"""Vectorised bisection root finder, for the quantiles of mixture distributions (a copy of meta_learning_pacoh_tpu/ops/rootfind.py).

The reference's interval-shrinking method behind
``EqualWeightedMixtureDist.icdf``: halve every bracket until the widest is
narrower than 2 eps, with an iteration cap and NaN where it is hit.
"""

import torch


def find_root_by_bounding(fun, left, right, eps=1e-6, max_iter=10_000):
    """Solve fun(x) = 0 elementwise for an increasing vectorised function.

    left, right: float32 tensors bracketing the roots. Returns the midpoints;
    NaN everywhere when max_iter was reached.
    """
    left = torch.as_tensor(left, dtype=torch.float32)
    right = torch.as_tensor(right, dtype=torch.float32, device=left.device)
    it = 0
    while it < max_iter and float(torch.max(torch.abs(right - left))) / 2.0 > eps:
        mid = (left + right) / 2.0
        left_of_zero = fun(mid) < 0
        left = torch.where(left_of_zero, mid, left)
        right = torch.where(left_of_zero, right, mid)
        it += 1
    mid = (left + right) / 2.0
    return torch.full_like(mid, float("nan")) if it >= max_iter else mid
