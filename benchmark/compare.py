"""The comparisons that decide ``correct``: by the worst leaf of a state.

A leaf's reading is the gap between the program's norm of the leaf and the
reference's, |‖a‖ - ‖b‖|, over the larger of the reference's norm of that
leaf and of the median leaf (some gradients are all but zero). Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone under Adam and are left out of a change (``moving``).
"""

import contextlib
import statistics

import numpy as np


def norms(a, leaves):
    """{name: ‖a[..., slice]‖} of arrays ``a`` [..., P] or of a dict of arrays:
    ``leaves`` is [(name, key, slice)], key None for a plain array."""
    out = {}
    for name, key, sl in leaves:
        part = np.asarray(a if key is None else a[key], np.float64)
        out[name] = float(np.linalg.norm(part[..., sl] if sl is not None else part))
    return out


def leaf_gaps(prog, ref, leaves, keep=None):
    """[|‖prog‖ - ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)] of the leaves
    in ``keep`` (default: all)."""
    a, b = norms(prog, leaves), norms(ref, leaves)
    med = statistics.median(b.values())
    names = [n for n, _, _ in leaves if keep is None or n in keep]
    return [abs(a[n] - b[n]) / max(b[n], med, 1e-300) for n in names]


def worst_leaf_gap(prog, ref, leaves, keep=None):
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, leaves, keep))


def median_leaf_gap(prog, ref, leaves, keep=None):
    """The median leaf's gap (``leaf_gaps``)."""
    return statistics.median(leaf_gaps(prog, ref, leaves, keep))


def moving(ref_grad, leaves):
    """The leaves whose reference gradient norm is at least a thousandth of the
    median leaf's."""
    b = norms(ref_grad, leaves)
    med = statistics.median(b.values())
    return {n for n, v in b.items() if v >= 1e-3 * med}


def rel_gap(a, b):
    """|a - b| / |b|."""
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


@contextlib.contextmanager
def tf32():
    """Matrix products in TF32 on the card, the precision below the
    configurations' float32."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
