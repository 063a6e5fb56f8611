"""User-suppliable GP mean and kernel modules (counterpart of meta_learning_pacoh_tpu/models/modules.py).

The MLL-family learners (GPR-MLL, PACOH-MAP) accept a module instance next
to the 'NN' / 'SE' / 'constant' / 'zero' shorthands. A module is a frozen
dataclass: hashable by value, so it can sit inside the frozen ``GPConfig``
that keys ``flat_layout``'s cache, and two equal modules share one layout.
It exposes

    init_params(generator, input_dim) -> dict of raw (unconstrained) leaves,
        unbatched, as ``init_gp_params`` returns them
    mean(params, x) -> [K, ..., N]                      (MeanModule)
    gram(params, x1, x2) -> [K, ..., N, M]              (KernelModule)

where every leaf of ``params`` carries the leading particle axis K ([K, ...])
and the inputs carry it too (x [K, ..., N, D]), as everywhere in
``gp_base``. The leaves live in the learner's parameters under
'custom_mean' / 'custom_kernel' and train in the hyperparameter group.
"""

import dataclasses
import math

import torch

from meta_learning_pacoh_torch.ops.kernels import softplus


@dataclasses.dataclass(frozen=True)
class MeanModule:
    """Protocol base of user-supplied prior means."""

    def init_params(self, generator, input_dim):
        raise NotImplementedError

    def mean(self, params, x):
        """x [K, ..., N, D] -> [K, ..., N]."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class KernelModule:
    """Protocol base of user-supplied covariance functions."""

    def init_params(self, generator, input_dim):
        raise NotImplementedError

    def gram(self, params, x1, x2):
        """x1 [K, ..., N, D], x2 [K, ..., M, D] -> [K, ..., N, M]."""
        raise NotImplementedError


def _lead(t, x):
    """Reshape the particle leaf t [K, *rest] to broadcast against x [K, ..., *rest]."""
    mid = x.dim() - t.dim()
    return t.reshape(t.shape[:1] + (1,) * mid + t.shape[1:])


def _safe_dist(x1, x2):
    """Pairwise Euclidean distance [..., N, M] from differences, with the
    squared distance clamped at 1e-12 before the square root: the gradient
    of ||d|| at d = 0 is undefined, and without the clamp a duplicated
    point makes it NaN."""
    sq = torch.sum((x1[..., :, None, :] - x2[..., None, :, :]) ** 2, dim=-1)
    return torch.sqrt(torch.clamp_min(sq, 1e-12))


@dataclasses.dataclass(frozen=True)
class CosineKernel(KernelModule):
    """k(x, x') = cos(2 pi ||x - x'|| / p), the period p = softplus(raw), raw 0 at init."""

    def init_params(self, generator, input_dim):
        del generator, input_dim
        return {"period_raw": torch.zeros(())}

    def gram(self, params, x1, x2):
        d = _safe_dist(x1, x2)
        p = _lead(softplus(params["period_raw"]), d)
        return torch.cos(2.0 * math.pi * d / p)


@dataclasses.dataclass(frozen=True)
class MaternKernel(KernelModule):
    """Matern kernel with an ARD lengthscale over the raw inputs,
    nu in {0.5, 1.5, 2.5} (the closed forms)."""

    nu: float = 2.5

    def __post_init__(self):
        if self.nu not in (0.5, 1.5, 2.5):
            raise ValueError(f"MaternKernel: nu must be 0.5/1.5/2.5, got {self.nu}")

    def init_params(self, generator, input_dim):
        del generator
        return {"lengthscale_raw": torch.zeros(input_dim)}

    def gram(self, params, x1, x2):
        ls = _lead(softplus(params["lengthscale_raw"]), x1[..., 0, :])[..., None, :]
        d = _safe_dist(x1 / ls, x2 / ls)
        if self.nu == 0.5:
            return torch.exp(-d)
        if self.nu == 1.5:
            s = math.sqrt(3.0) * d
            return (1.0 + s) * torch.exp(-s)
        s = math.sqrt(5.0) * d
        return (1.0 + s + s * s / 3.0) * torch.exp(-s)


@dataclasses.dataclass(frozen=True)
class LinearMean(MeanModule):
    """m(x) = w . x + b, raw 0 at init."""

    def init_params(self, generator, input_dim):
        del generator
        return {"w": torch.zeros(input_dim), "b": torch.zeros(())}

    def mean(self, params, x):
        w = _lead(params["w"], x[..., 0, :])[..., None, :]
        return torch.sum(x * w, dim=-1) + _lead(params["b"], x[..., 0])
