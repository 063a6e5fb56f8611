"""Stein transport kernel (csrc/svgd_phi.cu) and its plain version.

Replaces meta_learning_pacoh_tpu/ops/pallas/svgd_kernel.py (``svgd_phi_fused``,
the Pallas kernel ``_svgd_kernel``). The median of the K*K pairwise squared
distances is the order statistic at 0-based rank K*K//2, the upper middle
for an even count, which is what the TPU kernel's bisection converges to.
Neither ``torch.median`` (lower middle) nor ``jnp.median`` (mean of the
two) gives it. On the card the kernel runs over one thread-block cluster
whose CTAs split P (``svgd_plan``; see the source). Stacked fits (seeds or
trials) pass x and s of [S, K, P]: one launch of S clusters, each system
with its own median, as the Pallas call under ``jax.vmap``.
"""

import functools
import math
from typing import NamedTuple

import torch

from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.cuda.build import launch
from meta_learning_pacoh_torch.ops.kernels import sq_dists

MAX_K = 32  # the kernel keeps K x K intermediates in shared memory
MAX_SYSTEMS = 65535  # S, the clusters of one launch (the grid's y extent)
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 with the non-portable cluster attribute
SLICE_TARGET = 160  # the plan's columns a CTA, at most, where 16 CTAs allow it
MAX_STAGED_BYTES = 200 * 1024  # a CTA's X and S slices in shared memory (csrc kMaxStagedBytes)
# the kernel's static shared memory: the partial and whole Gram, d2's pairs,
# K_xx, the row sums and the median's slot
STATIC_SMEM_BYTES = 4 * (2 * (MAX_K * (MAX_K + 1) // 2) + 2 * MAX_K * MAX_K + MAX_K + 1)
SMEM_LIMIT = 232448  # shared memory a block may use on the H100


class SvgdPlan(NamedTuple):
    cluster: int  # CTAs of the one cluster
    slice: int  # columns of P a CTA: CTA r owns [r * slice, min(P, (r + 1) * slice))
    staged: bool  # the slices of X and S in shared memory (else read from device memory)
    smem_bytes: int  # shared memory a CTA


def slice_len(p, c):
    """Columns of each CTA's slice of P over c CTAs: a multiple of 4 (16-byte
    copies), as cluster_util.cuh's slice_len; the last slice may be ragged."""
    return ((p + c - 1) // c + 3) // 4 * 4


@functools.lru_cache(maxsize=None)
def svgd_plan(k, p, cluster=None):
    """The launch of K1 for K particles of P parameters: the fewest CTAs
    whose slices hold at most SLICE_TARGET columns (16 beyond), or
    ``cluster`` CTAs where it is given (tests and tools). Cached: the
    general step calls it every step with the same (K, P)."""
    if cluster is None:
        cluster = next((c for c in CLUSTER_SIZES if slice_len(p, c) <= SLICE_TARGET),
                       CLUSTER_SIZES[-1])
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"svgd_phi: cluster {cluster} not in {CLUSTER_SIZES}")
    width = slice_len(p, cluster)
    staged_bytes = 2 * k * width * 4
    staged = staged_bytes <= MAX_STAGED_BYTES
    return SvgdPlan(cluster, width, staged, STATIC_SMEM_BYTES + (staged_bytes if staged else 0))


def median_upper(d2):
    """Order statistic of all entries of each d2 [..., K, K] at 0-based rank K*K//2 -> [...]."""
    flat = d2.reshape(*d2.shape[:-2], -1)
    return torch.kthvalue(flat, flat.shape[-1] // 2 + 1, dim=-1).values


def svgd_phi_ref(x, s):
    """Plain PyTorch version: phi [..., K, P] for particles x and scores s
    [..., K, P], each system with its own median."""
    k = x.shape[-2]
    d2 = sq_dists(x, x)
    h = median_upper(d2)[..., None, None] / (2.0 * math.log(k + 1))
    gamma = 1.0 / (1e-8 + 2.0 * h)
    k_xx = torch.exp(-gamma * d2)
    row_sum = torch.sum(k_xx, dim=-1, keepdim=True)
    return (k_xx @ s + 2.0 * gamma * (x * row_sum - k_xx @ x)) / k


def svgd_phi_fused(x, s, cluster=None):
    """phi for the RBF kernel with the median-heuristic bandwidth, x and s
    [K, P] or [S, K, P] (one launch either way); ``cluster`` forces the
    plan's CTAs (tests and tools)."""
    if x.device.type == "cpu":
        return svgd_phi_ref(x, s)
    if x.dim() not in (2, 3):
        raise ValueError(f"svgd_phi: expected [K, P] or [S, K, P], got {tuple(x.shape)}")
    cuda.check_operand("svgd_phi x", x, x.dim())
    cuda.check_operand("svgd_phi s", s, x.dim())
    k, p = x.shape[-2:]
    systems = x.shape[0] if x.dim() == 3 else 1
    if s.shape != x.shape or s.device != x.device:
        raise ValueError(f"svgd_phi: s {tuple(s.shape)} does not match x {tuple(x.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"svgd_phi: the kernel takes 1 <= K <= {MAX_K}, got {k}")
    if not 1 <= systems <= MAX_SYSTEMS:
        raise ValueError(f"svgd_phi: the kernel takes 1 <= S <= {MAX_SYSTEMS}, got {systems}")
    plan = svgd_plan(k, p, cluster)
    phi = torch.empty_like(x)
    launch("pacoh_svgd_phi", x, x.data_ptr(), s.data_ptr(), phi.data_ptr(), systems, k, p,
           math.log(k + 1), plan.cluster, plan.slice, int(plan.staged))
    cuda.LAUNCHES["svgd_phi"] += 1
    return phi
