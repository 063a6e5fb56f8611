"""K1, the Stein transport over one thread-block cluster, on the CPU.

The CUDA kernel (csrc/svgd_phi.cu) runs only on the card; here its plan
(``svgd_kernel.svgd_plan``: the CTAs, their slices of P, the shared memory)
is checked over a grid of K and P, and its schedule is emulated in numpy:
each CTA's partial Gram over its slice (a warp a pair: the lanes over the
columns, then the shuffle tree), the partials summed in rank order, the
median from the pairs (``median_upper_pairs`` of csrc/fused_update.cuh),
gamma, K_xx, the row sums and phi slice by slice. The float32 emulation is
held against the JAX package's Pallas kernel in interpret mode, as the JAX
package's own tests run it, at rtol 1e-5 per system (float32 sums in
another order: the Gram's split across CTAs and lanes).
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from meta_learning_pacoh_tpu.ops.pallas.svgd_kernel import svgd_phi_fused as jax_svgd_phi
from meta_learning_pacoh_torch.ops.cuda import svgd_kernel

P_SLICE = 2372  # particle width of the cauchy_20 slice (NN/NN 32x32, D=2)
P_SE = 1188  # the cauchy_20 learner with covar_module="SE"
PLAN_PS = (1, 37, 2308, 2371, 2372, 20000)


def assert_close_per_system(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want).reshape(got.shape[0], -1).max(axis=1)
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    assert np.all(diff <= rtol * scale), (diff / scale).max()


def slices(plan, p):
    """[lo, hi) of each CTA's columns, as the kernel forms them."""
    out = []
    for rank in range(plan.cluster):
        lo = min(rank * plan.slice, p)
        out.append((lo, min(p, lo + plan.slice)))
    return out


def pairs(k):
    """The pairs (i <= j) in the kernel's order, row by row."""
    return [(i, j) for i in range(k) for j in range(i, k)]


def partial_gram(xs, dtype):
    """One CTA's Gram pairs over its columns xs [K, w]: lane l sums the
    columns l, l + 32, .. in order, then the shuffle tree (offsets 16, 8, 4,
    2, 1) gives lane 0 the pair's sum."""
    k, w = xs.shape
    ij = np.array(pairs(k))
    prod = (xs[ij[:, 0]] * xs[ij[:, 1]]).astype(dtype)  # [pairs, w]
    lanes = np.zeros((len(ij), 32), dtype)
    for c0 in range(0, w, 32):
        chunk = prod[:, c0:c0 + 32]
        lanes[:, :chunk.shape[1]] += chunk
    for off in (16, 8, 4, 2, 1):
        lanes = lanes[:, :off] + lanes[:, off:2 * off]
    return lanes[:, 0]


def cluster_gram(x, plan, dtype):
    """The whole Gram [K, K]: the CTAs' partials summed in rank order."""
    k, p = x.shape
    total = np.zeros(k * (k + 1) // 2, dtype)
    for lo, hi in slices(plan, p):
        total = total + partial_gram(x[:, lo:hi].astype(dtype), dtype)
    gram = np.zeros((k, k), dtype)
    for q, (i, j) in enumerate(pairs(k)):
        gram[i, j] = gram[j, i] = total[q]
    return gram


def median_upper_pairs(d2p, k):
    """rbf_median.cuh's median_upper_pairs: the entry at rank K*K//2 of the
    symmetric K x K matrix with a zero diagonal, from its pairs i < j."""
    rank = k * k // 2
    for val in list(d2p) + [0.0]:
        less = 2 * int(np.sum(d2p < val)) + (k if val > 0 else 0)
        less_eq = 2 * int(np.sum(d2p <= val)) + (k if val >= 0 else 0)
        if less <= rank < less_eq:
            return val
    return np.nan


def emulate_svgd_phi(x, s, cluster=None):
    """K1's schedule in float32: plan, partial Grams, rank-order sum, d2 of
    the pairs (diagonal exactly 0), the median from the pairs, gamma, K_xx,
    row sums in order, phi slice by slice."""
    f = np.float32
    k, p = x.shape
    plan = svgd_kernel.svgd_plan(k, p, cluster)
    gram = cluster_gram(x, plan, f)
    diag = np.diagonal(gram)
    d2 = np.maximum(diag[:, None] + diag[None, :] - f(2) * gram, f(0)).astype(f)
    np.fill_diagonal(d2, 0)
    iu = np.triu_indices(k, 1)
    med = f(median_upper_pairs(d2[iu], k))
    log_kp1 = f(math.log(k + 1))
    gamma = f(1) / (f(1e-8) + f(2) * (med / (f(2) * log_kp1)))
    kxx = np.exp(-gamma * d2).astype(f)
    row_sum = np.zeros(k, f)
    for j in range(k):
        row_sum += kxx[:, j]
    phi = np.zeros((k, p), f)
    for lo, hi in slices(plan, p):
        xs, ss = x[:, lo:hi].astype(f), s[:, lo:hi].astype(f)
        ks, kx = np.zeros_like(xs), np.zeros_like(xs)
        for j in range(k):
            ks += kxx[:, j:j + 1] * ss[j]
            kx += kxx[:, j:j + 1] * xs[j]
        phi[:, lo:hi] = (ks + f(2) * gamma * (xs * row_sum[:, None] - kx)) / f(k)
    return phi


# ------------------------------------------------------------------ the plan

@pytest.mark.parametrize("p", PLAN_PS)
def test_plan_slices_cover_p_and_fit_shared_memory(p):
    """For every K in 1..32, at the plan's C and at every C it may be forced
    to: slices of a multiple of 4 columns that cover [0, P) exactly, in rank
    order; the staged X and S within their budget; a CTA's shared memory
    within the H100's 227 KB."""
    for k in range(1, svgd_kernel.MAX_K + 1):
        for cluster in (None,) + svgd_kernel.CLUSTER_SIZES:
            plan = svgd_kernel.svgd_plan(k, p, cluster)
            assert plan.cluster in svgd_kernel.CLUSTER_SIZES
            assert plan.slice % 4 == 0 and plan.slice >= 4
            covered = np.zeros(p, np.int64)
            prev_hi = 0
            for lo, hi in slices(plan, p):
                assert lo == prev_hi and hi >= lo
                covered[lo:hi] += 1
                prev_hi = hi
            assert prev_hi == p and np.all(covered == 1)
            staged_bytes = 2 * k * plan.slice * 4
            assert plan.staged == (staged_bytes <= svgd_kernel.MAX_STAGED_BYTES)
            assert plan.smem_bytes <= svgd_kernel.SMEM_LIMIT


def test_plan_spreads_the_main_paths_and_keeps_tiny_p_on_one_cta():
    """The general step's shapes take a cluster of more than one CTA; a P
    within one slice target takes one; the last slice of a ragged P is
    shorter, not empty, at the plan's C."""
    for p in (P_SLICE, P_SE, 2308):
        plan = svgd_kernel.svgd_plan(10, p)
        assert plan.cluster >= 2 and plan.staged
        assert plan.slice <= svgd_kernel.SLICE_TARGET
    assert svgd_kernel.svgd_plan(10, 37).cluster == 1
    plan = svgd_kernel.svgd_plan(10, 2371)
    lo, hi = slices(plan, 2371)[-1]
    assert 0 < hi - lo < plan.slice
    assert not svgd_kernel.svgd_plan(32, 20000).staged  # the slices read from device memory
    with pytest.raises(ValueError):
        svgd_kernel.svgd_plan(10, 2372, cluster=3)


@pytest.mark.parametrize("k,p,cluster", [(10, P_SLICE, None), (10, P_SE, None), (32, 2371, None),
                                         (7, 37, 16), (10, P_SLICE, 1), (3, 20000, None)])
def test_split_gram_rank_order_sum_equals_the_whole(k, p, cluster):
    """In float64 the CTAs' partial Grams summed in rank order equal X X^T
    within 1e-12 of its largest entry: the split changes only the float32
    order."""
    x = np.random.RandomState(k + p).randn(k, p)
    plan = svgd_kernel.svgd_plan(k, p, cluster)
    got = cluster_gram(x, plan, np.float64)
    want = x @ x.T
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_median_from_pairs_equals_the_whole_matrix_rank():
    """median_upper_pairs on the pairs equals the order statistic at rank
    K*K//2 of the whole matrix (svgd_kernel.median_upper), ties included."""
    rs = np.random.RandomState(0)
    for k in (1, 2, 3, 4, 10, 31, 32):
        x = rs.randn(k, 5)
        x[k // 2] = x[0]  # a tie at 0 off the diagonal
        d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        want = np.sort(d2.reshape(-1))[k * k // 2]
        assert median_upper_pairs(d2[np.triu_indices(k, 1)], k) == want


# ------------------------------------------- the emulation against the Pallas kernel

@pytest.mark.parametrize("k,p", [(4, P_SLICE), (10, P_SLICE), (32, P_SLICE), (10, 2371)])
def test_cluster_schedule_matches_pallas_kernel(k, p):
    """The float32 emulation of K1's cluster schedule against the JAX
    package's Stein kernel in interpret mode, rtol 1e-5 per system."""
    rs = np.random.RandomState(k)
    x = rs.randn(k, p).astype(np.float32)
    s = (10.0 * rs.randn(k, p)).astype(np.float32)
    want = np.asarray(jax_svgd_phi(jnp.asarray(x), jnp.asarray(s)))
    got = emulate_svgd_phi(x, s)
    assert_close_per_system(got[None], want[None], rtol=1e-5)


@pytest.mark.parametrize("cluster", [1, 2, 16])
def test_cluster_schedule_at_other_sizes_matches_plain(cluster):
    """The emulation at other cluster sizes against the port's plain
    version, rtol 1e-5 per system."""
    import torch

    rs = np.random.RandomState(cluster)
    x = rs.randn(10, P_SE).astype(np.float32)
    s = rs.randn(10, P_SE).astype(np.float32)
    want = svgd_kernel.svgd_phi_ref(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    got = emulate_svgd_phi(x, s, cluster)
    assert_close_per_system(got[None], want[None], rtol=1e-5)
