"""Distributed block-cyclic Cholesky over a mesh axis (counterpart of
meta_learning_pacoh_tpu/parallel/dist_chol.py).

The last tier of the MLL dispatch: for a task whose Gram matrix is past the
single-device kernels' window (N > 512), the ranks of one mesh axis factor
it together. Block rows are dealt out cyclically, so the O(N^2) residency
and the O(N^3) trailing updates split over the ranks.

Algorithm (right-looking, block size nb, D ranks, nB = N / nb blocks), as in
the JAX package:
  for k in 0 .. nB - 1:
    owner(k) = k mod D holds the diagonal block A_kk and broadcasts it;
    every rank factors L_kk = chol(A_kk) (``ops.chol.cholesky``: the
    kernel K4 on the card at nb in 65-512) and panel-solves its rows
    below the diagonal, L_ik = A_ik L_kk^-T;
    an all_gather of the column panel {L_ik}; every rank applies the
    full-width trailing update A_i,: -= L_ik panel^T.
Full-width row updates keep the trailing matrix symmetric, so only the
lower triangle is ever read. The panel solves and the trailing updates are
``torch.linalg.solve_triangular`` and ``torch.matmul``, as the JAX package
leaves them to XLA outside Pallas; the collectives are explicit calls on
the axis's process group, made by every rank in the same order (also on a
mesh of one rank).
"""

import math

import torch

from meta_learning_pacoh_torch.ops.chol import cholesky
from meta_learning_pacoh_torch.parallel.mesh import (
    all_gather,
    axis_group,
    axis_rank,
    axis_size,
    broadcast_,
)

_LOG_2PI = math.log(2.0 * math.pi)


def _dist_chol_body(a_loc, group, d, n_dev, n_blocks, nb):
    """One rank's share of the factorization: a_loc [Lb, nb, N] its block
    rows (global blocks d, d + D, ...), updated in place into its rows of L.

    A slot's global block grows with the slot, so the rows below block k are
    the slots from ``first_below`` on: the panel solve and the trailing
    update touch only them. The other rows' entries right of their diagonal
    block are junk, zeroed at the end; the gathered panel's blocks j > k,
    the only ones the update reads, are all rows below k."""
    for k in range(n_blocks):
        ck = k * nb
        owner, slot = k % n_dev, k // n_dev
        first_below = max(0, (k - d) // n_dev + 1)
        diag = a_loc[slot, :, ck:ck + nb].contiguous() if d == owner else torch.empty(
            (nb, nb), dtype=a_loc.dtype, device=a_loc.device)
        l_kk = cholesky(broadcast_(diag, owner, group))
        if d == owner:
            a_loc[slot, :, ck:ck + nb] = l_kk

        # L_ik = A_ik L_kk^-T on the rows below k, as one [rows, nb] system
        below = a_loc[first_below:, :, ck:ck + nb]
        below.copy_(torch.linalg.solve_triangular(
            l_kk.mT, below.reshape(-1, nb), upper=True, left=False).reshape(below.shape))
        if k == n_blocks - 1:
            break

        # gather the column panel (global block order) and update the rows below
        panel = all_gather(a_loc[:, :, ck:ck + nb], group).transpose(0, 1).reshape(
            n_blocks, nb, nb)
        tail_t = panel[k + 1:].mT.transpose(0, 1).reshape(nb, -1)  # [nb, m]: L_jk^T, j > k
        a_loc[first_below:, :, ck + nb:] -= torch.matmul(below, tail_t)

    # zero everything right of each row's diagonal block (junk of the updates)
    gidx = d + n_dev * torch.arange(a_loc.shape[0], device=a_loc.device)
    col = torch.arange(n_blocks * nb, device=a_loc.device)[None, None, :]
    keep = col < ((gidx + 1) * nb)[:, None, None]
    return torch.where(keep, a_loc, torch.zeros_like(a_loc))


def distributed_cholesky(a, mesh, axis_name="task", block_size=128):
    """Lower Cholesky factor of one [N, N] positive-definite matrix, its
    block rows factored across the ranks of ``mesh``'s axis ``axis_name``.

    Every rank passes the same matrix and gets the whole factor [N, N]. A
    matrix whose size is no multiple of nb * D is padded with an identity
    tail. The caller adds jitter, as with ``ops.chol.cholesky``; a failed
    diagonal block factors to NaN, which spreads, as XLA's does.
    """
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"one square matrix, got shape {tuple(a.shape)}")
    n = a.shape[0]
    n_dev = axis_size(mesh, axis_name)
    group = axis_group(mesh, axis_name)
    d = axis_rank(mesh, axis_name)
    nb = min(block_size, max(8, n))
    step = nb * n_dev
    n_pad = -(-n // step) * step
    n_blocks = n_pad // nb
    lb = n_blocks // n_dev

    if n_pad != n:
        padded = torch.zeros((n_pad, n_pad), dtype=a.dtype, device=a.device)
        padded[:n, :n] = a
        padded[n:, n:] = torch.eye(n_pad - n, dtype=a.dtype, device=a.device)
        a = padded

    # rank d's slots hold global blocks d, d + D, ... (the block-cyclic order);
    # strided views, so no index array crosses from the host and a call
    # queues on the card without waiting for it
    a_loc = a.reshape(lb, n_dev, nb, n_pad)[:, d].clone(memory_format=torch.contiguous_format)
    l_loc = _dist_chol_body(a_loc, group, d, n_dev, n_blocks, nb)
    l_full = all_gather(l_loc, group).transpose(0, 1).reshape(n_pad, n_pad)
    return l_full[:n, :n]


def _distributed_kinv(chol_l, mesh, axis_name):
    """K^-1 from the (replicated) lower factor, the O(N^3) back-solve split
    by columns: rank d solves K x = e_j for its slice of the identity's
    columns (two triangular solves on an [N, N / D] right-hand side), and
    an all_gather joins the slices into the symmetric inverse."""
    n = chol_l.shape[0]
    n_dev = axis_size(mesh, axis_name)
    d = axis_rank(mesh, axis_name)
    cols_per = -(-n // n_dev)
    cols = d * cols_per + torch.arange(cols_per, device=chol_l.device)
    e = (torch.arange(n, device=chol_l.device)[:, None] == cols[None, :]).to(chol_l.dtype)
    x = torch.linalg.solve_triangular(chol_l, e, upper=False)
    x = torch.linalg.solve_triangular(chol_l.mT, x, upper=True)
    parts = all_gather(x, axis_group(mesh, axis_name))  # [D, N, N / D]
    return parts.permute(1, 0, 2).reshape(n, n_dev * cols_per)[:, :n]


class _DistributedMLL(torch.autograd.Function):
    """The closed-form MLL and its gradient: the factorization is never
    repeated or differentiated through."""

    @staticmethod
    def forward(ctx, mean, k_noisy, y, n_eff, mesh, axis_name, block_size):
        chol_l = distributed_cholesky(k_noisy, mesh, axis_name, block_size)
        z = torch.linalg.solve_triangular(chol_l, (y - mean)[:, None], upper=False)[:, 0]
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol_l)))
        ctx.save_for_backward(chol_l, z)
        ctx.mesh, ctx.axis_name = mesh, axis_name
        return -0.5 * (torch.sum(z * z) + logdet + n_eff * _LOG_2PI)

    @staticmethod
    def backward(ctx, g):
        # d/dK = 0.5 (a a^T - K^-1), a = K^-1 (y - mean); K^-1 column-sharded
        chol_l, z = ctx.saved_tensors
        alpha = torch.linalg.solve_triangular(chol_l.mT, z[:, None], upper=True)[:, 0]
        k_inv = _distributed_kinv(chol_l, ctx.mesh, ctx.axis_name)
        dk = 0.5 * (torch.outer(alpha, alpha) - k_inv)
        return g * alpha, g * dk, -g * alpha, None, None, None, None


def distributed_gp_mll(mean, k_noisy, y, mesh, axis_name="task", block_size=128, n_eff=None):
    """Exact GP marginal log-likelihood (NOT divided by n) of one task whose
    Gram matrix [N, N] is factored across the mesh (``distributed_cholesky``).

    ``n_eff`` (default: y's length) is the number of real points in the
    n log(2 pi) constant: a padded system's identity rows add 0 to the
    quadratic form and the log-determinant already. Differentiable in
    mean, k_noisy and y by the closed form (an ``autograd.Function``),
    whose K^-1 is column-sharded over the same axis (``_distributed_kinv``).
    """
    if n_eff is None:
        n_eff = float(y.shape[-1])
    n_eff = torch.as_tensor(n_eff, dtype=y.dtype, device=y.device)
    return _DistributedMLL.apply(mean, k_noisy, y, n_eff, mesh, axis_name, block_size)


def distributed_gp_mll_batch(means, ks_noisy, ys, mesh, axis_name="task", block_size=128,
                             n_eff=None):
    """B tasks, each an [N, N] system factored across the mesh, one after
    another (all ranks on one factorization at a time: matrix parallelism,
    not task parallelism). means, ys [B, N]; ks_noisy [B, N, N]; n_eff [B]
    or None -> [B] MLLs (NOT divided by n)."""
    if n_eff is None:
        n_eff = torch.full(ys.shape[:-1], float(ys.shape[-1]), dtype=ys.dtype,
                           device=ys.device)
    return torch.stack([
        distributed_gp_mll(means[b], ks_noisy[b], ys[b], mesh, axis_name, block_size,
                           n_eff=n_eff[b])
        for b in range(ys.shape[0])])
