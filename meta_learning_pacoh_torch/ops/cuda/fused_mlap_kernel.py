"""Fused PACOH-MLAP training and meta-test kernel (csrc/fused_mlap.cuh), its plain version, and its host-side trainers.

Replaces meta_learning_pacoh_tpu/ops/pallas/fused_mlap_kernel.py
(``fused_mlap_train_packed``, the Pallas kernel of ``_make_mlap_kernel``,
``FusedMLAPTrainer`` and ``FusedMLAPMetaTest``), whose arithmetic is the
closed-form spec meta_learning_pacoh_tpu/ops/fused_mlap_math.py. One launch
runs ``n_steps`` iterations of the nested two-level PAC-Bayes bound: S
reparameterised samples of the diagonal hyper-posterior, the S*T inner
Gaussian KLs with the 1e-6 / 1e-4 / 1e-2 jitter escalation, the weighted
bound and every gradient in closed form, and optax's Adam in two groups (lr
for the hyper-posterior and the noise, lr * posterior_lr_multiplier for the
per-task posteriors). In meta-test mode the hyper-posterior and the noise
are frozen, the loss is the plain sum of the per-task bounds, and only the
per-task posteriors train, at the meta-test's lr.

The state is a dict of tensors updated in place (``STATE_KEYS``: the flat
``[P]`` loc and log_scale in the JAX package's ``ravel_pytree`` order,
q_means [T, N], q_trils [T, N, N], raw_noise []), with two such dicts of
Adam moments. The TPU kernel's packed layouts and pages existed to fill TPU
lanes and are not ported: a noise page is the step's [S, P] standard
normals, a count page the step's [T] task-draw counts.

The kernel runs one thread-block cluster of C CTAs a sample
(``cluster_plan`` chooses C, the activations' row stride and the tasks a
tile; ``smem_bytes`` mirrors a CTA's shared memory): each CTA holds the
sample whole and owns a group of tasks, with their posteriors and moments,
and a slice of P, with the hyper-posterior and its moments there. Where a
CTA's tasks do not fit in its shared memory, the tiled kernel keeps each
cluster's posteriors and moments in device memory (``tile_floats``) and
walks the tasks in tiles, so the task count is bounded only by device
memory. The window of the kernel (``fused_mlap_fits``): NN mean and NN
kernel with feature_dim 1 and one hidden width, 1 <= S <= 32 samples,
tasks of N <= 8 points, and a CTA of one task within one block's shared
memory; it does not depend on T, as the JAX learner's gate does not (in
training and in the meta-test), and ``cluster_plan`` finds a plan for every
T.
"""

import functools
import math

import torch

from meta_learning_pacoh_torch.models.gp_base import gp_features, gp_mean
from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.chol import unrolled_cholesky, unrolled_solve_lower_mat
from meta_learning_pacoh_torch.ops.cuda.build import launch
from meta_learning_pacoh_torch.ops.cuda.chol_kernel import diag_ok
from meta_learning_pacoh_torch.ops.cuda.fused_svgd_kernel import (
    CLUSTER_SIZES,
    RESIDENT_CLUSTERS,
    _device_operands,
    _prior_on,
    fused_prior,
    largest_tile,
    slice_len,
)
from meta_learning_pacoh_torch.ops.kernels import softplus
from meta_learning_pacoh_torch.ops.launch_sched import (
    count_pages,
    staircase_launches,
    staircase_lr,
)
from meta_learning_pacoh_torch.utils.profiling import (
    TRAINER_BUILD,
    TRAINER_LAUNCH,
    TRAINER_PAGES,
    span,
    spanned,
)

MAX_S = 32  # samples, one cluster each
MAX_N = 8  # the per-task algebra is unrolled in registers
SMEM_BYTES = 232448  # shared memory one Hopper block can use
STATE_KEYS = ("loc", "log_scale", "q_means", "q_trils", "raw_noise")
Q_KEYS = ("q_means", "q_trils")
KL_JITTERS = (1e-6, 1e-4, 1e-2)
_LOG_2PI = math.log(2.0 * math.pi)


def smem_bytes(t, n, d, hidden, p, c, hs, tile=None):
    """Shared memory of one CTA, as csrc/fused_mlap.cuh lays it out: the sample
    and the CTA's partial score, its rows' activation slots (row stride hs),
    its rows, four floats a task, its tasks' posteriors and their moments,
    its slice of the hyper-posterior and of both pairs of moments, the block
    sums' partials, 16 scalars and the leaf offsets; with ``tile`` below
    ceil(T / C) (the tiled kernel) the rows of a tile, two floats a task of
    it and no task's posterior."""
    tmax = -(-t // c)
    n_layers = len(hidden)
    rest = 2 * p + 6 * slice_len(p, c) + 40 + 16 + 4 * n_layers + 6
    if tile is not None and tile < tmax:
        rmax = tile * n
        return 4 * (rest + (n_layers + 1) * 2 * rmax * hs + rmax * (d + 4) + 2 * tile)
    rmax = tmax * n
    return 4 * (rest + (n_layers + 1) * 2 * rmax * hs + rmax * (d + 4) + 4 * tmax
                + 3 * rmax * (n + 1))


def tile_floats(t, n):
    """Floats of one cluster's device scratch in the tiled kernel
    (csrc/fused_mlap.cuh): the posteriors and their moments, the rows'
    cotangents, three floats a task."""
    m = t * n
    return 3 * m * (n + 1) + 2 * m + 3 * t


@functools.lru_cache(maxsize=None)
def _plan(s, t, n, d, hidden, cluster):
    p = fused_prior(d, hidden, 1.0, 1.0).dim
    h = hidden[0]
    if cluster is None:
        sizes = ([c for c in CLUSTER_SIZES if c <= t]
                 + [c for c in reversed(CLUSTER_SIZES) if c > t])
        sizes = [c for c in sizes if s <= RESIDENT_CLUSTERS[c]]
    else:
        sizes = [int(cluster)]
    for c in sizes:  # the untiled kernel, as the window's shapes always take
        for hs in dict.fromkeys((h | 1, h)):
            if smem_bytes(t, n, d, hidden, p, c, hs) <= SMEM_BYTES:
                return c, hs, -(-t // c)
    for c in sizes:  # the tiled kernel, the most tasks a tile that fit
        for hs in dict.fromkeys((h | 1, h)):
            tile = largest_tile(lambda tt: smem_bytes(t, n, d, hidden, p, c, hs, tt), -(-t // c))
            if tile is not None:
                return c, hs, tile
    return None


def cluster_plan(s, t, n, d, hidden, cluster=None):
    """(C, hs, tile) of a launch: the first size of ``CLUSTER_SIZES`` with
    no more CTAs than tasks whose S clusters ``RESIDENT_CLUSTERS`` holds at
    once and whose CTA fits in shared memory untiled (tile = ceil(T / C)),
    with an odd activation row stride where it fits (H otherwise); where
    none fits (a task or two of a wide net), the smallest such size with
    more CTAs than tasks, whose CTAs without a task hold only their slices;
    where none of those fits either (many tasks), the first size whose tiled
    CTA fits, with the most tasks a tile. ``cluster`` forces C (the learners
    never pass it)."""
    hidden = tuple(int(h) for h in hidden)
    plan = _plan(s, t, n, d, hidden, None if cluster is None else int(cluster))
    if plan is None:
        raise ValueError(f"fused_mlap: no cluster plan for S={s}, T={t}, N={n}, D={d}, "
                         f"hidden={hidden}, cluster={cluster}")
    return plan


def resident_clusters(t, n, d, hidden, plan, device="cuda"):
    """Clusters of the plan's C CTAs resident at once on the card
    (cudaOccupancyMaxActiveClusters, read by the kernel's C entry)."""
    import ctypes

    hidden = tuple(int(h) for h in hidden)
    c, hs, tile = plan
    p = fused_prior(d, hidden, 1.0, 1.0).dim
    out = ctypes.c_int(0)
    launch(f"{_entry(t, plan)}_clusters", torch.empty(0, device=device), t, n, d, hidden[0],
           len(hidden), p, c, hs, tile, ctypes.addressof(out))
    return out.value


def _entry(t, plan):
    """The C entry of a plan: the tiled kernel (csrc/fused_mlap_tiled.cu) where
    its tile is below a CTA's tasks, else the untiled one (csrc/fused_mlap.cu)."""
    c, _, tile = plan
    return "pacoh_fused_mlap_tiled" if tile < -(-t // c) else "pacoh_fused_mlap"


def fused_mlap_fits(s, t, n, d, hidden):
    """Whether the kernel takes this configuration: the structural window
    and a plan at one task, which every task count then has (the tiled
    kernel)."""
    del t  # a shape that fits at one task fits at every T
    hidden = tuple(int(h) for h in hidden)
    return (1 <= s <= MAX_S and 1 <= n <= MAX_N and len(hidden) >= 1
            and len(set(hidden)) == 1 and _plan(s, 1, n, d, hidden, None) is not None)


def sum_log_prior_scale(d, hidden, wps, bps):
    """sum_p log(hyper-prior scale_p), a Python float as the JAX trainer forms
    it: n_w log(wps) + n_b log(bps) (the lengthscale and noise scales are 1)."""
    sizes = (d,) + tuple(hidden) + (1,)
    n_w = 2 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    n_b = 2 * (sum(hidden) + 1)
    return float(n_w * math.log(wps) + n_b * math.log(bps))


def _task_weights(counts, t, meta_test, dtype, device):
    """u_t: 1 in meta-test mode; counts / their sum, or 1/T for the full batch."""
    if meta_test:
        return torch.ones(t, dtype=dtype, device=device)
    if counts is None:
        return torch.full((t,), 1.0 / t, dtype=dtype, device=device)
    return counts / torch.sum(counts)


def mlap_loss_and_grads(params, eps, counts, X, Y, mask, hyper_prior, *, task_kl_weight,
                        meta_kl_weight, delta, n_tasks=None, meta_test=False):
    """One MLAP loss evaluation and its gradients, the closed form of
    meta_learning_pacoh_tpu/ops/fused_mlap_math.py.

    params: {'loc' [P], 'log_scale' [P], 'q_means' [T, N], 'q_trils' [T, N, N],
    'raw_noise' []}; eps [S, P] the step's standard normals; counts [T] the
    step's task-draw counts, or None for the full batch; X [T, N, D], Y [T, N],
    mask [T, N]; N <= 8. n_tasks (default T) is the task count of the bound's
    log(n_tasks) and of the meta-complexity. meta_test: the loss is the sum of
    the per-task bounds (no meta-complexity) and only q_means and q_trils get
    gradients.

    Every gradient is the spec's closed form: the inner KLs' VJP
    dKL/dK1 = 0.5 (K^-1 - (K^-1 L0)(K^-1 L0)^T - w w^T), dKL/dL0 =
    K^-1 L0 - diag(sign(l)/(|l| + 1e-12)), dKL/dmu = w, chained through the
    gram; the MLPs' backward (the spec's ``_mlp_bwd``) is the VJP of their
    forward with those cotangents. Returns (loss, grads, diag), grads keyed
    like params (Q_KEYS only in meta-test mode), diag {'avg_ll',
    'kl_outer_weighted', 'kl_inner_weighted'}.
    """
    loc, lsc = params["loc"].detach(), params["log_scale"].detach()
    qm, qt, nu = params["q_means"].detach(), params["q_trils"].detach(), params["raw_noise"]
    nu = nu.detach()
    t, n, d = X.shape
    if n > MAX_N:
        raise ValueError(f"mlap_loss_and_grads: N <= {MAX_N}, got {n}")
    s = eps.shape[0]
    n_tasks = t if n_tasks is None else int(n_tasks)
    u = _task_weights(counts, t, meta_test, X.dtype, X.device)

    scale = torch.exp(lsc)
    theta = loc[None, :] + scale[None, :] * eps  # [S, P]

    # ---- outer KL, closed form
    mu_p, sig_p = hyper_prior.loc.to(loc.dtype), hyper_prior.scale.to(loc.dtype)
    rq = (loc - mu_p) / sig_p
    kl_outer_raw = 0.5 * (torch.sum((scale / sig_p) ** 2) + torch.sum(rq * rq) - loc.shape[0]
                          + 2.0 * torch.sum(torch.log(sig_p)) - 2.0 * torch.sum(lsc))
    kl_outer = meta_kl_weight * kl_outer_raw
    noise_var = softplus(nu) + 1e-4

    # ---- the posteriors' side (theta-independent)
    m2 = mask[:, :, None] * mask[:, None, :]
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    diag_pad = torch.diag_embed(1.0 - mask)
    Leff = torch.tril(qt) * m2 + diag_pad
    qm_eff = qm * mask
    f_var = torch.sum(Leff * Leff, dim=-1)
    n_eff = torch.sum(mask, dim=-1)
    r = Y - qm_eff
    lp = -0.5 * ((r * r + f_var) / noise_var + torch.log(noise_var) + _LOG_2PI)
    avg_ll = torch.sum(lp * mask, dim=-1) / n_eff
    ldiag0 = torch.diagonal(Leff, dim1=-2, dim2=-1)
    logdet0 = 2.0 * torch.sum(torch.log(torch.abs(ldiag0) + 1e-12), dim=-1)
    Sig0 = Leff @ Leff.mT

    # ---- the GP prior of every sample: both nets forward
    with torch.enable_grad():
        theta_g = theta.detach().requires_grad_(not meta_test)
        p = hyper_prior.unravel(theta_g)
        x = X.expand(s, t, n, d)
        mu = gp_mean(hyper_prior.cfg, p, x)  # [S, T, N]
        z = gp_features(hyper_prior.cfg, p, x) / softplus(p["lengthscale_raw"])[:, None, None, :]
    zd = z.detach()
    zn = torch.sum(zd * zd, dim=-1)
    d2 = torch.clamp(zn[..., :, None] + zn[..., None, :] - 2.0 * (zd @ zd.mT), min=0.0)
    Km = torch.exp(-0.5 * d2)
    K1 = Km * m2 + diag_pad

    # the jitter escalation of ops/variational.gaussian_kl_chol, per (s, t)
    jit = torch.full(K1.shape[:-2], KL_JITTERS[-1], dtype=X.dtype, device=X.device)
    for j in reversed(KL_JITTERS[:-1]):
        ok = diag_ok(unrolled_cholesky(K1 + j * eye))
        jit = torch.where(ok, torch.full_like(jit, j), jit)
    L1 = unrolled_cholesky(K1 + jit[..., None, None] * eye)
    W1 = unrolled_solve_lower_mat(L1, eye.expand(L1.shape))  # L1^-1
    Kinv = W1.mT @ W1

    mu_eff = mu.detach() * mask
    dvec = mu_eff - qm_eff
    w = (Kinv @ dvec[..., None])[..., 0]  # K^-1 d
    quad = torch.sum(dvec * w, dim=-1)
    trace = torch.sum(Kinv * Sig0, dim=(-2, -1))
    logdet1 = 2.0 * torch.sum(torch.log(torch.diagonal(L1, dim1=-2, dim2=-1)), dim=-1)
    kl_st = 0.5 * (trace + quad - n + logdet1 - logdet0)  # [S, T]

    kl_inner = task_kl_weight * torch.mean(kl_st, dim=0)
    c_t = math.log(2.0) + torch.log(n_eff) + math.log(float(n_tasks)) - math.log(delta)
    c2 = 2.0 * (n_eff - 1.0)
    complexity = torch.sqrt((kl_outer + kl_inner + c_t) / c2)
    bound = -avg_ll + complexity
    loss = torch.sum(u * bound)
    cm2 = 2.0 * (n_tasks - 1.0)
    if not meta_test:
        meta_c = torch.sqrt((kl_outer + math.log(2.0) + math.log(float(n_tasks))
                             - math.log(delta)) / cm2)
        loss = loss + meta_c

    # =================== backward, closed form ===================
    beta = u / (2.0 * c2 * complexity)
    gamma = beta * task_kl_weight / s
    PL = Kinv @ Leff[None]  # K^-1 L0
    grads = {}

    ll_coef = u / (noise_var * n_eff)
    grads["q_means"] = (-ll_coef[:, None] * mask * r
                        - mask * torch.einsum("t,sti->ti", gamma, w))
    dl_diag = torch.diag_embed(torch.sign(ldiag0) / (torch.abs(ldiag0) + 1e-12))
    G_L = torch.einsum("t,stij->tij", gamma, PL) - (s * gamma)[:, None, None] * dl_diag
    grads["q_trils"] = torch.tril((ll_coef[:, None, None] * Leff + G_L) * m2)

    if not meta_test:
        chi = torch.sum(beta) + 1.0 / (2.0 * cm2 * meta_c)
        G_K1 = (0.5 * gamma[None, :, None, None]
                * (Kinv - PL @ PL.mT - w[..., :, None] * w[..., None, :]))
        d_mu = gamma[None, :, None] * w * mask[None]
        dd2 = G_K1 * m2 * Km * (-0.5)
        A2 = dd2 + dd2.mT
        dz = 2.0 * (torch.sum(A2, dim=-1)[..., None] * zd - A2 @ zd)
        (score,) = torch.autograd.grad((mu, z), theta_g, (d_mu, dz))
        grads["loc"] = (torch.sum(score, dim=0)
                        + chi * meta_kl_weight * (loc - mu_p) / (sig_p * sig_p))
        grads["log_scale"] = (scale * torch.sum(score * eps, dim=0)
                              + chi * meta_kl_weight * ((scale / sig_p) ** 2 - 1.0))
        davg_dvar = torch.sum(mask * (0.5 * (r * r + f_var) / (noise_var * noise_var)
                                      - 0.5 / noise_var), dim=-1) / n_eff
        grads["raw_noise"] = torch.sigmoid(nu) * torch.sum(u * (-davg_dvar))

    diag = {"avg_ll": torch.sum(u * avg_ll), "kl_outer_weighted": kl_outer,
            "kl_inner_weighted": torch.sum(u * kl_inner)}
    return loss.detach(), grads, diag


def fused_mlap_train_ref(params, mu, nu, x, y, mask, eps, counts, step0, lr_main, lr_post, *,
                         hidden, wps, bps, task_kl_weight, meta_kl_weight, delta, n_tasks,
                         meta_test=False, n_steps):
    """Plain PyTorch version of ``fused_mlap_train``, updating in place: each
    step ``mlap_loss_and_grads`` (counts[i] of a sampled batch when given)
    and optax's Adam with one step count, lr_main on loc, log_scale and
    raw_noise, lr_post on q_means and q_trils (only these in meta-test mode).
    Returns (last loss, mean loss, the last step's diag)."""
    hidden = tuple(int(h) for h in hidden)
    hp = _prior_on(x.shape[-1], hidden, float(wps), float(bps), x.device)
    keys = Q_KEYS if meta_test else STATE_KEYS
    losses = []
    for i in range(n_steps):
        loss, grads, diag = mlap_loss_and_grads(
            params, eps[i], None if counts is None else counts[i], x, y, mask, hp,
            task_kl_weight=task_kl_weight, meta_kl_weight=meta_kl_weight, delta=delta,
            n_tasks=n_tasks, meta_test=meta_test)
        with torch.no_grad():
            for k in keys:
                lr = lr_post if k in Q_KEYS else lr_main
                cuda.adam_step_(params[k], mu[k], nu[k], grads[k], step0 + i + 1, lr)
        losses.append(loss)
    return losses[-1], torch.mean(torch.stack(losses)), diag


def fused_mlap_train(params, mu, nu, x, y, mask, eps, counts, step0, lr_main, lr_post, *,
                     hidden, wps, bps, task_kl_weight, meta_kl_weight, delta, n_tasks,
                     meta_test=False, batch=None, n_steps, cluster=None):
    """n_steps of PACOH-MLAP (or of its meta-test) on the state ``params`` and
    its Adam moments ``mu``, ``nu`` (dicts keyed by STATE_KEYS; in meta-test
    mode the moments need only Q_KEYS), all updated in place. Returns (last
    loss, mean loss, the last step's diag) as device scalars.

    x [T, N, D], y [T, N], mask [T, N]; eps [n_steps, S, P] the steps'
    standard normals; counts [n_steps, T] the steps' task-draw counts, or
    None (the full batch: u_t = 1/T; meta-test mode takes None, u_t = 1),
    with ``batch`` the draws a step (each page's sum); step0 the Adam step
    count before the first step; lr_main, lr_post the launch's learning
    rates; n_tasks the bound's task count; ``cluster`` forces the cluster
    size C (``cluster_plan``). The plain version for CPU tensors, the kernel
    for CUDA tensors.
    """
    hidden = tuple(int(h) for h in hidden)
    if n_steps < 1:
        raise ValueError(f"fused_mlap: n_steps must be >= 1, got {n_steps}")
    kw = dict(hidden=hidden, wps=wps, bps=bps, task_kl_weight=task_kl_weight,
              meta_kl_weight=meta_kl_weight, delta=delta, n_tasks=n_tasks, meta_test=meta_test,
              n_steps=n_steps)
    dev = params["loc"].device
    if dev.type == "cpu":
        return fused_mlap_train_ref(params, mu, nu, x, y, mask, eps, counts, step0, lr_main,
                                    lr_post, **kw)
    if meta_test and counts is not None:
        raise ValueError("fused_mlap: the meta-test takes no count pages")
    if counts is not None and not batch:
        raise ValueError("fused_mlap: count pages need their batch size")
    s, p = eps.shape[1], eps.shape[2]
    t, n, d = x.shape
    moment_keys = Q_KEYS if meta_test else STATE_KEYS
    shapes = {"loc": (p,), "log_scale": (p,), "q_means": (t, n), "q_trils": (t, n, n),
              "raw_noise": ()}
    operands = [(f"{k}", params[k], shapes[k]) for k in STATE_KEYS]
    operands += [(f"mu {k}", mu[k], shapes[k]) for k in moment_keys]
    operands += [(f"nu {k}", nu[k], shapes[k]) for k in moment_keys]
    operands += [("x", x, (t, n, d)), ("y", y, (t, n)), ("mask", mask, (t, n)),
                 ("eps", eps, (n_steps, s, p))]
    if counts is not None:
        operands.append(("counts", counts, (n_steps, t)))
    for name, t_, shape in operands:
        cuda.check_operand(f"fused_mlap {name}", t_, len(shape))
        if t_.device != dev:
            raise ValueError(f"fused_mlap {name}: on {t_.device}, loc on {dev}")
        if tuple(t_.shape) != shape:
            raise ValueError(f"fused_mlap {name}: expected shape {shape}, got {tuple(t_.shape)}")
    if not fused_mlap_fits(s, t, n, d, hidden) or p != fused_prior(d, hidden, 1.0, 1.0).dim:
        raise ValueError(f"fused_mlap: the kernel does not take S={s}, T={t}, N={n}, D={d}, "
                         f"hidden={hidden}, P={p}")
    c, hs, tile = cluster_plan(s, t, n, d, hidden, cluster)
    prior_loc, prior_scale, offs = _device_operands(d, hidden, float(wps), float(bps), dev)
    kl_buf = torch.empty(2, s, t, 3, dtype=torch.float32, device=dev)
    q_buf = torch.empty(2, s, t * n * (n + 1), dtype=torch.float32, device=dev)
    s_buf = torch.empty(2, s, p, dtype=torch.float32, device=dev)
    entry = _entry(t, (c, hs, tile))
    t_buf = (torch.empty(s, tile_floats(t, n), dtype=torch.float32, device=dev)
             if entry == "pacoh_fused_mlap_tiled" else None)
    out = torch.empty(5, dtype=torch.float32, device=dev)
    u_scale = 1.0 if meta_test else 1.0 / (t if counts is None else batch)

    def ptr(tree, k):
        return tree[k].data_ptr() if k in moment_keys else None

    launch(entry, params["loc"], *(params[k].data_ptr() for k in STATE_KEYS),
           *(ptr(mu, k) for k in STATE_KEYS), *(ptr(nu, k) for k in STATE_KEYS),
           x.data_ptr(), y.data_ptr(), mask.data_ptr(),
           None if counts is None else counts.data_ptr(), eps.data_ptr(), prior_loc.data_ptr(),
           prior_scale.data_ptr(), offs.data_ptr(), kl_buf.data_ptr(), q_buf.data_ptr(),
           s_buf.data_ptr(), None if t_buf is None else t_buf.data_ptr(), out.data_ptr(), s, t,
           n, d, hidden[0], len(hidden), p, int(n_steps), int(bool(meta_test)), c, hs, tile,
           float(step0), float(lr_main), float(lr_post),
           float(u_scale), float(task_kl_weight), float(meta_kl_weight), float(-math.log(delta)),
           float(math.log(float(n_tasks))), float(2.0 * (n_tasks - 1.0)),
           sum_log_prior_scale(d, hidden, float(wps), float(bps)))
    cuda.LAUNCHES["fused_mlap"] += 1
    diag = {"avg_ll": out[2], "kl_outer_weighted": out[3], "kl_inner_weighted": out[4]}
    return out[0], out[1] / n_steps, diag


class FusedMLAPTrainer:
    """Host-side trainer of the fused kernel over a learner's state.

    It splits a run into launches of at most ``MAX_LAUNCH`` steps that cross
    no staircase boundary of the lr schedule (both groups follow one
    staircase) and builds each launch's pages from the learner's own draws:
    ``eps_draw(step, out)`` fills ``out`` [S, P] with the noise of a global
    step, ``task_draw(step)`` gives its task indices, drawn with replacement
    at every step as the JAX learner draws them, even for the full batch. So
    the fused and the general step follow one random trajectory. The state
    is the caller's tensors, updated in place.
    """

    MAX_LAUNCH = 512  # steps a launch (bounds its noise pages: 24 MB at sin_20)

    @spanned(TRAINER_BUILD)
    def __init__(self, X, Y, mask, *, hidden, lr, posterior_lr_multiplier, svi_batch_size,
                 task_batch_size, task_kl_weight, meta_kl_weight, delta, weight_prior_std,
                 bias_prior_std, eps_draw, task_draw, lr_decay=1.0):
        self.X, self.Y, self.mask = X, Y, mask
        self.n_tasks = int(X.shape[0])
        self.batch = int(task_batch_size)
        self.hidden = tuple(int(h) for h in hidden)
        self.lr, self.lr_post = float(lr), float(lr * posterior_lr_multiplier)
        self.lr_decay = float(lr_decay)
        self.n_samples = int(svi_batch_size)
        self.p = fused_prior(int(X.shape[-1]), self.hidden, 1.0, 1.0).dim
        self.eps_draw, self.task_draw = eps_draw, task_draw
        self.kw = dict(hidden=self.hidden, wps=float(weight_prior_std),
                       bps=float(bias_prior_std), task_kl_weight=float(task_kl_weight),
                       meta_kl_weight=float(meta_kl_weight), delta=float(delta),
                       n_tasks=self.n_tasks)
        self.last_loss = self.avg_loss = float("nan")
        self.last_diag = {}

    @spanned(TRAINER_PAGES)
    def count_pages(self, step0, n_steps):
        """[n_steps, T] draw counts of global steps step0 .. step0 + n_steps - 1."""
        pages = count_pages(self.task_draw, self.n_tasks, step0, n_steps)
        if self.X.device.type == "cuda":  # an asynchronous copy: the card keeps running
            pages = pages.pin_memory()
        return pages.to(self.X.device, non_blocking=True)

    @spanned(TRAINER_PAGES)
    def eps_pages(self, step0, n_steps):
        """[n_steps, S, P] noise of global steps step0 .. step0 + n_steps - 1."""
        pages = torch.empty(n_steps, self.n_samples, self.p, dtype=torch.float32,
                            device=self.X.device)
        for i in range(n_steps):
            self.eps_draw(step0 + i, pages[i])
        return pages

    def launches(self, step0, n_steps):
        """(launch_step0, sub_steps) of a run of n_steps from global step step0."""
        return staircase_launches(step0, n_steps, self.MAX_LAUNCH, self.lr_decay)

    def launch(self, params, mu, nu, step0, n_steps):
        eps = self.eps_pages(step0, n_steps)
        counts = self.count_pages(step0, n_steps)
        with span(TRAINER_LAUNCH):
            return fused_mlap_train(params, mu, nu, self.X, self.Y, self.mask, eps, counts,
                                    step0, staircase_lr(self.lr, self.lr_decay, step0),
                                    staircase_lr(self.lr_post, self.lr_decay, step0),
                                    batch=self.batch, n_steps=n_steps, **self.kw)

    def run(self, params, mu, nu, n_steps, step0):
        """n_steps from global step step0; (last loss, mean loss) as device
        scalars, also kept as ``last_loss`` and ``avg_loss`` (and the last
        step's diag as ``last_diag``)."""
        total = 0.0
        for s, sub in self.launches(step0, n_steps):
            self.last_loss, mean, self.last_diag = self.launch(params, mu, nu, s, sub)
            total = total + mean * sub
        self.avg_loss = total / n_steps
        return self.last_loss, self.avg_loss


class FusedMLAPMetaTest:
    """The meta-test's inference of per-task posteriors through the kernel in
    meta-test mode: the hyper-posterior and the noise frozen, Adam at ``lr``
    from zero moments on q_means and q_trils, one launch per ``MAX_LAUNCH``
    steps. ``eps_block(step0, n_steps)`` gives the [n_steps, S, P] noise of a
    launch (the learner draws one block a launch, so the general meta-test
    loop, which draws the same blocks, takes the same noise). ``n_tasks`` is
    the bound's task count: the learner's meta-train tasks, not the test tasks.
    """

    MAX_LAUNCH = 512

    @spanned(TRAINER_BUILD)
    def __init__(self, X, Y, mask, *, hidden, lr, task_kl_weight, meta_kl_weight, delta,
                 n_tasks, weight_prior_std, bias_prior_std):
        self.X, self.Y, self.mask = X, Y, mask
        self.lr = float(lr)
        self.kw = dict(hidden=tuple(int(h) for h in hidden), wps=float(weight_prior_std),
                       bps=float(bias_prior_std), task_kl_weight=float(task_kl_weight),
                       meta_kl_weight=float(meta_kl_weight), delta=float(delta),
                       n_tasks=int(n_tasks), meta_test=True)

    def launches(self, n_steps):
        return staircase_launches(0, n_steps, self.MAX_LAUNCH)

    def run(self, params, n_steps, eps_block):
        """n_steps of inference on ``params`` (STATE_KEYS; q_means and q_trils
        updated in place); returns the last step's loss."""
        mu = {k: torch.zeros_like(params[k]) for k in Q_KEYS}
        nu = {k: torch.zeros_like(params[k]) for k in Q_KEYS}
        last = None
        for s, sub in self.launches(n_steps):
            with span(TRAINER_PAGES):
                eps = eps_block(s, sub)
            with span(TRAINER_LAUNCH):
                last, _, _ = fused_mlap_train(params, mu, nu, self.X, self.Y, self.mask, eps,
                                              None, s, 0.0, self.lr, n_steps=sub, **self.kw)
            del eps  # freed before the next block is drawn, which may take its memory
        return last
