"""The fused PACOH-MLAP kernel's plain version (ops/cuda/fused_mlap_kernel.py) against the JAX package.

``mlap_loss_and_grads`` against the JAX closed-form spec
(ops/fused_mlap_math.py) on the same parameters, noise and task counts,
ragged tasks included; the meta-test mode against ``jax.grad`` of the JAX
learner's meta-test loss; three steps of ``fused_mlap_train_ref`` against
three steps of the spec (or that gradient) and the JAX learner's optax
update. The CUDA kernel is held against this plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 2).

The inputs come from chip_smoke.py's ``conditioned_tasks`` and
``conditioned_params``: inputs evenly spread in each task and a kernel net
that maps them to features about two lengthscales apart. At a learner's initial state the
inner KL's gram (no noise, 1e-6 jitter) is singular to float32, and two
float32 orders of the same step part at the percent level, in the JAX
package's own tests too (tests/test_fused_mlap.py); here they agree to
float32 rounding, so the tolerances are: loss rtol 1e-5, every gradient
within 1e-4 of its largest entry, the state after three steps within 1e-5
(a hundredth of one step's reach at lr 1e-3). State comparisons leave out
the kernel net's output bias: its true score is exactly zero, so its Adam
steps follow float noise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from meta_learning_pacoh_tpu import GPRegressionMetaLearnedPAC as JaxPAC
from meta_learning_pacoh_tpu.models.random_gp import posterior_kl_to_prior
from meta_learning_pacoh_tpu.ops.fused_mlap_math import mlap_loss_and_grads as jax_spec
from meta_learning_pacoh_torch.ops import launch_sched
from meta_learning_pacoh_torch.ops.cuda import fused_mlap_kernel as mk
from meta_learning_pacoh_torch.ops.cuda.fused_svgd_kernel import _prior_on

import chip_smoke
from chip_smoke import conditioned_tasks

HIDDEN = (8, 8)
JAX_KW = dict(num_iter_fit=10, random_seed=1, covar_module="NN", mean_module="NN",
              svi_batch_size=3, meta_kl_weight=1e-3, task_kl_weight=0.5,
              mean_nn_layers=HIDDEN, kernel_nn_layers=HIDDEN)
BOUND = dict(task_kl_weight=0.5, meta_kl_weight=1e-3, delta=0.1)


def conditioned_params(jax_model, rs):
    """chip_smoke.py's well-conditioned state for a JAX learner (numpy pytree)."""
    t, n, d = np.shape(jax_model.X)
    hp = _prior_on(d, tuple(jax_model.cfg.kernel_nn_layers), 0.5, 3.0, torch.device("cpu"))
    return chip_smoke.conditioned_params(hp, np.asarray(jax_model.mask),
                                         jax_model.params["raw_noise"], rs)


def flat_params(params):
    """A JAX parameter pytree -> the port's flat state dict of CPU tensors."""
    post = params["hyper_post"]
    return {"loc": torch.tensor(np.asarray(post["loc"])),
            "log_scale": torch.tensor(np.asarray(post["log_scale"])),
            **{k: torch.tensor(np.asarray(params[k])) for k in ("q_means", "q_trils",
                                                             "raw_noise")}}


def _learner(ragged, **kw):
    rs = np.random.RandomState(3 if ragged else 2)
    sizes = (5, 3, 5, 4, 5, 2) if ragged else None
    model = JaxPAC(conditioned_tasks(rs, 6, 5, sizes=sizes), **dict(JAX_KW, **kw))
    model.params = jax.tree.map(jnp.asarray, conditioned_params(model, rs))
    return model, rs


def _data(model):
    return tuple(torch.tensor(np.asarray(a, np.float32)) for a in (model.X, model.Y, model.mask))


def _jax_meta_test_loss(model, eps, Xc, Yc, Mc):
    """The JAX learner's meta-test loss (algos/pacoh_mlap.py make_loss) of
    q = {'q_means', 'q_trils'} with the sample noise eps given."""
    post = model.params["hyper_post"]
    theta = post["loc"][None, :] + jnp.exp(post["log_scale"])[None, :] * eps
    kl_outer = model.meta_kl_weight * posterior_kl_to_prior(post, model.hyper_prior)
    noise_var = model._noise_var(model.params["raw_noise"])

    def loss(q):
        def one(qm, qt, x, y, m):
            return model._task_bound(qm, qt, x, y, theta, noise_var, kl_outer,
                                     float(model.n_tasks), mask=m)[0]

        return jnp.sum(jax.vmap(one)(q["q_means"], q["q_trils"], Xc, Yc, Mc))

    return loss


def _assert_leaves(got, want, keys):
    for k in keys:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30), err_msg=k)


@pytest.mark.parametrize("counted", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_loss_and_grads_match_jax_spec(ragged, counted):
    model, rs = _learner(ragged)
    eps = rs.randn(3, model.hyper_prior.dim).astype(np.float32)
    counts = (np.bincount(rs.randint(0, 6, 6), minlength=6) if counted
              else np.ones(6)).astype(np.float32)
    X, Y, M = _data(model)
    loss_j, g_j, diag_j = jax_spec(model.params, jnp.asarray(eps), jnp.asarray(counts),
                                   *(jnp.asarray(a.numpy()) for a in (X, Y, M)),
                                   model.hyper_prior, **BOUND)
    hp = _prior_on(1, HIDDEN, 0.5, 3.0, torch.device("cpu"))
    loss, grads, diag = mk.mlap_loss_and_grads(
        flat_params(model.params), torch.from_numpy(eps),
        torch.from_numpy(counts) if counted else None, X, Y, M, hp, **BOUND)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for k in diag_j:
        np.testing.assert_allclose(float(diag[k]), float(diag_j[k]), rtol=1e-5, err_msg=k)
    want = {"loc": g_j["hyper_post"]["loc"], "log_scale": g_j["hyper_post"]["log_scale"],
            **{k: g_j[k] for k in ("q_means", "q_trils", "raw_noise")}}
    _assert_leaves(grads, want, mk.STATE_KEYS)


@pytest.mark.parametrize("ragged", [False, True])
def test_meta_test_mode_matches_jax_learner_loss(ragged):
    """Meta-test mode: the sum of the per-task bounds over the context sets
    (their own T) with the meta-train task count in c_t, and its q-side
    gradient, against jax.grad of the JAX learner's meta-test loss."""
    model, rs = _learner(False)
    sizes = (5, 2, 4, 5) if ragged else None
    ctx = JaxPAC(conditioned_tasks(rs, 4, 5, sizes=sizes), **JAX_KW)
    Xc, Yc, Mc = (np.asarray(a, np.float32) for a in (ctx.X, ctx.Y, ctx.mask))
    q = {"q_means": (0.1 * rs.randn(4, 5) * Mc).astype(np.float32),
         "q_trils": (np.tril(0.1 * rs.randn(4, 5, 5)) + np.eye(5)).astype(np.float32)}
    eps = rs.randn(3, model.hyper_prior.dim).astype(np.float32)
    loss_fn = _jax_meta_test_loss(model, jnp.asarray(eps), *(jnp.asarray(a)
                                                              for a in (Xc, Yc, Mc)))
    loss_j, g_j = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, q))
    params = flat_params({**model.params, **q})
    hp = _prior_on(1, HIDDEN, 0.5, 3.0, torch.device("cpu"))
    loss, grads, _ = mk.mlap_loss_and_grads(
        params, torch.from_numpy(eps), None, *(torch.from_numpy(a) for a in (Xc, Yc, Mc)), hp,
        n_tasks=model.n_tasks, meta_test=True, **BOUND)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    assert set(grads) == set(mk.Q_KEYS)
    _assert_leaves(grads, g_j, mk.Q_KEYS)


def test_plain_steps_match_spec_and_optax_in_two_groups():
    """Three steps of fused_mlap_train_ref (lr 1e-3 and, for the posteriors,
    2e-3) against three spec steps and the JAX learner's optax update."""
    model, rs = _learner(True, posterior_lr_multiplier=2.0)
    X, Y, M = _data(model)
    eps = rs.randn(3, 3, model.hyper_prior.dim).astype(np.float32)
    counts = np.stack([np.bincount(rs.randint(0, 6, 6), minlength=6)
                       for _ in range(3)]).astype(np.float32)
    params, opt_state = model.params, model.opt_state
    for i in range(3):
        loss_j, g_j, _ = jax_spec(params, jnp.asarray(eps[i]), jnp.asarray(counts[i]),
                                  *(jnp.asarray(a.numpy()) for a in (X, Y, M)),
                                  model.hyper_prior, **BOUND)
        updates, opt_state = model._opt.update(g_j, opt_state, params)
        params = optax.apply_updates(params, updates)
    state = flat_params(model.params)
    mu = {k: torch.zeros_like(v) for k, v in state.items()}
    nu = {k: torch.zeros_like(v) for k, v in state.items()}
    loss, _, _ = mk.fused_mlap_train_ref(
        state, mu, nu, X, Y, M, torch.from_numpy(eps), torch.from_numpy(counts), 0, 1e-3, 2e-3,
        hidden=HIDDEN, wps=0.5, bps=3.0, n_tasks=6, n_steps=3, **BOUND)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    want = flat_params(params)
    keep = np.ones(model.hyper_prior.dim, bool)  # the kernel net's output bias: see below
    keep[_prior_on(1, HIDDEN, 0.5, 3.0, torch.device("cpu")).slice_of(("kernel_nn", "b_out"))] = 0
    for k in mk.STATE_KEYS:
        got, w = state[k].numpy(), want[k].numpy()
        if k in ("loc", "log_scale"):
            got, w = got[keep], w[keep]
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5, err_msg=k)


def test_plain_meta_test_steps_match_jax_optax():
    """Three meta-test steps (Adam at lr 1e-2 on the posteriors alone)
    against jax.grad of the JAX learner's meta-test loss and optax.adam."""
    model, rs = _learner(False)
    ctx = JaxPAC(conditioned_tasks(rs, 4, 5), **JAX_KW)
    Xc, Yc, Mc = (np.asarray(a, np.float32) for a in (ctx.X, ctx.Y, ctx.mask))
    q0 = {"q_means": (0.1 * rs.randn(4, 5)).astype(np.float32),
          "q_trils": (np.tril(0.1 * rs.randn(4, 5, 5)) + np.eye(5)).astype(np.float32)}
    eps = rs.randn(3, 3, model.hyper_prior.dim).astype(np.float32)
    opt = optax.adam(1e-2)
    q = jax.tree.map(jnp.asarray, q0)
    st = opt.init(q)
    for i in range(3):
        loss_fn = _jax_meta_test_loss(model, jnp.asarray(eps[i]),
                                      *(jnp.asarray(a) for a in (Xc, Yc, Mc)))
        loss_j, g = jax.value_and_grad(loss_fn)(q)
        updates, st = opt.update(g, st, q)
        q = optax.apply_updates(q, updates)
    state = flat_params({**model.params, **q0})
    frozen = {k: state[k].clone() for k in ("loc", "log_scale", "raw_noise")}
    mu = {k: torch.zeros_like(state[k]) for k in mk.Q_KEYS}
    nu = {k: torch.zeros_like(state[k]) for k in mk.Q_KEYS}
    loss, _, _ = mk.fused_mlap_train_ref(
        state, mu, nu, *(torch.from_numpy(a) for a in (Xc, Yc, Mc)), torch.from_numpy(eps),
        None, 0, 0.0, 1e-2, hidden=HIDDEN, wps=0.5, bps=3.0, n_tasks=6, meta_test=True,
        n_steps=3, **BOUND)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    for k in mk.Q_KEYS:
        np.testing.assert_allclose(state[k].numpy(), np.asarray(q[k]), rtol=0, atol=1e-5)
    for k, v in frozen.items():
        assert torch.equal(state[k], v)


def test_kernel_window_and_constants():
    """The kernel takes the sin_20 mlap shapes (39 KB of shared memory a CTA
    in clusters of 8) and 400 tasks of 8 points (the tiled kernel: 235
    floats of a cluster's scratch a task), and refuses more than 32 samples, 9
    points, two widths, or nets whose sample is beyond a block's shared
    memory; the hyper-prior's log-scale sum is the JAX trainer's Python
    float."""
    assert mk.fused_mlap_fits(5, 20, 5, 1, (32, 32))
    assert mk.smem_bytes(20, 5, 1, (32, 32), 2308, 8, 33) == 4 * 9765
    assert not mk.fused_mlap_fits(33, 20, 5, 1, (32, 32))
    assert not mk.fused_mlap_fits(5, 20, 9, 1, (32, 32))
    assert not mk.fused_mlap_fits(5, 20, 5, 1, (32, 16))
    assert mk.fused_mlap_fits(5, 400, 8, 1, (32, 32))
    c, hs, tile = mk.cluster_plan(5, 400, 8, 1, (32, 32))
    assert tile < -(-400 // c) and mk.tile_floats(400, 8) == 400 * (3 * 8 * 9 + 2 * 8 + 3)
    assert not mk.fused_mlap_fits(5, 20, 5, 1, (256, 256))
    hp = _prior_on(2, (16, 16, 16), 0.5, 3.0, torch.device("cpu"))
    assert math.isclose(mk.sum_log_prior_scale(2, (16, 16, 16), 0.5, 3.0),
                        float(torch.sum(torch.log(hp.scale.double()))), rel_tol=1e-9)


def test_trainer_pages_and_launch_plans(monkeypatch):
    """The trainer's launches split at 512 steps and at staircase
    boundaries; its count pages are the learner's draws with replacement at
    every step (the full batch too), its noise pages the learner's noise.
    The meta-test runs in 512-step launches."""
    from meta_learning_pacoh_torch import GPRegressionMetaLearnedPAC

    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 1000)
    rs = np.random.RandomState(0)
    port = GPRegressionMetaLearnedPAC(conditioned_tasks(rs, 6, 5), device="cpu", lr_decay=0.5,
                                      **{k: v for k, v in JAX_KW.items() if k != "num_iter_fit"})
    port._fused_run_chunk(1)
    trainer = port._fused
    assert list(trainer.launches(0, 1200)) == [(0, 512), (512, 488), (1000, 200)]
    counts = trainer.count_pages(7, 4)
    assert counts.shape == (4, 6) and torch.all(counts.sum(1) == 6)
    for i in range(4):
        assert torch.equal(counts[i], torch.bincount(port._task_draw(7 + i), minlength=6).float())
    eps = trainer.eps_pages(7, 2)
    want = torch.empty_like(eps[0])
    port._draw_eps(8, want)
    assert torch.equal(eps[1], want)
    meta = mk.FusedMLAPMetaTest(port.X, port.Y, port.mask, hidden=HIDDEN, lr=1e-2, n_tasks=6,
                                weight_prior_std=0.5, bias_prior_std=3.0, **BOUND)
    plan = list(meta.launches(3000))
    assert plan[:2] == [(0, 512), (512, 512)] and plan[-1] == (2560, 440)
