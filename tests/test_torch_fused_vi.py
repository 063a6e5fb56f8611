"""The port's fused PACOH-VI training path and posterior helpers against the JAX package's.

On the CPU ``fused_vi_train`` takes its plain version (autograd of the
negative ELBO, the optax Adam update); the JAX side runs the Pallas
mega-kernel ``fused_vi_train_packed`` in interpret mode, as the JAX
package's own tests do, on state converted with its ``pack_state`` /
``unpack_state`` and noise pages from its ``pack_eps_page``, and its
closed-form spec ``vi_step_closed_form``. Inputs and noise come from numpy
seeds at a small size: S=4 samples, T=4 tasks of N=5 points, D=1, hidden
(8, 8).

Comparisons leave out the kernel net's output bias: its true gradient is
exactly zero, so both its loc and its log_scale random-walk float noise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu.models import random_gp as jax_random_gp
from meta_learning_pacoh_tpu.ops.fused_vi_math import vi_step_closed_form
from meta_learning_pacoh_tpu.ops.pallas.fused_train_kernel import pack_state, unpack_state
from meta_learning_pacoh_tpu.ops.pallas.fused_vi_kernel import FusedVITrainer as JaxTrainer
from meta_learning_pacoh_tpu.ops.pallas.fused_vi_kernel import (
    fused_vi_train_packed,
    pack_eps_page,
)
from meta_learning_pacoh_torch.models import random_gp
from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk
from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

S, T, N, D = 4, 4, 5, 1
HIDDEN = (8, 8)
WPS, BPS, PF, LR = 0.5, 3.0, 0.01, 1e-3
COUNTS = np.array([[2, 0, 1, 1], [0, 1, 1, 2], [1, 1, 1, 1]], np.float32)


def _jax_prior():
    cfg = jax_random_gp.random_gp_config(D, feature_dim=1, mean_nn_layers=HIDDEN,
                                         kernel_nn_layers=HIDDEN)
    return jax_random_gp.make_hyper_prior(cfg, weight_prior_std=WPS, bias_prior_std=BPS)


def _inputs(seed, ragged, n_steps=3):
    """Tasks, a posterior with non-zero Adam moments, and each step's noise."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(-2.0, 2.0, (T, N, D)).astype(np.float32)
    y = (np.sin(2.0 * x[..., 0]) + 0.1 * rs.randn(T, N)).astype(np.float32)
    mask = np.ones((T, N), np.float32)
    if ragged:  # one padded point, as the learner pads: zero input and target
        mask[2, 4] = 0.0
        x[2, 4], y[2, 4] = 0.0, 0.0
    hp = fk.fused_prior(D, HIDDEN, WPS, BPS)
    p = hp.dim
    loc = (hp.loc + 0.5 * hp.scale * torch.from_numpy(rs.randn(p).astype(np.float32))).numpy()
    lsc = (math.log(0.1) + 0.1 * rs.randn(p)).astype(np.float32)
    moments = [(0.01 * rs.randn(p)).astype(np.float32) for _ in range(2)]
    moments += [(1e-4 * rs.rand(p)).astype(np.float32) for _ in range(2)]
    eps = rs.randn(n_steps, S, p).astype(np.float32)
    return x, y, mask, [loc, lsc] + moments, eps


def _keep():
    keep = np.ones(fk.fused_prior(D, HIDDEN, WPS, BPS).dim, bool)
    keep[fk.fused_prior(D, HIDDEN, WPS, BPS).slice_of(("kernel_nn", "b_out"))] = False
    return keep


def _jax_trainer(x, mask, batch=None):
    hp = _jax_prior()
    post = {"loc": jnp.zeros(hp.dim), "log_scale": jnp.zeros(hp.dim)}
    return JaxTrainer(hp, post, jnp.asarray(x), jnp.zeros((T, N)), jnp.asarray(mask),
                      hidden=HIDDEN, lr=LR, prior_factor=PF, weight_prior_std=WPS,
                      bias_prior_std=BPS, svi_batch_size=S, base_key=jax.random.PRNGKey(0),
                      task_batch_size=batch, interpret=True)


def _jax_kernel_steps(x, y, mask, state, eps, step0, counts=None):
    """fused_vi_train_packed (interpret) from the flat state; returns the six
    flat state arrays and the last and mean loss."""
    hp = _jax_prior()
    tr = _jax_trainer(x, mask, None if counts is None else int(counts[0].sum()))
    packed = [pack_state(hp, jnp.asarray(a)[None], HIDDEN) for a in state]
    pages = jnp.stack([pack_eps_page(hp, jnp.asarray(e), HIDDEN) for e in eps])
    count_pages = None
    if counts is not None:  # [n_steps, Tpad8, 128], counts in lane 0
        count_pages = np.zeros((len(eps), 8, 128), np.float32)
        count_pages[:, :T, 0] = counts
        count_pages = jnp.asarray(count_pages)

    def n_major(a):
        return jnp.asarray(np.transpose(a, (1, 0, 2)).reshape(N * T, -1))

    out = fused_vi_train_packed(
        *packed, n_major(x), n_major(y[..., None]), n_major(mask[..., None]), tr.w_t,
        eps_pages=pages, step0=float(step0), S=S, T=T, N=N, D=D, hidden=HIDDEN, lr=LR,
        prior_factor=PF, wps=WPS, bps=BPS, mll_const=tr.mll_const, lp_const=tr.lp_const,
        ent_const=tr.ent_const, n_steps=len(eps), counts_pages=count_pages, interpret=True)
    flat = [np.asarray(unpack_state(hp, o, HIDDEN, 1)[0]) for o in out[:6]]
    return flat, float(out[6]), float(out[7])


def _port_steps(x, y, mask, state, eps, step0, counts=None):
    batch = None if counts is None else int(counts[0].sum())
    got = [torch.from_numpy(a.copy()) for a in state]
    last, mean = vk.fused_vi_train(
        *got, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask),
        torch.from_numpy(fk.task_weights(mask, batch)), torch.from_numpy(eps), step0, LR, PF,
        None if counts is None else torch.from_numpy(counts), hidden=HIDDEN, wps=WPS, bps=BPS,
        mll_const=vk.mll_constant(mask, batch), n_steps=len(eps))
    return [g.numpy() for g in got], float(last), float(mean)


@pytest.mark.parametrize("mode", ["full_batch", "counted"])
def test_plain_fused_steps_match_pallas_kernel(mode):
    """Three steps from one state (non-zero Adam moments, step0 7) with one
    set of noise: loc and log_scale rtol 2e-4 and atol 2e-6, as
    tests/test_fused_vi.py holds the Pallas kernel to its spec; the Adam
    moments to 1e-4 of their largest value; the last and the mean loss rtol
    1e-5. The counted mode feeds both sides the same count pages, one task
    never drawn in a step."""
    counted = mode == "counted"
    x, y, mask, state, eps = _inputs(seed=1, ragged=not counted)
    counts = COUNTS if counted else None
    want, want_last, want_mean = _jax_kernel_steps(x, y, mask, state, eps, 7, counts)
    got, last, mean = _port_steps(x, y, mask, state, eps, 7, counts)
    keep = _keep()
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g[keep], w[keep], rtol=2e-4, atol=2e-6)
    for g, w in zip(got[2:], want[2:]):
        assert np.abs(g - w)[keep].max() <= 1e-4 * np.abs(w).max()
    np.testing.assert_allclose([last, mean], [want_last, want_mean], rtol=1e-5)
    assert np.abs(got[0] - state[0])[keep].max() > 1e-3  # the steps moved it


def test_plain_fused_steps_match_closed_form_spec():
    """The same three full-batch steps against ``vi_step_closed_form``, the
    hand-derived spec of the Pallas kernel (its bias corrections in double
    precision): loc and log_scale rtol 2e-4, atol 2e-6; loss rtol 1e-5."""
    x, y, mask, state, eps = _inputs(seed=2, ragged=True)
    hp = _jax_prior()
    post = {"loc": jnp.asarray(state[0]), "log_scale": jnp.asarray(state[1])}
    m = {"loc": jnp.asarray(state[2]), "log_scale": jnp.asarray(state[3])}
    v = {"loc": jnp.asarray(state[4]), "log_scale": jnp.asarray(state[5])}
    for i in range(len(eps)):
        post, m, v, loss = vi_step_closed_form(
            post, m, v, 7.0 + i, jnp.asarray(eps[i]), jnp.asarray(x), jnp.asarray(y),
            jnp.asarray(mask), hp, prior_factor=PF, weight_prior_std=WPS, bias_prior_std=BPS,
            lr=LR)
    got, last, _ = _port_steps(x, y, mask, state, eps, 7)
    keep = _keep()
    for g, k in zip(got[:2], ("loc", "log_scale")):
        np.testing.assert_allclose(g[keep], np.asarray(post[k])[keep], rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(last, float(loss), rtol=1e-5)


@pytest.mark.parametrize("mode", ["full_batch", "counted"])
def test_constants_match_jax_trainer(mode):
    """The task weights, the MLL constant and the prior and entropy constants
    the kernel takes equal the JAX trainer's."""
    counted = mode == "counted"
    x, _, mask, _, _ = _inputs(seed=3, ragged=not counted)
    batch = 3 if counted else None
    tr = _jax_trainer(x, mask, batch)
    np.testing.assert_allclose(fk.task_weights(mask, batch), np.asarray(tr.w_t)[:, 0], rtol=1e-7)
    assert vk.mll_constant(mask, batch) == pytest.approx(tr.mll_const, rel=1e-12)
    lp, ent = vk.prior_constants(D, HIDDEN, WPS, BPS)
    assert (lp, ent) == pytest.approx((tr.lp_const, tr.ent_const), rel=1e-12)


@pytest.mark.parametrize("cov_type", ["diag", "full"])
def test_posterior_helpers_match_jax(cov_type):
    """scale_tril, log-diagonal, stddev, rsample, log_prob, entropy and the KL
    to the hyper-prior of one posterior, from numpy numbers: rtol 1e-5."""
    rs = np.random.RandomState(4)
    hp = fk.fused_prior(D, HIDDEN, WPS, BPS)
    p = hp.dim
    post = {"loc": (0.1 * rs.randn(p)).astype(np.float32)}
    if cov_type == "diag":
        post["log_scale"] = (math.log(0.1) + 0.1 * rs.randn(p)).astype(np.float32)
    else:
        raw = np.tril(0.01 * rs.randn(p, p)) + np.diag(np.log(rs.uniform(0.05, 0.1, p)))
        post["tril_raw"] = raw.astype(np.float32)
    eps = rs.randn(3, p).astype(np.float32)
    port = {k: torch.from_numpy(v) for k, v in post.items()}
    jpost = {k: jnp.asarray(v) for k, v in post.items()}
    samples = random_gp.posterior_rsample(port, torch.from_numpy(eps))
    if cov_type == "diag":
        want_samples = jpost["loc"] + jnp.exp(jpost["log_scale"]) * eps
    else:
        want_samples = jpost["loc"] + eps @ jax_random_gp.posterior_scale_tril(jpost).T
    np.testing.assert_allclose(samples.numpy(), np.asarray(want_samples), rtol=1e-5, atol=1e-6)
    pairs = [
        (random_gp.posterior_scale_tril(port), jax_random_gp.posterior_scale_tril(jpost)),
        (random_gp.posterior_log_diag(port), jax_random_gp.posterior_log_diag(jpost)),
        (random_gp.posterior_stddev(port), jax_random_gp.posterior_stddev(jpost)),
        (random_gp.posterior_log_prob(port, samples),
         jax_random_gp.posterior_log_prob(jpost, jnp.asarray(samples.numpy()))),
        (random_gp.posterior_entropy(port), jax_random_gp.posterior_entropy(jpost)),
        (random_gp.posterior_kl_to_prior(port, hp),
         jax_random_gp.posterior_kl_to_prior(jpost, _jax_prior())),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("cov_type", ["diag", "full"])
def test_init_posterior_shapes_and_ranges(cov_type):
    """The initial posterior as the JAX package draws it: loc ~ N(0, 0.1^2);
    diag log_scale ~ log 0.1 + N(0, 0.1^2); full tril_raw diagonal with
    exp(diag) in [0.05, 0.1]. A seed draws the same numbers twice."""
    gen = torch.Generator().manual_seed(0)
    post = random_gp.init_posterior(gen, 3000, cov_type=cov_type)
    assert post["loc"].dtype == torch.float32 and abs(float(post["loc"].std()) - 0.1) < 0.01
    if cov_type == "diag":
        assert abs(float(post["log_scale"].mean()) - math.log(0.1)) < 0.01
    else:
        raw = post["tril_raw"]
        assert torch.equal(raw, torch.diag(torch.diagonal(raw)))
        scale = torch.exp(torch.diagonal(raw))
        assert float(scale.min()) >= 0.05 - 1e-7 and float(scale.max()) <= 0.1 + 1e-7
    again = random_gp.init_posterior(torch.Generator().manual_seed(0), 3000, cov_type=cov_type)
    assert all(torch.equal(post[k], again[k]) for k in post)


def test_trainer_pages_and_launches():
    """The trainer's noise and count pages are the draws it is given, for the
    global steps of a launch; launches hold at most 512 steps and cross no
    staircase boundary."""
    x, y, mask, _, _ = _inputs(seed=5, ragged=False)
    p = fk.fused_prior(D, HIDDEN, WPS, BPS).dim

    def eps_draw(step, out):
        out.copy_(torch.full((S, p), float(step)))

    def task_draw(step):
        return torch.tensor([step % T, (step + 1) % T])

    tr = vk.FusedVITrainer(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask),
                           hidden=HIDDEN, lr=LR, prior_factor=PF, weight_prior_std=WPS,
                           bias_prior_std=BPS, svi_batch_size=S, eps_draw=eps_draw,
                           lr_decay=0.5, task_batch_size=2, task_draw=task_draw)
    pages = tr.eps_pages(10, 3)
    assert pages.shape == (3, S, p) and [float(pg[0, 0]) for pg in pages] == [10.0, 11.0, 12.0]
    counts = tr.count_pages(10, 2)
    assert counts.tolist() == [[0, 0, 1, 1], [1, 0, 0, 1]]
    assert list(tr.launches(10, 1100)) == [(10, 512), (522, 478), (1000, 110)]


def test_wrapper_checks_its_operands():
    x, y, mask, state, eps = _inputs(seed=6, ragged=False)
    args = [torch.from_numpy(a) for a in state] + [torch.from_numpy(a) for a in (x, y, mask)]
    w_t = torch.from_numpy(fk.task_weights(mask))
    with pytest.raises(ValueError):  # wrong task weights
        vk.fused_vi_train(*args, torch.ones(T), torch.from_numpy(eps), 0, LR, PF, hidden=HIDDEN,
                          wps=WPS, bps=BPS, mll_const=vk.mll_constant(mask), n_steps=1)
    with pytest.raises(ValueError):  # wrong MLL constant
        vk.fused_vi_train(*args, w_t, torch.from_numpy(eps), 0, LR, PF, hidden=HIDDEN, wps=WPS,
                          bps=BPS, mll_const=1.0, n_steps=1)
    assert vk.fused_vi_fits(10, 20, 5, 1, (32, 32))
    assert vk.fused_vi_fits(3, 7, 7, 2, (16, 16, 16))
    assert not vk.fused_vi_fits(33, 20, 5, 1, (32, 32))
    assert not vk.fused_vi_fits(10, 20, 9, 1, (32, 32))
    assert not vk.fused_vi_fits(10, 20, 5, 1, (32, 16))
    assert vk.fused_vi_fits(10, 400, 8, 1, (32, 32))  # any task count: tiles
    assert not vk.fused_vi_fits(10, 20, 5, 1, (256, 256))  # shared memory
