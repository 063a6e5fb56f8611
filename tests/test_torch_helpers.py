"""The JAX package's public helpers in the port, each against its JAX
function on the same seeded inputs, on the CPU.

Each helper exists under its JAX name in the port's module of the same
name. float32 values agree within rtol 1e-6 (``UnnormalizedExpDist``
exactly, ``inner_adapt``'s value and its gradient through the unroll within
1e-6, ``task_mll_flat`` in float64, where float32 rounds beyond 1e-6);
``make_lr_schedule`` equals optax's staircase at the steps around each
transition; ``CatDist`` samples its blocks in order from one
generator; ``rbf_median_gamma`` takes the mean of the two middles where
they differ, which the port's Stein transport does not.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu.ops.pallas import launch_sched as jax_sched
from meta_learning_pacoh_torch.ops import launch_sched

RTOL = 1e-6
HELPERS = [
    ("ops.distributions", "FactorizedNormal"), ("ops.distributions", "UnnormalizedExpDist"),
    ("ops.distributions", "CatDist"), ("ops.kernels", "rbf_ard_diag"),
    ("ops.svgd", "rbf_median_gamma"), ("models.random_gp", "task_mll_flat"),
    ("algos.base", "calib_error"), ("algos.maml", "inner_adapt"),
    ("algos.pacoh_map", "make_lr_schedule"), ("parallel.seed_parallel", "make_seed_mesh"),
]


def both(module):
    return (importlib.import_module("meta_learning_pacoh_tpu." + module),
            importlib.import_module("meta_learning_pacoh_torch." + module))


def f32(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("module, name", HELPERS)
def test_helper_exists_under_the_jax_name(module, name):
    jax_mod, port_mod = both(module)
    assert callable(getattr(jax_mod, name)) and callable(getattr(port_mod, name))


def test_make_seed_mesh_is_the_mesh_modules():
    from meta_learning_pacoh_torch.parallel import make_seed_mesh, mesh, seed_parallel

    assert seed_parallel.make_seed_mesh is mesh.make_seed_mesh is make_seed_mesh


# ------------------------------------------------------------------ distributions


@pytest.mark.parametrize("axis", [-1, 0])
def test_factorized_normal(axis):
    j, t = both("ops.distributions")
    rs = np.random.RandomState(0)
    loc, scale, value = f32(rs, 3, 4), np.exp(f32(rs, 3, 4)), f32(rs, 3, 4)
    want = j.FactorizedNormal(jnp.asarray(loc), jnp.asarray(scale), summation_axis=axis)
    got = t.FactorizedNormal(torch.from_numpy(loc), torch.from_numpy(scale), summation_axis=axis)
    np.testing.assert_allclose(got.log_prob(torch.from_numpy(value)).numpy(),
                               np.asarray(want.log_prob(jnp.asarray(value))), rtol=RTOL)
    assert np.array_equal(got.mean.numpy(), loc) and np.array_equal(got.stddev.numpy(), scale)


def test_unnormalized_exp_dist_exactly():
    j, t = both("ops.distributions")
    value = f32(np.random.RandomState(1), 5)

    def exponent(v):  # the same numbers from either package's array
        return -np.sum(np.asarray(v, dtype=np.float64) ** 2)

    assert t.UnnormalizedExpDist(exponent).log_prob(torch.from_numpy(value)) == \
        j.UnnormalizedExpDist(exponent).log_prob(jnp.asarray(value))


class _TorchBlock:
    def __init__(self, loc, scale):
        self.loc, self.scale = torch.tensor(loc), torch.tensor(scale)

    def sample(self, generator, shape=()):
        return self.loc + self.scale * torch.randn(tuple(shape) + self.loc.shape,
                                                   generator=generator)

    def log_prob(self, v):
        from meta_learning_pacoh_torch.ops.distributions import Normal

        return torch.sum(Normal(self.loc, self.scale).log_prob(v), dim=-1)


class _JaxBlock(_TorchBlock):
    def __init__(self, loc, scale):
        self.loc, self.scale = jnp.asarray(loc), jnp.asarray(scale)

    def sample(self, key, shape=()):
        return self.loc + self.scale * jax.random.normal(key, tuple(shape) + self.loc.shape)

    def log_prob(self, v):
        from meta_learning_pacoh_tpu.ops.distributions import Normal

        return jnp.sum(Normal(self.loc, self.scale).log_prob(v), axis=-1)


BLOCKS = ([[0.0, 0.5], [1.0, 2.0]], [[5.0], [2.0]], [[-1.0, 0.0, 1.0], [0.5, 0.5, 3.0]])


@pytest.mark.parametrize("reduce", [True, False])
def test_cat_dist(reduce):
    """log_prob against JAX's (summed or one row a block); a sample of shape
    (100,) is [100, 6], its blocks those the blocks draw in turn from one
    generator."""
    j, t = both("ops.distributions")
    dims = [len(loc) for loc, _ in BLOCKS]
    got = t.CatDist([_TorchBlock(*b) for b in BLOCKS], dims, reduce_event_dim=reduce)
    want = j.CatDist([_JaxBlock(*b) for b in BLOCKS], dims, reduce_event_dim=reduce)
    value = f32(np.random.RandomState(2), 7, 6)
    np.testing.assert_allclose(got.log_prob(torch.from_numpy(value)).numpy(),
                               np.asarray(want.log_prob(jnp.asarray(value))), rtol=RTOL)
    assert got.event_dim == want.event_dim == 6

    s = got.sample(torch.Generator().manual_seed(3), (100,))
    assert s.shape == (100, 6) and want.sample(jax.random.PRNGKey(0), (100,)).shape == (100, 6)
    gen = torch.Generator().manual_seed(3)
    parts = [b.sample(gen, (100,)) for b in got.dists]
    assert torch.equal(s, torch.cat(parts, dim=-1))
    assert abs(float(s[:, 2].mean()) - 5.0) < 0.6


# ------------------------------------------------------------------ kernels and SVGD


@pytest.mark.parametrize("outputscale", [1.0, 2.5, "per_batch"])
def test_rbf_ard_diag(outputscale):
    j, t = both("ops.kernels")
    rs = np.random.RandomState(4)
    x, ls = f32(rs, 2, 5, 3), np.exp(f32(rs, 3))
    os_ = np.exp(f32(rs, 2, 1)) if outputscale == "per_batch" else outputscale
    want = np.asarray(j.rbf_ard_diag(jnp.asarray(x), jnp.asarray(ls), jnp.asarray(os_)))
    got = t.rbf_ard_diag(torch.from_numpy(x), torch.from_numpy(ls), torch.as_tensor(os_))
    assert got.shape == want.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    k = t.rbf_ard(torch.from_numpy(x), torch.from_numpy(x), torch.from_numpy(ls),
                  torch.as_tensor(os_)[..., None])
    np.testing.assert_allclose(torch.diagonal(k, dim1=-2, dim2=-1).numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("k", [4, 5])
def test_rbf_median_gamma_takes_the_mean_of_the_middles(k):
    """At K=4 (16 distances, even) the two middles differ and both packages
    take their mean; at K=5 (25, odd) the middle itself."""
    j, t = both("ops.svgd")
    x = f32(np.random.RandomState(5), k, 7)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1).astype(np.float32)
    want = float(j.rbf_median_gamma(jnp.asarray(d2)))
    got = float(t.rbf_median_gamma(torch.from_numpy(d2)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    flat = np.sort(d2.ravel())
    lower, upper = flat[(flat.size - 1) // 2], flat[flat.size // 2]
    assert (lower != upper) == (k == 4)
    if k == 4:  # the rank K*K//2 statistic of rbf_phi and K1 gives another gamma
        h_upper = np.float32(upper) / np.float32(2.0 * np.log(k + 1))
        assert abs(1.0 / (1e-8 + 2.0 * h_upper) - got) > 1e-3 * got


# ------------------------------------------------------------------ models and metrics


def test_task_mll_flat():
    """Two particles of the hyper-prior, one task, with and without a masked
    point. Held in float64 on both sides (``jax.enable_x64``, float64
    tensors), within 1e-12: in float32 each package's value parts from its
    float64 value by up to 2.4e-5 of it here (the JAX function's -3.149475
    against -3.149549), above 1e-6, so float32 against float32 shows only
    rounding. The
    port's float32 value is held to the float64 value within 1e-4."""
    from meta_learning_pacoh_tpu.models import random_gp as jrg
    from meta_learning_pacoh_torch.models import random_gp as trg

    layers = dict(mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8))
    hp_j = jrg.make_hyper_prior(jrg.random_gp_config(1, feature_dim=2, **layers))
    hp_t = trg.make_hyper_prior(trg.random_gp_config(1, feature_dim=2, **layers))
    hp_t64 = trg.HyperPrior(hp_t.loc.double(), hp_t.scale.double(), hp_t.layout, hp_t.cfg)
    particles = np.array(hp_j.sample(jax.random.PRNGKey(1), (2,)))
    rs = np.random.RandomState(6)
    x, y = f32(rs, 6, 1), f32(rs, 6)
    mask = np.ones(6, np.float32)
    mask[4] = 0.0
    for m in (None, mask):
        with jax.enable_x64():
            x64, y64, m64 = (None if a is None else jnp.asarray(a, jnp.float64)
                             for a in (x, y, m))
            want = [float(jrg.task_mll_flat(hp_j, jnp.asarray(p, jnp.float64), x64, y64,
                                            mask=m64)) for p in particles]
        args = [torch.from_numpy(a) for a in (particles, x, y)]
        tm = None if m is None else torch.from_numpy(m)
        got = trg.task_mll_flat(hp_t64, *[a.double() for a in args],
                                mask=None if tm is None else tm.double())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
        got32 = trg.task_mll_flat(hp_t, *args, mask=tm)
        one = trg.task_mll_flat(hp_t, args[0][0], *args[1:], mask=tm)
        assert got32.shape == (2,) and got32.dtype == torch.float32 and one.shape == ()
        np.testing.assert_allclose(got32.numpy(), want, rtol=1e-4)
        assert float(one) == float(got32[0])


@pytest.mark.parametrize("n", [20, 57])
def test_calib_error(n):
    from meta_learning_pacoh_tpu.algos.base import calib_error as jax_calib
    from meta_learning_pacoh_tpu.ops.distributions import Normal as JaxNormal
    from meta_learning_pacoh_torch.algos.base import calib_error
    from meta_learning_pacoh_torch.ops.distributions import Normal

    rs = np.random.RandomState(n)
    loc, scale, y = f32(rs, n), np.exp(f32(rs, n)), rs.randn(n, 1)  # y float64, 2-D
    want = jax_calib(JaxNormal(jnp.asarray(loc), jnp.asarray(scale)), y)
    got = calib_error(Normal(torch.from_numpy(loc), torch.from_numpy(scale)), y)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=RTOL)


# ------------------------------------------------------------------ MAML's inner loop


@pytest.mark.parametrize("num_steps", [1, 3])
def test_inner_adapt_value_and_gradient_through_the_unroll(num_steps):
    """The adapted parameters, and the gradient of an outer MSE of them with
    respect to the initial ones (second order through the unroll), against
    jax.grad of the JAX function: within 1e-6."""
    from meta_learning_pacoh_tpu.algos.maml import inner_adapt as jax_adapt
    from meta_learning_pacoh_tpu.models.mlp import init_mlp_params, mlp_apply as jax_apply
    from meta_learning_pacoh_torch.algos.maml import inner_adapt
    from meta_learning_pacoh_torch.models.mlp import mlp_apply

    params = {k: np.array(v) for k, v in
              init_mlp_params(jax.random.PRNGKey(2), 1, 1, (16, 16)).items()}
    rs = np.random.RandomState(7)
    x, y, xo, yo = f32(rs, 6, 1), f32(rs, 6, 1), f32(rs, 8, 1), f32(rs, 8, 1)

    def jax_outer(p):
        adapted = jax_adapt(p, x, y, 0.1, num_steps)
        return jnp.mean((jax_apply(adapted, xo) - yo) ** 2), adapted

    (want_loss, want_adapted), want_grad = jax.value_and_grad(jax_outer, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()})

    start = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    adapted = inner_adapt(start, torch.from_numpy(x), torch.from_numpy(y), 0.1, num_steps)
    out = mlp_apply({k: w[None] for k, w in adapted.items()}, torch.from_numpy(xo)[None])[0]
    loss = torch.mean((out - torch.from_numpy(yo)) ** 2)
    grads = torch.autograd.grad(loss, list(start.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL)
    for (k, g), w in zip(start.items(), grads):
        np.testing.assert_allclose(adapted[k].detach().numpy(), np.asarray(want_adapted[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(w.numpy(), np.asarray(want_grad[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    plain = inner_adapt({k: v.detach() for k, v in start.items()}, torch.from_numpy(x),
                        torch.from_numpy(y), 0.1, num_steps)
    assert all(torch.equal(plain[k], adapted[k]) for k in params)


# ------------------------------------------------------------------ lr schedule


@pytest.mark.parametrize("transition", [None, 3])
def test_make_lr_schedule_is_the_optax_staircase(monkeypatch, transition):
    """At the steps around each of the first transitions (the default 1,000,
    and 3 set in both packages): optax's value within rtol 1e-6; without
    decay both return the lr itself."""
    j, t = both("algos.pacoh_map")
    if transition is not None:
        monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", transition)
        monkeypatch.setattr(jax_sched, "LR_TRANSITION_STEPS", transition)
    period = launch_sched.LR_TRANSITION_STEPS
    want, got = j.make_lr_schedule(1e-3, 0.7), t.make_lr_schedule(1e-3, 0.7)
    steps = sorted({max(0, m * period + d) for m in range(4) for d in (-1, 0, 1)})
    for s in steps:
        np.testing.assert_allclose(got(s), float(want(s)), rtol=RTOL, err_msg=str(s))
    assert got(period) < got(period - 1)
    assert t.make_lr_schedule(1e-3, 1.0) == j.make_lr_schedule(1e-3, 1.0) == 1e-3
