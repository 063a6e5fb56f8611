"""The port's custom GP modules and the learners that take them, against the JAX package.

Mirrors tests/test_custom_modules.py. Inputs are made from numpy seeds and go
to both packages; the port runs on the CPU, where its kernels' wrappers take
their plain versions (N=6 the unrolled expressions, 24 the K2/K3 plain
version, 60 the B4 one). The port's parameters carry the particle axis
(K=1 here, K=3 for the modules' own checks). Parameter comparisons leave out
the kernel net's output bias: its true gradient is exactly zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from meta_learning_pacoh_tpu import CosineKernel as JaxCosine
from meta_learning_pacoh_tpu import GPRegressionLearned as JaxGPR
from meta_learning_pacoh_tpu import GPRegressionMetaLearned as JaxMAP
from meta_learning_pacoh_tpu import LinearMean as JaxLinear
from meta_learning_pacoh_tpu import MaternKernel as JaxMatern
from meta_learning_pacoh_tpu.models import gp_base as jax_gp_base
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import (
    CosineKernel,
    GPRegressionLearned,
    GPRegressionMetaLearned,
    KernelModule,
    LinearMean,
    MaternKernel,
    MeanModule,
)
from meta_learning_pacoh_torch.models import gp_base
from meta_learning_pacoh_torch.models.random_gp import flat_layout, layout_slice, unravel_flat

NS = (6, 24, 60)
PORT_MODULES = {"cosine": CosineKernel(), "matern0.5": MaternKernel(0.5),
                "matern1.5": MaternKernel(1.5), "matern2.5": MaternKernel(2.5)}
JAX_MODULES = {"cosine": JaxCosine(), "matern0.5": JaxMatern(0.5), "matern1.5": JaxMatern(1.5),
               "matern2.5": JaxMatern(2.5)}


@pytest.fixture(autouse=True)
def clear_jit_cache():
    jit_cache.clear()
    yield
    jit_cache.clear()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _points(rs, n, d, duplicate=True):
    x = rs.randn(n, d).astype(np.float32)
    if duplicate:
        x[1] = x[0]  # d = 0 off the diagonal: the clamped distance's gradient
    return x


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("name", sorted(PORT_MODULES))
def test_kernel_grams_and_gradients_match_jax(name, d):
    """Three parameter sets (K=3) on 9 x 7 points with a duplicated pair:
    Grams atol 1e-6, and the gradients of a weighted sum of the Gram with
    respect to the parameters and both inputs atol 1e-6 of their largest
    entry (finite on the duplicated pair). The cosine kernel's argument
    reaches 20 rad, where XLA's and PyTorch's cos differ by 2e-6: 1e-5 there."""
    rs = np.random.RandomState(d)
    x1, x2 = _points(rs, 9, d), _points(rs, 7, d)
    x2[0] = x1[0]
    w = rs.randn(9, 7).astype(np.float32)
    raw = (0.5 * rs.randn(3, d)).astype(np.float32)
    jax_k, port_k = JAX_MODULES[name], PORT_MODULES[name]
    leaf = "period_raw" if name == "cosine" else "lengthscale_raw"
    raw = raw[:, 0] if name == "cosine" else raw

    def jax_sum(r, a, b):
        return jnp.sum(w * jax_k.gram({leaf: r}, a, b))

    for k in range(3):
        want = jax_k.gram({leaf: jnp.asarray(raw[k])}, jnp.asarray(x1), jnp.asarray(x2))
        want_g = jax.grad(jax_sum, argnums=(0, 1, 2))(jnp.asarray(raw[k]), jnp.asarray(x1),
                                                      jnp.asarray(x2))
        r = _t(raw).requires_grad_(True)
        a = _t(np.broadcast_to(x1, (3, 9, d))).requires_grad_(True)
        b = _t(np.broadcast_to(x2, (3, 7, d))).requires_grad_(True)
        got = port_k.gram({leaf: r}, a, b)
        got_g = torch.autograd.grad(torch.sum(_t(w) * got[k]), (r, a, b))
        tol = 1e-5 if name == "cosine" else 1e-6
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want), atol=tol)
        for g, wg in zip((got_g[0][k], got_g[1][k], got_g[2][k]), want_g):
            assert bool(torch.isfinite(g).all())
            scale = max(1.0, float(np.abs(np.asarray(wg)).max()))
            np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=0, atol=tol * scale)


@pytest.mark.parametrize("d", [1, 2])
def test_linear_mean_and_gradients_match_jax(d):
    """LinearMean over K=3 parameter sets: values and the gradients of a
    weighted sum atol 1e-6."""
    rs = np.random.RandomState(10 + d)
    x = rs.randn(11, d).astype(np.float32)
    w_vec, b = rs.randn(3, d).astype(np.float32), rs.randn(3).astype(np.float32)
    c = rs.randn(11).astype(np.float32)
    jax_m, port_m = JaxLinear(), LinearMean()
    params = {"w": _t(w_vec).requires_grad_(True), "b": _t(b).requires_grad_(True)}
    got = port_m.mean(params, _t(np.broadcast_to(x, (3, 11, d))))
    for k in range(3):
        def jax_sum(p):
            return jnp.sum(c * jax_m.mean(p, jnp.asarray(x)))

        p = {"w": jnp.asarray(w_vec[k]), "b": jnp.asarray(b[k])}
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(jax_m.mean(p, x)),
                                   atol=1e-6)
        want_g = jax.grad(jax_sum)(p)
        got_g = torch.autograd.grad(torch.sum(_t(c) * got[k]),
                                    (params["w"], params["b"]), retain_graph=True)
        np.testing.assert_allclose(got_g[0][k].numpy(), np.asarray(want_g["w"]), atol=1e-6)
        np.testing.assert_allclose(got_g[1][k].numpy(), np.asarray(want_g["b"]), atol=1e-6)


def test_modules_are_frozen_hashable_and_share_layouts():
    """Equal modules hash equal, so one GPConfig key and one cached flat
    layout; Matern takes only the closed-form nu; the protocol bases raise."""
    with pytest.raises(ValueError):
        MaternKernel(nu=2.0)
    assert MaternKernel(1.5) == MaternKernel(1.5) and hash(CosineKernel()) == hash(CosineKernel())
    with pytest.raises(Exception):
        MaternKernel(1.5).nu = 2.5
    cfg = gp_base.GPConfig(input_dim=2, covar_module=MaternKernel(1.5), mean_module=LinearMean())
    cfg2 = gp_base.GPConfig(input_dim=2, covar_module=MaternKernel(1.5), mean_module=LinearMean())
    assert flat_layout(cfg) is flat_layout(cfg2)
    with pytest.raises(NotImplementedError):
        KernelModule().gram({}, None, None)
    with pytest.raises(NotImplementedError):
        MeanModule().mean({}, None)


@pytest.mark.parametrize("mean_module", ["NN", "constant", "linear"])
@pytest.mark.parametrize("covar_module", ["NN", "cosine", "matern1.5"])
def test_flat_layout_with_custom_leaves_matches_ravel_pytree(mean_module, covar_module):
    """The custom leaves sit under custom_mean / custom_kernel in the JAX
    ravel order; a custom kernel owns its hyperparameters (no lengthscale,
    no outputscale), the noise stays."""
    def modules(jax_side):
        mean = {"linear": JaxLinear() if jax_side else LinearMean()}.get(mean_module, mean_module)
        covar = (JAX_MODULES if jax_side else PORT_MODULES).get(covar_module, covar_module)
        return dict(input_dim=2, mean_module=mean, covar_module=covar,
                    mean_nn_layers=(8,), kernel_nn_layers=(8,))

    jax_params = jax_gp_base.init_gp_params(jax_gp_base.GPConfig(**modules(True)),
                                            jax.random.PRNGKey(0))
    cfg = gp_base.GPConfig(**modules(False))
    layout = flat_layout(cfg)
    assert [p for p, _, _, _ in layout] == [
        tuple(str(getattr(k, "key", k)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jax_params)[0]]
    flat = np.random.RandomState(0).randn(ravel_pytree(jax_params)[0].size).astype(np.float32)
    want = ravel_pytree(jax_params)[1](jnp.asarray(flat))
    got = unravel_flat(layout, torch.from_numpy(flat))
    for path, _, _, _ in layout:
        g, w = got, want
        for key in path:
            g, w = g[key], w[key]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    custom_kernel = covar_module not in ("NN", "SE")
    assert ("lengthscale_raw" in cfg_keys(layout)) != custom_kernel
    assert "noise_raw" in cfg_keys(layout)


def cfg_keys(layout):
    return {p[0] for p, _, _, _ in layout}


def _gp_pair(mean_module, covar_module, d):
    mean_j = JaxLinear() if mean_module == "linear" else mean_module
    mean_p = LinearMean() if mean_module == "linear" else mean_module
    kw = dict(input_dim=d, has_outputscale=False, noise_floor=1e-4)
    jax_cfg = jax_gp_base.GPConfig(mean_module=mean_j, covar_module=JAX_MODULES[covar_module],
                                   **kw)
    cfg = gp_base.GPConfig(mean_module=mean_p, covar_module=PORT_MODULES[covar_module], **kw)
    return jax_cfg, cfg


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("covar_module", ["cosine", "matern0.5", "matern2.5"])
def test_prior_mll_value_and_grad_match_jax(covar_module, n):
    """gp_prior_mll with a custom kernel and LinearMean at N in {6, 24, 60}
    (D=1 for the cosine kernel, D=2 otherwise), the inputs with a duplicated
    point and the parameters moved off 0: the value rtol 1e-5, the gradient
    atol 1e-5 relative to its largest entry, all finite."""
    d = 1 if covar_module == "cosine" else 2
    rs = np.random.RandomState(n)
    x = _points(rs, n, d)
    y = rs.randn(n).astype(np.float32)
    jax_cfg, cfg = _gp_pair("linear", covar_module, d)
    jax_params = jax.tree.map(lambda a: a + 0.3 * jnp.ones_like(a),
                              jax_gp_base.init_gp_params(jax_cfg, jax.random.PRNGKey(0)))
    flat0, unravel = ravel_pytree(jax_params)
    want, want_g = jax.value_and_grad(
        lambda f: jax_gp_base.gp_prior_mll(jax_cfg, unravel(f), jnp.asarray(x),
                                           jnp.asarray(y)))(flat0)
    layout = flat_layout(cfg)
    flat = _t(flat0).requires_grad_(True)
    got = gp_base.gp_prior_mll(cfg, unravel_flat(layout, flat[None]), _t(x), _t(y))[0]
    (got_g,) = torch.autograd.grad(got, flat)
    assert bool(torch.isfinite(got_g).all())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    scale = float(np.abs(np.asarray(want_g)).max())
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=0, atol=1e-5 * scale)


def test_custom_kernel_grads_finite_on_duplicate_points():
    """tests/test_custom_modules.py's case on the port: identical rows make
    d = 0 off the diagonal, and the clamped distance keeps the gradient
    finite."""
    x = _t([[0.7], [0.7], [1.2]])
    y = _t([0.1, 0.1, -0.3])
    cfg = gp_base.GPConfig(input_dim=1, covar_module=MaternKernel(nu=1.5), mean_module="zero",
                           has_outputscale=False, noise_floor=1e-4)
    flat = torch.zeros(2, requires_grad=True)
    mll = gp_base.gp_prior_mll(cfg, unravel_flat(flat_layout(cfg), flat[None]), x, y)[0]
    (g,) = torch.autograd.grad(mll, flat)
    assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("covar_module", ["cosine", "matern2.5"])
def test_gp_predict_with_custom_modules_matches_jax(covar_module):
    """gp_predict with LinearMean and a custom kernel: the three Grams from
    the kernel on the raw inputs; mean and covariance atol 1e-5."""
    d = 1 if covar_module == "cosine" else 2
    rs = np.random.RandomState(7)
    x, xt = rs.randn(24, d).astype(np.float32), rs.randn(9, d).astype(np.float32)
    y = np.sin(3 * x[:, 0]).astype(np.float32)
    jax_cfg, cfg = _gp_pair("linear", covar_module, d)
    jax_params = jax.tree.map(lambda a: a + 0.2 * jnp.ones_like(a),
                              jax_gp_base.init_gp_params(jax_cfg, jax.random.PRNGKey(1)))
    mean_j, cov_j = jax_gp_base.gp_predict(jax_cfg, jax_params, jnp.asarray(x), jnp.asarray(y),
                                           jnp.asarray(xt))
    params = unravel_flat(flat_layout(cfg), _t(ravel_pytree(jax_params)[0])[None])
    mean, cov = gp_base.gp_predict(cfg, params, _t(x)[None], _t(y), _t(xt)[None])
    assert mean.shape == (1, 9) and cov.shape == (1, 9, 9)
    np.testing.assert_allclose(mean[0].numpy(), np.asarray(mean_j), atol=1e-5)
    np.testing.assert_allclose(cov[0].numpy(), np.asarray(cov_j), atol=1e-5)
    assert bool((torch.diagonal(cov[0]) > 0).all())


def _sin_data():
    """The reference's toy set (test_GPR.py:18-24): x in [-2, 2], y = sin(4x)."""
    x = np.linspace(-2, 2, num=60)
    return x, np.sin(4 * x)


def _gpr_pair(**kw):
    """A JAX CosineKernel learner and the port's started from its state."""
    x, y = _sin_data()
    jax_model = JaxGPR(x, y, covar_module=JaxCosine(), **kw)
    port = GPRegressionLearned(x, y, covar_module=CosineKernel(), device="cpu", **kw)
    port.load_state_dict(jax_model.state_dict())
    return jax_model, port


def _losses(fit, n_steps):
    return np.array([fit(n_iter=1, log_period=1, verbose=False) for _ in range(n_steps)])


@pytest.mark.parametrize("learning_mode", ["learn_kernel", "both"])
def test_cosine_gpr_trajectory_matches_jax(learning_mode):
    """GPR-MLL with a CosineKernel and a constant mean (the reference's
    custom-module test) on the 60-point sinusoid, from the JAX state moved
    by 0.3 (at 0 the constant mean's gradient is float noise, which Adam
    turns into steps of lr): 20 steps, the period and every parameter atol
    1e-5, losses rtol 1e-5 over 10 steps and 1e-4 over all; the custom
    kernel trains in the hyperparameter group (decay 0.01)."""
    jax_model, port = _gpr_pair(learning_mode=learning_mode, mean_module="constant",
                                random_seed=22)
    state = jax_model.state_dict()
    state["params"] = jax.tree.map(lambda a: a + np.float32(0.3), state["params"])
    jax_model.load_state_dict(state)
    port.load_state_dict(state)
    assert float(port._decay[layout_slice(port.layout, ("custom_kernel", "period_raw"))][0]) \
        == np.float32(0.01)
    want, got = _losses(jax_model.fit, 20), _losses(port.fit, 20)
    np.testing.assert_allclose(port.params.numpy(), np.asarray(ravel_pytree(jax_model.params)[0]),
                               rtol=0, atol=1e-5)
    gap = np.abs(got - want) / np.abs(want)
    assert gap[:10].max() < 1e-5 and gap.max() < 1e-4, gap.max()


def test_kernel_learning_cosine_beats_untrained():
    """tests/test_custom_modules.py's behaviour on the port: for
    learning_mode in ('learn_kernel', 'both'), a 500-step CosineKernel fit
    (with the validation set) moves the period and beats the one-step vanilla
    model on LL and RMSE."""
    x, y = _sin_data()
    vanilla = GPRegressionLearned(x, y, learning_mode="vanilla", num_iter_fit=1,
                                  mean_module="constant", covar_module=CosineKernel(),
                                  random_seed=22, device="cpu")
    vanilla.fit(verbose=False)
    ll_vanilla, rmse_vanilla, _ = vanilla.eval(x, y)
    for learning_mode in ("learn_kernel", "both"):
        learned = GPRegressionLearned(x, y, learning_mode=learning_mode, num_iter_fit=500,
                                      mean_module="constant", covar_module=CosineKernel(),
                                      random_seed=22, device="cpu")
        learned.fit(valid_x=x, valid_t=y, verbose=False)
        period = learned.params[layout_slice(learned.layout, ("custom_kernel", "period_raw"))]
        assert abs(float(torch.nn.functional.softplus(period)) - float(np.log(2.0))) > 1e-3
        ll, rmse, _ = learned.eval(x, y)
        assert ll > ll_vanilla and rmse < rmse_vanilla, (learning_mode, ll, ll_vanilla)


def test_custom_module_state_dict_roundtrip():
    """A fitted CosineKernel learner restored into a fresh one: the period
    and the predictions the same bits."""
    x, y = _sin_data()
    kw = dict(learning_mode="learn_kernel", num_iter_fit=20, mean_module="constant",
              covar_module=CosineKernel(), random_seed=22, device="cpu")
    m = GPRegressionLearned(x, y, **kw)
    m.fit(verbose=False)
    m2 = GPRegressionLearned(x, y, **kw)
    m2.load_state_dict(m.state_dict())
    assert torch.equal(m.params, m2.params)
    np.testing.assert_array_equal(m.predict(x)[0], m2.predict(x)[0])


def _map_tasks():
    rng = np.random.RandomState(25)
    tasks = []
    for _ in range(4):
        x = rng.uniform(-2, 2, size=20)
        tasks.append((x, np.sin(4 * x) + rng.normal(scale=0.05, size=20)))
    return tasks


@pytest.mark.parametrize("learning_mode", ["both", "learn_mean", "learn_kernel"])
def test_map_with_custom_modules_matches_jax(learning_mode):
    """PACOH-MAP with MaternKernel(1.5) and LinearMean on 4 tasks of 20
    points (tests/test_custom_modules.py's), full batch, lr 2e-2: off the
    fused path (its gate demands NN/NN), 20 general steps from the JAX
    learner's state moved by 0.3 with the custom kernel training with the
    kernel and the custom mean with the mean: parameters atol 1e-5, losses
    rtol 1e-5 over 10 steps and 1e-4 over all; a frozen leaf keeps its bits."""
    kw = dict(learning_mode=learning_mode, num_iter_fit=60, task_batch_size=-1,
              lr_params=2e-2, random_seed=22, mean_module=LinearMean(),
              covar_module=MaternKernel(nu=1.5))
    tasks = _map_tasks()
    jax_model = JaxMAP(tasks, **dict(kw, mean_module=JaxLinear(), covar_module=JaxMatern(1.5)))
    port = GPRegressionMetaLearned(tasks, device="cpu", **kw)
    assert not port._fused_path_ok()
    state = jax_model.state_dict()
    state["params"] = jax.tree.map(lambda a: a + np.float32(0.3), state["params"])
    jax_model.load_state_dict(state)
    port.load_state_dict(state)
    start = port.params.clone()
    want, got = _losses(jax_model.meta_fit, 20), _losses(port.meta_fit, 20)
    np.testing.assert_allclose(port.params.numpy(), np.asarray(ravel_pytree(jax_model.params)[0]),
                               rtol=0, atol=1e-5)
    gap = np.abs(got - want) / np.abs(want)
    assert gap[:10].max() < 1e-5 and gap.max() < 1e-4, gap.max()
    moved = {p[0]: bool((port.params - start)[layout_slice(port.layout, p)].abs().max() > 0)
             for p, _, _, _ in port.layout}
    assert moved == {"noise_raw": True,
                     "custom_kernel": learning_mode in ("both", "learn_kernel"),
                     "custom_mean": learning_mode in ("both", "learn_mean")}


def test_map_with_custom_modules_fits_and_evaluates():
    """tests/test_custom_modules.py's meta-learner case on the port: the
    meta-train loss falls over 60 steps, and eval is finite."""
    tasks = _map_tasks()
    m = GPRegressionMetaLearned(tasks, learning_mode="both", num_iter_fit=60, task_batch_size=-1,
                                covar_module=MaternKernel(nu=1.5), mean_module=LinearMean(),
                                lr_params=2e-2, random_seed=22, device="cpu")
    loss0 = m.meta_fit(verbose=False, log_period=1, n_iter=1)
    loss1 = m.meta_fit(verbose=False, log_period=59, n_iter=59)
    assert loss1 < loss0
    x_c, y_c = tasks[0][0][:10], tasks[0][1][:10]
    x_t, y_t = tasks[0][0][10:], tasks[0][1][10:]
    ll, rmse, _ = m.eval(x_c, y_c, x_t, y_t)
    assert np.isfinite(ll) and np.isfinite(rmse)
