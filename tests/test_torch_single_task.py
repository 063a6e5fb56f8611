"""The port's single-task learners (GPR-MLL, GPR-PAC) against the JAX learners.

Both sides start from the JAX learner's state (``load_state_dict`` of its
``state_dict()``) on the same seeded numpy data, the port on the CPU
(``device="cpu"``), where its kernels' wrappers take their plain versions:
N=6 the unrolled expressions, N=24 the K2/K3 plain version, N=60 the B4
one (the MLL) and B5's (the Cholesky of the predictive and of GPR-PAC's KL).
Nets are (16, 16).

GPR-MLL is compared in float32. GPR-PAC's KL factors the prior Gram with no
noise, singular to float32 at a learner's state (its smallest eigenvalues
1e-16 of the largest at N=24): there the JAX learner's own float32 gradient
lies 7e-4 of its largest entry from its float64 one, and Adam turns such
noise into steps of lr. So GPR-PAC's trajectories, predictions and
intervals are compared in float64 on both sides (``jax.enable_x64``, the
port's tensors in float64), where the two packages run the same algorithm;
in float32 the port must lie no further from the float64 run than twice the
JAX learner's own float32 distance from it.

Parameter comparisons leave out the kernel net's output bias: its true
gradient is exactly zero, so both sides random-walk float noise there.
"""

import contextlib
import pickle

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from meta_learning_pacoh_tpu import GPRegressionLearned as JaxGPR
from meta_learning_pacoh_tpu import GPRegressionLearnedPAC as JaxPAC
from meta_learning_pacoh_tpu.algos.gpr_mll import ReduceLROnPlateau as JaxPlateau
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import GPRegressionLearned, GPRegressionLearnedPAC
from meta_learning_pacoh_torch.algos.gpr_mll import ReduceLROnPlateau
from meta_learning_pacoh_torch.interop import _flat_leaves, from_jax_gpr_state
from meta_learning_pacoh_torch.models.random_gp import layout_slice

LEARNERS = {"gpr": (JaxGPR, GPRegressionLearned), "pac": (JaxPAC, GPRegressionLearnedPAC)}
NS = (6, 24, 60)
KW = dict(mean_nn_layers=(16, 16), kernel_nn_layers=(16, 16), random_seed=3)


@pytest.fixture(autouse=True)
def clear_jit_cache():
    jit_cache.clear()
    yield
    jit_cache.clear()


def _data(n, n_test=40, seed=25):
    """tests/test_single_task.py's toy function at n training points."""
    rs = np.random.RandomState(seed)
    x = rs.normal(-1, 2.0, (n, 1))
    y = 0.6 * x + np.sin((0.6 * x) ** 2) - 1 + rs.normal(0, 0.1, x.shape)
    xt = rs.normal(-1, 2.0, (n_test, 1))
    yt = 0.6 * xt + np.sin((0.6 * xt) ** 2) - 1 + rs.normal(0, 0.1, xt.shape)
    return x, y, xt, yt


def _pair(kind, x, y, **kw):
    """A JAX learner and the port's learner started from its state."""
    kw = dict(KW, **kw)
    jax_cls, port_cls = LEARNERS[kind]
    jax_model = jax_cls(x, y, **kw)
    port = port_cls(x, y, device="cpu", **kw)
    port.load_state_dict(jax_model.state_dict())
    return jax_model, port


def _cast(tree, dtype):
    return jax.tree.map(lambda a: np.asarray(a, dtype)
                        if getattr(a, "dtype", None) in (np.float32, np.float64) else a, tree)


@contextlib.contextmanager
def precision(kind, jax_model, port, state=None):
    """GPR-MLL as it is (float32); GPR-PAC in float64 on both sides: the JAX
    learner under ``jax.enable_x64`` with its state and data in float64, the
    port's (if any) state, data and new tensors in float64. ``state`` (a JAX
    state dict) is loaded into both first."""
    ports = [] if port is None else [port]
    if state is not None:
        jax_model.load_state_dict(state)
        for p in ports:
            p.load_state_dict(state)
    if kind == "gpr":
        yield
        return
    with jax.enable_x64():
        jax_model.load_state_dict(_cast(jax_model.state_dict(), np.float64))
        jax_model.train_x = np.asarray(jax_model.train_x, np.float64)
        jax_model.train_t = np.asarray(jax_model.train_t, np.float64)
        for p in ports:
            for name in ("params", "_mu", "_nu", "train_x", "train_t"):
                setattr(p, name, getattr(p, name).double())
            p._tensor = lambda a: torch.tensor(np.asarray(a, np.float64))
        yield


def _keep(port):
    path = ("kernel_nn", "b_out") if isinstance(port, GPRegressionLearned) else (
        "gp", "kernel_nn", "b_out")
    keep = np.ones(port.params.numel(), bool)
    if port.cfg.covar_module == "NN":
        keep[layout_slice(port.layout, path)] = False
    return keep


def _flat(jax_model):
    return np.asarray(ravel_pytree(jax_model.params)[0])


def _losses(model, n_steps):
    return np.array([model.fit(n_iter=1, log_period=1, verbose=False) for _ in range(n_steps)])


@pytest.mark.parametrize("kind", sorted(LEARNERS))
def test_data_and_state_match_jax(kind):
    """Normalised training data equal to the byte; the flat parameters in
    the JAX ravel order (GPR-PAC: gp, q_chol, q_mean); a fresh Adam state
    at the JAX learner's lr, in the JAX optimizer groups."""
    x, y, _, _ = _data(24)
    jax_model, port = _pair(kind, x, y)
    np.testing.assert_array_equal(port.train_x.numpy(), np.asarray(jax_model.train_x))
    np.testing.assert_array_equal(port.train_t.numpy(), np.asarray(jax_model.train_t))
    np.testing.assert_array_equal(port.params.numpy(), _flat(jax_model))
    state = from_jax_gpr_state(jax_model.state_dict())
    assert state["opt_state"]["count"] == 0 and not state["opt_state"]["mu"].any()
    assert state["opt_state"]["lr"] == pytest.approx(1e-3)
    # the hyperparameter group decays by 0.01 (q_chol whole, its upper triangle too)
    hyper = ("noise_raw",) if kind == "gpr" else ("gp", "noise_raw")
    assert float(port._decay[layout_slice(port.layout, hyper)][0]) == np.float32(0.01)
    nn = ("mean_nn", "w_0") if kind == "gpr" else ("gp", "mean_nn", "w_0")
    assert float(port._decay[layout_slice(port.layout, nn)].max()) == 0.0
    if kind == "pac":
        assert bool((port._decay[layout_slice(port.layout, ("q_chol",))]
                     == np.float32(0.01)).all())


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kind", sorted(LEARNERS))
def test_predictions_match_jax_from_same_state(kind, n):
    """From the JAX state after 4 steps (non-zero Adam moments, carried
    across exactly): predictions rtol 1e-5, atol 1e-6, and eval's LL, RMSE
    and calibration rtol 1e-5 (GPR-PAC in float64, see the module's
    docstring)."""
    x, y, xt, yt = _data(n)
    jax_model, port = _pair(kind, x, y)
    jax_model.fit(n_iter=4, log_period=4, verbose=False)
    state = jax_model.state_dict()
    port.load_state_dict(state)
    assert port._adam_count == 4 and port._step_count == 4
    groups = state["opt_state"].inner_states
    # each coordinate's moment is its group's, the other group's placeholder zero
    mu = sum(_flat_leaves(groups[g].inner_state.inner_state[0].mu, state["params"])
             for g in ("nn", "hyper"))
    np.testing.assert_array_equal(port._mu.numpy(), mu)
    assert np.abs(mu).max() > 0
    with precision(kind, jax_model, port, state):
        mean, std = port.predict(xt)
        mean_j, std_j = jax_model.predict(xt)
        np.testing.assert_allclose(mean, mean_j, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(std, std_j, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(port.eval(xt, yt), jax_model.eval(xt, yt), rtol=1e-5,
                                   atol=1e-6)


# name -> constructor keywords beyond KW
MODE_CASES = {
    "both": {},
    "learn_mean_se": dict(learning_mode="learn_mean", covar_module="SE"),
    "learn_kernel_constant": dict(learning_mode="learn_kernel", mean_module="constant"),
    "vanilla": dict(learning_mode="vanilla", covar_module="SE", mean_module="constant"),
    "sgd": dict(optimizer="SGD", lr=1e-2),
}
TRAJECTORIES = [(case, n) for n in NS for case in ("both",)] + [
    (case, 24) for case in sorted(MODE_CASES) if case != "both"]


@pytest.mark.parametrize("case,n", TRAJECTORIES)
@pytest.mark.parametrize("kind", sorted(LEARNERS))
def test_trajectories_match_jax(kind, case, n):
    """20 steps from the JAX initial state moved by 0.3 (so no leaf starts
    at 0) for each learning_mode and both optimizers (GPR-PAC in float64):
    parameters atol 1e-5, losses rtol 1e-5 over the first 10 steps and 1e-4
    over all 20; a frozen leaf keeps its bits (no update, no decay)."""
    x, y, _, _ = _data(n)
    jax_model, port = _pair(kind, x, y, **MODE_CASES[case])
    state = jax_model.state_dict()
    state["params"] = jax.tree.map(lambda a: a + np.float32(0.3), state["params"])
    with precision(kind, jax_model, port, state):
        start = port.params.clone()
        want, got = _losses(jax_model, 20), _losses(port, 20)
        keep = _keep(port)
        np.testing.assert_allclose(port.params.numpy()[keep], _flat(jax_model)[keep], rtol=0,
                                   atol=1e-5)
        gap = np.abs(got - want) / np.abs(want)
        assert gap[:10].max() < 1e-5 and gap.max() < 1e-4, gap.max()
        frozen = port._train_mask == 0
        assert torch.equal(port.params[frozen], start[frozen])
        assert bool(frozen.any()) == (case in ("learn_mean_se", "learn_kernel_constant",
                                               "vanilla"))
        assert float((port.params - start).abs()[~frozen].max()) > 1e-3


@pytest.mark.parametrize("n", NS)
def test_pac_float32_within_jax_float32_drift(n):
    """GPR-PAC in float32 from the JAX learner's own initial state, 10 steps:
    the port's parameters and losses no further from the JAX float64 run
    than twice the JAX float32 run's own distance from it (and 1e-5)."""
    x, y, _, _ = _data(n)
    jax_model, port = _pair("pac", x, y)
    state = jax_model.state_dict()
    jax32 = JaxPAC(x, y, **KW)
    jax32.load_state_dict(state)
    got, want32 = _losses(port, 10), _losses(jax32, 10)
    with precision("pac", jax_model, None, state):
        want64 = _losses(jax_model, 10)
        final64 = _flat(jax_model)
    keep = _keep(port)
    port_gap = np.abs(port.params.numpy() - final64)[keep].max()
    jax_gap = np.abs(_flat(jax32) - final64)[keep].max()
    assert port_gap <= max(2 * jax_gap, 1e-5), (port_gap, jax_gap)
    port_loss = np.abs(got - want64).max()
    jax_loss = np.abs(want32 - want64).max()
    assert port_loss <= max(2 * jax_loss, 1e-5 * np.abs(want64).max()), (port_loss, jax_loss)


def test_plateau_scheduler_matches_jax():
    """The host scheduler gives the JAX one's scales on a metric sequence
    with gains and falls (a repeated negative metric counts as a gain in
    torch's relative mode 'max'), reducing at the default patience of 10."""
    metrics = ([-3.0, -2.0, -2.0, -1.5] + [-1.6 - 0.01 * k for k in range(14)]
               + [-1.0] + [-1.2 - 0.01 * k for k in range(12)])
    for kw in ({}, dict(factor=0.5, patience=2), dict(factor=0.5, patience=0)):
        port, ref = ReduceLROnPlateau(**kw), JaxPlateau(**kw)
        assert [port.step(m) for m in metrics] == [ref.step(m) for m in metrics]
        assert port.scale < 1.0


@pytest.mark.parametrize("kind", sorted(LEARNERS))
def test_fit_with_validation_set_matches_jax(kind):
    """A fit with a validation set (the training inputs, the targets
    negated, so its LL falls as the fit goes on) in chunks of 2 steps, both
    learners' schedulers at patience 0 and factor 0.5: the same lr scales
    after every chunk and the same injected lr; GPR-MLL's parameters atol
    1e-5 and last loss rtol 1e-5. GPR-PAC runs in float32 here (the JAX
    learner's scheduler writes a float32 lr that its float64 step refuses),
    so only its schedule is compared."""
    x, y, _, _ = _data(24)
    jax_model, port = _pair(kind, x, y)
    scales = []
    for model, plateau in ((jax_model, JaxPlateau), (port, ReduceLROnPlateau)):
        model._plateau = plateau(factor=0.5, patience=0)
        seen = []
        step = model._plateau.step
        model._plateau.step = lambda metric, step=step, seen=seen: seen.append(step(metric)) or (
            seen[-1])
        last = model.fit(valid_x=x, valid_t=-y, n_iter=16, log_period=2, verbose=False)
        scales.append((seen, last))
    (want, want_loss), (got, got_loss) = scales
    assert got == want and want[-1] < 1.0
    lr = float(jax_model.opt_state.inner_states["hyper"].inner_state.hyperparams[
        "learning_rate"])
    assert port._lr_now == pytest.approx(lr, rel=1e-6)
    if kind == "gpr":
        keep = _keep(port)
        np.testing.assert_allclose(port.params.numpy()[keep], _flat(jax_model)[keep], rtol=0,
                                   atol=1e-5)
        assert got_loss == pytest.approx(want_loss, rel=1e-5)


@pytest.mark.parametrize("kind", sorted(LEARNERS))
def test_confidence_intervals_match_jax(kind):
    """The 90% interval at 40 points from the same state after 3 steps:
    rtol 1e-4, atol 1e-5, upper above lower (GPR-PAC in float64)."""
    x, y, _, _ = _data(24)
    jax_model, port = _pair(kind, x, y)
    jax_model.fit(n_iter=3, log_period=3, verbose=False)
    xs = np.linspace(-5.0, 5.0, 40)
    with precision(kind, jax_model, port, jax_model.state_dict()):
        ucb, lcb = port.confidence_intervals(xs, confidence=0.9)
        ucb_j, lcb_j = jax_model.confidence_intervals(xs, confidence=0.9)
    assert ucb.shape == lcb.shape == (40,) and np.all(ucb > lcb)
    np.testing.assert_allclose(ucb, ucb_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lcb, lcb_j, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", sorted(LEARNERS))
def test_state_dict_roundtrip_seeds_and_chunkings(kind):
    """One seed gives the same bits twice and in two chunkings; a pickled
    state_dict restores a learner of another seed to the same predictions."""
    x, y, xt, _ = _data(24)
    port_cls = LEARNERS[kind][1]
    kw = dict(KW, random_seed=9)
    runs = []
    for log_period in (30, 30, 7):
        m = port_cls(x, y, num_iter_fit=30, device="cpu", **kw)
        m.fit(verbose=False, log_period=log_period)
        runs.append(m)
    for other in runs[1:]:
        assert torch.equal(runs[0].params, other.params)
        assert torch.equal(runs[0]._nu, other._nu)
    m2 = port_cls(x, y, num_iter_fit=30, device="cpu", **dict(kw, random_seed=77))
    assert not torch.equal(m2.params, runs[0].params)
    m2.load_state_dict(pickle.loads(pickle.dumps(runs[0].state_dict())))
    np.testing.assert_array_equal(m2.predict(xt)[0], runs[0].predict(xt)[0])
    assert m2.state_dict()["step"] == 30 and m2._adam_count == 30


def test_gpr_fit_improves_and_learned_mean_beats_vanilla():
    """tests/test_single_task.py's behaviour on the port: 300 steps raise the
    test LL, and the NN mean beats the vanilla zero-mean SE GP."""
    x, y, xt, yt = _data(24, n_test=60)
    learned = GPRegressionLearned(x, y, num_iter_fit=300, random_seed=3, device="cpu")
    ll0 = learned.eval(xt, yt)[0]
    learned.fit(verbose=False, log_period=300)
    ll1 = learned.eval(xt, yt)[0]
    vanilla = GPRegressionLearned(x, y, num_iter_fit=300, random_seed=3, device="cpu",
                                  learning_mode="vanilla", mean_module="zero",
                                  covar_module="SE")
    vanilla.fit(verbose=False)
    assert ll1 > ll0 and ll1 > vanilla.eval(xt, yt)[0]


def test_pac_fit_improves_and_bound_decreases():
    """tests/test_single_task.py's GPR-PAC behaviour on the port: 1600 steps
    give a finite LL above the initial one, and a lower bound."""
    x, y, xt, yt = _data(24, n_test=60)
    m = GPRegressionLearnedPAC(x, y, num_iter_fit=1600, random_seed=1, device="cpu")
    ll0 = m.eval(xt, yt)[0]
    l0 = float(m._pac_loss(m.params)[0])
    l1 = m.fit(verbose=False, log_period=1600)
    ll1 = m.eval(xt, yt)[0]
    assert np.isfinite(ll1) and ll1 > ll0 and l1 < l0


def test_constructors_check_their_arguments():
    x, y, _, _ = _data(6)
    with pytest.raises(ValueError, match="kernel NN must be learned"):
        GPRegressionLearned(x, y, learning_mode="learn_mean", device="cpu")
    with pytest.raises(ValueError, match="optimizer"):
        GPRegressionLearned(x, y, optimizer="RMSprop", device="cpu")
    with pytest.raises(ValueError, match="mean_module"):
        GPRegressionLearnedPAC(x, y, mean_module="linear", device="cpu")
