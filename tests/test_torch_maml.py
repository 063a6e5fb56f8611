"""The port's MAML learner against the JAX learner.

The JAX learner runs on the CPU as the JAX package's own tests run it (MAML
reaches no Pallas kernel). The port runs on the CPU (``device="cpu"``).
Both start from the JAX learner's state (``load_state_dict`` of its
``state_dict()``), and the port is fed the JAX learner's task draws
(``fold_in`` of its train key and the step, then ``randint``), so the same
numbers go in. Tolerances: single evaluations (a forward pass, an
adaptation, a meta-loss) rtol 1e-5 or atol 1e-6, float32 sums in another
order; the meta-gradient within 1e-5 of its largest entry; parameters after
100 steps within 1e-4 max (a tenth of one Adam step's reach at lr 1e-3)
and 2e-6 mean, the limits of the twins in chip_smoke.py.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu import MAMLRegression as JaxMAML
from meta_learning_pacoh_tpu.algos.maml import inner_adapt
from meta_learning_pacoh_tpu.models.mlp import mlp_apply as jax_mlp_apply
from meta_learning_pacoh_tpu.ops.pallas import launch_sched as jax_sched
from meta_learning_pacoh_torch import MAMLRegression
from meta_learning_pacoh_torch.algos.maml import masked_mse
from meta_learning_pacoh_torch.datasets import SinusoidDataset
from meta_learning_pacoh_torch.interop import from_jax_maml_state
from meta_learning_pacoh_torch.models.mlp import mlp_apply
from meta_learning_pacoh_torch.ops import launch_sched
from meta_learning_pacoh_torch.utils.input_handling import handle_input_dim

KW = dict(layer_sizes=(16, 16), random_seed=3)


def _sin(n_tasks=6, ragged=True):
    """Sinusoid tasks of 5 points; with ragged, task 1 keeps 3, so padded."""
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=n_tasks, n_samples=5)
    if ragged:
        train[1] = (train[1][0][:3], train[1][1][:3])
    test = env.generate_meta_test_data(n_tasks=4, n_samples_context=5, n_samples_test=20)
    return train, test


def _pair(train, **kw):
    """A JAX learner and the port's, loaded with the JAX learner's state."""
    kw = dict(KW, **kw)
    jax_model = JaxMAML(train, **kw)
    port = MAMLRegression(train, device="cpu", **kw)
    port.load_state_dict(jax_model.state_dict())
    return jax_model, port


def _feed(port, jax_model, n_steps):
    """Give the port the JAX learner's task draws of steps 0 .. n_steps - 1."""
    idx = np.asarray(jax.vmap(lambda i: jax.random.randint(
        jax.random.fold_in(jax_model._train_key, i), (jax_model.task_batch_size,), 0,
        jax_model.n_tasks))(jnp.arange(n_steps))).astype(np.int64)
    port._task_draw = lambda step: torch.from_numpy(idx[step])


def _params(model):
    if isinstance(model, JaxMAML):
        return {k: np.asarray(v) for k, v in model.params.items()}
    return {k: v.numpy() for k, v in model._param_tree(model.params).items()}


def _gap(port, jax_model):
    got, want = _params(port), _params(jax_model)
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    return d.max(), d.mean()


def test_data_layout_and_state_carry_across():
    """The padded meta-data equal to the byte; the JAX state (params, Adam
    moments, count) loaded exactly, for Adam and for SGD (no moments)."""
    train, _ = _sin()
    jax_model, port = _pair(train)
    for got, want in ((port.X, jax_model.X), (port.Y, jax_model.Y),
                      (port.mask, jax_model.mask)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k, v in _params(jax_model).items():
        np.testing.assert_array_equal(_params(port)[k], v)
    jax_model.meta_fit(n_iter=2, log_period=2, verbose=False)
    state = from_jax_maml_state(jax_model.state_dict())
    assert state["opt_state"]["count"] == 2 and state["step"] == 2
    assert set(state["opt_state"]["mu"]) == set(jax_model.params)
    sgd = from_jax_maml_state(JaxMAML(train, optimizer="SGD", **KW).state_dict())
    assert sgd["opt_state"]["count"] == 0 and not any(v.any() for v in sgd["opt_state"]["nu"].values())


def test_mlp_forward_matches_jax():
    """The port's batched MLP against the JAX one on the same parameters,
    the leaves given a leading axis of 3 (three parameter sets)."""
    rs = np.random.RandomState(0)
    params = {f"{p}_{n}": rs.randn(3, *shape).astype(np.float32)
              for n, (w, b) in (("0", ((2, 16), (16,))), ("1", ((16, 16), (16,))),
                                ("out", ((16, 3), (3,))))
              for p, shape in (("w", w), ("b", b))}
    x = rs.randn(3, 7, 2).astype(np.float32)
    want = np.stack([np.asarray(jax_mlp_apply({k: v[i] for k, v in params.items()}, x[i]))
                     for i in range(3)])
    got = mlp_apply({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("num_steps", [1, 3])
def test_eval_adaptation_matches_jax(num_steps):
    """Evaluation's inner loop (the plain mean over the context points):
    the adapted and initial predictions of every test task, batched, against
    ``inner_adapt`` of the JAX package task by task."""
    train, test = _sin()
    jax_model, port = _pair(train)
    tasks = [handle_input_dim(cx, cy) + handle_input_dim(tx, ty) for cx, cy, tx, ty in test]
    CX = np.stack([port._normalize_x(t[0]) for t in tasks])
    CY = np.stack([port._normalize_y(t[1]) for t in tasks])
    TX = np.stack([port._normalize_x(t[2]) for t in tasks])
    adapted, initial = port._adapt_and_predict(*(torch.from_numpy(a) for a in (CX, CY, TX)),
                                               num_steps)
    for i in range(len(test)):
        p = inner_adapt(jax_model.params, CX[i], CY[i], jax_model.lr_inner, num_steps)
        np.testing.assert_allclose(adapted[i].numpy(), np.asarray(jax_mlp_apply(p, TX[i])),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(initial[i].numpy(),
                                   np.asarray(jax_mlp_apply(jax_model.params, TX[i])),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("num_inner_steps", [1, 2])
def test_second_order_meta_gradient_matches_jax(num_inner_steps):
    """Training's inner loop (the masked halves of ragged tasks) and the
    second-order meta-gradient through it: the JAX learner's first step at
    full batch, SGD at lr 1, gives its meta-loss and its gradient
    (params - new params); the port's meta-loss within rtol 1e-5 and its
    gradient within 1e-5 of the largest entry."""
    train, _ = _sin()
    jax_model, port = _pair(train, num_inner_steps=num_inner_steps, optimizer="SGD",
                            lr_meta=1.0, task_batch_size=-1)
    before = _params(jax_model)
    want_loss = jax_model.meta_fit(n_iter=1, log_period=1, verbose=False)
    want = np.concatenate([(before[k] - np.asarray(jax_model.params[k])).ravel()
                           for k in sorted(before)])
    flat = port.params.detach().requires_grad_(True)
    loss = port._meta_loss(flat, port.X, port.Y, port._w_inner, port._w_outer)
    (grad,) = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert np.abs(grad.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    # the first-order part alone is far off: the test sees the second order
    first = port.params.detach().requires_grad_(True)
    adapted = first.expand(port.n_tasks, -1)
    for _ in range(num_inner_steps):
        inner = torch.sum(masked_mse(port._param_tree(adapted), port.X, port.Y,
                                     port._w_inner))
        adapted = adapted - port.lr_inner * torch.autograd.grad(inner, adapted)[0].detach()
    (first_grad,) = torch.autograd.grad(torch.mean(masked_mse(
        port._param_tree(adapted), port.X, port.Y, port._w_outer)), first)
    assert np.abs(first_grad.numpy() - want).max() > 1e-3 * np.abs(want).max()


# name -> constructor keywords beyond KW
TRAJECTORY_CASES = {
    "adam_full_batch": dict(task_batch_size=-1),
    "adam_sampled": dict(task_batch_size=3),
    "sgd_staircase": dict(task_batch_size=3, optimizer="SGD", lr_meta=1e-2, lr_decay=0.5,
                          num_inner_steps=2),
}


@pytest.mark.parametrize("case", sorted(TRAJECTORY_CASES))
def test_trajectory_matches_jax(monkeypatch, case):
    """100 steps from the JAX initial state with the JAX task draws (SGD
    with a staircase of 30-step transitions in both packages): the
    parameters within 1e-4 max and 2e-6 mean, the last loss rtol 1e-5,
    the step and Adam counts carried."""
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 30)
    monkeypatch.setattr(jax_sched, "LR_TRANSITION_STEPS", 30)
    train, _ = _sin()
    jax_model, port = _pair(train, **TRAJECTORY_CASES[case])
    _feed(port, jax_model, 100)
    want_loss = jax_model.meta_fit(n_iter=100, log_period=100, verbose=False)
    got_loss = port.meta_fit(n_iter=100, log_period=100, verbose=False)
    gap_max, gap_mean = _gap(port, jax_model)
    assert gap_max <= 1e-4 and gap_mean <= 2e-6, (gap_max, gap_mean)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    state = port.state_dict()
    assert state["step"] == 100
    assert state["opt_state"]["count"] == (0 if case == "sgd_staircase" else 100)


def test_predict_and_eval_match_jax():
    """After 20 JAX steps: ``predict``'s (adapted, initial) pair at the
    default and at 3 inner steps, ``eval`` and ``eval_datasets`` (one
    float, the mean RMSE) on uniform and on ragged test tasks, rtol 1e-5."""
    train, test = _sin()
    jax_model = JaxMAML(train, **KW)
    jax_model.meta_fit(n_iter=20, log_period=20, verbose=False)
    port = MAMLRegression(train, device="cpu", **KW)
    port.load_state_dict(jax_model.state_dict())
    cx, cy, tx, _ = test[0]
    for steps in (None, 3):
        got = port.predict(cx, cy, tx, num_steps_eval=steps)
        want = jax_model.predict(cx, cy, tx, num_steps_eval=steps)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (20, 1)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        assert np.abs(got[0] - got[1]).max() > 0
    ragged = [test[0], (test[1][0][:3], test[1][1][:3], test[1][2], test[1][3])] + test[2:]
    for tasks, kw in ((test, {}), (test, dict(num_steps_eval=2)), (ragged, {})):
        got, want = port.eval_datasets(tasks, **kw), jax_model.eval_datasets(tasks, **kw)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(port.eval(*test[2]), jax_model.eval(*test[2]), rtol=1e-5)


def test_chunkings_and_state_round_trip_are_bit_identical():
    """One chunk of 40 steps, chunks of 7, and 17 steps then a pickled
    ``state_dict`` into a new learner and 23 more: the same bits."""
    train, test = _sin()
    kw = dict(KW, task_batch_size=3)
    one = MAMLRegression(train, device="cpu", **kw)
    one.meta_fit(n_iter=40, log_period=40, verbose=False)
    chunked = MAMLRegression(train, device="cpu", **kw)
    chunked.meta_fit(n_iter=40, log_period=7, verbose=False)
    first = MAMLRegression(train, device="cpu", **kw)
    first.meta_fit(n_iter=17, log_period=17, verbose=False)
    resumed = MAMLRegression(train, device="cpu", **kw)
    resumed.load_state_dict(pickle.loads(pickle.dumps(first.state_dict())))
    resumed.meta_fit(n_iter=23, log_period=23, verbose=False)
    for model in (chunked, resumed):
        for name in ("params", "_mu", "_nu"):
            assert torch.equal(getattr(model, name), getattr(one, name))
        assert model._step_count == 40 and model._adam_count == 40
    assert one.eval_datasets(test) == resumed.eval_datasets(test)
