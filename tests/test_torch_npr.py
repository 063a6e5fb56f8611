"""The port's Neural Process core and learner against the JAX package's.

The JAX functions and learner run on the CPU as the JAX package's own tests
run them (the NP reaches no Pallas kernel); the port runs on the CPU
(``device="cpu"``). The port takes its random draws as tensors, so the tests
compute the JAX side's from its keys exactly as the JAX code draws them
(npr.py:113-122, neural_process.py:99-106: ``fold_in`` of the train key and
the step, ``split`` into a task key and a split key, ``randint``, then
``split(batch)``, ``uniform(n)`` and ``normal(fold_in(k, 1))`` a task; an
evaluation's latents ``normal`` of the learner's next key, ``split`` a task
in the batched path) and feed them in. Tolerances: single evaluations rtol
1e-5 (atol 1e-6 near 0), float32 sums in another order; gradients within
1e-5 of their largest entry; parameters after 100 steps within 1e-4 max (a
tenth of one AdamW step's reach at lr 1e-3) and 2e-6 mean, the twins'
limits in chip_smoke.py.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu import NPRegressionMetaLearned as JaxNP
from meta_learning_pacoh_tpu.models import neural_process as jax_np
from meta_learning_pacoh_tpu.ops.pallas import launch_sched as jax_sched
from meta_learning_pacoh_torch import NPRegressionMetaLearned
from meta_learning_pacoh_torch.datasets import SinusoidDataset
from meta_learning_pacoh_torch.interop import from_jax_np_state
from meta_learning_pacoh_torch.models import neural_process as port_np
from meta_learning_pacoh_torch.ops import launch_sched

DIMS = dict(r_dim=16, z_dim=8, h_dim=16)
KW = dict(DIMS, random_seed=3)


def _sin(n_tasks=6, ragged=True):
    """Sinusoid tasks of 5 points; with ragged, task 1 keeps 3, so padded."""
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=n_tasks, n_samples=5)
    if ragged:
        train[1] = (train[1][0][:3], train[1][1][:3])
    test = env.generate_meta_test_data(n_tasks=4, n_samples_context=5, n_samples_test=20)
    return train, test


def _pair(train, **kw):
    kw = dict(KW, **kw)
    jax_model = JaxNP(train, **kw)
    port = NPRegressionMetaLearned(train, device="cpu", **kw)
    port.load_state_dict(jax_model.state_dict())
    return jax_model, port


def _task_draws(keys, n, z_dim):
    """A task's shuffle scores [B, n] and latent noise [B, z] from its keys [B]."""
    u = jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys)
    eps = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 1), (z_dim,)))(keys)
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(eps))


def _feed(port, jax_model, n_steps):
    """Give the port the JAX learner's draws of steps 0 .. n_steps - 1."""
    b, t, n = jax_model.task_batch_size, jax_model.n_tasks, jax_model.X.shape[1]
    draws = []
    for step in range(n_steps):
        k_task, k_split = jax.random.split(jax.random.fold_in(jax_model._train_key, step))
        idx = torch.from_numpy(np.array(jax.random.randint(k_task, (b,), 0, t)).astype(np.int64))
        u, eps = _task_draws(jax.random.split(k_split, b), n, port.z_dim)
        draws.append((None if b == t else idx, u, eps))
    port._step_draws = lambda step: draws[step]


def _feed_eval(port, jax_model, batch_sizes):
    """Give the port the latents of the JAX learner's next evaluations: one
    key a call, split into a key a task where ``batch_sizes`` says a
    batched call of that many tasks (None: one ``predict``)."""
    key, out = jax_model._key, []
    for size in batch_sizes:
        key, sub = jax.random.split(key)
        if size is None:
            out.append(jax.random.normal(sub, (port.z_dim,))[None])
        else:
            out.append(jax.vmap(lambda k: jax.random.normal(k, (port.z_dim,)))(
                jax.random.split(sub, size)))
    queue = [torch.from_numpy(np.array(e)) for e in out]
    port._eval_eps = lambda n: queue.pop(0)


def _params(model):
    if isinstance(model, JaxNP):
        return {k: np.asarray(v) for k, v in model.params.items()}
    return {k: v.numpy() for k, v in model._param_tree(model.params).items()}


def _ragged_batch(rs, b=4, n=7):
    x = rs.randn(b, n, 1).astype(np.float32)
    y = rs.randn(b, n, 1).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    for i, real in enumerate((7, 4, 6, 1)[:b]):
        mask[i, real:] = 0.0
        x[i, real:], y[i, real:] = 0.0, 0.0
    nc = np.ceil(0.5 * mask.sum(1)).astype(np.int32)
    return x, y, mask, nc


def test_encode_decode_elbo_and_gradient_match_jax():
    """``np_encode`` / ``np_decode`` / ``np_elbo_loss`` on ragged masks (one
    task of a single real point) with the JAX function's own draws fed in:
    the losses rtol 1e-5 and their summed gradient within 1e-5 of its
    largest entry."""
    rs = np.random.RandomState(0)
    params = jax_np.init_np_params(jax.random.PRNGKey(1), 1, 1, **DIMS)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    x, y, mask, nc = _ragged_batch(rs)
    mu, sig = port_np.np_encode(tparams, torch.from_numpy(x), torch.from_numpy(y),
                                torch.from_numpy(mask))
    z = rs.randn(4, DIMS["z_dim"]).astype(np.float32)
    mu_y, sig_y = port_np.np_decode(tparams, torch.from_numpy(x), torch.from_numpy(z))
    for i in range(4):
        want = jax_np.np_encode(params, x[i], y[i], mask=mask[i])
        np.testing.assert_allclose(mu[i].numpy(), want[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sig[i].numpy(), want[1], rtol=1e-5, atol=1e-6)
        want = jax_np.np_decode(params, x[i], z[i])
        np.testing.assert_allclose(mu_y[i].numpy(), want[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sig_y[i].numpy(), want[1], rtol=1e-5, atol=1e-6)

    keys = jax.random.split(jax.random.PRNGKey(7), 4)

    def jax_loss(p):
        return jax.vmap(lambda k, xi, yi, ni, mi: jax_np.np_elbo_loss(p, k, xi, yi, ni, mask=mi))(
            keys, x, y, nc, mask)

    want = np.asarray(jax_loss(params))
    want_grad = jax.grad(lambda p: jnp.sum(jax_loss(p)))(params)
    u, eps = _task_draws(keys, x.shape[1], DIMS["z_dim"])
    leaves = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    got = port_np.np_elbo_loss(leaves, u, eps, torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(nc.astype(np.int64)), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    grads = torch.autograd.grad(torch.sum(got), list(leaves.values()))
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want_grad.values())
    for key, g in zip(leaves, grads):
        assert np.abs(g.numpy() - np.asarray(want_grad[key])).max() <= 1e-5 * scale, key


def test_predict_function_matches_jax():
    """``np_predict`` with the JAX draw of the latent fed in."""
    rs = np.random.RandomState(2)
    params = jax_np.init_np_params(jax.random.PRNGKey(3), 1, 1, **DIMS)
    xc, yc, xt = (rs.randn(*s).astype(np.float32) for s in ((5, 1), (5, 1), (30, 1)))
    key = jax.random.PRNGKey(4)
    want = jax_np.np_predict(params, key, xc, yc, xt)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (DIMS["z_dim"],))))
    got = port_np.np_predict({k: torch.from_numpy(np.array(v)) for k, v in params.items()}, eps,
                             torch.from_numpy(xc), torch.from_numpy(yc), torch.from_numpy(xt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


# name -> constructor keywords beyond KW
TRAJECTORY_CASES = {
    "adamw_full_batch": dict(task_batch_size=-1),
    "adamw_sampled": dict(task_batch_size=3),
    "sgd_staircase": dict(task_batch_size=3, optimizer="SGD", lr_params=1e-2, lr_decay=0.5),
}


@pytest.mark.parametrize("case", sorted(TRAJECTORY_CASES))
def test_trajectory_matches_jax(monkeypatch, case):
    """100 steps from the JAX initial state with the JAX draws (SGD with a
    staircase of 30-step transitions in both packages): the parameters
    within 1e-4 max and 2e-6 mean, the last loss rtol 1e-5, the step and
    AdamW counts carried."""
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 30)
    monkeypatch.setattr(jax_sched, "LR_TRANSITION_STEPS", 30)
    train, _ = _sin()
    jax_model, port = _pair(train, **TRAJECTORY_CASES[case])
    np.testing.assert_array_equal(port.num_context_per_task, jax_model.num_context_per_task)
    _feed(port, jax_model, 100)
    want_loss = jax_model.meta_fit(n_iter=100, log_period=100, verbose=False)
    got_loss = port.meta_fit(n_iter=100, log_period=100, verbose=False)
    got, want = _params(port), _params(jax_model)
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert d.max() <= 1e-4 and d.mean() <= 2e-6, (d.max(), d.mean())
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    state = port.state_dict()
    assert state["step"] == 100
    assert state["opt_state"]["count"] == (0 if case == "sgd_staircase" else 100)


def test_state_carries_across():
    """The data equal to the byte; a JAX AdamW state (parameters, moments,
    count) and an SGD one (no moments) carried exactly."""
    train, _ = _sin()
    jax_model, port = _pair(train)
    for got, want in ((port.X, jax_model.X), (port.Y, jax_model.Y),
                      (port.mask, jax_model.mask)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jax_model.meta_fit(n_iter=3, log_period=3, verbose=False)
    port.load_state_dict(jax_model.state_dict())
    state = port.state_dict()
    assert state["opt_state"]["count"] == 3 and state["step"] == 3
    for tree in ("mu", "nu"):
        for k, v in getattr(jax_model.opt_state[0], tree).items():
            np.testing.assert_array_equal(state["opt_state"][tree][k], np.asarray(v))
    sgd = from_jax_np_state(JaxNP(train, optimizer="SGD", **KW).state_dict())
    assert sgd["opt_state"]["count"] == 0 and not any(v.any() for v in sgd["opt_state"]["mu"].values())


def test_eval_and_confidence_intervals_match_jax():
    """After 30 JAX steps, with the JAX learner's latents fed in: the
    batched ``eval_datasets`` (ll the mean per-point log-density, rmse,
    calib), ragged ``eval_datasets`` (task by task), ``eval`` and
    ``confidence_intervals``, rtol 1e-5 (calib, a frequency, exactly)."""
    train, test = _sin()
    jax_model = JaxNP(train, **KW)
    jax_model.meta_fit(n_iter=30, log_period=30, verbose=False)
    port = NPRegressionMetaLearned(train, device="cpu", **KW)
    port.load_state_dict(jax_model.state_dict())
    ragged = [test[0], (test[1][0][:3], test[1][1][:3], test[1][2], test[1][3])] + test[2:]

    _feed_eval(port, jax_model, [len(test)])
    got, want = port.eval_datasets(test), jax_model.eval_datasets(test)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _feed_eval(port, jax_model, [None] * len(ragged))
    got, want = port.eval_datasets(ragged), jax_model.eval_datasets(ragged)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _feed_eval(port, jax_model, [None])
    np.testing.assert_allclose(port.eval(*test[1]), jax_model.eval(*test[1]), rtol=1e-5)
    x = np.linspace(-5.0, 5.0, 40)
    _feed_eval(port, jax_model, [None])
    ucb, lcb = port.confidence_intervals(test[0][0], test[0][1], x, confidence=0.9)
    ucb_j, lcb_j = jax_model.confidence_intervals(test[0][0], test[0][1], x, confidence=0.9)
    assert ucb.shape == lcb.shape == (40,) and np.all(ucb > lcb)
    np.testing.assert_allclose(ucb, ucb_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lcb, lcb_j, rtol=1e-5, atol=1e-6)


def test_chunkings_and_state_round_trip_are_bit_identical():
    """One chunk of 40 steps, chunks of 7, and 17 steps then a pickled
    ``state_dict`` into a new learner and 23 more: the same bits."""
    train, _ = _sin()
    kw = dict(KW, task_batch_size=3)
    one = NPRegressionMetaLearned(train, device="cpu", **kw)
    one.meta_fit(n_iter=40, log_period=40, verbose=False)
    chunked = NPRegressionMetaLearned(train, device="cpu", **kw)
    chunked.meta_fit(n_iter=40, log_period=7, verbose=False)
    first = NPRegressionMetaLearned(train, device="cpu", **kw)
    first.meta_fit(n_iter=17, log_period=17, verbose=False)
    resumed = NPRegressionMetaLearned(train, device="cpu", **kw)
    resumed.load_state_dict(pickle.loads(pickle.dumps(first.state_dict())))
    resumed.meta_fit(n_iter=23, log_period=23, verbose=False)
    for model in (chunked, resumed):
        for name in ("params", "_mu", "_nu"):
            assert torch.equal(getattr(model, name), getattr(one, name))
        assert model._step_count == 40 and model._adam_count == 40
