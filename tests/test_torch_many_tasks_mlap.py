"""PACOH-MLAP's fused path beyond the window of the one-block kernel, against the JAX learner.

At T=128 tasks of N=8 points, nets 16x16 and S=4 the one-block kernel's
window (test_torch_many_tasks.py keeps a copy of its formula) ended at
T=68; the port's learner takes the fused path there as the JAX learner
takes its Pallas kernel. From
chip_smoke.py's well-conditioned state (at a learner's own initial state
the inner KL's gram is singular to float32), loaded from the JAX learner's
``state_dict()``, and with the JAX learner's draws, ten steps of the fused
path's plain version are held to the JAX learner's XLA steps on the CPU,
and so is the meta-test, through ``eval_datasets`` on 128 context sets.
Parameter comparisons leave out the kernel net's output bias.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from meta_learning_pacoh_tpu import GPRegressionMetaLearnedPAC as JaxPAC
from meta_learning_pacoh_torch import GPRegressionMetaLearnedPAC
from meta_learning_pacoh_torch.models.random_gp import posterior_rsample
from chip_smoke import conditioned_tasks
from test_torch_fused_mlap import conditioned_params
from test_torch_many_tasks import (  # noqa: F401 (the fixture)
    D,
    K,
    N,
    NETS,
    STEPS,
    T,
    feed,
    jax_general_step,
    keep_of,
)


def mlap_pair(rs):
    tasks = conditioned_tasks(rs, T, N)
    kw = dict(random_seed=1, covar_module="NN", mean_module="NN", svi_batch_size=K,
              meta_kl_weight=1e-3, **NETS)
    jax_model = JaxPAC(tasks, **kw)
    jax_model.params = jax.tree.map(jnp.asarray, conditioned_params(jax_model, rs))
    port = GPRegressionMetaLearnedPAC(tasks, device="cpu", **kw)
    port.load_state_dict(jax_model.state_dict())
    return jax_model, port


def test_mlap_fused_path_matches_jax():
    """Ten steps of the fused path's plain version (count pages of the JAX
    draws) against the JAX learner's ten from one conditioned state:
    parameters within 1e-4, mean 2e-6, the loss rtol 1e-4 (the limits of
    the sin_20 MLAP tests)."""
    jax_model, port = mlap_pair(np.random.RandomState(5))
    feed(port, jax_model, K)
    assert port._fused_path_ok()
    want_loss, _ = jax_model.meta_fit(n_iter=STEPS, log_period=STEPS, verbose=False)
    got_loss, _ = port.meta_fit(n_iter=STEPS, log_period=STEPS, verbose=False)
    assert port._fused is not None
    keep = keep_of(port.hyper_prior)
    flat = {"loc": jax_model.params["hyper_post"]["loc"],
            "log_scale": jax_model.params["hyper_post"]["log_scale"],
            **{k: jax_model.params[k] for k in ("raw_noise", "q_means", "q_trils")}}
    for k, w in flat.items():
        got, w = port.params[k].numpy(), np.asarray(w)
        if k in ("loc", "log_scale"):
            got, w = got[keep], w[keep]
        d = np.abs(got - w)
        assert d.max() <= 1e-4 and d.mean() <= 2e-6, (k, d.max(), d.mean())
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)


def test_mlap_fused_meta_test_matches_jax(monkeypatch):
    """eval_datasets on 128 context sets of 8 points after a 10-step
    meta-test, the port fed the JAX learner's draws (the aggregated prior's
    samples, the posteriors' start and the meta-test's noise): the fused
    meta-test's plain version against the JAX XLA meta-test, LL, RMSE and
    calibration rtol 1e-4 (the sin_20 MLAP eval test's limit)."""
    rs = np.random.RandomState(6)
    jax_model, port = mlap_pair(rs)
    test = []
    for cx, cy in conditioned_tasks(rs, T, N):
        tx = np.linspace(-3.0, 3.0, 9)[:, None] + rs.uniform(-0.3, 0.3, (9, 1))
        test.append((cx, cy, tx, np.sin(tx[:, 0])))
    key = jax.random.PRNGKey(7)
    k_init, k_opt, k_theta = jax.random.split(key, 3)
    k_ith, k_ieps = jax.random.split(k_init)
    p = port.hyper_prior.dim

    def normal(k, shape):
        return torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))

    agg, init_theta = normal(k_theta, (20, p)), normal(k_ith, (20, p))
    init_eps = normal(k_ieps, (T, N))
    steps = torch.stack([normal(k, (K, p)) for k in jax.random.split(k_opt, STEPS)])
    monkeypatch.setattr(jax_model, "_next_key", lambda: key)
    monkeypatch.setattr(port, "_agg_eps", lambda seed: agg)
    monkeypatch.setattr(port, "_init_task_posteriors", lambda post, X, mask, seed: port._init_q(
        posterior_rsample(post, init_theta), init_eps[:, :X.shape[1]], X, mask))
    monkeypatch.setattr(port, "_meta_test_eps", lambda seed, s0, n: steps[s0:s0 + n])

    def general(*args):
        raise AssertionError("the meta-test left the fused path")

    monkeypatch.setattr(port, "_meta_test_general", general)
    assert port._fused_meta_test_ok(T, N, D)
    want = jax_model.eval_datasets(test, n_iter_meta_test=STEPS)
    got = port.eval_datasets(test, n_iter_meta_test=STEPS)
    np.testing.assert_allclose(got, want, rtol=1e-4)
