"""The port's distributed Cholesky and MLL tier on gloo ranks on the CPU,
against the JAX package's (parallel/dist_chol.py on its virtual 8-device
mesh, and its single-device paths).

One group of 1, 2 and 4 ranks each is spawned once for the module (the
harness of tests/test_torch_mesh.py); every rank runs every case, and the
tests compare the ranks' results with each other (the same bits) and with
the references the test process computes:

- ``distributed_cholesky`` at N=72 with blocks of 16 (the identity-tail
  padding) against JAX's ``distributed_cholesky``, at N=256 and N=100
  (ragged) with blocks of 32 against ``jnp.linalg.cholesky``;
- ``distributed_gp_mll``'s value and gradient against JAX's single-device
  ``gp_mll`` and its autodiff;
- ``distributed_gp_mll_batch`` and the dispatch of ``gp_mll`` /
  ``gp_mll_batch`` under ``distributed_linalg(min_n=64, block_size=16)``
  (a [K, B, N, N] operand keeps the single-device path);
- the N=520 PACOH-MAP learner (2 tasks, 3 steps, nets (8,)) through the
  tier against the JAX learner without a mesh, at the JAX package's own
  2e-3, and against the port's learner without a mesh.
"""

import numpy as np
import pytest
import torch

from meta_learning_pacoh_torch import GPRegressionMetaLearned
from meta_learning_pacoh_torch.ops import gp as gp_ops
from meta_learning_pacoh_torch.parallel import (
    distributed_cholesky,
    distributed_gp_mll,
    distributed_gp_mll_batch,
    make_mesh,
)
from meta_learning_pacoh_torch.parallel import dist_chol
from test_torch_mesh import flat_state, join_ranks, start_ranks

WORLDS = (1, 2, 4)
CHOL_CASES = ((72, 16), (256, 32), (100, 32))
MAP_KW = dict(num_iter_fit=3, task_batch_size=-1, random_seed=30, mean_nn_layers=(8,),
              kernel_nn_layers=(8,))


def _spd(n, seed=0):
    rs = np.random.RandomState(seed)
    a = rs.randn(n + 16, n).astype(np.float32)
    return (a.T @ a) / n + 0.5 * np.eye(n, dtype=np.float32)


def _mll_inputs(n=96, seed=3):
    rs = np.random.RandomState(2)
    return (rs.randn(n).astype(np.float32), _spd(n, seed=seed), rs.randn(n).astype(np.float32))


def _batch_inputs():
    """3 tasks of 96 points, the last 6 of each padded (the JAX test's)."""
    rs = np.random.RandomState(0)
    b, n = 3, 96
    a = rs.randn(b, n + 16, n).astype(np.float32)
    k = np.einsum("bij,bik->bjk", a, a) / n + 0.5 * np.eye(n, dtype=np.float32)
    y = rs.randn(b, n).astype(np.float32)
    mean = rs.randn(b, n).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    mask[:, 90:] = 0.0
    return mean, k, y, mask


def _map_data():
    from meta_learning_pacoh_torch.datasets import SinusoidDataset

    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=2, n_samples=520)
    test = env.generate_meta_test_data(n_tasks=2, n_samples_context=8, n_samples_test=16)
    return train, test


def _grad_of(fn, *args):
    args = [torch.tensor(a).requires_grad_(True) for a in args]
    value = fn(*args)
    grads = torch.autograd.grad(value.sum(), args)
    return value.detach().numpy(), [g.numpy() for g in grads]


def _work(rank, payload):
    mesh = make_mesh(device="cpu")
    out = {"chol": {}, "input_kept": True}
    for n, block in CHOL_CASES:
        a = torch.tensor(_spd(n, seed=n))
        out["chol"][n] = distributed_cholesky(a, mesh, block_size=block).numpy()
        out["input_kept"] &= bool(torch.equal(a, torch.tensor(_spd(n, seed=n))))

    mean, k, y = _mll_inputs()
    out["mll"] = _grad_of(lambda m, kk, yy: distributed_gp_mll(m, kk, yy, mesh, block_size=12),
                          mean, k, y)

    # the batch and the dispatch: a counter on the tier's entry
    calls = []
    batch_fn = dist_chol.distributed_gp_mll_batch
    dist_chol.distributed_gp_mll_batch = lambda *a, **kw: calls.append(1) or batch_fn(*a, **kw)
    try:
        bm, bk, by, bmask = _batch_inputs()
        out["batch"] = distributed_gp_mll_batch(torch.tensor(bm), torch.tensor(bk),
                                                torch.tensor(by), mesh, block_size=16).numpy()

        def tiered(kk):
            with gp_ops.distributed_linalg(mesh, min_n=64, block_size=16):
                return gp_ops.gp_mll_batch(torch.tensor(bm), kk, torch.tensor(by), 0.1,
                                           torch.tensor(bmask))

        out["dispatch"] = _grad_of(tiered, bk)
        out["batch_calls"] = len(calls)
        with gp_ops.distributed_linalg(mesh, min_n=64, block_size=16):
            one = gp_ops.gp_mll(torch.tensor(bm[0]), torch.tensor(bk[0]), torch.tensor(by[0]),
                                0.1, torch.tensor(bmask[0]))
            before = len(calls)
            stacked = gp_ops.gp_mll_batch(torch.tensor(bm)[None], torch.tensor(bk)[None],
                                          torch.tensor(by)[None], 0.1,
                                          torch.tensor(bmask)[None])
        out["gp_mll"] = one.numpy()
        out["stacked"] = stacked.numpy()
        out["stacked_calls"] = len(calls) - before
    finally:
        dist_chol.distributed_gp_mll_batch = batch_fn

    train, test = payload["map_train"], payload["map_test"]
    model = GPRegressionMetaLearned(train, mesh=mesh, device="cpu", **MAP_KW)
    out["map_tier"] = model._dist_linalg is not None and model._shard is None
    model.load_state_dict(payload["map_state"])
    model.meta_fit(verbose=False)
    out["map"] = flat_state(model.state_dict())
    out["map_eval"] = model.eval_datasets(test)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The groups' results and the JAX references."""
    import jax
    import jax.numpy as jnp

    from meta_learning_pacoh_tpu import GPRegressionMetaLearned as JaxMAP
    from meta_learning_pacoh_tpu.parallel.dist_chol import distributed_cholesky as jax_dist
    from meta_learning_pacoh_tpu.parallel.mesh import make_mesh as jax_mesh

    train, test = _map_data()
    jax_model = JaxMAP(train, **MAP_KW)
    port = GPRegressionMetaLearned(train, device="cpu", **MAP_KW)
    port.load_state_dict(jax_model.state_dict())
    payload = {"map_train": train, "map_test": test, "map_state": port.state_dict()}
    handles = {w: start_ranks(tmp_path_factory.mktemp(f"world{w}"), w, _work, payload)
               for w in WORLDS}

    refs = {"chol": {}}
    for n, block in CHOL_CASES:
        k = jnp.asarray(_spd(n, seed=n))
        refs["chol"][n] = np.asarray(jax_dist(k, jax_mesh(8), "task", block) if n == 72
                                     else jnp.linalg.cholesky(k))

    from meta_learning_pacoh_tpu.ops import gp as jax_gp

    mean, k, y = _mll_inputs()
    n = y.shape[0]
    # gp_mll / n_eff without noise: the MLL of (mean, K, y) times n
    value, grads = jax.value_and_grad(
        lambda m, kk, yy: n * jax_gp.gp_mll(m, kk, yy, 0.0, jitter=0.0), argnums=(0, 1, 2))(
            jnp.asarray(mean), jnp.asarray(k), jnp.asarray(y))
    refs["mll"] = (np.asarray(value), [np.asarray(g) for g in grads])

    bm, bk, by, bmask = (jnp.asarray(a) for a in _batch_inputs())
    refs["batch"] = np.asarray(jax.vmap(lambda m, kk, yy: kk.shape[0] * jax_gp.gp_mll(
        m, kk, yy, 0.0, jitter=0.0))(bm, bk, by))
    refs["dispatch"] = jax.value_and_grad(
        lambda kk: jnp.sum(jax_gp.gp_mll_batch(bm, kk, by, 0.1, bmask)))(bk)
    refs["dispatch_values"] = np.asarray(jax_gp.gp_mll_batch(bm, bk, by, 0.1, bmask))
    jax_model.meta_fit(verbose=False)
    refs["jax_map_eval"] = jax_model.eval_datasets(test)
    refs["jax_map"] = jax_model
    port.meta_fit(verbose=False)  # without a mesh: torch.linalg above 512 points
    refs["map"] = flat_state(port.state_dict())
    refs["map_eval"] = port.eval_datasets(test)
    yield {w: join_ranks(h) for w, h in handles.items()}, refs


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_ends_with_the_same_bits(runs, world):
    results, _ = runs
    first = results[world][0]
    for res in results[world][1:]:
        for n in first["chol"]:
            np.testing.assert_array_equal(res["chol"][n], first["chol"][n])
        np.testing.assert_array_equal(res["mll"][0], first["mll"][0])
        for g, f in zip(res["mll"][1], first["mll"][1]):
            np.testing.assert_array_equal(g, f)
        for k in first["map"]:
            np.testing.assert_array_equal(res["map"][k], first["map"][k])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n", [n for n, _ in CHOL_CASES])
def test_distributed_cholesky_matches_jax(runs, world, n):
    """N=72 / blocks of 16 against JAX's distributed_cholesky on its 8-device
    mesh; 256 and the ragged 100 / blocks of 32 against jnp.linalg.cholesky
    (the JAX test's limits: atol 2e-5, rtol 1e-5)."""
    results, refs = runs
    got = results[world][0]["chol"][n]
    assert got.shape == (n, n)
    assert results[world][0]["input_kept"]  # the factorization never writes its input
    np.testing.assert_allclose(got, refs["chol"][n], atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(np.triu(got, 1), 0.0)


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_mll_value_and_gradient_match_jax(runs, world):
    """The closed-form backward against JAX's autodiff of its single-device
    gp_mll (value rtol 1e-5; gradients atol 5e-4 / rtol 1e-3, the JAX
    test's)."""
    results, refs = runs
    value, grads = results[world][0]["mll"]
    np.testing.assert_allclose(value, refs["mll"][0], rtol=1e-5)
    for g, w in zip(grads, refs["mll"][1]):
        np.testing.assert_allclose(g, w, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_batch_and_dispatch_match_jax(runs, world):
    """distributed_gp_mll_batch; gp_mll_batch in the context (values and the
    gradient in K, padded tasks included) against JAX's single-device path,
    rtol/atol 2e-5 and 1e-3 / 5e-4 (the JAX test's); gp_mll on one system
    takes the tier too; a [K, B, N, N] operand does not."""
    results, refs = runs
    res = results[world][0]
    np.testing.assert_allclose(res["batch"], refs["batch"], rtol=2e-5, atol=2e-5)
    value, (grad,) = res["dispatch"]
    np.testing.assert_allclose(value, refs["dispatch_values"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(grad, np.asarray(refs["dispatch"][1]), rtol=1e-3, atol=5e-4)
    assert res["batch_calls"] == 1  # the dispatched call
    np.testing.assert_allclose(res["gp_mll"], refs["dispatch_values"][0], rtol=2e-5, atol=2e-5)
    assert res["stacked_calls"] == 0
    np.testing.assert_allclose(res["stacked"][0], refs["dispatch_values"], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_map_learner_routes_large_n_through_the_tier(runs, world):
    """PACOH-MAP with mesh= on 2 tasks of 520 points: the tasks stay whole and
    the tier factors them; after 3 steps its evaluation against the JAX
    learner without a mesh (rtol/atol 2e-3, the JAX test's) and its state
    against the port's learner without a mesh (torch.linalg above 512
    points), the kernel net's output bias left out (the degenerate leaf)."""
    from meta_learning_pacoh_torch.models.random_gp import layout_slice

    results, refs = runs
    res = results[world][0]
    assert res["map_tier"]
    ll, rmse, _ = res["map_eval"]
    want_ll, want_rmse, _ = refs["jax_map_eval"]
    np.testing.assert_allclose(ll, want_ll, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(rmse, want_rmse, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(res["map_eval"], refs["map_eval"], rtol=1e-4, atol=1e-5)
    layout = GPRegressionMetaLearned(_map_data()[0], device="cpu", **MAP_KW).layout
    keep = np.ones(res["map"]["params"].shape, bool)
    keep[layout_slice(layout, ("kernel_nn", "b_out"))] = False
    for k in ("params", "opt_state/mu"):
        np.testing.assert_allclose(res["map"][k][keep], refs["map"][k][keep], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
