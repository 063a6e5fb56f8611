"""The port's multi-device layer on gloo ranks on the CPU.

The JAX package shards over a virtual 8-device CPU mesh inside one process;
the port runs one process a rank. Each group of ranks here is spawned once
a module (a module-scoped fixture): every rank runs all of the module's
cases and hands its results back, and the tests compare them. The ranks
meet through ``initialize_distributed`` on a file under the test's
temporary directory (no TCP port for parallel workers to race for), one
thread a rank.

What is held, and to what:

- ``make_mesh`` / ``make_seed_mesh`` shapes, ``shard_task_batch``'s slices
  (and its refusal of a count that does not divide the mesh, as JAX's
  ``device_put`` refuses it);
- ``build_svgd_parallel_step`` on 2 ranks and on the (2, 2) mesh against
  the port's single-process step, and with a numeric bandwidth against the
  JAX package's unsharded step;
- each of the seven learners that take ``mesh=`` on 4 ranks (16 tasks of 8
  points, as the JAX package's tests/test_parallel.py) against the port's
  unsharded learner from the same state and draws at rtol 1e-4 / atol 1e-5,
  and against the JAX learner (MAML and the NP against JAX's sharded
  learner on its 8-device mesh, the others against JAX's unsharded one)
  at the port's parity tolerance (max 1e-4, mean 2e-6). The general steps
  run on both sides: a learner built with ``mesh=`` turns its fused kernels
  off, and the unsharded runs here take ``PACOH_TORCH_DISABLE_FUSED=1``;
- the seed stack (5 seeds on 2 ranks, padded) and the hyper-parallel trials
  with ``mesh=`` against the same calls without a mesh;
- every rank ends with the same bits of every replicated quantity.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from meta_learning_pacoh_torch import (
    GPRegressionLearned,
    GPRegressionMetaLearned,
    GPRegressionMetaLearnedPAC,
    GPRegressionMetaLearnedSVGD,
    GPRegressionMetaLearnedVI,
    MAMLRegression,
    NPRegressionMetaLearned,
)
from meta_learning_pacoh_torch.models.random_gp import make_hyper_prior, meta_log_prob, \
    random_gp_config
from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.svgd import svgd_phi
from meta_learning_pacoh_torch.parallel import (
    build_svgd_parallel_step,
    fit_models_parallel,
    initialize_distributed,
    make_mesh,
    make_seed_mesh,
    shard_task_batch,
)
from meta_learning_pacoh_torch.utils.tuning_parallel import fit_svgd_hyper_parallel

RANK_TIMEOUT = 240  # seconds for a group of ranks to finish its cases


# ------------------------------------------------------------ the harness
def _rank_main(rank, world, init_file, work, payload, out_dir, env):
    os.environ.update(env)
    torch.set_num_threads(1)
    initialize_distributed("file://" + init_file, world, rank, device="cpu")
    try:
        result = work(rank, payload)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def start_ranks(tmp_dir, world, work, payload, env=None):
    """Spawn ``work(rank, payload)`` on ``world`` gloo ranks of one thread
    (``env`` set in them); ``join_ranks`` collects their results."""
    tmp_dir = str(tmp_dir)
    env = dict({"OMP_NUM_THREADS": "1"}, **(env or {}))
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # before the ranks import torch
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(world, os.path.join(tmp_dir, "init"), work, payload, tmp_dir, env),
            nprocs=world, join=False, start_method="spawn")
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    return ctx, tmp_dir, world, time.time() + RANK_TIMEOUT


def join_ranks(handle):
    """Each rank's result of a ``start_ranks`` group, in rank order."""
    ctx, tmp_dir, world, deadline = handle
    while not ctx.join(timeout=1):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {RANK_TIMEOUT} s")
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def flat_state(state, prefix=""):
    """A nested state dict -> {path: numpy array} (numbers as arrays)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(flat_state(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_same_bits(results, key):
    """Every rank's ``results[r][key]`` (a flat state) is bit-identical."""
    first = results[0][key]
    for r, res in enumerate(results[1:], 1):
        assert set(res[key]) == set(first)
        for k, v in first.items():
            np.testing.assert_array_equal(res[key][k], v, err_msg=f"rank {r} {k}")


def _tasks(n_tasks=16, n=8, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_tasks):
        x = rs.uniform(-5, 5, (n, 1))
        out.append((x, np.sin(x) + 2 + 0.05 * rs.normal(size=(n, 1))))
    return out


# ------------------------------------------------------------ the learners
NETS = dict(mean_nn_layers=(8, 8), kernel_nn_layers=(8, 8))
STEPS = 10
# name -> (class, constructor keywords); every one full batch
LEARNERS = {
    "map": (GPRegressionMetaLearned, dict(NETS, task_batch_size=-1, random_seed=3)),
    "svgd": (GPRegressionMetaLearnedSVGD, dict(NETS, num_particles=4, random_seed=7)),
    "vi": (GPRegressionMetaLearnedVI, dict(NETS, svi_batch_size=3, random_seed=30)),
    "mlap": (GPRegressionMetaLearnedPAC, dict(NETS, covar_module="NN", mean_module="NN",
                                              svi_batch_size=3, meta_kl_weight=1e-3,
                                              random_seed=1)),
    "maml": (MAMLRegression, dict(layer_sizes=(16, 16), task_batch_size=-1, random_seed=5)),
    "np": (NPRegressionMetaLearned, dict(r_dim=8, z_dim=8, h_dim=8, task_batch_size=-1,
                                         random_seed=5)),
}
GPR_KW = dict(mean_nn_layers=(8,), kernel_nn_layers=(8,), random_seed=30, lr_scheduler=False)
GPR_STEPS = 3
MLAP_META_TEST = 30


def _feed(model, feeds):
    """Give a port learner the JAX learner's draws (numpy, every step's)."""
    if "eps" in feeds:
        eps, idx = torch.from_numpy(feeds["eps"]), torch.from_numpy(feeds["idx"])
        model._draw_eps = lambda step, out: out.copy_(eps[step])
        model._task_draw = lambda step: idx[step]
    if "u" in feeds:
        u, eps = torch.from_numpy(feeds["u"]), torch.from_numpy(feeds["z_eps"])
        model._step_draws = lambda step: (None, u[step], eps[step])


def _fit_port(name, train, state, feeds, mesh=None):
    cls, kw = LEARNERS[name]
    model = cls(train, mesh=mesh, device="cpu", **kw)
    model.load_state_dict(state)
    _feed(model, feeds)
    model.meta_fit(n_iter=STEPS, log_period=STEPS, verbose=False)
    return model


def _learner_work(rank, payload):
    mesh = make_mesh(device="cpu")
    out = {"mesh": (tuple(mesh.mesh_dim_names), tuple(mesh.shape))}
    for name, (state, feeds) in payload["learners"].items():
        model = _fit_port(name, payload["train"][name], state, feeds, mesh)
        out[name] = flat_state(model.state_dict())
        if name == "mlap":
            out["mlap_eval"] = model.eval_datasets(payload["mlap_test"],
                                                   n_iter_meta_test=MLAP_META_TEST)
            out["mlap_eval_state"] = flat_state(model.state_dict())
    x, y, state = payload["gpr"]
    gpr = GPRegressionLearned(x, y, mesh=mesh, device="cpu", **GPR_KW)
    gpr.load_state_dict(state)
    gpr.fit(n_iter=GPR_STEPS, log_period=GPR_STEPS, verbose=False)
    out["gpr"] = flat_state(gpr.state_dict())
    out["gpr_tier"] = gpr._dist_linalg is not None

    # the parallel SVGD step on the (2, 2) mesh
    mesh2 = make_mesh(particle_parallel=True, device="cpu")
    out["mesh2"] = (tuple(mesh2.mesh_dim_names), tuple(mesh2.shape))
    out["step_2d"] = _parallel_steps(mesh2, payload["step"])
    return out


# ------------------------------------------------- the parallel SVGD step
STEP_CFG = dict(feature_dim=1, mean_nn_layers=(8,), kernel_nn_layers=(8,))


def _step_data(seed=0, k=8):
    """Tasks, normalised roughly, and particles from the hyper-prior (numpy)."""
    from meta_learning_pacoh_torch.utils.input_handling import stack_task_tuples

    X, Y, M = stack_task_tuples(_tasks())
    Y = (Y - Y.mean()) / (Y.std() + 1e-8)
    hp = make_hyper_prior(random_gp_config(1, **STEP_CFG))
    particles = hp.sample(torch.Generator().manual_seed(seed), (k,)).numpy()
    return {"X": X.astype(np.float32), "Y": Y.astype(np.float32), "M": M.astype(np.float32),
            "particles": particles}


def _parallel_steps(mesh, data, n_steps=3):
    """n_steps of ``build_svgd_parallel_step`` at the median bandwidth and at
    bandwidth 1.0 -> each run's particles, gathered over the particle axis."""
    hp = make_hyper_prior(random_gp_config(1, **STEP_CFG))
    out = {}
    for label, bandwidth in (("median", None), ("fixed", 1.0)):
        step, place = build_svgd_parallel_step(hp, 0.01, 1e-2, mesh, bandwidth=bandwidth)
        state = place(data["particles"], None, data["X"], data["Y"], data["M"])
        particles, opt_state, X, Y, M = state
        for _ in range(n_steps):
            particles, opt_state = step(particles, opt_state, X, Y, M)
        if "particle" in mesh.mesh_dim_names:
            from meta_learning_pacoh_torch.parallel.mesh import all_gather, axis_group

            particles = all_gather(particles, axis_group(mesh, "particle")).reshape(
                -1, particles.shape[-1])
        out[label] = particles.numpy()
    return out


def _single_process_steps(data, bandwidth, n_steps=3):
    """The same steps in one process with no mesh: the score, phi, Adam."""
    hp = make_hyper_prior(random_gp_config(1, **STEP_CFG))
    X, Y, M = (torch.from_numpy(data[k]) for k in ("X", "Y", "M"))
    particles = torch.from_numpy(data["particles"]).clone()
    mu, nu = torch.zeros_like(particles), torch.zeros_like(particles)
    for i in range(n_steps):
        part = particles.detach().requires_grad_(True)
        (score,) = torch.autograd.grad(meta_log_prob(hp, 0.01, part, X, Y, M).sum(), part)
        with torch.no_grad():
            phi = svgd_phi(particles, score, bandwidth=bandwidth)
            cuda.adam_step_(particles, mu, nu, -phi, i + 1, 1e-2)
    return particles.numpy()


def _jax_unsharded_steps(data, n_steps=3):
    """The JAX package's step on a one-device mesh, bandwidth 1.0."""
    import jax.numpy as jnp
    import optax

    from meta_learning_pacoh_tpu.models.random_gp import make_hyper_prior as jax_prior
    from meta_learning_pacoh_tpu.models.random_gp import random_gp_config as jax_config
    from meta_learning_pacoh_tpu.parallel.mesh import build_svgd_parallel_step as jax_build
    from meta_learning_pacoh_tpu.parallel.mesh import make_mesh as jax_mesh

    hp = jax_prior(jax_config(1, **STEP_CFG))
    opt = optax.adam(1e-2)
    step, place = jax_build(hp, 0.01, opt, jax_mesh(1), bandwidth=1.0)
    particles = jnp.asarray(data["particles"])
    p, s, X, Y, M = place(particles, opt.init(particles), data["X"], data["Y"], data["M"])
    for _ in range(n_steps):
        p, s = step(p, s, X, Y, M)
    return np.asarray(p)


# ------------------------------------------------------ the 2-rank group
SEEDS = (22, 23, 24, 25, 26)
STACK_KW = dict(NETS, num_particles=3, num_iter_fit=5)


def _stack_models(train, seeds=SEEDS, **kw):
    return [GPRegressionMetaLearnedSVGD(train, random_seed=s, device="cpu",
                                        **dict(STACK_KW, **kw)) for s in seeds]


def _trial_models(train):
    return [GPRegressionMetaLearnedSVGD(train, random_seed=9, lr=lr, prior_factor=pf,
                                        device="cpu", **STACK_KW)
            for lr, pf in ((1e-3, 0.01), (3e-3, 0.1), (1e-2, 0.05))]


def _two_rank_work(rank, payload):
    out = {"world": dist.get_world_size(), "rank": dist.get_rank()}
    mesh = make_mesh(device="cpu")
    out["mesh"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    refused = make_mesh(particle_parallel=True, device="cpu")  # 2 ranks: 1-D
    out["mesh_pp"] = (tuple(refused.mesh_dim_names), tuple(refused.shape))
    seed_mesh = make_seed_mesh(device="cpu")
    out["seed_mesh"] = (tuple(seed_mesh.mesh_dim_names), tuple(seed_mesh.shape))

    X = np.arange(4 * 3 * 1, dtype=np.float32).reshape(4, 3, 1)
    shards = shard_task_batch(mesh, X, X[..., 0], np.ones((4, 3), np.float32))
    out["shard"] = [s.numpy() for s in shards]
    try:
        shard_task_batch(mesh, X[:3], X[:3, :, 0], np.ones((3, 3), np.float32))
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)

    out["step_1d"] = _parallel_steps(mesh, payload["step"])

    train = payload["stack_train"]
    models = _stack_models(train)
    fit_models_parallel(models, n_iter=5, mesh=seed_mesh, prefer="vmap")
    out["stack"] = [flat_state(m.state_dict()) for m in models]
    trials = _trial_models(train)
    fit_svgd_hyper_parallel(trials, n_iter=5, mesh=seed_mesh)
    out["trials"] = [flat_state(m.state_dict()) for m in trials]

    # the default route with a mesh, on models in a fused window: the seed
    # axis is still split (each rank steps a stack of its share)
    os.environ.pop("PACOH_TORCH_DISABLE_FUSED")
    try:
        models = _stack_models(train)
        out["stack_auto_fused"] = all(m._fused_path_ok() for m in models)
        cls, sizes = type(models[0]), []
        stacked_step = cls._stacked_step

        def spy(self, stack):
            sizes.append(len(stack.models))
            return stacked_step(self, stack)

        cls._stacked_step = spy
        try:
            fit_models_parallel(models, n_iter=5, mesh=seed_mesh)
        finally:
            cls._stacked_step = stacked_step
        out["stack_auto"] = [flat_state(m.state_dict()) for m in models]
        out["stack_auto_sizes"] = sizes
        try:
            fit_models_parallel(_stack_models(train), n_iter=5, mesh=seed_mesh,
                                prefer="sequential_fused")
            out["stack_fused_mesh"] = None
        except ValueError as e:
            out["stack_fused_mesh"] = str(e)
    finally:
        os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
    return out


# -------------------------------------------------------------- fixtures
def _jax_learner_and_feeds(name, train):
    """The JAX learner (unsharded; MAML and the NP on the 8-device mesh) at
    the run's initial state, its state, and its draws, for ``name``."""
    import jax
    import jax.numpy as jnp

    import meta_learning_pacoh_tpu as J
    from meta_learning_pacoh_tpu.parallel.mesh import make_mesh as jax_mesh

    cls = {"map": J.GPRegressionMetaLearned, "svgd": J.GPRegressionMetaLearnedSVGD,
           "vi": J.GPRegressionMetaLearnedVI, "mlap": J.GPRegressionMetaLearnedPAC,
           "maml": J.MAMLRegression, "np": J.NPRegressionMetaLearned}[name]
    kw = dict(LEARNERS[name][1])
    if name in ("maml", "np"):
        kw["mesh"] = jax_mesh(8)
    model = cls(train, **kw)
    feeds = {}
    if name == "mlap":
        from test_torch_fused_mlap import conditioned_params

        model.params = jax.tree.map(jnp.asarray, conditioned_params(
            model, np.random.RandomState(2)))
    if name in ("vi", "mlap"):
        p = model.hyper_prior.dim

        def one(i):
            k_task, k_theta = jax.random.split(jax.random.fold_in(model._train_key, i))
            return (jax.random.randint(k_task, (model.task_batch_size,), 0, model.n_tasks),
                    jax.random.normal(k_theta, (model.svi_batch_size, p), jnp.float32))

        idx, eps = jax.vmap(one)(jnp.arange(STEPS))
        feeds = {"idx": np.asarray(idx).astype(np.int64), "eps": np.array(eps)}
    if name == "np":
        from test_torch_npr import _task_draws

        us, zs = [], []
        for step in range(STEPS):
            _, k_split = jax.random.split(jax.random.fold_in(model._train_key, step))
            u, z = _task_draws(jax.random.split(k_split, model.n_tasks), model.X.shape[1], 8)
            us.append(u.numpy())
            zs.append(z.numpy())
        feeds = {"u": np.stack(us), "z_eps": np.stack(zs)}
    return model, feeds


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups' results and every reference: the JAX learners and the
    port's unsharded ones from the same states and draws."""
    from meta_learning_pacoh_tpu.utils import jit_cache

    from chip_smoke import conditioned_tasks

    saved = {k: os.environ.get(k) for k in ("PACOH_TORCH_DISABLE_FUSED",
                                             "PACOH_TPU_FORCE_PALLAS", "PACOH_TPU_DISABLE_FUSED")}
    os.environ["PACOH_TORCH_DISABLE_FUSED"] = "1"
    os.environ.pop("PACOH_TPU_FORCE_PALLAS", None)
    os.environ["PACOH_TPU_DISABLE_FUSED"] = "1"
    jit_cache.clear()
    try:
        train = {name: _tasks() for name in LEARNERS}
        train["mlap"] = conditioned_tasks(np.random.RandomState(2), 16, 8)
        mlap_test = [(x[:4], y[:4], x[4:], y[4:])
                     for x, y in conditioned_tasks(np.random.RandomState(3), 8, 8)]
        step_data = _step_data()
        stack_train = _tasks(n_tasks=6, n=5, seed=4)

        jax_models, states = {}, {}
        for name in LEARNERS:
            jax_model, feeds = _jax_learner_and_feeds(name, train[name])
            cls, kw = LEARNERS[name]
            port = cls(train[name], device="cpu", **kw)
            port.load_state_dict(jax_model.state_dict())
            states[name] = (port.state_dict(), feeds)
            jax_models[name] = jax_model
        gpr_train = _gpr_task()
        jax_gpr = _jax_gpr(gpr_train)
        port_gpr = GPRegressionLearned(*gpr_train, device="cpu", **GPR_KW)
        port_gpr.load_state_dict(jax_gpr.state_dict())
        payload = {"learners": states, "train": train, "mlap_test": mlap_test,
                   "gpr": (*gpr_train, port_gpr.state_dict()), "step": step_data}
        env = {"PACOH_TORCH_DISABLE_FUSED": "1"}
        # the ranks run while the references are computed
        four = start_ranks(tmp_path_factory.mktemp("four"), 4, _learner_work, payload, env)
        two = start_ranks(tmp_path_factory.mktemp("two"), 2, _two_rank_work,
                          {"step": step_data, "stack_train": stack_train}, env)

        refs = {}
        for name, (state, feeds) in states.items():
            model = _fit_port(name, train[name], state, feeds)
            refs[name] = flat_state(model.state_dict())
            if name == "svgd":
                # the TPU Stein kernel's median (rank K*K//2), the port's
                # convention, in interpret mode; XLA's plain path takes the
                # midpoint of the two middles
                os.environ["PACOH_TPU_FORCE_PALLAS"] = "1"
                jit_cache.clear()
            jax_models[name].meta_fit(n_iter=STEPS, log_period=STEPS, verbose=False)
            os.environ.pop("PACOH_TPU_FORCE_PALLAS", None)
            jit_cache.clear()
            if name == "mlap":
                refs["mlap_eval"] = model.eval_datasets(mlap_test,
                                                        n_iter_meta_test=MLAP_META_TEST)
        port_gpr.fit(n_iter=GPR_STEPS, log_period=GPR_STEPS, verbose=False)
        jax_gpr.fit(n_iter=GPR_STEPS, log_period=GPR_STEPS, verbose=False)
        refs["gpr"] = flat_state(port_gpr.state_dict())
        refs["step"] = {"median": _single_process_steps(step_data, None),
                        "fixed": _single_process_steps(step_data, 1.0),
                        "jax": _jax_unsharded_steps(step_data)}
        stack = _stack_models(stack_train)
        fit_models_parallel(stack, n_iter=5, prefer="vmap")
        refs["stack"] = [flat_state(m.state_dict()) for m in stack]
        trials = _trial_models(stack_train)
        fit_svgd_hyper_parallel(trials, n_iter=5)
        refs["trials"] = [flat_state(m.state_dict()) for m in trials]
        yield {"four": join_ranks(four), "two": join_ranks(two), "refs": refs,
               "jax": jax_models, "jax_gpr": jax_gpr}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jit_cache.clear()


def _gpr_task(n=520):
    from meta_learning_pacoh_torch.datasets import SinusoidDataset

    env = SinusoidDataset(random_state=np.random.RandomState(26))
    (x, y), = env.generate_meta_train_data(n_tasks=1, n_samples=n)
    return x, y


def _jax_gpr(train):
    from meta_learning_pacoh_tpu import GPRegressionLearned as JaxGPR

    return JaxGPR(*train, **GPR_KW)


# ------------------------------------------------------------------ tests
def test_make_mesh_shapes_and_shard_task_batch(runs):
    two, four = runs["two"], runs["four"]
    for res in two:
        assert res["world"] == 2
        assert res["mesh"] == (("task",), (2,))
        assert res["mesh_pp"] == (("task",), (2,))  # particle_parallel needs >= 4 ranks
        assert res["seed_mesh"] == (("seed",), (2,))
        assert "divisible" in res["uneven"]
    for r, res in enumerate(two):
        X = np.arange(12, dtype=np.float32).reshape(4, 3, 1)
        np.testing.assert_array_equal(res["shard"][0], X[2 * r:2 * r + 2])
        np.testing.assert_array_equal(res["shard"][1], X[2 * r:2 * r + 2, :, 0])
    for res in four:
        assert res["mesh"] == (("task",), (4,))
        assert res["mesh2"] == (("task", "particle"), (2, 2))


def test_initialize_distributed_single_process_is_a_no_op():
    """No coordinator and at most one process: nothing to rendezvous."""
    was = dist.is_initialized()
    initialize_distributed()
    initialize_distributed(num_processes=1)
    assert dist.is_initialized() == was
    with pytest.raises(ValueError, match="one local device id"):
        initialize_distributed("localhost:1", 2, 0, local_device_ids=[0, 1], device="cpu")


@pytest.mark.parametrize("label", ["median", "fixed"])
@pytest.mark.parametrize("group", ["step_1d", "step_2d"])
def test_parallel_svgd_step_matches_single_process(runs, group, label):
    """Three steps of build_svgd_parallel_step on 2 ranks (tasks sharded) and
    on the (2, 2) mesh (tasks and particles sharded) against the same steps
    in one process, and the two-rank runs bit-identical."""
    results = runs["two"] if group == "step_1d" else runs["four"]
    want = runs["refs"]["step"][label]
    for res in results:
        np.testing.assert_allclose(res[group][label], want, rtol=1e-4, atol=1e-5)
    for res in results[1:]:
        np.testing.assert_array_equal(res[group][label], results[0][group][label])


def test_parallel_svgd_step_matches_jax(runs):
    """At bandwidth 1.0 (the JAX package's plain transport has no median of
    the port's convention), against JAX's unsharded step."""
    want = runs["refs"]["step"]["jax"]
    np.testing.assert_allclose(runs["refs"]["step"]["fixed"], want, rtol=1e-4, atol=1e-5)
    for res in runs["four"]:
        np.testing.assert_allclose(res["step_2d"]["fixed"], want, rtol=1e-4, atol=1e-5)


def _jax_flat(name, model):
    """The JAX learner's parameters as the port's flat vectors."""
    import jax

    from meta_learning_pacoh_torch.interop import from_jax_map_state, from_jax_mlap_state, \
        from_jax_state, from_jax_vi_state

    state = jax.tree.map(np.asarray, model.state_dict())
    convert = {"map": from_jax_map_state, "svgd": from_jax_state, "vi": from_jax_vi_state,
               "mlap": from_jax_mlap_state}.get(name)
    if convert is not None:
        return flat_state(convert(state))
    cls, kw = LEARNERS[name]
    port = cls(_tasks(), device="cpu", **kw)
    port.load_state_dict(state)
    return flat_state(port.state_dict())


def _kernel_bias(name):
    """A mask of the flat GP parameter vector that leaves out the kernel
    net's output bias (exactly zero gradient: Adam walks float noise there,
    ROADMAP's degenerate leaf); None for MAML and the NP."""
    if name in ("maml", "np"):
        return None
    from meta_learning_pacoh_torch.models.gp_base import GPConfig
    from meta_learning_pacoh_torch.models.random_gp import flat_layout, layout_dim, \
        layout_slice

    if name == "map":
        cfg = GPConfig(input_dim=1, feature_dim=2, mean_module="NN", covar_module="NN",
                       mean_nn_layers=NETS["mean_nn_layers"],
                       kernel_nn_layers=NETS["kernel_nn_layers"])
    else:
        cfg = random_gp_config(1, feature_dim=1, mean_module="NN", covar_module="NN", **NETS)
    layout = flat_layout(cfg)
    keep = np.ones(layout_dim(layout), bool)
    keep[layout_slice(layout, ("kernel_nn", "b_out"))] = False
    return keep


def _kept(a, keep):
    return a if keep is None or a.shape[-1:] != keep.shape else a[..., keep]


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_sharded_learner_matches_unsharded_and_jax(runs, name):
    """Ten full-batch steps on 4 ranks: every rank the same bits; against the
    port's unsharded learner rtol 1e-4 / atol 1e-5 (parameters and
    optimizer state); against the JAX learner max 1e-4 and mean 2e-6. The
    GP learners' kernel-net output bias is left out of both comparisons."""
    results, ref = runs["four"], runs["refs"][name]
    assert_same_bits(results, name)
    got = results[0][name]
    keep = _kernel_bias(name)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(_kept(got[k], keep), _kept(ref[k], keep), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    want = _jax_flat(name, runs["jax"][name])
    gap = np.concatenate([np.abs(_kept(got[k], keep) - _kept(want[k], keep)).ravel()
                          for k in want if k.startswith(("params", "particles", "posterior"))])
    assert gap.max() <= 1e-4 and gap.mean() <= 2e-6, (gap.max(), gap.mean())


def test_sharded_mlap_meta_test_matches_unsharded(runs):
    """MLAP's meta-test with the 8 test tasks sharded over the 4 ranks and
    gathered: the evaluation as the unsharded learner's (JAX's own limit,
    1e-3 in LL and RMSE), the gathered state the same on every rank."""
    want = runs["refs"]["mlap_eval"]
    for res in runs["four"]:
        ll, rmse, _ = res["mlap_eval"]
        assert abs(ll - want[0]) < 1e-3 and abs(rmse - want[1]) < 1e-3
        assert res["mlap_eval"] == runs["four"][0]["mlap_eval"]
    assert_same_bits(runs["four"], "mlap_eval_state")


def test_gpr_mll_through_the_distributed_tier(runs):
    """GPR-MLL on one task of 520 points with mesh=: the training MLL through
    the distributed tier on 4 ranks, 3 steps, against the port's learner
    without a mesh (rtol 1e-4 / atol 1e-5) and the JAX learner (2e-3, its
    own limit for the N=520 tier)."""
    import jax

    from meta_learning_pacoh_torch.interop import from_jax_gpr_state
    from meta_learning_pacoh_torch.models.random_gp import layout_slice

    results, ref = runs["four"], runs["refs"]["gpr"]
    assert all(res["gpr_tier"] for res in results)
    assert_same_bits(results, "gpr")
    layout = GPRegressionLearned(*_gpr_task(20), device="cpu", **GPR_KW).layout
    keep = np.ones(ref["params"].shape, bool)
    keep[layout_slice(layout, ("kernel_nn", "b_out"))] = False  # the degenerate leaf
    for k in ("params", "opt_state/mu", "opt_state/nu"):
        np.testing.assert_allclose(results[0]["gpr"][k][keep], ref[k][keep], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    want = from_jax_gpr_state(jax.tree.map(np.asarray, runs["jax_gpr"].state_dict()))
    np.testing.assert_allclose(results[0]["gpr"]["params"][keep], want["params"][keep],
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("what", ["stack", "trials", "stack_auto"])
def test_seed_and_trial_stacks_on_a_mesh(runs, what):
    """Five seeds (and three trials) on 2 ranks, a count that does not divide
    the mesh: padded, split, gathered. Every rank ends with every model's
    state, the same bits, within rtol 1e-4 / atol 1e-5 of the stack without
    a mesh. With the default ``prefer`` a mesh splits the seed axis also
    where every model is in a fused window (each rank steps 3 of the 6
    padded fits), and 'sequential_fused' with a mesh is refused."""
    results, want = runs["two"], runs["refs"]["stack" if what == "stack_auto" else what]
    if what == "stack_auto":
        for res in results:
            assert res["stack_auto_fused"]
            assert res["stack_auto_sizes"] == [3] * 5
            assert "sequential_fused" in res["stack_fused_mesh"]
    for res in results:
        assert len(res[what]) == len(want)
        for got, ref in zip(res[what], want):
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for got, ref in zip(results[1][what], results[0][what]):
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


def test_mesh_preconditions():
    """mesh= needs the full batch, a 'task' axis and a mesh of the learner's
    device type; a seed stack refuses learners that carry a mesh; without a
    card a CUDA mesh raises."""

    class FakeMesh:
        mesh_dim_names = ("task",)
        device_type = "cuda"

    train = _tasks(n_tasks=4, n=5)
    with pytest.raises(ValueError, match="full batch"):
        GPRegressionMetaLearned(train, task_batch_size=2, mesh=FakeMesh(), device="cpu")
    with pytest.raises(ValueError, match="device type"):
        GPRegressionMetaLearnedSVGD(train, mesh=FakeMesh(), device="cpu")
    FakeMesh.mesh_dim_names = ("seed",)
    with pytest.raises(ValueError, match="'task' axis"):
        MAMLRegression(train, task_batch_size=-1, mesh=FakeMesh(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
