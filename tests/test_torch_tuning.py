"""The port's tuning and experiment harness on the CPU.

Mirrors tests/test_tuning_parallel.py (hyper-parallel trials: K learners
that differ only in lr, weight decay, prior_factor or bandwidth fitted as
one stack; ``tune_run``'s batch mode; ``run_trial_batch``) and the tuning,
experiment and ``StepTimer`` cases of tests/test_harness.py, for
``meta_learning_pacoh_torch.utils``. The JAX package's ``jit_cache`` test
has no counterpart (the port has no jit cache). Besides: the port's TPE
suggestion stream equals the JAX package's for a seed, suggestion for
suggestion; the hyper-parallel MAP fit equals the JAX package's from the
same initial states; ``profiling.trace`` writes a Chrome trace.
"""

import json
import os

import numpy as np
import pytest

from meta_learning_pacoh_tpu import GPRegressionMetaLearned as JaxMAP
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_tpu.utils import tuning as jax_tuning
from meta_learning_pacoh_tpu.utils.tuning_parallel import (
    fit_map_hyper_parallel as jax_fit_map_hyper_parallel,
)
from meta_learning_pacoh_torch import (
    GPRegressionMetaLearned,
    GPRegressionMetaLearnedSVGD,
    GPRegressionMetaLearnedVI,
)
from meta_learning_pacoh_torch.datasets import SinusoidDataset
from meta_learning_pacoh_torch.interop import params_from_jax
from meta_learning_pacoh_torch.models.random_gp import layout_slice
from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.utils.experiment import (
    LoopExecutor,
    collect_exp_results,
    generate_launch_commands,
    hash_dict,
    save_results,
    setup_exp_doc,
)
from meta_learning_pacoh_torch.utils.profiling import StepTimer, trace
from meta_learning_pacoh_torch.utils.tuning import (
    Choice,
    LogUniform,
    RandomSuggest,
    Randint,
    TPESuggest,
    Uniform,
    sample_config,
    select_best_configs,
    tune_run,
)
from meta_learning_pacoh_torch.utils.tuning_parallel import (
    fit_hyper_parallel,
    fit_map_hyper_parallel,
    fit_svgd_hyper_parallel,
    fit_vi_hyper_parallel,
    run_map_trial_batch,
    run_trial_batch,
)

HIDDEN = (8, 8)
HYPERS = [(1e-3, 0.2), (3e-3, 0.01), (5e-4, 0.5)]


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in ("PACOH_TPU_FORCE_PALLAS", "PACOH_TORCH_DISABLE_FUSED",
                 "PACOH_TORCH_DISABLE_KERNELS"):
        monkeypatch.delenv(name, raising=False)
    jit_cache.clear()
    yield
    jit_cache.clear()


def _tasks(n_tasks=4, n_samples=5, seed=26):
    env = SinusoidDataset(random_state=np.random.RandomState(seed))
    return env.generate_meta_train_data(n_tasks=n_tasks, n_samples=n_samples)


def _build(mt, lr, wd, seed=30, n_iter=30, feature_dim=2, task_batch_size=-1):
    return GPRegressionMetaLearned(
        mt, num_iter_fit=n_iter, random_seed=seed, lr_params=lr, weight_decay=wd,
        feature_dim=feature_dim, task_batch_size=task_batch_size,
        mean_nn_layers=HIDDEN, kernel_nn_layers=HIDDEN, device="cpu")


def _build_svgd(mt, lr, pf, bw, seed=30, n_iter=20):
    return GPRegressionMetaLearnedSVGD(
        mt, num_iter_fit=n_iter, random_seed=seed, lr=lr, prior_factor=pf, bandwidth=bw,
        num_particles=3, task_batch_size=-1, mean_nn_layers=HIDDEN, kernel_nn_layers=HIDDEN,
        device="cpu")


def _build_vi(mt, lr, pf, seed=30, n_iter=20):
    return GPRegressionMetaLearnedVI(
        mt, num_iter_fit=n_iter, random_seed=seed, lr=lr, prior_factor=pf, svi_batch_size=2,
        task_batch_size=-1, mean_nn_layers=HIDDEN, kernel_nn_layers=HIDDEN, device="cpu")


def _keep(model):
    """All but the kernel net's output bias, whose true gradient is exactly 0
    (pairwise feature distances are shift-invariant): Adam random-walks
    float noise there, so two float orders drift apart."""
    keep = np.ones(model.params.numel(), bool)
    keep[layout_slice(model.layout, ("kernel_nn", "b_out"))] = False
    return keep


def _general_fits(builds, n_iter, monkeypatch):
    """Each trial's own meta_fit through the general step."""
    monkeypatch.setenv("PACOH_TORCH_DISABLE_FUSED", "1")
    models = [b() for b in builds]
    for m in models:
        m.meta_fit(verbose=False, log_period=n_iter, n_iter=n_iter)
    monkeypatch.delenv("PACOH_TORCH_DISABLE_FUSED")
    return models


def test_torch_map_hyper_parallel_matches_sequential(monkeypatch):
    """Three trials of other lr and weight decay, one stacked fit, against
    each trial's general-step fit: every parameter and AdamW moment."""
    mt = _tasks()
    seq = _general_fits([lambda h=h: _build(mt, *h) for h in HYPERS], 30, monkeypatch)
    par = [_build(mt, lr, wd) for lr, wd in HYPERS]
    fit_map_hyper_parallel(par, n_iter=30)
    for m_s, m_p in zip(seq, par):
        assert m_p.fitted and m_p._step_count == 30 and m_p._adam_count == 30
        for got, want in ((m_p.params, m_s.params), (m_p._mu, m_s._mu), (m_p._nu, m_s._nu)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=1e-5)


def test_torch_map_hyper_parallel_matches_jax():
    """The port's stacked trials from the JAX learners' initial states
    against the JAX package's fit_map_hyper_parallel (optax's
    inject_hyperparams), 30 steps, at the JAX test's limit (atol 2e-3,
    the kernel net's output bias left out)."""
    mt = _tasks()
    kw = dict(num_iter_fit=30, random_seed=30, feature_dim=2, task_batch_size=-1,
              mean_nn_layers=HIDDEN, kernel_nn_layers=HIDDEN)
    jax_models = [JaxMAP(mt, lr_params=lr, weight_decay=wd, **kw) for lr, wd in HYPERS]
    ports = []
    for (lr, wd), jm in zip(HYPERS, jax_models):
        port = GPRegressionMetaLearned(mt, lr_params=lr, weight_decay=wd, device="cpu", **kw)
        port.load_state_dict(jm.state_dict())
        ports.append(port)
    jax_fit_map_hyper_parallel(jax_models, n_iter=30)
    fit_map_hyper_parallel(ports, n_iter=30)
    keep = _keep(ports[0])
    for jm, port in zip(jax_models, ports):
        np.testing.assert_allclose(port.params.numpy()[keep], params_from_jax(jm.params)[keep],
                                   rtol=0, atol=2e-3)


def test_torch_hyper_parallel_single_step_exact(monkeypatch):
    """One stacked step with per-trial lr and weight decay gives each
    trial's own general step's bits."""
    mt = _tasks()
    seq = _general_fits([lambda h=h: _build(mt, *h) for h in HYPERS], 1, monkeypatch)
    par = [_build(mt, lr, wd) for lr, wd in HYPERS]
    fit_map_hyper_parallel(par, n_iter=1)
    for m_s, m_p in zip(seq, par):
        np.testing.assert_array_equal(m_p.params.numpy(), m_s.params.numpy())


def test_torch_trial_state_supports_continued_training():
    """The AdamW moments written back let meta_fit continue (here on the
    fused path's plain version) as after a sequential fit."""
    mt = _tasks()
    m_seq = _build(mt, 2e-3, 0.1)
    m_seq.meta_fit(verbose=False, log_period=20, n_iter=20)
    m_seq.meta_fit(verbose=False, log_period=20, n_iter=20)
    m_par = _build(mt, 2e-3, 0.1)
    fit_map_hyper_parallel([m_par, _build(mt, 1e-3, 0.3)], n_iter=20)
    assert m_par._fused is None and m_par._fused_path_ok()
    m_par.meta_fit(verbose=False, log_period=20, n_iter=20)
    assert m_par._step_count == m_par._adam_count == 40
    keep = _keep(m_par)
    np.testing.assert_allclose(m_par.params.numpy()[keep], m_seq.params.numpy()[keep],
                               rtol=0, atol=2e-3)
    m_copy = _build(mt, 2e-3, 0.1)
    m_copy.load_state_dict(m_par.state_dict())
    np.testing.assert_array_equal(m_copy._mu.numpy(), m_par._mu.numpy())


def test_torch_hyper_parallel_rejects_mixed_static_configs():
    mt = _tasks()
    with pytest.raises(ValueError, match="cfg"):
        fit_map_hyper_parallel([_build(mt, 1e-3, 0.1, feature_dim=2),
                                _build(mt, 1e-3, 0.1, feature_dim=4)], n_iter=5)
    moved = _build(mt, 1e-3, 0.1)
    moved.meta_fit(verbose=False, log_period=1, n_iter=1)
    with pytest.raises(ValueError, match="same training step"):
        fit_map_hyper_parallel([_build(mt, 1e-3, 0.1), moved], n_iter=5)


def test_torch_svgd_hyper_parallel_matches_sequential(monkeypatch):
    """SVGD trials of other lr, prior_factor and numeric bandwidth (the
    plain transport, one bandwidth a trial)."""
    mt = _tasks()
    hypers = [(1e-3, 0.01, 2.0), (3e-3, 0.05, 0.5)]
    seq = _general_fits([lambda h=h: _build_svgd(mt, *h) for h in hypers], 20, monkeypatch)
    par = [_build_svgd(mt, *h) for h in hypers]
    fit_hyper_parallel(par, n_iter=20)  # dispatches on the learner's class
    for m_s, m_p in zip(seq, par):
        assert m_p.fitted and m_p._step_count == 20
        np.testing.assert_allclose(m_p.particles.numpy(), m_s.particles.numpy(),
                                   rtol=2e-4, atol=5e-5)


def test_torch_svgd_hyper_parallel_median_bandwidth(monkeypatch):
    """All-None bandwidths share the median-heuristic Stein transport (on
    the card one K1 launch of [trials, K, P] a step: one launch counted a
    step, none here on the CPU); a mixed batch is refused (tune_run then
    falls back to sequential trials)."""
    mt = _tasks()
    seq = _general_fits([lambda: _build_svgd(mt, 1e-3, 0.01, None, n_iter=10)], 10,
                        monkeypatch)[0]
    par = [_build_svgd(mt, 1e-3, 0.01, None, n_iter=10),
           _build_svgd(mt, 2e-3, 0.02, None, n_iter=10)]
    cuda.reset_launch_counts()
    fit_svgd_hyper_parallel(par, n_iter=10)
    assert cuda.LAUNCHES["svgd_phi"] == 0
    np.testing.assert_allclose(par[0].particles.numpy(), seq.particles.numpy(),
                               rtol=2e-4, atol=1e-5)
    with pytest.raises(AssertionError):
        fit_svgd_hyper_parallel([_build_svgd(mt, 1e-3, 0.01, None),
                                 _build_svgd(mt, 1e-3, 0.01, 1.0)], n_iter=2)


def test_torch_vi_hyper_parallel_matches_sequential(monkeypatch):
    mt = _tasks()
    hypers = [(1e-3, 0.01), (3e-3, 0.05)]
    seq = _general_fits([lambda h=h: _build_vi(mt, *h) for h in hypers], 20, monkeypatch)
    par = [_build_vi(mt, *h) for h in hypers]
    fit_vi_hyper_parallel(par, n_iter=20)
    for m_s, m_p in zip(seq, par):
        assert m_p.fitted and m_p._step_count == 20
        for key in m_s.posterior:
            np.testing.assert_allclose(m_p.posterior[key].numpy(), m_s.posterior[key].numpy(),
                                       rtol=2e-4, atol=1e-5)


def test_torch_fit_hyper_parallel_rejects_unsupported_learner():
    class Dummy:
        pass

    with pytest.raises(NotImplementedError):
        fit_hyper_parallel([Dummy()])


SPACE = {"x": Uniform(0.0, 1.0), "y": LogUniform(1e-3, 1.0)}


def _drive_manually(num_samples, batch_size, seed=3):
    """The reference suggestion stream: suggest K back-to-back, run, tell K
    (constructed exactly as tune_run constructs its suggester)."""
    sugg = TPESuggest(SPACE, metric="score", mode="max", seed=seed)
    seen = []
    while len(seen) < num_samples:
        k = min(batch_size, num_samples - len(seen))
        batch = [sugg.suggest() for _ in range(k)]
        for c in batch:
            sugg.tell(c, c["x"])
        seen.extend(batch)
    return seen


def test_torch_batched_tpe_stream_matches_manual_batch_driving(tmp_path):
    # 24 > the default n_startup=20, so the last batch takes the Parzen path
    num, k = 24, 4
    analysis = tune_run(
        lambda cfg: {"score": cfg["x"]}, SPACE, num_samples=num, metric="score", mode="max",
        seed=3, local_dir=str(tmp_path), verbose=False, batch_size=k,
        batch_trial_fn=lambda cfgs: [{"score": c["x"]} for c in cfgs])
    assert [t["config"] for t in analysis.trials] == _drive_manually(num, k)
    assert all(t["status"] == "DONE" for t in analysis.trials)


@pytest.mark.parametrize("seed", [0, 3])
def test_torch_tpe_stream_equals_jax(seed):
    """The port's suggesters (a numpy copy) give the JAX package's stream for
    a seed, suggestion for suggestion, through the random start-up and the
    Parzen phase, continuous and categorical dimensions alike."""
    space = {"x": Uniform(-2.0, 3.0), "y": LogUniform(1e-4, 1.0),
             "c": Choice(["a", "b", "c"]), "n": Randint(1, 5)}
    jax_space = {"x": jax_tuning.Uniform(-2.0, 3.0), "y": jax_tuning.LogUniform(1e-4, 1.0),
                 "c": jax_tuning.Choice(["a", "b", "c"]), "n": jax_tuning.Randint(1, 5)}
    port = TPESuggest(space, metric="v", n_startup=8, seed=seed)
    ref = jax_tuning.TPESuggest(jax_space, metric="v", n_startup=8, seed=seed)
    for _ in range(30):
        got, want = port.suggest(), ref.suggest()
        assert got == want
        value = -(got["x"] - 1.0) ** 2 + (got["c"] == "b")
        port.tell(got, value)
        ref.tell(want, value)
    got = RandomSuggest(space, seed=seed)
    want = jax_tuning.RandomSuggest(jax_space, seed=seed)
    assert [got.suggest() for _ in range(5)] == [want.suggest() for _ in range(5)]
    assert (sample_config(space, np.random.RandomState(seed))
            == jax_tuning.sample_config(jax_space, np.random.RandomState(seed)))


def test_torch_batch_failure_falls_back_to_sequential(tmp_path):
    calls = {"batch": 0, "seq": 0}

    def bad_batch(cfgs):
        calls["batch"] += 1
        raise RuntimeError("device exploded")

    def trial(cfg):
        calls["seq"] += 1
        return {"score": cfg["x"]}

    analysis = tune_run(trial, SPACE, num_samples=4, metric="score", seed=0,
                        local_dir=str(tmp_path), verbose=False, batch_size=2,
                        batch_trial_fn=bad_batch)
    assert calls["batch"] == 2 and calls["seq"] == 4
    assert len([t for t in analysis.trials if t["status"] == "DONE"]) == 4


def test_torch_run_trial_batch_groups_and_orders():
    mt = _tasks()
    configs = [
        {"lr": 1e-3, "weight_decay": 0.1, "feature_dim": 2, "task_batch_size": -1},
        {"lr": 2e-3, "weight_decay": 0.2, "feature_dim": 4, "task_batch_size": -1},  # alone
        {"lr": 3e-3, "weight_decay": 0.3, "feature_dim": 2, "task_batch_size": -1},
    ]

    def build(c):
        return _build(mt, c["lr"], c["weight_decay"], n_iter=10,
                      feature_dim=int(c["feature_dim"]))

    def evaluate(m):
        return {"lr_seen": float(m.lr_params), "steps": m._step_count}

    out = run_map_trial_batch(configs, build, evaluate, n_iter=10)
    assert run_map_trial_batch is run_trial_batch
    assert [r["lr_seen"] for r in out] == [1e-3, 2e-3, 3e-3]
    assert all(r["steps"] == 10 for r in out)


class TestTorchExperimentUtils:
    def test_torch_hash_dict_stable_and_order_invariant(self):
        a = hash_dict({"x": 1, "y": "foo"})
        assert a == hash_dict({"y": "foo", "x": 1}) and len(a) == 32

    def test_torch_setup_save_collect_roundtrip(self, tmp_path):
        run_dir = setup_exp_doc("exp1", {"lr": 0.001, "seed": 1}, str(tmp_path))
        save_results({"test_ll": -0.5, "rmse": np.float32(0.3)}, run_dir, log=False)
        run_dir2 = setup_exp_doc("exp1", {"lr": 0.01, "seed": 2}, str(tmp_path))
        save_results({"test_ll": -0.7, "rmse": 0.4}, run_dir2, log=False)
        df = collect_exp_results("exp1", str(tmp_path), verbose=False)
        assert len(df) == 2 and set(df["test_ll"]) == {-0.5, -0.7}

    def test_torch_generate_launch_commands(self):
        cmds = generate_launch_commands("exp.py", {"lr": [0.1, 0.01], "seed": [1, 2, 3]})
        assert len(cmds) == 6 and all("--lr" in c and "--seed" in c for c in cmds)

    def test_torch_loop_executor(self):
        acc = []
        LoopExecutor().run(lambda a, b: acc.append(a + b), [1, 2], [10, 20])
        assert acc == [11, 22]


class TestTorchSearch:
    def test_torch_uniform_unit_roundtrip(self):
        d = Uniform(2.0, 10.0)
        assert abs(d.from_unit(d.to_unit(7.3)) - 7.3) < 1e-9

    def test_torch_loguniform_samples_in_range(self):
        d = LogUniform(1e-4, 1e-1)
        rs = np.random.RandomState(0)
        samples = [d.sample(rs) for _ in range(200)]
        assert min(samples) >= 1e-4 and max(samples) <= 1e-1
        assert 5e-4 < np.exp(np.mean(np.log(samples))) < 2e-2

    def test_torch_tpe_beats_random_on_quadratic(self):
        space = {"x": Uniform(-10.0, 10.0)}

        def run(suggester, n=60):
            best = -np.inf
            for _ in range(n):
                c = suggester.suggest()
                val = -((c["x"] - 3.0) ** 2)
                suggester.tell(c, val)
                best = max(best, val)
            return best

        tpe_best = run(TPESuggest(space, metric="v", n_startup=15, seed=0))
        assert tpe_best >= run(RandomSuggest(space, seed=0)) - 1e-6 and tpe_best > -0.5

    def test_torch_choice_dimension(self):
        sugg = TPESuggest({"opt": Choice(["a", "b", "c"])}, metric="v", n_startup=5, seed=1)
        for _ in range(30):
            c = sugg.suggest()
            sugg.tell(c, 1.0 if c["opt"] == "b" else 0.0)
        assert [sugg.suggest()["opt"] for _ in range(50)].count("b") > 25


class TestTorchTuneRun:
    def test_torch_runs_and_selects_best(self, tmp_path):
        analysis = tune_run(lambda cfg: {"score": -abs(cfg["x"] - 0.7)},
                            {"x": Uniform(0.0, 1.0)}, num_samples=15, metric="score",
                            mode="max", local_dir=str(tmp_path), name="t1", verbose=False)
        best = select_best_configs(analysis, metric="score", N=3)
        assert len(best) == 3 and abs(best[0]["x"] - 0.7) < 0.25
        assert len(analysis.dataframe()) == 15

    def test_torch_checkpoint_resume(self, tmp_path):
        space = {"x": Uniform(0.0, 1.0)}
        tune_run(lambda cfg: {"score": cfg["x"]}, space, num_samples=5, metric="score",
                 local_dir=str(tmp_path), name="t2", verbose=False)
        with open(os.path.join(tmp_path, "experiment_state-t2.json")) as f:
            state = json.load(f)
        assert len([t for t in state["trials"] if t["status"] == "DONE"]) == 5
        analysis = tune_run(lambda cfg: {"score": cfg["x"]}, space, num_samples=8,
                            metric="score", local_dir=str(tmp_path), name="t2", resume=True,
                            verbose=False)
        assert len([t for t in analysis.trials if t["status"] == "DONE"]) == 8

    def test_torch_resume_modes_local_remote_prompt(self, tmp_path, monkeypatch):
        """resume in {LOCAL, REMOTE, PROMPT}; an interrupted RUNNING trial is
        marked ERROR on resume."""
        import shutil

        space = {"x": Uniform(0.0, 1.0)}
        local, remote = tmp_path / "local", tmp_path / "remote"
        remote.mkdir()

        def run(n, where, **kw):
            return tune_run(lambda cfg: {"score": cfg["x"]}, space, num_samples=n,
                            metric="score", local_dir=str(where), name="t5", verbose=False,
                            **kw)

        run(4, local)
        state_file = os.path.join(local, "experiment_state-t5.json")
        with open(state_file) as f:
            state = json.load(f)
        state["trials"].append({"config": {"x": 0.5}, "status": "RUNNING",
                                "last_result": None, "history": []})
        with open(state_file, "w") as f:
            json.dump(state, f)
        analysis = run(6, local, resume="LOCAL")
        statuses = [t["status"] for t in analysis.trials]
        assert statuses.count("DONE") == 6 and "RUNNING" not in statuses
        assert len([t for t in analysis.trials if t.get("error") == "interrupted"]) == 1

        shutil.copy2(state_file, remote / "experiment_state-t5.json")
        local2 = tmp_path / "local2"
        analysis2 = run(7, local2, resume="REMOTE", remote_dir=str(remote))
        assert len([t for t in analysis2.trials if t["status"] == "DONE"]) == 7
        with pytest.raises(ValueError):
            run(1, local2, resume="REMOTE")  # no remote_dir

        monkeypatch.setattr("builtins.input", lambda _: "n")
        assert len(run(1, local, resume="PROMPT").trials) == 1
        monkeypatch.setattr("builtins.input", lambda _: "y")
        analysis4 = run(6, local, resume="PROMPT")
        assert len([t for t in analysis4.trials if t["status"] == "DONE"]) == 6

    def test_torch_failure_handling(self, tmp_path):
        calls = {"n": 0}

        def flaky(cfg):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("boom")
            return {"score": 1.0}

        analysis = tune_run(flaky, {"x": Uniform(0, 1)}, num_samples=2, metric="score",
                            local_dir=str(tmp_path), name="t3", max_failures=3, verbose=False)
        statuses = [t["status"] for t in analysis.trials]
        assert statuses.count("ERROR") == 2 and statuses.count("DONE") == 2

    def test_torch_generator_trials_record_history(self, tmp_path):
        def trial(cfg):
            for i in range(3):
                yield {"score": float(i)}

        analysis = tune_run(trial, {"x": Uniform(0, 1)}, num_samples=2, metric="score",
                            local_dir=str(tmp_path), name="t4", verbose=False)
        t = analysis.trials[0]
        assert len(t["history"]) == 3 and t["last_result"]["score"] == 2.0


class TestTorchProfiling:
    def test_torch_step_timer(self):
        import time as _t

        timer = StepTimer()
        for _ in range(3):
            with timer.measure(100):
                _t.sleep(0.01)
        assert timer.steps_per_sec > 0 and timer.summary()["n_measurements"] == 3

    def test_torch_trace_writes_a_chrome_trace(self, tmp_path):
        import torch

        with trace(str(tmp_path)) as prof:
            torch.ones(8) @ torch.ones(8)
        with open(tmp_path / "trace.json") as f:
            assert "traceEvents" in json.load(f)
        assert len(prof.key_averages()) > 0
