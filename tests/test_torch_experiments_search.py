"""The port's hyperparameter search and its launcher against the originals
(experiments/hyperparam_search/), on the CPU.

The search space and ``BATCH_STATIC_KEYS`` equal the original's. With stub
learners (tests/test_torch_experiments_cli.py), whose metrics follow from
their keywords, both searches propose the same configs in the same order
(past TPE's 20 random start-up trials), sequentially, in trial batches
(the stacked fits of ``run_trial_batch``), with the re-evaluation seeds
fitted together, and resumed from their experiment state; each writes the
same best-configs CSV bytes. A batch whose stacked fit raises falls back to
sequential trials, counted; a trial that raises is counted as failed.
Wiring: the four algorithms' learners against the JAX learners of the
original's ``build_model`` keywords. End to end: a search with real
learners at 5 steps. The launcher's commands run the port's search with the
original's flags.
"""

import json
import shlex

import pytest

from meta_learning_pacoh_torch.datasets import provide_data
from test_torch_experiments_cli import (
    _stub,
    assert_wiring,
    init_record,
    jax_twin,
    one_torch_thread,  # noqa: F401  (autouse)
    port_module,
    port_stubs,
    reference,
)

SEARCH = "hyperparam_search.meta_hyperparam_search"
LAUNCH = "hyperparam_search.launch_hyperparam_sweeps"
ALGOS = ("pacoh_map", "pacoh_svgd", "pacoh_vi", "pacoh_mlap")
COMMON = ["--n_iter_fit", "7", "--n_eval_tasks", "3", "--top_n", "2", "--n_test_seeds", "2"]
RUNS = {
    "map_sequential": ["--algo", "pacoh_map", "--num_samples", "24"],
    "map_batched": ["--algo", "pacoh_map", "--num_samples", "24", "--trial_batch_size", "3",
                    "--seed_parallel"],
    "svgd_batched": ["--algo", "pacoh_svgd", "--num_samples", "6", "--trial_batch_size", "2"],
    "vi_batched_fallback": ["--algo", "pacoh_vi", "--num_samples", "4", "--trial_batch_size",
                            "2"],
    "mlap": ["--algo", "pacoh_mlap", "--num_samples", "3", "--trial_batch_size", "2",
             "--seed_parallel"],
    "resume_first": ["--algo", "pacoh_svgd", "--num_samples", "3"],
    "resume_second": ["--algo", "pacoh_svgd", "--num_samples", "5", "--resume"],
}
FAILS = {"vi_batched_fallback": ["fit_hyper_parallel"]}
CONFIGS = {
    "pacoh_map": {"lr": 2e-3, "weight_decay": 0.05, "feature_dim": 4, "task_batch_size": 10},
    "pacoh_svgd": {"lr": 2e-3, "prior_factor": 0.01, "bandwidth": 2.5, "num_particles": 5},
    "pacoh_vi": {"lr": 2e-3, "prior_factor": 0.01, "svi_batch_size": 5},
    "pacoh_mlap": {"task_kl_weight": 0.3, "meta_kl_weight": 1e-3, "lr": 5e-4, "lr_decay": 0.95,
                   "posterior_lr_multiplier": 2.0, "svi_batch_size": 5, "task_batch_size": 5},
}


def local_dir(root, key):
    return str(root / ("resume" if key.startswith("resume") else key))


@pytest.fixture(scope="module")
def originals(tmp_path_factory):
    base = tmp_path_factory.mktemp("orig")
    jobs = [{"module": SEARCH, "kind": "main", "cwd": str(base), "fail": FAILS.get(key, []),
             "argv": argv + COMMON + ["--local_dir", local_dir(base, key)]}
            for key, argv in RUNS.items()]
    jobs += [{"module": SEARCH, "kind": "call", "cwd": str(base), "argv": None,
              "func": "search_space", "args": [algo]} for algo in ALGOS]
    jobs += [{"module": SEARCH, "kind": "call", "cwd": str(base), "argv": None,
              "func": "BATCH_STATIC_KEYS", "args": []}]
    jobs += [{"module": SEARCH, "kind": "call", "cwd": str(base), "argv": None,
              "func": "build_model", "args": [algo, CONFIGS[algo], "sin_20", 3, 11]}
             for algo in ALGOS]
    jobs += [{"module": LAUNCH, "kind": "main", "cwd": str(base),
              "argv": ["--datasets", "sin_20,cauchy_20,sin_5", "--algos", "pacoh_map,pacoh_vi"]}]
    out = reference(jobs)
    n = len(RUNS)
    return {"base": base, "runs": dict(zip(RUNS, out[:n])),
            "spaces": dict(zip(ALGOS, out[n:n + 4])), "static": out[n + 4],
            "builds": dict(zip(ALGOS, out[n + 5:n + 9])), "launch": out[n + 9]}


@pytest.mark.parametrize("algo", ALGOS)
def test_search_space_is_the_originals(originals, algo):
    search = port_module(SEARCH)
    assert _stub["plain"](search.search_space(algo)) == originals["spaces"][algo]["return"]
    static = {k: list(v) for k, v in search.BATCH_STATIC_KEYS.items()}
    assert static == originals["static"]["return"]


@pytest.mark.parametrize("key", list(RUNS))
def test_search_proposes_and_writes_as_the_original(originals, monkeypatch, tmp_path, key):
    """The same learners (so the same configs, in order), the same stacked
    fits, the same best-configs CSV bytes; fallbacks counted."""
    if key == "resume_second":
        port_stubs(monkeypatch, port_module(SEARCH))
        port_module(SEARCH).main(RUNS["resume_first"] + COMMON
                                 + ["--local_dir", local_dir(tmp_path, key)], device="cpu")
    calls = port_stubs(monkeypatch, port_module(SEARCH), fail=FAILS.get(key, []))
    out = port_module(SEARCH).main(RUNS[key] + COMMON + ["--local_dir", local_dir(tmp_path, key)],
                                   device="cpu")
    want = originals["runs"][key]
    assert calls == want["calls"]
    algo = RUNS[key][1]
    name = f"best_configs_{algo}_sin_20.csv"
    got = (tmp_path / local_dir(tmp_path, key).split("/")[-1] / name).read_bytes()
    if key != "resume_first":  # the original's file is the resumed run's by now
        assert got == (originals["base"] / local_dir(originals["base"], key).split("/")[-1]
                       / name).read_bytes()
    assert len(out.rows) == 4 and out.failed == 0
    batches = sum(1 for c in calls if c[0] == "fit_hyper_parallel")
    assert out.fell_back == (batches if key in FAILS else 0)
    if key == "vi_batched_fallback":  # a batch of two svi_batch_size stacks nothing
        assert batches >= 1 and want["stdout"].count("falling back to sequential") == batches


def test_a_failing_trial_is_counted(monkeypatch, tmp_path):
    """A trial that raises is recorded by tune_run as failed (and replaced by
    a new suggestion), and the search's Outcome counts it."""
    search = port_module(SEARCH)
    port_stubs(monkeypatch, search)
    real, seen = search.build_and_eval, []

    def first_fails(*a, **k):
        seen.append(a)
        if len(seen) == 2:
            raise RuntimeError("trial failure")
        return real(*a, **k)

    monkeypatch.setattr(search, "build_and_eval", first_fails)
    out = search.main(["--algo", "pacoh_vi", "--num_samples", "3"] + COMMON
                      + ["--local_dir", str(tmp_path)], device="cpu")
    assert (out.failed, out.fell_back, len(out.rows)) == (1, 0, 4)


@pytest.mark.parametrize("algo", ALGOS)
def test_search_learner_matches_the_originals(originals, monkeypatch, algo):
    """build_model's learner (PACOH-MAP with lr_params=): the original's
    keywords give the same hyperparameters and eval from the same state."""
    name, kw, _ = init_record(originals["builds"][algo]["calls"])
    train, _, test = provide_data("sin_20", seed=3)
    port, port_test = port_module(SEARCH).build_model(algo, CONFIGS[algo], "sin_20", 3, 11,
                                                      device="cpu")
    assert len(port_test) == len(test)
    assert_wiring(monkeypatch, jax_twin(name, train, kw), port, test[:3])


def test_search_end_to_end(originals, tmp_path):
    """A search with real learners at 5 steps: trials stacked in pairs, the
    re-evaluation seeds fitted together, no trial failed, no batch fallen
    back, the original's CSV header."""
    search = port_module(SEARCH)
    out = search.main(["--algo", "pacoh_map", "--num_samples", "4", "--trial_batch_size", "2",
                       "--seed_parallel", "--n_iter_fit", "5", "--n_eval_tasks", "2", "--top_n",
                       "1", "--n_test_seeds", "2", "--local_dir", str(tmp_path)], device="cpu")
    assert (out.failed, out.fell_back, len(out.rows)) == (0, 0, 2)
    header = (tmp_path / "best_configs_pacoh_map_sin_20.csv").read_text().splitlines()[0]
    want = (originals["base"] / "map_batched" / "best_configs_pacoh_map_sin_20.csv")
    assert header == want.read_text().splitlines()[0]
    state = json.loads((tmp_path / "experiment_state-pacoh_map_sin_20.json").read_text())
    assert [t["status"] for t in state["trials"]] == ["DONE"] * 4


def test_launcher_runs_the_ports_search(originals):
    """The launcher prints one command a (dataset, algo) in the original's
    order and flags, each running the port's search module, whose parser
    takes it."""
    launch, search = port_module(LAUNCH), port_module(SEARCH)
    got = launch.main(["--datasets", "sin_20,cauchy_20,sin_5", "--algos", "pacoh_map,pacoh_vi"])
    want = originals["launch"]["stdout"].splitlines()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        g, w = shlex.split(g), shlex.split(w)
        assert g[1:3] == ["-m", launch.SEARCH_MODULE]
        assert w[1].endswith("experiments/hyperparam_search/meta_hyperparam_search.py")
        assert g[3:] == w[2:]
        args = search.parser().parse(g[3:])
        assert [args.dataset, args.algo] == [g[4], g[6]]
