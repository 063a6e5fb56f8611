"""The port's baseline comparison (with its n-tasks variant and summary) and
meta-overfitting sweep against the originals (experiments/baselines/,
experiments/meta_overfitting/run_overfitting_sweep.py), on the CPU.

With stub learners and a counting clock (tests/test_torch_experiments_cli.py)
each port CLI makes the original's calls (learner keywords, meta_fit and
eval_datasets arguments and data, the stacked fits) and writes the
original's CSV byte for byte, also when a cell raises (a NaN row, counted
in the port's Outcome) and when the seed-parallel fit raises (a counted
fallback to sequential runs, with the rows of the sequential run). The
summary's statistics are those the original prints. Wiring: for the
comparison's five algorithms and the sweep's three, the port's learner and
the JAX learner of the original's keywords keep the same hyperparameters
and evaluate the same from the same state. End to end: each CLI with real
learners at 5 steps.
"""

import math

import numpy as np
import pytest

from meta_learning_pacoh_torch.datasets import provide_data
from meta_learning_pacoh_torch.experiments._cli import read_csv, write_csv
from test_torch_experiments_cli import (
    assert_wiring,
    init_record,
    jax_twin,
    one_torch_thread,  # noqa: F401  (autouse)
    port_module,
    port_stubs,
    reference,
)

BC = "baselines.baseline_comparison"
BCN = "baselines.baseline_comparison_n_tasks"
SWEEP = "meta_overfitting.run_overfitting_sweep"
RUNS = {
    "comparison": (BC, ["--datasets", "sin_20,sin_5", "--seeds", "22,23", "--n_iter_fit", "7",
                        "--n_test_tasks", "4"], []),
    "comparison_failing": (BC, ["--datasets", "sin_20", "--seeds", "22", "--algos",
                                "pacoh_map,pacoh_svgd,maml"], ["GPRegressionMetaLearnedSVGD"]),
    "n_tasks": (BCN, ["--base_datasets", "sin", "--n_tasks_grid", "5,10", "--algos",
                      "pacoh_map,maml", "--seeds", "22", "--n_iter_fit", "7"], []),
    "sweep": (SWEEP, ["--n_tasks_grid", "4,8", "--weight_decay_grid", "0.0,0.5", "--seeds",
                      "22,23", "--n_iter_fit", "7", "--n_test_tasks", "3"], []),
    "sweep_parallel": (SWEEP, ["--n_tasks_grid", "4,8", "--weight_decay_grid", "0.5",
                               "--seeds", "22,23,24", "--seed_parallel", "--n_test_tasks", "3"],
                       []),
    "sweep_fallback": (SWEEP, ["--n_tasks_grid", "4", "--weight_decay_grid", "0.1,0.5",
                               "--seeds", "22,23", "--seed_parallel", "--n_test_tasks", "3"],
                       ["fit_models_parallel"]),
    "sweep_maml_failing": (SWEEP, ["--algo", "maml", "--n_tasks_grid", "4", "--weight_decay_grid",
                                   "0.0", "--seeds", "22,23"], ["MAMLRegression"]),
    "sweep_np": (SWEEP, ["--algo", "np", "--n_tasks_grid", "4", "--weight_decay_grid", "0.2",
                         "--seeds", "22", "--seed_parallel"], []),
}
# cells that fail and groups that fall back in each run
EXPECT = {"comparison_failing": (1, 0), "sweep_fallback": (0, 2), "sweep_maml_failing": (2, 0)}


@pytest.fixture(scope="module")
def originals(tmp_path_factory):
    base = tmp_path_factory.mktemp("orig")
    jobs = []
    for key, (module, argv, fail) in RUNS.items():
        (base / key).mkdir()
        jobs.append({"module": module, "kind": "main", "cwd": str(base / key), "fail": fail,
                     "argv": argv + ["--output_csv", str(base / key / "out.csv")]})
    calls = [{"module": m, "kind": "call", "cwd": str(base), "argv": None,
              "func": "run_cell", "args": [algo, "sin_20", 3, 11, 3]}
             for m, algo in ((BC, a) for a in ALGOS)]
    calls += [{"module": SWEEP, "kind": "call", "cwd": str(base), "argv": None,
               "func": "build_one", "args": [algo, "sin", 4, 0.3, 22, 11, 3]}
              for algo in SWEEP_ALGOS]
    out = reference(jobs + calls)
    return base, dict(zip(RUNS, out[:len(jobs)])), out[len(jobs):]


ALGOS = ("pacoh_map", "pacoh_svgd", "pacoh_vi", "maml", "np")
SWEEP_ALGOS = ("pacoh_map", "maml", "np")


@pytest.mark.parametrize("key", sorted(RUNS))
def test_runs_match_the_original(originals, monkeypatch, tmp_path, key):
    """The same calls, the same CSV bytes (stub learners, counting clock),
    and the failed cells and fallbacks counted."""
    base, runs, _ = originals
    module, argv, fail = RUNS[key]
    calls = port_stubs(monkeypatch, port_module(module), fail=fail)
    out = port_module(module).main(argv + ["--output_csv", str(tmp_path / "out.csv")],
                                   device="cpu")
    assert calls == runs[key]["calls"]
    assert (tmp_path / "out.csv").read_bytes() == (base / key / "out.csv").read_bytes()
    assert (out.failed, out.fell_back) == EXPECT.get(key, (0, 0))
    assert len(out.rows) == len(read_csv(tmp_path / "out.csv"))
    if key == "sweep_fallback":
        stdout = runs[key]["stdout"]
        assert stdout.count("seed-parallel FAILED") == 2


def test_fallback_rows_equal_the_sequential_run(monkeypatch, tmp_path):
    """A seed-parallel fit that raises falls back to sequential runs whose
    metric rows are the sequential sweep's."""
    module, argv, _ = RUNS["sweep_fallback"]
    sweep = port_module(module)
    port_stubs(monkeypatch, sweep, fail=["fit_models_parallel"])
    fallen = sweep.main(argv + ["--output_csv", str(tmp_path / "a.csv")], device="cpu")
    port_stubs(monkeypatch, sweep)
    sequential = sweep.main([a for a in argv if a != "--seed_parallel"]
                            + ["--output_csv", str(tmp_path / "b.csv")], device="cpu")
    assert fallen.fell_back == 2 and sequential.fell_back == 0
    strip = [{k: v for k, v in r.items() if k != "duration"} for r in fallen.rows]
    assert strip == [{k: v for k, v in r.items() if k != "duration"} for r in sequential.rows]


def test_summary_is_the_originals(tmp_path):
    """summarize_baselines on a comparison CSV gives the statistics the
    original prints (its pandas table, to the 6 digits it shows)."""
    rs = np.random.RandomState(3)
    rows = [{"algo": a, "dataset": d, "seed": s,
             "test_ll": np.nan if a == "maml" else float(rs.randn()),
             "test_rmse": float(rs.rand()), "calib_err": np.nan if a == "maml" else rs.rand() / 9,
             "fit_time": float(rs.rand())}
            for d in ("sin_20", "cauchy_20") for a in ALGOS for s in (22, 23, 24)]
    path = tmp_path / "bc.csv"
    write_csv(rows, path)
    (want,) = reference([{"module": "baselines.summarize_baselines", "kind": "call",
                          "cwd": str(tmp_path), "argv": ["--csv", str(path)], "func": "main",
                          "args": [["prog"]]}])
    got = port_module("baselines.summarize_baselines").main(["--csv", str(path)])
    lines = want["stdout"].strip().splitlines()
    assert lines[0].split() == list(got[0][1])
    printed = [line.split()[-7:] for line in lines[2:]]
    assert len(printed) == len(got) == 10
    for (key, vals), cells in zip(got, printed):
        for v, cell in zip(vals.values(), cells):
            assert (math.isnan(v) and cell == "NaN") or float(cell) == pytest.approx(v, rel=1e-5,
                                                                                   abs=1e-6)


@pytest.mark.parametrize("algo", ALGOS)
def test_comparison_learner_matches_the_originals(originals, monkeypatch, algo):
    """run_cell's learner: the original's keywords (weight_decay=0.2 for MAP),
    the same hyperparameters and eval from the same state."""
    _, _, calls = originals
    name, kw, data = init_record(calls[ALGOS.index(algo)]["calls"])
    train, _, test = provide_data("sin_20", seed=3)
    port = port_module(BC).build_cell(algo, train, 3, 11, device="cpu")
    assert_wiring(monkeypatch, jax_twin(name, train, kw), port, test[:3])


@pytest.mark.parametrize("algo", SWEEP_ALGOS)
def test_sweep_learner_matches_the_originals(originals, monkeypatch, algo):
    """build_one's learner, trained on the contexts of the 4-tuples: the same
    data, keywords-built hyperparameters and eval from the same state, on
    the held-out points of the training tasks."""
    _, _, calls = originals
    name, kw, data = init_record(calls[len(ALGOS) + SWEEP_ALGOS.index(algo)]["calls"])
    port, meta_train, test = port_module(SWEEP).build_one(algo, "sin", 4, 0.3, 22, 11, 3,
                                                          device="cpu")
    train = [(cx, cy) for cx, cy, _, _ in meta_train]
    assert len(test) == 3 and len(meta_train) == 4
    assert_wiring(monkeypatch, jax_twin(name, train, kw), port, meta_train[:3])


@pytest.mark.parametrize("key", ["comparison", "n_tasks", "sweep"])
def test_end_to_end(tmp_path, key):
    """Each CLI with real learners at 5 steps: the original's header, finite
    metrics where the original writes them, no failure."""
    module, argv, _ = RUNS[key]
    small = {"comparison": ["--datasets", "sin_20", "--seeds", "22", "--n_test_tasks", "1"],
             "n_tasks": ["--base_datasets", "sin", "--n_tasks_grid", "5", "--algos",
                         "pacoh_map,np", "--seeds", "22", "--n_test_tasks", "2"],
             "sweep": ["--n_tasks_grid", "4", "--weight_decay_grid", "0.1", "--seeds", "22,23",
                       "--n_test_tasks", "2", "--seed_parallel"]}[key]
    out = port_module(module).main(small + ["--n_iter_fit", "5", "--output_csv",
                                            str(tmp_path / "out.csv")], device="cpu")
    header = (tmp_path / "out.csv").read_text().splitlines()[0]
    assert header == ",".join(out.rows[0])
    assert (out.failed, out.fell_back) == (0, 0)
    for row in out.rows:
        for k, v in row.items():
            if isinstance(v, float) and not (row["algo"] == "maml" and (
                    k.startswith("test_ll") or k == "calib_err")):
                assert math.isfinite(v), (row, k)
