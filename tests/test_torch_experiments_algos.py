"""The port's six per-algorithm experiment CLIs against the originals
(experiments/meta_gpr_{mll,svgd,vi}_base_exp.py, meta_mlap_base_exp.py,
maml_base_exp.py, npr_base_exp.py), on the CPU.

Wiring: the original's ``main`` runs in a child process with stub learners
(tests/test_torch_experiments_cli.py) and records the keywords it builds its
learner with; the JAX learner built here with those keywords and the port's
learner built by the port CLI from the same command line keep the same
hyperparameters, and from the JAX learner's state (interop) with its draws
fed in, eval_datasets on three test tasks agrees: LL and RMSE within rtol
1e-4, atol 1e-6, the calibration, a step function of the predictive cdf,
within one point's crossing of a level (1.2e-3; MLAP after a meta-test of
0 steps, its inner Gram being singular to float32 on sin_20). End to end:
each port CLI at 5 steps (nets (8, 8); the test split cut to one task,
MLAP's meta-test to 20 steps) writes config.json and results.json with the
original's keys.
"""

import json
import os

import pytest

from meta_learning_pacoh_torch import GPRegressionMetaLearnedPAC
from meta_learning_pacoh_torch.datasets import provide_data
from test_torch_experiments_cli import (
    ALGO_CLIS,
    assert_wiring,
    init_record,
    jax_twin,
    one_torch_thread,  # noqa: F401  (autouse)
    port_module,
    reference,
)

WIRING_ARGV = ["--nn_layers", "8,8", "--n_iter_fit", "20", "--seed", "3", "--lr", "0.002",
               "--task_batch_size", "4", "--feature_dim", "1"]
EXTRA = {"meta_gpr_mll_base_exp": ["--weight_decay", "0.1"],
         "meta_gpr_svgd_base_exp": ["--num_particles", "3", "--bandwidth", "1.5"],
         "meta_gpr_vi_base_exp": ["--svi_batch_size", "3"],
         "meta_mlap_base_exp": ["--svi_batch_size", "3", "--meta_kl_weight", "1e-3"],
         "maml_base_exp": ["--lr_inner", "0.1"],
         "npr_base_exp": ["--r_dim", "8", "--z_dim", "4", "--h_dim", "8"]}


def argv_of(module, data_dir):
    return WIRING_ARGV + EXTRA[module] + ["--data_dir", data_dir]


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Each original run through main with the stub learners at argv_of."""
    base = tmp_path_factory.mktemp("orig")
    jobs = []
    for m in ALGO_CLIS:
        (base / m).mkdir()
        jobs.append({"module": m, "kind": "main", "cwd": str(base / m),
                     "argv": argv_of(m, str(base / m / "exp"))})
    return base, dict(zip(ALGO_CLIS, reference(jobs)))


@pytest.mark.parametrize("module", ALGO_CLIS)
def test_learner_matches_the_originals(recorded, monkeypatch, tmp_path, module):
    """The port CLI's learner and the JAX learner of the original's keywords:
    the same hyperparameters, and the same eval from the same state."""
    _, runs = recorded
    name, kw, _ = init_record(runs[module]["calls"])
    cli = port_module(module)
    args = cli.parser().parse(argv_of(module, str(tmp_path)))
    train, _, test = provide_data(args.dataset, seed=args.seed)
    port = cli.build_model(args, train, device="cpu")
    assert_wiring(monkeypatch, jax_twin(name, train, kw), port, test[:3])


@pytest.mark.parametrize("module", ALGO_CLIS)
def test_cli_end_to_end(recorded, monkeypatch, tmp_path, module):
    """The port CLI with real learners at 5 steps writes
    <data_dir>/<exp_name>/<hash>/{config,results}.json with the original's
    keys; results.json holds finite numbers, the ones main returns."""
    base, _ = recorded
    meta_base_exp = port_module("meta_base_exp")
    load = meta_base_exp.load_data

    def cut(args):
        train, valid, test = load(args)
        return train, valid, test[:1]

    monkeypatch.setattr(meta_base_exp, "load_data", cut)
    monkeypatch.setattr(port_module("maml_base_exp"), "load_data", cut)
    evaluate = GPRegressionMetaLearnedPAC.eval_datasets
    monkeypatch.setattr(GPRegressionMetaLearnedPAC, "eval_datasets",
                        lambda self, tasks, **kw: evaluate(self, tasks, n_iter_meta_test=20))
    argv = argv_of(module, str(tmp_path / "exp")) + ["--n_iter_fit", "5", "--log_period", "5"]
    results = port_module(module).main(argv, device="cpu")
    (got_dir,) = [d for d, _, files in os.walk(tmp_path / "exp") if files]
    (want_dir,) = [d for d, _, files in os.walk(base / module / "exp") if files]
    assert os.path.relpath(got_dir, tmp_path / "exp").split(os.sep)[0] == \
        os.path.relpath(want_dir, base / module / "exp").split(os.sep)[0]
    for f in ("config.json", "results.json"):
        with open(os.path.join(got_dir, f)) as g, open(os.path.join(want_dir, f)) as w:
            got, want = json.load(g), json.load(w)
        assert list(got) == list(want), f
    with open(os.path.join(got_dir, "results.json")) as g:
        written = json.load(g)
    assert written == results and all(v == v and abs(v) < float("inf") for v in written.values())
