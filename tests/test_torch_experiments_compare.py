"""The port's computational comparison against the original
(experiments/computational_comparison.py), on the CPU.

With the stub learners and the counting clock of
tests/test_torch_experiments_cli.py, the port's CLI has the original's
flags (names, defaults, absl types), builds each learner with the
original's keywords on the same data, makes the same ``meta_fit`` and
``eval_datasets`` calls in the same order, and prints and writes the same
JSON bytes, at the defaults and at another command line. Its fits and evals
are what they time: with real learners, a cold fit and two warm ones of
each learner, continuing from the state the last one left, follow the JAX
learner's fits of the same keywords from one state, step count and
parameters; and MLAP's eval takes the JAX learner's ``n_iter_meta_test``.
"""

import inspect
import json

import numpy as np
import pytest
import torch

import test_torch_pacoh_map as map_tests
import test_torch_pacoh_mlap as mlap_tests
import test_torch_pacoh_vi as vi_tests
from meta_learning_pacoh_tpu import GPRegressionMetaLearnedPAC as JaxPAC
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import GPRegressionMetaLearnedPAC, GPRegressionMetaLearnedVI
from test_torch_experiments_cli import (
    one_torch_thread,  # noqa: F401  (autouse)
    port_flags,
    port_module,
    port_stubs,
    port_values,
    reference,
    typed,
)

CC = "computational_comparison"
LINES = {"default": [], "other": ["--n_iter=7", "--n_repeats", "2", "--n_test_tasks", "3"]}


@pytest.fixture(scope="module")
def originals(tmp_path_factory):
    """The original run through main with the stub learners at each of LINES,
    ``--output`` into its own directory."""
    base = tmp_path_factory.mktemp("orig")
    jobs = []
    for line, argv in LINES.items():
        (base / line).mkdir()
        jobs.append({"module": CC, "kind": "main", "cwd": str(base / line),
                     "argv": argv + ["--output", str(base / line / "out.json")]})
    return base, dict(zip(LINES, reference(jobs)))


def test_flags_match_the_original(originals):
    """The original's four flags: names, absl types, defaults of the same
    Python types, and the values of another command line."""
    base, runs = originals
    parser = port_module(CC).parser()
    assert typed(port_flags(parser)) == typed(runs["default"]["flags"])
    argv = LINES["other"] + ["--output", str(base / "other" / "out.json")]
    assert typed(port_values(parser, argv)) == typed(runs["other"]["values"])


@pytest.mark.parametrize("line", sorted(LINES))
def test_calls_and_json_match_the_original(originals, tmp_path, monkeypatch, line):
    """Stub learners, a counting clock: the same constructor keywords and
    data, the same meta_fit / eval_datasets calls in order (MLAP's eval with
    n_iter_meta_test=1000), the same printed lines and the same JSON bytes
    in the --output file; main returns what it wrote."""
    base, runs = originals
    want = runs[line]
    calls = port_stubs(monkeypatch, port_module(CC))
    out = tmp_path / "out.json"
    got = port_module(CC).main(LINES[line] + ["--output", str(out)], device="cpu")
    assert json.loads(json.dumps(calls)) == want["calls"]
    names = [c[1] for c in want["calls"] if c[0] == "init"]
    assert names == ["GPRegressionMetaLearned", "GPRegressionMetaLearnedSVGD",
                     "GPRegressionMetaLearnedVI", "GPRegressionMetaLearnedPAC"]
    assert out.read_bytes() == (base / line / "out.json").read_bytes()
    assert json.loads(out.read_text()) == got
    printed = want["stdout"]
    assert printed.endswith(json.dumps(got, indent=2) + "\n")
    assert list(got) == ["PACOH-MAP", "PACOH-SVGD", "PACOH-VI", "PACOH-MLAP"]


def test_stdout_matches_the_original(originals, monkeypatch, capsys):
    """Without --output the port prints the original's lines and writes no file."""
    _, runs = originals
    port_stubs(monkeypatch, port_module(CC))
    port_module(CC).main([], device="cpu")
    assert capsys.readouterr().out == runs["default"]["stdout"]


# ------------------------------------------------------------------ real learners

N_FIT = 3  # steps of each fit; a cold fit and two warm ones, as the CLI's


@pytest.fixture()
def jax_general_step(monkeypatch):
    """The JAX learners' XLA step, the jit cache cleared around the test."""
    for name in ("PACOH_TPU_FORCE_PALLAS", "PACOH_TPU_MAP_WEIGHTED", "PACOH_TPU_VI_WEIGHTED",
                 "PACOH_TPU_DISABLE_FUSED", "PACOH_TORCH_DISABLE_FUSED",
                 "PACOH_TORCH_DISABLE_KERNELS"):
        monkeypatch.delenv(name, raising=False)
    jit_cache.clear()
    yield
    jit_cache.clear()


def _map_pair():
    """PACOH-MAP at the CLI's task batch of 5 (of 6 tasks), the port drawing
    the JAX learner's task indices."""
    train, _ = map_tests._sin()
    jax_model, port = map_tests._pair(train, task_batch_size=5)
    idx = torch.from_numpy(map_tests._jax_draws(jax_model, 3 * N_FIT))
    port._task_draw = lambda step: idx[step]

    def close():
        keep = map_tests._keep(port)
        np.testing.assert_allclose(map_tests._params(port)[keep],
                                   map_tests._params(jax_model)[keep], rtol=0, atol=1e-5)
    return jax_model, port, close


def _svgd_pair():
    train, _ = map_tests._sin()
    jax_model, port = map_tests._svgd_pair(train)

    def close():
        np.testing.assert_allclose(port.particles.numpy(), np.asarray(jax_model.particles),
                                   rtol=0, atol=1e-5)
    return jax_model, port, close


def _vi_pair():
    train, _ = vi_tests._sin()
    jax_model = vi_tests.JaxVI(train, **vi_tests.KW)
    port = GPRegressionMetaLearnedVI(train, device="cpu", **vi_tests.KW)
    port.load_state_dict(jax_model.state_dict())
    vi_tests._feed(port, jax_model, 3 * N_FIT)

    def close():
        keep = vi_tests._keep(port)
        for key in ("loc", "log_scale"):
            np.testing.assert_allclose(vi_tests._post(port, key)[keep],
                                       vi_tests._post(jax_model, key)[keep], rtol=0, atol=1e-5)
    return jax_model, port, close


def _mlap_pair():
    jax_model, port, _ = mlap_tests._pair(task_batch_size=3)
    mlap_tests._feed(port, jax_model, 3 * N_FIT)
    return jax_model, port, lambda: mlap_tests._assert_params_close(port, jax_model, 1e-4, 2e-6)


PAIRS = {"map": _map_pair, "svgd": _svgd_pair, "vi": _vi_pair, "mlap": _mlap_pair}


@pytest.mark.parametrize("learner", sorted(PAIRS))
def test_warm_fits_continue_as_the_jax_learners(jax_general_step, learner):
    """From one state, the port fed the JAX draws: the CLI's cold fit and two
    warm fits (each ``meta_fit(verbose=False, log_period=n, n_iter=n)``)
    keep the JAX learner's step count and parameters after every fit
    (within the tolerances of the learners' own tests), so a warm fit
    continues the optimiser's state as the JAX learner's does."""
    jax_model, port, close = PAIRS[learner]()
    step0 = jax_model.state_dict()["step"]
    for i in range(1, 4):
        for model in (jax_model, port):
            model.meta_fit(verbose=False, log_period=N_FIT, n_iter=N_FIT)
        assert port.state_dict()["step"] == jax_model.state_dict()["step"] == step0 + i * N_FIT
        close()


def test_mlap_eval_keyword_matches_the_jax_learner():
    """MLAP's eval_datasets takes n_iter_meta_test (default 3000) and other
    keywords, as the JAX learner's; meta_fit the same keywords as JAX's."""
    for name in ("eval_datasets", "meta_fit"):
        got = inspect.signature(getattr(GPRegressionMetaLearnedPAC, name))
        want = inspect.signature(getattr(JaxPAC, name))
        assert got == want, name
