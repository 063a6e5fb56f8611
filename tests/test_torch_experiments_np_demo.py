"""The port's image NP driver and demo against the originals
(experiments/np_image_experiment.py, demo.py), on the CPU.

The image NP driver reads the original's JSON config and writes the
original's files: config.json byte for byte, losses.json with a loss an
epoch, model.pkl with the original's keys and parameter names, shapes and
dtypes; the port's model.pkl holds numpy arrays only, the parameters of
the same training run driven directly, and loads into a fresh port model
that inpaints as the trained one does. The demo builds and fits its learner
with the original's keywords (read from both sources), prints the
original's three results, which are the bits of the same learner fitted
directly (its steps cut here), and saves its plot where matplotlib is.
"""

import ast
import json
import os
import pickle

import numpy as np

from chip_smoke import synthetic_idx_images
from meta_learning_pacoh_torch import GPRegressionMetaLearned
from meta_learning_pacoh_torch.datasets import SinusoidDataset
from meta_learning_pacoh_torch.datasets.np_image_data import mnist_image_batches
from meta_learning_pacoh_torch.experiments import np_image_experiment
from meta_learning_pacoh_torch.models.neural_process_img import (
    NeuralProcessImg,
    NeuralProcessImgTrainer,
    batch_context_target_mask,
)
from test_torch_experiments_cli import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {"dataset": "mnist", "img_size": [1, 28, 28], "batch_size": 8, "r_dim": 8, "h_dim": 8,
          "z_dim": 4, "num_context_range": [3, 20], "num_extra_target_range": [5, 20],
          "epochs": 2, "lr": 1e-3, "limit": 16, "seed": 0}


def _config(tmp_path, results):
    synthetic_idx_images(str(tmp_path / "train-images-idx3-ubyte.gz"), 16)
    return {**CONFIG, "path_to_data": str(tmp_path), "results_dir": str(tmp_path / results)}


def test_np_image_driver_writes_the_originals_files(tmp_path):
    from experiments.np_image_experiment import run_experiment as original

    config = _config(tmp_path, "port")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    losses, out = np_image_experiment.main([str(path)], device="cpu")
    _, want = original({**config, "results_dir": str(tmp_path / "orig")}, verbose=False)
    assert sorted(os.listdir(out)) == sorted(os.listdir(want)) == [
        "config.json", "losses.json", "model.pkl"]
    with open(os.path.join(want, "config.json")) as f:
        want_config = json.load(f)
    assert json.loads((tmp_path / "port" / "config.json").read_text()) == {
        **want_config, "results_dir": config["results_dir"]}
    with open(os.path.join(out, "losses.json")) as f:
        assert json.load(f) == losses and len(losses) == 2 and np.isfinite(losses).all()
    with open(os.path.join(out, "model.pkl"), "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(want, "model.pkl"), "rb") as f:
        ref = pickle.load(f)
    assert sorted(got) == sorted(ref) == ["config", "params"]
    assert got["config"] == config
    assert {k: (v.shape, v.dtype) for k, v in got["params"].items()} == {
        k: (np.asarray(v).shape, np.asarray(v).dtype) for k, v in ref["params"].items()}
    assert all(type(v) is np.ndarray for v in got["params"].values())


def test_model_pkl_loads_into_a_fresh_model(tmp_path):
    """model.pkl holds the parameters of the same run driven directly; a
    fresh model loaded from it inpaints with the trained model's bits."""
    config = _config(tmp_path, "port")
    np_image_experiment.run_experiment(config, verbose=False, device="cpu")
    with open(tmp_path / "port" / "model.pkl", "rb") as f:
        saved = pickle.load(f)
    batches = mnist_image_batches(batch_size=8, size=28, path_to_data=str(tmp_path),
                                  random_state=np.random.RandomState(0), limit=16)
    kw = dict(r_dim=8, z_dim=4, h_dim=8, random_seed=0, device="cpu")
    direct = NeuralProcessImg((1, 28, 28), **kw)
    NeuralProcessImgTrainer(direct, lr=1e-3, num_context_range=(3, 20),
                            num_extra_target_range=(5, 20)).train(batches, 2)
    assert np.array_equal(np.concatenate([v.ravel() for v in saved["params"].values()]),
                          np.concatenate([v.ravel() for v in np_image_experiment.model_arrays(
                              direct).values()]))
    loaded = NeuralProcessImg((1, 28, 28), **kw)
    loaded.load_params(saved["params"])
    loaded._generator.set_state(direct._generator.get_state())
    cm, _ = batch_context_target_mask((1, 28, 28), 30, 10, 1,
                                      random_state=np.random.RandomState(1))
    for a, b in zip(loaded.inpaint(batches.images[0], cm[0]),
                    direct.inpaint(batches.images[0], cm[0])):
        np.testing.assert_array_equal(a, b)


def _calls(path, names):
    """{name: (positional argument sources, {keyword: value source})} of the
    calls of ``names`` in a source file."""
    out = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            if name in names:
                out[name] = ([ast.unparse(a) for a in node.args],
                             {k.arg: ast.unparse(k.value) for k in node.keywords})
    return out


def test_demo_calls_are_the_originals():
    """The demo's data, learner and fit calls carry the original's arguments
    (the port's step counts named as constants of the same values)."""
    from meta_learning_pacoh_torch import demo

    names = ("RandomState", "SinusoidDataset", "generate_meta_train_data",
             "generate_meta_test_data", "GPRegressionMetaLearned", "meta_fit", "eval_datasets",
             "linspace", "predict", "confidence_intervals", "savefig")
    want = _calls(os.path.join(ROOT, "demo.py"), names)
    got = _calls(demo.__file__, names)
    assert got["GPRegressionMetaLearned"][1].pop("device") == "device"
    got["GPRegressionMetaLearned"][1]["num_iter_fit"] = str(demo.NUM_ITER_FIT)
    got["meta_fit"][1]["log_period"] = str(demo.LOG_PERIOD)
    assert got == want


def test_demo_prints_the_directly_fitted_learners_results(monkeypatch, tmp_path, capsys):
    from meta_learning_pacoh_torch import demo

    monkeypatch.setattr(demo, "NUM_ITER_FIT", 30)
    monkeypatch.setattr(demo, "LOG_PERIOD", 10)
    monkeypatch.chdir(tmp_path)
    got = demo.main([], device="cpu")
    out = capsys.readouterr().out
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=20, n_samples=5)
    test = env.generate_meta_test_data(n_tasks=20, n_samples_context=5, n_samples_test=50)
    model = GPRegressionMetaLearned(train, weight_decay=0.2, num_iter_fit=30, random_seed=30,
                                    device="cpu")
    model.meta_fit(n_iter=30, log_period=30, verbose=False)
    want = model.eval_datasets(test)
    assert got == want
    for label, v in zip(("Test log-likelihood:", "Test RMSE:", "Test calibration error:"), want):
        assert f"{label} {v}\n" in out
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert "Could not plot results" in out
    else:
        assert "saved plot to demo_prediction.png" in out
        assert (tmp_path / "demo_prediction.png").exists()
