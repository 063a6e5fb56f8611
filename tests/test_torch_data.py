"""The port's task environments and import boundary.

``provide_data`` of the port (a numpy copy) must give byte-equal arrays to
the JAX package's for the same seed, and so must the file-backed
environments on synthetic files (the Physionet and Swissfel fixtures of
tests/test_file_datasets.py, a tiny gzipped IDX3 pair for MNIST, all in
``tmp_path``); importing the port must not import jax.
"""

import os
import subprocess
import sys

import gzip
import struct

import numpy as np
import pytest
from test_file_datasets import physionet_dir, swissfel_dir  # noqa: F401  (fixtures)

from meta_learning_pacoh_tpu.datasets import data_sim as jax_data_sim
from meta_learning_pacoh_tpu.datasets import provide_data as jax_provide_data
from meta_learning_pacoh_torch.datasets import data_sim, provide_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_tasks_byte_equal(got, want):
    for split_got, split_want in zip(got, want):
        assert len(split_got) == len(split_want)
        for task_got, task_want in zip(split_got, split_want):
            for a, b in zip(task_got, task_want):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["sin_20", "cauchy_20"])
def test_provide_data_is_byte_equal(name):
    assert_tasks_byte_equal(provide_data(name, seed=28), jax_provide_data(name, seed=28))


@pytest.fixture()
def mnist_dir(tmp_path):
    """12 training and 8 test images of 28 x 28 in gzipped IDX3 files."""
    rs = np.random.RandomState(0)
    for name, n in (("train", 12), ("t10k", 8)):
        imgs = rs.randint(0, 256, size=(n, 28, 28), dtype=np.uint8)
        with gzip.open(tmp_path / f"{name}-images-idx3-ubyte.gz", "wb") as f:
            f.write(struct.pack(">IIII", 2051, *imgs.shape) + imgs.tobytes())
    return str(tmp_path)


def _file_env(module, name, data_dir, seed):
    if name == "physionet":
        return module.PhysionetDataset(random_state=np.random.RandomState(seed), variable_id=2,
                                       physionet_dir=data_dir)
    if name == "swissfel":
        return module.SwissfelDataset(random_state=np.random.RandomState(seed),
                                      swissfel_dir=data_dir)
    return module.MNISTRegressionDataset(random_state=np.random.RandomState(seed))


# name -> (fixture, meta-train arguments, meta-test arguments)
FILE_ENVS = {
    "physionet": ("physionet_dir", dict(n_tasks=4, n_samples=47),
                  dict(n_tasks=3, n_samples_context=24)),
    "swissfel": ("swissfel_dir", dict(n_tasks=5, n_samples=200),
                 dict(n_samples_context=200, n_samples_test=400)),
    "mnist": ("mnist_dir", dict(n_tasks=4, n_samples=20),
              dict(n_tasks=3, n_samples_context=10, n_samples_test=30)),
}


@pytest.mark.parametrize("name", sorted(FILE_ENVS))
def test_file_environments_are_byte_equal(request, monkeypatch, name):
    """Each file-backed environment of the port against the JAX package's on
    the same synthetic files and seed: meta-train and meta-test tasks equal
    to the byte (MNIST reads its directory from ``MNIST_DIR``)."""
    fixture, train_kw, test_kw = FILE_ENVS[name]
    data_dir = request.getfixturevalue(fixture)
    for module in (data_sim, jax_data_sim):
        monkeypatch.setattr(module, "MNIST_DIR", data_dir)
    got, want = (_file_env(module, name, data_dir, seed=5) for module in (data_sim, jax_data_sim))
    assert_tasks_byte_equal((got.generate_meta_train_data(**train_kw),
                             got.generate_meta_test_data(**test_kw)),
                            (want.generate_meta_train_data(**train_kw),
                             want.generate_meta_test_data(**test_kw)))


def test_import_leaves_jax_out():
    """Every module of the port, found by ``pkgutil.walk_packages``, imports
    neither JAX nor anything of the JAX package."""
    code = ("import importlib, pkgutil, sys, meta_learning_pacoh_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
            "assert len(names) > 20, names\n"
            "for name in names: importlib.import_module(name)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'meta_learning_pacoh_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120).stdout
    assert out.strip() == "[]"
