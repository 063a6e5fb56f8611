"""The port's task environments and import boundary.

``provide_data`` of the port (a numpy copy) must give byte-equal arrays to
the JAX package's for the same seed, and importing the port must not import
jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from meta_learning_pacoh_tpu.datasets import provide_data as jax_provide_data
from meta_learning_pacoh_torch.datasets import provide_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["sin_20", "cauchy_20"])
def test_provide_data_is_byte_equal(name):
    got, want = provide_data(name, seed=28), jax_provide_data(name, seed=28)
    for split_got, split_want in zip(got, want):
        assert len(split_got) == len(split_want)
        for task_got, task_want in zip(split_got, split_want):
            for a, b in zip(task_got, task_want):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()


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
