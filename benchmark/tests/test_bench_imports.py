"""Nothing the benchmark runs loads JAX or the JAX package, and its reference
imports nothing of the program; without a card the entry exits with 2."""

import ast
import glob
import os
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "meta_learning_pacoh_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(harness.BENCH_DIR, "**", "*.py"), recursive=True):
        assert not imported_tops(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(harness.BENCH_DIR, "reference", "*.py")):
        assert "meta_learning_pacoh_torch" not in imported_tops(path), path


def test_what_the_harness_loads_holds_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from benchmark import harness, calibrate, trace;"
            "import benchmark.drivers.fit, benchmark.drivers.meta_test;"
            "[harness.reader(m['name']) for m in harness.entries()['per_layer']];"
            "import meta_learning_pacoh_torch;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, harness.ROOT], capture_output=True,
                         text=True, check=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_entry_exits_2_and_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        return  # the card's runs check the other side
    out = subprocess.run([sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
                          "--workload", "svgd_sin320_fit", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode == 2 and "{" not in out.stdout
