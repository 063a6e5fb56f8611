"""Times the build of the port's CUDA kernels, source by source.

Compiles each ``meta_learning_pacoh_torch/csrc/*.cu`` alone, one after
another, with the flags of ``ops/cuda/build.py`` and ``nvcc --time``, and
prints each one's wall seconds and its phases (host preprocessing, cicc,
ptxas, ...); then builds all of them together as ``build.library`` does
(one nvcc per source, all started at once) and prints that wall time. The
last line is one JSON object with every number. Needs nvcc; writes only
into a temporary directory.

    python tools/nvcc_times.py
"""

import csv
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from meta_learning_pacoh_torch.ops.cuda import build  # noqa: E402


def main():
    nvcc = build._nvcc()
    sources = build._csrc_files(".cu")
    result = {"alone": {}, "phases_s": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            name = os.path.basename(src)
            table = os.path.join(tmp, name + ".csv")
            t0 = time.perf_counter()
            subprocess.run([nvcc, *build.NVCC_FLAGS, "-c", "-o", os.path.join(tmp, name + ".o"),
                            src, "--time", table], check=True, capture_output=True)
            result["alone"][name] = time.perf_counter() - t0
            phases = {}
            with open(table) as f:
                for row in csv.reader(f):
                    row = [c.strip() for c in row]
                    if len(row) >= 8 and row[7] == "ms":
                        phases[row[1]] = phases.get(row[1], 0.0) + float(row[6]) / 1e3
            result["phases_s"][name] = phases
            print(f"{name}: {result['alone'][name]:.2f} s alone; "
                  + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items()), flush=True)
        t0 = time.perf_counter()
        build._compile(sources, os.path.join(tmp, "lib.so"))
        result["together_s"] = time.perf_counter() - t0
    print(f"all {len(sources)} sources together: {result['together_s']:.2f} s")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
