#!/usr/bin/env python3
"""Time the batched Cholesky K4 and the blocked MLL forward (B4) at their main
paths' shapes beside ``torch.linalg.cholesky_ex``, and the B4 backward beside
its plain version and ``torch.cholesky_inverse``, on one CUDA card.

    python3 tools/tiled_chol_bench.py [--root DIR] [--out FILE]

``--root`` imports ``meta_learning_pacoh_torch`` from another checkout (an
unpacked parent commit), so that two trees can be timed on the same card:
run parent, change, change, parent. Shapes, all N=200: K4 at B=2000
(the evals of ``cauchy_20`` and ``vi_t5_n200``) and B=200 (``svgd_t5_n200``,
``map_t5_n200``); the B4 forward at B=5 (MAP general step), B=50 (SVGD/VI
general steps) and B=200 (bench.py); the B4 backward at the same three
batches, on the forward's L and z (the library call computes K^-1 alone
from L). Each time is the median over 15 CUDA event pairs of ``inner``
back-to-back calls, divided by ``inner``; the card's name and power limit
are printed beside them.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPES = (("chol", 2000, 200), ("chol", 200, 200), ("blocked_fwd", 5, 200),
          ("blocked_fwd", 50, 200), ("blocked_fwd", 200, 200), ("blocked_bwd", 5, 200),
          ("blocked_bwd", 50, 200), ("blocked_bwd", 200, 200))


def per_call_ms(fn, inner, reps=15):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--out")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("tiled_chol_bench: no CUDA device")
    from meta_learning_pacoh_torch.ops.cuda import blocked_mll_kernel as bk
    from meta_learning_pacoh_torch.ops.cuda import chol_kernel

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    rows = []
    for name, b, n in SHAPES:
        g = torch.randn(b, n, n + 3, generator=gen).cuda()
        a = (g @ g.mT / n + 0.5 * torch.eye(n, device="cuda")).contiguous()
        r = torch.randn(b, n, generator=gen).cuda()
        inner = 2 if b >= 2000 else 10
        if name == "blocked_bwd":
            _, _, L, z = bk.blocked_mll_fwd(a, r)
            gq, gl = torch.randn(b, generator=gen).cuda(), torch.randn(b, generator=gen).cuda()
            kernel = lambda: bk.blocked_mll_bwd(L, z, gq, gl)  # noqa: E731
            plain = lambda: bk.blocked_mll_bwd_ref(L, z, gq, gl)  # noqa: E731
            library, lib_name = (lambda: torch.cholesky_inverse(L)), "cholesky_inverse"
        else:
            kernel = ((lambda: chol_kernel.cholesky_fused(a)) if name == "chol"
                      else (lambda: bk.blocked_mll_fwd(a, r)))
            plain, library, lib_name = None, (lambda: torch.linalg.cholesky_ex(a)), "cholesky_ex"
        k1 = per_call_ms(kernel, inner)
        lib1 = per_call_ms(library, inner)
        k2 = per_call_ms(kernel, inner)
        lib2 = per_call_ms(library, inner)
        row = {"kernel": name, "B": b, "N": n, "ms": [k1, k2], f"{lib_name}_ms": [lib1, lib2]}
        line = f"{name} B={b} N={n}: kernel {k1:.4f} {k2:.4f} ms, {lib_name} {lib1:.4f} {lib2:.4f} ms"
        if plain is not None:
            row["plain_ms"] = per_call_ms(plain, inner)
            line += f", plain {row['plain_ms']:.4f} ms"
        rows.append(row)
        print(line)
    result = {"root": os.path.abspath(args.root), "card": card, "rows": rows}
    print(card)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
