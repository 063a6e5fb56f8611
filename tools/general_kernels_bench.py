#!/usr/bin/env python3
"""Time the general step's kernels K1 (Stein transport), K2 and K3 (the
small-N MLL forward and backward), and the small-N Cholesky B5, and their
plain versions as device time and as one synchronised call, on one CUDA
card.

    python3 tools/general_kernels_bench.py [--root DIR] [--out FILE]

``--root`` imports ``meta_learning_pacoh_torch`` from another checkout (an
unpacked parent commit), so that two trees can be timed on the same card:
run parent, change, change, parent. Shapes: K1 at [10, 2372] (the NN/NN
width of ``cauchy_20``) and [10, 1188] (its ``covar_module="SE"`` learner,
whose general step calls K1 every step); K2 and K3 at B=200, N=20 with
systems that need the 1e-4 and the 1e-2 jitter and with none, and at B=50
and 200 with N=48; B5 at N in {32, 50, 64} (the evals' predictive
covariances are N=50) and B in {1, 20, 200}, beside
``torch.linalg.cholesky_ex``.

Device time: ``chip_smoke.device_ms`` of this checkout: a device-side wait
(``torch.cuda._sleep``) long enough for the host to enqueue the whole run,
then an event, 100 calls, an event; the time between the events over 100,
checked to hold no host time (a plain version that reads a value back to
the host cannot be queued so: it is marked ``host_sync``). Profiler:
``chip_smoke.profiled_ms``, the summed durations of the kernels and copies
``torch.profiler`` records on the card over 20 calls, over 20. Wall: the
median of 20 event pairs around one synchronised call each.
Each time is printed beside the card's name and power limit.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
WALL_REPS = 20


def _timers():
    """This checkout's chip_smoke.py (its device-time and event helpers),
    whichever tree ``--root`` imports the kernels from."""
    path = os.path.join(os.path.dirname(HERE), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_timers", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TIMERS = _timers()


def timings(fn):
    dev, host_sync = TIMERS.device_ms(fn)
    return {"device_ms": dev, "host_sync": host_sync, "profiler_ms": TIMERS.profiled_ms(fn),
            "wall_ms": statistics.median(TIMERS.median_ms(fn, WALL_REPS))}


def systems(b, n, escalate, gen):
    """b SPD systems of size n; with ``escalate``, five whose factorization
    needs the 1e-4 (systems 3, 50, 120 of 200) or the 1e-2 jitter (7, 160),
    as phase 2 of chip_smoke.py builds them."""
    import torch

    g = torch.randn(b, n, n + 3, generator=gen)
    kn = g @ g.mT / n + 0.5 * torch.eye(n)
    if escalate:
        for i, lam_min in ((3, -5e-5), (50, -5e-5), (120, -5e-5), (7, -5e-3), (160, -5e-3)):
            q, _ = torch.linalg.qr(torch.randn(n, n, generator=gen, dtype=torch.float64))
            lam = torch.empty(n, dtype=torch.float64).uniform_(1e-4, 1e-3, generator=gen)
            lam[0] = lam_min
            kn[i] = ((q * lam) @ q.T).float()
    return kn.contiguous().cuda(), torch.randn(b, n, generator=gen).cuda()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(HERE))
    parser.add_argument("--out")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("general_kernels_bench: no CUDA device")
    from meta_learning_pacoh_torch.ops.cuda import (chol_kernel, chol_small_kernel, mll_kernel,
                                                    svgd_kernel)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    rows = []

    def report(row):
        rows.append(row)
        parts = [f"{key} " + ", ".join("n/a" if v is None else
                                       (f"{v:.5f}" if isinstance(v, float) else str(v))
                                       for v in val.values())
                 for key, val in row.items() if isinstance(val, dict)]
        print(f"{row['kernel']} {row['shape']}: " + "; ".join(parts))

    for k, p in ((10, 2372), (10, 1188)):
        x = torch.randn(k, p, generator=gen).cuda()
        s = (10.0 * torch.randn(k, p, generator=gen)).cuda()
        report({"kernel": "K1 svgd_phi", "shape": f"[{k}, {p}]",
                "kernel_ms": timings(lambda: svgd_kernel.svgd_phi_fused(x, s)),
                "plain_ms": timings(lambda: svgd_kernel.svgd_phi_ref(x, s))})
    for b, n, escalate in ((200, 20, True), (200, 20, False), (50, 48, False), (200, 48, False)):
        kn, r = systems(b, n, escalate, gen)
        _, _, L, z = mll_kernel.mll_fwd_ref(kn, r)
        gq, gl = torch.randn(b, generator=gen).cuda(), torch.randn(b, generator=gen).cuda()
        shape = f"B={b}, N={n}" + (", escalating" if escalate else "")
        report({"kernel": "K2 mll_fwd", "shape": shape,
                "kernel_ms": timings(lambda: mll_kernel.mll_fwd(kn, r)),
                "plain_ms": timings(lambda: mll_kernel.mll_fwd_ref(kn, r)),
                "cholesky_ex_ms": timings(lambda: torch.linalg.cholesky_ex(kn))})
        report({"kernel": "K3 mll_bwd", "shape": shape,
                "kernel_ms": timings(lambda: mll_kernel.mll_bwd(L, z, gq, gl)),
                "plain_ms": timings(lambda: mll_kernel.mll_bwd_ref(L, z, gq, gl)),
                "cholesky_inverse_ms": timings(lambda: torch.cholesky_inverse(L))})
    for n in (32, 50, 64):
        for b in (1, 20, 200):
            g = torch.randn(b, n, n + 3, generator=gen)
            a = (g @ g.mT / n + 0.1 * torch.eye(n)).contiguous().cuda()
            report({"kernel": "B5 chol_small", "shape": f"B={b}, N={n}",
                    "kernel_ms": timings(lambda: chol_small_kernel.cholesky_small(a)),
                    "plain_ms": timings(lambda: chol_kernel.cholesky_ref(a)),
                    "cholesky_ex_ms": timings(lambda: torch.linalg.cholesky_ex(a))})
    result = {"root": os.path.abspath(args.root), "card": card, "run": TIMERS.QUEUED_RUN,
              "rows": rows}
    print(card)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
