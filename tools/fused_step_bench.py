#!/usr/bin/env python3
"""Time the fused SVGD (B2) and VI (B7) training kernels a step at ``sin_20``'s
shapes, on one CUDA card.

    python3 tools/fused_step_bench.py [--root DIR] [--out FILE] [--clusters 1,2,4,5,8]

``--root`` imports ``meta_learning_pacoh_torch`` from another checkout (an
unpacked parent commit), so that two trees can be timed on the same card:
run parent, change, change, parent. Shapes: ``sin_20`` (20 tasks of 5
points, D=1, NN/NN 32x32, P=2308) with K = S = 10 (the main path) and with
K = S = 32 (the window's largest). B2 runs launches of 200 steps, B7 of 200
steps from prebuilt noise pages; each time is the median over 7 CUDA event
pairs of one launch, divided by its steps. Where the tree's wrappers take a
``cluster`` keyword, each shape is also timed at every size of
``--clusters`` that the card holds, beside the default plan. The card's
name and power limit are printed beside the times.
"""

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

STEPS = 200
REPS = 7


def per_step_ms(fn, steps=STEPS, reps=REPS):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / steps)
    return statistics.median(times)


def sin20_arrays():
    import numpy as np

    from meta_learning_pacoh_torch.datasets import SinusoidDataset

    env = SinusoidDataset(random_state=np.random.RandomState(26))
    train = env.generate_meta_train_data(n_tasks=20, n_samples=5)
    x = np.stack([t[0] for t in train]).astype(np.float32)
    y = np.stack([t[1] for t in train]).astype(np.float32).reshape(x.shape[:2])
    return x, y, np.ones(y.shape, np.float32)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--out")
    parser.add_argument("--clusters", default="1,2,4,5,8")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("fused_step_bench: no CUDA device")
    import meta_learning_pacoh_torch
    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    x, y, mask = (torch.from_numpy(a).to(dev) for a in sin20_arrays())
    t, n, d = x.shape
    hidden = (32, 32)
    hp = fk.fused_prior(d, hidden, 0.5, 3.0)
    p = hp.dim
    clustered = "cluster" in inspect.signature(fk.fused_svgd_train).parameters
    sizes = [None] + ([int(c) for c in args.clusters.split(",")] if clustered else [])
    rows = []
    for k in (10, 32):
        rs = np.random.RandomState(k)
        theta = (hp.loc + hp.scale * torch.from_numpy(rs.randn(k, p).astype(np.float32))).to(dev)
        w_t = torch.from_numpy(fk.task_weights(mask.cpu().numpy())).to(dev)
        eps = torch.from_numpy(rs.randn(STEPS, k, p).astype(np.float32)).to(dev)
        mll_const = vk.mll_constant(mask.cpu().numpy())
        for c in sizes:
            forced = {} if c is None else {"cluster": c}
            plan = None
            if clustered:
                plan = fk.cluster_plan(k, t, n, d, hidden, c)
                if fk.resident_clusters(k, t, n, d, hidden, plan) < k:
                    print(f"B2/B7 K=S={k} C={c}: {k} clusters of {plan[0]} are not co-resident")
                    continue
            state = [theta.clone(), torch.zeros_like(theta), torch.zeros_like(theta)]
            b2 = per_step_ms(lambda: fk.fused_svgd_train(
                *state, x, y, mask, w_t, 0, 1e-3, 0.01, hidden=hidden, wps=0.5, bps=3.0,
                n_steps=STEPS, **forced))
            post = [0.1 * torch.randn(p, device=dev), torch.full((p,), -2.0, device=dev)]
            post += [torch.zeros(p, device=dev) for _ in range(4)]
            b7 = per_step_ms(lambda: vk.fused_vi_train(
                *post, x, y, mask, w_t, eps, 0, 1e-3, 0.01, hidden=hidden, wps=0.5, bps=3.0,
                mll_const=mll_const, n_steps=STEPS, **forced))
            label = "plan" if c is None else f"C={c}"
            print(f"K=S={k} {label} {plan}: B2 {b2:.5f} ms a step, B7 {b7:.5f} ms a step")
            rows.append({"K": k, "cluster": c, "plan": plan, "b2_ms": b2, "b7_ms": b7})
    result = {"root": os.path.abspath(args.root),
              "package": os.path.dirname(meta_learning_pacoh_torch.__file__), "card": card,
              "rows": rows}
    print(card)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
