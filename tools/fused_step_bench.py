#!/usr/bin/env python3
"""Time the fused SVGD (B2) and VI (B7) training kernels a step at ``sin_20``'s
shapes, the big-N ones (B10, B11) at theirs, or the PACOH-MAP ones (B9, B6),
on one CUDA card.

    python3 tools/fused_step_bench.py [--root DIR] [--out FILE] [--clusters 1,2,4,5,8]
    python3 tools/fused_step_bench.py --bign [--root DIR] [--out FILE]
    python3 tools/fused_step_bench.py --map [--root DIR] [--out FILE] [--clusters 1,2,4,8,16]
    python3 tools/fused_step_bench.py --mlap [--root DIR] [--out FILE] [--clusters 1,2,4,5,8]

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

``--bign`` times B10 and B11 instead, from the learners' own data and
initial states (K = S = 10, full batch, NN/NN 32x32; the learners of
``chip_smoke.py``): at ``svgd_t5_n200`` / ``vi_t5_n200`` (5 tasks of 200 points),
``cauchy_20`` (20 tasks of 20 points, D=2), the corners of the big-N faceoff
(5 sinusoid tasks of N in {9, 48, 128, 256}, 20 tasks of N=200) and shapes
of more systems than SMs at small N (20 tasks of N in {9, 48, 100}, 100
tasks of N=48), each the median over 7 launches of 100 steps. Each row
prints B10's plan: blocks, systems a block and threads a block (512 where
the tree's plan does not say).

``--map`` times B9 and B6 instead, from the MAP learners' own data and
initial states (chip_smoke.py's learners, NN/NN 32x32, F=2 unless said):
B9 at ``map_t5_n200`` (5 tasks of 200 points, full batch), at 5 sinusoid
tasks of N in {9, 48, 200, 256, 300, 512} and at phase 2's odd shape
(ragged tasks of up to 300 points, D=2, F=3, nets (16,16,16)), launches of
100 steps (25 at N=512); B6 at the demo's shapes (20 tasks of 5 points),
counted (task batch 5, launches of 512 steps from the learner's count
pages) and full batch (launches of 200 steps). Where the tree's B6 wrapper
takes a ``cluster`` keyword, B6 is also timed at every size of
``--clusters`` the card holds.

``--mlap`` times the fused PACOH-MLAP kernel B8 instead, from the learner's
own data, initial state and pages (chip_smoke.py's ``mlap`` learner: S=5, 20
tasks of 5 points, NN/NN 32x32): the fit counted (the learner's count pages)
and full batch, the meta-test mode at T=5 (five test context sets) and T=20,
each in launches of 200 steps, and phase 2's odd shape (S=3, 7 ragged tasks
of up to 7 points, D=2, nets (16,16,16)). Where the tree's wrapper takes a
``cluster`` keyword, every shape is also timed at each size of ``--clusters``
that is no larger than its task count.
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
BIGN_STEPS = 100
# (label, tasks, points): cauchy_20's tasks where tasks is None
BIGN_SHAPES = (("t5_n200", 5, 200), ("cauchy_20", None, None), ("N=9, 5 tasks", 5, 9),
               ("N=48, 5 tasks", 5, 48), ("N=128, 5 tasks", 5, 128),
               ("N=256, 5 tasks", 5, 256), ("N=200, 20 tasks", 20, 200),
               ("N=9, 20 tasks", 20, 9), ("N=48, 20 tasks", 20, 48),
               ("N=100, 20 tasks", 20, 100), ("N=48, 100 tasks", 100, 48))


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


def bign_rows():
    """B10 and B11 a step at BIGN_SHAPES, from the learners' data and initial
    states (chip_smoke.py's learners, importing the package on sys.path)."""
    import numpy as np
    import torch

    sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_bign_kernel as sb
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_bign_kernel as vb
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

    rows = []
    for label, n_tasks, n_points in BIGN_SHAPES:
        tasks = cs.bign_data()[0] if label == "t5_n200" else cs.faceoff_tasks(n_tasks, n_points)
        seed = 30 if label == "cauchy_20" else 1
        svgd, vi = cs.bign_svgd_model(tasks, seed=seed), cs.bign_vi_model(tasks, seed=seed)
        data = (svgd.X, svgd.Y, svgd.mask)
        t, n, d = svgd.X.shape
        kw = dict(hidden=(32, 32), wps=0.5, bps=3.0, n_steps=BIGN_STEPS)
        trainer = sb.FusedSVGDBigNTrainer(*data, hidden=(32, 32), lr=1e-3, prior_factor=0.01,
                                          weight_prior_std=0.5, bias_prior_std=3.0)
        state = [svgd.particles.clone(), torch.zeros_like(svgd.particles),
                 torch.zeros_like(svgd.particles)]
        b10 = per_step_ms(lambda: sb.fused_svgd_bign_train(*state, *data, trainer.w_t, 0, 1e-3,
                                                           0.01, **kw), BIGN_STEPS)
        p = vi.hyper_prior.dim
        eps = torch.from_numpy(np.random.RandomState(0).randn(BIGN_STEPS, 10, p)
                               .astype(np.float32)).to(vi.X.device)
        mll_const = vk.mll_constant(vi.mask.cpu().numpy())
        post = cs.vi_state(vi)
        b11 = per_step_ms(lambda: vb.fused_vi_bign_train(*post, vi.X, vi.Y, vi.mask, trainer.w_t,
                                                         eps, 0, 1e-3, 0.01,
                                                         mll_const=mll_const, **kw), BIGN_STEPS)
        plan = sb.svgd_bign_plan(10, t, n, d, (32, 32))
        threads = plan[3] if len(plan) > 3 else 512
        print(f"{label} (T={t}, N={n}, D={d}; {plan[0]} blocks of {plan[1]} systems, {threads} "
              f"threads, matrices in {'shared' if plan[2] else 'device'} memory): B10 {b10:.5f} "
              f"ms a step, B11 {b11:.5f} ms a step")
        rows.append({"shape": label, "T": t, "N": n, "D": d, "plan": list(plan), "b10_ms": b10,
                     "b11_ms": b11})
    return rows


def map_rows(clusters):
    """B9 and B6 a step (see the module's docstring)."""
    import numpy as np
    import torch

    sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from meta_learning_pacoh_torch.ops.cuda import fused_map_bign_kernel as bg
    from meta_learning_pacoh_torch.ops.cuda import fused_map_kernel as mk

    rows = []
    rs = np.random.RandomState(9)  # chip_smoke.phase2_b9's odd shape
    odd = [(rs.uniform(-2.0, 2.0, (m, 2)), rs.randn(m)) for m in (300, 250, 300, 120)]
    shapes = [("map_t5_n200", cs.bign_data()[0], {})]
    shapes += [(f"N={n}, 5 tasks", cs.faceoff_tasks(5, n), {}) for n in (9, 48, 200, 256, 300, 512)]
    shapes += [("odd: ragged up to 300, D=2, F=3, nets (16,16,16)", odd,
                dict(feature_dim=3, mean_nn_layers=(16, 16, 16), kernel_nn_layers=(16, 16, 16)))]
    for label, tasks, kw in shapes:
        model = cs.bign_model(tasks, **kw)
        tr = model._fused_trainer()
        t, n, d = model.X.shape
        steps = 25 if n > 300 else BIGN_STEPS
        state = [model.params.clone(), torch.zeros_like(model.params),
                 torch.zeros_like(model.params)]
        ms = per_step_ms(lambda: bg.fused_map_bign_train(
            *state, model.X, model.Y, model.mask, tr.w_t, 0, 1e-3, 0.0, layout=model.layout,
            n_steps=steps), steps)
        plan = bg.bign_plan(t, n, d, model.cfg.feature_dim, model.cfg.mean_nn_layers,
                            model.cfg.kernel_nn_layers)
        print(f"B9 {label} (T={t}, N={n}, D={d}; plan {plan}): {ms:.5f} ms a step")
        rows.append({"kernel": "B9", "shape": label, "T": t, "N": n, "D": d, "plan": list(plan),
                     "ms": ms})
    demo = cs.demo_model(cs.sin20()[0])
    tr = demo._fused_trainer()
    counts = tr.count_pages(0, mk.FusedMAPTrainer.MAX_LAUNCH)
    data = (demo.X, demo.Y, demo.mask, tr.w_t)
    clustered = "cluster" in inspect.signature(mk.fused_map_train).parameters
    sizes = [None] + (clusters if clustered else [])
    for c in sizes:
        forced = {} if c is None else {"cluster": c}
        if c is not None and not mk.cluster_fits(*demo.X.shape, demo.cfg.feature_dim,
                                                 demo.cfg.mean_nn_layers,
                                                 demo.cfg.kernel_nn_layers, c):
            print(f"B6 C={c}: not taken at the demo's shapes")
            continue
        for label, cnt, steps in (("demo, counted batch of 5", counts, counts.shape[0]),
                                  ("demo, full batch", None, STEPS)):
            state = [demo.params.clone(), torch.zeros_like(demo.params),
                     torch.zeros_like(demo.params)]
            try:
                ms = per_step_ms(lambda: mk.fused_map_train(
                    *state, *data, 0, 1e-3, 0.2, cnt, layout=demo.layout, n_steps=steps,
                    **forced), steps)
            except RuntimeError as e:  # a cluster size the card does not hold
                print(f"B6 {label} C={c}: {e}")
                continue
            plan = mk.map_plan(*demo.X.shape, demo.cfg.feature_dim, demo.cfg.mean_nn_layers,
                               demo.cfg.kernel_nn_layers, c) if clustered else None
            name = "plan" if c is None else f"C={c}"
            print(f"B6 {label} {name} {plan}: {ms:.5f} ms a step")
            rows.append({"kernel": "B6", "shape": label, "cluster": c,
                         "plan": None if plan is None else list(plan), "ms": ms})
    return rows


def mlap_rows(clusters):
    """B8 a step (see the module's docstring)."""
    import numpy as np

    sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from meta_learning_pacoh_torch.ops.cuda import fused_mlap_kernel as mk

    train, test = cs.sin20()
    rs = np.random.RandomState(8)  # chip_smoke.phase2_b8's odd shape
    odd_kw = dict(svi_batch_size=3, mean_nn_layers=(16, 16, 16), kernel_nn_layers=(16, 16, 16))
    odd = cs.mlap_model(cs.conditioned_tasks(rs, 7, 7, 2, (7, 5, 7, 3, 7, 6, 2)), **odd_kw)
    fit, ctx = cs.mlap_model(train), cs.mlap_model([t[:2] for t in test[:5]])
    clustered = "cluster" in inspect.signature(mk.fused_mlap_train).parameters
    rows = []
    for label, model, counted, meta_test in (("mlap, counted", fit, True, False),
                                             ("mlap, full batch", fit, False, False),
                                             ("mlap meta-test, T=5", ctx, False, True),
                                             ("mlap meta-test, T=20", fit, False, True),
                                             ("odd shape, counted", odd, True, False)):
        t, n, d = model.X.shape
        hidden = tuple(model.cfg.mean_nn_layers)
        trainer = mk.FusedMLAPTrainer(
            model.X, model.Y, model.mask, hidden=hidden, lr=1e-3, posterior_lr_multiplier=1.0,
            svi_batch_size=model.svi_batch_size, task_batch_size=t, task_kl_weight=1.0,
            meta_kl_weight=1e-3, delta=0.1, weight_prior_std=0.5, bias_prior_std=3.0,
            eps_draw=model._draw_eps, task_draw=model._task_draw)
        eps = trainer.eps_pages(0, STEPS)
        counts = trainer.count_pages(0, STEPS) if counted else None
        kw = dict(hidden=hidden, wps=0.5, bps=3.0, task_kl_weight=1.0, meta_kl_weight=1e-3,
                  delta=0.1, n_tasks=20 if meta_test else t, meta_test=meta_test,
                  batch=t if counted else None, n_steps=STEPS)
        lrs = (0.0, 1e-2) if meta_test else (1e-3, 1e-3)
        for c in [None] + ([c for c in clusters if c <= t] if clustered else []):
            forced = {} if c is None else {"cluster": c}
            state = cs.mlap_state(model)
            try:
                ms = per_step_ms(lambda: mk.fused_mlap_train(
                    *state, model.X, model.Y, model.mask, eps, counts, 0, *lrs, **kw, **forced))
            except RuntimeError as e:  # a cluster size the card does not hold
                print(f"B8 {label} C={c}: {e}")
                continue
            plan = (list(mk.cluster_plan(model.svi_batch_size, t, n, d, hidden, c)) if clustered
                    else None)
            name = "plan" if c is None else f"C={c}"
            print(f"B8 {label} (S={model.svi_batch_size}, T={t}, N={n}, D={d}, {hidden}) {name} "
                  f"{plan}: {ms:.5f} ms a step")
            rows.append({"kernel": "B8", "shape": label, "cluster": c, "plan": plan, "ms": ms})
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--out")
    parser.add_argument("--clusters", help="cluster sizes to time beside the plan "
                        "(default 1,2,4,5,8; with --map 1,2,4,8,16)")
    parser.add_argument("--bign", action="store_true", help="time B10 and B11 instead")
    parser.add_argument("--map", action="store_true", help="time B9 and B6 instead")
    parser.add_argument("--mlap", action="store_true", help="time B8 instead")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("fused_step_bench: no CUDA device")
    import meta_learning_pacoh_torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if args.mlap:
        emit(args, {"root": os.path.abspath(args.root),
                    "package": os.path.dirname(meta_learning_pacoh_torch.__file__), "card": card,
                    "rows": mlap_rows([int(c) for c in (args.clusters or "1,2,4,5,8").split(",")])})
        return
    if args.map:
        emit(args, {"root": os.path.abspath(args.root),
                    "package": os.path.dirname(meta_learning_pacoh_torch.__file__), "card": card,
                    "rows": map_rows([int(c) for c in (args.clusters or "1,2,4,8,16").split(",")])})
        return
    if args.bign:
        emit(args, {"root": os.path.abspath(args.root),
                    "package": os.path.dirname(meta_learning_pacoh_torch.__file__), "card": card,
                    "rows": bign_rows()})
        return
    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

    dev = torch.device("cuda")
    x, y, mask = (torch.from_numpy(a).to(dev) for a in sin20_arrays())
    t, n, d = x.shape
    hidden = (32, 32)
    hp = fk.fused_prior(d, hidden, 0.5, 3.0)
    p = hp.dim
    clustered = "cluster" in inspect.signature(fk.fused_svgd_train).parameters
    sizes = [None] + ([int(c) for c in (args.clusters or "1,2,4,5,8").split(",")] if clustered
                      else [])
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
    emit(args, {"root": os.path.abspath(args.root),
                "package": os.path.dirname(meta_learning_pacoh_torch.__file__), "card": card,
                "rows": rows})


def emit(args, result):
    print(result["card"])
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
