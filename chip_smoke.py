#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PACOH-SVGD once on one NVIDIA GPU.

    python3 chip_smoke.py                # all phases, one card
    python3 chip_smoke.py --profile DIR  # also trace 20 fit steps and one eval
                                         # with torch.profiler, tables into DIR

Phase 0 requires CUDA and prints the card's name and power limit.
Phase 1 builds the hand-written kernels from ``meta_learning_pacoh_torch/csrc``.
Phase 2 holds each kernel against its plain PyTorch version on the card, at
the shapes the ``cauchy_20`` main path gives it, and times both.
Phase 3 runs that main path through the public entry points:
``provide_data("cauchy_20")``, ``GPRegressionMetaLearnedSVGD(..., device="cuda")``,
``meta_fit`` and ``eval_datasets`` on all 200 test tasks, with every launch
counter at 0 before and above 0 after; then twins of the fit and of the eval
with the kernels disabled, compared with the kernel path.

Any failure raises and exits non-zero. The line before the last is a JSON
object with one record per kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

SOURCE = "meta_learning_pacoh_torch/csrc/"
TPU = "meta_learning_pacoh_tpu/ops/pallas/"
KERNELS = {  # launch-counter name -> (source, TPU kernel it replaces)
    "svgd_phi": (SOURCE + "svgd_phi.cu", TPU + "svgd_kernel.py:71"),
    "mll_fwd": (SOURCE + "mll.cu", TPU + "mll_kernel.py:188"),
    "mll_bwd": (SOURCE + "mll.cu", TPU + "mll_kernel.py:219"),
    "chol": (SOURCE + "chol.cu", TPU + "blocked_mll_kernel.py:815"),
}
# per-system error, normalised by the system's largest |plain| value
KERNEL_RTOL = 2e-4
FIT_STEPS = 500
TWIN_STEPS = 20
# particles after TWIN_STEPS Adam steps from one state: max difference a tenth
# of one step's reach (lr 1e-3), mean difference 2e-6
TWIN_ATOL, TWIN_MEAN_ATOL = 1e-4, 2e-6
EVAL_TWIN_TASKS = 20
EVAL_TWIN_TOL = 1e-3  # rtol and atol of LL, RMSE, calib


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def median_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_pair(kernel, plain, reps=10):
    """Median ms of each, timed in turns: plain, kernel, kernel, plain."""
    import torch

    kernel(), plain()
    torch.cuda.synchronize()
    p = median_ms(plain, reps)
    k = median_ms(kernel, reps) + median_ms(kernel, reps)
    p += median_ms(plain, reps)
    return statistics.median(k), statistics.median(p)


def system_err(got, want):
    """(max abs error, max per-system error / max |want| of that system)."""
    import torch

    diff = (got - want).abs().reshape(got.shape[0], -1)
    scale = want.abs().reshape(want.shape[0], -1).amax(dim=1).clamp_min(1e-30)
    return float(diff.max()), float((diff.amax(dim=1) / scale).max())


def check(name, got, want, records):
    abs_err, rel = system_err(got, want)
    print(f"  {name}: max abs err {abs_err:.3e}, max per-system rel err {rel:.3e}")
    if not rel <= KERNEL_RTOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"({rel:.3e} > {KERNEL_RTOL})")
    records[name] = max(records.get(name, 0.0), abs_err)


def spd(n_sys, n, gen, scale=0.1):
    import torch

    g = torch.randn(n_sys, n, n + 3, generator=gen).cuda()
    return (g @ g.mT / n + scale * torch.eye(n, device="cuda")).contiguous()


def escalating_systems(n, gen, lam_min):
    """A symmetric matrix with eigenvalues in [1e-4, 1e-3] except one lam_min."""
    import torch

    q, _ = torch.linalg.qr(torch.randn(n, n, generator=gen, dtype=torch.float64))
    lam = torch.empty(n, dtype=torch.float64).uniform_(1e-4, 1e-3, generator=gen)
    lam[0] = lam_min
    return ((q * lam) @ q.T).float().cuda()


def phase2(param_dim):
    import torch

    from meta_learning_pacoh_torch.ops.cuda import chol_kernel, mll_kernel, svgd_kernel

    gen = torch.Generator().manual_seed(0)
    errs, times = {}, {}

    # K1 at the slice's [K, P]
    x = torch.randn(10, param_dim, generator=gen).cuda()
    s = 10.0 * torch.randn(10, param_dim, generator=gen).cuda()
    check("svgd_phi", svgd_kernel.svgd_phi_fused(x, s)[None],
          svgd_kernel.svgd_phi_ref(x, s)[None], errs)
    times["svgd_phi"] = time_pair(lambda: svgd_kernel.svgd_phi_fused(x, s),
                                  lambda: svgd_kernel.svgd_phi_ref(x, s))

    # K2/K3 at the slice's B = K*T = 200 systems of N = 20, with systems whose
    # factorization needs the 1e-4 and the 1e-2 jitter
    b, n = 200, 20
    kn = spd(b, n, gen, scale=0.5)
    for i in (3, 50, 120):
        kn[i] = escalating_systems(n, gen, -5e-5)
    for i in (7, 160):
        kn[i] = escalating_systems(n, gen, -5e-3)
    r = torch.randn(b, n, generator=gen).cuda()
    eye = torch.eye(n, device="cuda")
    ok = [chol_kernel.diag_ok(chol_kernel.cholesky_ref(kn + j * eye))
          for j in mll_kernel.JITTERS]
    level = torch.where(ok[0], 0, torch.where(ok[1], 1, 2))
    if not {0, 1, 2} <= set(level.tolist()):
        raise AssertionError(f"escalation levels hit: {sorted(set(level.tolist()))}")
    got = mll_kernel.mll_fwd(kn, r)
    want = mll_kernel.mll_fwd_ref(kn, r)
    for label, g_, w_ in zip(("quad", "logdet", "L", "z"), got, want):
        check("mll_fwd", g_[:, None] if g_.dim() == 1 else g_,
              w_[:, None] if w_.dim() == 1 else w_, errs)
        print(f"    ({label})")
    L, z = want[2], want[3]
    gq = torch.randn(b, generator=gen).cuda()
    gl = torch.randn(b, generator=gen).cuda()
    for label, g_, w_ in zip(("dkn", "dr"), mll_kernel.mll_bwd(L, z, gq, gl),
                             mll_kernel.mll_bwd_ref(L, z, gq, gl)):
        check("mll_bwd", g_, w_, errs)
        print(f"    ({label})")
    times["mll_fwd"] = time_pair(lambda: mll_kernel.mll_fwd(kn, r),
                                 lambda: mll_kernel.mll_fwd_ref(kn, r))
    times["mll_bwd"] = time_pair(lambda: mll_kernel.mll_bwd(L, z, gq, gl),
                                 lambda: mll_kernel.mll_bwd_ref(L, z, gq, gl))

    # K4 at the eval's shape: 200 test tasks x 10 particles of N = 200, with
    # one indefinite matrix that must come back NaN as in the plain version
    a = spd(2000, 200, gen)
    lam = torch.linalg.eigvalsh(a[5])
    a[5] -= (lam[0] + 0.05 * (lam[1] - lam[0])) * torch.eye(200, device="cuda")
    a[5] -= 1e-3 * torch.eye(200, device="cuda")
    got, want = chol_kernel.cholesky_fused(a), chol_kernel.cholesky_ref(a)
    nan_got, nan_want = torch.isnan(got), torch.isnan(want)
    if not (torch.equal(nan_got, nan_want) and bool(nan_want[5].all())
            and not bool(nan_want[torch.arange(2000) != 5].any())):
        raise AssertionError("chol: NaN pattern differs from the plain version")
    keep = torch.arange(2000, device="cuda") != 5
    check("chol", got[keep], want[keep], errs)
    times["chol"] = time_pair(lambda: chol_kernel.cholesky_fused(a),
                              lambda: chol_kernel.cholesky_ref(a), reps=3)
    for name, (k_ms, p_ms) in times.items():
        print(f"  {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median)")
    return errs, times


def diff_excluding(a, b, skip):
    """(max, mean) |a - b| over all but the columns in ``skip``."""
    import torch

    keep = torch.ones(a.shape[-1], dtype=torch.bool)
    keep[skip] = False
    d = (a - b).abs()[:, keep]
    return float(d.max()), float(d.mean())


def profile(label, fn, out_dir):
    """Trace fn once with torch.profiler; write the table, return a summary."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()  # warm
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # device-side rows only: an operator's row repeats its kernels' time
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "top": [(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in top]}


def phase3(profile_dir):
    import numpy as np
    import torch

    from meta_learning_pacoh_torch import GPRegressionMetaLearnedSVGD
    from meta_learning_pacoh_torch.datasets import provide_data
    from meta_learning_pacoh_torch.ops import cuda

    train, _, test = provide_data("cauchy_20", seed=28)
    model = GPRegressionMetaLearnedSVGD(train, num_particles=10, random_seed=30,
                                        device="cuda")
    print(f"  cauchy_20: {len(train)} tasks x {len(train[0][0])} points, "
          f"{len(test)} test tasks x {len(test[0][2])} test points, "
          f"K={model.num_particles}, P={model.hyper_prior.dim}")

    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    model.meta_fit(n_iter=FIT_STEPS, log_period=FIT_STEPS, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ll, rmse, calib = model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    print(f"  meta_fit: {FIT_STEPS} steps in {fit_s:.3f} s "
          f"({FIT_STEPS / fit_s:.1f} steps/s, first step included)")
    print(f"  eval_datasets: {len(test)} tasks in {eval_s:.3f} s (first call)")
    print(f"  metrics: LL {ll:.6f}, RMSE {rmse:.6f}, calib {calib:.6f}")
    print(f"  launches in the main path: {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
    if not all(math.isfinite(v) for v in (ll, rmse, calib)):
        raise AssertionError("non-finite metrics")
    if model.particles.shape != (10, model.hyper_prior.dim) or not bool(
            torch.isfinite(model.particles).all()):
        raise AssertionError("particles are not finite of shape [K, P]")

    # steady-state step rate, after the first chunk's warm-up
    t0 = time.perf_counter()
    model.meta_fit(n_iter=100, log_period=100, verbose=False)
    torch.cuda.synchronize()
    steady = 100 / (time.perf_counter() - t0)
    print(f"  steady state: {steady:.1f} steps/s")
    t0 = time.perf_counter()
    model.eval_datasets(test)
    torch.cuda.synchronize()
    eval_warm_s = time.perf_counter() - t0
    print(f"  eval_datasets again: {eval_warm_s:.3f} s")
    traces = {}
    if profile_dir:
        traces["fit_20_steps"] = profile(
            "fit", lambda: model.meta_fit(n_iter=20, log_period=20, verbose=False), profile_dir)
        traces["eval"] = profile("eval", lambda: model.eval_datasets(test), profile_dir)
        for label, summary in traces.items():
            print(f"  trace {label}: " + json.dumps(summary))

    # twins from one state: kernels on, kernels off
    state = model.state_dict()
    skip = model.hyper_prior.slice_of(("kernel_nn", "b_out"))
    twins = {}
    for label, disabled in (("kernels", "0"), ("plain", "1")):
        os.environ["PACOH_TORCH_DISABLE_KERNELS"] = disabled
        twin = GPRegressionMetaLearnedSVGD(train, num_particles=10, random_seed=30,
                                           device="cuda")
        twin.load_state_dict(state)
        twin.meta_fit(n_iter=TWIN_STEPS, log_period=TWIN_STEPS, verbose=False)
        twins[label] = (twin.particles.detach().cpu(),
                        twin.eval_datasets(test[:EVAL_TWIN_TASKS]))
    os.environ.pop("PACOH_TORCH_DISABLE_KERNELS")
    d_max, d_mean = diff_excluding(twins["kernels"][0], twins["plain"][0], skip)
    print(f"  twin fit ({TWIN_STEPS} steps): |particle diff| max {d_max:.3e}, "
          f"mean {d_mean:.3e} (kernel_nn.b_out excluded; tolerances {TWIN_ATOL}, "
          f"{TWIN_MEAN_ATOL})")
    if not (d_max <= TWIN_ATOL and d_mean <= TWIN_MEAN_ATOL):
        raise AssertionError("kernel and plain twins disagree")
    m_k, m_p = np.asarray(twins["kernels"][1]), np.asarray(twins["plain"][1])
    print(f"  twin eval ({EVAL_TWIN_TASKS} tasks): kernels {m_k.tolist()}, "
          f"plain {m_p.tolist()}")
    if not np.allclose(m_k, m_p, rtol=EVAL_TWIN_TOL, atol=EVAL_TWIN_TOL):
        raise AssertionError("kernel and plain eval disagree")
    return launches, dict(fit_s=fit_s, eval_s=eval_s, eval_warm_s=eval_warm_s,
                          steady_steps_per_s=steady, ll=ll, rmse=rmse, calib=calib,
                          twin_max=d_max, twin_mean=d_mean, traces=traces)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="trace 20 fit steps and one eval with torch.profiler; "
                             "write the tables into DIR")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    card = card_line()
    print(f"phase 0: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; {card}")

    from meta_learning_pacoh_torch.models.random_gp import make_hyper_prior, random_gp_config
    from meta_learning_pacoh_torch.ops.cuda import build

    t0 = time.perf_counter()
    build.library()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_info['seconds']:.2f} s) -> {build.build_info['path']}")
    for line in build.build_info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("   ", line.strip())

    param_dim = make_hyper_prior(random_gp_config(2, feature_dim=1)).dim
    print(f"phase 2: kernels against their plain versions (P={param_dim})")
    errs, times = phase2(param_dim)

    print("phase 3: cauchy_20 PACOH-SVGD main path")
    launches, summary = phase3(args.profile)
    print("slice: " + json.dumps({"card": card, **summary}))

    records = [{"name": name, "route": "cuda", "source": src, "replaces": tpu,
                "launches": launches[name], "max_abs_err": errs[name],
                "ms": times[name][0], "plain_ms": times[name][1]}
               for name, (src, tpu) in KERNELS.items()]
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
