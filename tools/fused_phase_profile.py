#!/usr/bin/env python3
"""Profile the phases of the fused SVGD (B2) and VI (B7) kernels by ``clock64()``
marks, on one CUDA card.

    python3 tools/fused_phase_profile.py [--root DIR] [--work DIR] [--out FILE]

Copies ``meta_learning_pacoh_torch`` of the checkout ``--root`` (default:
this one) into ``--work`` (default ``_scratch_tree/phase_profile``, which
git ignores; never the package itself), adds marks to the copy's B2 and B7
sources and builds it: thread 0 of block 0 adds the cycles since its last
mark to a per-phase counter at each mark, each mark placed after a barrier
so that it closes the block's phase. Then it runs 200 steps of each kernel
in one launch at ``sin_20``'s shapes (K = S = 10, NN/NN 32x32) and prints the
cycles a step of every phase, the profiled build's time a step, and the
card's name, power limit and SM clock. It knows two layouts of the kernels:
one block a particle or sample (score_section.cuh) and one cluster a
particle or sample (cluster_score.cuh). The marks add a few barriers and
global stores, so the times are the profiled build's, not the kernel's.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 200

PROF = """
__device__ long long g_prof[16];
__device__ long long g_t0;
__device__ __forceinline__ void prof_mark(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const long long t = clock64();
    g_prof[i] += t - g_t0;
    g_t0 = t;
  }
}
"""

READER = """
extern "C" int pacoh_prof_read_%s(long long* out) {
  long long zero[16] = {0};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(zero));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
}
"""

# (file, anchor, text inserted after the anchor); each anchor occurs once
ONE_BLOCK = {
    "header": "score_section.cuh",
    "patches": [
        ("score_section.cuh", "  nets_forward(th, o, M, D, H, L, w);\n", "  prof_mark(1);\n"),
        ("score_section.cuh", "  __syncthreads();\n\n  // ---- backward of both nets into the score\n",
         "  prof_mark(2);\n"),
        ("score_section.cuh", "    if (kValue) *wql_out = sq;\n  }\n  __syncthreads();\n",
         "  prof_mark(3);\n"),
        ("fused_svgd.cu", "    const int par = it & 1;\n", "    prof_mark(0);\n"),
        ("fused_svgd.cu", "      s_pub[c] = s;\n    }\n", "    __syncthreads();\n    prof_mark(4);\n"),
        ("fused_svgd.cu", "      s_pub[c] = s;\n    }\n    __syncthreads();\n    prof_mark(4);\n"
         "    grid.sync();\n", "    prof_mark(5);\n"),
        ("fused_svgd.cu", "      if (lane == 0) q.d2[me * K + j] = acc;\n    }\n",
         "    __syncthreads();\n    prof_mark(6);\n"),
        ("fused_svgd.cu", "    prof_mark(6);\n    grid.sync();\n", "    prof_mark(7);\n"),
        ("fused_svgd.cu", "    const float gamma = rbf_gamma(median_upper(d2s, kk, scal), q.log_kp1);\n",
         "    prof_mark(8);\n"),
        ("fused_svgd.cu", "          v_me[c], q.lr, bc1, bc2);\n    }\n    __syncthreads();\n",
         "    prof_mark(9);\n"),
        ("fused_vi.cu", "    const int par = it & 1;\n", "    prof_mark(0);\n"),
        ("fused_vi.cu", "* __ldg(eps_me + c);\n    __syncthreads();\n", "    prof_mark(10);\n"),
        ("fused_vi.cu", "(-0.5f * (scal[0] + q.mll_const));\n    }\n",
         "    __syncthreads();\n    prof_mark(4);\n"),
        ("fused_vi.cu", "    prof_mark(4);\n    grid.sync();\n", "    prof_mark(5);\n"),
        ("fused_vi.cu", "      adam(g_lsc, lsc[c], mls[c], vls[c], q.lr, bc1, bc2);\n    }\n",
         "    __syncthreads();\n    prof_mark(8);\n"),
        ("fused_vi.cu", "        loss_sum += loss;\n      }\n    }\n    __syncthreads();\n",
         "    prof_mark(9);\n"),
    ],
    "svgd": {0: "loop", 1: "both nets forward", 2: "per-task MLL", 3: "both nets backward",
             4: "hyper-prior term, publish", 5: "grid barrier 1", 6: "distances",
             7: "grid barrier 2", 8: "median", 9: "transport, Adam"},
    "vi": {0: "loop", 10: "sample", 1: "both nets forward", 2: "per-task MLL",
           3: "both nets backward", 4: "hyper-prior term, publish, objective",
           5: "grid barrier", 8: "reduction over S, Adam", 9: "loss (block 0)"},
}

CLUSTER = {
    "header": "cluster_score.cuh",
    "patches": [
        ("cluster_score.cuh", "  cluster_forward(th, o, D, H, L, w);\n", "  prof_mark(1);\n"),
        ("cluster_score.cuh", "  cluster_tasks<N, kValue>(th, o, L, w_t, counts, w);\n",
         "  prof_mark(2);\n"),
        ("cluster_score.cuh", "  cluster_backward<kValue>(th, sc, o, D, H, L, w, wql_out);\n",
         "  __syncthreads();\n  prof_mark(3);\n"),
        ("fused_svgd.cu", "    const int par = it & 1;\n", "    prof_mark(0);\n"),
        ("fused_svgd.cu", "                         w, nullptr);\n    cluster.sync();\n",
         "    prof_mark(4);\n"),
        ("fused_svgd.cu", "(scale * scale));\n    }\n", "    __syncthreads();\n    prof_mark(5);\n"),
        ("fused_svgd.cu", "    prof_mark(5);\n    grid.sync();\n", "    prof_mark(6);\n"),
        ("fused_svgd.cu", "xst + cc, sst + cc, PT);\n      }\n      __syncthreads();\n",
         "      prof_mark(13);\n"),
        ("fused_svgd.cu", "        pd2[pr] = acc;\n      }\n      __syncthreads();\n    }\n",
         "    prof_mark(7);\n"),
        ("fused_svgd.cu", "    prof_mark(7);\n    cluster.sync();\n", "    prof_mark(8);\n"),
        ("fused_svgd.cu", "      kw[tid] = expf(-gamma * dd);\n    }\n    if (vec) cp_async_wait<0>();\n"
         "    __syncthreads();\n",
         "    prof_mark(9);\n"),
        ("fused_svgd.cu", "m_me[c], v_me[c], q.lr, bc1, bc2);\n      }\n    }\n",
         "    __syncthreads();\n    prof_mark(10);\n"),
        ("fused_svgd.cu", "then the particle whole again\n    cluster.sync();\n", "    prof_mark(11);\n"),
        ("fused_svgd.cu", "      cluster_gather(cluster, th, P);\n      __syncthreads();\n    }\n",
         "    prof_mark(12);\n"),
        ("fused_vi.cu", "    const int par = it & 1;\n", "    prof_mark(0);\n"),
        ("fused_vi.cu", "    if (it > 0) step_loss((it - 1) & 1);\n", "    prof_mark(11);\n"),
        ("fused_vi.cu", "    prof_mark(11);\n    cluster.sync();\n", "    prof_mark(4);\n"),
        ("fused_vi.cu", "      o_pub[1] = scal[0];\n    }\n", "    __syncthreads();\n    prof_mark(5);\n"),
        ("fused_vi.cu", "    prof_mark(5);\n    grid.sync();\n", "    prof_mark(6);\n"),
        ("fused_vi.cu", "__ldg(eps_next + c);\n    }\n", "    __syncthreads();\n    prof_mark(10);\n"),
        ("fused_vi.cu", "    lsum = block_sum(lsum, red);\n", "    prof_mark(7);\n"),
        ("fused_vi.cu", "    if (tid == 0) scal[1] = lsum;\n    cluster.sync();\n", "    prof_mark(9);\n"),
        ("fused_vi.cu", "    if (more) cluster_gather(cluster, th, P);\n    __syncthreads();\n",
         "    prof_mark(8);\n"),
    ],
    "svgd": {0: "loop", 1: "both nets forward", 2: "per-task MLL", 3: "both nets backward",
             4: "cluster barrier A", 5: "cluster sum of the slice, hyper-prior term, publish",
             6: "grid barrier", 13: "staging the slice", 7: "distances of the slice",
             8: "cluster barrier B",
             9: "cluster sum of the distances, median, kernel row", 10: "transport, Adam",
             11: "cluster barrier C", 12: "gather"},
    "vi": {0: "loop", 1: "both nets forward", 2: "per-task MLL", 3: "both nets backward",
           11: "the previous step's loss (its CTA only)", 4: "cluster barrier A",
           5: "cluster sum of the slice, hyper-prior term, publish", 6: "grid barrier",
           10: "reduction over S, Adam, next sample", 7: "sum of log_scale",
           9: "cluster barrier B", 8: "gather"},
}


def patched_copy(root, work):
    src = os.path.join(os.path.abspath(root), "meta_learning_pacoh_torch")
    dst = os.path.join(work, "meta_learning_pacoh_torch")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(dst, "csrc")
    layout = CLUSTER if os.path.exists(os.path.join(csrc, "cluster_score.cuh")) else ONE_BLOCK
    texts = {}

    def text(name):
        if name not in texts:
            with open(os.path.join(csrc, name)) as f:
                texts[name] = f.read()
        return texts[name]

    head = text(layout["header"])
    texts[layout["header"]] = head.replace("namespace {\n", "namespace {\n" + PROF, 1)
    for name, anchor, insert in layout["patches"]:
        body = text(name)
        if body.count(anchor) != 1:
            raise RuntimeError(f"fused_phase_profile: anchor found {body.count(anchor)} times "
                               f"in {name}: {anchor!r}")
        texts[name] = body.replace(anchor, anchor + insert)
    texts["fused_svgd.cu"] = text("fused_svgd.cu") + READER % "svgd"
    texts["fused_vi.cu"] = text("fused_vi.cu") + READER % "vi"
    for name, body in texts.items():
        with open(os.path.join(csrc, name), "w") as f:
            f.write(body)
    return layout


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(HERE))
    parser.add_argument("--work", default=os.path.join(os.path.dirname(HERE), "_scratch_tree",
                                                       "phase_profile"))
    parser.add_argument("--out")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("fused_phase_profile: no CUDA device")
    layout = patched_copy(args.root, os.path.abspath(args.work))
    sys.path.insert(0, os.path.abspath(args.work))
    from meta_learning_pacoh_torch.ops.cuda import build
    from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk
    from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

    sys.path.insert(0, HERE)
    from fused_step_bench import sin20_arrays

    lib = build.library()
    query = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"]
    dev = torch.device("cuda")
    x, y, mask = (torch.from_numpy(a).to(dev) for a in sin20_arrays())
    hidden, k = (32, 32), 10
    hp = fk.fused_prior(x.shape[-1], hidden, 0.5, 3.0)
    rs = np.random.RandomState(10)
    theta = (hp.loc + hp.scale * torch.from_numpy(rs.randn(k, hp.dim).astype(np.float32))).to(dev)
    w_t = torch.from_numpy(fk.task_weights(mask.cpu().numpy())).to(dev)
    eps = torch.from_numpy(rs.randn(STEPS, k, hp.dim).astype(np.float32)).to(dev)
    svgd_state = [theta.clone(), torch.zeros_like(theta), torch.zeros_like(theta)]
    post = [0.1 * torch.randn(hp.dim, device=dev), torch.full((hp.dim,), -2.0, device=dev)]
    post += [torch.zeros(hp.dim, device=dev) for _ in range(4)]
    runs = {
        "svgd": lambda n: fk.fused_svgd_train(*svgd_state, x, y, mask, w_t, 0, 1e-3, 0.01,
                                              hidden=hidden, wps=0.5, bps=3.0, n_steps=n),
        "vi": lambda n: vk.fused_vi_train(*post, x, y, mask, w_t, eps[:n].contiguous(), 0, 1e-3,
                                          0.01, hidden=hidden, wps=0.5, bps=3.0,
                                          mll_const=vk.mll_constant(mask.cpu().numpy()),
                                          n_steps=n),
    }
    buf = (ctypes.c_longlong * 16)()
    result = {"root": os.path.abspath(args.root), "layout": layout["header"]}
    for label, run in runs.items():
        read = getattr(lib, f"pacoh_prof_read_{label}")
        read.argtypes = [ctypes.c_void_p]
        run(10)
        torch.cuda.synchronize()
        read(buf)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(STEPS)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / STEPS
        err = read(buf)
        if err:
            raise RuntimeError(f"fused_phase_profile: reading the marks failed ({err})")
        phases = {name: buf[i] / STEPS for i, name in layout[label].items() if i != 0}
        total = sum(phases.values())
        print(f"{label} ({layout['header']}): {ms:.5f} ms a step (profiled build); "
              f"cycles a step by phase, block 0 ({total:.0f} in all):")
        for name, cyc in phases.items():
            print(f"  {name:58s} {cyc:10.0f}  {100 * cyc / total:5.1f}%")
        result[label] = {"ms_per_step": ms, "cycles": phases}
    card = subprocess.run(query, capture_output=True, text=True, check=True, timeout=60)
    result["card"] = card.stdout.strip()
    print(result["card"])
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
