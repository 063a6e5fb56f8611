"""Measure, on one NVIDIA GPU, what the port's big-N SVGD and VI dispatch and chip_smoke.py's phase 9 limits rest on.

    python tools/torch_bign_policy.py [--seeds 1-8] [--out FILE]

For bench.py's ``svgd_t5_n200`` and ``vi_t5_n200`` learners (5 tasks x 200
points, K = S = 10, full batch) and each seed, 20 steps from the learner's
initial state through its fused kernel (B10, B11), through its general step
(``PACOH_TORCH_DISABLE_FUSED=1``) and through the kernel's plain version in
float64 (``chip_smoke.bign_twins``): the gaps of each path to the float64
run. The largest general-step gap over the seeds, twice, is the fixed limit
of ``chip_smoke.BIGN_GENERAL_F64``. Then the faceoff of the two paths' steady
rates at the shapes of ``chip_smoke.BIGN_FACEOFF`` (``chip_smoke.
bign_faceoff``), beside the learners' default dispatch
(``ops/cuda/fused_svgd_bign_kernel.bign_wins``). Prints the card's name and
power limit, each reading, and one JSON object, also written to ``--out``.
Imports nothing of JAX.
"""

import argparse
import json
import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", default="1-8", help="first-last seed")
    parser.add_argument("--out", help="also write the JSON object to this file")
    args = parser.parse_args()
    first, last = (int(v) for v in args.seeds.split("-"))

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_bign_policy: no CUDA device")
    card = chip_smoke.card_line()
    print(card, flush=True)
    train, _ = chip_smoke.bign_data()
    learners = (("svgd_t5_n200", chip_smoke.bign_svgd_model, chip_smoke.svgd_state, 1,
                 chip_smoke.svgd_plain64),
                ("vi_t5_n200", chip_smoke.bign_vi_model, chip_smoke.vi_live_state, 2,
                 chip_smoke.vi_plain64))
    out = {"card": card, "drift": {}, "faceoff": {}}
    for label, build, state_of, n_params, plain64 in learners:
        rows = []
        for seed in range(first, last + 1):
            *_, f64, g64, fg = chip_smoke.bign_twins(build, state_of, n_params, plain64, train,
                                                     seed)
            rows.append(dict(seed=seed, fused_f64=f64, general_f64=g64, fused_general=fg))
            print(f"{label} seed {seed}: (max, mean, moments) fused - float64 {f64}, general - "
                  f"float64 {g64}, fused - general {fg}", flush=True)
        largest = [max(r["general_f64"][i] for r in rows) for i in range(3)]
        out["drift"][label] = dict(rows=rows, general_f64_largest=largest)
        print(f"{label}: the general step's largest gaps to float64 over seeds {first}-{last}: "
              f"{largest}", flush=True)
    for label, build, *_ in learners:
        out["faceoff"][label] = chip_smoke.bign_faceoff(label.split("_")[0].upper(), build)
    text = json.dumps(out)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
