"""Measure phase 10's twins on the card over seeds: the source of chip_smoke.py's PAC_TWIN_F64.

    python3 tools/single_task_twins.py [--seeds 1-8] [--out tools/single_task_twins.json]

For each path of chip_smoke.py's phase 10 and each seed, the path's learner
built at that seed takes chip_smoke.TWIN_STEPS steps from its initial state
through the kernels and through their plain versions
(``PACOH_TORCH_DISABLE_KERNELS=1``) in float32, and GPR-PAC's also in
float64 (``chip_smoke.single_twins``). Writes every gap (parameters' max and
mean |diff|, the kernel net's output bias left out, and the last loss's
relative difference) and the limits GPR-PAC's twin takes: twice the largest
kernel - float64 reading over the seeds, rounded up to two significant
digits, as tools/torch_bign_policy.py sets the big-N general steps' limits.
Needs the card; the readings kept in tools/single_task_twins.json are an
H100's.
"""

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def round_up(x):
    """x rounded up to two significant digits."""
    scale = 10.0 ** (math.floor(math.log10(x)) - 1)
    return math.ceil(x / scale) * scale


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", default="1-8", help="first-last seed")
    parser.add_argument("--out", default=os.path.join(ROOT, "tools", "single_task_twins.json"))
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    import meta_learning_pacoh_torch as pkg
    from tools.single_task_ref import build

    if not torch.cuda.is_available():
        sys.exit("single_task_twins: no CUDA device")
    first, last = (int(v) for v in args.seeds.split("-"))

    def build_path(name, seed=30):
        return build(pkg, name, seed=seed)

    gaps = {}
    for name in chip_smoke.SINGLE_PATHS:
        gaps[name] = {}
        for seed in range(first, last + 1):
            print(f"{name}, seed {seed}:", flush=True)
            gaps[name][seed] = chip_smoke.single_twins(name, build_path, seed=seed, check=False)
    wide = [g["plain64"] for g in gaps["gpr_pac_n200"].values()]
    limits = [round_up(2.0 * max(g[i] for g in wide)) for i in range(3)]
    out = {"card": chip_smoke.card_line(), "seeds": [first, last], "gaps": gaps,
           "pac_twin_f64": limits}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"card": out["card"], "pac_twin_f64": limits}))


if __name__ == "__main__":
    main()
