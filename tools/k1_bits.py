"""K1 (csrc/svgd_phi.cu) of two or more checkouts on the same inputs, bit for bit.

    python3 tools/k1_bits.py --root . --root DIR

Each root's package is imported in a process of its own (its kernel
library built there on first use), runs K1 on seeded inputs at the general
step's shapes ([K, P] calls: cauchy_20's [10, 2372], its SE learner's
[10, 1188], K=1, K=32 at P=20000, P=37) and, where that root's wrapper
takes a seed axis, at [1, K, P] too; the outputs of every root and shape
must be equal to the first root's [K, P] outputs, bit for bit. Needs the
card.
"""

import argparse
import os
import subprocess
import sys
import tempfile

SHAPES = ((10, 2372), (10, 1188), (1, 2372), (32, 20000), (10, 37))

CHILD = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from meta_learning_pacoh_torch.ops.cuda import svgd_kernel
out = {}
for k, p in %r:
    gen = torch.Generator().manual_seed(k * 100000 + p)
    x = torch.randn(k, p, generator=gen).cuda()
    s = (10.0 * torch.randn(k, p, generator=gen)).cuda()
    out[f"{k}x{p}"] = svgd_kernel.svgd_phi_fused(x, s).cpu().numpy()
    try:
        out[f"1x{k}x{p}"] = svgd_kernel.svgd_phi_fused(x[None].contiguous(),
                                                       s[None].contiguous())[0].cpu().numpy()
    except ValueError:  # a wrapper without the seed axis
        pass
np.savez(sys.argv[2], **out)
""" % (SHAPES,)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", action="append", required=True,
                        help="a checkout's root (repeat); the first is the reference")
    args = parser.parse_args()
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for i, root in enumerate(args.root):
            path = os.path.join(tmp, f"k1_{i}.npz")
            subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(root), path], check=True)
            outs.append(dict(np.load(path)))
    ref = outs[0]
    same = True
    for root, out in zip(args.root, outs):
        for key, value in out.items():
            want = ref[key.split("x", 1)[1] if key.count("x") == 2 else key]
            equal = np.array_equal(value, want)
            same &= equal
            print(f"{root} {key}: {'the same bits' if equal else 'DIFFERENT'} as "
                  f"{args.root[0]} [K, P]")
    if not same:
        sys.exit("k1_bits: outputs differ")


if __name__ == "__main__":
    main()
