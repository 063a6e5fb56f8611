"""B2, B7, B8 and B10 of two or more checkouts on the same inputs, bit for bit.

    python3 tools/fused_bits.py --root . --root DIR

Each root's package is imported in a process of its own (its kernel
library built there on first use) and runs the fused SVGD (B2), VI (B7)
and MLAP (B8) kernels on seeded inputs at the shapes of their main paths:
``sin_20``'s (20 tasks of 5 points, D=1, NN/NN 32x32) with K = S = 10 and
32, full batch and with count pages; B8 at S=5, full batch, counted and in
meta-test mode at 20 and 5 tasks; phase 2's odd shape (7 ragged tasks
of up to 7 points, D=2, nets (16,16,16), S=3); and B10 at ``svgd_t5_n200``'s
(K=10, 5 tasks of 200 points, D=1, NN/NN 32x32), full batch and counted.
Every output (the state and its moments after 50 steps, and the losses) must
equal the first root's, bit for bit. Needs the card.
"""

import argparse
import os
import subprocess
import sys
import tempfile

CHILD = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from meta_learning_pacoh_torch.ops.cuda import fused_mlap_kernel as mk
from meta_learning_pacoh_torch.ops.cuda import fused_svgd_bign_kernel as sb
from meta_learning_pacoh_torch.ops.cuda import fused_svgd_kernel as fk
from meta_learning_pacoh_torch.ops.cuda import fused_vi_kernel as vk

STEPS = 50
out = {}


def data(seed, t, n, d, ragged):
    gen = torch.Generator().manual_seed(seed)
    x = 4.0 * torch.rand(t, n, d, generator=gen) - 2.0
    y = torch.sin(2.0 * x.sum(-1)) + 0.1 * torch.randn(t, n, generator=gen)
    mask = torch.ones(t, n)
    if ragged:
        for i in range(t):
            mask[i, (i * 3) % n + 1:] = 0.0 if i % 2 else 1.0
    x, y = x * mask[..., None], y * mask
    return gen, x.cuda(), y.cuda(), mask.cuda()


def counts_of(gen, t, batch):
    idx = torch.randint(0, t, (STEPS, batch), generator=gen)
    return torch.stack([torch.bincount(i, minlength=t).float() for i in idx]).cuda()


for name, (count, t, n, d, hidden, ragged) in {
        "sin20_10": (10, 20, 5, 1, (32, 32), False),
        "sin20_32": (32, 20, 5, 1, (32, 32), False),
        "odd": (3, 7, 7, 2, (16, 16, 16), True)}.items():
    for counted in (False,) if ragged else (False, True):  # counted: uniform sizes
        gen, x, y, mask = data(len(name) + 7 * counted, t, n, d, ragged)
        batch = max(1, t // 4) if counted else None
        counts = counts_of(gen, t, batch) if counted else None
        w_t = torch.from_numpy(fk.task_weights(mask.cpu().numpy(), batch)).cuda()
        hp = fk.fused_prior(d, hidden, 0.5, 3.0)
        p = hp.dim
        theta = (hp.loc + hp.scale * torch.randn(count, p, generator=gen)).cuda()
        state = [theta, torch.zeros_like(theta), torch.zeros_like(theta)]
        fk.fused_svgd_train(*state, x, y, mask, w_t, 0, 1e-3, 0.01, counts, hidden=hidden,
                            wps=0.5, bps=3.0, n_steps=STEPS)
        key = f"b2_{name}_{'counted' if counted else 'full'}"
        for i, a in enumerate(state):
            out[f"{key}_{i}"] = a.cpu().numpy()
        post = [(0.1 * torch.randn(p, generator=gen)).cuda(), torch.full((p,), -2.0).cuda()]
        post += [torch.zeros(p).cuda() for _ in range(4)]
        eps = torch.randn(STEPS, count, p, generator=gen).cuda()
        loss = vk.fused_vi_train(*post, x, y, mask, w_t, eps, 0, 1e-3, 0.01, counts,
                                 hidden=hidden, wps=0.5, bps=3.0,
                                 mll_const=vk.mll_constant(mask.cpu().numpy(), batch),
                                 n_steps=STEPS)
        key = f"b7_{name}_{'counted' if counted else 'full'}"
        for i, a in enumerate(post):
            out[f"{key}_{i}"] = a.cpu().numpy()
        out[f"{key}_loss"] = torch.stack(loss).cpu().numpy()

for name, (s, t, n, d, hidden, ragged, mode) in {
        "mlap_full": (5, 20, 5, 1, (32, 32), False, "full"),
        "mlap_counted": (5, 20, 5, 1, (32, 32), False, "counted"),
        "mlap_test20": (5, 20, 5, 1, (32, 32), False, "test"),
        "mlap_test5": (5, 5, 5, 1, (32, 32), False, "test"),
        "mlap_odd": (3, 7, 7, 2, (16, 16, 16), True, "counted")}.items():
    gen, x, y, mask = data(len(name), t, n, d, ragged)
    hp = fk.fused_prior(d, hidden, 0.5, 3.0)
    p = hp.dim
    params = {"loc": (hp.loc + 0.1 * hp.scale * torch.randn(p, generator=gen)).cuda(),
              "log_scale": torch.full((p,), -2.3).cuda(),
              "q_means": (0.1 * torch.randn(t, n, generator=gen)).cuda() * mask,
              "q_trils": (torch.tril(0.1 * torch.randn(t, n, n, generator=gen))
                          + torch.eye(n)).cuda(),
              "raw_noise": torch.tensor(-1.0).cuda()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    eps = torch.randn(STEPS, s, p, generator=gen).cuda()
    meta_test = mode == "test"
    counts = counts_of(gen, t, t) if mode == "counted" else None
    lrs = (0.0, 1e-2) if meta_test else (1e-3, 1e-3)
    loss, mean, diag = mk.fused_mlap_train(
        params, mu, nu, x, y, mask, eps, counts, 0, *lrs, hidden=hidden, wps=0.5, bps=3.0,
        task_kl_weight=1.0, meta_kl_weight=1e-3, delta=0.1, n_tasks=20, meta_test=meta_test,
        batch=t if counts is not None else None, n_steps=STEPS)
    for tree_name, tree in (("state", params), ("mu", mu), ("nu", nu)):
        for k, v in tree.items():
            out[f"b8_{name}_{tree_name}_{k}"] = v.cpu().numpy()
    out[f"b8_{name}_loss"] = torch.stack([loss, mean, *diag.values()]).cpu().numpy()

for counted in (False, True):  # B10 at svgd_t5_n200's shapes
    t, n, hidden = 5, 200, (32, 32)
    gen, x, y, mask = data(11 + counted, t, n, 1, False)
    batch = 2 if counted else None
    counts = counts_of(gen, t, batch) if counted else None
    w_t = torch.from_numpy(fk.task_weights(mask.cpu().numpy(), batch)).cuda()
    hp = fk.fused_prior(1, hidden, 0.5, 3.0)
    theta = (hp.loc + hp.scale * torch.randn(10, hp.dim, generator=gen)).cuda()
    state = [theta, torch.zeros_like(theta), torch.zeros_like(theta)]
    sb.fused_svgd_bign_train(*state, x, y, mask, w_t, 0, 1e-3, 0.01, counts, hidden=hidden,
                             wps=0.5, bps=3.0, n_steps=STEPS)
    for i, a in enumerate(state):
        out[f"b10_t5_n200_{'counted' if counted else 'full'}_{i}"] = a.cpu().numpy()
np.savez(sys.argv[2], **out)
"""


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", action="append", required=True,
                        help="a checkout's root (repeat); the first is the reference")
    args = parser.parse_args()
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for i, root in enumerate(args.root):
            path = os.path.join(tmp, f"fused_{i}.npz")
            subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(root), path], check=True)
            outs.append(dict(np.load(path)))
    ref = outs[0]
    same = True
    for root, out in zip(args.root[1:], outs[1:]):
        differ = sorted(k for k in ref if k not in out or not np.array_equal(out[k], ref[k]))
        same &= not differ
        print(f"{root}: {len(ref) - len(differ)} of {len(ref)} outputs the same bits as "
              f"{args.root[0]}" + (f"; DIFFERENT: {differ}" if differ else ""))
    if not same:
        sys.exit("fused_bits: outputs differ")


if __name__ == "__main__":
    main()
