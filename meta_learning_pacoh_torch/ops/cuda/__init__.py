"""Hand-written CUDA kernels for Hopper: the counterpart of ``ops/pallas/``.

Each module holds one kernel's wrapper and, beside it, its plain PyTorch
version. A wrapper takes the plain version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device; it never falls back.
``LAUNCHES`` counts the kernel launches of each wrapper, so a run can show
that its main path went through the kernels (``fused_svgd_bign_coresident``
counts those of B10's launches whose plan put two blocks on an SM).
``adam_step_`` is the Adam(W) update of the learners' general steps and of
the fused training kernels' plain versions.
"""

import math

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

LAUNCHES = {"svgd_phi": 0, "mll_fwd": 0, "mll_bwd": 0, "chol": 0, "chol_small": 0,
            "blocked_fwd": 0, "blocked_bwd": 0, "fused_svgd": 0, "fused_map": 0,
            "fused_vi": 0, "fused_map_bign": 0, "fused_mlap": 0, "fused_svgd_bign": 0,
            "fused_vi_bign": 0, "fused_svgd_bign_coresident": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def adam_step_(theta, mu, nu, g, t, lr, weight_decay=0.0, mask=None):
    """optax's Adam(W) step t (1-based) on gradient g, in place, as the fused
    kernels compute it: bias corrections 1 - exp(t log b) in float32, then
    theta - lr (update + weight_decay theta). ``mask`` (0/1, theta's shape)
    freezes its 0 coordinates as optax's ``set_to_zero``: their gradient
    is dropped and they get neither an update nor weight decay."""
    if mask is not None:
        g = g * mask
    t = torch.tensor(float(t), dtype=torch.float32, device=theta.device)
    bc1 = 1.0 - torch.exp(t * math.log(ADAM_B1))
    bc2 = 1.0 - torch.exp(t * math.log(ADAM_B2))
    mu.mul_(ADAM_B1).add_((1.0 - ADAM_B1) * g)
    nu.mul_(ADAM_B2).add_((1.0 - ADAM_B2) * g * g)
    update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS) + weight_decay * theta
    if mask is not None:
        update = update * mask
    theta.sub_(lr * update)


def check_operand(name, t, ndim):
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of rank ``ndim``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
