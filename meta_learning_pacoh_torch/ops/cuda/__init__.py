"""Hand-written CUDA kernels for Hopper: the counterpart of ``ops/pallas/``.

Each module holds one kernel's wrapper and, beside it, its plain PyTorch
version. A wrapper takes the plain version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device; it never falls back.
``LAUNCHES`` counts the kernel launches of each wrapper, so a run can show
that its main path went through the kernels.
"""

import torch

LAUNCHES = {"svgd_phi": 0, "mll_fwd": 0, "mll_bwd": 0, "chol": 0, "fused_svgd": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
