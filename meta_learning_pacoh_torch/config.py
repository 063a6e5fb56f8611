"""Runtime configuration of the PyTorch port (counterpart of meta_learning_pacoh_tpu/config.py).

GP numerics need true float32: a reduced-precision matrix product (TF32 on
the card) destroys the conditioning of the N x N Gram matrices and NaNs the
factorization, so importing the package pins full-precision products.

``kernels_enabled()`` mirrors ``PACOH_TPU_DISABLE_PALLAS``: the hand-written
CUDA kernels are on unless ``PACOH_TORCH_DISABLE_KERNELS`` is set, which
sends every dispatch point to its plain PyTorch version (the twin that
``chip_smoke.py`` compares the kernel path with).

``fused_enabled()`` mirrors ``PACOH_TPU_DISABLE_FUSED``: the single-launch
fused training kernel is on unless ``PACOH_TORCH_DISABLE_FUSED`` is set, or
the kernels are off altogether; then the learner takes its general step.

``force_bign_fused()`` mirrors ``PACOH_TPU_FORCE_BIGN_FUSED``: set, the
SVGD and VI learners take their big-N fused kernels wherever the kernels
fit, also beyond the shapes where the card's faceoff measured them to win
(``ops/cuda/fused_svgd_bign_kernel.bign_wins``).
"""

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def _unset(name):
    return os.environ.get(name, "").lower() in ("", "0", "false", "no")


def kernels_enabled():
    return _unset("PACOH_TORCH_DISABLE_KERNELS")


def fused_enabled():
    return kernels_enabled() and _unset("PACOH_TORCH_DISABLE_FUSED")


def force_bign_fused():
    return not _unset("PACOH_TORCH_FORCE_BIGN_FUSED")
