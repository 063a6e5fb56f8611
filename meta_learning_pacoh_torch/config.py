"""Runtime configuration of the PyTorch port (counterpart of meta_learning_pacoh_tpu/config.py).

GP numerics need true float32: a reduced-precision matrix product (TF32 on
the card) destroys the conditioning of the N x N Gram matrices and NaNs the
factorization, so importing the package pins full-precision products.

``kernels_enabled()`` mirrors ``PACOH_TPU_DISABLE_PALLAS``: the hand-written
CUDA kernels are on unless ``PACOH_TORCH_DISABLE_KERNELS`` is set, which
sends every dispatch point to its plain PyTorch version (the twin that
``chip_smoke.py`` compares the kernel path with).
"""

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def kernels_enabled():
    val = os.environ.get("PACOH_TORCH_DISABLE_KERNELS", "")
    return val.lower() in ("", "0", "false", "no")
