"""PACOH meta-learning of Gaussian-process priors in PyTorch, with hand-written CUDA kernels.

The port of ``meta_learning_pacoh_tpu`` (JAX on the TPU, which stays the
reference) to PyTorch on an NVIDIA Hopper GPU. Its modules mirror the JAX
package's layout; the Pallas kernels of ``ops/pallas/`` become CUDA C++
kernels in ``csrc/``, wrapped in ``ops/cuda/``. The learners expose the same
constructor keywords plus ``device=``, and ``meta_fit / predict / eval /
eval_datasets / state_dict / load_state_dict``.
"""

from meta_learning_pacoh_torch import config  # noqa: F401  (pins float32 precision)
from meta_learning_pacoh_torch.algos.pacoh_svgd import GPRegressionMetaLearnedSVGD

__version__ = "0.1.0"

__all__ = ["GPRegressionMetaLearnedSVGD"]
