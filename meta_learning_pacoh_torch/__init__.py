"""PACOH meta-learning of Gaussian-process priors in PyTorch, with hand-written CUDA kernels.

The port of ``meta_learning_pacoh_tpu`` (JAX on the TPU, which stays the
reference) to PyTorch on an NVIDIA Hopper GPU. Its modules mirror the JAX
package's layout; the Pallas kernels of ``ops/pallas/`` become CUDA C++
kernels in ``csrc/``, wrapped in ``ops/cuda/``. The meta-learners (PACOH-MAP,
PACOH-SVGD, PACOH-VI and PACOH-MLAP) expose the same constructor keywords plus
``device=`` (the card by default, ``"cpu"`` for the CPU), and ``meta_fit /
predict / eval / eval_datasets / confidence_intervals / state_dict /
load_state_dict``; the single-task learners (GPR-MLL, GPR-PAC) ``fit /
predict / eval / confidence_intervals / state_dict / load_state_dict``. The
custom mean and kernel modules plug into GPR-MLL and PACOH-MAP. The
reference paper's baselines MAML and the Neural Process learner (with the
image NP of ``models/neural_process_img.py`` and its data in
``datasets/np_image_data.py``) run no hand-written kernel: MAML's
``eval`` and ``eval_datasets`` return one RMSE, and its ``predict`` the
(adapted, initial) means. ``parallel.fit_models_parallel`` fits S learners
of one configuration at once (seeds, stacked on a leading axis);
``utils.tuning_parallel`` fits tuning trials that way, ``utils.tuning``
suggests and runs them, ``utils.experiment`` keeps the runs' files and
``utils.profiling`` traces and times them.
"""

from meta_learning_pacoh_torch import config  # noqa: F401  (pins float32 precision)
from meta_learning_pacoh_torch.algos.gpr_mll import GPRegressionLearned
from meta_learning_pacoh_torch.algos.gpr_pac import GPRegressionLearnedPAC
from meta_learning_pacoh_torch.algos.maml import MAMLRegression
from meta_learning_pacoh_torch.algos.npr import NPRegressionMetaLearned
from meta_learning_pacoh_torch.algos.pacoh_map import GPRegressionMetaLearned
from meta_learning_pacoh_torch.algos.pacoh_mlap import GPRegressionMetaLearnedPAC
from meta_learning_pacoh_torch.algos.pacoh_svgd import GPRegressionMetaLearnedSVGD
from meta_learning_pacoh_torch.algos.pacoh_vi import GPRegressionMetaLearnedVI
from meta_learning_pacoh_torch.models.modules import (
    CosineKernel,
    KernelModule,
    LinearMean,
    MaternKernel,
    MeanModule,
)

__version__ = "0.1.0"

__all__ = ["CosineKernel", "KernelModule", "LinearMean", "MaternKernel", "MeanModule",
           "GPRegressionMetaLearned", "GPRegressionMetaLearnedPAC", "GPRegressionMetaLearnedSVGD",
           "GPRegressionMetaLearnedVI", "GPRegressionLearned", "GPRegressionLearnedPAC",
           "MAMLRegression", "NPRegressionMetaLearned"]
