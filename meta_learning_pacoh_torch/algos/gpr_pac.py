"""Single-task PAC-Bayes GP: a variational posterior trained on McAllester's
bound (counterpart of meta_learning_pacoh_tpu/algos/gpr_pac.py).

A variational Gaussian q(f) = N(q_mean, L L^T) at the training inputs,
L = tril(q_chol), and the GP prior's parameters are trained together on

    loss = -sum_i E_q[log N(y_i | f_i, sigma^2)]
           + sqrt((KL(q || prior) + log(2 sqrt(n) / delta)) / (2 n)),

with the optimizer groups of ``gpr_mll`` (q_mean and q_chol in the
hyperparameter group: q_chol's upper triangle takes no gradient but still
decays by 0.01, as in the JAX learner). The flat vector is the JAX
parameter tree {'gp', 'q_chol', 'q_mean'} in ``ravel_pytree`` order.

The KL factors the prior Gram through ``safe_cholesky`` (ops/variational.py),
so with 65-512 training points every step runs K4 three times (two trial
factorizations and the final one); ``predict`` goes through
``svgp_predict``.
"""

import math

import torch

from meta_learning_pacoh_torch.algos.base import check_choice
from meta_learning_pacoh_torch.algos.gpr_mll import SingleTaskLearner, param_group
from meta_learning_pacoh_torch.models.gp_base import (
    GPConfig,
    gp_gram,
    gp_mean,
    gp_noise,
    init_gp_params,
)
from meta_learning_pacoh_torch.models.random_gp import ravel_flat, tree_layout, unravel_flat
from meta_learning_pacoh_torch.ops.chol import cholesky
from meta_learning_pacoh_torch.ops.variational import (
    expected_log_prob_gaussian,
    gaussian_kl_chol,
    svgp_predict,
)


class GPRegressionLearnedPAC(SingleTaskLearner):

    def __init__(self, train_x, train_t, learning_mode="both", lr=1e-3, delta=0.1,
                 weight_decay=0.0, feature_dim=2, num_iter_fit=1000, covar_module="NN",
                 mean_module="NN", mean_nn_layers=(32, 32), kernel_nn_layers=(32, 32),
                 optimizer="Adam", normalize_data=True, lr_scheduler=True, random_seed=None,
                 device=None):
        """device: where the parameters, the data and the computation live
        ('cuda', 'cpu', a torch.device); None means the card, and raises
        without one."""
        super().__init__(train_x, train_t, learning_mode, lr, weight_decay, num_iter_fit,
                         optimizer, normalize_data, lr_scheduler, random_seed, device)
        check_choice("mean_module", mean_module, ("NN", "constant", "zero"))
        check_choice("covar_module", covar_module, ("NN", "SE"))
        self.delta = delta
        self.cfg = GPConfig(input_dim=self.input_dim, feature_dim=feature_dim,
                            mean_module=mean_module, covar_module=covar_module,
                            mean_nn_layers=tuple(mean_nn_layers),
                            kernel_nn_layers=tuple(kernel_nn_layers),
                            has_outputscale=True, noise_floor=1e-4)
        n = self.n_train_samples
        tree = {"gp": init_gp_params(self.cfg, self._generator),
                "q_mean": torch.zeros(n), "q_chol": torch.zeros(n, n)}
        self.layout = tree_layout(tree)
        self.params = ravel_flat(self.layout, tree).to(self.device)
        # q(f) starts at the prior: its mean, and the factor of its Gram + 1e-3 I
        with torch.no_grad():
            p = unravel_flat(self.layout, self.params[None])
            x = self.train_x[None]
            p["q_mean"].copy_(gp_mean(self.cfg, p["gp"], x))
            eye = torch.eye(n, device=self.device)
            p["q_chol"].copy_(cholesky(gp_gram(self.cfg, p["gp"], x) + 1e-3 * eye))
        self._setup_optimizer([param_group(path[1], learning_mode) if path[0] == "gp"
                               else "hyper" for path, _, _, _ in self.layout])
        self._aux = None

    def _pac_loss(self, params):
        """(bound, (expected log-likelihood, KL)) at flat ``params`` [P]."""
        p = unravel_flat(self.layout, params[None])
        gp, n = p["gp"], float(self.n_train_samples)
        noise = gp_noise(self.cfg, gp)  # [1]
        q_mean, q_chol = p["q_mean"], torch.tril(p["q_chol"])
        f_var = torch.sum(q_chol ** 2, dim=-1)
        ll = torch.sum(expected_log_prob_gaussian(self.train_t, q_mean, f_var, noise[:, None]))
        x = self.train_x[None]
        kl = gaussian_kl_chol(q_mean, q_chol, gp_mean(self.cfg, gp, x),
                              gp_gram(self.cfg, gp, x))[0]
        bound = -ll + torch.sqrt((kl + math.log(2.0 * math.sqrt(n) / self.delta)) / (2.0 * n))
        return bound, (ll, kl)

    def _loss(self, params):
        bound, aux = self._pac_loss(params)
        self._aux = tuple(a.detach() for a in aux)
        return bound

    def _fit_message(self):
        ll, kl = self._aux
        return " - LL: %.3f - KL: %.3f" % (float(ll), float(kl))

    def _predict_moments(self, test_xn):
        p = unravel_flat(self.layout, self.params[None])
        gp, xc, xt = p["gp"], self.train_x[None], test_xn[None]
        mean, cov = svgp_predict(p["q_mean"], torch.tril(p["q_chol"]), gp_mean(self.cfg, gp, xc),
                                 gp_gram(self.cfg, gp, xc), gp_gram(self.cfg, gp, xc, xt),
                                 gp_mean(self.cfg, gp, xt), gp_gram(self.cfg, gp, xt))
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        return mean[0], cov[0] + gp_noise(self.cfg, gp)[0] * eye
