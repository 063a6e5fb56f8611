"""Neural Processes for image completion, context pixels to the full image (counterpart of meta_learning_pacoh_tpu/models/neural_process_img.py).

The reference's vendored image-NP stack: ``NeuralProcessImg`` (reference:
third_party/neural_processes/neural_process.py:138-189), the mask
utilities ``img_mask_to_np_input`` / ``random_context_target_mask`` /
``batch_context_target_mask`` / ``xy_to_img`` (utils.py:37-196, numpy
copies of the JAX package's, so one ``RandomState`` draws the same masks in
both packages) and ``NeuralProcessImgTrainer`` (training.py:10-131), on
the NP core of models/neural_process.py.

Masks are index arrays with one point count a batch (the reference
requires every mask of a batch to expose the same number of pixels,
utils.py:50-53), so one batched pass covers the image batch. The
parameters and the Adam moments are flat vectors over the JAX parameter
dict's layout; the latent noise comes from a CPU generator seeded with the
model's seed (``_latent_noise``), on the model's device: the card unless
the caller names another (``device="cpu"``).
"""

import numpy as np
import torch

from meta_learning_pacoh_torch.algos.base import resolve_device
from meta_learning_pacoh_torch.models.neural_process import (
    _LOG_2PI,
    gaussian_kl,
    init_np_params,
    np_decode,
    np_encode,
    np_predict,
)
from meta_learning_pacoh_torch.models.random_gp import ravel_flat, tree_layout, unravel_flat
from meta_learning_pacoh_torch.ops import cuda


# ----------------------------------------------------------------- mask utils


def img_mask_to_np_input(img, mask, normalize=True):
    """(img [B, C, H, W], mask [B, H, W] binary) -> (x [B, P, 2], y [B, P, C]).

    x holds (row, col) locations of visible pixels, y their intensities.
    Every mask must expose the SAME number P of pixels (reference contract,
    utils.py:50-53). normalize=True maps locations to [-1, 1] and
    intensities to [-0.5, 0.5] (utils.py:55-57). Host-side numpy.
    """
    img = np.asarray(img)
    mask = np.asarray(mask).astype(bool)
    b, c, h, w = img.shape
    xs, ys = [], []
    for i in range(b):
        rows, cols = np.nonzero(mask[i])
        xs.append(np.stack([rows, cols], axis=-1).astype(np.float32))
        ys.append(img[i, :, rows, cols].astype(np.float32))  # [P, C]
    P = xs[0].shape[0]
    assert all(x.shape[0] == P for x in xs), "masks must expose equal counts"
    x = np.stack(xs)  # [B, P, 2]
    y = np.stack(ys)  # [B, P, C]
    if normalize:
        x = (x - np.array([h / 2.0, w / 2.0], np.float32)) / np.array(
            [h / 2.0, w / 2.0], np.float32)
        y = y - 0.5
    return x, y


def random_context_target_mask(img_size, num_context, num_extra_target,
                               random_state=None):
    """Random binary (context, target) masks with context a subset of target
    (reference: utils.py:88-121)."""
    rs = random_state or np.random
    _, h, w = img_size
    measurements = rs.choice(h * w, size=num_context + num_extra_target,
                             replace=False)
    context_mask = np.zeros((h, w), np.uint8)
    target_mask = np.zeros((h, w), np.uint8)
    rows, cols = measurements // w, measurements % w
    target_mask[rows, cols] = 1
    context_mask[rows[:num_context], cols[:num_context]] = 1
    return context_mask, target_mask


def batch_context_target_mask(img_size, num_context, num_extra_target,
                              batch_size, repeat=False, random_state=None):
    """Batch of (context, target) masks (reference: utils.py:124-159)."""
    _, h, w = img_size
    cm = np.zeros((batch_size, h, w), np.uint8)
    tm = np.zeros((batch_size, h, w), np.uint8)
    if repeat:
        c, t = random_context_target_mask(img_size, num_context,
                                          num_extra_target, random_state)
        cm[:], tm[:] = c, t
    else:
        for i in range(batch_size):
            cm[i], tm[i] = random_context_target_mask(
                img_size, num_context, num_extra_target, random_state)
    return cm, tm


def xy_to_img(x, y, img_size):
    """Inverse of img_mask_to_np_input: scatter normalized (x, y) points back
    into [B, C, H, W] images; missing pixels are 0 (reference: utils.py:162-196)."""
    x, y = np.asarray(x), np.asarray(y)
    c, h, w = img_size
    b = x.shape[0]
    rows = np.clip((x[..., 0] * (h / 2.0) + h / 2.0).astype(int), 0, h - 1)
    cols = np.clip((x[..., 1] * (w / 2.0) + w / 2.0).astype(int), 0, w - 1)
    img = np.zeros((b, c, h, w), np.float32)
    for i in range(b):
        # advanced indexing puts the point axis first: result is [P, C]
        img[i, :, rows[i], cols[i]] = y[i] + 0.5
    return img


# ----------------------------------------------------------------------- ELBO


def np_elbo_given_split(params, eps, xc, yc, xt, yt):
    """NP training loss with an explicit context-subset/target split:
    -sum log p(y_t | z ~ q_target) + KL(q_target || q_context)
    (reference: training.py:110-131). Data [..., P, D], eps [..., Dz]
    the latent noise; returns [...]."""
    mu_t, sig_t = np_encode(params, xt, yt)
    mu_c, sig_c = np_encode(params, xc, yc)
    mu_y, sig_y = np_decode(params, xt, mu_t + sig_t * eps)
    log_lik = torch.sum(-0.5 * ((yt - mu_y) / sig_y) ** 2 - torch.log(sig_y) - 0.5 * _LOG_2PI,
                        dim=(-2, -1))
    return -log_lik + gaussian_kl(mu_t, sig_t, mu_c, sig_c)


# ----------------------------------------------------------------------- model


class NeuralProcessImg:
    """Image-completion NP: x = normalized pixel locations, y = intensities
    (reference: neural_process.py:138-189)."""

    def __init__(self, img_size, r_dim=128, z_dim=128, h_dim=128, random_seed=None,
                 device=None):
        """device: where the parameters and the computation live; None means
        the card, and raises without one."""
        self.img_size = tuple(img_size)
        self.num_channels = img_size[0]
        self.z_dim = z_dim
        self.device = resolve_device(device)
        self._generator = torch.Generator().manual_seed(0 if random_seed is None
                                                        else int(random_seed))
        params = init_np_params(self._generator, x_dim=2, y_dim=self.num_channels,
                                r_dim=r_dim, z_dim=z_dim, h_dim=h_dim)
        self.layout = tree_layout(params)
        self.params = ravel_flat(self.layout, params).to(self.device)
        self._rng = np.random.RandomState(random_seed)

    def load_params(self, params):
        """Take the parameters of a dict of arrays with the JAX model's names,
        e.g. a JAX model's ``params`` (``interop.np_params_from_jax``)."""
        self.params = ravel_flat(self.layout, {
            k: torch.as_tensor(np.asarray(v, dtype=np.float32)) for k, v in params.items()
        }).to(self.device)

    def _latent_noise(self, n):
        """[n, z_dim] standard normals from the model's generator, on its device."""
        return torch.randn(n, self.z_dim, generator=self._generator).to(self.device)

    def _tensors(self, *arrays):
        return [torch.as_tensor(np.asarray(a, dtype=np.float32), device=self.device)
                for a in arrays]

    def _batch_elbo(self, flat, XC, YC, XT, YT):
        """The mean ELBO loss of a batch of point sets at flat parameters."""
        eps = self._latent_noise(XC.shape[0])
        return torch.mean(np_elbo_given_split(unravel_flat(self.layout, flat), eps,
                                              XC, YC, XT, YT))

    @torch.no_grad()
    def forward_loss(self, img, context_mask, target_mask):
        """Mean ELBO loss of a batch given explicit masks."""
        xc, yc = img_mask_to_np_input(img, context_mask)
        xt, yt = img_mask_to_np_input(img, target_mask)
        return float(self._batch_elbo(self.params, *self._tensors(xc, yc, xt, yt)))

    @torch.no_grad()
    def inpaint(self, img, context_mask):
        """Complete a single image from its visible (context) pixels:
        predicts intensities at ALL pixel locations. img [C, H, W],
        context_mask [H, W] -> (mean_img, sigma_img) [C, H, W]."""
        c, h, w = self.img_size
        xc, yc = img_mask_to_np_input(img[None], context_mask[None])
        rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        x_all = np.stack([rows.ravel(), cols.ravel()], -1).astype(np.float32)
        x_all = (x_all - np.array([h / 2.0, w / 2.0], np.float32)) / np.array(
            [h / 2.0, w / 2.0], np.float32)
        xc, yc, x_all = self._tensors(xc[0], yc[0], x_all)
        mu, sigma = np_predict(unravel_flat(self.layout, self.params),
                               self._latent_noise(1)[0], xc, yc, x_all)
        mu = mu.cpu().numpy().T.reshape(c, h, w) + 0.5
        sigma = sigma.cpu().numpy().T.reshape(c, h, w)
        return mu, sigma


class NeuralProcessImgTrainer:
    """Epoch trainer for image NPs (reference: training.py:10-105): per batch,
    sample (num_context, num_extra_target) uniformly from the given ranges
    with the model's ``RandomState``, build random masks, take one Adam step
    on the mean ELBO loss."""

    def __init__(self, neural_process, lr=1e-3, num_context_range=(3, 50),
                 num_extra_target_range=(5, 50), print_freq=100):
        self.np_img = neural_process
        self.lr = lr
        self.num_context_range = num_context_range
        self.num_extra_target_range = num_extra_target_range
        self.print_freq = print_freq
        self._mu = torch.zeros_like(neural_process.params)
        self._nu = torch.zeros_like(neural_process.params)
        self._adam_count = 0
        self.steps = 0
        self.epoch_loss_history = []

    def _step(self, xc, yc, xt, yt):
        """One Adam step on a batch of point sets; returns the loss (a device scalar)."""
        m = self.np_img
        flat = m.params.detach().requires_grad_(True)
        loss = m._batch_elbo(flat, *m._tensors(xc, yc, xt, yt))
        (grad,) = torch.autograd.grad(loss, flat)
        self._adam_count += 1
        with torch.no_grad():
            cuda.adam_step_(m.params, self._mu, self._nu, grad, self._adam_count, self.lr)
        return loss.detach()

    def train(self, batches, epochs, verbose=False):
        """batches: iterable of [B, C, H, W] numpy arrays (pixel values in
        [0, 1]); re-iterated each epoch."""
        m = self.np_img
        rs = m._rng
        for _ in range(epochs):
            epoch_loss, n_batches = 0.0, 0
            for img in batches:
                num_context = rs.randint(*self.num_context_range)
                num_extra = rs.randint(*self.num_extra_target_range)
                cm, tm = batch_context_target_mask(
                    m.img_size, num_context, num_extra, img.shape[0], random_state=rs)
                xc, yc = img_mask_to_np_input(img, cm)
                xt, yt = img_mask_to_np_input(img, tm)
                loss = float(self._step(xc, yc, xt, yt))
                epoch_loss += loss
                n_batches += 1
                self.steps += 1
                if verbose and self.steps % self.print_freq == 0:
                    print(f"iteration {self.steps}, loss {loss:.3f}")
            self.epoch_loss_history.append(epoch_loss / max(n_batches, 1))
        return self.epoch_loss_history
