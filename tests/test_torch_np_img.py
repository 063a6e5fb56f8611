"""The port's image Neural Process and its data against the JAX package's.

The mask utilities and the data loaders are numpy copies: one
``RandomState`` (or one set of files) gives byte-equal arrays in both
packages. The model, its trainer and ``inpaint`` run from the JAX model's
parameters (``interop.np_params_from_jax``) with the JAX side's latent
noise fed in (a key a call, ``split`` a batch, ``normal``), and the
trainer's masks come from the model's own ``RandomState``, as in JAX. The
files are synthetic and written to ``tmp_path``, as
tests/test_np_image_data.py writes them. Tolerances: the losses and
predictions rtol 1e-5 (atol 1e-6 near 0), float32 sums in another order;
the parameters after the Adam steps within 1e-5 (a hundredth of one step's
reach at lr 1e-3).
"""

import gzip
import struct

import jax
import numpy as np
import pytest
import torch

from meta_learning_pacoh_tpu.datasets import data_sim as jax_data_sim
from meta_learning_pacoh_tpu.datasets import np_image_data as jax_data
from meta_learning_pacoh_tpu.models import neural_process_img as jax_img
from meta_learning_pacoh_torch.datasets import data_sim as port_data_sim
from meta_learning_pacoh_torch.datasets import np_image_data as port_data
from meta_learning_pacoh_torch.interop import np_params_from_jax
from meta_learning_pacoh_torch.models import neural_process_img as port_img
from meta_learning_pacoh_torch.models.random_gp import unravel_flat

IMG = (1, 8, 8)
DIMS = dict(r_dim=16, z_dim=8, h_dim=16)


def _images(n, seed=0):
    """Synthetic 1-channel 8 x 8 images in [0, 1]."""
    return np.random.RandomState(seed).uniform(size=(n,) + IMG).astype(np.float32)


def _pair(seed=3):
    """The JAX model and the port's with the JAX parameters."""
    jax_model = jax_img.NeuralProcessImg(IMG, random_seed=seed, **DIMS)
    port = port_img.NeuralProcessImg(IMG, random_seed=seed, device="cpu", **DIMS)
    port.load_params(np_params_from_jax(jax_model.params))
    return jax_model, port


def _feed_noise(port, jax_model, batch_sizes):
    """Give the port the latents of the JAX model's next calls: one key a
    call, split into a key an image for a batch (None: one latent)."""
    key, queue = jax_model._key, []
    for size in batch_sizes:
        key, sub = jax.random.split(key)
        keys = sub[None] if size is None else jax.random.split(sub, size)
        queue.append(torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.normal(k, (port.z_dim,)))(keys))))
    port._latent_noise = lambda n: queue.pop(0)


def _idx_file(path, images):
    raw = struct.pack(">IIII", 2051, *images.shape) + images.tobytes()
    with gzip.open(path, "wb") as f:
        f.write(raw)


def test_mask_utils_byte_equal_to_jax():
    """One ``RandomState`` gives the same masks and point sets in both
    packages, and ``xy_to_img`` scatters them back to the same images."""
    imgs = _images(3)
    got = [port_img.random_context_target_mask(IMG, 5, 7, np.random.RandomState(0))]
    want = [jax_img.random_context_target_mask(IMG, 5, 7, np.random.RandomState(0))]
    for repeat in (False, True):
        got.append(port_img.batch_context_target_mask(IMG, 5, 7, 3, repeat=repeat,
                                                      random_state=np.random.RandomState(1)))
        want.append(jax_img.batch_context_target_mask(IMG, 5, 7, 3, repeat=repeat,
                                                      random_state=np.random.RandomState(1)))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    cm, tm = got[1]
    for normalize in (True, False):
        for mask in (cm, tm):
            g = port_img.img_mask_to_np_input(imgs, mask, normalize=normalize)
            w = jax_img.img_mask_to_np_input(imgs, mask, normalize=normalize)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    x, y = port_img.img_mask_to_np_input(imgs, tm)
    rec = port_img.xy_to_img(x, y, IMG)
    assert rec.tobytes() == jax_img.xy_to_img(x, y, IMG).tobytes()
    for i in range(3):
        m = tm[i].astype(bool)
        np.testing.assert_allclose(rec[i, 0][m], imgs[i, 0][m], atol=1e-6)


def test_elbo_loss_trainer_steps_and_inpaint_match_jax():
    """From the JAX parameters with the JAX latents: ``forward_loss``, two
    epochs of the trainer over two batches (its masks drawn from the model's
    ``RandomState`` in both packages), and ``inpaint``."""
    imgs = _images(8)
    jax_model, port = _pair()
    cm, tm = jax_img.batch_context_target_mask(IMG, 6, 9, 4,
                                               random_state=np.random.RandomState(5))
    _feed_noise(port, jax_model, [4])
    np.testing.assert_allclose(port.forward_loss(imgs[:4], cm, tm),
                               jax_model.forward_loss(imgs[:4], cm, tm), rtol=1e-5)

    kw = dict(lr=1e-3, num_context_range=(4, 9), num_extra_target_range=(5, 12))
    jax_trainer = jax_img.NeuralProcessImgTrainer(jax_model, **kw)
    trainer = port_img.NeuralProcessImgTrainer(port, **kw)
    batches = [imgs[:4], imgs[4:]]
    _feed_noise(port, jax_model, [4] * 4)
    want = jax_trainer.train(batches, epochs=2)
    got = trainer.train(batches, epochs=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert trainer.steps == jax_trainer.steps == 4
    for k, v in unravel_flat(port.layout, port.params).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jax_model.params[k]), rtol=0, atol=1e-5)

    _feed_noise(port, jax_model, [None])
    got = port.inpaint(imgs[0], cm[0])
    want = jax_model.inpaint(imgs[0], cm[0])
    for g, w in zip(got, want):
        assert g.shape == IMG
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    assert np.all(got[1] > 0)


def test_np_elbo_given_split_gradient_matches_jax():
    """The image ELBO of a batch and its gradient, with the JAX latents fed
    in: the loss rtol 1e-5, the gradient within 1e-5 of its largest entry."""
    imgs = _images(4, seed=1)
    jax_model, port = _pair(seed=4)
    cm, tm = jax_img.batch_context_target_mask(IMG, 6, 9, 4,
                                               random_state=np.random.RandomState(6))
    xc, yc = jax_img.img_mask_to_np_input(imgs, cm)
    xt, yt = jax_img.img_mask_to_np_input(imgs, tm)
    key = jax.random.PRNGKey(11)
    loss_fn = lambda p: jax_model._batch_elbo(p, key, xc, yc, xt, yt)  # noqa: E731
    want, want_grad = jax.value_and_grad(loss_fn)(jax_model.params)
    eps = jax.vmap(lambda k: jax.random.normal(k, (port.z_dim,)))(jax.random.split(key, 4))
    port._latent_noise = lambda n: torch.from_numpy(np.array(eps))
    flat = port.params.detach().requires_grad_(True)
    got = port._batch_elbo(flat, *port._tensors(xc, yc, xt, yt))
    (grad,) = torch.autograd.grad(got, flat)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    grads = {k: v.numpy() for k, v in unravel_flat(port.layout, grad).items()}
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want_grad.values())
    for k, g in grads.items():
        assert np.abs(g - np.asarray(want_grad[k])).max() <= 1e-5 * scale, k


def test_image_loaders_byte_equal_to_jax(tmp_path):
    """``mnist_image_batches`` (a gzipped IDX3 file, resized 28 -> 16 and
    kept at 28), ``celeba_image_batches`` (jpgs, crop then resize),
    ``ImageBatches``' reshuffles and ``SineFunctionData``: the same bytes for
    the same seeds."""
    from PIL import Image

    rs = np.random.RandomState(0)
    _idx_file(tmp_path / "train-images-idx3-ubyte.gz",
              rs.randint(0, 256, size=(12, 28, 28), dtype=np.uint8))
    for i in range(6):
        arr = rs.randint(0, 256, size=(109, 89, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / f"{i:06d}.jpg")
    loaders = [
        lambda pkg, s: pkg.mnist_image_batches(batch_size=5, size=size, path_to_data=str(tmp_path),
                                               random_state=np.random.RandomState(s), limit=10)
        for size in (16, 28)
    ] + [lambda pkg, s: pkg.celeba_image_batches(str(tmp_path), batch_size=2, size=16, crop=40,
                                                 random_state=np.random.RandomState(s))]
    for load in loaders:
        got, want = load(port_data, 2), load(jax_data, 2)
        assert got.images.tobytes() == want.images.tobytes()
        for _ in range(2):  # two epochs, reshuffled alike
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    got = port_data.SineFunctionData(num_samples=5, num_points=20,
                                     random_state=np.random.RandomState(3))
    want = jax_data.SineFunctionData(num_samples=5, num_points=20,
                                     random_state=np.random.RandomState(3))
    assert len(got) == len(want) == 5
    for i in range(5):
        for a, b in zip(got[i], want[i]):
            assert a.tobytes() == b.tobytes()
    assert port_data.MNIST_DIR == port_data_sim.MNIST_DIR == jax_data_sim.MNIST_DIR


def test_model_defaults_to_the_card(monkeypatch):
    """Built without a device, the image NP lives on the card; with no card
    it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_img.NeuralProcessImg(IMG, **DIMS)
    assert port_img.NeuralProcessImg(IMG, device="cpu", **DIMS).params.device.type == "cpu"
