"""Datasets of the image and 1-D Neural Process (a numpy copy of meta_learning_pacoh_tpu/datasets/np_image_data.py).

The port carries its own copy because importing the JAX package's module
imports jax; the random draws are made in the same order, so a seed gives
byte-equal arrays in both packages.

- `SineFunctionData`   — the 1-D toy: f(x) = a sin(x - b), a/b uniform
                         (reference: third_party/neural_processes/datasets.py:10-59).
- `mnist_image_batches` — MNIST images as re-iterable [B, 1, S, S] batches
                         (datasets.py:62-89), parsed from local IDX files
                         by `data_sim._parse_idx_images`; no torchvision.
- `celeba_image_batches` — CelebA jpgs, center-crop then resize
                         (datasets.py:92-149), via PIL, imported on call.
- `ImageBatches`       — the DataLoader replacement: batches of one shape
                         (drop-last), reshuffled each epoch.

All loaders return channel-first [B, C, H, W] float arrays in [0, 1], the
layout `models/neural_process_img.py` consumes.
"""

import glob
import os

import numpy as np

from meta_learning_pacoh_torch.datasets.data_sim import (
    MNIST_DIR,
    _parse_idx_images,
)


class SineFunctionData:
    """f(x) = a sin(x - b) sampled on a fixed [-pi, pi] grid.

    Reference: datasets.py:10-59 (SineData). Indexing returns
    (x [num_points, 1], y [num_points, 1]) float32 arrays.
    """

    def __init__(self, amplitude_range=(-1.0, 1.0), shift_range=(-0.5, 0.5),
                 num_samples=1000, num_points=100, random_state=None):
        rs = random_state or np.random.RandomState()
        a_min, a_max = amplitude_range
        b_min, b_max = shift_range
        x = np.linspace(-np.pi, np.pi, num_points,
                        dtype=np.float32)[:, None]
        self.data = []
        for _ in range(num_samples):
            a = (a_max - a_min) * rs.rand() + a_min
            b = (b_max - b_min) * rs.rand() + b_min
            self.data.append((x, (a * np.sin(x - b)).astype(np.float32)))
        self.num_samples = num_samples
        self.x_dim = self.y_dim = 1

    def __getitem__(self, index):
        return self.data[index]

    def __len__(self):
        return self.num_samples


class ImageBatches:
    """Re-iterable static-shape batch stream over [N, C, H, W] images.

    Each iteration (epoch) yields floor(N / batch_size) batches of exactly
    `batch_size` images (drop-last), reshuffled when `shuffle`: the stand-in
    for the reference's torch DataLoader (datasets.py:85-89).
    """

    def __init__(self, images, batch_size=16, shuffle=True,
                 random_state=None):
        assert images.ndim == 4, "expected [N, C, H, W]"
        self.images = np.asarray(images, np.float32)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._rs = random_state or np.random.RandomState()

    def __len__(self):
        return len(self.images) // self.batch_size

    def __iter__(self):
        idx = np.arange(len(self.images))
        if self.shuffle:
            self._rs.shuffle(idx)
        n_full = len(self) * self.batch_size
        for start in range(0, n_full, self.batch_size):
            yield self.images[idx[start:start + self.batch_size]]


def _resize_nearest(images, size):
    """[N, H, W, C] -> [N, size, size, C] nearest-neighbor (numpy only)."""
    n, h, w, _ = images.shape
    if h == size and w == size:
        return images
    ri = (np.arange(size) * (h / size)).astype(np.int64).clip(0, h - 1)
    ci = (np.arange(size) * (w / size)).astype(np.int64).clip(0, w - 1)
    return images[:, ri][:, :, ci]


def mnist_image_batches(batch_size=16, size=28, path_to_data=None,
                        train=True, shuffle=True, random_state=None,
                        limit=None):
    """MNIST images as an `ImageBatches` stream of [B, 1, size, size].

    Reference: datasets.py:62-89 (`mnist`). Parses the raw IDX files under
    `path_to_data` (default: the repo's data/mnist directory) — zero
    torchvision dependence.
    """
    mnist_dir = path_to_data or MNIST_DIR
    names = (("train-images-idx3-ubyte.gz", "train-images-idx3-ubyte")
             if train else
             ("t10k-images-idx3-ubyte.gz", "t10k-images-idx3-ubyte"))
    path = None
    for name in names:
        p = os.path.join(mnist_dir, name)
        if os.path.exists(p):
            path = p
            break
    if path is None:
        raise FileNotFoundError(
            f"MNIST idx files not found in {mnist_dir} (looked for {names})")
    imgs = _parse_idx_images(path).astype(np.float32) / 255.0  # [N, H, W]
    if limit is not None:
        imgs = imgs[:limit]
    imgs = _resize_nearest(imgs[..., None], size)  # [N, S, S, 1]
    imgs = np.transpose(imgs, (0, 3, 1, 2))        # [N, 1, S, S]
    return ImageBatches(imgs, batch_size=batch_size, shuffle=shuffle,
                        random_state=random_state)


def celeba_image_batches(path_to_data, batch_size=16, size=32, crop=89,
                         shuffle=True, random_state=None, subsample=1,
                         limit=None):
    """CelebA jpgs as an `ImageBatches` stream of [B, 3, size, size].

    Reference: datasets.py:92-149 (`celeba` + CelebADataset): center-crop
    to `crop` x `crop` BEFORE resizing to `size` x `size`.
    """
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(path_to_data, "*.jpg")))[::subsample]
    if limit is not None:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no .jpg files under {path_to_data}")
    out = []
    for p in paths:
        img = Image.open(p)
        w, h = img.size
        left, top = (w - crop) // 2, (h - crop) // 2
        img = img.crop((left, top, left + crop, top + crop))
        img = img.resize((size, size), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
        if arr.ndim == 2:  # grayscale jpg -> replicate to 3 channels
            arr = np.repeat(arr[..., None], 3, axis=-1)
        out.append(np.transpose(arr[..., :3], (2, 0, 1)))
    return ImageBatches(np.stack(out), batch_size=batch_size,
                        shuffle=shuffle, random_state=random_state)
