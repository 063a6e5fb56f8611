"""Input-shape handling shared by all learners (a copy of meta_learning_pacoh_tpu/utils/input_handling.py).

Behavioral parity with the reference's dimensionality promotion
(reference: meta_learn/util.py:44-58): 1-D arrays are promoted to 2-D
column layout, and x/y row counts must agree.
"""

import numpy as np


def handle_input_dim(x, y=None):
    """Promote 1-D arrays to 2-D (n, 1) and validate shapes.

    Returns x (and y if given) as float32 numpy arrays of rank 2.
    """
    x = np.asarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[:, None]
    assert x.ndim == 2, f"x must be 1- or 2-dimensional, got ndim={x.ndim}"

    if y is None:
        return x

    y = np.asarray(y, dtype=np.float32)
    if y.ndim == 1:
        y = y[:, None]
    assert y.ndim == 2, f"y must be 1- or 2-dimensional, got ndim={y.ndim}"
    assert x.shape[0] == y.shape[0], (
        f"x and y must have the same number of rows: {x.shape[0]} vs {y.shape[0]}"
    )
    return x, y


def stack_task_tuples(task_tuples):
    """Stack a list of (x_i, y_i) tuples of possibly-ragged sizes into padded
    dense arrays plus a validity mask.

    Returns (X, Y, mask):
      X    [T, N_max, D] float32, zero-padded
      Y    [T, N_max]    float32, zero-padded (y flattened; output_dim must be 1)
      mask [T, N_max]    float32, 1.0 where real data

    Padding with a mask keeps every task the same static shape so the whole
    meta-batch lives in a single [T, N, D] tensor that `vmap`/`pjit` can
    shard and the XLA compiler can tile onto the MXU. The reference instead
    kept a Python list of per-task tensors (meta_learn/GPR_meta_mll.py:59-74).
    """
    tasks = [handle_input_dim(x, y) for x, y in task_tuples]
    n_max = max(x.shape[0] for x, _ in tasks)
    d = tasks[0][0].shape[1]
    T = len(tasks)
    X = np.zeros((T, n_max, d), dtype=np.float32)
    Y = np.zeros((T, n_max), dtype=np.float32)
    mask = np.zeros((T, n_max), dtype=np.float32)
    for i, (x, y) in enumerate(tasks):
        assert y.shape[1] == 1, "only scalar regression targets supported"
        n = x.shape[0]
        X[i, :n] = x
        Y[i, :n] = y[:, 0]
        mask[i, :n] = 1.0
    return X, Y, mask
