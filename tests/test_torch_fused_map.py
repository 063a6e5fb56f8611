"""The port's fused PACOH-MAP training kernel against the JAX package's.

On the CPU ``fused_map_train`` takes its plain version (autograd of
``gp_prior_mll_batch``, the AdamW update of the TPU kernel); the JAX side
runs the Pallas kernel ``fused_map_train_packed`` in interpret mode, as the
JAX package's own tests do, on state packed with its ``pack_state``. Inputs
come from numpy seeds at a small size: T=4 tasks of N=5 points, D=1, F=2,
both nets (8, 8); and the odd shape of chip_smoke.py's phase 2.

Parameter comparisons leave out the kernel net's output bias: its true
gradient is exactly zero, so both sides random-walk float noise there
(tests/test_fused_map.py, ``_drop_degenerate``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from meta_learning_pacoh_tpu import GPRegressionMetaLearned as JaxMAP
from meta_learning_pacoh_tpu.models import gp_base as jax_gp_base
from meta_learning_pacoh_tpu.ops.pallas import launch_sched as jax_sched
from meta_learning_pacoh_tpu.ops.pallas.fused_map_kernel import (
    FusedMAPTrainer as JaxTrainer,
    fused_map_train_packed,
    pack_state,
    unpack_state,
)
from meta_learning_pacoh_tpu.utils import jit_cache
from meta_learning_pacoh_torch import GPRegressionMetaLearned
from meta_learning_pacoh_torch.datasets import SinusoidDataset
from meta_learning_pacoh_torch.models.random_gp import layout_slice
from meta_learning_pacoh_torch.ops import launch_sched
from meta_learning_pacoh_torch.ops.cuda import fused_map_kernel as mk

LR, WD = 1e-3, 0.2
SMALL = dict(t=4, n=5, d=1, f=2, mh=(8, 8), kh=(8, 8))
ODD = dict(t=7, n=8, d=3, f=3, mh=(16, 16, 16), kh=(32, 32))


def _case(seed, t, n, d, f, mh, kh, ragged=True):
    """Tasks, a parameter vector drawn as torch.nn.Linear draws its init
    (raw hyperparameters near 0), and small non-zero AdamW moments."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(-2.0, 2.0, (t, n, d)).astype(np.float32)
    y = (np.sin(2.0 * x.sum(-1)) + 0.1 * rs.randn(t, n)).astype(np.float32)
    mask = np.ones((t, n), np.float32)
    if ragged:  # padded points as the learner pads them: zero input and target
        mask[1, n - 2:] = 0.0
        x[mask == 0], y[mask == 0] = 0.0, 0.0
    layout = mk.map_layout(d, f, mh, kh)
    theta = np.concatenate([
        rs.uniform(-1.0, 1.0, size) / np.sqrt(_fan_in(layout, path))
        if path[0] in ("mean_nn", "kernel_nn") else 0.1 * rs.randn(size)
        for path, _, _, size in layout]).astype(np.float32)
    mu = (0.01 * rs.randn(theta.size)).astype(np.float32)
    nu = (1e-4 * rs.rand(theta.size)).astype(np.float32)
    return (x, y, mask), (theta, mu, nu), layout


def _fan_in(layout, path):
    """fan_in of an MLP leaf: the rows of its layer's weight."""
    shapes = {p: s for p, s, _, _ in layout}
    return shapes[path[:-1] + ("w_" + path[-1][2:],)][0]


def _jax_unravel(d, f, mh, kh):
    cfg = jax_gp_base.GPConfig(input_dim=d, feature_dim=f, mean_nn_layers=mh, kernel_nn_layers=kh)
    flat, unravel = ravel_pytree(jax_gp_base.init_gp_params(cfg, jax.random.PRNGKey(0)))
    return cfg, unravel, flat.size


def _jax_steps(data, state, case, step0, n_steps, lr=LR, counts=None):
    """n_steps of the Pallas kernel in interpret mode -> flat (theta, m, v), last loss."""
    (x, y, mask), (t, n, d, f, mh, kh) = data, (case[k] for k in ("t", "n", "d", "f", "mh", "kh"))
    _, unravel, p = _jax_unravel(d, f, mh, kh)
    assert p == state[0].size
    packed = [pack_state(unravel(jnp.asarray(a)), mh, kh) for a in state]
    pages = None
    if counts is not None:  # [n_steps, Tpad8, 128], counts in lane 0
        pages = np.zeros((n_steps, -(-t // 8) * 8, 128), np.float32)
        pages[:, :t, 0] = counts
        pages = jnp.asarray(pages)

    def n_major(a):
        return jnp.asarray(np.transpose(a, (1, 0, 2)).reshape(n * t, -1))

    w_t = mk.task_weights(mask).reshape(t, 1)
    out = fused_map_train_packed(
        *packed, n_major(x), n_major(y[..., None]), n_major(mask[..., None]), jnp.asarray(w_t),
        float(step0), T=t, N=n, D=d, F=f, mean_hidden=mh, kernel_hidden=kh, lr=lr,
        weight_decay=WD, noise_floor=1e-3, n_steps=n_steps, counts_pages=pages,
        interpret=True)
    flat = [np.asarray(ravel_pytree(unpack_state(o, mh, kh))[0]) for o in out[:3]]
    return flat, float(out[3])


def _port_steps(data, state, case, step0, n_steps, lr=LR, counts=None):
    x, y, mask = (torch.from_numpy(a) for a in data)
    got = [torch.from_numpy(a.copy()) for a in state]
    layout = mk.map_layout(case["d"], case["f"], case["mh"], case["kh"])
    last, _ = mk.fused_map_train(*got, x, y, mask, torch.from_numpy(mk.task_weights(data[2])),
                                 step0, lr, WD, None if counts is None else torch.tensor(counts),
                                 layout=layout, n_steps=n_steps)
    return [g.numpy() for g in got], float(last)


def _keep(case):
    layout = mk.map_layout(case["d"], case["f"], case["mh"], case["kh"])
    keep = np.ones(layout[-1][2] + layout[-1][3], bool)
    keep[layout_slice(layout, ("kernel_nn", "b_out"))] = False
    return keep


def test_layout_and_gradient_of_one_step():
    """From one state: the loss the plain version reports for its first step
    equals the Pallas kernel's and -sum of the JAX ``gp_prior_mll_batch``
    (rtol 1e-5, float32 sums in another order); the AdamW moment m after one
    step from m = 0 is 0.1 times the gradient, which matches jax.grad of
    that loss (atol 1e-5 of the leaf's scale); the updated parameters match
    the kernel's at atol 1e-5."""
    data, state, _ = _case(1, **SMALL)
    state = (state[0], np.zeros_like(state[1]), np.zeros_like(state[2]))
    (theta, m, _), loss = _port_steps(data, state, SMALL, 0, 1)
    (j_theta, j_m, _), j_loss = _jax_steps(data, state, SMALL, 0, 1)
    cfg, unravel, _ = _jax_unravel(1, 2, (8, 8), (8, 8))
    x, y, mask = (jnp.asarray(a) for a in data)

    def jax_loss(flat):
        return -jnp.sum(jax_gp_base.gp_prior_mll_batch(cfg, unravel(flat), x, y, mask))

    want_loss, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(state[0]))
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(j_loss, float(want_loss), rtol=1e-5)
    want_grad = np.asarray(want_grad)
    layout = mk.map_layout(1, 2, (8, 8), (8, 8))
    for path, _, offset, size in layout:
        sl = slice(offset, offset + size)
        scale = max(float(np.abs(want_grad[sl]).max()), 1e-3)
        np.testing.assert_allclose(m[sl] / 0.1, want_grad[sl], rtol=0, atol=1e-5 * scale + 1e-6,
                                   err_msg=str(path))
    keep = _keep(SMALL)
    np.testing.assert_allclose(theta[keep], j_theta[keep], rtol=0, atol=1e-5)
    np.testing.assert_allclose(m, j_m, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["full_batch", "counted"])
def test_trajectory_matches_pallas_kernel(mode):
    """20 steps from one state (non-zero moments, step 7). Parameters atol
    3e-4, a few lr quanta of Adam's sign-like early steps, the tolerance of
    tests/test_fused_map.py:144-147; AdamW moments atol 5e-4 of their scale
    plus 1e-4 (the same file); the last loss rtol 1e-5. The counted mode
    feeds the port the JAX trainer's own count pages (``_make_counts``:
    fold_in + randint), a batch of 3."""
    data, state, _ = _case(2, **SMALL)
    counts = None
    if mode == "counted":
        x, y, mask = (jnp.asarray(a) for a in data)
        cfg, unravel, _ = _jax_unravel(1, 2, (8, 8), (8, 8))
        trainer = JaxTrainer(unravel(jnp.asarray(state[0])), x, y, mask, feature_dim=2,
                             mean_hidden=(8, 8), kernel_hidden=(8, 8), lr=LR, weight_decay=WD,
                             task_batch_size=3, base_key=jax.random.PRNGKey(5), interpret=True)
        counts = np.asarray(trainer._make_counts(trainer.base_key, 7, 20))[:, :4, 0]
        assert np.all(counts.sum(1) == 3) and np.any(counts == 0)
    got, loss = _port_steps(data, state, SMALL, 7, 20, counts=counts)
    want, j_loss = _jax_steps(data, state, SMALL, 7, 20, counts=counts)
    keep = _keep(SMALL)
    np.testing.assert_allclose(got[0][keep], want[0][keep], rtol=0, atol=3e-4)
    for g, w in zip(got[1:], want[1:]):
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(g[keep], w[keep], rtol=0, atol=5e-4 * scale + 1e-4)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    assert np.abs(got[0] - state[0])[keep].max() > 5e-3  # the steps moved it


def test_staircase_crossing_matches_pallas_kernel(monkeypatch):
    """12 steps across staircase boundaries (transition shrunk to 5 in both
    packages, lr_decay 0.5), one launch per stair as both trainers split
    them: parameters atol 3e-4 as above."""
    monkeypatch.setattr(launch_sched, "LR_TRANSITION_STEPS", 5)
    monkeypatch.setattr(jax_sched, "LR_TRANSITION_STEPS", 5)
    data, state, _ = _case(3, **SMALL)
    got, want = list(state), list(state)
    launches = list(launch_sched.staircase_launches(3, 12, 12, 0.5))
    assert launches == list(jax_sched.staircase_launches(3, 12, 12, 0.5)) and len(launches) == 3
    for s0, sub in launches:
        lr = launch_sched.staircase_lr(LR, 0.5, s0)
        assert lr == jax_sched.staircase_lr(LR, 0.5, s0)
        got, _ = _port_steps(data, got, SMALL, s0, sub, lr=lr)
        want, _ = _jax_steps(data, want, SMALL, s0, sub, lr=lr)
    keep = _keep(SMALL)
    np.testing.assert_allclose(got[0][keep], want[0][keep], rtol=0, atol=3e-4)


def test_odd_shape_matches_pallas_kernel():
    """Seven ragged tasks of up to 8 points, D=3, F=3, nets of other depths
    and widths, 5 steps: parameters atol 3e-4, last loss rtol 1e-5."""
    data, state, _ = _case(4, **ODD)
    got, loss = _port_steps(data, state, ODD, 0, 5)
    want, j_loss = _jax_steps(data, state, ODD, 0, 5)
    keep = _keep(ODD)
    np.testing.assert_allclose(got[0][keep], want[0][keep], rtol=0, atol=3e-4)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)


def _sin_tasks(n_tasks, n_samples):
    env = SinusoidDataset(random_state=np.random.RandomState(26))
    return env.generate_meta_train_data(n_tasks=n_tasks, n_samples=n_samples)


# name -> (tasks, points, constructor keywords); the JAX gate runs with Pallas
# forced and counted batches on, as on the TPU
GATE_CASES = {
    "demo_like": (6, 5, {}),
    "full_batch": (6, 5, dict(task_batch_size=-1)),
    "lr_decay": (6, 5, dict(lr_decay=0.5)),
    "three_layers": (6, 5, dict(mean_nn_layers=(8, 8, 8), kernel_nn_layers=(16,))),
    "feature_dim_8": (6, 5, dict(feature_dim=8)),
    "feature_dim_9": (6, 5, dict(feature_dim=9)),
    "n8": (6, 8, {}),
    "sgd": (6, 5, dict(optimizer="SGD")),
    "learn_mean_se": (6, 5, dict(learning_mode="learn_mean", covar_module="SE")),
    "constant_mean": (6, 5, dict(learning_mode="learn_kernel", mean_module="constant")),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_learner_gate_matches_jax(monkeypatch, case):
    """The port's learner (count-weighted batches, its only mode) takes the
    fused path exactly where the JAX learner does on the TPU; its gate
    ``fused_map_fits`` differs from the TPU's VMEM test only in memory."""
    monkeypatch.setenv("PACOH_TPU_FORCE_PALLAS", "1")
    monkeypatch.setenv("PACOH_TPU_MAP_WEIGHTED", "1")
    monkeypatch.delenv("PACOH_TPU_DISABLE_FUSED", raising=False)
    jit_cache.clear()
    n_tasks, n_samples, kw = GATE_CASES[case]
    tasks = _sin_tasks(n_tasks, n_samples)
    kw = dict(kw, mean_nn_layers=kw.get("mean_nn_layers", (8, 8)),
              kernel_nn_layers=kw.get("kernel_nn_layers", (8, 8)), weight_decay=WD)
    want = JaxMAP(tasks, **kw)._fused_path_ok()
    jit_cache.clear()
    assert GPRegressionMetaLearned(tasks, device="cpu", **kw)._fused_path_ok() == want
    assert want == (case in ("demo_like", "full_batch", "lr_decay", "three_layers",
                             "feature_dim_8", "n8"))


@pytest.mark.parametrize("t,n,d,f,mh,kh,fits", [
    (20, 5, 1, 2, (32, 32), (32, 32), True),
    (7, 8, 3, 3, (16, 16, 16), (32, 32), True),
    (1, 1, 1, 1, (4,), (4,), True),
    (409, 5, 1, 2, (32, 32), (32, 32), True),  # tasks grouped 4 to a block
    (20, 9, 1, 2, (32, 32), (32, 32), False),  # N above the unrolled window
    (20, 5, 1, 9, (32, 32), (32, 32), False),
    (20, 5, 1, 2, (), (32, 32), False),
    (20, 5, 1, 2, (256, 256), (32, 32), False),  # the parameters outgrow shared memory
])
def test_fused_map_fits(t, n, d, f, mh, kh, fits):
    assert mk.fused_map_fits(t, n, d, f, mh, kh) == fits


def test_task_groups_and_wrapper_checks():
    assert mk.task_groups(20) == (20, 1)
    assert mk.task_groups(128) == (128, 1)
    assert mk.task_groups(129) == (65, 2)
    assert mk.task_groups(409) == (103, 4)
    data, state, layout = _case(5, **SMALL)
    args = [torch.from_numpy(a) for a in (*state, *data)]
    with pytest.raises(ValueError):  # w_t of the wrong weights
        mk.fused_map_train(*args, torch.ones(4), 0, LR, WD, layout=layout, n_steps=1)
    with pytest.raises(ValueError):
        mk.fused_map_train(*args, torch.from_numpy(mk.task_weights(data[2])), 0, LR, WD,
                           layout=layout, n_steps=0)
