"""State carried across from the JAX package.

``from_jax_state`` turns a JAX SVGD learner's ``state_dict()`` (numpy
particles, the optax optimizer state, the step) into the port's state dict,
``from_jax_map_state`` a JAX PACOH-MAP learner's (a parameter pytree and
optax's multi-transform AdamW state), and ``from_jax_vi_state`` a JAX
PACOH-VI learner's (the posterior dict and optax's Adam or SGD state), and
``from_jax_mlap_state`` a JAX PACOH-MLAP learner's (the hyper-posterior,
noise and per-task posteriors, and optax's two-group Adam or SGD state), and
``from_jax_gpr_state`` / ``from_jax_gpr_pac_state`` a JAX single-task
learner's (a parameter pytree and optax's grouped AdamW or SGD state), and
``from_jax_maml_state`` / ``from_jax_np_state`` a JAX MAML or Neural
Process learner's (a flat dict of leaves and optax's Adam(W) or SGD
state); ``np_params_from_jax`` copies a JAX ``NeuralProcessImg.params``. With
the identical flat parameter layout (models/random_gp.py) the two packages
can then continue from the same numbers. The JAX state is read by
attribute, key and position only; nothing of JAX or optax is imported.
"""

import numpy as np


def from_jax_state(state):
    """{'particles', 'opt_state': (ScaleByAdamState(count, mu, nu), ...), 'step'}
    -> {'particles', 'opt_state': {'mu', 'nu', 'count'}, 'step'}."""
    particles = np.asarray(state["particles"], dtype=np.float32)
    adam = state["opt_state"][0]
    if hasattr(adam, "mu"):
        mu, nu, count = adam.mu, adam.nu, adam.count
    else:  # SGD: no moments
        mu = nu = np.zeros_like(particles)
        count = 0
    return {
        "particles": particles,
        "opt_state": {"mu": np.asarray(mu, dtype=np.float32),
                      "nu": np.asarray(nu, dtype=np.float32),
                      "count": int(np.asarray(count))},
        "step": int(state.get("step", 0)),
    }


def _flat_leaves(tree, like):
    """Leaves of ``tree`` in the ``ravel_pytree`` order (dict keys sorted at
    every level), flattened and concatenated; a leaf that is no array (optax's
    placeholder for a frozen leaf) counts as zeros shaped like ``like``'s."""
    parts = []
    for key in sorted(like):
        leaf, ref = tree.get(key) if isinstance(tree, dict) else None, like[key]
        if isinstance(ref, dict):
            parts.append(_flat_leaves(leaf, ref))
        else:
            arr = np.asarray(leaf) if hasattr(leaf, "shape") else np.zeros(np.shape(ref))
            parts.append(arr.astype(np.float32).reshape(-1))
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def params_from_jax(params):
    """A JAX parameter pytree (numpy or JAX leaves) -> the flat float32 vector."""
    return _flat_leaves(params, params)


def from_jax_map_state(state):
    """A JAX ``GPRegressionMetaLearned.state_dict()`` -> the port's MAP state:
    {'params' [P], 'opt_state': {'mu', 'nu', 'count'}, 'step'}.

    The optimizer state is optax's ``MultiTransformState(inner_states={'train':
    MaskedState(inner_state=(ScaleByAdamState(count, mu, nu), ...)), ...})``;
    the moments of frozen leaves, and all of them under SGD, are zeros.
    """
    params = state["params"]
    adam = state["opt_state"].inner_states["train"].inner_state[0]
    flat = params_from_jax(params)
    if hasattr(adam, "mu"):
        mu, nu = _flat_leaves(adam.mu, params), _flat_leaves(adam.nu, params)
        count = int(np.asarray(adam.count))
    else:
        mu, nu, count = np.zeros_like(flat), np.zeros_like(flat), 0
    return {"params": flat, "opt_state": {"mu": mu, "nu": nu, "count": count},
            "step": int(state.get("step", 0))}


def from_jax_vi_state(state):
    """A JAX ``GPRegressionMetaLearnedVI.state_dict()`` -> the port's VI state:
    {'posterior': {'loc', 'log_scale' | 'tril_raw'}, 'opt_state': {'mu', 'nu',
    'count'}, 'step'}, the moments with the posterior's keys.

    The optimizer state is optax's ``(ScaleByAdamState(count, mu, nu), ...)``
    for Adam; SGD's keeps no moments, which become zeros.
    """
    post = {k: np.asarray(v, dtype=np.float32) for k, v in state["posterior"].items()}
    adam = state["opt_state"][0]
    if hasattr(adam, "mu"):
        mu = {k: np.asarray(adam.mu[k], dtype=np.float32) for k in post}
        nu = {k: np.asarray(adam.nu[k], dtype=np.float32) for k in post}
        count = int(np.asarray(adam.count))
    else:
        mu = {k: np.zeros_like(v) for k, v in post.items()}
        nu = {k: np.zeros_like(v) for k, v in post.items()}
        count = 0
    return {"posterior": post, "opt_state": {"mu": mu, "nu": nu, "count": count},
            "step": int(state.get("step", 0))}


def from_jax_mlap_state(state):
    """A JAX ``GPRegressionMetaLearnedPAC.state_dict()`` -> the port's MLAP state:
    {'params': {'hyper_post': {'loc', 'log_scale' | 'tril_raw'}, 'raw_noise',
    'q_means', 'q_trils'}, 'opt_state': {'mu', 'nu', 'count'}, 'step'}, the
    moments nested as the params.

    The optimizer state is optax's ``MultiTransformState(inner_states={'main':
    MaskedState(inner_state=(ScaleByAdamState(count, mu, nu), ...)),
    'posterior': ...})``: 'main' holds the moments of the hyper-posterior and
    the noise, 'posterior' those of q_means and q_trils. SGD keeps no moments,
    which become zeros.
    """
    params = {"hyper_post": {k: np.asarray(v, dtype=np.float32)
                             for k, v in state["params"]["hyper_post"].items()},
              **{k: np.asarray(state["params"][k], dtype=np.float32)
                 for k in ("raw_noise", "q_means", "q_trils")}}
    groups = state["opt_state"].inner_states
    main, post = groups["main"].inner_state[0], groups["posterior"].inner_state[0]
    if hasattr(main, "mu"):
        def moments(field):
            return {"hyper_post": {k: np.asarray(getattr(main, field)["hyper_post"][k],
                                                 dtype=np.float32)
                                   for k in params["hyper_post"]},
                    "raw_noise": np.asarray(getattr(main, field)["raw_noise"], dtype=np.float32),
                    **{k: np.asarray(getattr(post, field)[k], dtype=np.float32)
                       for k in ("q_means", "q_trils")}}

        mu, nu, count = moments("mu"), moments("nu"), int(np.asarray(main.count))
    else:
        def zeros():
            return {"hyper_post": {k: np.zeros_like(v) for k, v in params["hyper_post"].items()},
                    **{k: np.zeros_like(params[k]) for k in ("raw_noise", "q_means", "q_trils")}}

        mu, nu, count = zeros(), zeros(), 0
    return {"params": params, "opt_state": {"mu": mu, "nu": nu, "count": count},
            "step": int(state.get("step", 0))}


def from_jax_gpr_state(state):
    """A JAX ``GPRegressionLearned.state_dict()`` -> the port's single-task
    state: {'params' [P], 'opt_state': {'mu', 'nu', 'count', 'lr'}, 'step'}.

    The optimizer state is optax's ``PartitionState(inner_states={'nn': ...,
    'hyper': ..., 'freeze': ...})``, each trained group a
    ``MaskedState(inner_state=InjectStatefulHyperparamsState(hyperparams,
    inner_state=(ScaleByAdamState(count, mu, nu), ...)))`` whose leaves of the
    other groups are placeholders. A coordinate's moments are those of its
    group (zeros where frozen, and all of them under SGD); both groups share
    the count and the injected learning rate (the plateau scheduler's).
    """
    params = state["params"]
    flat = params_from_jax(params)
    mu, nu = np.zeros_like(flat), np.zeros_like(flat)
    count, lr = 0, None
    for group in ("nn", "hyper"):
        inject = state["opt_state"].inner_states[group].inner_state
        lr = float(np.asarray(inject.hyperparams["learning_rate"]))
        adam = inject.inner_state[0]
        if hasattr(adam, "mu"):
            mu += _flat_leaves(adam.mu, params)
            nu += _flat_leaves(adam.nu, params)
            count = max(count, int(np.asarray(adam.count)))
    return {"params": flat, "opt_state": {"mu": mu, "nu": nu, "count": count, "lr": lr},
            "step": int(state.get("step", 0))}


# GPRegressionLearnedPAC's state is the same pytree with the GP's leaves under
# 'gp' beside 'q_chol' and 'q_mean', in the same optax groups
from_jax_gpr_pac_state = from_jax_gpr_state


def np_params_from_jax(params):
    """A flat JAX parameter dict (numpy or JAX leaves, e.g. a JAX
    ``NeuralProcessImg.params``) -> {name: float32 numpy array}."""
    return {k: np.array(v, dtype=np.float32) for k, v in params.items()}


def from_jax_np_state(state):
    """A JAX ``NPRegressionMetaLearned.state_dict()`` -> the port's state:
    {'params': {name: array}, 'opt_state': {'mu', 'nu' (same keys), 'count'},
    'step'}.

    The optimizer state is optax's ``(ScaleByAdamState(count, mu, nu), ...)``
    for AdamW (and MAML's Adam); SGD's first entry keeps no moments, which
    become zeros.
    """
    params = np_params_from_jax(state["params"])
    adam = state["opt_state"][0]
    if hasattr(adam, "mu"):
        mu, nu = np_params_from_jax(adam.mu), np_params_from_jax(adam.nu)
        count = int(np.asarray(adam.count))
    else:
        mu = {k: np.zeros_like(v) for k, v in params.items()}
        nu = {k: np.zeros_like(v) for k, v in params.items()}
        count = 0
    return {"params": params, "opt_state": {"mu": mu, "nu": nu, "count": count},
            "step": int(state.get("step", 0))}


# MAMLRegression's state is the same: its net's dict of leaves, and optax's
# Adam or SGD state
from_jax_maml_state = from_jax_np_state
