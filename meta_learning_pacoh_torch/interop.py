"""State carried across from the JAX package.

``from_jax_state`` turns a JAX learner's ``state_dict()`` (numpy particles,
the optax optimizer state, the step) into the port's state dict. With the
identical flat parameter layout (models/random_gp.py) the two packages can
then continue from the same numbers. The JAX state is read by attribute and
position only; nothing of JAX or optax is imported.
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
