"""Tanh MLP as a function of a parameter dict (counterpart of meta_learning_pacoh_tpu/models/mlp.py).

Layout: {'w_0': [in, h0], 'b_0': [h0], ..., 'w_out': [h, out], 'b_out': [out]},
weights stored input-major so the forward is x @ w + b, as in the JAX
package. ``mlp_apply`` takes the leaves with a leading particle axis,
[K, in, out] and [K, out], and the input with the same axis, x [K, ..., in].
"""

import math

import torch


def mlp_shapes(input_dim, output_dim, hidden_layers):
    sizes = [input_dim] + list(hidden_layers) + [output_dim]
    return [(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)]


def init_mlp_params(generator, input_dim, output_dim, hidden_layers,
                    scheme="torch_linear"):
    """Initial weights drawn from ``generator`` (a CPU ``torch.Generator``).

    'torch_linear': U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for w and b.
    'kaiming_tanh': w ~ U(+-sqrt(3) g / sqrt(fan_in)) with tanh gain g = 5/3,
                    b ~ U(+-1/sqrt(fan_out)).
    """
    params = {}
    n_hidden = len(hidden_layers)
    for i, (fan_in, fan_out) in enumerate(mlp_shapes(input_dim, output_dim, hidden_layers)):
        name = str(i) if i < n_hidden else "out"
        if scheme == "torch_linear":
            w_bound = b_bound = 1.0 / math.sqrt(fan_in)
        elif scheme == "kaiming_tanh":
            w_bound = math.sqrt(3.0) * (5.0 / 3.0) / math.sqrt(fan_in)
            b_bound = 1.0 / math.sqrt(fan_out)
        else:
            raise ValueError(f"unknown init scheme {scheme!r}")
        params[f"w_{name}"] = (torch.rand(fan_in, fan_out, generator=generator)
                               * 2.0 - 1.0) * w_bound
        params[f"b_{name}"] = (torch.rand(fan_out, generator=generator) * 2.0 - 1.0) * b_bound
    return params


def mlp_apply(params, x):
    """Forward pass with tanh hidden activations: x [K, ..., in] -> [K, ..., out],
    one batched product per layer."""
    n_layers = len(params) // 2 - 1
    lead = x.shape[:-1]
    h = x.reshape(x.shape[0], -1, x.shape[-1])
    for i in range(n_layers):
        h = torch.tanh(torch.baddbmm(params[f"b_{i}"][:, None, :], h, params[f"w_{i}"]))
    h = torch.baddbmm(params["b_out"][:, None, :], h, params["w_out"])
    return h.reshape(*lead, h.shape[-1])
