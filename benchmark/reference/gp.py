"""Plain PyTorch reference of the GP prior that PACOH meta-learns: the flat
parameter vector and its hyper-prior, the tanh nets of the mean and of the
kernel's features, the RBF kernel, and the exact marginal likelihood.

Written from the model's description, not from the program: the layout is
``jax.flatten_util.ravel_pytree``'s order of the parameter dict (keys sorted
at every level, leaves row-major), so a flat vector means the same numbers
here and in the program. Every function takes any floating type; the checks
run it in float64.

Where a numeric rule of the configuration picks a jitter level by whether a
float32 factorization succeeds, ``factor_levels`` makes that choice the same
way and then factors in the caller's type.
"""

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def net_leaves(d_in, hidden, d_out):
    """{name: shape} of a tanh MLP d_in -> hidden... -> d_out."""
    sizes = [d_in, *hidden, d_out]
    leaves = {}
    for i in range(len(sizes) - 1):
        name = str(i) if i < len(hidden) else "out"
        leaves[f"w_{name}"] = (sizes[i], sizes[i + 1])
        leaves[f"b_{name}"] = (sizes[i + 1],)
    return leaves


def layout(d, hidden, feature_dim=1):
    """((path, shape, offset), ...) of NN mean + NN kernel parameters, in the
    sorted-key order; and P."""
    tree = {"kernel_nn": net_leaves(d, hidden, feature_dim), "lengthscale_raw": (feature_dim,),
            "mean_nn": net_leaves(d, hidden, 1), "noise_raw": ()}
    out, offset = [], 0

    def walk(node, path):
        nonlocal offset
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key], path + (key,))
            else:
                shape = node[key]
                out.append((path + (key,), shape, offset))
                offset += math.prod(shape)

    walk(tree, ())
    return tuple(out), offset


def leaf_slices(lay):
    """[(name, slice)] of every leaf of a layout."""
    return [("/".join(path), slice(off, off + math.prod(shape))) for path, shape, off in lay]


def unflatten(lay, theta):
    """theta [..., P] -> {path: leaf [..., *shape]}."""
    lead = theta.shape[:-1]
    return {path: theta[..., off:off + math.prod(shape)].reshape(*lead, *shape)
            for path, shape, off in lay}


def hyper_prior(lay, p, weight_prior_std, bias_prior_std, device):
    """(loc, scale) [P] float64 of the factorised Gaussian hyper-prior: weights
    N(0, wps), biases N(0, bps), the raw lengthscale N(0, 1), the raw noise N(-1, 1)."""
    loc = torch.zeros(p, dtype=torch.float64, device=device)
    scale = torch.ones(p, dtype=torch.float64, device=device)
    for path, shape, off in lay:
        block = slice(off, off + math.prod(shape))
        name = path[-1]
        if name == "noise_raw":
            loc[block] = -1.0
        elif name.startswith("w_"):
            scale[block] = weight_prior_std
        elif name.startswith("b_"):
            scale[block] = bias_prior_std
    return loc, scale


def softplus(x):
    return torch.nn.functional.softplus(x)


def mlp(leaves, prefix, x, n_hidden):
    """tanh MLP of leaves ``prefix``/w_i, b_i (leading axes matching x's
    first ones) at x [..., N, D] -> [..., N, out]."""
    h = x
    for i in range(n_hidden):
        h = torch.tanh(h @ leaves[(prefix, f"w_{i}")]
                       + leaves[(prefix, f"b_{i}")].unsqueeze(-2))
    return h @ leaves[(prefix, "w_out")] + leaves[(prefix, "b_out")].unsqueeze(-2)


def prior_moments_at(leaves, x, n_hidden):
    """(mean [..., N], RBF Gram [..., N, N]) of parameter sets at x [..., N, D]:
    the mean net's output, and exp(-|f(x) - f(x')|^2 / 2) of the kernel net's
    features divided by the lengthscale softplus(lengthscale_raw)."""
    mean = mlp(leaves, "mean_nn", x, n_hidden)[..., 0]
    ls = softplus(leaves[("lengthscale_raw",)])
    f = mlp(leaves, "kernel_nn", x, n_hidden) / ls.unsqueeze(-2)
    diff = f.unsqueeze(-2) - f.unsqueeze(-3)
    return mean, torch.exp(-0.5 * torch.sum(diff * diff, dim=-1))


def factor_ok32(a):
    """Per matrix of a [..., N, N]: does a float32 Cholesky factor succeed with
    a finite, positive diagonal?"""
    lower, info = torch.linalg.cholesky_ex(a.float())
    diag = torch.diagonal(lower, dim1=-2, dim2=-1)
    return (info == 0) & torch.all(torch.isfinite(diag) & (diag > 0), dim=-1)


def factor_levels(a, levels, relative=False):
    """Cholesky factor of a + j s I per matrix, the level j the first of
    ``levels`` at which a float32 factor succeeds (the last level otherwise);
    s = 1, or the mean of a's diagonal with ``relative``."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    with torch.no_grad():
        scale = (torch.diagonal(a, dim1=-2, dim2=-1).mean(-1).clamp_min(1e-12) if relative
                 else torch.ones(a.shape[:-2], dtype=a.dtype, device=a.device))
        level = torch.full(a.shape[:-2], levels[-1], dtype=a.dtype, device=a.device)
        for j in reversed(levels[:-1]):
            ok = factor_ok32(a + j * scale[..., None, None] * eye)
            level = torch.where(ok, torch.full_like(level, j), level)
    return torch.linalg.cholesky(a + (level * scale)[..., None, None] * eye)


def gauss_logpdf(y, mean, cov, levels=(0.0,), relative=False):
    """log N(y; mean, cov), y and mean [..., N], cov [..., N, N], the factor's
    jitter level chosen by ``factor_levels``."""
    lower = factor_levels(cov, levels, relative)
    z = torch.linalg.solve_triangular(lower, (y - mean).unsqueeze(-1), upper=False)[..., 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(lower, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * (torch.sum(z * z, dim=-1) + logdet + y.shape[-1] * LOG_2PI)


def normalise(train):
    """(x_mean [D], x_std [D], y_mean, y_std) of the meta-train tasks, pooled
    over all their points, in float64: the z-score of the learners."""
    import numpy as np

    xs = np.concatenate([np.asarray(x, np.float64) for x, _ in train])
    ys = np.concatenate([np.asarray(y, np.float64).reshape(-1) for _, y in train])
    return xs.mean(0), xs.std(0) + 1e-8, float(ys.mean()), float(ys.std() + 1e-8)


def stack_tasks(tasks, stats, device):
    """(X [T, N, D], Y [T, N]) float64 of tasks of one size, normalised by ``stats``."""
    import numpy as np

    x_mean, x_std, y_mean, y_std = stats
    X = np.stack([(np.asarray(x, np.float64) - x_mean) / x_std for x, _ in tasks])
    Y = np.stack([(np.asarray(y, np.float64).reshape(-1) - y_mean) / y_std for _, y in tasks])
    return (torch.tensor(X, dtype=torch.float64, device=device),
            torch.tensor(Y, dtype=torch.float64, device=device))
