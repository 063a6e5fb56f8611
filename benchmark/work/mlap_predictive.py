"""Work of PACOH-MLAP's predictive and metrics after a meta-test: the prior
moment-matched over 20 hyper-posterior samples at each task's context and
test points, the sparse-GP predictive, and each task's joint density."""

from benchmark.work.counts import mlp_forward_macs

N_AGG = 20


def flops_per_call(s):
    """Per task, at M = N + Nt points: both nets forward for 20 samples, their
    Gram matrices and the moment matching (about 8 M^2 a sample); the
    predictive's solves and products (about 4 N Nt^2 + 4 N^2 Nt); the
    density's factor and solve (Nt^3 / 3 + Nt^2)."""
    n, nt = s["n"], s["n_test"]
    m = n + nt
    per_sample = 2 * 2 * m * mlp_forward_macs(s["d"], s["hidden"], 1) + 8 * m * m
    return s["t"] * (N_AGG * per_sample + nt ** 3 / 3 + nt * nt + 4 * n * nt * nt
                     + 4 * n * n * nt)
