"""Work of B10, the fused PACOH-SVGD kernel for tasks of 9 <= N <= 256
points (csrc/fused_svgd_bign.cu): what a step and a launch need."""

from benchmark.work.counts import mlp_flops, transport_adam_flops

KERNEL = "fused_svgd_bign_kernel"


def flops_per_step(s):
    """The K T systems (both nets over a task's rows forward and backward, the
    Gram matrix and its chains, about 23 N^2, the factor, L^-1 and the
    symmetric K^-1, N^3 / 3 each), the transport and Adam."""
    k, t, n, d, hidden, p = s["k"], s["t"], s["n"], s["d"], s["hidden"], s["p"]
    per_system = 2 * mlp_flops(n, d, hidden, 1) + n ** 3 + 23 * n * n
    return k * t * per_system + transport_adam_flops(k, p)


def bytes_per_launch(s):
    k, t, n, d, p = s["k"], s["t"], s["n"], s["d"], s["p"]
    return 4 * (6 * k * p + t * n * (d + 2) + t)
