"""Work of B2, the fused PACOH-SVGD kernel for tasks of N <= 8 points
(csrc/fused_svgd.cu): what a step and a launch need at a cell's shapes."""

from benchmark.work.counts import gp_task_flops, mlp_flops, transport_adam_flops

KERNEL = "fused_svgd_kernel"  # the CUDA function's name in the trace


def flops_per_step(s):
    """Both nets over the K T N rows forward and backward, every task's MLL
    and gradient, the transport and Adam; ``s`` the cell's shapes."""
    k, t, n, d, hidden, p = s["k"], s["t"], s["n"], s["d"], s["hidden"], s["p"]
    return k * (2 * mlp_flops(t * n, d, hidden, 1) + t * gp_task_flops(n, 1)) \
        + transport_adam_flops(k, p)


def bytes_per_launch(s):
    """A launch reads and writes the particles and both Adam moments once and
    reads the data (x, y, mask) and the task weights once."""
    k, t, n, d, p = s["k"], s["t"], s["n"], s["d"], s["p"]
    return 4 * (6 * k * p + t * n * (d + 2) + t)
