"""Work of B8's meta-test mode (csrc/fused_mlap.cuh, the fused PACOH-MLAP
kernel with the hyper-posterior and the noise frozen): a step and a launch
at a cell's shapes (``s``: S samples, T tasks of N context points in D
dimensions, nets ``hidden``, P parameters)."""

from benchmark.work.counts import mlp_forward_macs

KERNEL = "fused_mlap_kernel"


def q_floats(s):
    """Floats of the tasks' posteriors (means and factors)."""
    return s["t"] * s["n"] * (s["n"] + 1)


def flops_per_step(s):
    """Per sample both nets forward over the T N rows, each task's factor,
    inverse and KL (about 4 N^3 + 12 N^2), the sample's draw; then the
    posteriors' gradients and Adam (about 20 a float)."""
    t, n = s["t"], s["n"]
    nets = 4 * t * n * mlp_forward_macs(s["d"], s["hidden"], 1)
    return s["s"] * (nets + t * (4 * n ** 3 + 12 * n * n) + 8 * s["p"]) + 20 * q_floats(s)


def bytes_per_launch(s):
    """A launch reads and writes the posteriors and their moments once, reads
    the hyper-posterior and the data once."""
    t, n, d, p = s["t"], s["n"], s["d"], s["p"]
    return 4 * (6 * (2 * p + q_floats(s) + 1) + t * n * (d + 2))


def bytes_per_step(s):
    """Each step reads its page of S P standard normals."""
    return 4 * s["s"] * s["p"]
