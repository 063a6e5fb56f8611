"""Operation counts shared by the kernels' work functions (copied from the
port's chip_smoke.py arithmetic, which reproduces PERF.md's bounds)."""


def mlp_flops(rows, d, hidden, out):
    """A tanh MLP's forward, weight gradients and input gradients (none into
    the data) over ``rows`` rows."""
    sizes = [d, *hidden, out]
    macs = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return 2 * rows * (3 * macs - d * hidden[0])


def mlp_forward_macs(d, hidden, out):
    """Multiply-adds of one row's forward pass."""
    sizes = [d, *hidden, out]
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def gp_task_flops(n, f):
    """One task's MLL and its gradient: the kernel matrix, one factorization,
    the solves, L^-1, K^-1 and the gradient's pair terms."""
    return n * n * (3 * f + 10) + n ** 3


def transport_adam_flops(k, p):
    """The Stein transport of K particles of P coordinates and their Adam step."""
    return 7 * k * k * p + 12 * k * p
