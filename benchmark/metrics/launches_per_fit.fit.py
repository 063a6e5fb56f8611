"""Kernel launches a fit in the traced window, of every kernel (the
program's and PyTorch's)."""


def read(run):
    fits = len(run.driver.records)
    return len(run.trace.within(run.trace.kernels, run.trace.t0, run.trace.t1)) / fits
