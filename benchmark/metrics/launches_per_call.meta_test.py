"""Kernel launches a meta-test call in the traced window, of every kernel
(the program's and PyTorch's)."""

from benchmark.metrics_util import call_spans


def read(run):
    spans = call_spans(run)
    if not spans:
        return None
    t = run.trace
    return sum(len(t.within(t.kernels, s, e)) for _, s, e in spans) / len(spans)
