"""Host ms a meta-test call: a call's wall time (the benchmark's span) less
the device's busy time inside it, the mean over the traced window's calls."""

from benchmark.metrics_util import call_spans


def read(run):
    spans = call_spans(run)
    if not spans:
        return None
    t = run.trace
    host = []
    for _, start, end in spans:
        inside = [(n, s, min(e, end)) for n, s, e in t.within(t.device, start, end)]
        busy = sum(e - s for s, e in t.busy_intervals(inside))
        host.append((end - start - busy) * 1e-9)
    return 1e3 * sum(host) / len(host)
