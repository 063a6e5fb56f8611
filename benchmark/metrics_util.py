"""Helpers of the per-layer readers."""

import re

from benchmark.work import peaks


def kernel_events(run, kernel):
    """The traced window's device events of the CUDA function ``kernel``."""
    pattern = re.compile(rf"\b{re.escape(kernel)}\b")
    t = run.trace
    return [ev for ev in t.within(t.kernels, t.t0, t.t1) if pattern.search(ev[0])]


def call_spans(run):
    """The benchmark's spans of the window's meta-test calls."""
    return [sp for sp in run.trace.spans if sp[0] == "bench.call"]


def roofline_pct(run, work):
    """The least time of ``work``'s kernel at the window's steps over its
    summed device time, %, or None where it did not run. ``work`` has
    KERNEL, flops_per_step(shape), bytes_per_launch(shape) and maybe
    bytes_per_step(shape)."""
    events = kernel_events(run, work.KERNEL)
    if not events:
        return None
    d = run.driver
    steps = sum(r["steps"] for r in d.records if r["ok"])
    per_step = getattr(work, "bytes_per_step", lambda s: 0)(d.shape)
    least = peaks.least_s(steps * work.flops_per_step(d.shape),
                          len(events) * work.bytes_per_launch(d.shape) + steps * per_step)
    busy = sum(end - start for _, start, end in events) * 1e-9
    return 100.0 * least / busy
