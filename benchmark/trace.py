"""The benchmark's own profiler session and its reduction to the numbers the
per-layer readers take: the device's operations, the benchmark's spans, the
host's operators, busy and idle time, and the breakdown of the result line.

A traced run wraps the measured window in ``torch.profiler`` (host and
device activities). The benchmark marks each fit or call with a
``record_function`` span named ``bench.<kind>``; those spans and the device
operations share one clock in the trace.
"""

import bisect
import collections
import gzip
import json
import os

import torch
from torch.profiler import ProfilerActivity, profile

MEMCPY = ("Memcpy", "Memset")
WINDOW = "bench.window"  # the span of the measured window


def session():
    """A profiler of the host and the card, not yet started."""
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _ns(ev, what):
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


class Summary:
    """What a trace says about a window [t0, t1] (ns, the trace's clock).

    ``device``: [(name, start, end)] of every device operation (kernels,
    copies, fills), sorted by start; ``kernels``: the kernels alone;
    ``spans``: [(name, start, end)] of the benchmark's spans; ``host``:
    [(name, start, end)] of the host's operators."""

    def __init__(self, events, t0, t1):
        self.t0, self.t1 = t0, t1
        self.device, self.kernels, self.spans, self.host = [], [], [], []
        self._starts = {}
        for ev in events:
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            name = ev.name()
            if ev.device_type() != torch.autograd.DeviceType.CPU:
                kind = str(ev.activity_type() if hasattr(ev, "activity_type") else "").lower()
                if "annotation" in kind or name.startswith("bench."):
                    continue  # the benchmark's spans, mirrored on the device's timeline
                self.device.append((name, start, end))
                if "kernel" in kind or (not kind and not name.startswith(MEMCPY)):
                    self.kernels.append((name, start, end))
            elif name == WINDOW:
                continue
            elif name.startswith("bench."):
                self.spans.append((name, start, end))
            else:
                self.host.append((name, start, end))
        for lst in (self.device, self.kernels, self.spans, self.host):
            lst.sort(key=lambda e: e[1])

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self, events=None):
        """The union of the intervals of ``events`` (default: every device
        operation) clipped to the window, merged: [(start, end)]."""
        merged = []
        for _, s, e in (self.device if events is None else events):
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def within(self, events, start, end):
        """The events of ``events`` (a list of this summary's, sorted by start)
        that start inside [start, end]."""
        key = id(events)
        if key not in self._starts:
            self._starts[key] = [ev[1] for ev in events]
        starts = self._starts[key]
        return events[bisect.bisect_left(starts, start):bisect.bisect_right(starts, end)]

    def breakdown(self, top=10):
        """{"device_ops": [[name, s]], "idle_gaps": [[what the host ran, s]]}:
        the device operations that took most time, summed by name, and the
        idle time of the device summed by the host operator (or, where none
        ran, the benchmark's span) that covers most of each gap."""
        by_op = collections.Counter()
        for name, s, e in self.device:
            by_op[name] += (min(e, self.t1) - max(s, self.t0)) * 1e-9
        busy = self.busy_intervals()
        gaps, last = [], self.t0
        for s, e in busy:
            if s > last:
                gaps.append((last, s))
            last = e
        if self.t1 > last:
            gaps.append((last, self.t1))
        by_gap = collections.Counter()
        starts = [hs for _, hs, _ in self.host]
        for s, e in gaps:
            by_gap[self._host_label(starts, s)] += (e - s) * 1e-9
        return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
                "idle_gaps": [[n, v] for n, v in by_gap.most_common(top)]}

    def write(self, path):
        """The window's device operations and the benchmark's spans as a
        gzipped Chrome trace (Perfetto opens it): a few MB where the
        profiler's own export of every host operator takes hundreds."""
        rows = [{"name": n, "ph": "X", "ts": (s - self.t0) / 1e3, "dur": (e - s) / 1e3,
                 "pid": pid, "tid": 0}
                for pid, events in ((0, self.spans), (1, self.device)) for n, s, e in events]
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with gzip.open(path, "wt") as f:
            json.dump({"traceEvents": rows}, f)

    def _host_label(self, starts, at):
        """The innermost host operator running at ``at`` (the latest-started
        of those that cover it, among the 64 that started last before it),
        or the benchmark's span there, or "harness"."""
        i = bisect.bisect_right(starts, at)
        for name, hs, he in reversed(self.host[max(0, i - 64):i]):
            if he >= at:
                return name
        for name, hs, he in self.spans:
            if hs <= at <= he:
                return name
        return "harness"


def reduce(prof, out_path=None):
    """The ``Summary`` of a finished profiler over its ``bench.window`` span;
    writes its device operations and spans, gzipped, to ``out_path`` if given."""
    events = prof.profiler.kineto_results.events()
    window = [ev for ev in events if ev.name() == WINDOW]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} '{WINDOW}' spans, not one")
    t0 = _ns(window[0], "start")
    summary = Summary(events, t0, t0 + _ns(window[0], "duration"))
    if out_path:
        summary.write(out_path)
    return summary
