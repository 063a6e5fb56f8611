"""The program's own spans in a traced window, and what the per-layer readers
take from them.

The port marks its stages with ``pacoh.<layer>.<stage>`` spans
(``meta_learning_pacoh_torch.utils.profiling.span``), recorded by the same
profiler session as the device's operations, so on one clock. The layer
words: ``learner`` and ``ops`` (the learner and the general ops it calls:
the layer "algos learner"), ``trainer`` (the fused trainers: "ops.cuda
trainers"). Spans nest on one host thread; at any moment the innermost open
span owns the host's time. A span's self time is its duration less what its
child spans cover and less the host's waits on the device inside it (the
synchronizing runtime calls: a read-back's wait for the kernels queued
before it is the device's time, not the span's work); each device-idle gap
of the window, cut at span boundaries, goes piece by piece to the layer of
the innermost open span, or to none (the benchmark's own loop).

A program without spans (an older tree) yields none, and the readers
return None.
"""

PREFIX = "pacoh."
LEARNER = ("learner", "ops")
TRAINER = ("trainer",)
WAITS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize")


def layer(name):
    """The layer word of a span name ``pacoh.<layer>.<stage>``."""
    return name.split(".")[1]


def spans(summary):
    """[(name, start, end)] of the program's spans in the trace's host
    events, sorted by start (ns, the trace's clock)."""
    return [ev for ev in summary.host if ev[0].startswith(PREFIX)]


def owners(events):
    """[(start, end, name)]: disjoint pieces of time in order, each under the
    innermost of ``events`` (proper nesting, sorted by start) open there. A
    span that outlasts its parent is cut at the parent's end."""
    pieces, stack = [], []  # stack: [name, end] of the open spans, innermost last
    cursor = None

    def close_until(t):
        nonlocal cursor
        while stack and stack[-1][1] <= t:
            name, end = stack.pop()
            if end > cursor:
                pieces.append((cursor, end, name))
            cursor = max(cursor, end)

    for name, start, end in sorted(events, key=lambda ev: (ev[1], -ev[2])):
        close_until(start)
        if stack and start > cursor:
            pieces.append((cursor, start, stack[-1][0]))
        if stack:
            end = min(end, stack[-1][1])
        cursor = start if cursor is None else max(cursor, start)
        stack.append([name, end])
    if stack:
        close_until(stack[0][1])
    return pieces


def overlap(pieces, intervals):
    """Per piece of ``pieces`` [(start, end, name)], its time inside the union
    of ``intervals`` [(start, end)] (both sorted and disjoint): [ns]."""
    out, j = [], 0
    for start, end, _ in pieces:
        while j < len(intervals) and intervals[j][1] <= start:
            j += 1
        total, k = 0, j
        while k < len(intervals) and intervals[k][0] < end:
            total += min(end, intervals[k][1]) - max(start, intervals[k][0])
            k += 1
        out.append(total)
    return out


def minus(intervals, holes):
    """The parts of ``intervals`` [(start, end)] outside ``holes`` (both sorted
    and disjoint), sorted."""
    out, j = [], 0
    for start, end in intervals:
        while j < len(holes) and holes[j][1] <= start:
            j += 1
        cursor, k = start, j
        while k < len(holes) and holes[k][0] < end:
            if holes[k][0] > cursor:
                out.append((cursor, holes[k][0]))
            cursor = max(cursor, holes[k][1])
            k += 1
        if cursor < end:
            out.append((cursor, end))
    return out


def idle_intervals(summary):
    """[(start, end)] of the window in which no device operation ran."""
    gaps, last = [], summary.t0
    for start, end in summary.busy_intervals():
        if start > last:
            gaps.append((last, start))
        last = end
    if summary.t1 > last:
        gaps.append((last, summary.t1))
    return gaps


def pieces(summary, words):
    """The ``owners`` pieces of the program's spans that belong to the layers
    ``words``; None where the program recorded no span."""
    events = spans(summary)
    if not events:
        return None
    return [p for p in owners(events) if layer(p[2]) in words]


def self_ns(summary, words, within=None):
    """The summed self time (ns) of the spans of the layers ``words``, less
    the host's waits on the device, inside the window or inside the
    intervals ``within`` [(start, end)]; None where the program recorded no
    span."""
    mine = pieces(summary, words)
    if mine is None:
        return None
    windows = [(summary.t0, summary.t1)] if within is None else sorted(within)
    waits = summary.busy_intervals([ev for ev in summary.host if ev[0] in WAITS])
    return sum(overlap(mine, minus(windows, waits)))


def idle_ns(summary, words):
    """Device-idle time (ns) of the window under an innermost span of the
    layers ``words``; None where the program recorded no span."""
    mine = pieces(summary, words)
    return None if mine is None else sum(overlap(mine, idle_intervals(summary)))


def idle_pct(run, words):
    """``idle_ns`` as a share of the window, %."""
    ns = idle_ns(run.trace, words)
    return None if ns is None else 100.0 * ns * 1e-9 / run.trace.window_s
