"""Host ms a meta-test call in the learner's own stages: the summed self
time (less the host's waits on the device, such as the metrics' read-back
waiting for the call's kernels) of the ``pacoh.learner.*`` and
``pacoh.ops.*`` spans inside the traced window's calls (the benchmark's
spans) over the calls. Nothing where the program records no span."""

from benchmark import program_spans
from benchmark.metrics_util import call_spans


def read(run):
    calls = call_spans(run)
    if not calls:
        return None
    ns = program_spans.self_ns(run.trace, program_spans.LEARNER,
                               [(start, end) for _, start, end in calls])
    return None if ns is None else 1e-6 * ns / len(calls)
