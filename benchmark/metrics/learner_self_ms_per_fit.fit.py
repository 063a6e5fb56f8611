"""Host ms a fit in the learner's own stages: the summed self time (less the
host's waits on the device) of the traced window's ``pacoh.learner.*`` and
``pacoh.ops.*`` spans (construction, data preparation, the fused-path gate,
``meta_fit`` outside its trainer) over the window's fits. Nothing where the
program records no span."""

from benchmark import program_spans


def read(run):
    ns = program_spans.self_ns(run.trace, program_spans.LEARNER)
    return None if ns is None else 1e-6 * ns / len(run.driver.records)
