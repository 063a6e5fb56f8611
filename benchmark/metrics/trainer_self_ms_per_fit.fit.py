"""Host ms a fit in the fused trainer: the summed self time (less the host's
waits on the device) of the traced window's ``pacoh.trainer.*`` spans (its
construction, pages and launches) over the window's fits. Nothing where the
program records no span."""

from benchmark import program_spans


def read(run):
    ns = program_spans.self_ns(run.trace, program_spans.TRAINER)
    return None if ns is None else 1e-6 * ns / len(run.driver.records)
