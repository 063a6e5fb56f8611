"""Share of the traced window in which the device is idle while the host is
inside a fused trainer's span (``pacoh.trainer.*``) as the innermost, %:
the part of ``device_idle_pct.fit`` the trainers own. Nothing where the
program records no span."""

from benchmark import program_spans


def read(run):
    return program_spans.idle_pct(run, program_spans.TRAINER)
