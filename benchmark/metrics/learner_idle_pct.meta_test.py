"""Share of the traced window in which the device is idle while the host is
inside a learner or general-ops span as the innermost, %: the part of
``device_idle_pct.meta_test`` the learner owns. Nothing where the program
records no span."""

from benchmark import program_spans


def read(run):
    return program_spans.idle_pct(run, program_spans.LEARNER)
