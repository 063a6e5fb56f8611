"""B2's least time over its device time in the traced window, %: the
window's fit steps and launches, counted by ``benchmark/work/fused_svgd.py``,
against the summed time of the B2 kernels. Nothing where B2 did not run."""

from benchmark.metrics_util import roofline_pct
from benchmark.work import fused_svgd


def read(run):
    return roofline_pct(run, fused_svgd)
