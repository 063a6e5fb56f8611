"""B8's meta-test mode: its least time over its device time in the traced
window, %, the window's meta-test steps and launches counted by
``benchmark/work/fused_mlap_meta_test.py``. Nothing where B8 did not run."""

from benchmark.metrics_util import roofline_pct
from benchmark.work import fused_mlap_meta_test


def read(run):
    return roofline_pct(run, fused_mlap_meta_test)
