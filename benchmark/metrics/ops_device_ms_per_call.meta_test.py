"""Device ms a meta-test call of every kernel other than B8's: the
predictive, its metrics and the set-up of the call's posteriors."""

import re

from benchmark.metrics_util import call_spans
from benchmark.work import fused_mlap_meta_test


def read(run):
    spans = call_spans(run)
    if not spans:
        return None
    t = run.trace
    b8 = re.compile(rf"\b{fused_mlap_meta_test.KERNEL}\b")
    total = sum(e - s for _, s0, e0 in spans for name, s, e in t.within(t.kernels, s0, e0)
                if not b8.search(name))
    return 1e-6 * total / len(spans)
