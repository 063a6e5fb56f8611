"""The counted operations of all the window's meta-test calls (B8's steps and
the predictive) over the window's time and the card's float32 peak, %."""

from benchmark.work import fused_mlap_meta_test, mlap_predictive, peaks


def read(run):
    d = run.driver
    calls = [r for r in d.records if r["ok"]]
    per_call = (d.shape["steps"] * fused_mlap_meta_test.flops_per_step(d.shape)
                + mlap_predictive.flops_per_call(d.shape))
    return 100.0 * len(calls) * per_call / d.window_s / peaks.FLOAT32_FLOPS
