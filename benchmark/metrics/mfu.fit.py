"""The counted operations of all the window's meta-training steps over the
window's time and the card's float32 peak, %."""

from benchmark.work import peaks, svgd_step


def read(run):
    d = run.driver
    steps = sum(r["steps"] for r in d.records if r["ok"])
    return 100.0 * steps * svgd_step.flops_per_step(d.shape) / d.window_s / peaks.FLOAT32_FLOPS
