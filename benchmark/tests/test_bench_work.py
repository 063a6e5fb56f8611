"""The work functions reproduce PERF.md's bounds (ms a step at the cells'
shapes, float32 operations over 67 TFLOP/s)."""

import pytest

from benchmark.work import fused_mlap_meta_test, fused_svgd, fused_svgd_bign, peaks, svgd_step

SIN320 = dict(k=10, t=320, n=5, d=1, hidden=(32, 32), p=2308)
T5N200 = dict(k=10, t=5, n=200, d=1, hidden=(32, 32), p=2308)
MLAP200 = dict(s=5, t=200, n=5, d=1, hidden=(32, 32), p=2308)


@pytest.mark.parametrize("work, shape, bound_ms", [
    (fused_svgd, SIN320, 0.003137),
    (fused_svgd_bign, T5N200, 0.0086),
    (fused_mlap_meta_test, MLAP200, 0.000340),
])
def test_bounds_of_perf_md(work, shape, bound_ms):
    least = 1e3 * peaks.least_s(work.flops_per_step(shape), 0)
    assert least == pytest.approx(bound_ms, abs=5e-7 if bound_ms < 1e-3 else 5e-5)


def test_the_step_count_follows_the_kernel_a_shape_takes():
    assert svgd_step.flops_per_step(SIN320) == fused_svgd.flops_per_step(SIN320)
    assert svgd_step.flops_per_step(T5N200) == fused_svgd_bign.flops_per_step(T5N200)


def test_bytes_are_far_below_the_operations_at_a_fit_launch():
    per_step = fused_svgd.bytes_per_launch(SIN320) / 10000
    assert per_step / peaks.HBM_BYTES < fused_svgd.flops_per_step(SIN320) / peaks.FLOAT32_FLOPS
