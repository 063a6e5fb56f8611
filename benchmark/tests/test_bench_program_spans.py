"""The reduction of the program's ``pacoh.*`` spans (``benchmark/program_spans.py``)
and its readers, on synthetic traces (``trace.Summary`` of made-up events,
times in ns) and on one traced run of a fit cell on the CPU."""

import pytest
import torch

from benchmark import harness, program_spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
NEW = ("learner_self_ms_per_fit.fit", "trainer_self_ms_per_fit.fit", "learner_idle_pct.fit",
       "trainer_idle_pct.fit")


class Event:
    """What ``trace.Summary`` reads of a profiler event."""

    def __init__(self, name, start, end, device=CPU, kind="user_annotation"):
        self._name, self._start, self._dur = name, start, end - start
        self._device, self._kind = device, kind

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._device

    def activity_type(self):
        return self._kind


def kernel(name, start, end):
    return Event(name, start, end, CUDA, "kernel")


def summary(events, t0=0, t1=1000):
    return trace.Summary(events, t0, t1)


class Run:
    def __init__(self, events, fits=1, t1=1000):
        self.trace = summary(events, t1=t1)
        self.driver = type("Driver", (), {"records": [{}] * fits})()


def read(metric, run):
    return harness.reader(metric)(run)


# One fit, 0-1000 ns: the learner's construction 100-300 (data preparation
# 150-200 inside), its meta_fit 400-900 with the trainer's build 450-500 and
# launch 600-700 inside; the kernel runs 680-980, a copy 160-170.
FIT = [Event("pacoh.learner.init", 100, 300), Event("pacoh.learner.prepare", 150, 200),
       Event("pacoh.learner.meta_fit", 400, 900), Event("pacoh.trainer.build", 450, 500),
       Event("pacoh.trainer.launch", 600, 700), kernel("fused_svgd_kernel", 680, 980),
       Event("Memcpy HtoD", 160, 170, CUDA, "gpu_memcpy")]


def test_self_time_subtracts_child_spans_and_the_host_s_waits():
    s = summary(FIT)
    # init 200 - prepare 50, prepare 50, meta_fit 500 - build 50 - launch 100
    assert program_spans.self_ns(s, program_spans.LEARNER) == 150 + 50 + 350
    assert program_spans.self_ns(s, program_spans.TRAINER) == 50 + 100
    assert program_spans.self_ns(s, program_spans.LEARNER, [(0, 175)]) == 50 + 25
    assert read("learner_self_ms_per_fit.fit", Run(FIT, fits=2)) == pytest.approx(275e-6)
    # a read-back in the construction waits 220-260 for the device, the launch's 640-650
    waits = [Event("cudaStreamSynchronize", 220, 260, kind="cuda_runtime"),
             Event("cudaDeviceSynchronize", 640, 650, kind="cuda_runtime")]
    s = summary(FIT + waits)
    assert program_spans.self_ns(s, program_spans.LEARNER) == 150 + 50 + 350 - 40
    assert program_spans.self_ns(s, program_spans.TRAINER) == 50 + 100 - 10


def test_a_gap_across_learner_trainer_and_harness_is_split_among_them():
    s = summary(FIT)
    # idle: 0-160, 170-680, 980-1000
    assert program_spans.idle_intervals(s) == [(0, 160), (170, 680), (980, 1000)]
    learner = program_spans.idle_ns(s, program_spans.LEARNER)
    trainer = program_spans.idle_ns(s, program_spans.TRAINER)
    # learner: init 100-150, prepare 150-160 and 170-200, init 200-300,
    # meta_fit 400-450, 500-600; trainer: build 450-500, launch 600-680
    assert learner == 50 + 10 + 30 + 100 + 50 + 100
    assert trainer == 50 + 80
    harness_idle = 160 + 510 + 20 - learner - trainer  # 0-100, 300-400, 980-1000
    assert harness_idle == 100 + 100 + 20
    assert read("learner_idle_pct.fit", Run(FIT)) == pytest.approx(34.0)
    assert read("trainer_idle_pct.fit", Run(FIT)) == pytest.approx(13.0)


def test_a_span_that_outlasts_its_parent_is_cut_at_the_parent_s_end():
    pieces = program_spans.owners([("pacoh.learner.meta_fit", 0, 100),
                                   ("pacoh.trainer.launch", 50, 150)])
    assert pieces == [(0, 50, "pacoh.learner.meta_fit"), (50, 100, "pacoh.trainer.launch")]


@pytest.mark.parametrize("seed", range(6))
def test_the_layer_idle_shares_sum_to_no_more_than_the_device_idle_share(seed):
    gen = torch.Generator().manual_seed(seed)

    def draw(lo, hi):
        a, b = sorted(int(v) for v in torch.randint(lo, hi, (2,), generator=gen))
        return a, b + 1

    events, t = [], 0
    for _ in range(8):  # fits one after another, each with nested spans and kernels
        a, b = draw(t, t + 400)
        events.append(Event("pacoh.learner.meta_fit", a, b))
        c, d = draw(a, b)
        events.append(Event("pacoh.trainer.launch", c, min(d, b)))
        e, f = draw(c, c + 300)
        events.append(kernel("k", e, f))
        t = b + 1
    run = Run(events, fits=8, t1=t + 50)
    idle = read("device_idle_pct.fit", run)
    shares = read("learner_idle_pct.fit", run) + read("trainer_idle_pct.fit", run)
    assert 0 < shares <= idle + 1e-9


def test_the_program_s_spans_are_no_device_operations():
    mirrors = [Event(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(), CUDA,
                     "gpu_user_annotation") for ev in FIT if ev.name().startswith("pacoh.")]
    plain, spanned = Run(FIT[-2:]), Run(FIT + mirrors)
    assert [n for n, _, _ in spanned.trace.device] == [n for n, _, _ in plain.trace.device]
    for metric in ("launches_per_fit.fit", "device_idle_pct.fit"):
        assert read(metric, spanned) == read(metric, plain)


def test_without_the_program_s_spans_the_readers_return_nothing():
    run = Run(FIT[-2:])
    for metric in NEW + ("learner_self_ms_per_call.meta_test", "learner_idle_pct.meta_test"):
        assert read(metric, run) is None


def test_the_meta_test_readers_take_the_learner_s_share_of_the_benchmark_s_calls():
    calls = [Event("bench.call", 0, 175), Event("bench.call", 400, 900)]
    run = Run(FIT + calls)
    assert len(run.trace.spans) == 2
    # learner self time: init 100-150 and prepare 150-175 in the first call,
    # meta_fit 400-450, 500-600 and 700-900 in the second, over two calls
    assert read("learner_self_ms_per_call.meta_test", run) == pytest.approx(212.5e-6)
    assert read("learner_idle_pct.meta_test", run) == pytest.approx(34.0)


def test_a_traced_fit_cell_reports_the_span_metrics_on_the_cpu():
    out = harness.run_cell("svgd_sin320_fit", 2 ** 31 + 77, 0.2, True, device="cpu",
                           overrides={"config": {"kwargs": {"num_iter_fit": 4}},
                                      "traffic": {"n_tasks": 6}})
    got = {name: out["metrics"][name]["value"] for name in NEW}
    assert all(v > 0 for v in got.values())
    assert got["learner_idle_pct.fit"] + got["trainer_idle_pct.fit"] <= 100.0
