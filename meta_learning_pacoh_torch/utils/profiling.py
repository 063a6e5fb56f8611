"""Profiling/tracing helpers (counterpart of meta_learning_pacoh_tpu/utils/profiling.py).

`trace(log_dir)` wraps a code block in a ``torch.profiler`` trace of the
host and the card (CPU and CUDA activities), written as a Chrome trace into
``log_dir`` (viewable in Perfetto or chrome://tracing); `StepTimer`
collects steady-state steps/sec without the warm-up, whose first record
holds the kernel build and the cuBLAS set-up.

`span(name)` marks a stage of the program for such a trace: while a
``torch.profiler`` session records, it is a profiler range of that name, so
the stage lands in the same trace as the card's kernels, copies and fills,
on one clock; while none records, it is the shared no-op ``OFF``, for the
cost of one flag read. `spanned(name)` is its decorator form, which decides at
each call. A span never synchronizes, allocates or touches the device: it
ends when the host returns. Spans nest on the one host thread.

Span names are the constants below, ``pacoh.<layer>.<stage>``, the layer
words those of the layer map: ``learner`` the algos learners, ``trainer``
the ``ops.cuda`` fused trainers, ``ops`` the general ops a learner calls.
"""

import contextlib
import functools
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile

LEARNER_INIT = "pacoh.learner.init"  # a learner's constructor
LEARNER_PREPARE = "pacoh.learner.prepare"  # stacking and normalising task tuples
LEARNER_META_FIT = "pacoh.learner.meta_fit"
LEARNER_GATE = "pacoh.learner.gate"  # whether a fused kernel takes the fit or meta-test
LEARNER_STEP = "pacoh.learner.step"  # one general step
LEARNER_META_TEST = "pacoh.learner.meta_test"  # MLAP's inference of the task posteriors
LEARNER_EVAL = "pacoh.learner.eval"  # MLAP's metrics after the inference
TRAINER_BUILD = "pacoh.trainer.build"  # a fused trainer's constructor
TRAINER_PAGES = "pacoh.trainer.pages"  # a launch's count or noise pages
TRAINER_LAUNCH = "pacoh.trainer.launch"  # operand checks to the C call's return
OPS_SCORE = "pacoh.ops.score"  # the particles' score by autograd
OPS_TRANSPORT = "pacoh.ops.transport"  # the Stein transport
OPS_UPDATE = "pacoh.ops.update"  # the optimizer's step
OPS_PREDICTIVE = "pacoh.ops.predictive"  # MLAP's predictive moments
SPANS = (LEARNER_INIT, LEARNER_PREPARE, LEARNER_META_FIT, LEARNER_GATE, LEARNER_STEP,
         LEARNER_META_TEST, LEARNER_EVAL, TRAINER_BUILD, TRAINER_PAGES, TRAINER_LAUNCH,
         OPS_SCORE, OPS_TRANSPORT, OPS_UPDATE, OPS_PREDICTIVE)


class _Off:
    """The span while no profiler records: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


def span(name):
    """A context of the stage ``name`` (one of ``SPANS``): a profiler range
    while a ``torch.profiler`` session records, else ``OFF``. The flag is
    torch's own, set while any session records; a bare ``record_function``
    costs about 10 us a call even with no session.

    The range is torch's fast RecordFunction, which the trace holds as a
    host operator. A ``record_function`` range is a user annotation, which
    the profiler mirrors onto the device's timeline over the kernels
    launched inside it; a trace reader whose torch gives no event kinds
    cannot tell that mirror from device work."""
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return OFF


def spanned(name):
    """Decorator: the function runs inside ``span(name)``, decided at each call."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


@contextlib.contextmanager
def trace(log_dir="./torch-trace", create_perfetto_link=False):
    """Capture a ``torch.profiler`` trace (operators on the host, kernels on
    the card where there is one) of the block; yields the profiler and
    writes ``<log_dir>/trace.json`` at the end. ``create_perfetto_link``
    keeps the JAX signature and is unused: the file opens in Perfetto."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Accumulates (steps, seconds) pairs; first call can be discarded as the
    warm-up (the kernel build, the cuBLAS set-up) via `skip_first`. Each
    record is monotonic wall time (``time.perf_counter``) and, where CUDA is
    initialized, ends with a ``torch.cuda.synchronize``, so that it holds
    the work the block queued on the card."""

    def __init__(self, skip_first=True):
        self.skip_first = skip_first
        self.records = []

    @contextlib.contextmanager
    def measure(self, n_steps):
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.records.append((n_steps, time.perf_counter() - t0))

    @property
    def steps_per_sec(self):
        recs = self.records[1:] if (self.skip_first and len(self.records) > 1) \
            else self.records
        total_steps = sum(n for n, _ in recs)
        total_time = sum(t for _, t in recs)
        return total_steps / total_time if total_time > 0 else float("nan")

    def summary(self):
        return {
            "steps_per_sec": self.steps_per_sec,
            "n_measurements": len(self.records),
            "compile_overhead_sec": (
                self.records[0][1] - self.records[1][1]
                if len(self.records) > 1 and self.records[0][0] == self.records[1][0]
                else None
            ),
        }
