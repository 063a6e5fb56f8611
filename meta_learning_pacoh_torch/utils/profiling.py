"""Profiling/tracing helpers (counterpart of meta_learning_pacoh_tpu/utils/profiling.py).

`trace(log_dir)` wraps a code block in a ``torch.profiler`` trace of the
host and the card (CPU and CUDA activities), written as a Chrome trace into
``log_dir`` (viewable in Perfetto or chrome://tracing); `StepTimer`
collects steady-state steps/sec without the warm-up, whose first record
holds the kernel build and the cuBLAS set-up.
"""

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


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
    warm-up (the kernel build, the cuBLAS set-up) via `skip_first`. A block
    that queues work on the card should end with a read-back or a
    synchronize, so that its time holds the card's."""

    def __init__(self, skip_first=True):
        self.skip_first = skip_first
        self.records = []

    @contextlib.contextmanager
    def measure(self, n_steps):
        t0 = time.time()
        yield
        self.records.append((n_steps, time.time() - t0))

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
