"""The benchmark's core: it finds a cell's files by the names in
``BENCHMARK.json``, runs its driver's set-up, measured window and output
check, reads its per-layer metrics from a traced window, and assembles the
result line.

A cell is one entry of ``workloads``. Its configuration is
``benchmark/configs/<config>.json`` (the learner and its keywords), its
traffic ``benchmark/traffic/<traffic>.json`` (the data and the driver that
runs it: ``benchmark/drivers/<driver>.py``), its output limits
``benchmark/limits/<cell>.json``, and each per-layer metric a reader
``benchmark/metrics/<metric>.py``. A later cell, configuration, traffic mix
or metric is new files and new entries; nothing here names one. A cell held
out of BENCHMARK.json keeps its entries in ``benchmark/pending.json``.
"""

import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "meta_learning_pacoh_tpu")
TRACE_DIR = os.path.join(ROOT, "bench_out")


def load(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load(os.path.join(ROOT, "BENCHMARK.json"))


def pending():
    """``benchmark/pending.json``: entries, in BENCHMARK.json's form, of cells
    that are built and measured but held out of BENCHMARK.json (``PERF.md``
    says why); ``run.py`` and the tests still run them by name."""
    return load(os.path.join(BENCH_DIR, "pending.json"))


def entries():
    """BENCHMARK.json's configurations, cells and metrics with the pending ones."""
    spec, held = benchmark(), pending()
    return {k: spec[k] + held.get(k, []) for k in ("configs", "workloads", "end_to_end",
                                                  "per_layer")}


class Cell:
    """A cell of ``BENCHMARK.json`` with its files: ``workload`` (the entry),
    ``config``, ``traffic``, ``limits``, ``end_to_end`` and ``per_layer``
    (the metric entries it reports)."""

    def __init__(self, name, overrides=None):
        spec = entries()
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json or benchmark/pending.json")
        self.name = name
        self.workload = cells[name]
        self.config = load(os.path.join(BENCH_DIR, "configs", self.workload["config"] + ".json"))
        self.traffic = load(os.path.join(BENCH_DIR, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load(os.path.join(BENCH_DIR, "limits", name + ".json"))
        for part, changes in (overrides or {}).items():  # smaller sizes, for the tests
            merged = {**getattr(self, part), **changes}
            if "kwargs" in changes:
                merged["kwargs"] = {**getattr(self, part)["kwargs"], **changes["kwargs"]}
            setattr(self, part, merged)
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name] if m["moves"] in moved else [])]


def driver_class(name):
    return importlib.import_module(f"benchmark.drivers.{name}").Driver


def reader(metric):
    """The ``read(run)`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def process_age_s():
    """Seconds since this process started (the kernel's start time of it)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def card_limits():
    """[(name, power.limit)] of the cards, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return [("nvidia-smi failed", str(err))]
    return [tuple(p.strip() for p in line.split(",")) for line in out.strip().splitlines()]


class Run:
    """What a per-layer reader reads: the driver (its records and the cell's
    shapes) and the trace's ``Summary``."""

    def __init__(self, driver, summary):
        self.driver = driver
        self.trace = summary


def run_cell(name, seed, seconds, trace, device="cuda", t_start=None, overrides=None):
    """One run of cell ``name``: set-up, the window of ``seconds`` (traced
    with ``trace``), the output check. Returns the result line's dict.

    ``device`` "cpu" runs the program on the CPU at the traffic's sizes (the
    tests give small ones through ``overrides``, {"config" | "traffic" |
    "limits": changed keys}); a device number is then never reported."""
    t_start = time.perf_counter() if t_start is None else t_start
    age0 = process_age_s() - (time.perf_counter() - t_start)
    cell = Cell(name, overrides)
    driver = driver_class(cell.traffic["driver"])(cell, int(seed), device)
    driver.setup(seconds)
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    setup_s = age0 + time.perf_counter() - t_start

    summary = None
    if trace:
        from benchmark import trace as tracing

        prof = tracing.session()
        with prof:
            with torch.profiler.record_function(tracing.WINDOW):
                driver.window(seconds, torch.profiler.record_function)
        out = os.path.join(TRACE_DIR, f"{name}.seed{seed}.trace.json.gz") if on_card else None
        summary = tracing.reduce(prof, out)
    else:
        driver.window(seconds, lambda _: contextlib.nullcontext())

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules the benchmark may not load are loaded: {found}")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    driver.release()
    checks = driver.checks()

    if trace:
        run = Run(driver, summary)
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        values = driver.end_to_end()
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(driver.failed == 0 and all(v <= lim for _, v, lim in checks)),
              "attempted": int(driver.attempted), "failed": int(driver.failed),
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = summary.busy_s()
        device_info["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = {n: {"value": float(v), "limit": float(lim)} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    return result
