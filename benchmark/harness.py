"""One run of one cell: discovery by name, set-up, the measured window, the
traced window, the check of ``correct``, and the result line.

Everything is found by the names in ``BENCHMARK.json``:

* the cell ``benchmark/workloads/<cell>.json`` (the limits of its check);
* its configuration ``benchmark/configs/<config>.json``;
* its traffic mix ``benchmark/traffic/<traffic>.json``, whose ``driver``
  names ``benchmark/drivers/<driver>.py``;
* each per-layer metric's reader ``benchmark/layer_metrics/<metric>.py``.

A driver module has ``setup(ctx) → state``, ``window(ctx, state, seconds)
→ Window``, ``unit(ctx, state)`` (one step of the traced window),
``evidence(ctx, state)`` (what the check needs, after which the program's
state is dropped) and ``check(ctx, evidence) → [Check]``.
"""

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import imports
from .trace import Trace

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(REPO / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # the cell's entry in BENCHMARK.json
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def cell(name: str, spec: Optional[dict] = None) -> Cell:
    """The cell ``name`` with its files and the metrics it reports."""
    spec = spec or benchmark_spec()
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m["workloads"] or ("workloads" not in m and m["moves"] in e2e_names)]
    return Cell(name=name, entry=entry,
                config=load_json(ROOT / "configs" / f"{entry['config']}.json"),
                traffic=load_json(ROOT / "traffic" / f"{entry['traffic']}.json"),
                workload=load_json(ROOT / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def driver(name: str):
    return importlib.import_module(f"{__package__}.drivers.{name}")


def reader(metric: str) -> Callable:
    """``read(ctx) → float | None`` of ``layer_metrics/<metric>.py``."""
    path = ROOT / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"{__package__}.layer_metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def subseed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for each of a run's random streams
    (weights, body model, inputs, dropout), from the run's seed."""
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (1 << 63)


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    device: torch.device
    sizes: dict                 # the traffic's and configuration's sizes, tests may shrink them
    control: Optional[str] = None   # a lower-precision stand-in (calibrate.py)
    fault: Optional[str] = None     # a planted fault (calibrate.py)
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (reported on standard error)."""
        self.phases[name] = time.perf_counter()

    @property
    def cfg(self) -> dict:
        return self.cell.config

    def seed_of(self, stream: int) -> int:
        return subseed(self.seed, stream)


@dataclasses.dataclass
class Window:
    """The measured window: its end-to-end metrics, the work attempted and
    failed, its length and its steps."""
    metrics: Dict[str, float]
    attempted: int
    failed: int
    seconds: float
    units: int


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: Optional[float] = None
    detail: Optional[dict] = None   # where the value came from (calibrate.py prints it)

    @property
    def ok(self) -> bool:
        return self.limit is not None and self.value == self.value and self.value <= self.limit


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"


def traced_window(ctx: Context, drv, state, units: int) -> Trace:
    """``units`` steps under the profiler; the Chrome trace goes to a
    temporary file, is read and deleted."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        sync(ctx.device)
        t0 = time.perf_counter()
        for _ in range(units):
            drv.unit(ctx, state)
        sync(ctx.device)
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Trace.from_file(path, window_s, units)
    finally:
        os.unlink(path)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx: Context, seconds: float, trace: bool, t_start: float) -> dict:
    """Set up, measure, check; → the result dict (``checks`` last)."""
    drv = driver(ctx.cell.traffic["driver"])
    dev = ctx.device
    ctx.phases = {"start": t_start}
    if dev.type == "cuda":
        torch.zeros(1, device=dev)          # the device's allocator, before its peak is reset
        torch.cuda.reset_peak_memory_stats(dev)
    ctx.phase("device")
    state = drv.setup(ctx)
    sync(dev)
    setup_s = time.perf_counter() - t_start
    ctx.phase("setup")
    win = drv.window(ctx, state, seconds)
    tr = traced_window(ctx, drv, state, ctx.sizes["trace_units"]) if trace else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ev = drv.evidence(ctx, state)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check(ctx, ev)
    del ev

    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device["power_limit"] = power_limit()
    result = {"correct": all(c.ok for c in checks), "attempted": win.attempted,
              "failed": win.failed}
    if trace:
        rctx = ReadContext(ctx=ctx, trace=tr, window=win)
        metrics = {}
        for m in ctx.cell.per_layer:
            value = reader(m["name"])(rctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        result["metrics"] = metrics
        result["device"] = device
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        values = dict(win.metrics, setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in ctx.cell.end_to_end}
        result["device"] = device
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    result["_details"] = {c.name: c.detail for c in checks if c.detail}
    return result


@dataclasses.dataclass
class ReadContext:
    """What a per-layer reader gets: the run's context, the traced window
    (``trace.units`` steps over ``trace.window_s``) and the measured one."""
    ctx: Context
    trace: Trace
    window: Window


def sizes(c: Cell, **overrides) -> dict:
    """The sizes a run uses: the traffic's and the configuration's, with
    ``overrides`` (the tests' small sizes)."""
    out = dict(c.traffic)
    out.setdefault("crop", c.config["crop"])
    out.setdefault("num_vertices", c.config["smplx"]["num_vertices"])
    out.update(overrides)
    return out


def main(args, t_start: float) -> int:
    c = cell(args.workload)
    chips = c.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell {c.name} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    ctx = Context(cell=c, seed=args.seed, device=torch.device("cuda", 0), sizes=sizes(c))
    result = run(ctx, args.seconds, bool(args.trace), t_start)
    result.pop("_details")
    marks = list(ctx.phases.items())
    print("setup phases (s): " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                                           for a, b in zip(marks, marks[1:])), file=sys.stderr)
    bad = imports.loaded_forbidden()
    if bad:
        print(f"benchmark: the run loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    for name, chk in result["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
