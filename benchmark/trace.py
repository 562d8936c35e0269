"""Reading a traced window: the profiler's Chrome trace, reduced to what the
per-layer readers and the breakdown need.

* Device operations are the trace's kernels, copies and sets.
* A device operation belongs to a span when the host call that launched
  it (the CUDA runtime or driver event with the same correlation id) lies
  inside a ``record_function`` span of that name on the same thread. This
  holds for the program's own kernels, which launch through ``ctypes``
  outside any aten op, as for every other launch. Launches from another
  thread (autograd's backward) belong to no span of the launching
  thread's caller.
* Busy time is the union of the device operations' intervals; the window
  is the traced wall time, which the harness measures around the traced
  steps.
"""

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    def __init__(self, events: List[dict], window_s: float, units: int):
        self.window_s = window_s
        self.units = units
        xs = [e for e in events if e.get("ph") == "X"]
        self.device = sorted((e for e in xs if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
        self.launch = {e["args"]["correlation"]: e for e in xs
                       if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.spans: Dict[str, Dict[Tuple, List[Tuple[float, float]]]] = defaultdict(
            lambda: defaultdict(list))
        for e in xs:
            if e.get("cat") == "user_annotation":
                self.spans[e["name"]][(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"]))
        for per_thread in self.spans.values():
            for key, v in per_thread.items():
                per_thread[key] = _union(v)
        self.host = [e for e in xs if e.get("cat") in HOST_CATS]

    @classmethod
    def from_file(cls, path: str, window_s: float, units: int) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"], window_s, units)

    # ---- device time ----

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, µs."""
        return _union([(e["ts"], e["ts"] + e["dur"]) for e in self.device])

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) / 1e6

    def device_s(self, events: Optional[List[dict]] = None) -> float:
        return sum(e["dur"] for e in (self.device if events is None else events)) / 1e6

    def in_span(self, name: str) -> List[dict]:
        """The device operations launched inside a span called ``name``."""
        per_thread = self.spans.get(name, {})
        out = []
        for e in self.device:
            launch = self.launch.get(e.get("args", {}).get("correlation"))
            if launch is None:
                continue
            iv = per_thread.get((launch["pid"], launch["tid"]))
            if not iv:
                continue
            i = bisect.bisect_right(iv, (launch["ts"], float("inf"))) - 1
            if i >= 0 and iv[i][0] <= launch["ts"] <= iv[i][1]:
                out.append(e)
        return out

    # ---- the breakdown ----

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, float] = defaultdict(float)
        for e in self.device:
            total[e["name"][:120]] += e["dur"] / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle device time between operations, summed by what the host was
        doing at each gap's middle: the innermost host event there on the
        thread that launched the most operations."""
        counts: Dict[Tuple, int] = defaultdict(int)
        for e in self.device:
            launch = self.launch.get(e.get("args", {}).get("correlation"))
            if launch is not None:
                counts[(launch["pid"], launch["tid"])] += 1
        if not counts:
            return []
        main = max(counts, key=counts.get)
        host = sorted((e for e in self.host if (e["pid"], e["tid"]) == main),
                      key=lambda e: (e["ts"], -e["dur"]))
        total: Dict[str, float] = defaultdict(float)
        iv = self.intervals()
        stack: List[dict] = []
        j = 0
        for (_, b), (a, _) in zip(iv, iv[1:]):
            mid = (a + b) / 2
            while j < len(host) and host[j]["ts"] <= mid:
                while stack and stack[-1]["ts"] + stack[-1]["dur"] < host[j]["ts"]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < mid:
                stack.pop()
            label = stack[-1]["name"][:120] if stack else "host: no traced call"
            total[label] += (a - b) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
