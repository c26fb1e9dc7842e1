"""Device time by kernel, busy and idle share and the longest idle gaps of a
``torch.profiler`` Chrome trace.

A copy of ``scripts/torch_trace_summary.py`` (its arithmetic, frozen here so
that a change to the program cannot change the yardstick).  Standard library
only.  A trace with no device events (a run on the CPU) is refused: its busy
share is not measured, not 0.
"""

from __future__ import annotations

import collections
import json
import re
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
HAND_WRITTEN = ("jet_layernorm", "jet_gemm", "jet_softmax_values")
GAPS = 10  # the longest idle gaps listed


def load_events(path: str | Path) -> list[dict]:
    """The complete (``ph == "X"``) events of ``path`` (a trace file, or a
    directory holding ``trace.json``)."""
    path = Path(path)
    if path.is_dir():
        path = path / "trace.json"
    with open(path, encoding="utf8") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]


def categorise(name: str, cat: str) -> str:
    """The port's hand-written kernel by name, else the functional category."""
    for kernel in HAND_WRITTEN:
        if kernel in name:
            return kernel
    lower = name.lower()
    if cat != "kernel" or re.search(r"memcpy|memset|copy|cat_|transpose", lower):
        return "copy"
    if re.search(r"gemm|gemv|cutlass|cublas|matmul|xmma|sm90_|sm80_|ampere_|hopper|wgmma", lower):
        return "library GEMM"
    if re.search(r"reduce|reduction|norm|softmax|sum|mean|scan|sort|topk|argmax", lower):
        return "reduction"
    if re.search(r"elementwise|vectorized|unrolled|pointwise|foreach|fill|where|exp|sqrt", lower):
        return "elementwise"
    return "other"


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def spanning_host_op(host: list[dict], start: float, end: float) -> str | None:
    """The innermost host event that holds ``[start, end]``, else the one that
    overlaps it most, else ``None``."""
    holding = [e for e in host if e["ts"] <= start and e["ts"] + e["dur"] >= end]
    if holding:
        return min(holding, key=lambda e: e["dur"])["name"]
    overlap = [(min(end, e["ts"] + e["dur"]) - max(start, e["ts"]), e) for e in host]
    overlap = [(o, e) for o, e in overlap if o > 0]
    return max(overlap, key=lambda p: p[0])[1]["name"] if overlap else None


def summarise(events: list[dict], top: int = 25, iters: int | None = None) -> dict:
    """Device time by kernel and category, the busy share and the longest gaps.

    Times in ms (trace timestamps are µs).  Raises ``ValueError`` if the trace
    has no device event.
    """
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if not device:
        raise ValueError("the trace has no device events: the device's busy share is not measured")
    host = [e for e in events if e.get("cat") in HOST_CATEGORIES]
    starts = [e["ts"] for e in host] + [e["ts"] for e in device]
    window = (min(starts), max(e["ts"] + e["dur"] for e in device))
    span_us = window[1] - window[0]

    time_by_name: collections.Counter = collections.Counter()
    count_by_name: collections.Counter = collections.Counter()
    category_of = {}
    for e in device:
        time_by_name[e["name"]] += e["dur"] / 1e3
        count_by_name[e["name"]] += 1
        category_of[e["name"]] = categorise(e["name"], e["cat"])
    kernel_ms = sum(time_by_name.values())
    by_category: dict[str, dict] = {}
    for name, ms in time_by_name.items():
        row = by_category.setdefault(category_of[name], {"ms": 0.0, "launches": 0})
        row["ms"] += ms
        row["launches"] += count_by_name[name]
    for row in by_category.values():
        row["share"] = row["ms"] / kernel_ms

    busy = merge([(e["ts"], e["ts"] + e["dur"]) for e in device])
    busy_us = sum(end - start for start, end in busy)
    idle = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy[0][0] > window[0]:
        idle.insert(0, (window[0], busy[0][0]))
    longest = sorted(idle, key=lambda g: g[0] - g[1])[:GAPS]
    summary = {
        "window_ms": span_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "busy_share": busy_us / span_us,
        "idle_share": 1 - busy_us / span_us,
        "device_events": len(device),
        "kernel_ms": kernel_ms,
        "kernel_launches": sum(1 for e in device if e.get("cat") == "kernel"),
        "ms_by_name": dict(time_by_name),
        "hand_written_launches": {
            k: by_category.get(k, {}).get("launches", 0) for k in HAND_WRITTEN},
        "categories": dict(sorted(by_category.items(), key=lambda kv: -kv[1]["ms"])),
        "top": [{"name": name, "category": category_of[name], "ms": ms,
                 "launches": count_by_name[name], "share": ms / kernel_ms}
                for name, ms in time_by_name.most_common(top)],
        "gaps": [{"start_ms": (start - window[0]) / 1e3, "ms": (end - start) / 1e3,
                  "host_op": spanning_host_op(host, start, end)} for start, end in longest],
    }
    if iters:
        summary["per_iteration"] = {
            "iterations": iters,
            "window_ms": summary["window_ms"] / iters,
            "device_busy_ms": summary["device_busy_ms"] / iters,
            "kernel_ms": kernel_ms / iters,
            "launches": {k: v["launches"] / iters for k, v in by_category.items()},
            "category_ms": {k: v["ms"] / iters for k, v in by_category.items()},
        }
    return summary
