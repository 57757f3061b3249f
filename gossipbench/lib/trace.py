"""Reading a ``torch.profiler`` chrome trace: device intervals, their
union over the steady sub-window, kernel symbols, and the idle gaps named
by what the host was doing.

The sub-window runs from the first ``gossipbench.step`` span to the end of
the last. Device work is every ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` event whose launch (the runtime or driver call with the
same ``correlation``) lies in the sub-window, taken whole: the device's
timestamps may stand a millisecond or more off the host's, so a cut at
the host's span edges on the device's clock would drop or add the end of
a step. An event with no launch in the trace is cut at the edges. Busy
time is the union of the device intervals (a sum would count overlapping
streams twice).
"""

import dataclasses
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

STEP_SPAN = "gossipbench.step"
NAME_CHARS = 96  # a breakdown name's length (cuDNN's mangled names run to 2000)
SPAN_PREFIX = "gossipbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ANON = "(anonymous namespace)::"


def symbol(name: str) -> str:
    """A kernel's bare function name: ``void (anonymous
    namespace)::encode_kernel<false>(float const*, ...)`` ->
    ``encode_kernel``; a name with no signature is returned as it is."""
    s = name.replace(ANON, "").strip()
    if s.startswith("void "):
        s = s[5:]
    for stop in ("<", "("):
        if stop in s:
            s = s[: s.index(stop)]
    return s.rsplit("::", 1)[-1].strip()


@dataclasses.dataclass
class Summary:
    """What the readers take from one traced sub-window (seconds)."""

    steps: int
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]  # by symbol, kernels only
    device_ops: List[Tuple[str, float]]  # by symbol, every device op, longest first
    idle_gaps: List[Tuple[str, float]]  # longest first


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(events, t: float) -> str:
    best = None
    for e in events:
        if e["ts"] <= t <= e["ts"] + e["dur"]:
            if best is None or e["dur"] < best["dur"]:
                best = e
    return "" if best is None else best["name"]


def summarize(events: List[dict], top: int = 10) -> Summary:
    steps = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == STEP_SPAN]
    if not steps:
        raise ValueError("the trace holds no gossipbench.step span")
    w0 = min(float(e["ts"]) for e in steps)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in steps)
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device, kernel_s, op_s = [], defaultdict(float), defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        at = launched.get(e.get("args", {}).get("correlation"))
        if at is None:
            a, b = max(a, w0), min(b, w1)
        elif not w0 <= at <= w1:
            continue
        if b <= a:
            continue
        device.append((a, b))
        name = symbol(e["name"])[:NAME_CHARS] if e["cat"] == "kernel" else e["cat"]
        op_s[name] += (b - a) * 1e-6
        if e["cat"] == "kernel":
            kernel_s[name] += (b - a) * 1e-6
    merged = union(device)
    busy = sum(b - a for a, b in merged)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith(SPAN_PREFIX) and e["name"] != STEP_SPAN]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    named = []
    for length, start in gaps:
        mid = start + length / 2
        span = _innermost(spans, mid)[len(SPAN_PREFIX):] or "outside"
        op = _innermost(ops, mid)
        named.append((f"{span}/{op}" if op else span, length * 1e-6))
    return Summary(steps=len(steps), window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                   kernel_s=dict(kernel_s),
                   device_ops=sorted(op_s.items(), key=lambda kv: -kv[1])[:top],
                   idle_gaps=named)


def load(path: Path) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    for e in events:
        if "ts" in e:
            e["ts"] = float(e["ts"])
            e["dur"] = float(e.get("dur", 0.0))
    return events


def kernel_groups(root: Path) -> Dict[str, set]:
    """``{group: {symbol}}`` from every ``kernels/*.json`` file."""
    groups: Dict[str, set] = defaultdict(set)
    for path in sorted((root / "kernels").glob("*.json")):
        spec = json.loads(path.read_text())
        groups[spec["group"]].update(spec["symbols"])
    return dict(groups)
