"""Reading the program's own spans in a ``torch.profiler`` chrome trace.

The port opens a ``bluefog.<name>`` range around each dispatch
(``fused_train_step``, ``optimizer_step``, a collective's name) and, inside
its train step, around each phase: ``forward`` and ``backward`` once a
worker, ``update`` and ``combine`` once a step
(``bluefog_tpu_torch.timeline.span``). Each device event of the traced
sub-window (chosen as ``lib/trace.py`` chooses it: work whose launch lies
in the ``gossipbench.step`` spans, taken whole; work with no launch in the
trace cut at the edges) belongs to the innermost ``bluefog.*`` span that
holds its launch, the runtime or driver call with the same
``correlation``, made on any thread: the autograd engine launches the
backward's kernels from its own thread while the caller waits inside
``bluefog.backward``. Launches and spans are both on the host's clock, so
the device clock's offset moves no attribution. Work launched in no span,
or with no launch in the trace, is ``outside``.

Per span, over the traced steps: the union of its own device intervals
(work launched in a child span is the child's), the device events it
launched, its host time, the idle time of each gap of the device timeline
that its work ended, and the blocking runtime calls made inside it. A gap
between two pieces of device work is a length on the device's clock; the
two gaps at the sub-window's edges (before the first device work and
after the last) would mix the two clocks, and are ``EDGES``. The longest
gaps are also named ``<span>/<op>`` by the work that ended them: its span
and the operator (``cpu_op``) that launched it, on the launching thread;
a blocking call is named by its operator too.
"""

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from gossipbench.lib.trace import DEVICE_CATS, LAUNCH_CATS, NAME_CHARS, STEP_SPAN, symbol, union

PREFIX = "bluefog."
PHASES = ("forward", "backward", "update", "combine")
OUTSIDE = "outside"
EDGES = "edges"
# runtime calls that hold the host until the device or its allocator
# answers, as the trace names them
BLOCKING = ("cudaMalloc", "cudaFree")
BLOCKING_SUFFIX = "Synchronize"


@dataclasses.dataclass
class SpanStats:
    """One span name's totals over the traced steps (seconds)."""

    device_s: float = 0.0  # the union of its own device intervals
    launches: int = 0  # device events (kernels, copies, sets) it launched
    host_s: float = 0.0  # its host duration, summed over its instances
    idle_s: float = 0.0  # the device gaps that its work ended
    # blocking runtime calls inside it: "<call>/<op>" -> [count, host s]
    blocking: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    kernel_s: Dict[str, float] = dataclasses.field(default_factory=dict)  # by symbol


@dataclasses.dataclass
class Spans:
    """What the span readers take from one traced sub-window."""

    steps: int
    window_s: float  # the sub-window, lib/trace.py's
    busy_s: float  # the union of every device interval
    phases_busy_s: float  # the union of the device intervals of the four phases
    by_span: Dict[str, SpanStats]  # by name less the prefix, ``outside`` included
    idle_spans: List[Tuple[str, float]]  # (span or EDGES, idle s), longest first
    gaps: List[Tuple[str, float]]  # ("<span>/<op>", s), the longest interior gaps


def _is_blocking(name: str) -> bool:
    return name in BLOCKING or name.endswith(BLOCKING_SUFFIX)


def _owner(spans: List[Tuple[float, float, str]], t: float) -> str:
    """The innermost span (the shortest) holding the host time ``t``."""
    best, best_dur = OUTSIDE, None
    for a, b, name in spans:
        if a <= t <= b and (best_dur is None or b - a < best_dur):
            best, best_dur = name, b - a
    return best


class _Ops:
    """The operators (``cpu_op``) of each thread, to name a host time by
    the innermost one open at it."""

    def __init__(self, events: List[dict]):
        self.by_tid: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
        for e in events:
            if e.get("cat") == "cpu_op":
                a = float(e["ts"])
                self.by_tid[e.get("tid")].append((a, a + float(e.get("dur", 0.0)), e["name"]))

    def at(self, tid, t: float) -> str:
        name = _owner(self.by_tid.get(tid, []), t)
        return "" if name == OUTSIDE else name


def _named(span: str, op: str) -> str:
    return f"{span}/{op}" if op else span


# The sub-window and the launches are lib/trace.py::summarize's, which keeps
# them inline; test_gossipbench_spans.py holds the two readings equal.
def _window(events: List[dict]) -> Tuple[int, float, float]:
    """``(steps, first step's start, last step's end)`` in microseconds."""
    steps = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == STEP_SPAN]
    if not steps:
        raise ValueError("the trace holds no gossipbench.step span")
    return (len(steps), min(float(e["ts"]) for e in steps),
            max(float(e["ts"]) + float(e["dur"]) for e in steps))


def _launches(events: List[dict]):
    """The runtime and driver calls, the launches among them by correlation."""
    return [e for e in events if e.get("cat") in LAUNCH_CATS]


def summarize(events: List[dict], top: int = 10) -> Spans:
    n_steps, w0, w1 = _window(events)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(PREFIX):])
             for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith(PREFIX) and w0 <= float(e["ts"]) <= w1]
    stats: Dict[str, SpanStats] = defaultdict(SpanStats)
    for a, b, name in spans:
        stats[name].host_s += (b - a) * 1e-6
    ops = _Ops(events)
    launched = {}
    for e in _launches(events):
        at = float(e["ts"])
        if "correlation" in e.get("args", {}):
            launched[e["args"]["correlation"]] = (at, e.get("tid"))
        if w0 <= at <= w1 and _is_blocking(e["name"]):
            call = stats[_owner(spans, at)].blocking.setdefault(
                _named(e["name"], ops.at(e.get("tid"), at)), [0, 0.0])
            call[0] += 1
            call[1] += float(e.get("dur", 0.0)) * 1e-6
    work: List[Tuple[float, float, str, tuple]] = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        launch = launched.get(e.get("args", {}).get("correlation"))
        if launch is None:
            a, b, owner = max(a, w0), min(b, w1), OUTSIDE
        elif not w0 <= launch[0] <= w1:
            continue
        else:
            owner = _owner(spans, launch[0])
        if b <= a:
            continue
        work.append((a, b, owner, launch))
        s = stats[owner]
        s.launches += 1
        if e["cat"] == "kernel":
            name = symbol(e["name"])[:NAME_CHARS]
            s.kernel_s[name] = s.kernel_s.get(name, 0.0) + (b - a) * 1e-6
    by_owner: Dict[str, list] = defaultdict(list)
    for a, b, owner, _l in work:
        by_owner[owner].append((a, b))
    for owner, intervals in by_owner.items():
        stats[owner].device_s = sum(b - a for a, b in union(intervals)) * 1e-6
    idle: Dict[str, float] = defaultdict(float)
    gaps = []  # (length, owner, launch of the work that ended it)
    end = None
    for a, b, owner, launch in sorted(work, key=lambda w: (w[0], w[1])):
        if end is None:
            idle[EDGES] += max(a - w0, 0.0)
        elif a > end:
            idle[owner] += a - end
            gaps.append((a - end, owner, launch))
        end = b if end is None else max(end, b)
    idle[EDGES] += max(w1 - end, 0.0) if end is not None else w1 - w0
    for owner, gap in idle.items():
        if owner != EDGES:
            stats[owner].idle_s = gap * 1e-6
    merged = union([(a, b) for a, b, _o, _l in work])
    phases = union([(a, b) for a, b, o, _l in work if o in PHASES])
    named = [(_named(owner, ops.at(launch[1], launch[0]) if launch else ""), length * 1e-6)
             for length, owner, launch in sorted(gaps, key=lambda g: -g[0])[:top]]
    return Spans(steps=n_steps, window_s=(w1 - w0) * 1e-6,
                 busy_s=sum(b - a for a, b in merged) * 1e-6, phases_busy_s=sum(b - a for a, b in phases) * 1e-6, by_span=dict(stats),
                 idle_spans=sorted(((k, v * 1e-6) for k, v in idle.items() if v > 0),
                                   key=lambda kv: -kv[1]), gaps=named)


def phase_ms(spans: Optional[Spans], phase: str) -> Optional[float]:
    """Device milliseconds a step of ``phase``'s own work; None where the
    trace holds no such span or no device work at all."""
    if spans is None or spans.busy_s <= 0 or phase not in spans.by_span:
        return None
    return 1e3 * spans.by_span[phase].device_s / spans.steps


def idle_spans_ms(spans: Spans) -> List[List]:
    """``[[span, idle ms a step], ...]``, longest first."""
    return [[name, 1e3 * s / spans.steps] for name, s in spans.idle_spans]


def lines(spans: Spans) -> List[str]:
    """One line a span, by device time: host, device and idle ms, launches
    and blocking calls, each a step."""
    n = spans.steps
    out = []
    for name, s in sorted(spans.by_span.items(), key=lambda kv: -kv[1].device_s):
        calls = ", ".join(f"{k} {c / n:g} ({1e3 * t / n:.3f} ms)"
                          for k, (c, t) in sorted(s.blocking.items())) or "none"
        out.append(f"span {name}: host {1e3 * s.host_s / n:.3f} ms, device "
                   f"{1e3 * s.device_s / n:.3f} ms, launches {s.launches / n:g}, idle "
                   f"{1e3 * s.idle_s / n:.3f} ms, blocking calls {calls} a step")
    return out
