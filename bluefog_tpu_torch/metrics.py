# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Telemetry: the host registry of counters, gauges and histograms, its
three exporters, and the sampled gossip-health probe of the device tier.

Counterpart of ``bluefog_tpu/metrics.py``.

**Host tier.** A process-wide registry fed by the runtime: plan-cache hits
and misses, rounds and wire bytes per gossip step, window ops, the
asynchronous engine's ticks, watchdog stalls. It records whether or not
the device tier is on. The JAX package also counts ``bluefog.recompiles``
(a fresh XLA program); eager PyTorch builds no program, and no cache of
the port is keyed the way JAX keys its programs, so the port does not
emit that series (nor the flight recorder's ``compile`` events).

**Device tier** (``BLUEFOG_METRICS=1``): on one communicating step in
``BLUEFOG_METRICS_INTERVAL`` (default 10) the optimizer runs a *sub-gossip*
probe: the same combine, on the same wire, over a 512-aligned prefix of at
most ``BLUEFOG_METRICS_SAMPLE_ELEMS`` elements of each packed dtype group
of its input (on the error-feedback tiers over copies of the prefix of the
CHOCO state, which are then dropped). The combine is elementwise, and the
quantized wire is block-local on 512-element blocks, so the probe's output
is bitwise the first columns of the full combine's. The probe touches
nothing the training state is computed from, and a step that is not
sampled runs exactly the code it runs with metrics off, so metrics on
gives the training bits of metrics off. :func:`build_probe_payload` packs
the probe's slices; the optimizer starts their copy to pinned host memory
without blocking, with a CUDA event beside it, and the host folds them
(:func:`fold_device_payload`, after waiting on the event) at the next
sample or at :func:`flush`. The fold replays the quantizer with the port's
plain versions on CPU tensors (:func:`kernels.encode_reference`,
:func:`kernels.dequantize`; bf16 by ``torch.bfloat16`` rounding). Across
processes the probe runs on each process's rows over the transport, and
its payload's ``[n_local, k]`` prefix rows are gathered to every process
before the copy (:func:`gather_probe_payload`), so the consensus distance,
the gradient norm and the quantizer replay's error are the stacked fold's,
bitwise, in every process; the counters keep their per-worker accounting.

**Exporters**: JSONL (``BLUEFOG_METRICS_FILE`` or :func:`export_jsonl`),
the Prometheus textfile (``BLUEFOG_METRICS_PROM`` or :func:`export_prom`)
and Chrome-trace counter events on the active timeline. See
``docs/metrics.md`` for the series.
"""

import json
import os
import threading
import time
from typing import Dict, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "peek",
    "reset",
    "enabled",
    "metrics_interval",
    "flush",
    "register_flush_hook",
    "auto_export",
    "export_jsonl",
    "export_prom",
    "prom_lines",
    "export_timeline_counters",
    "last_worker_rows",
    "metrics_export",
    "N_SLOTS",
    "SLOT_COUNT",
    "SLOT_DISAGREEMENT",
    "SLOT_PARAM_NORM",
    "SLOT_GRAD_NORM",
    "SLOT_QUANT_ERR",
    "SLOT_EF_RESIDUAL",
    "sample_elems_cap",
    "build_probe_payload",
    "start_host_copy",
    "quant_replay",
    "fold_device_payload",
    "drain_device_buffer",
    "gather_probe_payload",
    "wire_bytes_per_step",
    "record_allgather_wire",
]


# -- host-tier registry -------------------------------------------------------

_lock = threading.Lock()
_registry: Dict[str, object] = {}


class Counter:
    """Monotonic event count (plan-cache hits, recompiles, stalls...)."""

    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with _lock:
            self.value += n

    def describe(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Last-written value (rounds per step, drained RMS norms...)."""

    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        with _lock:
            self.value = float(v)

    def describe(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Histogram:
    """Running summary (count / sum / min / max / last) plus bounded
    log-bucket tail quantiles (p50 / p90 / p99).

    The five-number summary feeds dashboards and JSONL diffs; the
    quantiles answer the question a five-number summary cannot — "what
    is tail latency" — without unbounded storage: observations land in
    logarithmic buckets (:data:`_LOG_RES` per octave, clamped to a
    fixed index range), so memory is O(1) in the observation count and
    a reported quantile is within one bucket (≈ ``2**(1/(2*_LOG_RES))``,
    ~9 % relative) of the true order statistic. Exact distributions
    belong in the profiler tier."""

    kind = "histogram"

    # log-bucket resolution: buckets per octave. Reported quantiles are
    # within 2**(1/(2*_LOG_RES)) (~9%) of the true value.
    _LOG_RES = 4
    # clamp indices to [2**-40, 2**40] (~1e-12 .. ~1e12): 321 buckets
    # max, so a hostile series cannot grow the dict without bound
    _IDX_MIN = -40 * _LOG_RES
    _IDX_MAX = 40 * _LOG_RES
    QUANTILES = (0.5, 0.9, 0.99)

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.last = 0.0
        self._buckets: Dict[int, int] = {}

    def _bucket(self, v: float) -> int:
        import math

        if v <= 0.0:
            # zero / negative observations share the underflow bucket:
            # the quantile walk reports them as "at or below 2^-40"
            return self._IDX_MIN
        idx = round(self._LOG_RES * math.log2(v))
        return max(self._IDX_MIN, min(self._IDX_MAX, idx))

    def observe(self, v: float) -> None:
        v = float(v)
        b = self._bucket(v)
        with _lock:
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.last = v
            self._buckets[b] = self._buckets.get(b, 0) + 1

    def quantile(self, q: float) -> Optional[float]:
        """The ``q``-quantile from the log buckets (None when empty).
        Representative value is the bucket's log-space center, clamped
        into the exact observed [min, max] envelope so a one-bucket
        histogram reports its own numbers."""
        with _lock:
            if self.count == 0:
                return None
            need = q * self.count
            seen = 0
            idx = self._IDX_MAX
            for idx in sorted(self._buckets):
                seen += self._buckets[idx]
                if seen >= need:
                    break
            v = 2.0 ** (idx / self._LOG_RES)
            lo = self.min if self.min is not None else v
            hi = self.max if self.max is not None else v
            return float(min(max(v, lo), hi))

    def describe(self) -> dict:
        out = {
            "type": self.kind,
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "last": self.last,
        }
        if self.count:
            for q in self.QUANTILES:
                out[f"p{int(q * 100)}"] = self.quantile(q)
        return out


def _series(name: str, cls):
    with _lock:
        cur = _registry.get(name)
        if cur is None:
            cur = cls()
            _registry[name] = cur
            return cur
    if not isinstance(cur, cls):
        raise TypeError(
            f"metric {name!r} is a {cur.kind}, requested {cls.kind}"
        )
    return cur


def counter(name: str) -> Counter:
    return _series(name, Counter)


def gauge(name: str) -> Gauge:
    return _series(name, Gauge)


def histogram(name: str) -> Histogram:
    return _series(name, Histogram)


def snapshot() -> dict:
    """All series as ``{name: {"type": ..., "value"/"count"/...}}``."""
    with _lock:
        items = sorted(_registry.items())
    return {name: s.describe() for name, s in items}


def peek(name: str):
    """The registered series object, or None when nothing has written
    it yet. Read-only consumers (counter-delta and gauge reads) use this
    instead of
    :func:`counter`/:func:`gauge`, which would CREATE an empty series —
    a snapshot polluted with never-written zeros is indistinguishable
    from measured zeros."""
    with _lock:
        return _registry.get(name)


def reset() -> None:
    """Drop every registered series (test isolation)."""
    global _allgather_calls
    with _lock:
        _registry.clear()
        _last_worker_rows.clear()
        _allgather_calls = 0


# -- env knobs ----------------------------------------------------------------


def enabled() -> bool:
    """Device-tier switch: ``BLUEFOG_METRICS=1`` (default off). The host
    registry records regardless."""
    return os.environ.get("BLUEFOG_METRICS", "0").lower() in ("1", "true", "on", "yes")


def metrics_interval() -> int:
    """Sampling and drain period in communicating steps
    (``BLUEFOG_METRICS_INTERVAL``, default 10)."""
    from bluefog_tpu_torch.logging_util import env_int

    return max(1, env_int("BLUEFOG_METRICS_INTERVAL", 10))


# -- device tier ------------------------------------------------------------------

# One row per worker per drained sample; every slot but COUNT holds a sum
# of squares, so the drain reports an RMS.
SLOT_COUNT = 0         # communicating steps accumulated since the last drain
SLOT_DISAGREEMENT = 1  # sum ||y - x||^2 (weighted neighbour disagreement)
SLOT_PARAM_NORM = 2    # sum ||x||^2 of the gossip input
SLOT_GRAD_NORM = 3     # sum ||g||^2 of the local gradient
SLOT_QUANT_ERR = 4     # sum ||payload - dequant(payload)||^2 (quantized wires)
SLOT_EF_RESIDUAL = 5   # sum ||x - x_hat_self||^2 (the EF tiers' residual)
N_SLOTS = 6

_SLOT_NAMES = {
    SLOT_DISAGREEMENT: "disagreement",
    SLOT_PARAM_NORM: "param_norm",
    SLOT_GRAD_NORM: "grad_norm",
    SLOT_QUANT_ERR: "quant_err",
    SLOT_EF_RESIDUAL: "ef_residual",
}

# the probe's grain: whole 512-element wire blocks, so the prefix keeps the
# full wire's block scales
_ROW = 512

# every wire tier with a quantization-error replay; the _ef ones also
# publish the residual slot
_QUANT_WIRES = ("int8", "bf16", "int8_ef", "int4", "int4_ef")
_EF_WIRES = ("int8_ef", "int4_ef")


def sample_elems_cap() -> int:
    """Elements of each packed dtype group the probe covers
    (``BLUEFOG_METRICS_SAMPLE_ELEMS``, default 64 Ki, at least 512). A
    larger group is estimated from its 512-aligned prefix, scaled by the
    coverage ratio."""
    from bluefog_tpu_torch.logging_util import env_int

    return max(512, env_int("BLUEFOG_METRICS_SAMPLE_ELEMS", 1 << 16))


def prefix_elems(total: int, cap: int) -> int:
    """The probe's prefix of a group of ``total`` elements: ``cap`` cut to
    whole blocks, at most the group."""
    return min(total, max(_ROW, cap - cap % _ROW))


def build_probe_payload(pairs, g_subs, wire=None) -> dict:
    """The probe's results as the payload the host folds:
    ``pairs = [(sub_x, sub_y, scale, ef_self_new or None)]`` per dtype
    group (``[N, k]`` device tensors: the prefix of the combine's input
    and the same combine's output on it) and ``g_subs = [(sub_g, scale)]``
    for the gradient. ``x``, ``y`` and ``g`` are f32 copies multiplied by
    ``sqrt(scale)`` (f32), so the host's squared sums estimate the whole
    group; ``pack`` carries the unscaled input and its ratio for the
    quantizer replay, ``ef`` the probe's updated ``x_hat_self``."""
    import math

    import torch

    def scaled(sub, scale):
        sub = sub.to(torch.float32)
        if scale != 1.0:
            sub = sub * torch.tensor(math.sqrt(scale), dtype=torch.float32, device=sub.device)
        return sub

    payload = {
        "x": tuple(scaled(sx, sc) for sx, _sy, sc, _e in pairs),
        "y": tuple(scaled(sy, sc) for _sx, sy, sc, _e in pairs),
        "g": tuple(scaled(sg, sc) for sg, sc in g_subs),
        "pack": (),
        "ef": (),
    }
    if wire in _QUANT_WIRES:
        payload["pack"] = tuple(
            (sx.to(torch.float32), torch.full((1,), sc, dtype=torch.float32, device=sx.device))
            for sx, _sy, sc, _e in pairs
        )
    if wire in _EF_WIRES:
        payload["ef"] = tuple(e for _sx, _sy, _sc, e in pairs)
    return payload


def gather_probe_payload(payload, ctx) -> dict:
    """Across processes: the probe payload of this process's rows with
    every worker's rows, ``[N, k]`` in global order, in every process (one
    :func:`~bluefog_tpu_torch.collective.transport.gather_rows` of all its
    ``[n_local, k]`` tensors, the probe's prefix only), so the fold is the
    stacked fold, bitwise, in every process. The ``pack`` ratios stay as
    they are. With one process the payload itself."""
    if ctx is None or ctx.process_count == 1:
        return payload
    from bluefog_tpu_torch.collective import transport

    rows = (list(payload["x"]) + list(payload["y"]) + list(payload["g"])
            + [sub for sub, _ratio in payload["pack"]] + list(payload["ef"]))
    if not rows:
        return payload
    full = iter(transport.gather_rows([t.contiguous() for t in rows], ctx))
    take = lambda group: tuple(next(full) for _ in group)  # noqa: E731
    out = {"x": take(payload["x"]), "y": take(payload["y"]), "g": take(payload["g"])}
    out["pack"] = tuple((next(full), ratio) for _sub, ratio in payload["pack"])
    out["ef"] = take(payload["ef"])
    return out


def _payload_map(payload, fn):
    """``payload`` with ``fn`` applied to every tensor."""
    return {
        "x": tuple(fn(t) for t in payload["x"]),
        "y": tuple(fn(t) for t in payload["y"]),
        "g": tuple(fn(t) for t in payload["g"]),
        "pack": tuple((fn(s), fn(r)) for s, r in payload["pack"]),
        "ef": tuple(fn(t) for t in payload["ef"]),
    }


def start_host_copy(payload):
    """Start the copy of a device payload to the host: ``(host payload,
    event)``. On the card each tensor goes to pinned memory with
    ``non_blocking=True`` (a copy into pageable memory would be
    synchronous) and a CUDA event is recorded after the copies; read the
    host tensors only after the event. CPU tensors are copied at once and
    the event is None."""
    import torch

    event = None
    on_cuda = any(t.is_cuda for t in payload["x"] + payload["g"])

    def copy(t):
        if not t.is_cuda:
            return t.detach().clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t.detach(), non_blocking=True)
        return host

    host = _payload_map(payload, copy)
    if on_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream())
    return host, event


def quant_replay(v, wire: str):
    """The wire's reconstruction of the f32 rows ``v [N, k]`` (a CPU
    tensor), by the port's plain quantizer: ``encode_reference`` and
    ``dequantize`` on the zero-padded 512-element blocks (int8, int4),
    or the bf16 rounding."""
    import torch

    from bluefog_tpu_torch.collective import kernels

    v = v.to(torch.float32)
    if wire == "bf16":
        return v.to(torch.bfloat16).to(torch.float32)
    base = "int4" if wire in ("int4", "int4_ef") else "int8"
    n = v.shape[1]
    padded = kernels.pad_blocks(v).contiguous()
    payload, scales = kernels.encode_reference(padded, base)
    out = kernels.dequantize(payload, scales).reshape(v.shape[0], -1)
    return out[:, :n]


def fold_device_payload(payload, wire=None, prefix: str = "bluefog.gossip",
                        export: bool = True) -> dict:
    """Fold a host-side probe payload (worker-stacked CPU tensors or
    arrays) into the per-worker metric rows, then into the registry
    through :func:`drain_device_buffer`; sums in float64."""
    import numpy as np
    import torch

    def f64(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().to(torch.float64).numpy()
        return np.asarray(t, np.float64)

    xs = [f64(t) for t in payload["x"]]
    ys = [f64(t) for t in payload["y"]]
    gs = [f64(t) for t in payload["g"]]
    size = xs[0].shape[0] if xs else (gs[0].shape[0] if gs else 1)
    buf = np.zeros((size, N_SLOTS), np.float64)
    buf[:, SLOT_COUNT] = 1.0
    for x, y in zip(xs, ys):
        buf[:, SLOT_DISAGREEMENT] += ((y - x) ** 2).reshape(size, -1).sum(1)
        buf[:, SLOT_PARAM_NORM] += (x ** 2).reshape(size, -1).sum(1)
    for g in gs:
        buf[:, SLOT_GRAD_NORM] += (g ** 2).reshape(size, -1).sum(1)
    if wire in _QUANT_WIRES:
        for pi, (sub, scale) in enumerate(payload["pack"]):
            sub = torch.as_tensor(sub).detach().cpu().to(torch.float32).reshape(size, -1)
            scale = float(torch.as_tensor(scale).reshape(-1)[0])
            if wire in _EF_WIRES:  # the residual against the hat-self copy
                hat = torch.as_tensor(payload["ef"][pi]).detach().cpu().to(
                    torch.float32).reshape(size, -1)[:, :sub.shape[1]]
            else:
                hat = quant_replay(sub, wire)
            err = ((sub - hat).to(torch.float64) ** 2).sum(1)
            buf[:, SLOT_QUANT_ERR] += err.numpy() * scale
        if wire in _EF_WIRES:
            buf[:, SLOT_EF_RESIDUAL] = buf[:, SLOT_QUANT_ERR]
    return drain_device_buffer(buf, prefix=prefix, export=export, wire=wire)


def drain_device_buffer(buf, prefix: str = "bluefog.gossip", export: bool = True,
                        wire=None) -> dict:
    """Fold a ``[size, N_SLOTS]`` host array into the registry: per metric
    the per-worker RMS over the interval, published as ``<prefix>.<name>``
    (mean over workers) and ``<prefix>.<name>.max`` (the worst worker).
    The wire slots are published only where ``wire`` measures them.
    ``export=True`` runs the env-configured exporters."""
    import numpy as np

    buf = np.asarray(buf, np.float64)
    counts = buf[:, SLOT_COUNT]
    out = {"steps": float(counts.max(initial=0.0))}
    denom = np.maximum(counts, 1.0)
    for slot, name in sorted(_SLOT_NAMES.items()):
        if slot == SLOT_QUANT_ERR and wire not in _QUANT_WIRES:
            continue
        if slot == SLOT_EF_RESIDUAL and wire not in _EF_WIRES:
            continue
        rms = np.sqrt(buf[:, slot] / denom)
        mean_v, max_v = float(rms.mean()), float(rms.max())
        gauge(f"{prefix}.{name}").set(mean_v)
        gauge(f"{prefix}.{name}.max").set(max_v)
        with _lock:
            _last_worker_rows[f"{prefix}.{name}"] = rms.copy()
        out[name] = mean_v
        out[f"{name}.max"] = max_v
    if export:
        auto_export()
    return out


# the per-worker RMS vectors of the latest drain, by gauge name
_last_worker_rows: Dict[str, object] = {}


def last_worker_rows() -> Dict[str, object]:
    """``{series: per-worker numpy vector}`` of the latest device drain."""
    with _lock:
        return dict(_last_worker_rows)


# -- deferred drains ---------------------------------------------------------------

# holders of a pending probe payload (weakly held, so an optimizer stays
# collectable); flush() folds them
_flush_hooks: list = []


def register_flush_hook(obj) -> None:
    """Register an object with ``_flush_metrics()`` for :func:`flush`."""
    import weakref

    _flush_hooks.append(weakref.ref(obj))


def flush() -> None:
    """Fold every registered holder's pending probe payload into the
    registry (dead references are dropped)."""
    alive = []
    for ref in _flush_hooks:
        obj = ref()
        if obj is not None:
            obj._flush_metrics()
            alive.append(ref)
    _flush_hooks[:] = alive


def wire_bytes_per_step(n_elems_by_itemsize, n_rounds: int, wire: Optional[str] = None) -> int:
    """Per-worker wire bytes of one gossip step
    (:func:`bluefog_tpu_torch.scaling.wire_bytes_per_step`)."""
    from bluefog_tpu_torch import scaling

    return scaling.wire_bytes_per_step(n_elems_by_itemsize, n_rounds, wire)


# compressed neighbor_allgather dispatches, for the 1-in-interval sampling
_allgather_calls = 0


def record_allgather_wire(x, wire: str, wire_bytes: int) -> None:
    """Wire bytes of one compressed ``neighbor_allgather`` (every call) and,
    on one call in :func:`metrics_interval`, its quantization error
    replayed on the host over a 512-aligned prefix of the input (sliced on
    the device before the copy): ``bluefog.allgather.quant_err[.max]``,
    the per-worker RMS over the prefix."""
    import numpy as np
    import torch

    global _allgather_calls
    counter("bluefog.allgather.wire_bytes").inc(wire_bytes)
    with _lock:
        sampled = _allgather_calls % metrics_interval() == 0
        _allgather_calls += 1
    if not sampled:
        return
    size = int(x.shape[0])
    n = 1
    for d in x.shape[1:]:
        n *= int(d)
    keep = prefix_elems(n, sample_elems_cap())
    sub = x.reshape(size, -1)[:, :keep].detach().to(torch.float32).cpu()
    hat = quant_replay(sub, wire)
    errs = np.sqrt(((sub - hat).to(torch.float64) ** 2).sum(1).numpy() / max(keep, 1))
    gauge("bluefog.allgather.quant_err").set(float(errs.mean()))
    gauge("bluefog.allgather.quant_err.max").set(float(errs.max()))


# -- exporters ----------------------------------------------------------------


def export_jsonl(path: Optional[str] = None) -> Optional[str]:
    """Append one snapshot line to ``path`` (default
    ``BLUEFOG_METRICS_FILE``). Each line is a standalone JSON object
    ``{"ts": <unix seconds>, "metrics": {...}}`` — the format
    ``tools/metrics_report.py`` summarizes. Returns the path written, or
    None when no path is configured."""
    path = path or os.environ.get("BLUEFOG_METRICS_FILE")
    if not path:
        return None
    line = json.dumps({"ts": time.time(), "metrics": snapshot()})
    with open(path, "a") as f:
        f.write(line + "\n")
    return path


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _prom_val(v: float) -> str:
    """Render one sample value in Prometheus exposition format. Python's
    ``%g`` spells non-finite floats ``nan``/``inf``, which strict
    exposition parsers reject — the format's own casings are ``NaN`` /
    ``+Inf`` / ``-Inf`` (a NaN gauge, e.g. a step EWMA before warmup,
    must degrade to an explicitly-unparseable-as-number token, not an
    invalid line)."""
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return f"{v:g}"


def prom_lines() -> list:
    """The registry rendered as Prometheus exposition lines, in
    DETERMINISTIC order (series sorted by raw name; fixed sub-line
    order per series) with the conventional ``# HELP`` / ``# TYPE``
    preamble per family — successive scrapes/textfiles of an unchanged
    registry are byte-identical, so they diff cleanly. Counter names
    get ``_total``; histograms export as a summary:
    ``_count`` / ``_sum`` / ``_min`` / ``_max`` plus the log-bucket
    ``{quantile="..."}`` series. Shared by the textfile exporter and
    the live ``/metrics`` endpoint (the JAX package serves it live)."""
    lines = []
    for name, desc in sorted(snapshot().items()):
        pname = _prom_name(name)
        if desc["type"] == "counter":
            lines.append(f"# HELP {pname}_total bluefog_tpu series "
                         f"{name}")
            lines.append(f"# TYPE {pname}_total counter")
            lines.append(f"{pname}_total {_prom_val(desc['value'])}")
        elif desc["type"] == "gauge":
            lines.append(f"# HELP {pname} bluefog_tpu series {name}")
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_prom_val(desc['value'])}")
        else:
            lines.append(f"# HELP {pname} bluefog_tpu series {name}")
            lines.append(f"# TYPE {pname} summary")
            for q in Histogram.QUANTILES:
                v = desc.get(f"p{int(q * 100)}")
                if v is not None:
                    lines.append(
                        f'{pname}{{quantile="{q:g}"}} {_prom_val(v)}'
                    )
            lines.append(f"{pname}_count {_prom_val(desc['count'])}")
            lines.append(f"{pname}_sum {_prom_val(desc['sum'])}")
            for k in ("min", "max"):
                if desc[k] is not None:
                    lines.append(f"{pname}_{k} {_prom_val(desc[k])}")
    return lines


def export_prom(path: Optional[str] = None) -> Optional[str]:
    """Write :func:`prom_lines` in Prometheus textfile-collector format
    to ``path`` (default ``BLUEFOG_METRICS_PROM``), atomically (write to
    ``<path>.tmp`` then rename — node_exporter may scrape mid-write)."""
    path = path or os.environ.get("BLUEFOG_METRICS_PROM")
    if not path:
        return None
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(prom_lines()) + "\n")
    os.replace(tmp, path)
    return path


def export_timeline_counters() -> int:
    """Emit every scalar series as a Chrome-trace counter event
    (``ph:"C"``) on the active timeline; counters render as stacked area
    tracks under the op spans in chrome://tracing / Perfetto. No-op (0)
    when no timeline is active; returns the number of events emitted."""
    from bluefog_tpu_torch import timeline as tl

    if not tl.timeline_enabled():
        return 0
    n = 0
    for name, desc in snapshot().items():
        value = desc.get("value", desc.get("last"))
        if value is None:
            continue
        tl.timeline_record_counter(name, float(value))
        n += 1
    return n


def auto_export() -> None:
    """Run every env-configured exporter: JSONL append, Prometheus
    textfile rewrite, timeline counter events. Called at each device
    drain and from ``bf.shutdown()``."""
    export_jsonl()
    export_prom()
    export_timeline_counters()


def metrics_export(jsonl_path: Optional[str] = None,
                   prom_path: Optional[str] = None) -> dict:
    """Facade export (``bf.metrics_export()``): flush any deferred
    device-tier drains, write the JSONL and/or Prometheus files
    (explicit paths win over the env defaults), emit timeline counters
    if a timeline is active, and return the snapshot."""
    flush()
    export_jsonl(jsonl_path)
    export_prom(prom_path)
    export_timeline_counters()
    return snapshot()
