"""The traced steps of one cell, read by the program's own spans::

    python3 gossipbench/phases.py --workload <cell> --seed <n> [--steps 2] [--out <dir>]

Sets the cell up as ``run.py`` does (``drivers/train.py::Program``), drives it
through its check steps and a few more, then profiles ``--steps`` steps as
a traced run does (``drivers/train.py::_profiled``: one warm-up step, each
step in ``gossipbench.step`` / ``.train_step`` / ``.sync`` spans), keeps the
trace and reads it twice: with ``lib/trace.py`` and the cell's device
readers, as a traced run reads it (and again with the program's spans
taken out, which must read the same), and with ``lib/spans.py``, by the
program's spans. Logs one line a span (host, device and idle ms, launches
and blocking runtime calls, each a step), the idle gaps by the span whose
launch ended them, the device time of each kernel group and of the flash
and pooling kernels by span, and the host cost of one span with the
profiler off and on; writes the same as ``<out>/<cell>.json`` and the
trace beside it. Needs a CUDA device, as ``run.py`` does. On a program
that opens no spans every device event is ``outside``.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
WARM_STEPS = 2  # steps after the check steps, before the profiled ones
SPAN_COST_CALLS = 20000
KERNEL_PREFIXES = ("flash_fwd", "flash_bwd", "max_pool_backward")


def span_cost_us(activities, calls: int = SPAN_COST_CALLS) -> dict:
    """Host microseconds of an empty loop turn, and of one empty
    ``timeline.span`` with the profiler off and recording."""
    from torch.profiler import profile

    from bluefog_tpu_torch import timeline as tl

    def per_turn(body) -> float:
        t0 = time.perf_counter()
        body()
        return 1e6 * (time.perf_counter() - t0) / calls

    def loop():
        for _ in range(calls):
            pass

    def spans():
        for _ in range(calls):
            with tl.span("cost", tl.PHASE):
                pass

    out = {"loop": per_turn(loop)}
    if hasattr(tl, "span"):  # a program with no spans has no cost to read
        out["off"] = per_turn(spans)
        with profile(activities=activities):
            out["on"] = per_turn(spans)
    return out


def _by_span(spans_summary, match) -> dict:
    """``{span: device ms a step}`` of the kernels whose symbol ``match``es."""
    n = spans_summary.steps
    out = {}
    for name, s in spans_summary.by_span.items():
        ms = 1e3 * sum(v for k, v in s.kernel_s.items() if match(k)) / n
        if ms > 0:
            out[name] = ms
    return out


def read(events, cell_metrics, ctx_parts) -> dict:
    """Everything the tool reports of one trace (see the module docstring)."""
    from gossipbench import harness
    from gossipbench.lib import spans, trace

    summary = trace.summarize(events)
    plain = trace.summarize([e for e in events if not (
        e.get("cat") == "user_annotation" and e["name"].startswith(spans.PREFIX))])
    sp = spans.summarize(events)
    readers, same = {}, summary == plain
    for name in cell_metrics:
        reader = harness.reader(name)
        readers[name] = reader.read(SimpleNamespace(trace=summary, **ctx_parts))
        same = same and reader.read(SimpleNamespace(trace=plain, **ctx_parts)) == readers[name]
    n = sp.steps
    groups = trace.kernel_groups(harness.HERE)
    kernels = {g: _by_span(sp, lambda k, syms=syms: k in syms) for g, syms in groups.items()}
    kernels.update({p: _by_span(sp, lambda k, p=p: k.startswith(p)) for p in KERNEL_PREFIXES})
    top = {name: sorted(((k, 1e3 * v / n) for k, v in s.kernel_s.items()),
                        key=lambda kv: -kv[1])[:6]
           for name, s in sp.by_span.items()}
    steps = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"] in (trace.STEP_SPAN, "gossipbench.train_step")),
                   key=lambda e: e["ts"])
    return {
        "steps": n, "window_ms": 1e3 * summary.window_s / n, "busy_ms": 1e3 * summary.busy_s / n,
        "traced_step_ms": [e["dur"] / 1e3 for e in steps if e["name"] == trace.STEP_SPAN],
        "train_step_ms": [e["dur"] / 1e3 for e in steps if e["name"] != trace.STEP_SPAN],
        "readers": readers,
        "same_without_program_spans": same,
        "idle_gaps": [list(x) for x in summary.idle_gaps],
        "spans": {name: {"host_ms": 1e3 * s.host_s / n, "device_ms": 1e3 * s.device_s / n,
                         "launches": s.launches / n, "idle_ms": 1e3 * s.idle_s / n,
                         "blocking": {k: [c / n, 1e3 * t / n]
                                      for k, (c, t) in s.blocking.items()},
                         "top_kernels": top[name]}
                  for name, s in sp.by_span.items()},
        "phases": {p: spans.phase_ms(sp, p) for p in spans.PHASES},
        "phases_cover": sp.phases_busy_s / sp.busy_s if sp.busy_s > 0 else None,
        "idle_spans": spans.idle_spans_ms(sp),
        "gaps": [[name, 1e3 * v] for name, v in sp.gaps],
        "kernels_by_span": kernels,
        "lines": spans.lines(sp),
    }


def profile_cell(workload: str, cfg, mix, family, seed: int, steps: int, device, out: Path,
                 log=print) -> dict:
    """Set the cell up, profile ``steps`` steps and read the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    from gossipbench import harness
    from gossipbench.drivers import train
    from gossipbench.lib import trace, weights
    from gossipbench.reference import wire

    torch.manual_seed(weights.sub_seed(seed, "torch"))
    program = train.Program(cfg, mix, family, seed, device)
    for _ in range(mix["check_steps"] + WARM_STEPS):
        program.step()
    train.sync(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    cost = span_cost_us(activities)
    train._reset_launches()
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{workload}.trace.json"
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=steps),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(1 + steps):
            with record_function(trace.STEP_SPAN):
                with record_function("gossipbench.train_step"):
                    program.step()
                with record_function("gossipbench.sync"):
                    train.sync(device)
            prof.step()
    launches = {k: v / (1 + steps) for k, v in train._launches().items() if v}
    ctx_parts = dict(
        cfg=cfg, mix=mix, family=family,
        width=wire.layout(family.reference.param_table(cfg))[1],
        wire_launches={k: launches[k] for k in train._wire_kernels() if k in launches},
        rounds=(len(wire.exponential_sources(mix["workers"]))
                if mix["topology"] == "ExponentialGraph" else None))
    program.free()
    bench = harness.benchmark()
    cell_metrics = [m["name"] for m in harness.metrics_of(bench, "per_layer", workload)
                    if m["source"] == "device_trace"]
    result = {"cell": workload, "seed": seed, "span_us": cost, "launches": launches,
              **read(trace.load(path), cell_metrics, ctx_parts)}
    for line in result["lines"]:
        log(f"[phases] {line}")
    log(f"[phases] idle by span, ms a step: {result['idle_spans']}")
    log(f"[phases] longest gaps by the span and op that launched the work ending them, ms: "
        f"{result['gaps']}")
    log(f"[phases] four phases cover {result['phases_cover']} of busy; by kernel group: "
        f"{result['kernels_by_span']}")
    log(f"[phases] span us: {cost}; traced steps ms {result['traced_step_ms']}, train_step "
        f"ms {result['train_step_ms']}; readers {result['readers']}, the same without the "
        f"program's spans: {result['same_without_program_spans']}")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--out", default=str(ROOT / "build" / "gossipbench" / "phases"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from gossipbench import harness, run

    for var, sub in run.CACHES.items():
        os.environ[var] = str(ROOT / "build" / "gossipbench-cache" / sub)
    for var in [v for v in os.environ if v.startswith("BLUEFOG_")]:
        del os.environ[var]
    import torch

    if not torch.cuda.is_available():
        print("gossipbench phases: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    bench = harness.benchmark()
    w = harness.cell(bench, args.workload)
    cfg, m = harness.config(bench, w["config"]), harness.mix(w["traffic"])
    card = run.card_line()
    print(f"[phases] card: {card}", flush=True)
    result = profile_cell(args.workload, cfg, m, harness.family(cfg), args.seed, args.steps,
                          torch.device("cuda", 0), Path(args.out),
                          log=lambda s: print(s, flush=True))
    result["card"] = card
    result["device"] = torch.cuda.get_device_name(0)
    with open(Path(args.out) / f"{args.workload}.json", "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("cell", "phases", "phases_cover", "idle_spans",
                                             "readers", "same_without_program_spans")}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
