"""Finding a cell's pieces by name and turning one run into the result line.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The
configuration is ``configs/<config>.json``; its ``family`` names the
module that builds the port's model, ``families/<family>.py`` (which names
its reference). The mix is ``mixes/<traffic>.json``; its ``driver`` names
the window driver ``drivers/<driver>.py``. The limits of the comparison that decides
``correct`` are ``limits/<cell>.json``. Each per-layer metric is
``metrics/<metric>.py``, whose ``read(ctx)`` returns a number, or None
where the run gave it nothing to read.
"""

import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FOREIGN = ("jax", "jaxlib", "flax", "bluefog_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(traffic: str) -> dict:
    return load_json(HERE / "mixes" / f"{traffic}.json")


def limits(workload: str) -> dict:
    return load_json(HERE / "limits" / f"{workload}.json")


def family(cfg: dict):
    return importlib.import_module(f"gossipbench.families.{cfg['family']}")


def driver(m: dict):
    return importlib.import_module(f"gossipbench.drivers.{m['driver']}")


def reader(metric: str):
    """``metrics/<metric>.py`` as a module (a name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"gossipbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(bench: dict, kind: str, workload: str):
    """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def foreign_modules():
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FOREIGN))


def run(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print):
    """One run of ``workload``: ``(result line as a dict, check lines)``."""
    w = cell(bench, workload)
    return run_cell(w, config(bench, w["config"]), mix(w["traffic"]), limits(workload),
                    metrics_of(bench, "end_to_end", workload),
                    metrics_of(bench, "per_layer", workload),
                    seed, seconds, trace, device, t_start, log=log)


def run_cell(w: dict, cfg: dict, m: dict, lim: dict, end_to_end, per_layer, seed: int,
             seconds: float, trace: bool, device, t_start: float, log=print):
    """One run of the cell ``w`` on its configuration, mix and limits."""
    import torch

    out = driver(m).run(cfg, m, family(cfg), seed, seconds, trace, device, t_start, lim,
                        ROOT / "build" / "gossipbench" / f"{w['name']}.trace.json", log=log)
    if trace:
        values = {}
        for spec in per_layer:
            value = reader(spec["name"]).read(out.ctx)
            if value is not None:
                values[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        values = {spec["name"]: {"value": out.end_to_end[spec["name"]], "unit": spec["unit"]}
                  for spec in end_to_end}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": w["chips"], "memory_peak_bytes": out.peak_bytes}
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": values, "device": dev}
    if trace:
        s = out.summary
        dev.update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in s.device_ops],
                               "idle_gaps": [list(x) for x in s.idle_gaps]}
    result["checks"] = out.checks
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r} (worst at {out.where[k]})"
             for k, c in out.checks.items()]
    return result, lines
