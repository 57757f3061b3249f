"""Readings that the limits of ``correct`` are set from, on the chip::

    python3 gossipbench/control.py --workload <cell> --seeds 1-12 --control-seeds 1-3

For each seed: the program's first steps against the reference's (the
lower readings). For each control seed besides: the control (the
reference with every matrix product and convolution in float8 e4m3) and
each planted fault (``reference/train.py::faults``), each against the
reference (the upper readings). One JSON line a reading, on standard
output and in ``--out``; every number of ``lib/compare.py`` and the
spread of the leaf gaps behind the two leaf numbers.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def seeds(text: str):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b or a) + 1))
    return out


def reading(kind: str, seed: int, got, ref, lim) -> dict:
    """The comparison's numbers, each step's loss gap, and each leaf number
    under every statistic ``lib/compare.py`` offers."""
    from gossipbench.lib import compare

    correct, checks, where = compare.compare(got, ref, lim)
    row = {"kind": kind, "seed": seed, "correct": correct, "where": where}
    row.update({k: c["value"] for k, c in checks.items()})
    lp, lr = got["losses"], ref["losses"]
    row["loss_by_step"] = ((lp - lr).abs() / lr.abs()).max(dim=1).values.tolist()
    for key in compare.checks_of(lim):
        if key != "loss_gap":
            for over in compare.STATISTICS:
                row[f"{key}.{over}"] = compare.leaf_number(key, over, got, ref)[0]
    return row


def norms(out) -> dict:
    """The raw readings of one side, for a look beyond the summary."""
    return {"losses": out["losses"].tolist(),
            **{k: {n: v.tolist() for n, v in out[k].items()}
               for k in ("grad", "late_grad", "grad_max", "change") if k in out}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--control-seeds", default="1-3")
    p.add_argument("--out", default=None)
    p.add_argument("--raw", action="store_true", help="also emit every leaf's norms")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from gossipbench import harness
    from gossipbench.drivers import train
    from gossipbench.reference import train as reference_train

    if not torch.cuda.is_available():
        print("gossipbench: the readings need a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = harness.benchmark()
    w = harness.cell(bench, args.workload)
    cfg, m = harness.config(bench, w["config"]), harness.mix(w["traffic"])
    fam, lim = harness.family(cfg), harness.limits(args.workload)
    steps = m["check_steps"]
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    control = set(seeds(args.control_seeds))
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        program = train.Program(cfg, m, fam, seed, device)
        got = program.first_steps(steps, late="late_grad_gap" in lim)
        program.free()
        ref = train.reference_outputs(cfg, m, fam, seed, device, steps)
        emit({**reading("program", seed, got, ref, lim), "s": time.perf_counter() - t0})
        if args.raw:
            emit({"kind": "raw", "seed": seed, "program": norms(got), "reference": norms(ref)})
        if seed not in control:
            continue
        variants = [("control", reference_train.fp8, None)]
        variants += [(f, reference_train.identity, f)
                     for f in reference_train.faults(fam.reference)]
        for kind, cast, fault in variants:
            t0 = time.perf_counter()
            bad = train.reference_outputs(cfg, m, fam, seed, device, steps, cast=cast,
                                          fault=fault)
            emit({**reading(kind, seed, bad, ref, lim), "s": time.perf_counter() - t0})
            if args.raw:
                emit({"kind": "raw-" + kind, "seed": seed, "program": norms(bad)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
