"""Run one cell of the benchmark once, from the root of a checkout::

    python3 gossipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA device for each chip the cell asks for, else it exits 2 and
prints no result. The last line of standard output is the result, one JSON
object; the numbers the comparison checked, each beside its limit, are the
last lines of standard error and the result's last key. Build and kernel
caches stay in fixed directories under ``build/`` in the checkout.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "nv"}


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (its start time
    from ``/proc``; else now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


T_START = process_start()


def card_line() -> str:
    import subprocess

    query = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             check=True, capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "gossipbench-cache" / sub)
    for var in [v for v in os.environ if v.startswith("BLUEFOG_")]:
        del os.environ[var]  # the program runs its defaults
    sys.path.insert(0, str(ROOT))
    from gossipbench import harness

    bench = harness.benchmark()
    chips = harness.cell(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gossipbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import bluefog_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"gossipbench: the program is not in this checkout ({e})", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    print(f"[gossipbench] card: {card_line()}", flush=True)
    result, checks = harness.run(bench, args.workload, args.seed, args.seconds,
                                 bool(args.trace), torch.device("cuda", 0), T_START)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"gossipbench: the run loaded {foreign}", file=sys.stderr)
        return 4
    for line in checks:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
