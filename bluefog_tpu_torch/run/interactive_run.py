# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""``ibfrun-torch``: interactive (notebook or REPL) bluefog_tpu_torch
sessions.

Counterpart of ``bluefog_tpu/run/interactive_run.py``: the notebook is the
one process that drives every worker, so no cluster is started;
``ibfrun-torch`` prepares the environment (the worker count of ``-np``)
and runs an interactive interpreter. The stall watchdog defaults to off
(``BLUEFOG_STALL_TIMEOUT=0``) unless the caller set it, since a notebook
waits between cells.

Usage::

    ibfrun-torch start -np 8                  # IPython (or python) REPL
    ibfrun-torch start -np 8 jupyter lab      # any interactive command
    ibfrun-torch stop                         # nothing to stop
"""

import os
import shutil
import sys
from typing import Sequence

from bluefog_tpu_torch.run.run import build_child_env, parse_args

__all__ = ["main"]


def _interactive_argv(command):
    if command:
        return list(command)
    for candidate in ("ipython", "jupyter"):
        path = shutil.which(candidate)
        if path:
            return [path]
    return [sys.executable, "-i", "-c", "import bluefog_tpu_torch as bft"]


def main(argv: Sequence[str] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("start", "stop"):
        action, argv = argv[0], argv[1:]
    else:
        action = "start"
    if action == "stop":
        print("ibfrun-torch: no cluster processes to stop (one process)")
        return 0

    args = parse_args(argv)
    if args.version:
        from bluefog_tpu_torch.version import __version__

        print(__version__)
        return 0
    env = build_child_env(args, base_env=dict(os.environ))
    env.setdefault("BLUEFOG_STALL_TIMEOUT", "0")
    cmd = _interactive_argv(args.command)
    os.execvpe(cmd[0], cmd, env)
    raise AssertionError("unreachable")  # pragma: no cover


if __name__ == "__main__":
    sys.exit(main())
