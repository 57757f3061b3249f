# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""``bfrun-torch``: launch a bluefog_tpu_torch program.

Counterpart of ``bluefog_tpu/run/run.py`` (``bfrun-tpu``), with its
arguments:

- one host, ``-np N``: the command runs in one process that drives all
  ``N`` workers (``BLUEFOG_NUM_WORKERS=N``);
- several ``-H``/``--hostfile`` entries: one process per entry, local ones
  as children of the launcher and remote ones over ssh, each with
  ``BLUEFOG_COORDINATOR``, ``BLUEFOG_NUM_PROCESSES`` and
  ``BLUEFOG_PROCESS_ID`` set and its entry's slot count in
  ``BLUEFOG_LOCAL_WORKERS``; :func:`bluefog_tpu_torch.context.init` joins the
  ``torch.distributed`` process group from them and gives process ``i`` the
  next ``BLUEFOG_LOCAL_WORKERS`` worker rows. ``-H localhost:4,localhost:4``
  starts two local processes of four workers each.

Environment contract read by :mod:`bluefog_tpu_torch.context`:

============================  =================================================
``BLUEFOG_NUM_WORKERS``       total worker count (``-np``)
``BLUEFOG_LOCAL_WORKERS``     this process's worker count (its host's slots)
``BLUEFOG_COORDINATOR``       ``host:port`` of the rendezvous store
``BLUEFOG_NUM_PROCESSES``     number of processes
``BLUEFOG_PROCESS_ID``        this process's index
``BLUEFOG_TIMELINE``          timeline file prefix
``BLUEFOG_FLIGHT_DIR``        flight-recorder dump directory
============================  =================================================

Where the JAX launcher sizes the virtual CPU platform through
``XLA_FLAGS``, this one sets ``BLUEFOG_LOCAL_WORKERS``; ``--platform``
accepts only ``auto``: no variable moves the port to the CPU, a program
picks its device (``bft.init(device=...)``). When every host is this
machine, the coordinator is ``127.0.0.1``; JAX's launcher names the
machine by a routable name instead, which remote hosts need.
"""

import argparse
import os
import shlex
import subprocess
import sys
import time
from typing import Callable, Dict, List, Sequence, Tuple

from bluefog_tpu_torch.run import network_util

__all__ = [
    "parse_args",
    "build_child_env",
    "build_host_commands",
    "resolve_max_restarts",
    "backoff_seconds",
    "run_with_restarts",
    "flight_artifacts",
    "report_flight_artifacts",
    "main",
]

DEFAULT_COORDINATOR_PORT = 9781

# Environment prefixes forwarded to the processes (ssh starts a fresh
# environment, so the launcher re-exports them explicitly).
_FORWARD_PREFIXES = ("BLUEFOG_", "TORCH_", "NCCL_", "GLOO_", "CUDA_")


def parse_args(argv: Sequence[str] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="bfrun-torch", description="Bluefog PyTorch Runner"
    )
    parser.add_argument(
        "-v", "--version", action="store_true", dest="version",
        help="Shows bluefog_tpu_torch version.",
    )
    parser.add_argument(
        "-np", "--num-proc", action="store", dest="np", type=int,
        help="Total number of workers.",
    )
    parser.add_argument(
        "--platform", action="store", dest="platform", default="auto",
        choices=("auto",),
        help="Kept for the JAX launcher's surface; only 'auto': the program "
        "picks its device (the card unless it asks for the CPU).",
    )

    group_hosts = parser.add_mutually_exclusive_group()
    group_hosts.add_argument(
        "-H", "--hosts", action="store", dest="hosts",
        help="Comma-separated <hostname>:<slots> list (slots = workers of "
        "the process started there), e.g. host1:4,host2:4.",
    )
    group_hosts.add_argument(
        "-hostfile", "--hostfile", action="store", dest="hostfile",
        help="Path to a host file of '<hostname> slots=<n>' lines.",
    )
    parser.add_argument(
        "-p", "--ssh-port", action="store", dest="ssh_port", type=int,
        help="SSH port on all the hosts.",
    )
    parser.add_argument(
        "--coordinator", action="store", dest="coordinator",
        help="host:port of the rendezvous store. Set automatically in "
        "-H/--hostfile mode; pass explicitly when each process is started "
        "by an external scheduler.",
    )
    parser.add_argument(
        "--num-processes", action="store", dest="num_processes", type=int,
        help="Total processes (with --coordinator).",
    )
    parser.add_argument(
        "--process-id", action="store", dest="process_id", type=int,
        help="This process's index (with --coordinator).",
    )
    parser.add_argument(
        "--timeline-filename", action="store", dest="timeline_filename",
        help="Prefix for per-process Chrome-trace timeline files "
        "(sets BLUEFOG_TIMELINE).",
    )
    parser.add_argument(
        "--flight-dir", action="store", dest="flight_dir",
        help="Directory for flight-recorder dumps (sets BLUEFOG_FLIGHT_DIR): "
        "each process writes flight_<process_id>.json there on a stall, "
        "verdict, crash or SIGTERM, and the launcher lists them after a "
        "failed run.",
    )
    parser.add_argument(
        "--remote-python", action="store", dest="remote_python",
        default="python3",
        help="Interpreter used to run bare .py commands on REMOTE hosts "
        "(default python3). Locally the launcher's own sys.executable is "
        "used.",
    )
    parser.add_argument(
        "--max-restarts", action="store", dest="max_restarts", type=int,
        default=None,
        help="Restart a process that exits nonzero up to this many times, "
        "with exponential backoff (default from BLUEFOG_MAX_RESTARTS, else "
        "0 = fail fast).",
    )
    parser.add_argument(
        "--extra-env", action="append", dest="extra_env", default=[],
        metavar="KEY=VALUE",
        help="Extra environment variable for the launched processes "
        "(repeatable).",
    )
    parser.add_argument(
        "--verbose", action="store_true", dest="verbose",
        help="Print the launch plan before executing.",
    )
    parser.add_argument(
        "command", nargs=argparse.REMAINDER, help="Command to be executed."
    )

    args = parser.parse_args(argv)
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]  # argparse REMAINDER keeps the separator
    if not args.version and not args.np:
        parser.error("argument -np/--num-proc is required")
    if (args.coordinator is None) != (args.num_processes is None):
        parser.error("--coordinator and --num-processes must be given together")
    return args


def _parse_extra_env(pairs: Sequence[str]) -> Dict[str, str]:
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--extra-env expects KEY=VALUE, got {pair!r}")
        k, v = pair.split("=", 1)
        out[k] = v
    return out


def build_child_env(
    args, base_env: Dict[str, str], local_workers: int = None
) -> Dict[str, str]:
    """The environment of a launched process (pure).

    ``local_workers`` is the worker count of THIS process
    (``BLUEFOG_LOCAL_WORKERS``): ``-np`` on one host, the host's slot
    count with several; ``None`` defaults to ``args.np``, 0 leaves it to
    the caller (the JAX launcher's ``cpu_count`` in ``XLA_FLAGS``)."""
    env = dict(base_env)
    env["BLUEFOG_NUM_WORKERS"] = str(args.np)
    count = args.np if local_workers is None else local_workers
    if count > 0:
        env["BLUEFOG_LOCAL_WORKERS"] = str(count)
    if args.timeline_filename:
        env["BLUEFOG_TIMELINE"] = args.timeline_filename
    if getattr(args, "flight_dir", None):
        env["BLUEFOG_FLIGHT_DIR"] = args.flight_dir
    if args.coordinator:
        env["BLUEFOG_COORDINATOR"] = args.coordinator
        env["BLUEFOG_NUM_PROCESSES"] = str(args.num_processes)
        env["BLUEFOG_PROCESS_ID"] = str(args.process_id or 0)
    env.update(_parse_extra_env(args.extra_env))
    return env


def resolve_max_restarts(args, env: Dict[str, str] = None) -> int:
    """The restart budget (pure): the flag, then ``BLUEFOG_MAX_RESTARTS``,
    then 0 (fail fast); negative values are refused."""
    env = os.environ if env is None else env
    value = getattr(args, "max_restarts", None)
    if value is None:
        raw = env.get("BLUEFOG_MAX_RESTARTS", "0")
        try:
            value = int(raw)
        except ValueError:
            raise ValueError(
                f"BLUEFOG_MAX_RESTARTS must be an integer, got {raw!r}"
            )
    if value < 0:
        raise ValueError(f"max restarts must be >= 0, got {value}")
    return value


def backoff_seconds(attempt: int, base: float = 1.0, cap: float = 30.0) -> float:
    """Exponential backoff before restart ``attempt`` (0-based): ``base *
    2**attempt`` capped at ``cap`` (pure)."""
    assert attempt >= 0
    return min(float(cap), float(base) * (2.0 ** attempt))


def run_with_restarts(
    start: Callable[[], int],
    max_restarts: int,
    sleep: Callable[[float], None] = time.sleep,
    base: float = 1.0,
    log=None,
) -> int:
    """Run ``start()`` (returning an exit code), restarting on a nonzero
    exit up to ``max_restarts`` times with exponential backoff; returns the
    last exit code."""
    attempt = 0
    while True:
        rc = start()
        if rc == 0 or attempt >= max_restarts:
            return rc
        delay = backoff_seconds(attempt, base=base)
        if log is not None:
            log(
                f"[bfrun-torch] worker exited with {rc}; restart "
                f"{attempt + 1}/{max_restarts} in {delay:g}s"
            )
        sleep(delay)
        attempt += 1


def flight_artifacts(flight_dir: str) -> List[str]:
    """The flight dumps and timeline files a failed run left under
    ``--flight-dir``, sorted (empty when the directory is missing)."""
    if not flight_dir or not os.path.isdir(flight_dir):
        return []
    return sorted(
        os.path.join(flight_dir, f)
        for f in os.listdir(flight_dir)
        if f.endswith(".json")
    )


def report_flight_artifacts(flight_dir: str, out=None) -> List[str]:
    """After a nonzero exit: list the collected per-process dumps and the
    command that fuses them."""
    out = out or sys.stderr
    files = flight_artifacts(flight_dir)
    if not files:
        return files
    print(f"[bfrun-torch] flight artifacts in {flight_dir}:", file=out)
    for f in files:
        print(f"[bfrun-torch]   {f}", file=out)
    print(f"[bfrun-torch] postmortem: python tools/trace_merge.py {flight_dir}", file=out)
    return files


def _command_argv(command: Sequence[str], interpreter: str = None) -> List[str]:
    """Run a bare ``script.py`` through an interpreter: the launcher's own
    ``sys.executable`` locally, ``--remote-python`` on remote hosts."""
    command = list(command)
    if command and command[0].endswith(".py"):
        return [interpreter or sys.executable] + command
    return command


def build_host_commands(
    args, hosts: Sequence[network_util.HostSlots]
) -> List[Tuple[str, List[str]]]:
    """``(host, argv)`` of each process of a several-host launch (pure).

    Process ``i`` runs on ``hosts[i]`` with ``hosts[i].slots`` workers
    (``BLUEFOG_LOCAL_WORKERS``) and the coordinator on ``hosts[0]``;
    ``BLUEFOG_NUM_WORKERS`` is the total, so every process builds the same
    worker rows."""
    total_slots = sum(h.slots for h in hosts)
    if args.np != total_slots:
        raise ValueError(
            f"-np {args.np} does not match the {total_slots} total host "
            f"slots in {[tuple(h) for h in hosts]}"
        )
    all_local = all(network_util.is_local_address(h.host) for h in hosts)
    coordinator = args.coordinator
    if coordinator is None:
        coord_host = hosts[0].host
        if all_local:
            coord_host = "127.0.0.1"
        elif network_util.is_local_address(coord_host):
            # a local alias would name the wrong machine on the remote hosts
            coord_host = network_util.reachable_local_name()
        coordinator = f"{coord_host}:{DEFAULT_COORDINATOR_PORT}"
    forwarded = {
        key: val
        for key, val in os.environ.items()
        if key.startswith(_FORWARD_PREFIXES)
    }
    env = build_child_env(args, base_env=forwarded, local_workers=0)
    env["BLUEFOG_COORDINATOR"] = coordinator
    env["BLUEFOG_NUM_PROCESSES"] = str(len(hosts))

    commands = []
    for i, hs in enumerate(hosts):
        proc_env = dict(env)
        proc_env["BLUEFOG_LOCAL_WORKERS"] = str(hs.slots)
        proc_env["BLUEFOG_PROCESS_ID"] = str(i)
        env_prefix = ["env"] + [f"{k}={v}" for k, v in sorted(proc_env.items())]
        local = network_util.is_local_address(hs.host)
        argv = env_prefix + _command_argv(
            args.command,
            interpreter=None if local else getattr(args, "remote_python", "python3"),
        )
        if local:
            commands.append((hs.host, argv))
        else:
            ssh = ["ssh", "-o", "BatchMode=yes"]
            if args.ssh_port:
                ssh += ["-p", str(args.ssh_port)]
            ssh.append(hs.host)
            ssh.append(" ".join(shlex.quote(a) for a in argv))
            commands.append((hs.host, ssh))
    return commands


def _launch_pod(commands) -> int:
    """Start every process and poll them: on the first nonzero exit the
    others are terminated (a dead peer leaves the others blocked in the
    transport) and its code is returned."""
    procs = [subprocess.Popen(argv_) for _host, argv_ in commands]
    try:
        while any(p.poll() is None for p in procs):
            for (host, _), proc in zip(commands, procs):
                code = proc.poll()
                if code is not None and code != 0:
                    print(f"[bfrun-torch] process on {host} exited with {code}; "
                          "terminating the others", file=sys.stderr)
                    return code
            time.sleep(0.5)
        return next((p.returncode for p in procs if p.returncode != 0), 0)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def main(argv: Sequence[str] = None) -> int:
    args = parse_args(argv)

    if args.version:
        from bluefog_tpu_torch.version import __version__

        print(__version__)
        return 0

    if not args.command:
        print("bfrun-torch: no command to execute", file=sys.stderr)
        return 2

    if args.flight_dir:
        os.makedirs(args.flight_dir, exist_ok=True)

    if args.hosts or args.hostfile:
        hosts = (
            network_util.parse_hosts(args.hosts)
            if args.hosts
            else network_util.parse_hostfile(args.hostfile)
        )
        if not (len(hosts) == 1 and network_util.is_local_address(hosts[0].host)):
            commands = build_host_commands(args, hosts)
            if args.verbose:
                for host, argv_ in commands:
                    print(f"[bfrun-torch] {host}: {' '.join(argv_)}")
            rc = run_with_restarts(
                lambda: _launch_pod(commands), resolve_max_restarts(args),
                log=lambda msg: print(msg, file=sys.stderr),
            )
            if rc != 0:
                report_flight_artifacts(args.flight_dir)
            return rc

    # a process of an externally scheduled group (--coordinator) holds
    # size // processes workers unless BLUEFOG_LOCAL_WORKERS says otherwise
    external = args.coordinator and args.num_processes > 1
    env = build_child_env(args, base_env=dict(os.environ),
                          local_workers=0 if external else None)
    argv_ = _command_argv(args.command)
    max_restarts = resolve_max_restarts(args)
    if args.verbose:
        print(f"[bfrun-torch] exec: {' '.join(argv_)}")
    if max_restarts > 0 or args.flight_dir:
        rc = run_with_restarts(
            lambda: subprocess.run(argv_, env=env).returncode,
            max_restarts,
            log=lambda msg: print(msg, file=sys.stderr),
        )
        if rc != 0:
            report_flight_artifacts(args.flight_dir)
        return rc
    os.execvpe(argv_[0], argv_, env)
    raise AssertionError("unreachable")  # pragma: no cover


if __name__ == "__main__":
    sys.exit(main())
