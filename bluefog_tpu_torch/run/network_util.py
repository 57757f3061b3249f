# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Host-list parsing for the launcher.

Counterpart of ``bluefog_tpu/run/network_util.py`` (the reference's
hostfile and ``-H`` handling without NIC discovery: the process group's
rendezvous address is the coordinator's). Pure functions, tested without
any network.
"""

import re
import socket
from typing import List, NamedTuple, Sequence

__all__ = [
    "HostSlots",
    "parse_hosts",
    "parse_hostfile",
    "filter_local_addresses",
]

_HOSTFILE_LINE = re.compile(r"^(?P<host>\S+)(\s+slots\s*=\s*(?P<slots>\d+))?\s*$")


class HostSlots(NamedTuple):
    host: str
    slots: int


def parse_hosts(hosts: str) -> List[HostSlots]:
    """Parse ``host1:2,host2:4`` (reference -H format, run/run.py:78-83).

    A missing ``:slots`` suffix means one process slot on that host.
    """
    out: List[HostSlots] = []
    for part in hosts.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            host, slots = part.rsplit(":", 1)
            out.append(HostSlots(host, int(slots)))
        else:
            out.append(HostSlots(part, 1))
    if not out:
        raise ValueError(f"no hosts in host list {hosts!r}")
    return out


def parse_hostfile(path: str) -> List[HostSlots]:
    """Parse ``<hostname> slots=<n>`` lines (reference hostfile format,
    run/run.py:84-87). Blank lines and ``#`` comments are skipped."""
    out: List[HostSlots] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            m = _HOSTFILE_LINE.match(line)
            if m is None:
                raise ValueError(f"{path}:{lineno}: malformed hostfile line {line!r}")
            out.append(HostSlots(m.group("host"), int(m.group("slots") or 1)))
    if not out:
        raise ValueError(f"hostfile {path} lists no hosts")
    return out


_LOCAL_NAMES = frozenset({"localhost", "127.0.0.1", "::1", "0.0.0.0"})


def is_local_address(host: str) -> bool:
    if host in _LOCAL_NAMES:
        return True
    try:
        return host in (socket.gethostname(), socket.getfqdn())
    except OSError:
        return False


def filter_local_addresses(hosts: Sequence[str]) -> List[str]:
    """Hostnames that are NOT this machine (reference
    network_util.filter_local_addresses)."""
    return [h for h in hosts if not is_local_address(h)]


def reachable_local_name() -> str:
    """A name for THIS machine that remote hosts can route to — used for
    the coordinator address when the host list says 'localhost'."""
    fqdn = socket.getfqdn()
    if fqdn and fqdn not in _LOCAL_NAMES:
        return fqdn
    return socket.gethostname()
