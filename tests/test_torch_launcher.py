# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's launcher (``bluefog_tpu_torch.run``) against the JAX
package's (``bluefog_tpu.run``) on the same arguments.

The two differ where their environments do, and each difference is named
where it is tested:

- the JAX launcher sizes the virtual CPU platform of each process through
  ``XLA_FLAGS`` (and ``--platform cpu`` sets ``JAX_PLATFORMS``); the port
  sets the process's worker count, ``BLUEFOG_LOCAL_WORKERS``, and
  ``--platform`` takes only ``auto``;
- the forwarded prefixes are ``BLUEFOG_``, ``TORCH_``, ``NCCL_``, ``GLOO_``
  and ``CUDA_`` (JAX: ``BLUEFOG_``, ``JAX_``, ``XLA_``, ``LIBTPU_``, ``TPU_``);
- when every ``-H`` host is this machine the port's coordinator is
  ``127.0.0.1`` (JAX's names the machine by a routable name).

Host names are never resolved here: ``socket.gethostname`` and
``socket.getfqdn`` are replaced for every test. The last test launches
``bfrun-torch -np 4 -H localhost:2,localhost:2`` end to end.
"""

import os
import socket
import subprocess
import sys

import pytest

from bluefog_tpu.run import network_util as jnet
from bluefog_tpu.run import run as jrun
from bluefog_tpu_torch.run import interactive_run, network_util
from bluefog_tpu_torch.run import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E_TIMEOUT = 120


@pytest.fixture(autouse=True)
def _no_name_lookups(monkeypatch):
    monkeypatch.setattr(socket, "gethostname", lambda: "box")
    monkeypatch.setattr(socket, "getfqdn", lambda *a: "box.cluster")


# -- network_util ----------------------------------------------------------------


@pytest.mark.parametrize("hosts", ["host1:2,host2:4,host3", "localhost:4,localhost:4",
                                   " a:1 , b ", "h:16"])
def test_parse_hosts_equal_jax(hosts):
    assert network_util.parse_hosts(hosts) == jnet.parse_hosts(hosts)


@pytest.mark.parametrize("hosts", [" , ", ""])
def test_parse_hosts_empty_raises_like_jax(hosts):
    with pytest.raises(ValueError):
        jnet.parse_hosts(hosts)
    with pytest.raises(ValueError):
        network_util.parse_hosts(hosts)


@pytest.mark.parametrize("text", ["# pod\nhost1 slots=4\n\nhost2 slots = 4  # x\nhost3\n",
                                  "h slots=two\n", "# nothing\n"])
def test_parse_hostfile_equal_jax(tmp_path, text):
    hf = tmp_path / "hosts"
    hf.write_text(text)
    try:
        want = jnet.parse_hostfile(str(hf))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            network_util.parse_hostfile(str(hf))
        assert str(got.value) == str(e)
    else:
        assert network_util.parse_hostfile(str(hf)) == want


@pytest.mark.parametrize("host", ["localhost", "127.0.0.1", "::1", "0.0.0.0", "box",
                                  "box.cluster", "farawayhost"])
def test_local_addresses_equal_jax(host):
    assert network_util.is_local_address(host) == jnet.is_local_address(host)
    assert network_util.filter_local_addresses([host, "far"]) == \
        jnet.filter_local_addresses([host, "far"])
    assert network_util.reachable_local_name() == jnet.reachable_local_name()


# -- the argument surface ----------------------------------------------------------


ARGVS = [
    ["-np", "8", "--timeline-filename", "/tmp/tl", "--extra-env", "FOO=1", "--verbose",
     "train.py", "--lr", "0.1"],
    ["-np", "8", "-H", "h1:4,h2:4", "--flight-dir", "/tmp/f", "--max-restarts", "2", "x.py"],
    ["-np", "8", "--hostfile", "hf", "-p", "2222", "--remote-python", "py3", "x.py"],
    ["-np", "8", "--coordinator", "h0:9781", "--num-processes", "2", "--process-id", "1",
     "x.py"],
    ["-np", "4", "--", "x.py", "-v"],
    ["--version"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parse_args_equal_jax(argv):
    assert vars(run.parse_args(argv)) == vars(jrun.parse_args(argv))


@pytest.mark.parametrize("argv", [["train.py"], ["-np", "8", "--coordinator", "h:1", "x.py"],
                                  ["-np", "4", "-H", "a:2", "--hostfile", "f", "x.py"]])
def test_parse_args_refusals_equal_jax(argv):
    with pytest.raises(SystemExit):
        jrun.parse_args(argv)
    with pytest.raises(SystemExit):
        run.parse_args(argv)


def test_platform_takes_only_auto():
    """Named difference: ``--platform`` is ``auto`` only (JAX also takes
    ``cpu`` and ``tpu``); no variable moves the port to the CPU."""
    assert run.parse_args(["-np", "2", "--platform", "auto", "x.py"]).platform == "auto"
    assert jrun.parse_args(["-np", "2", "--platform", "cpu", "x.py"]).platform == "cpu"
    with pytest.raises(SystemExit):
        run.parse_args(["-np", "2", "--platform", "cpu", "x.py"])


# -- the environment contract --------------------------------------------------------


ENV_ARGVS = [
    ["-np", "4", "x.py"],
    ["-np", "2", "--timeline-filename", "/tmp/tl_", "--extra-env", "A=b", "x.py"],
    ["-np", "8", "--coordinator", "h0:9781", "--num-processes", "2", "--process-id", "1",
     "x.py"],
    ["-np", "8", "--flight-dir", "/tmp/f", "x.py"],
]


def _without_xla(env):
    return {k: v for k, v in env.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}


@pytest.mark.parametrize("argv", ENV_ARGVS, ids=range(len(ENV_ARGVS)))
@pytest.mark.parametrize("local", [None, 0, 3])
def test_child_env_equal_jax_but_the_worker_count(argv, local):
    """The same environment, except the named difference: JAX's
    ``XLA_FLAGS`` device count (``cpu_count``) is the port's
    ``BLUEFOG_LOCAL_WORKERS`` (``local_workers``)."""
    base = {"PATH": "/bin", "XLA_FLAGS": "--xla_dump_to=/d"}
    j = jrun.build_child_env(jrun.parse_args(argv), dict(base), cpu_count=local)
    t = run.build_child_env(run.parse_args(argv), {"PATH": "/bin"}, local_workers=local)
    count = run.parse_args(argv).np if local is None else local
    want = dict(_without_xla(j))
    if count > 0:
        want["BLUEFOG_LOCAL_WORKERS"] = str(count)
        assert f"--xla_force_host_platform_device_count={count}" in j["XLA_FLAGS"]
    assert t == want


def test_host_commands_slots_mismatch_like_jax():
    argv = ["-np", "4", "-H", "h1:4,h2:4", "x.py"]
    hosts = network_util.parse_hosts("h1:4,h2:4")
    with pytest.raises(ValueError) as j:
        jrun.build_host_commands(jrun.parse_args(argv), hosts)
    with pytest.raises(ValueError) as t:
        run.build_host_commands(run.parse_args(argv), hosts)
    assert str(t.value) == str(j.value)


def _split(argv):
    """``(env dict, command)`` of an ``env K=V ... cmd`` argv (local) or
    of the quoted command an ssh argv ends with (remote)."""
    import shlex

    if argv[0] == "ssh":
        words = shlex.split(argv[-1])
        head = argv[:-1]
    else:
        words, head = argv, []
    assert words[0] == "env"
    k = 1
    env = {}
    while "=" in words[k] and not words[k].startswith("/"):
        key, val = words[k].split("=", 1)
        env[key] = val
        k += 1
    return head, env, words[k:]


@pytest.mark.parametrize("hosts", ["localhost:4,far1:4", "far1:2,far2:6", "box:3,far:5",
                                   "localhost:4,localhost:4", "127.0.0.1:2,localhost:6"])
@pytest.mark.parametrize("extra", [[], ["-p", "2222"], ["--coordinator", "c:1",
                                                        "--num-processes", "2"]])
def test_host_commands_equal_jax_but_named_differences(hosts, extra, monkeypatch):
    """The same processes, hosts, ssh wrapping, interpreters and
    environments, except the named differences: ``XLA_FLAGS`` against
    ``BLUEFOG_LOCAL_WORKERS``, the forwarded prefixes, and a coordinator of
    ``127.0.0.1`` when every host is local."""
    monkeypatch.setenv("XLA_FLAGS", "--xla_dump_to=/tmp/d")
    monkeypatch.setenv("NCCL_DEBUG", "INFO")
    monkeypatch.setenv("BLUEFOG_X", "1")
    argv = ["-np", "8", "-H", hosts] + extra + ["x.py", "--lr", "1"]
    parsed = network_util.parse_hosts(hosts)
    j = jrun.build_host_commands(jrun.parse_args(argv), parsed)
    t = run.build_host_commands(run.parse_args(argv), parsed)
    all_local = all(network_util.is_local_address(h.host) for h in parsed)
    assert [h for h, _ in t] == [h for h, _ in j]
    for (hj, aj), (ht, at), hs in zip(j, t, parsed):
        head_j, env_j, cmd_j = _split(aj)
        head_t, env_t, cmd_t = _split(at)
        assert head_t == head_j and cmd_t == cmd_j
        want = {k: v for k, v in env_j.items()
                if not k.startswith(("XLA_", "JAX_", "LIBTPU_", "TPU_"))}
        want["BLUEFOG_LOCAL_WORKERS"] = str(hs.slots)
        want.update((k, v) for k, v in os.environ.items()
                    if k.startswith(("TORCH_", "NCCL_", "GLOO_", "CUDA_")))
        assert want["NCCL_DEBUG"] == "INFO"
        if all_local and "--coordinator" not in extra:
            assert env_j["BLUEFOG_COORDINATOR"] == "box.cluster:9781"
            want["BLUEFOG_COORDINATOR"] = "127.0.0.1:9781"
        assert env_t == want


def test_resolve_max_restarts_equal_jax():
    for argv, env in ((["-np", "2", "--max-restarts", "3", "x.py"], {"BLUEFOG_MAX_RESTARTS": "9"}),
                      (["-np", "2", "x.py"], {"BLUEFOG_MAX_RESTARTS": "5"}),
                      (["-np", "2", "x.py"], {})):
        assert run.resolve_max_restarts(run.parse_args(argv), env=env) == \
            jrun.resolve_max_restarts(jrun.parse_args(argv), env=env)
    for argv, env in ((["-np", "2", "x.py"], {"BLUEFOG_MAX_RESTARTS": "many"}),
                      (["-np", "2", "--max-restarts", "-1", "x.py"], {})):
        with pytest.raises(ValueError):
            jrun.resolve_max_restarts(jrun.parse_args(argv), env=env)
        with pytest.raises(ValueError):
            run.resolve_max_restarts(run.parse_args(argv), env=env)


def test_backoff_equal_jax():
    for a in range(8):
        for base, cap in ((1.0, 30.0), (0.5, 4.0)):
            assert run.backoff_seconds(a, base, cap) == jrun.backoff_seconds(a, base, cap)


@pytest.mark.parametrize("codes,budget", [([1, 1, 0], 5), ([7, 7, 7], 2), ([3], 0), ([0], 3)])
def test_run_with_restarts_equal_jax(codes, budget):
    def drive(fn):
        it, sleeps, logs = iter(codes), [], []
        rc = fn(lambda: next(it), budget, sleep=sleeps.append, log=logs.append)
        return rc, sleeps, [m.replace("bfrun-torch", "bfrun-tpu") for m in logs]

    assert drive(run.run_with_restarts) == drive(jrun.run_with_restarts)


def test_flight_artifacts_equal_jax(tmp_path):
    for name in ("flight_1.json", "flight_0.json", "note.txt", "tl0.json"):
        (tmp_path / name).write_text("{}")
    assert run.flight_artifacts(str(tmp_path)) == jrun.flight_artifacts(str(tmp_path))
    assert run.flight_artifacts(str(tmp_path / "missing")) == []


def test_interactive_argv_equal_jax():
    from bluefog_tpu.run import interactive_run as jint

    assert interactive_run._interactive_argv(["a", "b"]) == jint._interactive_argv(["a", "b"])


# -- end to end ---------------------------------------------------------------------


E2E_SCRIPT = """
import numpy as np
import torch
import bluefog_tpu_torch as bft
ctx = bft.init(device="cpu")
assert bft.size() == 4 and ctx.process_count == 2 and ctx.n_local == 2, (bft.size(), ctx.rows)
assert ctx.local_size == 2 and ctx.machine_size == 2 and bft.rank() == ctx.process_index
x = bft.worker_values(lambda r: np.full(3, float(r), np.float32))
assert tuple(x.shape) == (2, 3)
y = bft.allreduce(x)
assert torch.equal(y, torch.full((2, 3), 1.5)), y
z = bft.neighbor_allreduce(x)
w = bft.load_topology()
nbrs = [[i for i in range(4) if i != j and w[i, j]] for j in range(4)]
want = np.array([[(j + sum(nbrs[j])) / (len(nbrs[j]) + 1)] * 3 for j in ctx.rows], np.float32)
assert np.allclose(z.numpy(), want, atol=1e-6), (z, want)
bft.barrier()
bft.shutdown()
import sys
sys.stdout.write(f"E2E_OK {ctx.process_index}\\n")  # one write: the two processes share the pipe
sys.stdout.flush()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_bfrun_torch_two_local_processes_end_to_end(tmp_path):
    script = tmp_path / "prog.py"
    script.write_text(E2E_SCRIPT)
    env = {k: v for k, v in os.environ.items() if not k.startswith("BLUEFOG_")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.run", "-np", "4",
         "-H", "localhost:2,localhost:2", "--coordinator", f"127.0.0.1:{_free_port()}",
         "--num-processes", "2", str(script)],
        capture_output=True, text=True, timeout=E2E_TIMEOUT, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert sorted(line.split()[1] for line in out.stdout.splitlines()
                  if line.startswith("E2E_OK")) == ["0", "1"]


def test_bfrun_torch_version():
    out = subprocess.run([sys.executable, "-m", "bluefog_tpu_torch.run.run", "--version"],
                         capture_output=True, text=True, timeout=E2E_TIMEOUT,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0 and out.stdout.strip()


IBFRUN_PROBE = """
import os
assert os.environ["BLUEFOG_NUM_WORKERS"] == "4", os.environ
assert os.environ["BLUEFOG_STALL_TIMEOUT"] == "0", os.environ
import numpy as np
import bluefog_tpu_torch as bft
bft.init(device="cpu")
assert bft.size() == 4, bft.size()
x = bft.worker_values(lambda r: np.full((2,), float(r), np.float32))
for _ in range(20):
    x = bft.neighbor_allreduce(x)
mse = float(np.mean((x.numpy() - 1.5) ** 2))
assert mse < 1e-6, mse
bft.suspend(); bft.resume(); bft.shutdown()
print("IBFRUN_OK")
"""


def test_ibfrun_torch_start_executes_env_contract(tmp_path):
    """``ibfrun-torch start -np 4 <cmd>`` runs the command with the worker
    count set and the stall watchdog off, as JAX's ``ibfrun-tpu`` test
    drives it (the port's program picks the CPU itself)."""
    probe = tmp_path / "probe.py"
    probe.write_text(IBFRUN_PROBE)
    env = {k: v for k, v in os.environ.items() if not k.startswith("BLUEFOG_")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.run.interactive_run", "start", "-np", "4",
         sys.executable, str(probe)],
        capture_output=True, text=True, timeout=E2E_TIMEOUT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "IBFRUN_OK" in out.stdout
