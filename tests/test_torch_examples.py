# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's examples (``examples/torch_*.py``) as subprocesses on the CPU
(``--device cpu``), at the arguments of ``examples/run_all_examples.sh``
or smaller ones (mnist 40 epochs, long context 10 steps, the benchmark 3
iterations).

Where an example prints a deterministic trajectory its numbers are held to
a numpy replay of the same recursion in float64: the consensus mse of the
leading iterations (those above 1e-10, where float32 rounding is not
everything) within 1e-5 relative, the least-squares errors at iteration
10 within 1e-4 relative plus 1e-6 absolute (float32 iterates of norm about
1), the resumed checkpoint run's loss within 1e-5 relative, its
parameters bitwise those of the uninterrupted run.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from bluefog_tpu_torch import topology as ttu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
SIZE = 8


# every invocation of this file, started together when the first test asks
# (the examples are small and mostly wait on process start; one after
# another they take several times as long)
INVOCATIONS = {
    "consensus": ("torch_average_consensus.py",),
    "optimization": ("torch_decentralized_optimization.py", "--report", "10"),
    "checkpoint": ("torch_checkpoint_resume.py",),
    "mnist-neighbor_allreduce": ("torch_mnist.py", "--dist-optimizer", "neighbor_allreduce",
                                 "--epochs", "40"),
    "mnist-gradient_allreduce": ("torch_mnist.py", "--dist-optimizer", "gradient_allreduce",
                                 "--epochs", "40"),
    "mnist-win_put": ("torch_mnist.py", "--dist-optimizer", "win_put", "--epochs", "40"),
    "benchmark-static": ("torch_benchmark.py", "--model", "mlp", "--num-iters", "3"),
    "benchmark-dynamic": ("torch_benchmark.py", "--model", "mlp", "--dynamic", "--num-iters",
                          "3"),
    "long-context": ("torch_long_context.py", "--steps", "10"),
}
TIMEOUT = 240


@pytest.fixture(scope="module")
def started():
    env = {k: v for k, v in os.environ.items() if not k.startswith("BLUEFOG_")}
    # one intra-op thread each: nine processes share the host with the
    # other test workers, and unbounded thread pools slow every one of them
    env["OMP_NUM_THREADS"] = "1"
    procs = {key: subprocess.Popen(
        [sys.executable, os.path.join(EXAMPLES, argv[0]), "--device", "cpu", *argv[1:]],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for key, argv in INVOCATIONS.items()}
    yield procs, {}
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def run_example(started, key):
    """The stdout of invocation ``key``, which must exit 0 and, but for the
    benchmark, print PASSED."""
    procs, done = started
    if key not in done:
        try:
            done[key] = procs[key].communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            procs[key].kill()
            done[key] = procs[key].communicate()
    out, err = done[key]
    assert procs[key].returncode == 0, (
        f"{INVOCATIONS[key]} failed\nstdout:\n{out}\nstderr:\n{err}")
    assert "PASSED" in out or key.startswith("benchmark"), out
    return out


def _uniform(topo):
    """Receiver weights ``1 / (in_degree + 1)`` over self and the
    in-neighbours: ``W[i, j]`` is the weight ``j`` gives ``i``."""
    mask = (np.asarray(topo) != 0).astype(np.float64)
    np.fill_diagonal(mask, 1.0)
    return mask / mask.sum(axis=0, keepdims=True)


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=0)


def test_average_consensus_matches_a_numpy_replay(started):
    out = run_example(started, "consensus")
    rows = {m.group(1): [float(v) for v in m.group(2).split()]
            for m in re.finditer(r"^\[(.+)\] mse by iteration: (.+)$", out, re.M)}
    data = np.random.RandomState(42).randn(SIZE, 16).astype(np.float32).astype(np.float64)
    target = data.mean(0)
    w = _uniform(ttu.ExponentialGraph(SIZE))
    x, static = data, []
    for _ in range(5):
        x = w.T @ x
        static.append(np.mean((x - target) ** 2))
    gens = [ttu.GetDynamicOnePeerSendRecvRanks(ttu.ExponentialTwoGraph(SIZE), r)
            for r in range(SIZE)]
    x, dynamic = data, []
    for _ in range(5):
        wt = np.eye(SIZE) * 0.5
        for j, (_send, recv) in enumerate(next(g) for g in gens):
            wt[list(recv), j] = 0.5
        x = wt.T @ x
        dynamic.append(np.mean((x - target) ** 2))
    for name, want in (("static exp2", static), ("dynamic one-peer", dynamic),
                       ("window put/update", static)):
        keep = [i for i, v in enumerate(want) if v > 1e-10]
        assert len(keep) >= 2, name
        _close([rows[name][i] for i in keep], [want[i] for i in keep], 1e-5)


def _lsq_replay(kind, X, y, w_opt, iters, alpha):
    w = np.zeros((SIZE, X.shape[2]))
    grad = lambda w: np.einsum("rsd,rs->rd", X, np.einsum("rsd,rd->rs", X, w) - y) / X.shape[1]  # noqa: E731
    if kind == "push_diging":
        a = np.zeros((SIZE, SIZE))
        topo = np.asarray(ttu.ExponentialTwoGraph(SIZE))
        for i in range(SIZE):
            outs = [j for j in range(SIZE) if j != i and topo[i, j] != 0]
            a[i, outs] = 1.0 / (2 * len(outs))
        n = X.shape[2]
        wv = np.zeros((SIZE, 2 * n + 1))
        g = grad(np.zeros((SIZE, n)))
        wv[:, n:2 * n], wv[:, -1], g_prev = g, 1.0, g
        for _ in range(iters):
            wv[:, :n] -= 0.1 * wv[:, n:2 * n]
            wv = 0.5 * wv + a.T @ wv
            x = wv[:, :n] / wv[:, -1:]
            g = grad(x)
            wv[:, n:2 * n] += g - g_prev
            g_prev = g
        return np.linalg.norm(x.mean(0) - w_opt)
    mix = np.asarray(ttu.ExponentialTwoGraph(SIZE), np.float64).T
    psi_prev, q, g_prev = w, grad(w), grad(w)
    for _ in range(iters):
        if kind == "diffusion":
            w = mix @ (w - alpha * grad(w))
        elif kind == "exact_diffusion":
            psi = w - alpha * grad(w)
            w, psi_prev = mix @ (psi + w - psi_prev), psi
        else:
            w = mix @ w - alpha * q
            g = grad(w)
            q, g_prev = mix @ q + g - g_prev, g
    return np.linalg.norm(w.mean(0) - w_opt)


def test_decentralized_optimization_matches_a_numpy_replay(started):
    sys.path.insert(0, EXAMPLES)
    try:
        import torch_decentralized_optimization as ex
    finally:
        sys.path.remove(EXAMPLES)
    out = run_example(started, "optimization")
    got = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^\[(\w+)\s*\] \|w - w_opt\| at iteration 10: (\S+);", out, re.M)}
    X, y, w_opt = (a.astype(np.float64) for a in ex.make_problem(SIZE))
    assert sorted(got) == sorted(ex.TOLS)
    for kind in sorted(ex.TOLS):
        np.testing.assert_allclose(got[kind], _lsq_replay(kind, X, y, w_opt, 10, 0.2),
                                   rtol=1e-4, atol=1e-6)


def test_checkpoint_resume_matches_a_numpy_replay(started):
    out = run_example(started, "checkpoint")
    assert "bitwise equal: True" in out and "step counters 30 / 30" in out
    loss = float(re.search(r"loss (\S+)$", out, re.M).group(1))
    c = np.random.RandomState(3).randn(SIZE, 8).astype(np.float32).astype(np.float64)
    gens = [ttu.GetDynamicOnePeerSendRecvRanks(ttu.ExponentialGraph(SIZE), r)
            for r in range(SIZE)]
    w = c.copy()
    for _ in range(30):
        wt = np.eye(SIZE)
        for j, (_send, recv) in enumerate(next(g) for g in gens):
            wt[list(recv) + [j], j] = 1.0 / (len(recv) + 1)
        w = wt.T @ w - 0.15 * (w - c)
    _close(loss, np.mean((w - c.mean(0)) ** 2), 1e-5)


@pytest.mark.parametrize("optimizer", ["neighbor_allreduce", "gradient_allreduce", "win_put"])
def test_mnist(started, optimizer):
    out = run_example(started, f"mnist-{optimizer}")
    assert float(re.search(r"final train accuracy: (\S+)", out).group(1)) > 0.9


@pytest.mark.parametrize("dynamic", [False, True])
def test_benchmark_static_and_dynamic(started, dynamic):
    out = run_example(started, "benchmark-dynamic" if dynamic else "benchmark-static")
    assert "imgs/sec" in out and ("/ dynamic]" in out) == dynamic


def test_long_context(started):
    out = run_example(started, "long-context")
    assert "|delta| = " in out
