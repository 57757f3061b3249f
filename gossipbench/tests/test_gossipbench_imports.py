"""Nothing the benchmark runs loads JAX or the JAX package, and the
command refuses to run where it cannot measure."""

import os
import shutil
import subprocess
import sys

from gossipbench import harness

RUN = r"""
import sys, time
sys.path.insert(0, {root!r})
import gossipbench.run, gossipbench.control
from gossipbench import harness
from gossipbench.tests import tiny
for name in tiny.cells():
    tiny.run(name, trace=True)
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_after_a_run():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", RUN.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=600, env=env,
                         cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(out.stdout.strip().splitlines()[-1].split(","))
    assert "bluefog_tpu_torch" in loaded and "gossipbench" in loaded
    assert not loaded & set(harness.FOREIGN), loaded & set(harness.FOREIGN)


def test_foreign_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert "jax" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.foreign_modules()


def _command(cwd, *args):
    return subprocess.run([sys.executable, "gossipbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card_or_the_program(tmp_path):
    args = ("--workload", harness.benchmark()["workloads"][0]["name"], "--seed", "1",
            "--seconds", "1", "--trace", "0")
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "gossipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (harness.ROOT, tmp_path):
        out = _command(cwd, *args)
        assert out.returncode != 0
        for line in out.stdout.splitlines():
            assert not line.startswith("{"), line
    bad = _command(harness.ROOT, "--workload", "no-such-cell", "--seed", "1", "--seconds", "1")
    assert bad.returncode != 0 and not bad.stdout.strip()
