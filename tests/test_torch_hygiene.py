# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Import hygiene of the PyTorch/CUDA port, and its refusal to fall back
to the CPU silently.

``bluefog_tpu_torch``, ``chip_smoke.py`` and the port's examples
(``examples/torch_*.py``) run on a machine with no JAX and no networkx, so
none may import ``jax``, ``flax``, ``optax``, ``networkx`` or anything of
the JAX package ``bluefog_tpu``.
"""

import ast
import re
from pathlib import Path

import pytest
import torch

import bluefog_tpu_torch as bft
from bluefog_tpu_torch.collective import kernels
from bluefog_tpu_torch.ops import flash, flash_attention

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "networkx", "ml_dtypes", "bluefog_tpu")


def _port_sources():
    return (sorted((ROOT / "bluefog_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_exist():
    names = {p.name for p in _port_sources()}
    assert {"chip_smoke.py", "kernels.py", "optimizers.py", "resnet.py", "windows.py",
            "flash.py", "attention.py", "transformer.py", "dynamic.py", "mlp.py",
            "long_context.py", "dryrun.py", "ops.py", "inner.py", "plan.py", "infer.py",
            "graphs.py", "utility.py", "context.py", "stacked.py", "async_gossip.py",
            "attribution.py", "sharding.py", "scaling.py", "checkpoint.py",
            "logging_util.py", "watchdog.py", "timeline.py", "metrics.py", "flight.py",
            "version.py", "torch_average_consensus.py", "torch_decentralized_optimization.py",
            "torch_mnist.py", "torch_long_context.py", "torch_checkpoint_resume.py",
            "torch_benchmark.py", "faults.py", "membership.py", "repair.py",
            "recovery.py", "staleness.py", "memory.py", "spectral.py", "placement.py",
            "health.py", "fleetsim.py", "federation.py", "slo.py", "wire_ref.py",
            "autotune.py", "transport.py", "run.py", "network_util.py",
            "interactive_run.py", "mpi_ops.py", "batchnorm.py"} <= names
    for source in ("__init__.py", "run.py", "network_util.py", "interactive_run.py"):
        assert (ROOT / "bluefog_tpu_torch" / "run" / source).is_file()
    assert (ROOT / "bluefog_tpu_torch" / "collective" / "transport.py").is_file()
    for source in ("__init__.py", "faults.py", "membership.py", "repair.py", "recovery.py"):
        assert (ROOT / "bluefog_tpu_torch" / "elastic" / source).is_file()
    for source in ("wire_kernels.cu", "flash_kernels.cu", "batchnorm_kernels.cu"):
        assert (ROOT / "bluefog_tpu_torch" / "csrc" / source).is_file()
    for source in ("__init__.py", "mpi_ops.py", "optimizers.py"):
        path = ROOT / "bluefog_tpu_torch" / "torch" / source
        assert path.is_file() and path in _port_sources()


@pytest.mark.parametrize("call", ["scaled_dot_product_attention", "torch.compile", "cudnn"])
def test_port_calls_no_library_attention_or_compiler(call):
    """The port's attention is its own kernels: no module of the package
    calls PyTorch's fused attention, cuDNN or ``torch.compile`` (only
    ``chip_smoke.py`` times SDPA, as a yardstick)."""
    for path in sorted((ROOT / "bluefog_tpu_torch").rglob("*.py")):
        assert call not in path.read_text(), f"{path.name} mentions {call}"


def test_observability_exports_have_the_jax_names():
    """The observability names of ``bluefog_tpu/__init__.py``, with its
    signatures (compared as source text: the JAX package is not imported)."""
    import inspect

    names = ("flight", "flight_dump", "metrics", "metrics_export", "metrics_snapshot",
             "timeline", "timeline_init", "timeline_shutdown", "timeline_enabled",
             "timeline_start_activity", "timeline_end_activity", "timeline_record_instant",
             "timeline_record_counter", "timeline_context", "watchdog", "suspend", "resume",
             "set_stall_timeout", "logger", "set_log_level", "__version__")
    assert set(names) <= set(bft.__all__)
    jax_init = (ROOT / "bluefog_tpu" / "__init__.py").read_text()
    version = (ROOT / "bluefog_tpu" / "version.py").read_text()
    assert f'__version__ = "{bft.__version__}"' in version
    for name in names[:-1]:
        if name in ("timeline", "watchdog"):  # submodules, not in JAX's __all__
            assert (ROOT / "bluefog_tpu" / f"{name}.py").is_file()
        else:
            assert f'"{name}"' in jax_init, name
    for name in ("timeline_init", "timeline_start_activity", "timeline_record_counter",
                 "set_stall_timeout", "metrics_export"):
        src = (ROOT / "bluefog_tpu" / f"{getattr(bft, name).__module__.split('.')[-1]}.py"
               ).read_text()
        params = list(inspect.signature(getattr(bft, name)).parameters)
        assert re.search(rf"def {name}\(\s*{params[0]}\b", src), name


def test_elastic_exports_have_the_jax_names():
    """``bft.elastic`` exports the names of ``bluefog_tpu/elastic/__init__.py``
    (compared as source text: the JAX package is not imported), with the
    signatures of its facade functions."""
    import inspect

    jax_init = (ROOT / "bluefog_tpu" / "elastic" / "__init__.py").read_text()
    block = jax_init[jax_init.index("__all__ = ["):]
    jax_names = re.findall(r'"(\w+)"', block[:block.index("]")])
    assert len(jax_names) == 22
    assert sorted(bft.elastic.__all__) == sorted(jax_names)
    assert "elastic" in bft.__all__
    for name in jax_names:
        assert hasattr(bft.elastic, name), name
    for name in ("start", "stop", "active_session", "inject", "guard"):
        params = list(inspect.signature(getattr(bft.elastic, name)).parameters)
        m = re.search(rf"def {name}\(([^)]*)\)", jax_init)
        want = [p.split(":")[0].split("=")[0].strip().lstrip("*")
                for p in m.group(1).replace("\n", " ").split(",")]
        assert params == [w for w in want if w], name


def test_torch_frontend_exports_have_the_jax_names():
    """``bluefog_tpu_torch.torch`` exports ``bluefog_tpu.torch``'s
    ``__all__``, in its order, each function taking JAX's parameters first
    (read from the source with ``ast``: the JAX package is not imported).
    The package does not import its frontend, as ``bluefog_tpu`` does not
    import its own."""
    import inspect

    import bluefog_tpu_torch.torch as bftt

    jax_dir = ROOT / "bluefog_tpu" / "torch"
    (jax_all,) = [ast.literal_eval(n.value) for n in ast.parse((jax_dir / "__init__.py")
                                                              .read_text()).body
                  if isinstance(n, ast.Assign) and n.targets[0].id == "__all__"]
    assert bftt.__all__ == jax_all
    defs = {n.name: [a.arg for a in n.args.args + n.args.kwonlyargs]
            for source in ("mpi_ops.py", "optimizers.py")
            for n in ast.parse((jax_dir / source).read_text()).body
            if isinstance(n, ast.FunctionDef)}
    for name in jax_all:
        params = list(inspect.signature(getattr(bftt, name)).parameters)
        assert params[:len(defs[name])] == defs[name], name
    init = ast.parse((ROOT / "bluefog_tpu_torch" / "__init__.py").read_text())
    for node in ast.walk(init):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert not node.module.startswith("bluefog_tpu_torch.torch")
            if node.module == "bluefog_tpu_torch":
                assert "torch" not in [a.name for a in node.names]


@pytest.mark.parametrize("module", ["attribution", "staleness", "memory"])
def test_observatory_exports_have_the_jax_names(module):
    """``bft.attribution`` (alias ``bft.doctor``), ``bft.staleness`` and
    ``bft.memory`` export the names of the JAX modules' ``__all__``, with
    the signatures of their module functions (compared as source text: the
    JAX package is not imported)."""
    import inspect

    src = (ROOT / "bluefog_tpu" / f"{module}.py").read_text()
    block = src[src.index("__all__ = ["):]
    jax_names = re.findall(r'"(\w+)"', block[:block.index("]")])
    port = getattr(bft, module)
    assert sorted(port.__all__) == sorted(jax_names)
    assert module in bft.__all__ and "doctor" in bft.__all__ and bft.doctor is bft.attribution
    defs = {n.name: n.args for n in ast.parse(src).body if isinstance(n, ast.FunctionDef)}
    for name in jax_names:
        obj = getattr(port, name)
        if inspect.isfunction(obj):
            a = defs[name]
            want = [x.arg for x in a.args + ([a.vararg] if a.vararg else []) + a.kwonlyargs
                    + ([a.kwarg] if a.kwarg else [])]
            assert list(inspect.signature(obj).parameters) == want, name
    for extra in ("suspect_join", "DEGRADE_RATIO", "BREACH_COOLDOWN", "ADVISORY_COOLDOWN",
                  "DRIFT_STREAK", "ENABLE_ENV", "INTERVAL_ENV", "FILE_ENV"):
        if re.search(rf"^(def )?{extra}\b", src, re.M):
            assert hasattr(port, extra), extra


@pytest.mark.parametrize("module", ["fleetsim", "federation", "slo", "autotune"])
def test_fleet_exports_have_the_jax_names(module):
    """``bft.fleetsim``, ``bft.federation``, ``bft.slo`` and ``bft.autotune``
    export the JAX modules' public names (their ``__all__``; ``slo.py`` has
    none, so its public top-level names), with the signatures of their module
    functions (compared as source text: the JAX package is not imported)."""
    import inspect

    src = (ROOT / "bluefog_tpu" / f"{module}.py").read_text()
    body = ast.parse(src).body
    if "__all__ = [" in src:
        block = src[src.index("__all__ = ["):]
        jax_names = re.findall(r'"(\w+)"', block[:block.index("]")])
    else:
        jax_names = [n.name for n in body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                     and not n.name.startswith("_")]
        jax_names += [t.id for n in body if isinstance(n, ast.Assign) for t in n.targets
                      if isinstance(t, ast.Name) and not t.id.startswith("_")]
    port = getattr(bft, module)
    assert module in bft.__all__
    assert sorted(port.__all__) == sorted(jax_names)
    defs = {n.name: n.args for n in body if isinstance(n, ast.FunctionDef)}
    for name in jax_names:
        obj = getattr(port, name)
        if inspect.isfunction(obj):
            a = defs[name]
            want = [x.arg for x in a.args + ([a.vararg] if a.vararg else []) + a.kwonlyargs
                    + ([a.kwarg] if a.kwarg else [])]
            assert list(inspect.signature(obj).parameters) == want, name


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_networkx_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bft.init()
    assert not bft.is_initialized()
    ctx = bft.init(device="cpu")
    try:
        assert ctx.device.type == "cpu"
    finally:
        bft.shutdown()


def test_wrappers_take_plain_versions_only_on_cpu():
    """A CPU tensor takes the plain version and counts no launch; any
    other device is refused rather than computed elsewhere."""
    kernels.reset_launch_counts()
    x = torch.randn(2, 1024)
    src = torch.tensor([[1, 0]], dtype=torch.int32)
    p, s = kernels.encode(x, "int8")
    kernels.decode_accumulate(x.clone(), p, s, src, torch.full((1, 2), 0.5), "int8")
    kernels.encode_diff(x, torch.zeros_like(x), "int8")
    kernels.decode_add(x.clone(), p, s, src[0], "int8")
    kernels.decode(p, s, src[0], "int8")
    kernels.decode(p, s, None, "int8")
    assert kernels.launch_counts() == {
        "encode": 0, "encode_diff": 0, "decode": 0, "decode_add": 0, "decode_accumulate": 0,
    }
    for call in (
        lambda m: kernels.encode(m, "int8"),
        lambda m: kernels.encode_diff(m, m.clone(), "int8"),
        lambda m: kernels.decode_add(m, p.to("meta"), s.to("meta"), src[0].to("meta"), "int8"),
    ):
        with pytest.raises(ValueError):
            call(x.to("meta"))


def test_flash_wrappers_take_plain_versions_only_on_cpu():
    """The flash kernels' wrappers likewise: CPU tensors take the plain
    versions and count no launch (forward, both backward kernels, and
    autograd through ``flash_attention``); a ``meta`` tensor is refused."""
    flash.reset_launch_counts()
    q = torch.randn(1, 24, 2, 8, requires_grad=True)
    flash_attention(q, q, q, causal=True).sum().backward()
    out, lse = flash.flash_fwd(q.detach(), q.detach(), q.detach(), True, 0.5)
    delta = flash.attention_delta(out, out)
    args = (q.detach(), q.detach(), q.detach(), out, lse, delta, None, True, 0.5)
    flash.flash_bwd_dkv(*args)
    flash.flash_bwd_dq(*args)
    assert flash.launch_counts() == {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    m = q.detach().to("meta")
    for call in (
        lambda: flash.flash_fwd(m, m, m, True, 0.5),
        lambda: flash.flash_bwd_dkv(m, m, m, m, lse.to("meta"), delta.to("meta"), None, True, 0.5),
        lambda: flash.flash_bwd_dq(m, m, m, m, lse.to("meta"), delta.to("meta"), None, True, 0.5),
        lambda: flash_attention(m, m, m, causal=True),
    ):
        with pytest.raises(ValueError):
            call()
