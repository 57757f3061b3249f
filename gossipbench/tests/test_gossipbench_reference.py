"""The plain reference against the port on tiny sizes on the CPU, and the
reference's independence from the program."""

import ast
from pathlib import Path

import pytest
import torch

from gossipbench import harness
from gossipbench.drivers import train
from gossipbench.lib import compare
from gossipbench.reference import wire
from gossipbench.tests import tiny

REFERENCE = Path(harness.HERE) / "reference"


def test_reference_imports_nothing_of_the_program():
    for path in sorted(REFERENCE.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in ("torch", "gossipbench", "math", "dataclasses",
                                              "contextlib", "typing"), (path.name, name)
                if name.startswith("gossipbench."):
                    assert name.split(".")[1] in ("lib", "reference"), (path.name, name)


@pytest.mark.parametrize("name", tiny.cells())
@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_program_follows_the_reference(name, seed):
    _w, cfg, m, lim = tiny.cell(name)
    family = harness.family(cfg)
    program = train.Program(cfg, m, family, seed, tiny.CPU)
    got = program.first_steps(m["check_steps"], late="late_grad_gap" in lim)
    program.free()
    ref = train.reference_outputs(cfg, m, family, seed, tiny.CPU, m["check_steps"])
    correct, checks, where = compare.compare(got, ref, lim)
    assert correct, (checks, where)


def test_wire_format_matches_the_ports_quantizer():
    from bluefog_tpu_torch.collective import kernels

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 512 * 40, generator=gen) * torch.rand(8, 512 * 40, generator=gen)
    payload, scales = kernels.encode(x.clone(), "int8")
    port = kernels.dequantize(payload, scales).reshape(8, -1)
    mine = wire.dequantized_int8(x)
    # the port multiplies by f32(1/127) where the format divides by 127: a
    # block's scale may differ in its last bit (127 lanes of it at most),
    # a lane never (that would be a whole step, amax / 127)
    amax = x.abs().reshape(8, -1, 512).amax(-1, keepdim=True)
    assert torch.all((port - mine).abs().reshape(8, -1, 512) <= amax * 2**-22)


def test_combine_is_the_difference_form():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(8, 1024, generator=gen)
    src = wire.exponential_sources(8)
    y = x.clone()
    wire.combine_int8_(y, src, columns=512)
    xh = wire.dequantized_int8(x)
    want = x + sum((xh[s] - xh) for s in src) / 4
    assert torch.allclose(y, want, atol=1e-6)
    # exact consensus is a fixed point
    c = x[:1].repeat(8, 1)
    d = c.clone()
    wire.combine_int8_(d, src)
    assert torch.equal(c, d)


def test_layout_orders_leaves_as_jax_does():
    table = [type("P", (), {"name": n, "shape": s})() for n, s in
             (("Block_10.kernel", (3, 2)), ("Block_2.kernel", (1, 1, 2, 2)), ("a.bias", (2,)))]
    slots, width = wire.layout(table)
    assert [s.name for s in slots] == ["Block_10.kernel", "Block_2.kernel", "a.bias"]
    assert [s.kind for s in slots] == ["dense", "conv", "same"] and width == 512
    row = torch.arange(512, dtype=torch.float32)
    assert wire.leaf(row, slots[0]).shape == (3, 2)
    assert torch.equal(wire.leaf(row, slots[0]), torch.arange(6.0).view(2, 3).t())
