"""The comparison that decides ``correct`` for a training cell.

The numbers that a cell's limits file (``limits/<cell>.json``) names,
each against its limit there (the file also names the statistic each leaf
number takes, under ``over``):

- ``loss_gap``: the largest relative gap of a worker's loss at one of the
  first steps, ``|program - reference| / |reference|``;
- ``grad_gap``: the first gradient, the optimizer's momentum after one
  step;
- ``change_gap``: each leaf's change over the first steps;
- ``late_grad_gap``: the gradient at the last of the first steps, over
  the leaves that the first gradient leaves out (a ResNet's residual
  branches, whose first gradient is 0 through a zero BatchNorm scale);
  the program's is its momentum less ``momentum`` times the one before.

A leaf number compares norms, never the norm of a difference. ``worst``:
leaf by leaf and worker by worker, the gap between the program's norm and
the reference's over the reference's norm of that leaf or of the worker's
median leaf, whichever is larger; the largest such gap. ``median``: the
same gaps, each leaf at its worst worker, at the median leaf: where small
leaves move mostly by rounding (the int8 wire's, which differs between
any two runs; BatchNorm's cancelling sums in bf16), the worst leaf is
noise and the median is steady. ``whole``: the gap of the whole model's
norm, at the worst worker.

A leaf is left out of the first-gradient numbers where its reference
gradient is under a thousandth of the median leaf's (the median over the
leaves with any gradient), and out of the change where its largest
reference gradient over the steps is: it then moves by round-off alone.
The late gradient applies the same rule among its own leaves.
"""

import math
from typing import Dict, List, Optional, Tuple

import torch

CHECKS = ("loss_gap", "grad_gap", "change_gap", "late_grad_gap")
# (number, the sides' key, the reference's gradient that picks the leaves)
LEAF_NUMBERS = (("grad_gap", "grad", "grad"), ("change_gap", "change", "grad_max"),
                ("late_grad_gap", "late_grad", "late_grad"))
NEGLIGIBLE = 1e-3  # of the worker's median leaf gradient


def slot_norms(rows: torch.Tensor, slots, minus: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """``{leaf: [N] float64 on the host}``: each leaf's norm in every
    worker row of ``rows [N, width]`` (of ``rows - minus`` when a row
    ``minus`` is given); a slot has ``name``, ``offset`` and ``numel``."""
    out = {}
    for s in slots:
        seg = rows[:, s.offset:s.offset + s.numel]
        if minus is not None:
            seg = seg - minus[s.offset:s.offset + s.numel]
        out[s.name] = torch.linalg.vector_norm(seg, dim=1).to("cpu", torch.float64)
    return out


def _stack(norms: Dict[str, torch.Tensor], names) -> torch.Tensor:
    return torch.stack([norms[k] for k in names], dim=1)  # [N, S]


def silent_at_first(first_grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose first reference gradient is under the rule's
    thousandth of the median leaf's in every worker."""
    names = sorted(first_grad)
    g = _stack(first_grad, names)
    silent = torch.ones(len(names), dtype=torch.bool)
    for j in range(g.shape[0]):
        moved = g[j] > 0
        if moved.any():
            silent &= g[j] < NEGLIGIBLE * g[j][moved].median()
    return [k for k, s in zip(names, silent.tolist()) if s]


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              ref_grad: Dict[str, torch.Tensor], among: Optional[List[str]] = None):
    """``(gaps [N, S], kept [N, S], leaf names)``: each leaf's gap in each
    worker, 0 where the leaf is left out, inf where the program's norm is
    not finite (the names of both sides must agree); over the leaves
    ``among`` where given, else over all."""
    names = sorted(reference) if among is None else sorted(among)
    p, r, g = _stack(program, names), _stack(reference, names), _stack(ref_grad, names)
    kept = torch.zeros_like(g, dtype=torch.bool)
    base = torch.ones_like(r)
    for j in range(g.shape[0]):
        moved = g[j] > 0
        if moved.any():
            kept[j] = g[j] >= NEGLIGIBLE * g[j][moved].median()
        if kept[j].any():
            base[j] = torch.clamp(r[j], min=float(r[j][kept[j]].median()))
    gap = ((p - r).abs() / base).masked_fill(~kept, 0.0)
    return torch.where(torch.isfinite(p), gap, torch.full_like(gap, math.inf)), kept, names


def _same_leaves(program, reference) -> str:
    if sorted(program) != sorted(reference):
        return f"leaves differ: {sorted(set(reference) ^ set(program))[:4]}"
    return ""


def leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
             ref_grad: Dict[str, torch.Tensor], among: Optional[List[str]] = None
             ) -> Tuple[float, str]:
    """``(largest gap, "leaf/worker")`` of one leaf-norm comparison."""
    differ = _same_leaves(program, reference)
    if differ:
        return math.inf, differ
    gap, _kept, names = leaf_gaps(program, reference, ref_grad, among)
    worst = int(torch.argmax(gap))
    j, s = divmod(worst, len(names))
    return float(gap.view(-1)[worst]), f"{names[s]}/worker {j}"


def median_leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
                    ref_grad: Dict[str, torch.Tensor], among: Optional[List[str]] = None
                    ) -> Tuple[float, str]:
    """``(gap, "leaf")`` of the median leaf, each leaf at its worst worker,
    over the leaves kept in some worker."""
    differ = _same_leaves(program, reference)
    if differ:
        return math.inf, differ
    gap, kept, names = leaf_gaps(program, reference, ref_grad, among)
    idx = torch.nonzero(kept.any(dim=0)).view(-1)
    if not len(idx):
        return math.inf, "no leaf moved"
    worst = gap[:, idx].max(dim=0).values
    order = torch.argsort(worst)
    mid = int(order[(len(order) - 1) // 2])
    return float(worst[mid]), names[int(idx[mid])]


def whole_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              ref_grad: Dict[str, torch.Tensor], among: Optional[List[str]] = None
              ) -> Tuple[float, str]:
    """``(gap, "worker j")`` of the whole model's norm (of the leaves
    ``among`` where given) at the worst worker."""
    differ = _same_leaves(program, reference)
    if differ:
        return math.inf, differ
    names = sorted(reference) if among is None else sorted(among)
    p = torch.linalg.vector_norm(_stack(program, names), dim=1)
    r = torch.linalg.vector_norm(_stack(reference, names), dim=1)
    gap = (p - r).abs() / r
    gap = torch.where(torch.isfinite(p), gap, torch.full_like(gap, math.inf))
    j = int(torch.argmax(gap))
    return float(gap[j]), f"worker {j}"


STATISTICS = {"worst": leaf_gap, "median": median_leaf_gap, "whole": whole_gap}


def leaf_number(key: str, over: str, program: Dict[str, object], reference: Dict[str, object]
                ) -> Tuple[float, str]:
    """One leaf number of :data:`LEAF_NUMBERS` under the statistic ``over``."""
    side, rule = next((s, r) for k, s, r in LEAF_NUMBERS if k == key)
    among = silent_at_first(reference["grad"]) if key == "late_grad_gap" else None
    if among == []:
        return math.inf, "no leaf is silent at first"
    return STATISTICS[over](program[side], reference[side], reference[rule], among)


def checks_of(limits: Dict[str, dict]) -> List[str]:
    """The numbers a cell's limits hold, in :data:`CHECKS`' order."""
    unknown = set(limits) - set(CHECKS) - {"readings"}
    if unknown:
        raise ValueError(f"the limits name numbers the comparison has not: {sorted(unknown)}")
    return [k for k in CHECKS if k in limits]


def compare(program: Dict[str, object], reference: Dict[str, object],
            limits: Dict[str, dict]) -> Tuple[bool, Dict[str, Dict[str, float]], Dict[str, str]]:
    """``(correct, {check: {"value", "limit"}}, {check: where})`` over the
    numbers that ``limits`` names."""
    lp, lr = program["losses"], reference["losses"]
    loss = (lp - lr).abs() / lr.abs()
    loss = torch.where(torch.isfinite(lp), loss, torch.full_like(loss, math.inf))
    worst = int(torch.argmax(loss))
    values = {"loss_gap": (float(loss.view(-1)[worst]),
                           f"step {worst // lr.shape[1]}/worker {worst % lr.shape[1]}")}
    wanted = checks_of(limits)
    for key in [k for k in wanted if k != "loss_gap"]:
        over = limits[key]["over"]
        value, where = leaf_number(key, over, program, reference)
        values[key] = (value, f"{over}: {where}")
    checks = {k: {"value": values[k][0], "limit": float(limits[k]["limit"])} for k in wanted}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks, {k: values[k][1] for k in wanted}
