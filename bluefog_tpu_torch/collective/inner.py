# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Weighted combines over the stacked worker axis.

Counterpart of ``bluefog_tpu/collective/inner.py``. There every function
runs inside ``shard_map`` on one worker's block and a round is a
``lax.ppermute``; here ``x`` is the whole ``[N, ...]`` worker tensor and a
round is a gather along the leading axis: row ``j`` of round ``r`` is
``x[src[r, j]]``, or zeros when ``src[r, j] == -1`` (what ``ppermute``
delivers to a non-destination, whose weight is 0). The arithmetic follows
the JAX functions op for op, so the stacked results equal the mesh
results slot for slot.
"""

import weakref
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from bluefog_tpu_torch.collective import kernels
from bluefog_tpu_torch.collective.plan import CommPlan, SchedulePlan

__all__ = [
    "weighted_combine",
    "weighted_combine_operands",
    "weighted_combine_quantized",
    "weighted_combine_quantized_operands",
    "weighted_combine_quantized_ef_operands",
    "ef_state_zeros",
    "neighbor_allreduce",
    "neighbor_allreduce_step",
    "hierarchical_neighbor_allreduce",
    "hierarchical_neighbor_allreduce_operands",
    "hierarchical_neighbor_allreduce_step",
    "hierarchical_neighbor_allreduce_quantized",
    "neighbor_allgather",
    "allreduce",
    "allgather",
    "broadcast",
    "pair_gossip",
    "barrier",
    "plan_operands",
    "schedule_operands",
]


def _weight_dtype(x: torch.Tensor) -> torch.dtype:
    """Float inputs combine in their own dtype; integers in float32."""
    return x.dtype if x.is_floating_point() else torch.float32


def plan_operands(plan: CommPlan, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(src [R, N] int32, self_w [N] f32, recv_w [R, N] f32)`` of a plan,
    on ``device``."""
    self_w, recv_w = plan.weight_operands()
    return (
        torch.from_numpy(np.array(plan.sources())).to(device),
        torch.from_numpy(self_w).to(device),
        torch.from_numpy(recv_w).to(device),
    )


def _gather(x: torch.Tensor, src_r: torch.Tensor) -> torch.Tensor:
    """One round of the stacked ``ppermute``: row ``j`` is
    ``x[src_r[j]]``, zeros where ``src_r[j] < 0``."""
    idx = src_r.to(torch.long)
    got = x.index_select(0, idx.clamp(min=0))
    has = (idx >= 0).view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(has, got, torch.zeros((), dtype=x.dtype, device=x.device))


def _col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-worker vector ``[N]`` shaped to broadcast against ``like``."""
    return v.to(like.dtype).view((-1,) + (1,) * (like.dim() - 1))


def weighted_combine_operands(
    x: torch.Tensor, src: torch.Tensor, self_w: torch.Tensor, recv_w: torch.Tensor
) -> torch.Tensor:
    """``y_j = self_w[j] * x_j + sum_r recv_w[r, j] * x_{src[r, j]}``, the
    weights as runtime operands."""
    xw = x.to(_weight_dtype(x))
    y = xw * _col(self_w, xw)
    for r in range(src.shape[0]):
        y = y + _gather(xw, src[r]) * _col(recv_w[r], xw)
    return y


def weighted_combine(x: torch.Tensor, plan: CommPlan) -> torch.Tensor:
    """:func:`weighted_combine_operands` with the plan's weights."""
    return weighted_combine_operands(x, *plan_operands(plan, x.device))


def neighbor_allreduce(x: torch.Tensor, plan: CommPlan) -> torch.Tensor:
    """Weighted neighbor averaging over a static plan."""
    return weighted_combine(x, plan)


# {schedule: {device: stacked operands on it}}, dropped with the schedule
_SCHEDULE_OPERANDS: "weakref.WeakKeyDictionary[SchedulePlan, dict]" = weakref.WeakKeyDictionary()


def schedule_operands(schedule: SchedulePlan, device):
    """``(src [period, R, N] int32, self_w [period, N] f32, recv_w [period,
    R, N] f32)`` of a schedule (:attr:`SchedulePlan.stacked_operands`) on
    ``device``, moved there once per schedule and device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cache = _SCHEDULE_OPERANDS.setdefault(schedule, {})
    if device not in cache:
        cache[device] = tuple(torch.from_numpy(np.array(a)).to(device)
                              for a in schedule.stacked_operands)
    return cache[device]


def neighbor_allreduce_step(x: torch.Tensor, step, schedule: SchedulePlan) -> torch.Tensor:
    """Dynamic-topology neighbor averaging selected by the step index
    (``lax.switch`` over the period in the JAX function): the period's
    operands are stacked on the device once (:func:`schedule_operands`) and
    indexed with ``step % period``, so a changing peer set rebuilds nothing
    and ``step`` (an int or an integer tensor on ``x``'s device) is never
    read back to the host. Rounds a step does not use have sender -1 and
    weight 0."""
    idx = torch.as_tensor(step, device=x.device).reshape(1).long() % schedule.period
    src, self_w, recv_w = (a.index_select(0, idx)[0]
                           for a in schedule_operands(schedule, x.device))
    return weighted_combine_operands(x, src, self_w, recv_w)


def _hierarchical(x: torch.Tensor, local_size: int, combine) -> torch.Tensor:
    """Sum over each machine's ``local_size`` workers (worker ``m * local +
    l``, the JAX mesh ``(machines, local)`` in row-major order), combine the
    ``[machines, ...]`` sums, divide by ``local_size`` and give every local
    slot its machine's result."""
    if local_size < 1 or x.shape[0] % local_size:
        raise ValueError(f"{x.shape[0]} workers do not split into machines of {local_size}")
    local_sum = x.reshape((x.shape[0] // local_size, local_size) + tuple(x.shape[1:])).sum(1)
    combined = combine(local_sum) / local_size
    return combined.unsqueeze(1).expand(
        (combined.shape[0], local_size) + tuple(combined.shape[1:])
    ).reshape((x.shape[0],) + tuple(combined.shape[1:]))


def hierarchical_neighbor_allreduce(
    x: torch.Tensor, machine_plan: CommPlan, local_size: int
) -> torch.Tensor:
    """Machine-level gossip: the local sum over each machine's workers (the
    JAX ``psum`` over the local axis), the machine plan's combine over the
    machines, divided by ``local_size``, broadcast back to every local slot."""
    return _hierarchical(x, local_size, lambda y: weighted_combine(y, machine_plan))


def hierarchical_neighbor_allreduce_operands(
    x: torch.Tensor, src: torch.Tensor, self_w: torch.Tensor, recv_w: torch.Tensor,
    local_size: int,
) -> torch.Tensor:
    """:func:`hierarchical_neighbor_allreduce` with the machine-level
    weights as runtime operands (see :func:`weighted_combine_operands`)."""
    return _hierarchical(x, local_size,
                         lambda y: weighted_combine_operands(y, src, self_w, recv_w))


def hierarchical_neighbor_allreduce_step(
    x: torch.Tensor, step, machine_schedule: SchedulePlan, local_size: int
) -> torch.Tensor:
    """Dynamic machine-topology variant (one-peer Exp2 at machine level,
    :func:`bluefog_tpu_torch.topology.GetExp2DynamicSendRecvMachineRanks`)."""
    return _hierarchical(x, local_size,
                         lambda y: neighbor_allreduce_step(y, step, machine_schedule))


def hierarchical_neighbor_allreduce_quantized(
    x: torch.Tensor, src: torch.Tensor, recv_w: torch.Tensor, local_size: int,
    wire: str = "int8",
) -> torch.Tensor:
    """:func:`hierarchical_neighbor_allreduce` with the machine-level leg
    on the quantized wire (``"bf16"``, ``"int8"`` or ``"int4"``): the local
    sum stays exact, the ``[machines, ...]`` sums go through
    :func:`weighted_combine_quantized_operands` (on the integer wires
    ``encode`` + ``decode_accumulate`` on the card). ``src``/``recv_w``
    are the machine plan's (:func:`plan_operands`), normalized."""
    return _hierarchical(x, local_size, lambda y: weighted_combine_quantized_operands(
        y, src, recv_w, wire=wire, inplace=True))


# -- the classic collectives ----------------------------------------------------------


def allreduce(x: torch.Tensor, average: bool = True) -> torch.Tensor:
    """Every worker's slot becomes the sum over the workers, or with
    ``average`` the mean in :func:`_weight_dtype`, divided by the static
    worker count (the JAX ``psum`` of a literal)."""
    if not average:
        total = x.sum(0, keepdim=True, dtype=x.dtype)
    else:
        wdt = _weight_dtype(x)
        total = x.to(wdt).sum(0, keepdim=True) / torch.tensor(x.shape[0], dtype=wdt)
    return total.expand(x.shape).clone()


def allgather(x: torch.Tensor) -> torch.Tensor:
    """``[N, d0, ...]`` -> ``[N, N * d0, ...]``: every worker's copy of the
    concatenation of all workers' slots along their first axis (a scalar
    slot per worker gives ``[N, N]``)."""
    n = x.shape[0]
    flat = x.reshape((1, -1) + tuple(x.shape[2:]))
    return flat.expand((n,) + tuple(flat.shape[1:])).clone()


def broadcast(x: torch.Tensor, root_rank: int) -> torch.Tensor:
    """Every worker's slot becomes worker ``root_rank``'s."""
    if not 0 <= root_rank < x.shape[0]:
        raise ValueError(f"root_rank {root_rank} out of range for {x.shape[0]} workers")
    return x[root_rank:root_rank + 1].expand(x.shape).clone()


def pair_gossip(
    x: torch.Tensor,
    pairs: Sequence[Tuple[int, int]],
    self_weight: Optional[float] = None,
    pair_weight: Optional[float] = None,
) -> torch.Tensor:
    """Each pair ``(a, b)`` averages with its partner, ``self_weight * x +
    pair_weight * x_partner`` (default 1/2 each), in :func:`_weight_dtype`
    with the weights in that dtype; ranks outside every pair keep their
    value, in that dtype."""
    n = x.shape[0]
    partner = [-1] * n
    for a, b in pairs:
        if a == b:
            raise ValueError("pair_gossip partner must differ from self")
        if partner[a] >= 0 or partner[b] >= 0:
            raise ValueError("pair_gossip: each rank may appear in at most one pair")
        partner[a], partner[b] = b, a
    wdt = _weight_dtype(x)
    xw = x.to(wdt)
    src = torch.tensor(partner, dtype=torch.int32, device=x.device)
    sw = torch.tensor(0.5 if self_weight is None else self_weight, dtype=wdt, device=x.device)
    pw = torch.tensor(0.5 if pair_weight is None else pair_weight, dtype=wdt, device=x.device)
    gossiped = xw * sw + _gather(xw, src) * pw
    paired = (src >= 0).view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(paired, gossiped, xw)


def barrier(device) -> None:
    """Wait until the device has finished all work queued so far."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def neighbor_allgather(
    x: torch.Tensor, plan: CommPlan, wire: Optional[str] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw (unweighted) in-neighbour values, rank-ascending:
    ``(gathered [N, max_in_degree, ...], mask [N, max_in_degree] bool)``,
    row ``k`` of worker ``j`` the value of its ``k``-th in-neighbour, zeros
    past its in-degree (the JAX layout, with the worker axis in front).

    ``wire`` ships the values as ``'bf16'``, or block-quantized as
    ``'int8'``/``'int4'``: one :func:`kernels.encode` of every worker's
    flat f32 payload, then one :func:`kernels.decode` per neighbour slot
    of the senders' rows, cast back to ``x.dtype`` — receivers get
    ``dequant(Q(x))``, as in the JAX function. Float payloads only."""
    if wire not in (None, "bf16", "int8", "int4"):
        raise ValueError(
            "neighbor_allgather wire must be None, 'bf16', 'int8', or "
            f"'int4', got {wire!r}"
        )
    if wire is not None and not x.is_floating_point():
        raise ValueError(f"quantized neighbor_allgather needs a float payload, got {x.dtype}")
    n_workers = x.shape[0]
    ins = plan.in_neighbors
    degree = plan.max_in_degree
    src = np.full((degree, n_workers), -1, np.int32)
    for j, nbrs in enumerate(ins):
        src[:len(nbrs), j] = nbrs
    mask = torch.from_numpy(src.T >= 0).to(x.device)
    src_t = torch.from_numpy(src).to(x.device)
    if degree == 0:
        return x.new_zeros((n_workers, 0) + tuple(x.shape[1:])), mask
    if wire in ("int8", "int4"):
        flat = x.reshape(n_workers, -1).to(torch.float32)
        n = flat.shape[1]
        payload, scales = kernels.encode(kernels.pad_blocks(flat), wire)
        rows = [
            kernels.unpad_blocks(
                kernels.decode(payload, scales, src_t[k], wire, src_in_range=True), n
            ).reshape(x.shape).to(x.dtype)
            for k in range(degree)
        ]
    else:
        sent = x if wire is None else x.to(torch.bfloat16)
        rows = [_gather(sent, src_t[k]).to(x.dtype) for k in range(degree)]
    return torch.stack(rows, dim=1), mask


def _check_combine_normalized(plan: CommPlan, what: str) -> None:
    """The difference-form quantized combine equals the exact combine
    only when each receiver's weights sum to 1; refuse otherwise (the
    error would be O(x) and silent)."""
    col_sums = plan.weight_matrix().sum(axis=0)
    if not np.allclose(col_sums, 1.0, atol=1e-6):
        bad = int(np.argmax(np.abs(col_sums - 1.0)))
        raise ValueError(
            f"{what} requires a normalized combine (receiver weights "
            f"summing to 1); rank {bad} sums to {col_sums[bad]:.6f}. "
            "Push-sum/column-stochastic plans are not supported."
        )


def _chunk_quantize(xf: torch.Tensor):
    """Stacked int8 block quantization of ``[N, n]`` f32: ``(q [N, C,
    512] int8, s [N, C] f32, xhat [N, n])`` (``inner._chunk_quantize``
    per worker)."""
    q, s = kernels.encode_reference(kernels.pad_blocks(xf), "int8")
    return q, s, _dequant8(q, s, xf.shape[1])


def _chunk_quantize4(xf: torch.Tensor):
    """Stacked int4 block quantization: ``(packed [N, C, 256], s16 [N, C]
    bf16, xhat [N, n])`` (``inner._chunk_quantize4`` per worker)."""
    p, s16 = kernels.encode_reference(kernels.pad_blocks(xf), "int4")
    return p, s16, _dequant4(p, s16, xf.shape[1])


def _dequant8(q: torch.Tensor, s: torch.Tensor, n: int) -> torch.Tensor:
    return kernels.unpad_blocks(kernels.dequantize(q, s), n)


def _dequant4(packed: torch.Tensor, s16: torch.Tensor, n: int) -> torch.Tensor:
    return kernels.unpad_blocks(kernels.dequantize(packed, s16), n)


def weighted_combine_quantized_operands(
    x: torch.Tensor,
    src: torch.Tensor,
    recv_w: torch.Tensor,
    wire: str = "int8",
    inplace: bool = False,
) -> torch.Tensor:
    """Quantized-wire combine in the difference form
    ``y = x + sum_r w_r (x_hat_r - x_hat_self)`` (exact consensus is a
    fixed point), in :func:`_weight_dtype` — the monolithic branches of the
    JAX function:

    - ``"bf16"``: every worker ships ``x`` rounded to bf16; each round adds
      ``((recv - x_hat) * w_r)`` computed in f32 and cast to the weight
      dtype, rounds in plan order. Data movement and elementwise
      arithmetic, as JAX computes it outside any kernel.
    - ``"int8"``/``"int4"`` on a float32 (or integer) ``x``: one
      :func:`kernels.encode` of every worker's flat payload, then one
      :func:`kernels.decode_accumulate` with all rounds folded in. With
      ``inplace=True`` and a contiguous f32 ``x`` whose per-worker size is
      a multiple of 512, ``x`` itself is the accumulator and is
      overwritten; otherwise a padded copy is.
    - ``"int8"``/``"int4"`` on a bf16 or f16 ``x``: the payload is encoded
      from ``x`` cast to f32 (:func:`kernels.encode`), each round's payload
      and the sender's own are decoded to f32 (:func:`kernels.decode`) and
      cast to the weight dtype, and the rounds are added in it, as the JAX
      composite branch does (the f32 accumulator of ``decode_accumulate``
      would round differently).

    A float64 ``x`` is refused: the JAX package holds no float64."""
    if wire not in ("int8", "bf16", "int4"):
        raise ValueError(
            f"wire must be 'int8', 'bf16', or 'int4', got {wire!r}"
        )
    wdt = _weight_dtype(x)
    if wdt == torch.float64:
        raise ValueError(
            "the quantized wire combines float32, bfloat16 or float16 "
            f"payloads (integers in float32), got {x.dtype}"
        )
    if wire == "bf16":
        xw = x.to(wdt)
        q16 = xw.to(torch.bfloat16)
        xhat = q16.to(torch.float32)
        y = xw
        for r in range(src.shape[0]):
            recv = _gather(q16, src[r]).to(torch.float32)
            y = y + ((recv - xhat) * _col(recv_w[r], recv)).to(wdt)
        return y
    n_workers = x.shape[0]
    if wdt != torch.float32:
        xw = x.to(wdt)
        flat = xw.to(torch.float32).reshape(n_workers, -1)
        n = flat.shape[1]
        payload, scales = kernels.encode(kernels.pad_blocks(flat).contiguous(), wire)

        def full(src_r):
            out = kernels.decode(payload, scales, src_r, wire, src_in_range=True)
            return kernels.unpad_blocks(out, n).reshape(x.shape).to(wdt)

        xhat = full(None)
        y = xw
        for r in range(src.shape[0]):
            y = y + (full(src[r]) - xhat) * _col(recv_w[r], xhat)
        return y
    if x.dtype != torch.float32:  # an integer payload combines in f32
        x, inplace = x.to(torch.float32), False
    flat = x.reshape(n_workers, -1)
    n = flat.shape[1]
    aligned = n % kernels.CHUNK == 0 and flat.is_contiguous()
    if inplace and aligned and flat.data_ptr() == x.data_ptr():
        acc = flat
    else:
        acc = kernels.pad_blocks(flat)
        if acc is flat:
            acc = flat.clone()
    payload, scales = kernels.encode(acc, wire)
    kernels.decode_accumulate(acc, payload, scales, src, recv_w, wire)
    if acc is flat:
        return x
    return kernels.unpad_blocks(acc, n).reshape(x.shape)


def weighted_combine_quantized(
    x: torch.Tensor, plan: CommPlan, wire: str = "int8"
) -> torch.Tensor:
    """:func:`weighted_combine_quantized_operands` with the plan's
    weights; validates that the plan is normalized."""
    _check_combine_normalized(plan, f"compression={wire!r}")
    src, _self_w, recv_w = plan_operands(plan, x.device)
    return weighted_combine_quantized_operands(x, src, recv_w, wire=wire)


def ef_state_zeros(n_workers: int, n: int, n_rounds: int, device):
    """Fresh CHOCO copies for an ``[N, n]`` payload on ``n_rounds``
    rounds: ``(xhat_self [N, d], xhat_recv [R, N, d])`` f32 zeros, with
    ``d`` = ``n`` padded to whole 512-element blocks (the padded tail
    stays zero)."""
    d = -(-n // kernels.CHUNK) * kernels.CHUNK
    return (
        torch.zeros((n_workers, d), dtype=torch.float32, device=device),
        torch.zeros((n_rounds, n_workers, d), dtype=torch.float32, device=device),
    )


def weighted_combine_quantized_ef_operands(
    x: torch.Tensor,
    state: Tuple[torch.Tensor, torch.Tensor],
    src: torch.Tensor,
    recv_w: torch.Tensor,
    wire: str = "int8",
    inplace: bool = False,
) -> torch.Tensor:
    """Quantized wire with memory (CHOCO-style difference compression),
    the monolithic branch of the JAX function: every worker keeps a
    public copy ``xhat_self`` of itself and integrated copies
    ``xhat_recv[r]`` of its round-``r`` source, ships ``q = Q(x -
    xhat_self)``, and sender and receivers add the same dequantized
    update to their copies, so the copies stay bit-identical
    (``xhat_recv[r][j] == xhat_self[src[r, j]]``). The combine uses the
    copies: ``y = x + sum_r w_r (xhat_recv[r] - xhat_self)``.

    ``state = (xhat_self [N, d], xhat_recv [R, N, d])`` f32 (see
    :func:`ef_state_zeros`) is updated in place — the JAX function
    returns a new state; here each round's copy is one contiguous
    ``[N, d]`` slab. Step 1 is one :func:`kernels.encode_diff`, step 2
    one :func:`kernels.decode_add` per round, step 3 the accumulate in
    plain torch, round by round, as JAX computes it outside any kernel.

    ``src [R, N]`` is a compiled plan's (:func:`plan_operands`): its
    ranks are in range by construction. ``x`` must be float32 ``[N,
    ...]`` with ``n`` elements per worker;
    with ``inplace=True`` and a contiguous, block-aligned ``x`` the result
    overwrites ``x``. The combine is always monolithic: the JAX
    function's chunked wavefront (``chunks``) does not apply on one card,
    so there is no such argument."""
    kernels._check_wire(wire)
    if x.dtype != torch.float32:
        raise ValueError(
            f"the quantized wire combines float32 payloads, got {x.dtype}"
        )
    xhat_self, xhat_recv = state
    n_workers = x.shape[0]
    flat = x.reshape(n_workers, -1)
    n = flat.shape[1]
    d = -(-n // kernels.CHUNK) * kernels.CHUNK
    if (tuple(xhat_self.shape) != (n_workers, d)
            or tuple(xhat_recv.shape) != (src.shape[0], n_workers, d)):
        raise ValueError(
            f"error-feedback state {tuple(xhat_self.shape)} / "
            f"{tuple(xhat_recv.shape)} does not fit x {tuple(x.shape)} on "
            f"{src.shape[0]} rounds"
        )
    aligned = n % kernels.CHUNK == 0 and flat.is_contiguous()
    if inplace and aligned and flat.data_ptr() == x.data_ptr():
        y = flat
    else:
        y = kernels.pad_blocks(flat)
        if y is flat:
            y = flat.clone()
    payload, scales = kernels.encode_diff(y, xhat_self, wire)
    diff = torch.empty_like(y)
    for r in range(src.shape[0]):
        hat_r = kernels.decode_add(xhat_recv[r], payload, scales, src[r], wire,
                                   src_in_range=True)
        torch.sub(hat_r, xhat_self, out=diff)
        y.add_(diff.mul_(_col(recv_w[r], diff)))
    if y is flat:
        return x
    return kernels.unpad_blocks(y, n).reshape(x.shape)
