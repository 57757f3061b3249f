# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Flash attention: the forward and the FlashAttention-2 backward.

Counterpart of ``bluefog_tpu/ops/flash.py`` on ``[batch, seq, heads,
head_dim]`` tensors. Three functions have hand-written CUDA kernels for
Hopper (built at first use by :mod:`bluefog_tpu_torch._build`) and a plain
PyTorch version beside them:

- :func:`flash_fwd` (replaces ``_fwd_call``): ``out`` and the per-row
  logsumexp ``lse [b, h, t]`` f32;
- :func:`flash_bwd_dkv` (replaces the dK/dV ``pallas_call`` of
  ``_bwd_call``): dK and dV, summed over each KV head's query group;
- :func:`flash_bwd_dq` (replaces the dQ ``pallas_call`` of ``_bwd_call``);

and one of its own, :func:`split_cotangent`: an f32 cotangent (the lse
form's) as two bf16 halves ``hi = bf16(dO)``, ``lo = bf16(dO - hi)``, which
carry 16 of its 24 mantissa bits into the tensor cores of the ``sm90``
backward.

A CUDA tensor always takes a kernel; a CPU tensor takes the plain version;
anything else raises. :func:`_route` chooses the kernel before the launch,
from dtypes, head_dim, pointers, strides and the scale, never after a
failure:

- ``sm90`` (``csrc/flash_sm90.cu``, all three kernels): bf16 q/k/v,
  head_dim a multiple of 8 up to 128 (:data:`SM90_MAX_HEAD_DIM`), every
  operand's base and batch, sequence and head strides on 16 bytes (the
  Tensor Memory Accelerator's condition), scale > 0: wgmma fed by TMA, a
  producer and two consumer warpgroups. A bf16 cotangent is an operand
  like the others; an f32 cotangent (the lse form) is split once into its
  fresh, contiguous halves, so its own layout does not matter, and every
  product with it is a sum of bf16 products (``dP = hi V^T + lo V^T``,
  ``dV += P_hi^T hi + P_hi^T lo + P_lo^T hi``; P stays f32 to about
  2^-16);
- ``mma`` (``csrc/flash_kernels.cu``): the other bf16 calls with a bf16
  cotangent (rows off 16 bytes, head_dim 36 or above 128, a scale that is
  not positive, ...), ``mma.sync`` with ``cp.async`` or scalar loads;
- ``simt`` (``csrc/flash_kernels.cu``): f32 q/k/v, and the bf16 backward
  with an f32 cotangent that ``sm90`` does not take (head_dim above 128,
  rows off 16 bytes, scale <= 0), on the CUDA cores.

The kernels take head_dim up to :data:`MAX_HEAD_DIM` (256); a CUDA call
above it raises. The plain versions take any head_dim.

The plain versions compute what the kernels compute, with the same masks,
guards and roundings: scores in f32 from the inputs, masked to -inf,
probabilities from the f32 scores, rounded to V's dtype before ``P.V``
(forward), to dO's before ``P^T.dO`` and ``dS`` to Q's (K's) before
``dS^T.Q`` (``dS.K``) in the backward. Only the softmax differs in form:
the kernels run it online over key tiles, the plain version over the
whole row.

:func:`flash_attention` and :func:`flash_attention_with_lse` are
differentiable (``torch.autograd.Function``; the backward launches dK/dV
and dQ, after ``delta = rowsum(dO * O)`` in f32). Cross-attention shapes go
to the dense reference by shape (:func:`flash_attention_supported`, as in
the JAX package).
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from bluefog_tpu_torch.ops.attention import _expand_kv, causal_keep, reference_attention

__all__ = [
    "MAX_HEAD_DIM",
    "SM90_MAX_HEAD_DIM",
    "flash_attention",
    "flash_attention_with_lse",
    "flash_attention_supported",
    "flash_fwd",
    "flash_fwd_reference",
    "flash_bwd_dkv",
    "flash_bwd_dkv_reference",
    "flash_bwd_dq",
    "flash_bwd_dq_reference",
    "attention_delta",
    "split_cotangent",
    "split_cotangent_reference",
    "launch_counts",
    "split_launch_count",
    "route_counts",
    "reset_launch_counts",
    "ROUTES",
]

MAX_HEAD_DIM = 256  # the mma and simt kernels
SM90_MAX_HEAD_DIM = 128
_NEG_INF = float("-inf")


# -- plain versions --------------------------------------------------------------


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, scale: float) -> torch.Tensor:
    """f32 scores ``[b, h, tq, tk]`` times ``scale``, future keys masked to
    -inf when causal (the last query sees the last key)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand_kv(q, k).float()) * scale
    if causal:
        s = s.masked_fill(~causal_keep(s.shape[-2], s.shape[-1], s.device), _NEG_INF)
    return s


def flash_fwd_reference(q, k, v, causal: bool, scale: float,
                        out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_fwd`; also the dense path of
    :func:`flash_attention_with_lse` for cross-attention shapes."""
    out_dtype = q.dtype if out_dtype is None else out_dtype
    s = _scores(q, k, causal, scale)
    m = s.amax(-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = p.sum(-1)
    l_safe = torch.where(l > 0, l, 1.0)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), _expand_kv(q, v).float())
    out = (pv / l_safe.transpose(1, 2)[..., None]).to(out_dtype)
    lse = torch.where(l > 0, m + torch.log(l_safe), _NEG_INF)
    return out, lse


def _dense_with_lse(q, k, v, causal: bool, scale: float):
    """Dense ``(out f32, lse)`` for any shapes (the JAX package's oracle of
    the lse-carrying path)."""
    return flash_fwd_reference(q, k, v, causal, scale, torch.float32)


def _recompute(q, k, v, do, lse, delta, dlse, causal, scale):
    """``(P, dS)`` ``[b, h, tq, tk]`` f32 from Q, K and the saved lse
    (``_recompute_p``), with ``dS = P * ((dP - delta) + dlse) * scale``."""
    s = _scores(q, k, causal, scale)
    finite = torch.isfinite(lse)[..., None]
    p = torch.exp(s - torch.where(finite, lse[..., None], 0.0))
    p = torch.where(finite & torch.isfinite(s), p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _expand_kv(q, v).float())
    c = dp - delta[..., None]
    if dlse is not None:
        c = c + dlse[..., None]
    return p, p * c * scale


def _group_sum(x: torch.Tensor, h_kv: int) -> torch.Tensor:
    """``[b, t, h, d]`` per query head -> ``[b, t, h_kv, d]`` per KV head."""
    b, t, h, d = x.shape
    return x.reshape(b, t, h_kv, h // h_kv, d).sum(3)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, dlse, causal: bool,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_bwd_dkv`."""
    p, ds = _recompute(q, k, v, do, lse, delta, dlse, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    h_kv = k.shape[2]
    return _group_sum(dk, h_kv).to(k.dtype), _group_sum(dv, h_kv).to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, dlse, causal: bool,
                           scale: float) -> torch.Tensor:
    """Plain version of :func:`flash_bwd_dq`."""
    _p, ds = _recompute(q, k, v, do, lse, delta, dlse, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), _expand_kv(q, k).float())
    return dq.to(q.dtype)


def split_cotangent_reference(do: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`split_cotangent`: ``hi = bf16(dO)``, ``lo =
    bf16(dO - hi)``, contiguous."""
    hi = do.to(torch.bfloat16).contiguous()
    lo = (do - hi.float()).to(torch.bfloat16).contiguous()
    return hi, lo


# -- kernels -------------------------------------------------------------------

ROUTES = ("sm90", "mma", "simt")
_LAUNCHES = {k: dict.fromkeys(ROUTES, 0) for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
_SPLIT_LAUNCHES = {"flash_split_cotangent": 0}


def launch_counts() -> dict:
    """Kernel launches by kernel, over all routes, since the last
    :func:`reset_launch_counts` (the plain versions never count)."""
    return {k: sum(by_route.values()) for k, by_route in _LAUNCHES.items()}


def route_counts() -> dict:
    """Kernel launches by kernel and route (``{kernel: {route: n}}``)
    since the last :func:`reset_launch_counts`."""
    return {k: dict(by_route) for k, by_route in _LAUNCHES.items()}


def split_launch_count() -> int:
    """Launches of :func:`split_cotangent`'s kernel since the last
    :func:`reset_launch_counts`."""
    return _SPLIT_LAUNCHES["flash_split_cotangent"]


def reset_launch_counts() -> None:
    for by_route in _LAUNCHES.values():
        for r in by_route:
            by_route[r] = 0
    _SPLIT_LAUNCHES["flash_split_cotangent"] = 0


class _Args(ctypes.Structure):
    """``BfFlashArgs`` of ``csrc/flash_args.cuh``."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("q", "k", "v", "d_o", "d_o_lo", "out", "dq", "dk", "dv", "lse", "delta", "dlse")]
        + [(n, ctypes.c_longlong * 3) for n in
           ("q_stride", "k_stride", "v_stride", "do_stride")]
        + [(n, ctypes.c_int) for n in ("b", "t", "h", "h_kv", "d")]
        + [("scale", ctypes.c_float)]
        + [(n, ctypes.c_int) for n in ("causal", "qkv_bf16", "out_f32", "do_f32", "vec")]
    )


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


_MAP_ERRORS = {100000: "no cuTensorMapEncodeTiled in the driver",
               100001: "cuTensorMapEncodeTiled refused an operand's layout"}


def _raise_on_status(status: int, what: str) -> None:
    if status != 0:
        why = _MAP_ERRORS.get(status, f"cudaError {status}")
        raise RuntimeError(f"{what} kernel launch failed: {why}")


def _check_shapes(q, k, v) -> None:
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
             "q, k, v must be [batch, seq, heads, head_dim]")
    b, t, h, d = q.shape
    _require(tuple(k.shape) == tuple(v.shape) and k.shape[0] == b and k.shape[1] == t
             and k.shape[3] == d and h % k.shape[2] == 0,
             f"self-attention shapes only: q {tuple(q.shape)}, k {tuple(k.shape)}, "
             f"v {tuple(v.shape)}")


def _check_kernel_head_dim(d: int) -> None:
    _require(d <= MAX_HEAD_DIM, f"head_dim {d} is above the flash kernels' limit of "
                                f"{MAX_HEAD_DIM} (the plain versions on the CPU take it)")


def _dispatch_device(*tensors) -> str:
    dev = tensors[0].device
    _require(dev.type in ("cuda", "cpu"), f"flash kernels run on cuda or cpu, got {dev}")
    for t in tensors:
        _require(t.device == dev, f"operands on {t.device} and {dev}")
    return dev.type


def _check_rows(t: torch.Tensor, name: str, dtypes) -> None:
    _require(t.dtype in dtypes, f"{name} must be one of {dtypes}, got {t.dtype}")
    _require(t.stride(3) == 1, f"{name} must have a contiguous last axis")


def _check_vector(t, name: str, shape) -> None:
    _require(tuple(t.shape) == shape, f"{name} must be {shape}, got {tuple(t.shape)}")
    _require(t.dtype == torch.float32 and t.is_contiguous(),
             f"{name} must be contiguous float32")


def _rows_aligned(tensors, d: int) -> bool:
    """True when every row of every operand starts on 16 bytes (the bf16
    route then stages tiles with 16-byte copies)."""
    if d % 8:
        return False
    return all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
               for t in tensors)


def _route(q, k, v, do=None, scale: float = 1.0) -> str:
    """The kernel a CUDA call of :func:`flash_fwd` (``do`` None),
    :func:`flash_bwd_dkv` or :func:`flash_bwd_dq` takes: ``"sm90"``,
    ``"mma"`` or ``"simt"`` (the module docstring states the rule; dK/dV
    and dQ take the same route). The tensor maps of ``sm90`` need
    16-byte aligned, positive strides; its softmax takes the row maximum
    before the scale, which needs ``scale > 0``. An f32 cotangent reaches
    ``sm90`` as fresh contiguous halves, so only a bf16 one must meet the
    layout conditions itself; ``mma`` takes no f32 cotangent."""
    if q.dtype == torch.float32:
        return "simt"
    split = do is not None and do.dtype == torch.float32
    operands = [q, k, v] + ([do] if do is not None and not split else [])
    if (q.dtype == torch.bfloat16 and q.shape[-1] <= SM90_MAX_HEAD_DIM and scale > 0
            and _rows_aligned(operands, q.shape[-1])
            and all(s > 0 for t in operands for s in t.stride()[:3])):
        return "sm90"
    return "simt" if split else "mma"


def _args(q, k, v, causal: bool, scale: float, **ptrs) -> _Args:
    b, t, h, d = q.shape
    a = _Args()
    a.q, a.k, a.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    for name, value in ptrs.items():
        setattr(a, name, None if value is None else value.data_ptr())
    for name, x in (("q_stride", q), ("k_stride", k), ("v_stride", v), ("do_stride", ptrs.get("d_o"))):
        if x is not None:
            getattr(a, name)[:] = list(x.stride()[:3])
    a.b, a.t, a.h, a.h_kv, a.d = b, t, h, k.shape[2], d
    a.scale = float(scale)
    a.causal = int(bool(causal))
    a.qkv_bf16 = int(q.dtype == torch.bfloat16)
    operands = [q, k, v] + ([ptrs["d_o"]] if ptrs.get("d_o") is not None else [])
    a.vec = int(_rows_aligned(operands, d))
    return a


def _launch(kernel: str, route: str, a: _Args, like: torch.Tensor) -> None:
    """Launches ``kernel`` by ``route`` on ``like``'s stream; raises on a
    refused launch; counts it."""
    from bluefog_tpu_torch import _build

    if route == "sm90":
        fn = getattr(_build.flash_sm90_library(), f"bf_{kernel}_sm90")
    else:
        fn = getattr(_build.flash_library(), f"bf_{kernel}")
    _raise_on_status(fn(ctypes.addressof(a), _stream(like)), f"{kernel} ({route})")
    _LAUNCHES[kernel][route] += 1


_FLOAT_TYPES = (torch.float32, torch.bfloat16)


def flash_fwd(q, k, v, causal: bool, scale: float,
              out_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention of ``q [b, t, h, d]`` over ``k``, ``v`` ``[b, t, h_kv,
    d]``: returns ``(out [b, t, h, d]`` in ``out_dtype`` (default q's;
    float32 allowed), ``lse [b, h, t]`` f32)``, ``lse = -inf`` for a row
    with no valid key (replaces ``_fwd_call``)."""
    _check_shapes(q, k, v)
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if _dispatch_device(q, k, v) == "cpu":
        return flash_fwd_reference(q, k, v, causal, scale, out_dtype)
    return _fwd_kernel(q, k, v, causal, scale, out_dtype, _route(q, k, v, scale=scale))


def _fwd_kernel(q, k, v, causal, scale, out_dtype, route):
    _check_kernel_head_dim(q.shape[-1])
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_rows(x, name, (q.dtype,) if name != "q" else _FLOAT_TYPES)
    _require(out_dtype in (q.dtype, torch.float32),
             f"out_dtype must be {q.dtype} or float32, got {out_dtype}")
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    a = _args(q, k, v, causal, scale, out=out, lse=lse)
    a.out_f32 = int(out_dtype == torch.float32)
    _launch("flash_fwd", route, a, q)
    return out, lse


def _check_backward(q, k, v, do, lse, delta, dlse) -> str:
    _check_shapes(q, k, v)
    b, t, h, _d = q.shape
    _require(tuple(do.shape) == tuple(q.shape),
             f"dO {tuple(do.shape)} does not match q {tuple(q.shape)}")
    extra = [x for x in (lse, delta, dlse) if x is not None]
    return _dispatch_device(q, k, v, do, *extra)


def _check_backward_cuda(q, k, v, do, lse, delta, dlse) -> None:
    b, t, h, d = q.shape
    _check_kernel_head_dim(d)
    _check_rows(q, "q", _FLOAT_TYPES)
    for name, x in (("k", k), ("v", v)):
        _check_rows(x, name, (q.dtype,))
    _check_rows(do, "dO", (q.dtype, torch.float32))
    for name, x in (("lse", lse), ("delta", delta), ("dlse", dlse)):
        if x is not None or name != "dlse":
            _check_vector(x, name, (b, h, t))


def _bwd_args(q, k, v, do, lse, delta, dlse, causal, scale, halves, **outs) -> _Args:
    """The argument block of a backward launch; ``halves`` is ``(hi,
    lo)`` of an f32 ``do`` on ``sm90`` (``d_o`` then points at ``hi``),
    else None."""
    if halves is not None:
        hi, lo = halves
        a = _args(q, k, v, causal, scale, d_o=hi, d_o_lo=lo, lse=lse, delta=delta, dlse=dlse,
                  **outs)
    else:
        a = _args(q, k, v, causal, scale, d_o=do, lse=lse, delta=delta, dlse=dlse, **outs)
        a.do_f32 = int(do.dtype == torch.float32)
    return a


def _halves(do, route: str):
    """``split_cotangent(do)`` where ``route`` takes an f32 cotangent as
    two bf16 halves (``sm90``), else None."""
    return split_cotangent(do) if route == "sm90" and do.dtype == torch.float32 else None


def flash_bwd_dkv(q, k, v, do, lse, delta, dlse, causal: bool,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK, dV (K's and V's shapes and dtypes) of attention ``q, k, v``
    with cotangent ``do`` (q's dtype or float32), saved ``lse``, ``delta
    = rowsum(dO * O)`` and the lse cotangent ``dlse`` (``[b, h, t]`` f32;
    ``dlse`` may be None: zero). A KV head's gradient sums its query
    group's (replaces the dK/dV kernel of ``_bwd_call``). On ``sm90`` an
    f32 ``do`` enters as its two bf16 halves (:func:`split_cotangent`);
    a ``delta`` from ``hi + lo`` then matches the dP the kernel forms, as
    the autograd backward's does."""
    if _check_backward(q, k, v, do, lse, delta, dlse) == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, dlse, causal, scale)
    return _dkv_kernel(q, k, v, do, lse, delta, dlse, causal, scale,
                       _route(q, k, v, do, scale))


def _dkv_kernel(q, k, v, do, lse, delta, dlse, causal, scale, route, halves=None):
    """dK/dV by ``route``; ``halves``: ``do``'s split when the caller made
    it already (else made here where the route needs it)."""
    _check_backward_cuda(q, k, v, do, lse, delta, dlse)
    if halves is None:
        halves = _halves(do, route)
    dk, dv = torch.empty(k.shape, dtype=k.dtype, device=k.device), \
        torch.empty(v.shape, dtype=v.dtype, device=v.device)
    a = _bwd_args(q, k, v, do, lse, delta, dlse, causal, scale, halves, dk=dk, dv=dv)
    _launch("flash_bwd_dkv", route, a, q)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, dlse, causal: bool,
                 scale: float) -> torch.Tensor:
    """dQ (q's shape and dtype), with the operands of
    :func:`flash_bwd_dkv` (replaces the dQ kernel of ``_bwd_call``)."""
    if _check_backward(q, k, v, do, lse, delta, dlse) == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, dlse, causal, scale)
    return _dq_kernel(q, k, v, do, lse, delta, dlse, causal, scale,
                      _route(q, k, v, do, scale))


def _dq_kernel(q, k, v, do, lse, delta, dlse, causal, scale, route, halves=None):
    """dQ by ``route``, ``halves`` as in :func:`_dkv_kernel`."""
    _check_backward_cuda(q, k, v, do, lse, delta, dlse)
    if halves is None:
        halves = _halves(do, route)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    a = _bwd_args(q, k, v, do, lse, delta, dlse, causal, scale, halves, dq=dq)
    _launch("flash_bwd_dq", route, a, q)
    return dq


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta [b, h, t] = rowsum(dO * O)`` in f32, from ``out`` in its
    own dtype (``_bwd_call``)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def split_cotangent(do: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An f32 cotangent ``[b, t, h, d]`` (any strides, last axis
    contiguous) as two contiguous bf16 tensors ``hi = bf16(dO)``, ``lo =
    bf16(dO - hi)``: ``dO - hi`` is exact in f32, so ``hi + lo`` is dO to a
    relative 2^-17. The kernel's bits are the plain version's."""
    _require(do.dim() == 4, "dO must be [batch, seq, heads, head_dim]")
    _check_rows(do, "dO", (torch.float32,))
    if _dispatch_device(do) == "cpu":
        return split_cotangent_reference(do)
    from bluefog_tpu_torch import _build

    b, t, h, d = do.shape
    hi = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=do.device)
    lo = torch.empty_like(hi)
    fn = _build.flash_sm90_library().bf_flash_split_cotangent
    _raise_on_status(fn(do.data_ptr(), hi.data_ptr(), lo.data_ptr(), *do.stride()[:3],
                        b, t, h, d, _stream(do)), "flash_split_cotangent")
    _SPLIT_LAUNCHES["flash_split_cotangent"] += 1
    return hi, lo


def _backward(ctx, do, dlse):
    q, k, v, out, lse = ctx.saved_tensors
    if do.stride(-1) != 1:
        do = do.contiguous()  # e.g. the expanded gradient of a sum
    if dlse is not None:
        dlse = dlse.float().contiguous()
    if _check_backward(q, k, v, do, lse, None, dlse) == "cpu":
        args = (q, k, v, do, lse, attention_delta(out, do), dlse, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv_reference(*args)
        return flash_bwd_dq_reference(*args), dk, dv, None, None
    route = _route(q, k, v, do, ctx.scale)
    halves = _halves(do, route)  # one split for both kernels
    # delta of the cotangent the kernels see (hi + lo where split), so that
    # dP - delta, which cancels in rows with few keys, is one cotangent's:
    # the gradient is then the f32 contract's for dO to 2^-17
    seen = do if halves is None else halves[0].float() + halves[1].float()
    args = (q, k, v, do, lse, attention_delta(out, seen), dlse, ctx.causal, ctx.scale)
    dk, dv = _dkv_kernel(*args, route, halves)
    dq = _dq_kernel(*args, route, halves)
    return dq, dk, dv, None, None


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` on self-attention shapes: out in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        return _backward(ctx, do, None)


class _FlashAttentionWithLse(torch.autograd.Function):
    """``flash_attention_with_lse``: f32 out and lse, differentiable in
    both (the lse cotangent joins dS as ``dlse_i * p_ij``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd(q, k, v, causal, scale, torch.float32)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        if do is None:
            do = torch.zeros_like(ctx.saved_tensors[3])
        return _backward(ctx, do, dlse)


def flash_attention_supported(q, k=None, v=None, *, block_q: int = 128,
                              block_k: int = 128) -> bool:
    """Kernel applicability: self-attention shapes only (one shared
    sequence length, grouped-query K/V with ``h % h_kv == 0`` and equal K
    and V head counts). Any sequence length and head_dim pass; only
    cross-attention shapes take the dense path."""
    del block_q, block_k  # the kernels choose their own tiles
    if q.dim() != 4 or q.shape[1] < 1:
        return False
    b, t, h, d = q.shape
    for other in (k, v):
        if other is None:
            continue
        if other.dim() != 4:
            return False
        ob, ot, oh, od = other.shape
        if (ob, ot, od) != (b, t, d) or oh < 1 or h % oh != 0:
            return False
    if k is not None and v is not None and k.shape[2] != v.shape[2]:
        return False
    return True


def _check_blocks(block_q, block_k) -> None:
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        _require(blk is None or (isinstance(blk, int) and blk > 0),
                 f"{name} must be a positive int or None, got {blk!r}")


def flash_attention(q, k, v, causal: bool = False, scale: Optional[float] = None,
                    block_q: Optional[int] = None, block_k: Optional[int] = None):
    """Attention on ``[batch, seq, heads, head_dim]`` tensors, out in q's
    dtype. Self-attention shapes run the flash kernels (forward and
    backward; the plain versions on the CPU); cross-attention shapes the
    dense :func:`reference_attention`. ``block_q``/``block_k`` are
    accepted for the JAX signature; the kernels choose their own tiles."""
    _check_blocks(block_q, block_k)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not flash_attention_supported(q, k, v):
        return reference_attention(q, k, v, causal=causal, scale=scale)
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))


def flash_attention_with_lse(q, k, v, causal: bool = False, scale: Optional[float] = None,
                             block_q: Optional[int] = None, block_k: Optional[int] = None):
    """Self-attention returning ``(out [b, t, h, d] f32, lse [b, h, t]
    f32)``, differentiable in both; the lse makes block results mergeable
    (ring attention). Cross-attention shapes take the dense path."""
    _check_blocks(block_q, block_k)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not flash_attention_supported(q, k, v):
        return _dense_with_lse(q, k, v, causal, scale)
    return _FlashAttentionWithLse.apply(q, k, v, bool(causal), float(scale))
