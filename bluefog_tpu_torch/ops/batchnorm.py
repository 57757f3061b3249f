# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""BatchNorm over NCHW activations, with the residual add and the ReLU
that follow it fused: flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``
as :class:`bluefog_tpu_torch.models.resnet.BatchNorm` runs it.

:func:`batch_norm` computes ``relu(residual + bn(x))`` (either part
optional). A CPU tensor takes the plain version,
:func:`batch_norm_reference`, the composite the model has always computed
(f32 statistics from the fast variance ``E[x^2] - E[x]^2`` clipped at 0,
the output rounded to its dtype, then the residual add and the ReLU), and
autograd differentiates it. A CUDA tensor takes the hand-written kernels
of ``csrc/batchnorm_kernels.cu`` (built at first use by
:mod:`bluefog_tpu_torch._build`), through a ``torch.autograd.Function``:

- forward: ``stats`` (per-block column sums of x and x^2), ``finish`` (the
  sums in a fixed order: mean, rstd, and the running statistics updated in
  place) and ``apply`` (normalize, scale and shift, the residual, the
  ReLU); in eval mode ``apply`` alone, from the running statistics;
- backward: ``bwd_reduce`` (column sums of ``g`` and ``g * xhat``, ``g`` the
  output's gradient masked by the ReLU), ``bwd_finish`` (dscale, dbias and
  dx's per-channel coefficients) and ``bwd_dx`` (dx, and ``g`` as the
  residual's gradient).

The Function saves x, the output where the ReLU was fused (the tensor the
next convolution saves anyway) and the per-channel f32 ``stats``: nothing
f32 of an activation's size. :func:`batch_norm_backward_reference` is the
backward's formula in plain PyTorch, the kernels' oracle.

A CUDA activation must be channels-last contiguous (``[N, C, H, W]`` whose
memory is a row-major ``[N*H*W, C]``), bf16 or f32, with the residual and
the output in its dtype; anything else raises. The statistics are
deterministic: the partial sums are added in a fixed order, with no
atomics.
"""

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bluefog_tpu_torch import _build

__all__ = [
    "batch_norm",
    "batch_norm_fwd",
    "batch_norm_bwd",
    "batch_norm_reference",
    "batch_norm_apply_reference",
    "batch_norm_backward_reference",
    "batch_norm_stats_reference",
    "batch_norm_stats_bounds",
    "batch_norm_sum_bound",
    "launch_counts",
    "reset_launch_counts",
    "KERNELS",
]

KERNELS = ("stats", "finish", "apply", "bwd_reduce", "bwd_finish", "bwd_dx")
_LAUNCHES = dict.fromkeys(KERNELS, 0)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # csrc/batchnorm_kernels.cu::kThreads
_BLOCKS_PER_SM = 4
# a reducing block walks at least this many rows, so its partials (2 f32 a
# channel) stay at most an eighth of the bf16 bytes it reads
_MIN_REDUCE_ROWS = 32
_UNROLL = 4  # rows a thread loads before it uses any


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts` (the
    plain versions never count)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


# -- plain versions -------------------------------------------------------------


def batch_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         running_mean: torch.Tensor, running_var: torch.Tensor,
                         training: bool, momentum: float = 0.9, eps: float = 1e-5,
                         residual: Optional[torch.Tensor] = None,
                         relu: bool = False) -> torch.Tensor:
    """The composite: statistics in ``x``'s dtype promoted to f32 at least,
    the running statistics updated in place (training), the output rounded
    to ``x``'s dtype, then ``residual +`` and ReLU."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if training:
        mu = xf.mean(dim=(0, 2, 3))
        mu2 = (xf * xf).mean(dim=(0, 2, 3))
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        with torch.no_grad():
            running_mean.copy_(momentum * running_mean + (1 - momentum) * mu)
            running_var.copy_(momentum * running_var + (1 - momentum) * var)
    else:
        mu, var = running_mean, running_var
    mul = torch.rsqrt(var + eps) * scale
    return _normalize(xf, mu, mul, bias, x.dtype, residual, relu)


def _normalize(xf, mu, mul, bias, out_dtype, residual, relu) -> torch.Tensor:
    y = (xf - mu[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    y = y.to(out_dtype)
    if residual is not None:
        y = residual + y
    if relu:
        y = F.relu(y)
    return y


def batch_norm_apply_reference(x: torch.Tensor, stats: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                               relu: bool = False) -> torch.Tensor:
    """The forward's normalization from given ``stats [3, C]`` (mean, rstd,
    flag): the reference's operations, one rounding each, with ``mul =
    rstd * scale``; the ``apply`` kernel's output bit for bit."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    return _normalize(xf, stats[0], stats[1] * scale, bias, x.dtype, residual, relu)


def batch_norm_stats_reference(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``stats [3, C]`` as the kernels write them: the batch mean, ``rstd =
    1 / sqrt(var + eps)`` of the clipped fast variance, and 1 where the
    variance term of the backward stands (``E[x^2] - E[x]^2 >= 0``, where
    ``torch.clamp`` passes its gradient), else 0."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(dim=(0, 2, 3))
    raw = (xf * xf).mean(dim=(0, 2, 3)) - mu * mu
    rstd = 1.0 / torch.sqrt(torch.clamp(raw, min=0.0) + eps)
    return torch.stack([mu, rstd, (raw >= 0).to(mu.dtype)])


def batch_norm_stats_bounds(x: torch.Tensor, ref: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f64 bounds ``(d_mean, d_var, d_rstd)`` on the kernels' mean, fast
    variance and rstd against ``ref`` (:func:`batch_norm_stats_reference`
    of ``x``): both sum in f32 but in another order (the kernels a few
    hundred rows a thread, then a fixed tree; ATen its own cascade), each
    sum within 2e-5 of the sum of its terms' magnitudes; the variance
    inherits ``E[x^2]``'s and twice the mean's, rstd half the variance's
    relative error and one f32 rounding."""
    xf = x.double()
    abs_mean = xf.abs().mean(dim=(0, 2, 3))
    sq_mean = (xf * xf).mean(dim=(0, 2, 3))
    d_mean = 2e-5 * abs_mean
    d_var = 2e-5 * sq_mean + 2 * ref[0].double().abs() * d_mean
    var = sq_mean - xf.mean(dim=(0, 2, 3)) ** 2
    d_rstd = ref[1].double() * (0.5 * d_var / (var.clamp(min=0) + 1e-5) + 2.0 ** -22)
    return d_mean, d_var, d_rstd


def batch_norm_sum_bound(terms: torch.Tensor) -> torch.Tensor:
    """The f64 bound on a per-channel f32 sum of ``terms [N, C, H, W]`` taken
    in another order (the backward's dbias and dscale): 2e-5 of the sum of
    the terms' magnitudes."""
    return 2e-5 * terms.double().abs().sum(dim=(0, 2, 3)) + 1e-30


def batch_norm_backward_reference(
    dy: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor], stats: torch.Tensor,
    scale: torch.Tensor, batch_stats: bool = True,
    sums: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dscale, dbias, g)`` of :func:`batch_norm` from the output's
    gradient ``dy``, the input ``x``, the output ``y`` where the ReLU was
    fused (else None) and ``stats`` (:func:`batch_norm_stats_reference`).
    ``g`` is ``dy`` masked by ``y > 0``, the residual's gradient; ``dx =
    rstd*scale * (g - sum(g)/M - xhat * sum(g*xhat)/M)`` with ``xhat = (x
    - mean) * rstd`` (each ``/M`` a product with ``1/M`` rounded first),
    the last term dropped where the variance was clipped;
    without ``batch_stats`` (eval mode) ``dx = rstd*scale * g``. Computed in
    ``x``'s dtype promoted to f32 at least; dx and g in ``dy``'s dtype.
    ``sums``, the per-channel ``(sum(g), sum(g * xhat))``, replaces the
    sums this computes (the kernels' own, to hold ``bwd_dx`` bit for
    bit)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    g = dy.to(acc)
    if y is not None:
        g = torch.where(y > 0, g, torch.zeros((), dtype=acc))
    mean, rstd, keep = (s[:, None, None] for s in stats.to(acc))
    xhat = (x.to(acc) - mean) * rstd
    inv_n = torch.tensor(float(x.numel() // x.shape[1]), dtype=acc).reciprocal()
    if sums is None:
        sg, sgx = g.sum(dim=(0, 2, 3)), (g * xhat).sum(dim=(0, 2, 3))
    else:
        sg, sgx = (t.to(acc) for t in sums)
    k1 = rstd * scale.to(acc)[:, None, None]
    if batch_stats:
        k2 = (sg * inv_n)[:, None, None]
        k3 = torch.where(keep != 0, (sgx * inv_n)[:, None, None], torch.zeros((), dtype=acc))
        dx = k1 * (g - k2 - xhat * k3)
    else:
        dx = k1 * g
    return dx.to(dy.dtype), sgx, sg, g.to(dy.dtype)


# -- kernels -------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _grid(m: int, c: int, vec_elems: int, index: int) -> Tuple[int, int]:
    """Blocks along the rows ``(reducing kernels, elementwise kernels)``: a
    few blocks an SM in all, a reducing block at least
    :data:`_MIN_REDUCE_ROWS` rows, an elementwise one :data:`_UNROLL` rows
    a thread. The partials' shape, so the order of the sums, depends on
    ``(m, c)``, the vector width and the card alone."""
    groups = c // vec_elems
    rows_per_pass = _THREADS // min(groups, _THREADS)
    chunks = -(-groups // _THREADS)
    blocks = max(1, _sm_count(index) * _BLOCKS_PER_SM // chunks)
    reduce = min(blocks, max(1, -(-m // max(rows_per_pass, _MIN_REDUCE_ROWS))))
    elementwise = min(blocks, max(1, -(-m // (rows_per_pass * _UNROLL))))
    return reduce, elementwise


def _stream(index: int) -> int:
    return torch._C._cuda_getCurrentRawStream(index)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def _vec(c: int, dtype: torch.dtype, *tensors) -> int:
    """The elements of a 16-byte access, where ``c`` and every pointer
    allow it, else 1."""
    v = 16 // (2 if dtype == torch.bfloat16 else 4)
    if c % v or any(t is not None and t.data_ptr() % 16 for t in tensors):
        return 1
    return v


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _status(status: int, what: str) -> None:
    if status:
        raise RuntimeError(f"BatchNorm {what} kernel launch failed with cudaError {status}")


def _eval_stats(running_mean, running_var, eps) -> torch.Tensor:
    """``stats`` of eval mode for the backward: the running mean and its
    rstd (the variance flag is unused without batch statistics)."""
    rstd = 1.0 / torch.sqrt(running_var + eps)
    return torch.stack([running_mean, rstd, torch.zeros_like(rstd)])


def batch_norm_fwd(x, scale, bias, residual, running_mean, running_var, training: bool,
                   momentum: float, eps: float, relu: bool, want_stats: bool = True):
    """The forward kernels on checked CUDA operands, one call into the
    library: ``(y, stats [3, C] f32)``. Training launches ``stats``,
    ``finish`` (the running statistics updated in place) and ``apply``;
    eval mode ``apply`` alone from the running statistics, and builds
    ``stats`` for a backward only if ``want_stats`` (else None)."""
    dev, c = x.device, x.shape[1]
    m = x.numel() // c if c else 0
    vec = _vec(c, x.dtype, x, residual)
    g_red, g_ew = _grid(m, c, vec, dev.index)
    y = torch.empty_like(x)
    if training:
        partial = torch.empty(g_red * 2 * c, dtype=torch.float32, device=dev)
        stats = torch.empty((3, c), dtype=torch.float32, device=dev)
        partial_p, stats_p = partial.data_ptr(), stats.data_ptr()
    else:
        stats = _eval_stats(running_mean, running_var, eps) if want_stats else None
        partial_p = stats_p = None
    _status(_build.batchnorm_library().bf_bn_forward(
        x.data_ptr(), _ptr(residual), y.data_ptr(), partial_p, stats_p,
        running_mean.data_ptr(), running_var.data_ptr(), scale.data_ptr(), bias.data_ptr(), m,
        c, g_red, g_ew, training, eps, momentum, 1 - momentum, relu, _DTYPES[x.dtype],
        vec > 1, _stream(dev.index)), "forward")
    if training:
        _LAUNCHES["stats"] += 1
        _LAUNCHES["finish"] += 1
    _LAUNCHES["apply"] += 1
    return y, stats


def batch_norm_bwd(dy, x, y, stats, scale, training: bool, residual_grad: bool):
    """The backward kernels, one call into the library: ``(dx, dscale,
    dbias, g)`` as :func:`batch_norm_backward_reference` gives them (``g``
    only if ``residual_grad``, else None), from the output's gradient
    ``dy``, the saved ``x``, the output ``y`` where the ReLU was fused (else
    None) and ``stats``. ``dy`` is taken to ``x``'s dtype and channels-last
    first where it is not (autograd hands the global pool's gradient
    expanded)."""
    dev, c = x.device, x.shape[1]
    m = x.numel() // c if c else 0
    if dy.dtype != x.dtype or not dy.is_contiguous(memory_format=torch.channels_last):
        dy = dy.to(dtype=x.dtype, memory_format=torch.channels_last)
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if residual_grad else None
    vec = _vec(c, x.dtype, x, y, dy, dx, dres)
    g_red, g_ew = _grid(m, c, vec, dev.index)
    # one f32 buffer: coef [3, C], dscale [C], dbias [C], then the partials
    ws = torch.empty((5 + 2 * g_red) * c, dtype=torch.float32, device=dev)
    p = ws.data_ptr()
    _status(_build.batchnorm_library().bf_bn_backward(
        dy.data_ptr(), _ptr(y), x.data_ptr(), stats.data_ptr(), scale.data_ptr(),
        p + 20 * c, p, p + 12 * c, p + 16 * c, dx.data_ptr(), _ptr(dres), m, c, g_red, g_ew,
        training, _DTYPES[x.dtype], vec > 1, _stream(dev.index)), "backward")
    _LAUNCHES["bwd_reduce"] += 1
    _LAUNCHES["bwd_finish"] += 1
    _LAUNCHES["bwd_dx"] += 1
    return dx, ws[3 * c:4 * c], ws[4 * c:5 * c], dres


class _BatchNorm(torch.autograd.Function):
    """The kernels' forward and backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, running_mean, running_var, training, momentum,
                eps, relu):
        grad = any(ctx.needs_input_grad)
        y, stats = batch_norm_fwd(x, scale, bias, residual, running_mean, running_var,
                                  training, momentum, eps, relu, want_stats=grad)
        if grad:
            ctx.save_for_backward(x, y if relu else None, stats, scale)
            ctx.training = training
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, stats, scale = ctx.saved_tensors
        dx, dscale, dbias, dres = batch_norm_bwd(dy, x, y, stats, scale, ctx.training,
                                                 ctx.needs_input_grad[3])
        return dx, dscale, dbias, dres, None, None, None, None, None, None


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, training: bool,
               momentum: float = 0.9, eps: float = 1e-5,
               residual: Optional[torch.Tensor] = None, relu: bool = False) -> torch.Tensor:
    """``relu(residual + bn(x))`` over ``x [N, C, H, W]``, with ``scale``,
    ``bias`` and the running statistics ``[C]`` f32 (updated in place in
    training). A CPU tensor takes :func:`batch_norm_reference`; a CUDA
    tensor the kernels, or it raises (see the module docstring)."""
    dev = x.device
    if dev.type == "cpu":
        return batch_norm_reference(x, scale, bias, running_mean, running_var, training,
                                    momentum, eps, residual, relu)
    _check(dev.type == "cuda", f"BatchNorm runs on cuda or cpu, got {dev}")
    _check(x.dtype in _DTYPES, f"BatchNorm on the card takes bf16 or f32, got {x.dtype}")
    _check(x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last),
           f"x must be [N, C, H, W] and channels-last contiguous, got {tuple(x.shape)} with "
           f"strides {x.stride()}")
    if residual is not None:
        _check(residual.device == dev and residual.dtype == x.dtype
               and residual.shape == x.shape
               and residual.is_contiguous(memory_format=torch.channels_last),
               f"the residual must be channels-last contiguous, like x ({x.dtype}, "
               f"{tuple(x.shape)} on {dev})")
    c = (x.shape[1],)
    for t, name in ((scale, "scale"), (bias, "bias"), (running_mean, "running_mean"),
                    (running_var, "running_var")):
        _check(t.dtype == torch.float32 and t.shape == c and t.device == dev
               and t.is_contiguous(), f"{name} must be a contiguous [{c[0]}] float32 tensor "
               f"on {dev}")
    return _BatchNorm.apply(x, scale, bias, residual, running_mean, running_var, bool(training),
                            float(momentum), float(eps), bool(relu))
