# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Smoke run of the PyTorch/CUDA port (``bluefog_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. device   -- the card's name, and its name and power limit from nvidia-smi;
2. build    -- compiles the CUDA wire kernels from ``bluefog_tpu_torch/csrc``;
3. parity   -- ``encode`` and ``decode_accumulate`` against their plain
               PyTorch versions on the card, int8 and int4, on a ragged input
               with an all-zero and a +-tiny block, over the Exp2(8) plan and
               the StarGraph(8) plan (partial permutations): bitwise;
4. consensus-- 40 rounds of ``neighbor_allreduce(x, compression="int8")`` on
               ``[8, 2**20]``: the spread shrinks 100x, the worker mean stays;
5. train    -- the main path: ResNet50 (1000 classes, bf16 compute) on 8
               virtual workers, 64 images of 224x224 each, seeded synthetic
               data, ``DistributedAdaptThenCombineOptimizer(sgd(0.1, 0.9))``
               with the int8 wire on the default Exp graph: 2 warm-up and 4
               timed steps, then one int4 step and one step of the CTA
               ``DistributedNeighborAllreduceOptimizer``. The kernels' launch
               counts are zeroed just before and read just after;
6. kernels  -- each kernel against its plain version at the main path's
               shapes (the full packed parameter buffer), timed with CUDA
               events beside its memory bound, then one JSON line.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA the script
exits non-zero before printing any result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import bluefog_tpu_torch as bft
from bluefog_tpu_torch import _build
from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.collective import inner, kernels
from bluefog_tpu_torch.collective.plan import plan_from_topology
from bluefog_tpu_torch.models import ResNet50, StackedModel, init_flax_like

SIZE = 8
BATCH = 64
IMAGE = 224
WARMUP, TIMED = 2, 4
RESNET50_PARAMS = 25_557_032  # the flax ResNet50 at 1000 classes

# Device memory rate by card (bytes/s; NVIDIA data sheets). The H100 SXM's
# 3.35 TB/s is the default for an unlisted Hopper part.
MEMORY_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
H100_SXM_RATE = 3.35e12
# Plain float32 arithmetic outside the tensor cores (H100 SXM data sheet).
F32_RATE = 67e12

KERNEL_ROWS = {
    "encode": ("bluefog_tpu/collective/kernels.py:373", "encode"),
    "decode_accumulate": ("bluefog_tpu/collective/kernels.py:449", "decode_accumulate"),
}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def memory_rate(name):
    for key, rate in MEMORY_RATE.items():
        if key in name:
            return rate
    return H100_SXM_RATE


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, iters=10, warmup=2):
    """Mean milliseconds per call: CUDA events on the card (after a
    warm-up), the host clock elsewhere."""
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def bits(t):
    """Integer view of a float tensor, for bitwise compares."""
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype, t.dtype))


def max_ulp(a, b):
    return int((bits(a).long() - bits(b).long()).abs().max())


def ragged_input(device, n=70_123, seed=0):
    """``[8, n]`` f32 (n % 512 != 0) with an all-zero block and a block of
    +-tiny multiples (a subnormal block scale) in every row."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(SIZE, n) * 5.0).astype(np.float32)
    x[:, :512] = 0.0
    tiny = np.finfo(np.float32).tiny
    x[:, 512:1024] = tiny * rng.choice([-1.0, 1.0], (SIZE, 512)) * rng.randint(1, 9, (SIZE, 512))
    return torch.from_numpy(x).to(device)


def check_encode(x, wire):
    """Kernel vs plain on one input; returns the max abs difference of the
    payload and the scales (0 when bitwise equal)."""
    p, s = kernels.encode(x, wire)
    rp, rs = kernels.encode_reference(x, wire)
    sync(x.device)
    err = max(float((p.int() - rp.int()).abs().max()),
              float((s.float() - rs.float()).abs().max()))
    if not (torch.equal(p, rp) and torch.equal(bits(s), bits(rs))):
        raise AssertionError(
            f"encode[{wire}] differs from its plain version: payload max diff "
            f"{int((p.int() - rp.int()).abs().max())}, scales max ulp {max_ulp(s, rs)}"
        )
    return err, p, s


def check_decode(acc, p, s, src, w, wire):
    got = kernels.decode_accumulate(acc.clone(), p, s, src, w, wire)
    ref = kernels.decode_accumulate_reference(acc.clone(), p, s, src, w, wire)
    sync(acc.device)
    if not torch.equal(bits(got), bits(ref)):
        raise AssertionError(
            f"decode_accumulate[{wire}] differs from its plain version: max ulp "
            f"{max_ulp(got, ref)}, max abs {float((got - ref).abs().max())}"
        )
    return float((got - ref).abs().max())


def phase_parity(device):
    x = kernels.pad_blocks(ragged_input(device)).contiguous()
    plans = {
        "exp2": plan_from_topology(topo.ExponentialTwoGraph(SIZE), weighted=True),
        "star": plan_from_topology(topo.StarGraph(SIZE), weighted=True),
    }
    for wire in ("int8", "int4"):
        _err, p, s = check_encode(x, wire)
        for name, plan in plans.items():
            src, _self_w, recv_w = inner.plan_operands(plan, device)
            check_decode(x, p, s, src, recv_w, wire)
        log("parity", f"{wire}: encode and decode_accumulate (exp2, star) bitwise "
                      f"equal to the plain versions on [{SIZE}, {x.shape[1]}]")


def phase_consensus(device, n=1 << 20, rounds=40):
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(SIZE, n, generator=gen, device=device)
    mean0 = x.mean(0)
    spread0 = float((x - mean0).abs().max())
    for _ in range(rounds):
        x = bft.neighbor_allreduce(x, compression="int8")
    sync(device)
    spread = float((x - x.mean(0)).abs().max())
    drift = float((x.mean(0) - mean0).abs().max()) / float(mean0.abs().max())
    log("consensus", f"{rounds} int8 rounds on [{SIZE}, {n}]: spread {spread0:.4g} -> "
                     f"{spread:.4g} ({spread0 / spread:.1f}x), mean drift {drift:.3g} (relative)")
    if not spread0 / spread >= 100:
        raise AssertionError(f"spread shrank only {spread0 / spread:.1f}x (< 100x)")
    if not drift <= 1e-5:
        raise AssertionError(f"worker mean drifted {drift:.3g} (> 1e-5 relative)")


def build_trainer(device, stage_sizes=None, num_filters=64, batch=BATCH, image=IMAGE,
                  num_classes=1000, seed=0):
    kw = {} if stage_sizes is None else {"stage_sizes": stage_sizes}
    model = init_flax_like(
        ResNet50(num_classes=num_classes, num_filters=num_filters, **kw), seed
    )
    sm = StackedModel(model, SIZE, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.randn(SIZE, batch, image, image, 3, generator=gen,
                         device=device).to(torch.bfloat16)
    labels = torch.randint(0, num_classes, (SIZE, batch), generator=gen, device=device)
    return sm, images, labels


def phase_train(device, sm, images, labels, warmup=WARMUP, timed=TIMED):
    """The main path. Returns ``(params, launch counts, [(step, forward
    and backward, optimizer) seconds per timed step])``; the split
    synchronises the card between the two parts."""
    params = sm.replicate()
    grads = torch.empty_like(params)
    atc = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    atc.compression = "int8"
    state = atc.init(params)
    losses, times = [], []

    def step(opt, st):
        t0 = time.perf_counter()
        loss, _ = sm.loss_and_grad(params, images, labels, grads)
        sync(device)
        t1 = time.perf_counter()
        opt.step(params, st, grads)
        sync(device)
        t2 = time.perf_counter()
        losses.append(loss.float().cpu())
        return t2 - t0, t1 - t0, t2 - t1

    kernels.reset_launch_counts()
    for i in range(warmup + timed):
        dt = step(atc, state)
        if i >= warmup:
            times.append(dt)
    atc.compression = "int4"
    step(atc, state)
    cta = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9))
    cta.compression = "int8"
    step(cta, cta.init(params))
    counts = kernels.launch_counts()

    table = torch.stack(losses)
    if not torch.isfinite(table).all() or not torch.isfinite(params).all():
        raise AssertionError("non-finite loss or parameters")
    for i, row in enumerate(table):
        kind = "atc/int8" if i < warmup + timed else ("atc/int4" if i == warmup + timed else "cta/int8")
        log("train", f"step {i} {kind}: mean loss {float(row.mean()):.5f} "
                     f"(workers {float(row.min()):.4f}..{float(row.max()):.4f})")
    return params, counts, times


def phase_profile(device, sm, images, labels, params, top=12):
    """One more ATC int8 step under ``torch.profiler``: the card's busy
    share of the step's wall time, and the kernels that take the most
    device time. Runs after the main path's launch counts were read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    opt.compression = "int8"
    state = opt.init(params)
    grads = torch.empty_like(params)
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sm.loss_and_grad(params, images, labels, grads)
        opt.step(params, state, grads)
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels only: an operator's self device time repeats its kernels'
    rows = [
        (e.self_device_time_total, e.count, e.key)
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA
    ]
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        log("profile", "the profiler reported no device time: busy share not measured")
        return
    log("profile", f"one profiled step (the profiler slows the host): wall "
                   f"{wall_us / 1e3:.1f} ms, kernels "
                   f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), idle "
                   f"{100 * (1 - busy_us / wall_us):.1f}%")
    for us, count, key in sorted(rows, reverse=True)[:top]:
        log("profile", f"{100 * us / busy_us:5.1f}% {us / 1e3:9.2f} ms x{count:5d} {key[:110]}")


def phase_kernels(device, params, counts, rate):
    """Each kernel against its plain version at the main path's shapes,
    and timed; returns the rows of the kernels JSON line."""
    plan = bft.get_context().static_plan()
    src, _self_w, recv_w = inner.plan_operands(plan, device)
    n_workers, width = params.shape
    elems = n_workers * width
    rows, lines = [], []
    for wire in ("int8", "int4"):
        x = params.clone()
        enc_err, p, s = check_encode(x, wire)
        dec_err = check_decode(x, p, s, src, recv_w, wire)
        acc = x.clone()
        enc_ms = time_ms(lambda: kernels.encode(x, wire), device)
        enc_plain = time_ms(lambda: kernels.encode_reference(x, wire), device, iters=3, warmup=1)
        dec_ms = time_ms(lambda: kernels.decode_accumulate(acc, p, s, src, recv_w, wire), device)
        dec_plain = time_ms(
            lambda: kernels.decode_accumulate_reference(acc, p, s, src, recv_w, wire),
            device, iters=3, warmup=1,
        )
        payload_b = p.numel() * p.element_size()
        scales_b = s.numel() * s.element_size()
        # bytes: every input read once, every output written once
        enc_bytes = elems * 4 + payload_b + scales_b
        dec_bytes = 2 * elems * 4 + payload_b + scales_b + src.numel() * 4 + recv_w.numel() * 4
        # operations: |x| and max per element, then divide and round (int4:
        # and pack); decode: the self dequant, then per round a dequant,
        # a subtract, a multiply and an add
        enc_ops = 4 * elems
        dec_ops = (1 + 4 * src.shape[0]) * elems
        for name, ms, plain, nbytes, ops, err in (
            ("encode", enc_ms, enc_plain, enc_bytes, enc_ops, enc_err),
            ("decode_accumulate", dec_ms, dec_plain, dec_bytes, dec_ops, dec_err),
        ):
            t_bytes, t_ops = nbytes / rate * 1e3, ops / F32_RATE * 1e3
            lines.append(
                f"{name}[{wire}] [{n_workers}, {width}]: {ms:.4f} ms kernel, "
                f"{plain:.4f} ms plain, bound {max(t_bytes, t_ops):.4f} ms "
                f"({nbytes / 1e9:.4f} GB), {nbytes / ms / 1e6:.1f} GB/s"
            )
            if wire == "int8":
                replaces, _ = KERNEL_ROWS[name]
                rows.append({
                    "name": name, "route": "cuda",
                    "source": "bluefog_tpu_torch/csrc/wire_kernels.cu",
                    "replaces": replaces, "launches": counts[name],
                    "max_abs_err": err, "ms": ms, "plain_ms": plain,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": None,
                })
            else:
                row = next(r for r in rows if r["name"] == name)
                row["max_abs_err"] = max(row["max_abs_err"], err)
        del x, acc, p, s
    return rows, lines


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log("device", f"{kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
                  f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = _build.build(["wire_kernels"])
    _build.wire_library()
    log("build", f"wire_kernels built in {time.perf_counter() - t0:.1f} s -> {libs['wire_kernels']}")
    for line in libs["wire_kernels"].with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())

    bft.init(size=SIZE)
    phase_parity(device)
    phase_consensus(device)

    sm, images, labels = build_trainer(device)
    if sm.n_params != RESNET50_PARAMS:
        raise AssertionError(f"ResNet50 has {sm.n_params} parameters, expected {RESNET50_PARAMS}")
    params, counts, times = phase_train(device, sm, images, labels)
    missing = [k for k in KERNEL_ROWS if counts[k] == 0]
    if missing:
        raise AssertionError(f"the main path launched no {missing} kernel: {counts}")
    step_s, fwd_s, opt_s = (statistics.median(t[k] for t in times) for k in range(3))
    log("train", f"ResNet50 x{SIZE} workers, {BATCH} images of {IMAGE}x{IMAGE} each, "
                 f"{sm.n_params} parameters per worker ({sm.width} packed): median step "
                 f"{step_s:.4f} s over {len(times)} (steps "
                 f"{', '.join(f'{t[0]:.4f}' for t in times)} s) = forward+backward "
                 f"{fwd_s:.4f} s + optimizer (SGD and int8 gossip) {opt_s:.4f} s; "
                 f"{SIZE * BATCH / step_s:.1f} images/s; peak memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}; on {smi}")
    phase_profile(device, sm, images, labels, params)
    del images, labels

    rows, lines = phase_kernels(device, params, counts, memory_rate(kind))
    for line in lines:
        log("kernels", f"{line}; on {smi}")
    print("kernels: " + json.dumps([r["name"] for r in rows]))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
