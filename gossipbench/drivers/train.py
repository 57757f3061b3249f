"""The training window: a closed loop of the port's fused train step.

Set-up builds one training step (``opt.make_train_step(sm.worker_loss)``
on a ``StackedModel`` and the mix's gossip optimizer), draws the weights
and a pool of distinct batches on the device from the seed, and drives
the step through the mix's first steps on batches that all differ. Those
steps warm up every shape; the losses they return, the first gradient
(read from the momentum after one step), the last one (the momentum less
``momentum`` times the one before, where the limits ask for it) and each
leaf's change over them are what the reference is held to. The window
then runs the same step object, one step after another (a step starts
when the one before it has returned and the card has finished it), for
``seconds``; with ``trace``
the profiler covers a few steps after it. Once the program's state is
freed, the reference follows the first steps in float32.
"""

import gc
import time
from types import SimpleNamespace
from typing import Optional

import torch

from gossipbench.lib import compare, weights
from gossipbench.lib import trace as trace_lib
from gossipbench.reference import train as reference_train
from gossipbench.reference import wire


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _trace_rows(state) -> torch.Tensor:
    """The momentum of an ``sgd(lr, momentum)`` state: after one step from
    zero, the gradient the optimizer was given."""
    return state["trace"] if isinstance(state, dict) else state


class Program:
    """The system under test: one train step with its model and state."""

    def __init__(self, cfg, mix, family, seed: int, device):
        import bluefog_tpu_torch as bft
        from bluefog_tpu_torch.models import StackedModel

        self.device, self.mix = device, mix
        n = mix["workers"]
        bft.init(topology_fn=getattr(bft.topology_util, mix["topology"]), size=n, device=device)
        module = family.build(cfg, device)
        self.sm = StackedModel(module, n, device, loss=family.program_loss())
        table = family.reference.param_table(cfg)
        mine = {p.name: tuple(p.shape) for p in table}
        theirs = {s.name: tuple(s.shape) for s in self.sm.slots}
        if mine != theirs:
            raise ValueError(f"the port's parameters differ from the configuration's: "
                             f"{sorted(set(mine.items()) ^ set(theirs.items()))[:6]}")
        flat = weights.draw(table, seed, device)
        self.row = self.sm.pack(weights.views(table, flat))
        del flat
        self.params = self.row.unsqueeze(0).repeat(n, 1).contiguous()
        opt = getattr(bft, mix["optimizer"])(bft.sgd(mix["lr"], momentum=mix["momentum"]))
        opt.compression = mix["compression"]
        self.opt = opt
        self.state = opt.init(self.params)
        self.step_fn = opt.make_train_step(self.sm.worker_loss)
        self.operands = [family.operands(b, mix) for b in
                         family.batches(cfg, mix, seed, device, mix["pool"])]
        self.index = 0

    def step(self) -> torch.Tensor:
        ops = self.operands[self.index % len(self.operands)]
        self.params, self.state, loss = self.step_fn(self.params, self.state, *ops)
        self.index += 1
        return loss

    def first_steps(self, steps: int, late: bool = False):
        """The mix's first steps: what the reference must reproduce (with
        ``late``, also the gradient of the last of them)."""
        losses, out, before = [], {}, None
        for t in range(steps):
            if late and t == steps - 1:
                before = _trace_rows(self.state).clone()
            losses.append(self.step().detach().to("cpu", torch.float64))
            if t == 0:
                out["grad"] = compare.slot_norms(_trace_rows(self.state), self.sm.slots)
        if before is not None:
            before.mul_(-float(self.mix["momentum"])).add_(_trace_rows(self.state))
            out["late_grad"] = compare.slot_norms(before, self.sm.slots)
            del before
        out["change"] = compare.slot_norms(self.params, self.sm.slots, minus=self.row)
        self.row = None
        return {"losses": torch.stack(losses), **out}

    def free(self) -> None:
        self.opt.free()
        for name in ("sm", "opt", "state", "step_fn", "params", "operands", "row"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_outputs(cfg, mix, family, seed: int, device, steps: int,
                      cast=reference_train.identity, fault: Optional[str] = None):
    """The reference's first steps on the weights and batches of ``seed``."""
    flat = weights.draw(family.reference.param_table(cfg), seed, device)
    pool = family.batches(cfg, mix, seed, device, mix["pool"])
    batches = [pool[t % len(pool)] for t in range(steps)]
    return reference_train.follow(family.reference, cfg, mix, flat, batches, steps,
                                  cast=cast, fault=fault)


def _launches():
    from bluefog_tpu_torch.collective import kernels
    from bluefog_tpu_torch.ops import flash

    return {**kernels.launch_counts(), **flash.launch_counts(),
            "flash_split_cotangent": flash.split_launch_count()}


def _wire_kernels():
    from bluefog_tpu_torch.collective import kernels

    return tuple(kernels.launch_counts())


def _reset_launches() -> None:
    from bluefog_tpu_torch.collective import kernels
    from bluefog_tpu_torch.ops import flash

    kernels.reset_launch_counts()
    flash.reset_launch_counts()


def _profiled(program: Program, steps: int, path) -> trace_lib.Summary:
    """``steps`` steps under ``torch.profiler`` after one warm-up step,
    each in a ``gossipbench.step`` span (the call ``gossipbench.train_step``,
    the wait ``gossipbench.sync``)."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    activities = [ProfilerActivity.CPU]
    if program.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=steps),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(1 + steps):
            with record_function(trace_lib.STEP_SPAN):
                with record_function("gossipbench.train_step"):
                    program.step()
                with record_function("gossipbench.sync"):
                    sync(program.device)
            prof.step()
    try:
        return trace_lib.summarize(trace_lib.load(path))
    finally:
        path.unlink()


def run(cfg, mix, family, seed: int, seconds: float, trace: bool, device, t_start: float,
        limits, trace_path, log=print):
    """One run of the cell: returns a namespace of what the harness
    reports (see the module docstring)."""
    torch.manual_seed(weights.sub_seed(seed, "torch"))
    program = Program(cfg, mix, family, seed, device)
    first = program.first_steps(mix["check_steps"], late="late_grad_gap" in limits)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()
    window_losses, host_s = [], []
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        window_losses.append(program.step())
        host_s.append(time.perf_counter() - a)
        sync(device)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    steps = len(host_s)
    launches = {k: v / steps for k, v in _launches().items() if v}
    wire_launches = {k: launches[k] for k in _wire_kernels() if k in launches}
    log(f"[gossipbench] set-up {t0 - t_start:.3f} s; window: {steps} steps in "
        f"{window_s:.4f} s; launches a step: "
        + (", ".join(f"{k} {v:g}" for k, v in launches.items()) or "none"))
    summary = None
    if trace:
        summary = _profiled(program, mix["profile_steps"], trace_path)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    losses = torch.stack([l.detach() for l in window_losses]).cpu()
    failed = int((~torch.isfinite(losses).all(dim=1)).sum())
    program.free()
    del window_losses
    ref = reference_outputs(cfg, mix, family, seed, device, mix["check_steps"])
    correct, checks, where = compare.compare(first, ref, limits)
    # what the per-layer readers read: the window's untraced steps, the
    # trace, and the shapes their counts come from
    ctx = SimpleNamespace(
        cfg=cfg, mix=mix, family=family, steps=steps, window_s=window_s, host_s=host_s,
        trace=summary, step_flops=family.step_flops(cfg, mix),
        width=wire.layout(family.reference.param_table(cfg))[1], wire_launches=wire_launches,
        rounds=(len(wire.exponential_sources(mix["workers"]))
                if mix["topology"] == "ExponentialGraph" else None))
    end_to_end = {"step_ms": 1e3 * window_s / steps, "peak_mem_gib": peak / 2**30,
                  "setup_s": t0 - t_start}
    return SimpleNamespace(end_to_end=end_to_end, peak_bytes=peak, attempted=steps,
                           failed=failed, correct=correct, checks=checks, where=where,
                           ctx=ctx, summary=summary)
