# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Checkpoint and resume of decentralized training state.

Counterpart of ``bluefog_tpu/checkpoint.py``, with ``torch.save`` in place
of orbax:

- ``save(path, step, params, opt_state, optimizer=None)`` writes the
  worker-stacked trees, and with ``optimizer`` its step and communication
  counters, the ``"grad"`` order's pending gradient sum, the CHOCO copies
  of the error-feedback tiers, and a window optimizer's window lanes;
  under ``BLUEFOG_SHARD=1`` the sharded state is gathered to full vectors
  first, so it restores under any layout;
- ``restore(path, step=None, optimizer=None)`` returns ``(step, params,
  opt_state)`` on the context's device and puts the rest back onto the
  optimizer, refusing a checkpoint of another world size, topology, shape
  or shard mode; under an open elastic session a checkpoint of another
  live set is repaired to instead (the session adopts the saved live set).

The module buffers of a model (BatchNorm statistics) are not parameters:
pass them as ``extra=`` (a tree of tensors) to both calls; ``restore``
copies the saved values into the given tensors in place.

A checkpoint is the directory ``<path>/<step>`` holding ``state.pt``,
written to a temporary directory and renamed into place, and the sidecar
``<path>/<step>.graph.json`` with the graph-info block (JAX's keys),
which ``restore`` reads first: a mismatch fails before any state is
loaded. Loading uses ``torch.load(..., weights_only=True)``.

Across processes (a context whose ``process_count > 1``) the file is the
one the stacked run writes, whatever the layout: ``save`` gathers every
tree of the payload (the params, opt_state, extra, the pending gradient
sum, the window lanes, the CHOCO copies and the sharded state) to every
row (:func:`bluefog_tpu_torch.collective.transport.gather_rows`, each
process in the same order), process 0 writes ``state.pt`` and the sidecar
and the others wait at the group's barrier; ``restore`` reads the file in
every process, each keeping its rows. So a checkpoint written by 2 x 4
processes restores in one process and the reverse, bitwise. The processes
must share the directory's file system.
"""

import ast
import hashlib
import json
import os
import shutil
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from bluefog_tpu_torch import context as ctx_mod
from bluefog_tpu_torch import sharding
from bluefog_tpu_torch import windows as win_mod
from bluefog_tpu_torch.collective import transport
from bluefog_tpu_torch.logging_util import logger

__all__ = ["save", "restore", "latest_step", "topology_digest"]

_STATE_FILE = "state.pt"
_WINDOW_LANES = ("value", "buffers", "versions", "p", "p_buffers")
_WINDOW_AGE = ("slot_written", "mass_birth")


def topology_digest(topo) -> Optional[str]:
    """Fingerprint of a weighted topology: the sha1 of its float64
    combination matrix's bytes (the matrix ``nx.to_numpy_array`` gives for
    the JAX package's graph, so both packages agree)."""
    if topo is None:
        return None
    return hashlib.sha1(
        np.ascontiguousarray(np.asarray(topo, dtype=np.float64)).tobytes()
    ).hexdigest()


def _graph_info(optimizer=None) -> Optional[dict]:
    """The graph block ``save`` records: world size, topology version and
    digest, the elastic live set (every worker without an elastic
    session), and the shard layout of a sharding optimizer. None before
    ``init``."""
    if not ctx_mod.is_initialized():
        return None
    ctx = ctx_mod.get_context()
    m = ctx.elastic_membership
    info = {
        "world_size": int(ctx.size),
        "topo_version": int(ctx.topo_version),
        "topo_digest": topology_digest(ctx.load_topology()),
        "live_ranks": list(m.live_ranks()) if m is not None else list(range(ctx.size)),
    }
    layout = getattr(optimizer, "_shard_layout", None)
    if layout is not None:
        info["shard"] = {
            "n_live": len(layout.live),
            "master": bool(layout.master),
            "groups": [[g.dtype, g.elems, g.slot] for g in layout.groups],
        }
    return info


def _check_graph_info(info: dict, optimizer) -> None:
    """Refuse, or under an open elastic session repair to, a restore whose
    graph does not match the live context: a different live set is
    adopted through ``session.adopt_live_set`` (ranks absent from it are
    condemned, present ones revived, the topology repaired)."""
    from bluefog_tpu_torch import elastic

    ctx = ctx_mod.get_context()
    saved_size = int(info["world_size"])
    if saved_size != ctx.size:
        raise ValueError(
            f"checkpoint was saved on a {saved_size}-worker mesh but the current "
            f"mesh has {ctx.size} workers; re-launch with the saved world size or "
            "re-shard the checkpoint explicitly"
        )
    saved_live = tuple(int(r) for r in info.get("live_ranks", []))
    cur_m = ctx.elastic_membership
    cur_live = cur_m.live_ranks() if cur_m is not None else tuple(range(ctx.size))
    saved_digest = info.get("topo_digest")
    cur_digest = topology_digest(ctx.load_topology())
    if saved_live == cur_live and saved_digest == cur_digest:
        return
    session = elastic.active_session()
    if session is not None and saved_live != cur_live:
        logger.warning(
            "checkpoint live set %s differs from current %s; repairing topology to "
            "the saved membership", list(saved_live), list(cur_live),
        )
        session.adopt_live_set(saved_live, optimizer)
        return
    raise ValueError(
        "checkpoint topology does not match the live context (saved topology "
        f"v{info.get('topo_version')} digest {saved_digest!r}, live "
        f"{list(saved_live)}; current digest {cur_digest!r}, live "
        f"{list(cur_live)}): restoring would silently load state shaped for a "
        "different graph. Install the matching topology with "
        "bft.set_topology(), or start an elastic session "
        "(bft.elastic.start()) to repair to the saved live set."
    )


def _to_host(tree):
    """A copy of a tree with every tensor detached on the CPU (dicts,
    lists and tuples kept; a NamedTuple becomes a tuple)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree) if not hasattr(tree, "_fields") \
            else tuple(_to_host(v) for v in tree)
    return tree


def _multi_process():
    """The active context when it spans several processes, else None."""
    if not ctx_mod.is_initialized():
        return None
    ctx = ctx_mod.get_context()
    return ctx if ctx.process_count > 1 else None


def _map_tensors(tree, fn):
    """``tree`` with ``fn`` applied to every tensor, structure kept
    (a NamedTuple stays one)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map_tensors(v, fn) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree


def _to_device(tree, device):
    return _map_tensors(tree, lambda t: t.to(device))


def _all_rows(tree, ctx, axis: int = 0):
    """Across processes, every worker's rows of each tensor of ``tree``
    (its rows along ``axis``); the tree itself with one process."""
    if ctx is None:
        return tree

    def gather(t):
        t = t.detach().to(ctx.device)
        rows = t.transpose(0, axis) if axis else t
        full = transport.gather_rows(rows.contiguous(), ctx)
        return full.transpose(0, axis) if axis else full

    return _map_tensors(tree, gather)


def _own_rows(tree, ctx, axis: int = 0):
    """Across processes, this process's rows (along ``axis``) of each
    tensor of a saved tree; the tree itself with one process."""
    if ctx is None:
        return tree
    rows = slice(ctx.rows.start, ctx.rows.stop)
    return _map_tensors(tree, lambda t: t[(slice(None),) * axis + (rows,)].clone())


def _window_state(opt) -> Optional[dict]:
    """A window optimizer's window lanes (and its age lane), or None;
    across processes every row of the lanes."""
    from bluefog_tpu_torch.optimizers import _WindowOptimizer

    if not isinstance(opt, _WindowOptimizer):
        return None
    if opt._name is None:
        raise ValueError(
            "cannot checkpoint a window optimizer with no live window "
            "(saved after free(), or before init())"
        )
    win = win_mod._get_win(ctx_mod.get_context(), opt._name)
    out = {"name": opt._name}
    out.update({f: _all_rows(getattr(win, f), _multi_process()).detach().cpu().clone()
                for f in _WINDOW_LANES})
    out.update({f: torch.from_numpy(getattr(win, f).copy()) for f in _WINDOW_AGE})
    out["clock"] = int(win.clock)
    return out


def _shard_layout_of(optimizer, opt_state):
    """The active layout iff ``opt_state`` really is the sharded form."""
    layout = getattr(optimizer, "_shard_layout", None)
    if layout is None or not isinstance(opt_state, sharding.ShardedOptState):
        return None
    return layout


def _gather_sharded_state(opt_state, layout) -> Tuple[dict, dict]:
    """Gather-on-save: each slot leaf ``[N, slot]`` becomes its group's full
    vector (the live owners' rows in order, padding cut), every other leaf
    is kept; returns ``(leaves by key, shard info)``."""
    from bluefog_tpu_torch.optimizers import _GossipOptimizer, _gather_slot_rows, tree_leaves

    out, slot_leaves = {}, []
    leaves = tree_leaves(opt_state)
    for i, leaf in enumerate(leaves):
        leaf = leaf.detach().cpu()
        gi = _GossipOptimizer._shard_slot_group(tuple(leaf.shape), layout)
        if gi is None:
            out[f"leaf_{i:03d}"] = leaf.clone()
        else:
            out[f"leaf_{i:03d}"] = _gather_slot_rows(leaf, layout, gi).clone()
            slot_leaves.append([i, gi])
    info = {
        "version": 1,
        "n_leaves": len(leaves),
        "slot_leaves": slot_leaves,
        "groups": [[g.dtype, g.elems] for g in layout.groups],
        "master": bool(layout.master),
    }
    return out, info


def save(path: str, step: int, params, opt_state, optimizer=None, extra=None) -> str:
    """Write the checkpoint ``<path>/<step>`` (atomically: a temporary
    directory renamed into place) and its graph sidecar; returns the
    directory. ``extra`` is saved beside the state (module buffers). It
    runs inside the memory observatory's ``checkpoint_save`` phase.
    Across processes every process calls it: the trees are gathered, and
    process 0 writes (see the module docstring)."""
    from bluefog_tpu_torch import memory as mem_mod

    with mem_mod.phase_scope("checkpoint_save"):
        return _save(path, step, params, opt_state, optimizer, extra)


def _save(path: str, step: int, params, opt_state, optimizer, extra) -> str:
    ctx = _multi_process()
    root = os.path.abspath(path)
    target = os.path.join(root, str(int(step)))
    # every process gathers in this order; across processes the trees
    # hold every row from here on
    params, opt_state = _all_rows(params, ctx), _all_rows(opt_state, ctx)
    payload = {"step": int(step), "params": _to_host(params), "opt_state": _to_host(opt_state)}
    if extra is not None:
        payload["extra"] = _to_host(_all_rows(extra, ctx))
    layout = _shard_layout_of(optimizer, opt_state)
    if layout is not None:
        payload["opt_state"], shard_info = _gather_sharded_state(opt_state, layout)
        payload["shard_info"] = repr(shard_info)
    graph_info = _graph_info(optimizer)
    if graph_info is not None:
        payload["graph_info"] = json.dumps(graph_info)
    if optimizer is not None:
        if getattr(optimizer, "_step_count", None) is not None:
            payload["opt_step_count"] = int(optimizer._step_count)
        if getattr(optimizer, "_comm_count", None) is not None:
            payload["opt_comm_count"] = int(optimizer._comm_count)
        accum = getattr(optimizer, "_grad_accum", None)
        if accum is not None:
            payload["grad_accum"] = _to_host(_all_rows(list(accum), ctx))
        wstate = _window_state(optimizer)
        if wstate is not None:
            payload["window"] = wstate
        ef = getattr(optimizer, "_ef", None)
        if ef is not None:
            # the receive copies [R, N, n] hold the workers on their axis 1
            payload["ef_state"] = [[_all_rows(a, ctx, axis).detach().cpu().clone()
                                    for axis, a in enumerate(pair)] for pair in ef]
            # the signature without its device, which restore puts back
            payload["ef_sig"] = repr(tuple(optimizer._ef_sig[:3]))
    if ctx is not None and ctx.process_index != 0:
        transport.barrier(ctx)
        return target
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{int(step)}.", dir=root)
    try:
        torch.save(payload, os.path.join(tmp, _STATE_FILE))
        if os.path.isdir(target):
            shutil.rmtree(target)
        os.replace(tmp, target)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if graph_info is not None:
        side = _sidecar_path(path, step)
        with open(side + ".tmp", "w") as f:
            json.dump({"graph_info": graph_info}, f)
        os.replace(side + ".tmp", side)
    if ctx is not None:
        transport.barrier(ctx)
    return target


def _sidecar_path(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"{int(step)}.graph.json")


def latest_step(path: str) -> Optional[int]:
    """The largest step directory under ``path``, or None."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = [int(d) for d in os.listdir(path) if d.isdigit()]
    return max(steps) if steps else None


def restore(path: str, step: Optional[int] = None, optimizer=None,
            extra=None) -> Tuple[int, object, object]:
    """Load ``(step, params, opt_state)`` from ``path`` (``step`` defaults
    to the latest), on the context's device; counters, the pending
    gradient sum, the CHOCO copies and the window lanes go back onto
    ``optimizer`` (already ``init``-ed with matching shapes), and ``extra``
    is filled in place. Across processes each process keeps its rows of
    the saved trees."""
    ctx = _multi_process()
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    target = os.path.join(os.path.abspath(path), str(int(step)))
    pre_validated = False
    side = _sidecar_path(path, step)
    if ctx_mod.is_initialized() and os.path.exists(side):
        try:
            with open(side) as f:
                side_info = json.load(f).get("graph_info")
        except (OSError, ValueError):
            side_info = None  # an unreadable sidecar: the check after loading runs
        if side_info is not None:
            _check_graph_info(side_info, optimizer)
            pre_validated = True
    payload = torch.load(os.path.join(target, _STATE_FILE), map_location="cpu",
                         weights_only=True)
    graph_info = payload.get("graph_info")
    if graph_info is not None and not pre_validated and ctx_mod.is_initialized():
        _check_graph_info(json.loads(graph_info), optimizer)
    device = ctx_mod.get_context().device if ctx_mod.is_initialized() else torch.device("cpu")
    params = _to_device(_own_rows(payload["params"], ctx), device)
    shard_info = payload.get("shard_info")
    if shard_info is not None:
        opt_state = _reslice_sharded_state(ast.literal_eval(shard_info), payload, params,
                                           optimizer, device, ctx)
    else:
        if (optimizer is not None and callable(getattr(optimizer, "_shard_active", None))
                and optimizer._shard_active()):
            raise ValueError(
                "BLUEFOG_SHARD=1 but this checkpoint holds REPLICATED optimizer "
                "state (saved with sharding off); restore with BLUEFOG_SHARD=0, or "
                "re-save from a sharded run (sharded saves are gathered and restore "
                "onto any live set)"
            )
        opt_state = _to_device(_own_rows(payload["opt_state"], ctx), device)
    if extra is not None:
        _fill_extra(extra, _own_rows(payload.get("extra"), ctx))
    if optimizer is not None:
        _restore_optimizer(optimizer, payload, device, ctx)
    return int(payload["step"]), params, opt_state


def _fill_extra(extra, saved) -> None:
    from bluefog_tpu_torch.optimizers import tree_leaves

    if saved is None:
        raise ValueError("checkpoint holds no extra tree; re-save with save(..., extra=...)")
    got, want = tree_leaves(saved), tree_leaves(extra)
    if len(got) != len(want) or any(tuple(a.shape) != tuple(b.shape) for a, b in zip(got, want)):
        raise ValueError("the saved extra tree does not match the given one in shape")
    with torch.no_grad():
        for dst, src in zip(want, got):
            dst.copy_(src)


def _restore_optimizer(optimizer, payload, device, ctx=None) -> None:
    from bluefog_tpu_torch.optimizers import _WindowOptimizer

    wstate = payload.get("window")
    if wstate is None and isinstance(optimizer, _WindowOptimizer):
        raise ValueError(
            "checkpoint has no window state but the given optimizer is a window "
            "optimizer; re-save with save(..., optimizer=opt)"
        )
    if "opt_step_count" in payload:
        optimizer._step_count = int(payload["opt_step_count"])
    elif getattr(optimizer, "_step_count", None) is not None:
        raise ValueError(
            "checkpoint has no optimizer step counter but the given optimizer is "
            "step-indexed; re-save with save(..., optimizer=opt)"
        )
    if getattr(optimizer, "_comm_count", None) is not None:
        optimizer._comm_count = int(payload.get("opt_comm_count",
                                                payload.get("opt_step_count", 0)))
    if hasattr(optimizer, "_grad_accum"):
        accum = payload.get("grad_accum")
        optimizer._grad_accum = None if accum is None else [
            a.to(device) for a in _own_rows(accum, ctx)]
    if wstate is not None:
        name = getattr(optimizer, "_name", None)
        if name is None:
            raise ValueError(
                "checkpoint holds window state but the given optimizer has no window "
                "(call init() on a window optimizer before restore)"
            )
        win = win_mod._get_win(ctx_mod.get_context(), name)
        wstate = dict(wstate, **{f: _own_rows(wstate[f], ctx) for f in _WINDOW_LANES})
        for field in _WINDOW_LANES:
            saved, cur = wstate[field], getattr(win, field)
            if tuple(saved.shape) != tuple(cur.shape):
                raise ValueError(
                    f"window {field!r} shape {tuple(saved.shape)} does not match the "
                    f"live window {tuple(cur.shape)}; was the optimizer init()-ed with "
                    "the same parameters?"
                )
        for field in _WINDOW_LANES:
            setattr(win, field, wstate[field].to(device=device, dtype=getattr(win, field).dtype))
        for field in _WINDOW_AGE:
            setattr(win, field, wstate[field].numpy().copy())
        win.clock = int(wstate["clock"])
    ef_saved = payload.get("ef_state")
    if ef_saved is not None:
        # the copies and their signature: the optimizer compares the
        # signature with the step's own and zeroes the copies on a mismatch
        optimizer._ef = tuple(tuple(_own_rows(a, ctx, axis).to(device=device, dtype=torch.float32)
                                    for axis, a in enumerate(pair))
                              for pair in ef_saved)
        optimizer._ef_sig = ast.literal_eval(payload["ef_sig"]) + (device,)


def _reslice_sharded_state(info: dict, payload: dict, params, optimizer, device, ctx=None):
    """Re-slice a gathered sharded state under the current layout: a fresh
    ``optimizer.init(params)`` gives the structure, each gathered vector is
    distributed into it and every other leaf is installed as saved (across
    processes, this process's rows of each)."""
    from bluefog_tpu_torch.optimizers import _slice_slot_rows, _tree_unflatten, tree_leaves

    if optimizer is None:
        raise ValueError(
            "checkpoint holds sharded optimizer state; pass optimizer= so restore "
            "can re-slice it under the current shard layout"
        )
    if not (callable(getattr(optimizer, "_shard_active", None)) and optimizer._shard_active()):
        raise ValueError(
            "this checkpoint's optimizer state was saved under BLUEFOG_SHARD=1 "
            "(gathered, shard-portable) but the given optimizer is not sharding; "
            "set BLUEFOG_SHARD=1 on a gradient-allreduce optimizer to restore it"
        )
    ref_state = optimizer.init(params)
    layout = optimizer._shard_layout
    saved_groups = [(str(g[0]), int(g[1])) for g in info["groups"]]
    cur_groups = [(g.dtype, g.elems) for g in layout.groups]
    if saved_groups != cur_groups:
        raise ValueError(
            f"sharded checkpoint was saved for dtype groups {saved_groups} but the "
            f"live parameters pack into {cur_groups}; was the optimizer init()-ed "
            "with the same parameters?"
        )
    if bool(info["master"]) != bool(layout.master):
        raise ValueError(
            f"sharded checkpoint was saved with BLUEFOG_SHARD_MASTER="
            f"{int(info['master'])} but the live setting is {int(layout.master)}; "
            "restore under the same master-param mode"
        )
    leaves = tree_leaves(ref_state)
    if len(leaves) != int(info["n_leaves"]):
        raise ValueError(
            f"sharded checkpoint has {info['n_leaves']} state leaves but the live "
            f"optimizer builds {len(leaves)}; inner transformation changed since save"
        )
    slot_map = {int(i): int(gi) for i, gi in info["slot_leaves"]}
    saved = payload["opt_state"]
    out = []
    for i, ref in enumerate(leaves):
        arr = saved[f"leaf_{i:03d}"].to(ref.dtype)
        gi = slot_map.get(i)
        if gi is not None:
            arr = _slice_slot_rows(arr, layout, gi)
        arr = _own_rows(arr, ctx)
        if gi is None and tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"saved state leaf {i} has shape {tuple(arr.shape)} but the live "
                f"optimizer expects {tuple(ref.shape)}"
            )
        out.append(arr.to(device))
    return _tree_unflatten(ref_state, out)
