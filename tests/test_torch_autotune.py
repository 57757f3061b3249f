# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""The port's topology controller (``bft.autotune``) against the JAX
package's ``bf.autotune``, case by case as ``tests/test_autotune.py`` runs
the JAX module, on the same inputs.

Both packages start from the ring on 8 workers (the JAX side on its
8-device CPU mesh, ``BLUEFOG_WIRE_KERNELS=0`` where an optimizer runs) with
the same pinned cost model, ``compiler.set_calibration(1e-5, 1e9)``, and
both controllers are fed the same triggers and the same step clock, in
lockstep. Tolerances:

- the decision sequences are EQUAL: actions, ``chosen``, ``blamed``,
  triggers, hysteresis, ``comm_steps``, the topology-version deltas, the
  verification verdicts and the samples; the recorded (rounded) candidate
  numbers within 1e-9 relative;
- the unrounded objectives, rates and step costs (``score_candidate`` with
  its rounding switched off on both sides) within 1e-9 relative;
- the installed ``mixing_matrix(load_topology())`` BITWISE JAX's after
  every observed step, so after every swap and rollback.

The closed loop (the doctor detects an injected ``degrade`` fault, the
controller migrates the live optimizer) is held to JAX's invariants, not to
JAX's timings: the doctor's cost model is pinned at alpha 2 ms on the
stacked class (a probe crossing the degraded edge sleeps 38 ms more than its
peers) and the step clock is pinned, as JAX's test pins it; the swap it
records is replayed through JAX's ``score_candidate``. The three artifact
tools of ``tools/`` run unchanged on the port's dump and JSONL. Two cases
are the port's own: the controller on at interval 1 on a quiet fabric
changes no bit of either dispatch path and adds no ``op_cache`` entry, and a
swap onto ``int8_ef`` starts fresh CHOCO copies whose next step equals
JAX's.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import optax
import pytest
import torch

import bluefog_tpu as bf
import bluefog_tpu.topology as jtu
import bluefog_tpu_torch as bft
from bluefog_tpu import attribution as jattribution
from bluefog_tpu import autotune as jautotune
from bluefog_tpu import health as jhealth
from bluefog_tpu import metrics as jmetrics
from bluefog_tpu.collective import compiler as jcompiler
from bluefog_tpu.elastic import repair as jrepair
from bluefog_tpu_torch import attribution, autotune, flight, health, interop, logging_util
from bluefog_tpu_torch import metrics
from bluefog_tpu_torch import topology as tu
from bluefog_tpu_torch.collective import compiler
from bluefog_tpu_torch.elastic import repair as repair_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8
REL = 1e-9
PIN = (1e-5, 1e9)
# the doctor's pinned probe model in the closed loop (tests/test_torch_doctor.py)
DOCTOR_PIN = (2e-3, 1e12, 0.0)

TRIG = [{"kind": "degraded_link", "source": "doctor",
         "edge": [2, 3], "ratio": 20.0}]

ENV = ("BLUEFOG_AUTOTUNE", "BLUEFOG_AUTOTUNE_INTERVAL", "BLUEFOG_AUTOTUNE_FILE",
       "BLUEFOG_AUTOTUNE_DRY_RUN", "BLUEFOG_AUTOTUNE_COOLDOWN", "BLUEFOG_AUTOTUNE_WIRE",
       "BLUEFOG_AUTOTUNE_DEGREES", "BLUEFOG_DOCTOR", "BLUEFOG_HEALTH", "BLUEFOG_METRICS",
       "BLUEFOG_PODS")


@pytest.fixture(autouse=True)
def contexts(cpu_devices, monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BLUEFOG_WIRE_KERNELS", "0")
    metrics.reset()
    jmetrics.reset()
    compiler.set_calibration(*PIN, source="test-pin")
    jcompiler.set_calibration(*PIN, source="test-pin")
    bf.init(devices=cpu_devices[:SIZE], topology_fn=lambda n: jtu.RingGraph(n))
    bft.init(device="cpu", topology_fn=tu.RingGraph)
    yield
    for mod in (autotune, jautotune, attribution, jattribution, health, jhealth):
        mod.stop()
    bft.elastic.stop()
    bf.elastic.stop()
    bf.shutdown()
    if bft.is_initialized():
        bft.shutdown()
    compiler.clear_calibration()
    jcompiler.clear_calibration()
    metrics.reset()
    jmetrics.reset()


# -- comparison helpers ---------------------------------------------------------------


def _close(a, b, path="$"):
    """Equal structure and values; floats within ``REL`` relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool) and isinstance(b, (int, float)):
        assert a == pytest.approx(b, rel=REL, abs=0), (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def _same_matrix():
    """The installed combine matrices, bitwise."""
    w = tu.mixing_matrix(bft.load_topology())
    jw = jtu.mixing_matrix(bf.load_topology())
    np.testing.assert_array_equal(w.view(np.uint64), jw.view(np.uint64))
    return w


def _normalized(tuner, v0):
    """A tuner's history with its topology versions relative to ``v0``."""
    decisions = []
    for d in tuner.decisions:
        r = d.to_json()
        r["topo_version_before"] -= v0
        r["topo_version_after"] -= v0
        decisions.append(r)
    samples = [dict(s, topo_version=s["topo_version"] - v0) for s in tuner.samples]
    return {"decisions": decisions, "verifications": list(tuner.verifications),
            "samples": samples, "summary": tuner.summary()}


def _same_history(tuners, v0s):
    _close(_normalized(tuners[0], v0s[0]), _normalized(tuners[1], v0s[1]))


def _drive_both(tuners, steps, step_s=0.01, triggers=None, step_s_fn=None, opts=(None, None)):
    """Feed the port's and JAX's tuner in lockstep; after every step the
    returned records agree and the installed matrices are bitwise equal.
    Returns the port's records."""
    ctxs = (bft.get_context(), bf.get_context())
    v0s = (ctxs[0].topo_version, ctxs[1].topo_version)
    out = []
    for t in range(steps):
        recs = []
        for tuner, ctx, opt in zip(tuners, ctxs, opts):
            s = step_s_fn(t, tuner) if step_s_fn is not None else step_s
            trig = triggers(t) if callable(triggers) else triggers
            recs.append(tuner.observe(ctx, step=t, optimizer=opt, step_s=s, triggers=trig))
        assert (recs[0] is None) == (recs[1] is None), t
        if recs[0] is not None:
            out.append(recs[0])
        for d in tuners[0].decisions:
            if d.action in ("swap", "rollback"):
                assert d.topo_version_after > d.topo_version_before, d.to_json()
        _same_matrix()
        assert ctxs[0].topo_version - v0s[0] == ctxs[1].topo_version - v0s[1]
    _same_history(tuners, v0s)
    return out


def _start_both(**kw):
    return autotune.start(**kw), jautotune.start(**kw)


def _unrounded(monkeypatch):
    """Switch the record's rounding off in both scorers."""
    for mod in (autotune, jautotune):
        monkeypatch.setattr(mod, "round", lambda x, n=None: x, raising=False)


def _score_both(cand, jcand, payload, factors, monkeypatch):
    """The recorded score (equal) and the unrounded one (within REL)."""
    s = autotune.score_candidate(cand, payload, factors)
    _close(s, jautotune.score_candidate(jcand, payload, factors))
    with monkeypatch.context() as m:
        _unrounded(m)
        _close(autotune.score_candidate(cand, payload, factors),
               jautotune.score_candidate(jcand, payload, factors))
    return s


# -- pure scoring -----------------------------------------------------------------------


@pytest.mark.parametrize("factors", [
    {(2, 3): 0.05},
    {(2, 3): 0.5, (5, 4): 0.2, (1, 0): 0.0},
    {(3, 3): 0.1, (9, 1): 0.3, (1, 2): 1.5, (6, 7): -1.0},
], ids=["one", "three", "ignored"])
def test_degraded_matrix_moves_lost_mass_to_receiver_diagonal(factors):
    """The lossy-link discount, bitwise JAX's: edge (s, d) at factor f
    delivers f of its weight and the receiver keeps the rest; column sums
    are preserved; self edges, out-of-range ranks and factors clamp as in
    JAX."""
    w = tu.mixing_matrix(tu.RingGraph(SIZE))
    np.testing.assert_array_equal(w, jtu.mixing_matrix(jtu.RingGraph(SIZE)))
    out = autotune.degraded_matrix(w, factors)
    np.testing.assert_array_equal(out.view(np.uint64),
                                  jautotune.degraded_matrix(w, factors).view(np.uint64))
    np.testing.assert_allclose(out.sum(axis=0), w.sum(axis=0))
    if factors == {(2, 3): 0.05}:
        assert out[2, 3] == pytest.approx(0.05 * w[2, 3])
        assert out[3, 3] == pytest.approx(w[3, 3] + 0.95 * w[2, 3])
        assert tu.consensus_decay_rate(out) > tu.consensus_decay_rate(w)


def test_scoring_charges_blamed_edges_and_prefers_exclusion(monkeypatch):
    """A candidate still carrying the blamed edge pays the doctor's penalty;
    at a heavy degrade the ring minus the edge beats the degraded ring.
    Both scores equal JAX's."""
    w = tu.mixing_matrix(tu.RingGraph(SIZE))
    factors = {(2, 3): 0.05}
    cur = _score_both({"name": "current", "matrix": w}, {"name": "current", "matrix": w},
                      1e8, factors, monkeypatch)
    masked = w.copy()
    masked[2, 3] = masked[3, 2] = 0.0
    rep = repair_mod.repaired_matrix(masked, range(SIZE), policy="average")
    jrep = jrepair.repaired_matrix(masked, range(SIZE), policy="average")
    np.testing.assert_array_equal(rep, jrep)
    excl = _score_both({"name": "excl", "matrix": rep}, {"name": "excl", "matrix": jrep},
                       1e8, factors, monkeypatch)
    assert cur["objective_s"] is not None
    assert excl["objective_s"] < cur["objective_s"]
    assert cur["step_cost_ms"] > excl["step_cost_ms"]
    assert compiler.degraded_round_penalty_s(1e8, 0.05) == \
        pytest.approx(19.0 * compiler.round_cost_s(1e8))
    assert compiler.degraded_round_penalty_s(1e8, 0.05) == \
        jcompiler.degraded_round_penalty_s(1e8, 0.05)
    assert compiler.degraded_round_penalty_s(1e8, 1.0) == 0.0


def test_scoring_disconnected_candidate_never_wins(monkeypatch):
    w = np.zeros((4, 4))
    w[:2, :2] = 0.5
    w[2:, 2:] = 0.5
    scored = _score_both({"name": "broken", "matrix": w}, {"name": "broken", "matrix": w},
                         1e6, {}, monkeypatch)
    assert scored["objective_s"] is None
    assert scored["tts_steps"] is None


def test_schedule_candidate_scores_period_product(monkeypatch):
    """The one-peer schedule of Exp2(8): the same period matrices as JAX's,
    the period-product rate, cheaper steps and a better objective than the
    static Exp2."""
    mats = tu.one_peer_period_matrices(tu.ExponentialTwoGraph(SIZE))
    jmats = jtu.one_peer_period_matrices(jtu.ExponentialTwoGraph(SIZE))
    assert len(mats) == len(jmats)
    for m, jm in zip(mats, jmats):
        np.testing.assert_array_equal(m, jm)
    scored = _score_both({"name": "one_peer", "mats": mats}, {"name": "one_peer", "mats": jmats},
                         1e6, {}, monkeypatch)
    assert scored["kind"] == "schedule"
    assert scored["period"] == len(mats)
    assert 0 < scored["rate"] < 1
    assert scored["rate"] == pytest.approx(tu.consensus_decay_rate(mats), abs=1e-6)
    e = tu.mixing_matrix(tu.ExponentialTwoGraph(SIZE))
    static = _score_both({"name": "exp2", "matrix": e}, {"name": "exp2", "matrix": e}, 1e6, {},
                         monkeypatch)
    assert scored["step_cost_ms"] < static["step_cost_ms"]
    assert scored["objective_s"] < static["objective_s"]


def test_wire_tier_crossing_prices_sidecar_inclusive_bytes(monkeypatch):
    """``BLUEFOG_AUTOTUNE_WIRE`` crosses every candidate with the listed
    tiers: the candidate lists (names, matrices, wires, eligibility) and
    their scores equal JAX's; int4_ef ships half int8_ef's bytes."""
    monkeypatch.setenv("BLUEFOG_AUTOTUNE_WIRE", "int8_ef,int4_ef,bogus")
    assert autotune.wire_tiers() == jautotune.wire_tiers() == ("int8_ef", "int4_ef")
    cands = autotune.TopologyAutotuner(interval=1)._candidates(bft.get_context(), None, {})
    jcands = jautotune.TopologyAutotuner(interval=1)._candidates(bf.get_context(), None, {})
    assert [c["name"] for c in cands] == [c["name"] for c in jcands]
    for c, jc in zip(cands, jcands):
        assert (c.get("wire"), c["eligible"], list(c["live"])) == \
            (jc.get("wire"), jc["eligible"], list(jc["live"]))
        for key in ("matrix", "mats"):
            if key in c:
                np.testing.assert_array_equal(np.asarray(c[key]), np.asarray(jc[key]))
        _score_both(c, jc, 4096 * 4.0, {}, monkeypatch)
    names = {c["name"] for c in cands}
    assert "ring|int4_ef" in names and "ring|int8_ef" in names
    s8, s4 = (autotune.score_candidate(next(c for c in cands if c["name"] == n), 4096 * 4.0, {})
              for n in ("ring|int8_ef", "ring|int4_ef"))
    assert s4["wire_bytes"] * 2 == s8["wire_bytes"]
    assert s4["objective_s"] < s8["objective_s"]


@pytest.mark.parametrize("size,exc", [(6, None), (8, ValueError), (8, AssertionError),
                                      (8, ZeroDivisionError)],
                         ids=["size6", "ValueError", "AssertionError", "ZeroDivisionError"])
def test_candidates_skip_a_generator_that_refuses_the_size(size, exc, cpu_devices, monkeypatch):
    """A generator that refuses the size with ``AssertionError``,
    ``ValueError`` or ``ZeroDivisionError`` (the port raises ``ValueError``
    where JAX asserts) is skipped, not raised, on both sides; the lists
    (names, matrices, eligibility) are JAX's, also at a size off a power of
    two (6, where Exp2 is still a candidate in both packages)."""
    if exc is not None:
        def refuse(n):
            raise exc("refused")

        monkeypatch.setattr(tu, "MeshGrid2DGraph", refuse)
        monkeypatch.setattr(jtu, "MeshGrid2DGraph", refuse)
    bf.init(devices=cpu_devices[:size], topology_fn=lambda n: jtu.RingGraph(n))
    bft.init(size=size, device="cpu", topology_fn=tu.RingGraph)
    cands = autotune.TopologyAutotuner(interval=1)._candidates(bft.get_context(), None,
                                                               {(2, 3): 0.05})
    jcands = jautotune.TopologyAutotuner(interval=1)._candidates(bf.get_context(), None,
                                                                 {(2, 3): 0.05})
    names = [c["name"] for c in cands]
    assert names == [c["name"] for c in jcands]
    assert ("mesh" in names) is (exc is None) and "exp2" in names
    for c, jc in zip(cands, jcands):
        assert c["eligible"] == jc["eligible"]
        for key in ("matrix", "mats"):
            if key in c:
                np.testing.assert_array_equal(np.asarray(c[key]), np.asarray(jc[key]))


def test_window_optimizers_are_scored_but_never_migrated():
    """A window optimizer (``mode`` put/get/push_sum) carries create-time
    buffers: every candidate but the incumbent is ineligible, as in JAX, so
    a persistent trigger records holds and migrates nothing."""
    import types

    opt = types.SimpleNamespace(mode="put")
    cands = autotune.TopologyAutotuner(interval=1)._candidates(bft.get_context(), opt,
                                                               {(2, 3): 0.05})
    jcands = jautotune.TopologyAutotuner(interval=1)._candidates(bf.get_context(), opt,
                                                                 {(2, 3): 0.05})
    assert [(c["name"], c["eligible"]) for c in cands] == \
        [(c["name"], c["eligible"]) for c in jcands]
    assert [c["name"] for c in cands if c["eligible"]] == ["current"]
    tuners = _start_both(interval=1, cooldown=4)
    _drive_both(tuners, 6, triggers=TRIG, opts=(opt, opt))
    assert tuners[0].swaps == 0 and {d.action for d in tuners[0].decisions} == {"hold"}


def test_payload_estimate_tracks_wire_counter():
    """The payload estimate follows the wire-byte counter (bytes since the
    last sample / steps / rounds), on both packages alike."""
    tuners = _start_both(interval=1, cooldown=4)
    wires = []
    for mod in (metrics, jmetrics):
        mod.gauge("bluefog.gossip.rounds").set(2)
        wires.append(mod.counter("bluefog.wire_bytes"))
        wires[-1].inc(1000.0)
    _drive_both(tuners, 2, triggers=[])
    for w in wires:
        w.inc(4000.0)
    _drive_both(tuners, 2, triggers=TRIG)
    for tuner in tuners:
        d = tuner.decisions[0]
        assert d.predicted["payload_bytes"] == 2000, d.predicted
        assert d.predicted["payload_bytes"] != int(compiler.DEFAULT_PAYLOAD_BYTES)


def test_cooldown_env_floored_at_refire_window(monkeypatch):
    for mod in (autotune, jautotune):
        monkeypatch.setenv("BLUEFOG_AUTOTUNE_COOLDOWN", "2")
        assert mod.cooldown_samples() == mod.COOLDOWN_SAMPLES
        monkeypatch.setenv("BLUEFOG_AUTOTUNE_COOLDOWN", "20")
        assert mod.cooldown_samples() == 20
        assert mod.TopologyAutotuner(interval=1, cooldown=3).cooldown == 3
    for name in ("TRIGGER_STREAK", "TRIGGER_QUIET_RESET", "MIN_GAIN_FRAC", "COOLDOWN_SAMPLES",
                 "ROLLBACK_FRAC", "VERIFY_SAMPLES", "EPS_RATIO", "MAX_SCHEDULE_PERIOD",
                 "_DEFAULT_SAFE_TIERS", "_ALL_TIERS"):
        assert getattr(autotune, name) == getattr(jautotune, name), name
    monkeypatch.setenv("BLUEFOG_AUTOTUNE_DEGREES", "3,x,0,3,4")
    monkeypatch.setenv("BLUEFOG_AUTOTUNE_INTERVAL", "7")
    monkeypatch.setenv("BLUEFOG_AUTOTUNE_DRY_RUN", "on")
    assert autotune.candidate_degrees() == jautotune.candidate_degrees() == (3, 4)
    assert autotune.autotune_interval() == jautotune.autotune_interval() == 7
    assert autotune.dry_run_enabled() is jautotune.dry_run_enabled() is True


# -- guardrails on the deterministic step clock ----------------------------------------


@pytest.mark.chaos
def test_transient_blip_never_swaps():
    """A trigger at one sample only: no search, no decision, on both."""
    tuners = _start_both(interval=1, cooldown=4)
    v0 = bft.get_context().topo_version
    _drive_both(tuners, 12, triggers=lambda t: TRIG if t == 3 else [])
    assert tuners[0].decisions == [] and tuners[0].swaps == 0
    assert bft.get_context().topo_version == v0


@pytest.mark.chaos
def test_persistent_degrade_swaps_once_and_excludes_edge():
    """A persistent degrade migrates exactly once, to the candidate JAX
    chooses, whose installed matrix (bitwise JAX's) down-weights the blamed
    edge."""
    tuners = _start_both(interval=1, cooldown=4)
    w_before = _same_matrix().copy()
    _drive_both(tuners, 16, triggers=TRIG)
    tuner = tuners[0]
    assert tuner.swaps == 1
    swap = next(d for d in tuner.decisions if d.action == "swap")
    assert [2, 3] in swap.blamed
    assert swap.triggers[0]["kind"] == "degraded_link"
    assert swap.topo_version_after > swap.topo_version_before
    w_after = _same_matrix()
    assert w_after[2, 3] < w_before[2, 3]
    assert swap.predicted["gain_frac"] > autotune.MIN_GAIN_FRAC


@pytest.mark.chaos
def test_dry_run_fires_once_per_cooldown_with_zero_migrations():
    tuners = _start_both(interval=1, cooldown=3, dry_run=True)
    v0 = bft.get_context().topo_version
    _drive_both(tuners, 14, triggers=TRIG)
    tuner = tuners[0]
    assert bft.get_context().topo_version == v0
    assert tuner.swaps == 0
    acts = [d.action for d in tuner.decisions]
    assert acts and all(a == "dry_run_swap" for a in acts)
    marks = [d.comm_steps for d in tuner.decisions]
    assert all(b - a == 3 for a, b in zip(marks, marks[1:])), marks
    assert all(any(c["name"] == "current" for c in d.candidates) for d in tuner.decisions)


@pytest.mark.chaos
def test_regressing_swap_rolls_back_and_blocklists():
    """A delivered step 5x the baseline rolls the swap back: the ring
    restored bitwise (and bitwise JAX's) under a fresh version, the
    regressed candidate blocklisted, as on JAX."""
    tuners = _start_both(interval=1, cooldown=4)
    ring_w = tu.mixing_matrix(tu.RingGraph(SIZE))
    _drive_both(tuners, 6, step_s_fn=lambda t, tuner: 0.01 if tuner.swaps == 0 else 0.05,
                triggers=TRIG)
    tuner = tuners[0]
    assert tuner.rollbacks == 1
    v = tuner.verifications[0]
    assert v["verdict"] == "regressed" and v["rolled_back"] is True and v["step_regressed"]
    rb = next(d for d in tuner.decisions if d.action == "rollback")
    assert rb.topo_version_after > rb.topo_version_before
    np.testing.assert_array_equal(_same_matrix().view(np.uint64), ring_w.view(np.uint64))
    swap = next(d for d in tuner.decisions if d.action == "swap")
    assert swap.chosen in tuner._blocked
    assert tuner._blocked == tuners[1]._blocked


@pytest.mark.chaos
def test_delivered_swap_is_kept():
    tuners = _start_both(interval=1, cooldown=4)
    _drive_both(tuners, 8, step_s=0.01, triggers=TRIG)
    tuner = tuners[0]
    assert tuner.swaps == 1 and tuner.rollbacks == 0
    assert tuner.verifications[0]["verdict"] == "delivered"
    assert tuner.verifications[0]["rolled_back"] is False


# -- the real closed loop ----------------------------------------------------------------


@pytest.mark.chaos
def test_closed_loop_doctor_detects_controller_migrates():
    """An injected degrade slows the doctor's probes of edge 2 -> 3; its
    ``degraded_link`` advisory names the edge from timings alone; the
    controller harvests it and migrates the live optimizer through the
    elastic session: zero stale dispatches, finite parameters, the blamed
    edge down-weighted. The swap's candidates, scored again through JAX's
    ``score_candidate`` from the record's factors and payload, give JAX's
    numbers and JAX's choice."""
    compiler.set_calibration(*DOCTOR_PIN, link_class=compiler.TRANSPORT_LINK_CLASS)
    ctx = bft.get_context()
    session = bft.elastic.start(policy="average")
    session.inject("degrade", rank=2, step=0, factor=0.05, peer=3)
    attribution.start(interval=1)
    tuner = autotune.TopologyAutotuner(interval=1, cooldown=8)
    seen = []
    search = tuner._candidates

    def recorded(c, o, factors):
        cands = search(c, o, factors)
        seen.append((dict(factors), cands))
        return cands

    tuner._candidates = recorded
    rng = np.random.RandomState(0)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.05))
    guard = bft.elastic.guard(opt)
    params = {"w": torch.from_numpy(np.stack([rng.randn(2048).astype(np.float32)
                                              for _ in range(SIZE)]))}
    state = opt.init(params)
    zeros = {"w": torch.zeros(SIZE, 2048)}
    w_before = tu.mixing_matrix(bft.load_topology()).copy()
    for t in range(12):
        params, state = guard.step(params, state, zeros)
        tuner.observe(ctx, step=t, optimizer=opt, step_s=0.01)
    assert any(a.kind == "degraded_link" and a.detail.get("edge") == [2, 3]
               for a in attribution.active().advisories)
    assert tuner.swaps >= 1
    assert tuner.rollbacks == 0
    swap = next(d for d in tuner.decisions if d.action == "swap")
    assert any(t.get("edge") == [2, 3] for t in swap.triggers), swap.triggers
    w_after = tu.mixing_matrix(bft.load_topology())
    assert w_after[2, 3] < w_before[2, 3]
    assert session.stale_dispatches == 0
    assert bool(np.all(np.isfinite(params["w"].numpy())))
    # the swap replayed through JAX's scorer
    factors, cands = seen[swap.seq]
    assert swap.blamed == [[s, d] for (s, d) in sorted(factors)]
    payload = swap.predicted["payload_bytes"]
    replay = [jautotune.score_candidate(c, payload, factors) for c in cands]
    _close(swap.candidates, replay)
    best = min((s for s in replay if s["eligible"] and s["objective_s"] is not None
                and s["name"] != "current"), key=lambda s: s["objective_s"])
    assert swap.chosen == best["name"]


@pytest.mark.chaos
def test_migration_respects_dead_ranks():
    """After a kill and its repair, a migration installs a matrix (bitwise
    JAX's) whose dead slot stays isolated, and dispatches stay clean."""
    sessions, guards, params, states, opts = [], [], [], [], []
    rng = np.random.RandomState(0)
    x0 = np.stack([rng.randn(1024).astype(np.float32) for _ in range(SIZE)])
    for side in ("port", "jax"):
        el = bft.elastic if side == "port" else bf.elastic
        session = el.start(policy="average")
        session.inject("kill", rank=5, step=1)
        if side == "port":
            opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.05))
            p = {"w": torch.from_numpy(x0.copy())}
        else:
            opt = bf.DistributedNeighborAllreduceOptimizer(optax.sgd(0.05))
            p = {"w": bf.worker_values(lambda r: x0[r])}
        sessions.append(session)
        opts.append(opt)
        guards.append(el.guard(opt))
        params.append(p)
        states.append(opt.init(p))
    zeros = ({"w": torch.zeros(SIZE, 1024)},
             {"w": bf.worker_values(lambda r: np.zeros(1024, np.float32))})

    def steps(n):
        for i in range(2):
            for _ in range(n):
                params[i], states[i] = guards[i].step(params[i], states[i], zeros[i])

    steps(4)
    for s in sessions:
        assert s.membership.dead_ranks() == (5,)
    _same_matrix()
    tuners = _start_both(interval=1, cooldown=4)
    _drive_both(tuners, 6, triggers=TRIG)
    assert tuners[0].swaps == 1
    w = _same_matrix()
    assert w[5, 5] == pytest.approx(1.0)
    assert np.count_nonzero(w[5, :]) == 1
    assert np.count_nonzero(w[:, 5]) == 1
    steps(2)
    assert sessions[0].stale_dispatches == 0 == sessions[1].stale_dispatches
    np.testing.assert_allclose(params[0]["w"].numpy(), np.asarray(params[1]["w"]),
                               rtol=0, atol=1e-6 * np.abs(x0).max())


# -- audit surfaces ------------------------------------------------------------------------


@pytest.mark.chaos
def test_decision_reaches_every_surface(tmp_path, monkeypatch):
    """One swap lands in the metrics, the flight ring and its side table,
    the JSONL and the health plane's ``/fleet`` block; the JSONL's
    decisions and verifications equal JAX's."""
    paths = (tmp_path / "port.jsonl", tmp_path / "jax.jsonl")
    health.start(interval=1)
    jhealth.start(interval=1)
    tuners = _start_both(interval=1, cooldown=4)
    ctxs = (bft.get_context(), bf.get_context())
    for t in range(8):
        for tuner, ctx, path in zip(tuners, ctxs, paths):
            monkeypatch.setenv("BLUEFOG_AUTOTUNE_FILE", str(path))
            tuner.observe(ctx, step=t, step_s=0.01, triggers=TRIG)
    tuner = tuners[0]
    assert tuner.swaps == 1
    snap = metrics.snapshot()
    assert snap["bluefog.autotune.decisions"]["value"] >= 1
    assert snap["bluefog.autotune.action.swap"]["value"] == 1
    assert "bluefog.autotune.objective_s" in snap
    jsnap = jmetrics.snapshot()
    for name in ("bluefog.autotune.decisions", "bluefog.autotune.action.swap",
                 "bluefog.autotune.action.hold", "bluefog.autotune.samples",
                 "bluefog.autotune.verifications", "bluefog.autotune.objective_s",
                 "bluefog.autotune.predicted_gain", "bluefog.autotune.last_decision_step"):
        assert (name in snap) == (name in jsnap), name
        if name in snap:
            assert snap[name]["value"] == jsnap[name]["value"], name
    dump = flight._build_dump("test")
    assert any(d.get("action") == "swap" for d in dump["autotune_decisions"])
    assert any(e["kind"] == "autotune" for e in dump["events"])
    rows = [json.loads(line) for line in paths[0].read_text().splitlines()]
    jrows = [json.loads(line) for line in paths[1].read_text().splitlines()]
    kinds = {r["kind"] for r in rows}
    assert "decision" in kinds and "verification" in kinds
    dec = next(r for r in rows if r["kind"] == "decision")
    assert dec["candidates"] and dec["triggers"]
    strip = ("ts", "topo_version_before", "topo_version_after")
    _close([{k: v for k, v in r.items() if k not in strip} for r in rows],
           [{k: v for k, v in r.items() if k not in strip} for r in jrows])
    rep = health.active().report()
    assert rep["autotune"]["swaps"] == 1
    assert rep["autotune"]["last_action"] in ("swap", "hold", "rollback")
    assert rep["autotune"] == jhealth.active().report()["autotune"]


def test_autotune_file_bad_directory_warns_once(monkeypatch):
    """A ``BLUEFOG_AUTOTUNE_FILE`` in a directory that does not exist warns
    once (the port's ``warn_once`` is a ``UserWarning``), and the failure
    never eats a decision."""
    logging_util._warned_once.clear()
    monkeypatch.setenv("BLUEFOG_AUTOTUNE_FILE", "/nonexistent-dir-autotune/decisions.jsonl")
    tuner = autotune.start(interval=1, cooldown=3)
    with warnings.catch_warnings(record=True) as fired:
        warnings.simplefilter("always")
        for t in range(8):
            tuner.observe(bft.get_context(), step=t, step_s=0.01, triggers=TRIG)
    warned = [w for w in fired if autotune.FILE_ENV in str(w.message)]
    assert len(warned) == 1, [str(w.message) for w in fired]
    assert tuner.decisions


# -- artifact tools ------------------------------------------------------------------------


def _make_history(tmp_path, monkeypatch):
    path = tmp_path / "autotune.jsonl"
    monkeypatch.setenv("BLUEFOG_AUTOTUNE_FILE", str(path))
    tuner = autotune.start(interval=1, cooldown=4)
    for t in range(8):
        tuner.observe(bft.get_context(), step=t, step_s=0.01, triggers=TRIG)
    dump_path = tmp_path / "autotune_dump.json"
    assert autotune.dump(str(dump_path)) == str(dump_path)
    monkeypatch.delenv("BLUEFOG_AUTOTUNE_FILE")
    return tuner, str(path), str(dump_path)


def test_autotune_report_reconstructs_from_artifacts(tmp_path, monkeypatch):
    """``tools/autotune_report.py`` rebuilds the port's history from its
    dump and its JSONL, without double counting both together."""
    sys.path.insert(0, REPO)
    from tools import autotune_report

    tuner, jsonl, dump = _make_history(tmp_path, monkeypatch)
    for src in (dump, jsonl):
        rep = autotune_report.build_report([src])
        assert rep["decisions"] == len(tuner.decisions)
        assert rep["actions"].get("swap") == 1
        swap = next(h for h in rep["history"] if h["action"] == "swap")
        assert swap["verification"]["verdict"] == "delivered"
        assert any("SWAP" in s for s in rep["summary"])
    both = autotune_report.build_report([dump, jsonl])
    assert both["decisions"] == len(tuner.decisions)
    assert both["actions"].get("swap") == 1
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "autotune_report.py"),
                           dump], capture_output=True, text=True, timeout=60, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-500:]
    assert "decision #0" in proc.stdout


def test_doctor_cli_folds_autotune_history(tmp_path, monkeypatch):
    """``tools/doctor.py --autotune`` joins the port's decisions into the
    triage; an unreadable artifact degrades."""
    sys.path.insert(0, REPO)
    from tools import doctor as doctor_mod

    _tuner, _jsonl, dump = _make_history(tmp_path, monkeypatch)
    compiler.set_calibration(*DOCTOR_PIN, link_class=compiler.TRANSPORT_LINK_CLASS)
    attribution.start(interval=1)
    doc_dump = tmp_path / "doctor.json"
    attribution.active().dump(str(doc_dump))
    report = doctor_mod.triage(doctor_mod.load_attribution(str(doc_dump)), [], [],
                               autotune=[dump])
    assert report["autotune"]["decisions"] >= 1
    assert report["autotune"]["actions"].get("swap") == 1
    assert any("autotune" in s for s in report["summary"])
    degraded = doctor_mod.triage(doctor_mod.load_attribution(str(doc_dump)), [], [],
                                 autotune=[str(tmp_path / "missing.json")])
    assert degraded["autotune"]["unreadable"]


def test_fleet_report_carries_decision_columns(tmp_path, monkeypatch):
    """``tools/fleet_report.py`` reads the port's health report with its
    ``autotune`` block (the decision columns), and one without it as
    absent."""
    sys.path.insert(0, REPO)
    from tools import fleet_report

    plane = health.start(interval=1)
    tuner = autotune.start(interval=1, cooldown=4)
    ctx = bft.get_context()
    for t in range(8):
        tuner.observe(ctx, step=t, step_s=0.01,
                      triggers=TRIG if t < 6 else [])
    with_block = plane.report()
    assert with_block["autotune"] == tuner.summary()
    autotune.stop()
    without = plane.report()
    assert "autotune" not in without
    p1, p2 = tmp_path / "a.json", tmp_path / "b.json"
    p1.write_text(json.dumps(with_block))
    p2.write_text(json.dumps(without))
    report = fleet_report.build_report(
        [fleet_report.load_artifact(str(p1)), fleet_report.load_artifact(str(p2))],
        [str(p1), str(p2)])
    r1, r2 = report["processes"]
    assert r1["autotune"] == "active"
    assert r1["autotune_last_action"] == tuner.last_action
    assert r1["autotune_decisions"] == len(tuner.decisions)
    assert r1["autotune_rollbacks"] == tuner.rollbacks
    assert r2["autotune"] == "absent"
    assert r2["autotune_last_action"] is None


# -- the port's own cases ------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["two-program", "make_train_step"])
def test_controller_on_quiet_fabric_is_bitwise_off(fused, monkeypatch):
    """``BLUEFOG_AUTOTUNE=1`` at interval 1 (set before ``bft.init``), no
    fault: the dispatch hook samples every step, decides nothing, adds no
    ``op_cache`` entry, moves no topology version, and the parameters and
    momentum are bitwise those of the controller off."""
    rng = np.random.RandomState(3)
    x0 = rng.randn(SIZE, 4096).astype(np.float32)
    target = rng.randn(SIZE, 4096).astype(np.float32)

    def run(on):
        if on:
            monkeypatch.setenv("BLUEFOG_AUTOTUNE", "1")
            monkeypatch.setenv("BLUEFOG_AUTOTUNE_INTERVAL", "1")
        else:
            monkeypatch.delenv("BLUEFOG_AUTOTUNE", raising=False)
        bft.init(device="cpu", topology_fn=tu.ExponentialTwoGraph, is_weighted=True)
        ctx = bft.get_context()
        v0 = ctx.topo_version
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = "int8"
        params = {"w": torch.from_numpy(x0.copy())}
        state = opt.init(params)
        y = torch.from_numpy(target)
        loss_fn = lambda p, t: 0.5 * torch.sum((p["w"] - t) ** 2)  # noqa: E731
        step = opt.make_train_step(loss_fn) if fused else None
        for _ in range(3):
            if fused:
                params, state, _loss = step(params, state, y)
            else:
                params, state = opt.step(params, state, {"w": params["w"] - y})
        tuner = autotune.active()
        return (params["w"].clone(), [s.clone() for s in torch.utils._pytree.tree_leaves(state)],
                set(ctx.op_cache), ctx.topo_version - v0, tuner)

    off = run(False)
    on = run(True)
    assert off[4] is None and on[4] is not None
    assert torch.equal(on[0].view(torch.int32), off[0].view(torch.int32))
    assert len(on[1]) == len(off[1])
    for a, b in zip(on[1], off[1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert on[2] == off[2]
    assert on[3] == off[3] == 0
    assert len(on[4].samples) == 3 and on[4].decisions == []


def test_swap_to_int8_ef_starts_fresh_copies_equal_jax(monkeypatch):
    """Under ``BLUEFOG_AUTOTUNE_WIRE=int8_ef`` an int4_ef run migrates to a
    candidate carrying ``int8_ef`` (JAX's choice): the old tier's CHOCO
    copies are dropped and the next step starts from zeroed copies. From the
    same parameters, that step equals JAX's: the parameters and the copies
    within 1e-6 of the largest value (XLA:CPU contracts the CHOCO update
    into FMAs, the port rounds it as two operations)."""
    monkeypatch.setenv("BLUEFOG_AUTOTUNE_WIRE", "int8_ef")
    rng = np.random.RandomState(7)
    x0 = rng.randn(SIZE, 2048).astype(np.float32)
    grads = [rng.randn(SIZE, 2048).astype(np.float32) for _ in range(3)]
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.05))
    jopt = bf.DistributedAdaptThenCombineOptimizer(optax.sgd(0.05))
    opt.compression = jopt.compression = "int4_ef"
    params = {"w": torch.from_numpy(x0.copy())}
    jparams = {"w": bf.worker_values(lambda r: x0[r])}
    state, jstate = opt.init(params), jopt.init(jparams)
    for g in grads[:2]:
        params, state = opt.step(params, state, {"w": torch.from_numpy(g)})
        jparams, jstate = jopt.step(jparams, jstate, {"w": bf.worker_values(lambda r: g[r])})
    old = opt._ef
    assert opt._ef_sig[2] == "int4_ef"
    tuners = _start_both(interval=1, cooldown=4)
    recs = _drive_both(tuners, 3, triggers=TRIG, opts=(opt, jopt))
    swap = next(r for r in recs if r.action == "swap")
    assert swap.chosen.endswith("|int8_ef"), swap.chosen
    assert opt.compression == jopt.compression == "int8_ef"
    # the same parameters on both sides; fresh copies must not depend on the past
    xs = np.asarray(jparams["w"]).copy()
    params = {"w": torch.from_numpy(xs.copy())}
    params, state = opt.step(params, state, {"w": torch.from_numpy(grads[2])})
    jparams, jstate = jopt.step({"w": bf.worker_values(lambda r: xs[r])}, jstate,
                                {"w": bf.worker_values(lambda r: grads[2][r])})
    assert opt._ef is not old and opt._ef_sig[2] == "int8_ef"
    scale = float(np.abs(xs).max())
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jparams["w"]), rtol=0,
                               atol=1e-6 * scale)
    (es_t, er_t), = interop.ef_state_to_jax(opt._ef, [2048])
    (es_j, er_j), = jopt._ef
    assert er_t.shape == np.asarray(er_j).shape
    np.testing.assert_allclose(es_t, np.asarray(es_j), rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(er_t, np.asarray(er_j), rtol=0, atol=1e-6 * scale)


@pytest.mark.chaos
def test_rollback_under_an_average_session_equals_jax():
    """Under an elastic session a swap and its rollback go through
    ``adopt_topology``, which installs the ``average`` repair of the matrix
    it is given: the rolled-back Exp2 is its symmetrized form, not Exp2,
    on the port as on JAX, bitwise after every step."""
    bft.set_topology(tu.ExponentialTwoGraph(SIZE), is_weighted=True)
    bf.set_topology(jtu.ExponentialTwoGraph(SIZE), is_weighted=True)
    exp2 = _same_matrix().copy()
    bft.elastic.start(policy="average")
    bf.elastic.start(policy="average")
    tuners = _start_both(interval=1, cooldown=4)
    _drive_both(tuners, 6, step_s_fn=lambda t, tuner: 0.01 if tuner.swaps == 0 else 0.05,
                triggers=TRIG)
    assert tuners[0].swaps == 1 and tuners[0].rollbacks == 1
    w = _same_matrix()
    assert not np.array_equal(w, exp2)
    np.testing.assert_array_equal(w, repair_mod.repaired_matrix(exp2, range(SIZE)))
