# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Smoke run of the PyTorch/CUDA port (``bluefog_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero. The main path's phases
(7, 8, 9, 11k and 11l) train the whole ResNet50; the phases that check the
subsystems on it (7a, 10, 11a-11j) train it cut to one block a stage
(``PATH_TRAINER``: the same widths, 64 images of 224x224 a worker, the same
tiers, steps and gates, about a third of the host's launches a step), which
keeps the script inside its time limit. The last ``[done]`` line lists the
seconds of each phase.

1. device   -- the card's name, and its name and power limit from nvidia-smi;
2. build    -- compiles the CUDA wire kernels and the two flash-attention
               sources (``flash_kernels.cu``, ``flash_sm90.cu``) from
               ``bluefog_tpu_torch/csrc`` (one ``nvcc`` each, together), and
               prints each one's build time and ptxas lines (registers,
               spills);
3. parity   -- every wire kernel (``encode``, ``decode_accumulate``,
               ``encode_diff``, ``decode_add``, ``decode``) against its plain
               PyTorch version on the card, int8 and int4, on a ragged input
               with an all-zero and a +-tiny block, over the Exp2(8) plan and
               the StarGraph(8) plan (partial permutations): bitwise; and
               the f32 cotangent's split into two bf16 halves
               (``flash_split_cotangent``) at the ring block's shape with
               edge values, on a wide view, a view off 16 bytes and an
               expanded view: bitwise;
4. consensus-- 40 rounds of ``neighbor_allreduce(x, compression="int8")`` on
               ``[8, 2**20]``: the spread shrinks 100x, the worker mean stays;
5. ef       -- 60 rounds of the int4_ef and int8_ef combines (the CTA
               optimizer at lr = 0) on ``[8, 2**20]``: the CHOCO copies stay
               bit-identical (``xhat_recv[r][j] == xhat_self[src[r, j]]``),
               the worker mean is kept to 1e-5, and int4_ef ends at least
               100x below the spread of the memoryless int4 wire;
6. facade   -- every collective of the facade on ``[8, 25 557 504]`` f32
               (ResNet50's packed width) on the card, 4 machines x 2, the
               weighted Exp2 graph: ``allreduce``, ``allgather``,
               ``broadcast``, ``neighbor_allreduce`` with explicit weights,
               with one step of one-peer dynamic weights (exact and int8),
               ``neighbor_allgather`` exact, bf16, int8 and int4,
               ``hierarchical_neighbor_allreduce`` on the ring of machines,
               ``pair_gossip``; each timed once with CUDA events beside its
               byte bound and held against the same call on a CPU copy
               (the plain versions): bitwise for the copies and the wires,
               ``FACADE_TOL`` of the largest value for the sums; then one
               nonblocking op of each kind through ``synchronize``, bitwise
               its blocking twin; ``barrier``; launch counts zeroed just
               before and read just after the card's ops;
7. train-step -- ResNet50 as below through ``opt.make_train_step
               (sm.worker_loss)`` with the weighted Exp2 graph and
               ``sgd(0.1, 0.9)``: atc, atc/int8, atc/int4_ef,
               grad-allreduce, hier/int8 (4 machines x 2, ring of
               machines), cta k=2 and atc/int8 delayed, each 1 warm-up and
               2 timed steps from the replicated parameters; every tier but
               the delayed one then runs the same steps as two programs
               (``loss_and_grad``, ``opt.step``) from the same parameters
               and batch statistics, and the parameters must agree bit for
               bit (cuDNN's deterministic algorithms); one line per tier
               with step s, images/s, optimizer ms and peak GiB; launch
               counts zeroed just before each tier's fused steps and read
               just after. The gossip runs in one bucket (the stacked
               transport's default); atc/int8 again as two programs in
               JAX's default 4 MiB buckets (``BLUEFOG_BUCKET_BYTES``) must
               give the same bits, on a line with both runs' optimizer ms
               and encode/decode_accumulate launches a step (the bucketed
               run's launches count with the tiers');
7a. observability -- the same ResNet50 and graph through
               ``opt.make_train_step``, ATC on int8 and int4_ef
               (``OBS_TIERS``), with ``BLUEFOG_METRICS=1`` at interval 1 for
               1 + 3 steps (every step runs the sub-gossip probe; the
               timeline and the flight recorder on), and with metrics off
               and at interval 10 for 1 + 10 steps (a whole interval whose
               last step is sampled): the parameters, momentum and EF copies
               bitwise those of metrics off after as many steps; the probe's
               output bitwise the first columns of the step's combine; the
               ``bluefog.gossip.*`` gauges folded from the pinned copy within
               ``OBS_GAUGE_TOL`` of the fold of a CPU copy of the same
               payload, and ``param_norm`` and ``disagreement`` within it of
               float64 sums over the last step's own combine input and
               output (not the payload); each sampled
               step launching exactly the probe's kernels more (int8: one
               ``encode`` and one ``decode_accumulate``; int4_ef: one
               ``encode_diff`` and a ``decode_add`` a round); the timeline
               parses, with the ``ENQUEUE`` spans and ``ph:"C"`` counters; a
               flight dump parses with the JAX package's keys; a
               ``synchronize`` behind ``torch.cuda._sleep`` past the
               watchdog's deadline increments ``bluefog.stalls`` and
               writes a dump; one line per tier with step s and optimizer
               ms off and at interval 1 (medians of 3 steps), off and at
               interval 10 (means over the 10-step interval); files under
               ``build/observability``;
8. train    -- the main path, ResNet50 (1000 classes, bf16 compute) on 8
               virtual workers, 64 images of 224x224 each, seeded synthetic
               data, ``sgd(0.1, 0.9)`` on the default Exp graph, in three
               paths, each with the kernels' launch counts zeroed just before
               and read just after:
               wire -- ATC int8 (2 warm-up, 4 timed steps), one ATC int4 and
                       one CTA int8 step;
               ef   -- ATC int4_ef (1 warm-up, 2 timed), one ATC int8_ef and
                       one CTA int4_ef step;
               push-sum -- ``DistributedPushSumOptimizer`` with
                       ``BLUEFOG_WINDOW_WIRE=int4`` (1 warm-up, 2 timed, the
                       gradients taken at ``params()``), then one step at
                       lr = 0 that holds the x mass to 1e-5 of sum |x| and
                       the p mass to 8;
9. (none: the benchmark's traced cells, ``gossipbench/``, profile the
               ATC int8 step phase by phase);
10. async   -- bench.py::run_async's straggler scenario at the main path's
               width: ``make_async_train_step`` over the same ResNet50 with
               ``DistributedNeighborAllreduceOptimizer(sgd(0.1, 0.9))`` on
               ``RingGraph(8, connect_style=1)``, rank 6 at one tenth of the
               cadence, ``max_age`` 4, the drop policy; int8 (1 warm-up, 12
               timed ticks), fp32, bf16 and int4 (1 + 3); one line per wire
               (median tick, the due ranks' forward+backward and update, the
               exchange and fold as the rest of the tick, participants per
               tick, images/s over local steps, peak, ``stale_drops``, the
               advisories' slow ranks); every loss finite, the p mass 8 to
               1e-5, over the int8 run a participation ratio of at least
               1 - 1.5/8, ``stale_drops > 0`` and an ``async_staleness``
               advisory naming rank 6 and only its edges; the
               ``bluefog.async.ticks`` and ``.local_steps`` counters and the
               ``.participants`` gauge equal to the engine's own summary;
               ``encode`` and ``decode`` launched on every int8 and int4 tick (counts
               zeroed just before each wire's ticks, read just after); one
               profiled int8 tick;
11. async check -- bench.py::run_async's problem (quad loss, dim 4096,
               ``RandomState(0)``, 24 ticks) on each wire on the card and on
               a CPU copy: every tick's estimates within ``ASYNC_TOL`` of the
               largest value; at ``sgd(0.0)`` the value mass kept to
               ``ASYNC_MASS_TOL`` of sum |x| and the p mass at 8;
11a. checkpoint -- the ResNet50 of train-step under zero2/int8 Adam and
               ATC int4_ef on ``sgd(0.1, 0.9)``: 1 step, ``checkpoint.save``
               (BatchNorm statistics in ``extra``), ``restore`` into a fresh
               optimizer, 2 steps: the parameters bitwise those of 3
               uninterrupted steps; the bytes and the save and restore
               seconds; written under ``build/checkpoint`` and deleted;
11b. elastic -- ``bft.elastic`` at full width, each part's launch counts
               zeroed just before it and read just after, cuDNN
               deterministic: (a) the train-step ResNet50 on the weighted
               Exp2 graph, ATC int8 ``sgd(0.1, 0.9)`` through
               ``bft.elastic.guard(opt).make_train_step``, a session
               (``average``) killing rank 4 at step 2, 1 + 5 steps,
               ``session.rejoin(4, params, opt)`` before the last: one
               repair at step 2 (detect 0, repair 0), no stale dispatch, no
               plan edge on rank 4 until the rejoin, every plan keyed with a
               live token, the ``verdict:dead:rank=4`` dump with the
               ``membership`` and ``faults`` blocks and the JAX package's
               keys, the ``bluefog.elastic.*`` series equal to the session's
               records, and the parameters and momentum bitwise a twin run
               without a session that installs ``repaired_topology`` by hand
               before step 2 and the rejoin's topology and
               ``consensus_restore`` at the rejoin; (b) the same on ATC
               int4_ef, kill only, 1 + 3 steps, the CHOCO copies rebuilt
               exactly at the repair; (d) the async phase's straggler on
               int8 given as a ``slow`` fault (``push_sum`` session), 1 + 4
               ticks bitwise those of ``cadence``, then rank 5 killed and 3
               ticks at lr 0: one re-window, rank 5 never due, the live p
               mass 7 and value mass kept, the estimates within the pre-kill
               range (one int8 quantum of the largest a tick); (e) a
               checkpoint saved after (a)'s repair lists 7 live ranks,
               restores under a fresh session (which condemns rank 4 and
               repairs) into one step bitwise the uninterrupted run's, and
               is refused without a session; (f) ``bench.py::run_elastic``'s
               problem on the card and on the CPU (detect within 1 step,
               consensus within 1e-3 of the numpy oracle, card within 1e-6
               of the CPU); (g) a ``synchronize`` behind
               ``torch.cuda._sleep`` past ``BLUEFOG_LIVENESS_TIMEOUT`` files
               SUSPECT for the last dispatch's ranks and a
               ``verdict:suspect:`` dump, a deadline stall fault is
               condemned and repaired, a shorter one counted; part (c) runs
               after 14a on its model: zero2/int8 Adam under the guard, rank
               3 killed at step 2, 1 + 4 steps: one re-shard onto the 7 live
               ranks, the moments bitwise across it, measured == analytic
               state bytes for 8 and 7 live, the last scatter bitwise
               ``plain_ring_scatter`` at the 7-live owner positions, the
               parameter rows equal, encode/decode every step and the flash
               kernels on ``sm90``; files under ``build/elastic``, deleted;
11c. observatories -- the doctor, the staleness lineage and the memory
               observatory at full width, each part's launch counts zeroed
               just before it and read just after, one line a part: (a) the
               stacked transport's measured calibration (gates: source
               ``measured-probe``, ``alpha > 0``, ``0 < beta x 2 x 8 <=`` the
               card's memory rate; then cleared), ResNet50 ATC int8 on the
               weighted Exp2 graph with ``BLUEFOG_DOCTOR=1`` at interval 1,
               1 + 4 steps bitwise a doctor-off run, a probe for every round
               of the plan, no advisory; then a ``degrade`` fault on the edge
               2 -> 3 at 0.05 for 3 steps: ``degraded_link`` naming only that
               edge on the counter, the flight side table and
               ``BLUEFOG_DOCTOR_FILE``, triaged by ``tools/doctor.py``; (b)
               ``BLUEFOG_STALENESS=1`` at interval 1, bound 2: the sync
               surface at age 0 with no self-check failure; ``delayed=True``
               at age 1, 0 at the reseed of a topology swap; a ``stall``
               fault (``steps=3``) on 2 -> 3 ramping 1, 2, 3 and recovering,
               one ``staleness_breach`` naming only it; the async phase's
               straggler (int8, 1 + 4 ticks) whose ``surface="async"`` ages
               equal the engine gate's; every run bitwise staleness off;
               ``tools/staleness_report.py`` reads the dump; (c) after 11b's
               part c, the TransformerLM under replicated and zero2/int8 Adam
               with ``BLUEFOG_MEMORY=1`` at interval 1 (1 + 2 steps each):
               the census's ``opt_state`` bytes equal to
               ``scaling.optimizer_state_bytes``, the census total at most
               the allocator's allocated bytes; a budget of 1.1x zero2's
               watermark files ``memory_pressure`` with the shard hint on the
               replicated run and none on zero2; an ``oom`` fault raises
               ``SimulatedResourceExhausted`` at its step, the flight dump's
               ``oom`` advisory ranks ``opt_state`` first (also in
               ``tools/memory_report.py``), ``bluefog.elastic.oom_faults``
               and ``bluefog.memory.oom_events`` 1 each; a real
               ``torch.OutOfMemoryError`` through the memory excepthook
               counts one event; (d) ResNet50 ATC int4_ef with all three at
               interval 10, 1 + 10 steps bitwise all three off, and a
               ``checkpoint.save`` recording the ``checkpoint_save`` phase;
               files under ``build/observatories``, deleted;
11d. health and relay -- the relay (short-cut) plan family and the fleet
               health plane on the same ResNet50 and weighted Exp2 graph,
               cuDNN deterministic, each counted part's launch counts zeroed
               just before it and read just after: (a) under
               ``BLUEFOG_PLAN_METHOD=shortcut``, on the virtual ring and with
               ``BLUEFOG_TORUS_DIMS=2,4``: every relay round a partial
               permutation of unit hops, the deliveries the edge set
               (``_check_relay``), the weights the direct plan's; integer
               payloads under dyadic weights (an all-to-all plan) at
               ``[8, 25 557 504]`` bitwise the offset lowering; the int8/int4
               relay combine's ``encode`` and ``decode_accumulate`` (Exp2, and
               the star, whose rounds feed two receivers from one origin) and
               the relay allgather's ``decode`` at that width bitwise their
               plain versions (uncounted); counted: ATC fp32, int8 and int4
               two-program steps (1 + 2) against the direct plan's (rounds,
               step s, optimizer ms), and ``neighbor_allgather`` exact, int8
               and int4, bitwise the direct plan's; ``int8_ef`` refused with
               the JAX package's ``ValueError``; (b) ATC int8 with
               ``BLUEFOG_HEALTH=1`` at interval 1 (1 + 4 steps) bitwise a
               health-off twin, only the lane's ``health_pushsum`` op-cache
               key added, ``predicted_rate`` the dense oracle's for the
               dispatched plan, ``/healthz``, ``/metrics`` and ``/fleet``
               served on 127.0.0.1 at an OS-assigned port and read back; the
               lane on the card within ``HR_LANE_TOL`` of
               ``fleet_aggregate_np`` (Exp2, rank 6 dead, 12 applications);
               with staleness and memory on, ``/fleet``'s memory block and the
               fleet slots; then the default interval (20) against off, 1 +
               20 steps, the mean step beside JAX's 1% bound (reported); (c)
               consensus through ``bft.neighbor_allreduce`` at ``[8, 25 557
               504]`` f32 on the ring and Exp2 (up to 40 steps): the fitted
               rate within ``HR_DECAY_TOL`` of the prediction, Exp2 faster;
               (d) a lossy ring edge 2 -> 3 (5 % delivery from step 30)
               under a ``degrade`` fault: ``mixing_degraded`` naming [2, 3]
               on the counter, the flight side table and
               ``BLUEFOG_HEALTH_FILE``, ``/healthz`` warn, then 503 with
               rank 5 dead; files under ``build/health_relay``, deleted;
11e. federation and SLO -- the two-level federation (``BLUEFOG_PODS=2``,
               ``BLUEFOG_DCN_PERIOD=2``) and the SLO engine with its canary
               on the same ResNet50 (:func:`phase_federation_slo` states
               every gate): (a) ATC fp32 (exact DCN), int8 and int4 (int4
               DCN) and int4_ef (its int4 fallback), 1 + 4 two-program
               steps each: the DCN/ICI cadence and keys, 2 + 2 encode and
               decode_accumulate launches a DCN step and 1 + 1 an ICI-only
               step, the first DCN combine bitwise the plain legs on a CPU
               copy (int8, int4) or within 1e-5 of float64 (fp32), the
               per-leg counters against ``wire_summary``, int4_ef bitwise
               int4, ``make_train_step`` bitwise the two-program step, a
               flat run after ``BLUEFOG_PODS`` is unset bitwise its twin;
               (b) ATC int8 with ``BLUEFOG_SLO=1``: bitwise the engine off
               at interval 1 and 10, one encode and a decode a round more a
               sampled step, the canary ok on every Exp2(8) edge for fp32,
               bf16, int8 and int4 and equal to the CPU's, a ``degrade``
               fault named alone, a spent budget turning ``/healthz`` 503
               and served at ``/slo``; (c) host only: the N = 1024 storm
               and a 4 x 16 federated fleet losing a pod;
11f. autotune -- the closed-loop topology controller on the same ResNet50
               and weighted Exp2 graph, ATC through ``make_train_step``
               (:func:`phase_autotune` states every gate): (a) a ``degrade``
               fault on 2 -> 3, the doctor at interval 1, a controller fed
               the live advisories on a pinned step clock: one swap naming
               [2, 3], none rolled back, w[2, 3] down, zero stale
               dispatches, the step after the swap on the new plan with one
               encode and one decode_accumulate, its combine bitwise the
               plain versions, the decision replayed on the host equal to
               its record; (b) ``BLUEFOG_AUTOTUNE=1`` at interval 1 and 10
               on a quiet fabric bitwise off, no op-cache key; (c) the dry
               run: only ``dry_run_swap`` decisions a cooldown apart, no
               migration, bitwise off; (d) a 5x delivered step rolls the
               swap back: Exp2 restored bitwise, the candidate blocklisted,
               the next combine bitwise plain; (e) ``BLUEFOG_AUTOTUNE_WIRE=
               int4_ef`` from int8_ef: fresh copies, one encode_diff and a
               decode_add a round, bitwise plain; (f) the swap on the
               counters, the flight table, the JSONL, ``/fleet`` and
               ``tools/autotune_report.py``; files under ``build/autotune``,
               deleted;
11g. transport -- the multi-process transport on the same ResNet50 and
               weighted Exp2(8), two-program steps (1 + 2) in five tiers
               (atc, atc/int8, atc/int4_ef, hier/int8 on 2 machines of 4,
               grad-allreduce), cuDNN deterministic
               (:func:`phase_transport` states every gate): (a) the stacked
               run in this process, its parameters saved under
               ``build/transport``; (b) two processes of four workers
               sharing the card, started by ``bfrun-torch -np 8 -H
               localhost:4,localhost:4`` (gloo, the rows staged through
               pinned host memory), each process's rows bitwise rows ``4p ..
               4p + 3`` of (a) on every tier, its bytes a step the plan's
               edges to the other process times ``wire_payload_bytes``,
               B1-B4 launched in each, a line a tier with step s, optimizer
               ms, transport ms, bytes and peak; (c) one process on NCCL at
               world size 1, atc/int8 bitwise (a); a process that exits
               nonzero or passes ``TP_TIMEOUT`` fails the phase (and is
               killed); files deleted;
11h. transport-state -- the window ops, the async engine, ZeRO and
               checkpoint across processes on the same ResNet50, cuDNN
               deterministic, 1 + 2 steps a tier
               (:func:`phase_transport_state` states every gate):
               push-sum/int8 and push-sum/int4 (the Exp graph), win-put/fp32,
               async/int8 (phase 10's straggler, 4 ticks) and zero2/int8
               (adam); (a) the stacked run in this process, each tier's
               parameters, window lanes and sharded state saved under
               ``build/transport_state``, push-sum/int8's checkpoint and its
               next step; (b) two processes of four workers sharing the card
               (``bfrun-torch``, gloo staged): every saved row bitwise (a),
               the x mass over the processes within 1e-5 and p exactly 8 over
               an lr-0 step, the bytes a step equal to the edge formulas, B1
               and B5 in each process on every quantized tier, a line a tier;
               (c) (b)'s checkpoint ``state.pt`` bitwise (a)'s, and (a)'s
               restored in (b)'s processes, the next step bitwise (a)'s;
               files deleted;
11i. transport-topology -- federation, relay plans and elastic sessions
               across processes on the same ResNet50, cuDNN deterministic
               (:func:`phase_transport_topology` states every gate):
               fed/int8 (2 pods, DCN period 2, int4 DCN wire, 4 steps),
               relay/fp32 and relay/int8 (``shortcut``, 3 steps),
               elastic/int8 and elastic/int4_ef (rank 5 killed at step 2 of
               4, a rejoin and one more step), elastic/zero2-int8 (adam,
               rank 6 killed: the re-shard) and elastic/async-int8 (phase
               10's straggler, rank 2 killed at tick 2: the re-window);
               (a) the stacked run in this process, saved under
               ``build/transport_topology``; (b) two processes of four
               workers sharing the card (``bfrun-torch``, gloo staged):
               every saved row bitwise (a), the repair at the same step with
               no stale dispatch and the live sets equal, the bytes a step
               equal to the formulas of :func:`tt_expected_bytes`, each
               case's kernels launched in each process, a line a case; (c)
               (b)'s elastic/int8 checkpoint (written after the kill)
               restored in both processes and in this one, the next step
               bitwise (a)'s; files deleted;
11j. transport-fleet -- the fleet samplers across processes on the same
               ResNet50, cuDNN deterministic, 1 + 2 steps a case
               (:func:`phase_transport_fleet` states every gate):
               samplers/int8 (the metrics probe, the doctor, staleness,
               memory, health serving ``/healthz`` and the SLO canary at
               interval 1), doctor-autotune/int8 (the crossing edge 3 -> 4
               degraded, the controller at interval 1, one route
               calibration), oom/int4_ef (the ``oom`` fault on rank 5) and
               async/int8 (staleness and health); (a) the stacked run in
               this process; (b) two processes of four workers sharing the
               card (``bfrun-torch``, gloo staged): every row bitwise (a),
               the samplers' outputs equal the other process's and (a)'s,
               the degraded edge named and one swap, the forensics' census,
               the scraped ``/healthz``, each case's kernels launched in each
               process, a line a case; files deleted;
11k. scaling-trace -- the scaling stats, the native timeline writer and
               the trace tools on the same ResNet50
               (:func:`phase_scaling_trace` states every gate): (a)
               ``scaling.gossip_comm_stats`` on the card at 25 557 032 f32
               elements: one ``collective-permute`` of the payload's bytes
               for one-peer Exp2 at n = 2, 4, 8, 3 for the static Exp2(8),
               an ``all-reduce``, the ``include_plan`` summary; (b)
               ``scaling.weak_scaling_times`` of ``opt.make_train_step``, ATC
               int8, 64 images a worker, at 1, 2, 4 and 8 workers (the
               one-peer Exp2 plan; one worker: the fully connected graph of
               one), 1 warm-up and 3 timed steps, a line each n with ms a
               step, images/s and efficiency (n workers share one card);
               one ``encode`` and one ``decode_accumulate`` a step, the first
               step's combine bitwise the plain versions'; (c) the timeline
               through the native writer (``using_native_writer()``) and
               through the Python writer, 1 + 2 ATC/int8 steps each: the same
               event names and counts, and the host us of one
               ``timeline_record_complete`` (median of 100 000 calls, one
               and two recording threads, each writer); (d)
               ``tools/trace_merge.py --report`` and
               ``tools/metrics_report.py --flight`` on (c)'s native run: exit
               0, 8 rank lanes, every step's rounds the Exp(8) plan's; files
               under ``build/scaling_trace``, deleted;
11l. frontend -- the torch frontend (``bluefog_tpu_torch.torch``,
               :func:`phase_frontend` states every gate): (a) its ops on
               ``[8, 25 557 504]`` f32 over Exp(8): ``neighbor_allreduce``
               exact and on the bf16, int8 and int4 wires, its forward
               bitwise the facade's (int8 and int4: one ``encode`` and one
               ``decode_accumulate`` a call), its backward launching no wire
               kernel and bitwise the exact combine over ``W^T`` (within
               1e-6 of W's product in float64 on 2**20 columns);
               ``allreduce`` and ``broadcast``, forward and backward,
               bitwise the facade's calls composed by hand; (b) the whole
               ResNet50 (64 images a worker, bf16 compute) trained by the
               user's ``torch.optim.SGD(lr=0.1, momentum=0.9)`` under
               ``StepLR(2, 0.5)`` wrapped by
               ``DistributedNeighborAllreduceOptimizer`` on the int8 wire,
               1 warm-up and 3 timed steps: one ``encode`` and one
               ``decode_accumulate`` a step, the parameters bitwise the same
               steps composed by hand, within ``FE_FUNC_TOL`` of the
               functional optimizer over the first two steps, a
               ``state_dict`` round trip; 1 + 2 steps of the wrapped
               gradient allreduce against the functional one;
12. kernels  -- each wire kernel against its plain version at the main
               path's shapes (the full packed parameter buffer), timed with
               CUDA events beside its memory bound;
13. flash-parity -- the flash kernels (``flash_fwd``, ``flash_bwd_dkv``,
               ``flash_bwd_dq``) against their plain versions on the card,
               on q/k/v split from one fused projection as the model gives
               them: bf16 at the transformer's shape (b 2, T 4096, 16
               heads of 64) causal and not, a ragged T, head_dim 96 and
               128, grouped-query K/V, rows off 16 bytes (head_dim 36, a
               buffer shifted by one element), f32 inputs, the lse form
               (f32 out and cotangent, a nonzero lse cotangent) at head_dim
               64 and 128 (``sm90``, the cotangent as two bf16 halves),
               two ``split`` cases whose cotangents' high halves cancel
               (``split_operands``: dV, and dP with dK and dQ, all low
               halves), head_dim 256 in bf16 (the ``mma`` route) and head_dim
               160 in f32 in the lse form (``simt``); every output row within
               ``FLASH_ROW_TOL`` of its own norm (f32 above head_dim 128:
               ``FLASH_ROW_TOL_F32_WIDE``), and each case's three
               kernels on the routes ``FLASH_ROUTES`` names (``sm90``:
               wgmma fed by TMA);
14. train, path transformer -- ``TransformerLM`` (vocab 16384, dim 1024, 16
               heads, 12 layers, T 4096, bf16 compute over f32 parameters:
               188 872 704 per worker) on 8 virtual workers, 2 sequences of
               seeded random tokens each, next-token loss, ``sgd(0.01,
               0.9)``: ATC int8 (1 warm-up, 3 timed steps), then ATC
               int4_ef (1 warm-up, 1 timed step); launch counts zeroed just
               before and read just after, with at least 96 ``sm90``
               launches of each flash kernel a step;
               then worker 0's forward at full
               size with every block's attention held against the plain
               version on its own q, k, v;
14a. zero    -- the same TransformerLM trained by
               ``DistributedGradientAllreduceOptimizer(adam(1e-4))`` in six
               tiers (``ZERO_TIERS``: repl, zero1, zero2 on fp32, int8, int4
               and int8_ef), 1 warm-up and 2 timed steps each from the same
               parameters: a line per tier with step s, tokens/s, optimizer
               ms, peak GiB, Adam state bytes measured and analytic, and
               encode/decode launches a step; zero1 and zero2/fp32 bitwise
               repl, measured == analytic bytes, encode and decode on every
               int8/int4 step; each zero2 tier's scatter, as the optimizer
               dispatched it, on the last step's gradients within
               ``ZERO_SUM_TOL`` (fp32) or ``ZERO_ENVELOPE`` of the
               allreduce's mean, the int8/int4 ones bitwise a plain ring
               (``plain_ring_scatter``) at the optimizer's chunk count and
               at the ICI-priced chooser's;
14b. zero check -- bench.py::run_shard's trajectory problem (quadratic,
               Adam lr 0.02, dim 4099, 8 steps) in zero1 and zero2 on
               fp32/int8/int4, on the card and on the CPU: against the numpy
               Adam replay and the card against the CPU;
15. dryrun   -- the dry run of ``__graft_entry__.dryrun_multichip``
               (``bluefog_tpu_torch.dryrun.DryRun``): 8 workers as 4
               machines x 2, one-peer Exp2 gossip on the step index
               (period 3), the hierarchical loss average on the weighted
               machine ring, ``MLP(16, 10)`` per worker from its own seed,
               ``sgd(0.05, 0.9)``, ring attention (f32, head_dim 2:
               ``simt``; outside the loss, so its forward only) for step
               indices 0, 1, 2, held against the same steps on the CPU to
               ``DRYRUN_TOL`` and each step's ring attention row by row to
               the f32 ``FLASH_ROW_TOL``; launch counts zeroed just before
               and read just after;
16. train, path long-context -- ``examples/long_context.py`` at the
               transformer's width: one ``TransformerLM`` (vocab 16384,
               dim 1024, 16 heads, 12 layers, max_len 8192, bf16 compute
               over f32 parameters), 2 seeded sequences of 8192 tokens
               sharded into 8 blocks of 1024 on the ring, every block's
               attention ring attention over the 8 workers, the whole
               sequence's mean next-token loss, ``sgd(0.01, 0.9)``: 1
               warm-up and 2 timed steps, each launching all three flash
               kernels on ``sm90`` (none on another route) and the
               cotangent's split at least 96 times (8 rounds x 12 layers);
               one profiled step (the flash backward kernels' share of
               device time); then block 0's
               ring attention at full size against the plain versions on
               the whole 8192-token sequence;
16a. examples -- the nine invocations of ``examples/run_all_examples.sh``
               on the port's ``examples/torch_<name>.py`` with the same
               arguments, as subprocesses started together on the card:
               each exits 0 (mnist's gate: 90% accuracy), a line each with
               its seconds and last line;
17. kernels  -- the flash kernels at the transformer's shape, timed beside
               their operation bound, their plain versions,
               ``F.scaled_dot_product_attention`` (the yardstick only:
               the port never calls it) and the ``mma`` route's kernel on
               the same inputs (``earlier_ms``); the lse form at the ring
               block's shape (b 16, T 1024, all on ``sm90``) held against
               its plain versions, beside its bound, SDPA and the ``simt``
               kernels on the same
               inputs (``lse_route`` on the flash rows, with the
               long-context path's measured launches per step); the split
               beside its byte bound;
17a. batchnorm -- the BatchNorm kernel pairs (forward: stats, finish,
               apply; backward: bwd_reduce, bwd_finish, bwd_dx) held to the
               plain versions at the ResNet50's largest BatchNorm
               (``bn_init``, ``[256*112*112, 64]`` bf16 with the ReLU
               fused) and at two block ends with the residual and the ReLU
               fused (``[256*56*56, 256]``, ``[256*7*7, 2048]``); the first
               timed beside the two-pass design's byte bound and the
               one-pass floor, the plain composite and ``F.batch_norm``
               (the yardstick only: the port never calls it); then the
               eleven-row JSON line.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA the script
exits non-zero before printing any result.

    python3 chip_smoke.py --phase health-relay
    python3 chip_smoke.py --phase federation-slo
    python3 chip_smoke.py --phase autotune
    python3 chip_smoke.py --phase transport
    python3 chip_smoke.py --phase transport-state
    python3 chip_smoke.py --phase transport-topology
    python3 chip_smoke.py --phase transport-fleet
    python3 chip_smoke.py --phase scaling-trace
    python3 chip_smoke.py --phase frontend
    python3 chip_smoke.py --phase batchnorm

run phase 11d, 11e, 11f, 11g, 11h, 11i, 11j, 11k or 11l alone on the ResNet50
of the whole run (11d-11j at ``PATH_TRAINER``'s depth; the wire kernels built
first) and print no result line. Phase
11g's processes run ``python3 chip_smoke.py --transport-child <config>``,
phase 11h's ``python3 chip_smoke.py --transport-state-child <config>``,
phase 11i's ``python3 chip_smoke.py --transport-topology-child <config>``,
phase 11j's ``python3 chip_smoke.py --transport-fleet-child <config>``.

(``--phase batchnorm`` runs 17a alone and prints its lines and rows.)

    python3 chip_smoke.py --planted-faults

builds each fault of ``PLANTED_FAULTS`` into its own copy of the package
under ``build/faults/`` and runs flash-parity's cases on it: it fails unless
every planted fault fails some case.
"""

import contextlib
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

import bluefog_tpu_torch as bft
import bluefog_tpu_torch.torch as bftt
from bluefog_tpu_torch import _build, flight, metrics, watchdog
from bluefog_tpu_torch import topology as topo
from bluefog_tpu_torch.collective import inner, kernels
from bluefog_tpu_torch.collective.plan import plan_from_topology
from bluefog_tpu_torch.dryrun import DryRun
from bluefog_tpu_torch.models import (
    ResNet50,
    StackedModel,
    TransformerLM,
    long_context,
    next_token_loss,
    resnet,
    transformer,
)
from bluefog_tpu_torch.ops import batchnorm as bn_ops
from bluefog_tpu_torch.ops import flash, ring_attention

SIZE = 8
BATCH = 64
# the ResNet50 of the phases that check the subsystems on it (7a, 10,
# 11a-11j): its depth cut to one block a stage (10 064 936 parameters), its
# widths whole; a step is bound by the host's kernel launches, so depth, not
# the batch, sets its time
PATH_TRAINER = {"stage_sizes": [1, 1, 1, 1]}
IMAGE = 224
WARMUP, TIMED = 2, 4
RESNET50_PARAMS = 25_557_032  # the flax ResNet50 at 1000 classes
RESNET50_WIDTH = 25_557_504  # its packed width: whole 512-element wire blocks
LOCAL = 2  # workers per machine in the facade and train-step phases
FACADE_TOL = 1e-6  # of the largest |value|: the facade's inexact ops, card vs CPU
# bench.py::run_transformer's configuration on a chip, in full
LM_CONFIG = dict(vocab=16384, dim=1024, heads=16, layers=12, max_len=4096)
LM_SEQ, LM_BATCH = 4096, 2
LM_PARAMS = 188_872_704
# examples/long_context.py at the transformer path's width: one model, each
# of 2 sequences of 8192 tokens sharded over the SIZE workers of the ring
LC_CONFIG = dict(vocab=16384, dim=1024, heads=16, layers=12, max_len=8192)
LC_BLOCK, LC_BATCH = 1024, 2
# the dry run's three steps on the card against the same steps on the CPU
DRYRUN_TOL = 1e-5
# bench.py::run_async's straggler scenario: rank SIZE - 2 at one tenth of the
# cadence, the staleness bound 4, the drop policy; (wire, warm-up, timed ticks)
ASYNC_SLOW, ASYNC_FACTOR, ASYNC_MAX_AGE = SIZE - 2, 10, 4
ASYNC_WIRES = (("int8", 1, 12), ("fp32", 1, 3), ("bf16", 1, 3), ("int4", 1, 3))
# bench.py::run_async's problem (quad loss, RandomState(0)) on the card against
# a CPU run: estimates within ASYNC_TOL of the largest value
ASYNC_DIM, ASYNC_TICKS, ASYNC_LR, ASYNC_TOL = 4096, 24, 0.05, 1e-6
ASYNC_MASS_TOL = 1e-5  # of sum |x|: the value mass at lr 0, float64 sums

# The zero phase: the transformer path's model trained by gradient-allreduce
# Adam in six tiers (name, BLUEFOG_SHARD, BLUEFOG_SHARD_GRADS, compression),
# 1 warm-up and 2 timed steps each
ZERO_TIERS = (("repl", 0, 0, None), ("zero1", 1, 0, None), ("zero2/fp32", 1, 1, None),
              ("zero2/int8", 1, 1, "int8"), ("zero2/int4", 1, 1, "int4"),
              ("zero2/int8_ef", 1, 1, "int8_ef"))
ZERO_LR = 1e-4
ZERO_WARMUP, ZERO_TIMED = 1, 2
# zero2/fp32's scatter, as the timed steps dispatched it, against the owned
# slots of the allreduce's mean: the ring (more than one chunk) adds the 8
# rows in another order than the allreduce's torch.sum (the reference's
# fast-against-ring bound, tests/test_reduce_scatter.py), of the largest
# |gradient|; the one-chunk one-sum form is the allreduce's sum
ZERO_SUM_TOL = 1e-6
# the reference's envelope of a quantized reduce-scatter against the exact
# one (tests/test_reduce_scatter.py::test_quantized_tier_envelope), here of
# the largest |gradient|; the int8/int4 scatters are also held bitwise
# against the plain ring (plain_ring_scatter)
ZERO_ENVELOPE = {"fp32": ZERO_SUM_TOL, "int8": 2e-2, "int8_ef": 2e-2, "int4": 2e-1}
# bench.py::run_shard's trajectory problem: the quadratic, Adam lr 0.02,
# 8 workers, dim 4099, 8 steps; the fp32 tiers within ZERO_ORACLE_TOL of
# the numpy Adam replay, the quantized ones within the envelope above;
# the card within ZERO_CARD_TOL of the largest value of the CPU run
ZERO_CHECK_DIM, ZERO_CHECK_STEPS, ZERO_CHECK_LR = 4099, 8, 0.02
ZERO_ORACLE_TOL, ZERO_CARD_TOL = 1e-4, 1e-6
ZERO_CHECK_TIERS = (("zero1", 0, None), ("zero2/fp32", 1, None), ("zero2/int8", 1, "int8"),
                    ("zero2/int4", 1, "int4"))

# Device memory rate by card (bytes/s; NVIDIA data sheets). The H100 SXM's
# 3.35 TB/s is the default for an unlisted Hopper part.
MEMORY_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
H100_SXM_RATE = 3.35e12
# Plain float32 arithmetic outside the tensor cores, and the dense bf16
# tensor-core rate (H100 SXM data sheet).
F32_RATE = 67e12
BF16_RATE = 989e12

# kernel -> the TPU kernel it replaces
KERNEL_ROWS = {
    "encode": "bluefog_tpu/collective/kernels.py:373",
    "decode_accumulate": "bluefog_tpu/collective/kernels.py:449",
    "encode_diff": "bluefog_tpu/collective/kernels.py:394",
    "decode_add": "bluefog_tpu/collective/kernels.py:431",
    "decode": "bluefog_tpu/collective/kernels.py:415",
    "flash_fwd": "bluefog_tpu/ops/flash.py:156",
    "flash_bwd_dkv": "bluefog_tpu/ops/flash.py:343",
    "flash_bwd_dq": "bluefog_tpu/ops/flash.py:369",
    # the lse form's f32 dO, which _bwd_call hands both backward kernels, as
    # two bf16 halves for the sm90 backward
    "flash_split_cotangent": "bluefog_tpu/ops/flash.py:313",
}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# phase 17a's BatchNorm cases, (shape [N, C, H, W], the residual fused),
# all bf16 with the ReLU fused: the ResNet50's largest (bn_init, timed for
# the kernel rows), then two block ends: the largest and the widest C
BN_CASES = (((256, 64, 112, 112), False), ((256, 256, 56, 56), True),
            ((256, 2048, 7, 7), True))
# the BatchNorm kernels under their launch-count names
BN_KERNELS = tuple(f"bn_{k}" for k in bn_ops.KERNELS)
# the lane mapping of csrc/wire_kernels.cu::decode_kernel that the kernels
# phase times
DECODE_MAPPING = ("4 blocks per warp, all loads before the stores, each warp-wide "
                  "float4 store one contiguous 512-byte run")
# the kernels each path of the train phase must launch (every path that
# trains a ResNet on the card launches the BatchNorm kernels too)
PATH_KERNELS = {
    # the facade's quantized neighbor_allreduce and neighbor_allgather
    "facade": ("encode", "decode"),
    # the fused ResNet50 steps of every optimizer tier
    "train-step": ("encode", "decode_accumulate", "encode_diff", "decode_add") + BN_KERNELS,
    "wire": ("encode", "decode_accumulate") + BN_KERNELS,
    "ef": ("encode_diff", "decode_add") + BN_KERNELS,
    "push-sum": ("encode", "decode") + BN_KERNELS,
    # the asynchronous ticks' int8 and int4 window wires
    "async": ("encode", "decode") + BN_KERNELS,
    "transformer": FLASH_KERNELS + ("encode", "decode_accumulate", "encode_diff",
                                    "decode_add"),
    # the ZeRO-2 int8/int4 scatters of the zero phase
    "zero": ("encode", "decode"),
    # the checkpoint phase's zero2/int8 scatter and ATC int4_ef copies
    "checkpoint": ("encode", "decode", "encode_diff", "decode_add") + BN_KERNELS,
    # the dry run's ring attention is outside the differentiated loss (as
    # in __graft_entry__._dryrun_body): its forward runs, no backward
    "dryrun": ("flash_fwd",),
    # each round's f32 cotangent is split once for both backward kernels
    "long-context": FLASH_KERNELS + ("flash_split_cotangent",),
    # the ResNet50 steps with the metrics probe on: atc/int8 and atc/int4_ef
    "observability": ("encode", "decode_accumulate", "encode_diff", "decode_add") + BN_KERNELS,
    # the elastic phase's ResNet50 parts: the int8 kill and rejoin, the
    # int4_ef kill, the async int8 ticks, the resumed checkpoint
    "elastic": ("encode", "decode_accumulate", "encode_diff", "decode_add", "decode") + BN_KERNELS,
    # its TransformerLM part: the zero2/int8 re-shard
    "elastic zero": FLASH_KERNELS + ("encode", "decode"),
    # the observatories phase: (a) the doctor's ATC int8 steps, (b) the
    # staleness runs (ATC int8, delayed int8, the async int8 ticks), (c) the
    # memory runs on the TransformerLM (zero2/int8 scatter), (d) ATC int4_ef
    "observatories a": ("encode", "decode_accumulate") + BN_KERNELS,
    "observatories b": ("encode", "decode_accumulate", "decode") + BN_KERNELS,
    "observatories c": FLASH_KERNELS + ("encode", "decode"),
    "observatories d": ("encode_diff", "decode_add") + BN_KERNELS,
    # the health and relay phase: (a) the relay ResNet50 steps (int8/int4)
    # and the relay neighbor_allgather (int8/int4), (b) the ATC int8 steps
    # with the health plane on
    "health relay a": ("encode", "decode_accumulate", "decode") + BN_KERNELS,
    "health relay b": ("encode", "decode_accumulate") + BN_KERNELS,
    # the federation and SLO phase: (a) both legs of the federated int8/int4
    # steps, (b) the SLO canary (one encode, one decode a round) beside the
    # ATC int8 steps
    "federation": ("encode", "decode_accumulate") + BN_KERNELS,
    "slo canary": ("encode", "decode") + BN_KERNELS,
    # the topology controller's runs: ATC int8 before and after a swap and a
    # rollback (B1, B2), and the swap onto int4_ef from int8_ef (B3, B4)
    "autotune": ("encode", "decode_accumulate", "encode_diff", "decode_add") + BN_KERNELS,
    # the transport phase: (a) the stacked reference, (b) both processes'
    # tiers (each process is gated on its own too), (c) NCCL's atc/int8
    "transport a": ("encode", "decode_accumulate", "encode_diff", "decode_add") + BN_KERNELS,
    "transport": ("encode", "decode_accumulate", "encode_diff", "decode_add") + BN_KERNELS,
    "transport nccl": ("encode", "decode_accumulate") + BN_KERNELS,
    # the transport-state phase: (a) the stacked reference, (b) both
    # processes' window, async and zero2 tiers (each process is gated on its
    # own too): the window and async wires and the scatter, B1 and B5
    "transport-state a": ("encode", "decode") + BN_KERNELS,
    "transport-state": ("encode", "decode") + BN_KERNELS,
    # the transport-topology phase: (a) the stacked reference and (c)'s
    # restore in one process, (b) both processes' federated, relay and
    # elastic cases and (c)'s restores: B1 + B2 on the int8 legs, B3 + B4 on
    # elastic/int4_ef, B1 + B5 in the re-sharded scatter and the re-window
    "transport-topology a": ("encode", "decode_accumulate", "encode_diff", "decode_add",
                             "decode") + BN_KERNELS,
    "transport-topology": ("encode", "decode_accumulate", "encode_diff", "decode_add",
                           "decode") + BN_KERNELS,
    # the transport-fleet phase: (a) the stacked cases, (b) both processes'
    # (each process is gated on its own too): B1 + B2 on the int8 combines
    # and the metrics probe, the SLO canary's B1 + B5, B3 + B4 on int4_ef
    # under the oom fault, B1 + B5 on the async ticks
    "transport-fleet a": ("encode", "decode_accumulate", "encode_diff", "decode_add", "decode")
                         + BN_KERNELS,
    "transport-fleet": ("encode", "decode_accumulate", "encode_diff", "decode_add", "decode")
                       + BN_KERNELS,
    # the scaling-trace phase's weak scaling: the ATC/int8 steps at 1, 2, 4
    # and 8 workers
    "scaling-trace": ("encode", "decode_accumulate") + BN_KERNELS,
    # the frontend phase's wrapped torch.optim.SGD on the int8 wire
    "frontend": ("encode", "decode_accumulate") + BN_KERNELS,
}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def reset_launch_counts():
    kernels.reset_launch_counts()
    flash.reset_launch_counts()
    bn_ops.reset_launch_counts()


def launch_counts():
    return {**kernels.launch_counts(), **flash.launch_counts(),
            "flash_split_cotangent": flash.split_launch_count(),
            **{f"bn_{k}": v for k, v in bn_ops.launch_counts().items()}}


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
    return check_same("decode_accumulate", wire, got, ref)


def check_same(name, wire, got, ref):
    """A kernel's f32 output against its plain version's, bitwise;
    returns the max abs difference (0)."""
    sync(got.device)
    if not torch.equal(bits(got), bits(ref)):
        raise AssertionError(
            f"{name}[{wire}] differs from its plain version: max ulp "
            f"{max_ulp(got, ref)}, max abs {float((got - ref).abs().max())}"
        )
    return float((got - ref).abs().max())


def check_encode_diff(x, h, wire):
    """encode_diff on a copy of ``h`` against its plain version on
    another: payload, scales and the updated copy. Returns ``(max abs
    difference, payload, scales, updated copy)``."""
    hk, hr = h.clone(), h.clone()
    p, s = kernels.encode_diff(x, hk, wire)
    rp, rs = kernels.encode_diff_reference(x, hr, wire)
    sync(x.device)
    if not (torch.equal(p, rp) and torch.equal(bits(s), bits(rs))):
        raise AssertionError(
            f"encode_diff[{wire}] differs from its plain version: payload max diff "
            f"{int((p.int() - rp.int()).abs().max())}, scales max ulp {max_ulp(s, rs)}"
        )
    return check_same("encode_diff", wire, hk, hr), p, s, hk


def check_decode_add(base, p, s, src_r, wire):
    got = kernels.decode_add(base.clone(), p, s, src_r, wire)
    ref = kernels.decode_add_reference(base.clone(), p, s, src_r, wire)
    return check_same("decode_add", wire, got, ref)


def check_decode_rows(p, s, src_r, wire):
    return check_same("decode", wire, kernels.decode(p, s, src_r, wire),
                      kernels.decode_reference(p, s, src_r, wire))


def check_split(do):
    """``flash.split_cotangent``'s kernel against its plain version on
    ``do``: both halves bitwise, contiguous; returns the max abs difference
    (0)."""
    hi, lo = flash.split_cotangent(do)
    rhi, rlo = flash.split_cotangent_reference(do)
    sync(do.device)
    for half, got, want in (("hi", hi, rhi), ("lo", lo, rlo)):
        if not (got.is_contiguous() and torch.equal(bits(got), bits(want))):
            raise AssertionError(f"split_cotangent's {half} differs from its plain version on "
                                 f"{tuple(do.shape)} (strides {do.stride()}): max ulp "
                                 f"{max_ulp(got, want)}")
    return 0.0


def split_inputs(device, b=SIZE * LC_BATCH, t=LC_BLOCK, h=LC_CONFIG["heads"],
                 d=LC_CONFIG["dim"] // LC_CONFIG["heads"], seed=3):
    """f32 cotangents for ``check_split``: the ring block's ``[b, t, h, d]``
    (the long-context path's shape) with zeros of both signs, f32
    subnormals, bf16 ties, values that round to bf16's largest and past it
    to inf; a view of a wider buffer (16-byte rows, the vector path); a view
    one element off 16 bytes at head_dim 36 and an expanded view (the
    scalar path)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, t, h, d, generator=gen, device=device) * 3.0
    edge = torch.tensor([0.0, -0.0, 1e-40, -3e-39, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                         3.389e38, -3.4e38], device=device)
    x.view(-1)[:edge.numel()] = edge
    wide = torch.randn(2, 300, 8, 2 * d, generator=gen, device=device)[..., :d]
    off = torch.randn(1 + 2 * 300 * 8 * 37, generator=gen, device=device)[1:].view(
        2, 300, 8, 37)[..., :36]
    expanded = torch.randn(300, 8, d, generator=gen, device=device).expand(2, 300, 8, d)
    return [x, wide, off, expanded]


def phase_parity(device):
    x = kernels.pad_blocks(ragged_input(device)).contiguous()
    h = kernels.pad_blocks(ragged_input(device, seed=1) * 0.5).contiguous()
    h[:, :1024] = 0.0  # the zero and the +-tiny blocks keep their difference
    plans = {
        "exp2": plan_from_topology(topo.ExponentialTwoGraph(SIZE), weighted=True),
        "star": plan_from_topology(topo.StarGraph(SIZE), weighted=True),
    }
    for wire in ("int8", "int4"):
        _err, p, s = check_encode(x, wire)
        _err, pd, sd, _h = check_encode_diff(x, h, wire)
        check_decode_rows(pd, sd, None, wire)
        for name, plan in plans.items():
            src, _self_w, recv_w = inner.plan_operands(plan, device)
            check_decode(x, p, s, src, recv_w, wire)
            for r in range(src.shape[0]):
                check_decode_add(h, pd, sd, src[r], wire)
                check_decode_rows(pd, sd, src[r], wire)
        log("parity", f"{wire}: encode, decode_accumulate, encode_diff, decode_add and "
                      f"decode (exp2, star) bitwise equal to the plain versions on "
                      f"[{SIZE}, {x.shape[1]}]")
    inputs = split_inputs(device)
    for do in inputs:
        check_split(do)
    log("parity", "flash_split_cotangent: hi and lo bitwise equal to the plain version on "
                  + ", ".join(f"{tuple(do.shape)} strides {do.stride()}" for do in inputs))


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


def spread(t):
    return float((t - t.mean(0)).abs().max())


def phase_ef(device, n=1 << 20, rounds=60):
    """The CHOCO copies' identity, the mean, and int4_ef against the
    memoryless int4 wire after the same rounds, at lr = 0."""
    gen = torch.Generator(device=device).manual_seed(2)
    x0 = torch.randn(SIZE, n, generator=gen, device=device)
    mean0 = x0.mean(0)
    src = bft.get_context().static_plan().sources()
    zero = {"w": torch.zeros_like(x0)}
    spreads = {}
    for tier in ("int4_ef", "int8_ef"):
        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.0))
        opt.compression = tier
        params = {"w": x0.clone()}
        state = opt.init(params)
        for _ in range(rounds):
            opt.step(params, state, zero)
        (xhat_self, xhat_recv), = opt._ef
        for r in range(src.shape[0]):
            for j in range(SIZE):
                if src[r, j] >= 0 and not torch.equal(bits(xhat_recv[r][j]),
                                                      bits(xhat_self[src[r, j]])):
                    raise AssertionError(f"{tier}: copy of round {r} at worker {j} "
                                         "differs from its source's own copy")
        drift = float((params["w"].mean(0) - mean0).abs().max()) / float(mean0.abs().max())
        if not drift <= 1e-5:
            raise AssertionError(f"{tier}: worker mean drifted {drift:.3g} (> 1e-5 relative)")
        spreads[tier] = spread(params["w"])
        log("ef", f"{tier}: {rounds} rounds on [{SIZE}, {n}]: spread {spread(x0):.4g} -> "
                  f"{spreads[tier]:.4g}, mean drift {drift:.3g} (relative), copies "
                  "bit-identical to their sources'")
        opt.free()
        del params, state
    plain = x0.clone()
    for _ in range(rounds):
        plain = bft.neighbor_allreduce(plain, compression="int4")
    spreads["int4"] = spread(plain)
    ratio = spreads["int4"] / max(spreads["int4_ef"], float(np.finfo(np.float32).tiny))
    log("ef", f"int4 (no memory) after the same rounds: spread {spreads['int4']:.4g}; "
              f"int4_ef is {ratio:.4g}x below it")
    if not spreads["int4_ef"] * 100 <= spreads["int4"]:
        raise AssertionError(f"int4_ef spread only {ratio:.3g}x below int4 (< 100x)")


def facade_context(device):
    """The facade's context: 8 workers as 4 machines x 2, the weighted
    Exp2 graph, the unweighted ring of machines."""
    bft.init(size=SIZE, device=device, nodes_per_machine=LOCAL)
    bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
    bft.set_machine_topology(topo.RingGraph(SIZE // LOCAL))


def one_peer_weights(step=1):
    """``(self_weight, src_weights, dst_weights)`` of one step of
    ``GetDynamicOnePeerSendRecvRanks`` over the exponential graph."""
    gens = [topo.GetDynamicOnePeerSendRecvRanks(topo.ExponentialGraph(SIZE), r)
            for r in range(SIZE)]
    for _ in range(step):
        for g in gens:
            next(g)
    pairs = [next(g) for g in gens]
    return ([1.0 / (len(recv) + 1) for _s, recv in pairs],
            [{i: 1.0 / (len(recv) + 1) for i in recv} for _s, recv in pairs],
            [list(send) for send, _r in pairs])


def facade_ops():
    """``name -> (call, exact, bytes moved / x.nbytes)``: each facade op on
    a worker tensor ``x``; ``exact`` ops must be bitwise equal across
    devices, the others within ``FACADE_TOL``. The byte factor counts the
    input read once and the output written once (a broadcast reads one
    row; the gathers write ``max_in_degree`` = 3 rows per worker)."""
    topology = topo.ExponentialTwoGraph(SIZE)
    self_w = [float(topology[j, j]) for j in range(SIZE)]
    src_w = [{int(i): float(topology[i, j]) for i in np.nonzero(topology[:, j])[0] if i != j}
             for j in range(SIZE)]
    dyn_self, dyn_src, dyn_dst = one_peer_weights()
    gather = lambda wire: lambda x: torch.stack(  # noqa: E731
        [r for r in bft.neighbor_allgather(x, compression=wire)])
    return {
        "allreduce": (lambda x: bft.allreduce(x), False, 2),
        "allgather": (lambda x: bft.allgather(x), True, 1 + SIZE),
        "broadcast": (lambda x: bft.broadcast(x, 3), True, 1 + 1 / SIZE),
        "neighbor_allreduce explicit": (
            lambda x: bft.neighbor_allreduce(x, self_weight=self_w, src_weights=src_w),
            False, 2),
        "neighbor_allreduce dynamic": (
            lambda x: bft.neighbor_allreduce(x, self_weight=dyn_self, src_weights=dyn_src,
                                             dst_weights=dyn_dst), False, 2),
        "neighbor_allreduce dynamic int8": (
            lambda x: bft.neighbor_allreduce(x, self_weight=dyn_self, src_weights=dyn_src,
                                             dst_weights=dyn_dst, compression="int8"),
            True, 2),
        "neighbor_allgather": (gather(None), True, 4),
        "neighbor_allgather bf16": (gather("bf16"), True, 4),
        "neighbor_allgather int8": (gather("int8"), True, 4),
        "neighbor_allgather int4": (gather("int4"), True, 4),
        "hierarchical_neighbor_allreduce": (
            lambda x: bft.hierarchical_neighbor_allreduce(x), False, 2),
        "pair_gossip": (lambda x: bft.pair_gossip(x, [(0, 5), (1, 2), (3, 7)]), False, 2),
    }


def nonblocking_ops():
    """One nonblocking op of each kind, ``name -> (start, blocking twin)``."""
    dyn_self, dyn_src, dyn_dst = one_peer_weights()
    return {
        "allreduce": (bft.allreduce_nonblocking, bft.allreduce),
        "allgather": (bft.allgather_nonblocking, bft.allgather),
        "broadcast": (lambda x: bft.broadcast_nonblocking(x, 3), lambda x: bft.broadcast(x, 3)),
        "neighbor_allreduce int8": (
            lambda x: bft.neighbor_allreduce_nonblocking(
                x, self_weight=dyn_self, src_weights=dyn_src, dst_weights=dyn_dst,
                compression="int8"),
            lambda x: bft.neighbor_allreduce(
                x, self_weight=dyn_self, src_weights=dyn_src, dst_weights=dyn_dst,
                compression="int8")),
        "neighbor_allgather int4": (
            lambda x: bft.neighbor_allgather_nonblocking(x, compression="int4"),
            lambda x: bft.neighbor_allgather(x, compression="int4")),
        "hierarchical_neighbor_allreduce": (bft.hierarchical_neighbor_allreduce_nonblocking,
                                            bft.hierarchical_neighbor_allreduce),
        "pair_gossip": (lambda x: bft.pair_gossip_nonblocking(x, [(0, 5)]),
                        lambda x: bft.pair_gossip(x, [(0, 5)])),
    }


def as_tensor(out):
    return torch.stack(out) if isinstance(out, list) else out


def phase_facade(device, rate, n=RESNET50_WIDTH):
    """Every facade op on ``[8, n]`` f32 on the card, timed once with CUDA
    events beside its byte bound, against the same call on a CPU copy of
    the input (the plain versions); then one nonblocking op of each kind
    through ``synchronize`` against its blocking twin on the card. Returns
    the launch counts of the card's ops, zeroed just before and read just
    after."""
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(SIZE, n, generator=gen, device=device) * 5.0
    x_cpu = x.cpu()
    ops = facade_ops()
    results, counts = {}, {k: 0 for k in launch_counts()}
    for name, (call, _exact, _factor) in ops.items():
        facade_context(device)
        reset_launch_counts()
        call(x)  # warm-up: the allocator's first segments
        sync(device)
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = as_tensor(call(x))
            end.record()
            sync(device)
            ms = start.elapsed_time(end)
        else:
            out, ms = as_tensor(call(x)), float("nan")
        for k, v in launch_counts().items():
            counts[k] += v
        results[name] = (out.cpu(), ms)
        del out
    t0 = time.perf_counter()
    facade_context(torch.device("cpu"))
    for name, (call, exact, factor) in ops.items():
        t_cpu = time.perf_counter()
        want = as_tensor(call(x_cpu))
        t_cpu = time.perf_counter() - t_cpu
        got, ms = results.pop(name)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"facade {name}: {tuple(got.shape)} {got.dtype} on the card, "
                                 f"{tuple(want.shape)} {want.dtype} on the CPU")
        scale = float(want.abs().max())
        same = torch.equal(bits(got), bits(want))
        err = 0.0 if same else float((got - want).abs().max())
        bound = factor * x.numel() * x.element_size() / rate * 1e3
        log("facade", f"{name}: {ms:.3f} ms on the card (bound {bound:.3f} ms, "
                      f"{100 * bound / ms:.1f}% of it), max |card - cpu| {err:.3g} "
                      f"({'bitwise equal' if same else f'tolerance {FACADE_TOL * scale:.3g}'}); "
                      f"the CPU's call {t_cpu:.2f} s")
        if exact and not same:
            raise AssertionError(f"facade {name}: not bitwise equal to the CPU's result "
                                 f"(max diff {err:.3g})")
        if not err <= FACADE_TOL * scale:
            raise AssertionError(f"facade {name}: max |card - cpu| {err:.3g} > "
                                 f"{FACADE_TOL} * {scale:.3g}")
        del want, got
    log("facade", f"CPU references in {time.perf_counter() - t0:.1f} s")
    del x_cpu
    facade_context(device)
    for name, (start_op, blocking) in nonblocking_ops().items():
        reset_launch_counts()
        handle = start_op(x)
        polled = bft.poll(handle)
        got = as_tensor(bft.synchronize(handle))
        want = as_tensor(blocking(x))
        for k, v in launch_counts().items():
            counts[k] += v
        if not bft.poll(handle) or not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"facade {name}_nonblocking: synchronize differs from "
                                 "the blocking op, or the handle is still pending")
        log("facade", f"{name}_nonblocking: synchronize bitwise equal to the blocking op "
                      f"(poll before synchronize: {polled})")
        del got, want
    bft.barrier()
    del x
    log("facade", f"launches {counts}")
    return counts


def train_step_tiers():
    """``name -> (factory, compression, K, delayed)`` of the train-step
    phase."""
    return {
        "atc": (bft.DistributedAdaptThenCombineOptimizer, None, 1, False),
        "atc/int8": (bft.DistributedAdaptThenCombineOptimizer, "int8", 1, False),
        "atc/int4_ef": (bft.DistributedAdaptThenCombineOptimizer, "int4_ef", 1, False),
        "grad-allreduce": (bft.DistributedGradientAllreduceOptimizer, None, 1, False),
        "hier/int8": (bft.DistributedHierarchicalNeighborAllreduceOptimizer, "int8", 1, False),
        "cta k=2": (bft.DistributedNeighborAllreduceOptimizer, None, 2, False),
        "atc/int8 delayed": (bft.DistributedAdaptThenCombineOptimizer, "int8", 1, True),
    }


def phase_train_step(device, sm, images, labels, warmup=1, timed=2, smi=""):
    """ResNet50 through ``opt.make_train_step(sm.worker_loss)``: each tier
    ``warmup + timed`` fused steps from the replicated parameters, then
    (all but the delayed tier) the same steps as two programs,
    ``loss_and_grad`` then ``opt.step``, from the same parameters and
    batch statistics: the parameters must agree bit for bit. cuDNN runs
    its deterministic algorithms here, so two runs of one gradient agree.
    Returns ``(launch counts of the fused steps, each zeroed just before
    a tier's fused run and read just after, {tier: numbers})``."""
    bft.init(size=SIZE, device=device, nodes_per_machine=LOCAL)
    bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
    bft.set_machine_topology(topo.RingGraph(SIZE // LOCAL))
    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    params0 = sm.replicate()
    workers = torch.arange(SIZE)  # host-side worker indices: no read-back per worker
    counts = {k: 0 for k in launch_counts()}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    numbers = {}
    try:
        for name, (factory, compression, k, delayed) in train_step_tiers().items():
            row = {}
            for fused in ((True,) if delayed else (True, False)):
                sm.load_buffers(stats0)
                opt = factory(bft.sgd(0.1, momentum=0.9), num_steps_per_communication=k)
                opt.compression = compression
                params = params0.clone()
                state = opt.init(params)
                if fused:
                    step = opt.make_train_step(sm.worker_loss, delayed=delayed)
                else:
                    grads = torch.empty_like(params)
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                if fused:
                    reset_launch_counts()
                times, losses = [], []
                for i in range(warmup + timed):
                    sync(device)
                    t0 = time.perf_counter()
                    if fused:
                        params, state, loss = step(params, state, images, labels, workers)
                        sync(device)
                        t1 = t2 = time.perf_counter()
                    else:
                        loss = sm.loss_and_grad(params, images, labels, grads)[0]
                        sync(device)
                        t1 = time.perf_counter()
                        opt.step(params, state, grads)
                        sync(device)
                        t2 = time.perf_counter()
                    losses.append(loss.float().cpu())
                    if i >= warmup:
                        times.append((t2 - t0, t1 - t0, t2 - t1))
                if fused:
                    row["launches"] = launch_counts()
                    for key, v in row["launches"].items():
                        counts[key] += v
                table = torch.stack(losses)
                if not torch.isfinite(table).all() or not torch.isfinite(params).all():
                    raise AssertionError(f"train-step {name}: non-finite loss or parameters")
                med = [statistics.median(t[c] for t in times) for c in range(3)]
                peak = (torch.cuda.max_memory_allocated(device) / 2**30
                        if device.type == "cuda" else float("nan"))
                if fused:
                    row.update(step_s=med[0], peak_gib=peak, params=params,
                               losses=[float(r.mean()) for r in table])
                else:
                    row.update(fb_s=med[1], opt_ms=med[2] * 1e3, two_program_step_s=med[0],
                               two_program_peak_gib=peak)
                    fused_params = row.pop("params")
                    if not torch.equal(bits(fused_params), bits(params)):
                        raise AssertionError(
                            f"train-step {name}: the fused parameters differ from the "
                            f"two-program path's (max diff "
                            f"{float((fused_params - params).abs().max()):.3g})")
                    if name == "atc/int8":
                        one_bucket_params = fused_params
                    del fused_params
                opt.free()
                del opt, state, params
                grads = None
            row.pop("params", None)
            numbers[name] = row
        # atc/int8 in JAX's default 4 MiB buckets, two-program: the same bits
        # as the stacked transport's one bucket; its launches count with the
        # fused tiers'
        os.environ["BLUEFOG_BUCKET_BYTES"] = str(4 << 20)
        try:
            sm.load_buffers(stats0)
            opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
            opt.compression = "int8"
            params = params0.clone()
            state = opt.init(params)
            grads = torch.empty_like(params)
            opt_times, step_launches = [], []
            for i in range(warmup + timed):
                sm.loss_and_grad(params, images, labels, grads)
                sync(device)
                reset_launch_counts()
                t1 = time.perf_counter()
                opt.step(params, state, grads)
                sync(device)
                if i >= warmup:
                    opt_times.append(time.perf_counter() - t1)
                step_launches.append(launch_counts())
                for key, v in step_launches[-1].items():
                    counts[key] += v
            if not torch.equal(bits(one_bucket_params), bits(params)):
                raise AssertionError(
                    "train-step atc/int8: 4 MiB buckets changed the parameters (max diff "
                    f"{float((one_bucket_params - params).abs().max()):.3g})")
            numbers["atc/int8 4 MiB buckets"] = dict(
                opt_ms=statistics.median(opt_times) * 1e3,
                launches={k: step_launches[-1][k] for k in ("encode", "decode_accumulate")})
            opt.free()
            del opt, state, params, grads, one_bucket_params
        finally:
            del os.environ["BLUEFOG_BUCKET_BYTES"]
        # the delayed tier has no two-program form: time the fused step on a
        # zero-cost loss (its gradient pass a row copy per worker), beside
        # atc/int8's on the same loss
        for name in ("atc/int8", "atc/int8 delayed"):
            factory, compression, k, delayed = train_step_tiers()[name]
            opt = factory(bft.sgd(0.1, momentum=0.9), num_steps_per_communication=k)
            opt.compression = compression
            params = params0.clone()
            state = opt.init(params)
            step = opt.make_train_step(lambda row, *_batch: row.sum() * 0.0, delayed=delayed)
            times = []
            for i in range(warmup + timed):
                sync(device)
                t0 = time.perf_counter()
                step(params, state, images, labels, workers)
                sync(device)
                if i >= warmup:
                    times.append(time.perf_counter() - t0)
            numbers[name]["zero_loss_ms"] = statistics.median(times) * 1e3
            opt.free()
            del opt, state, params
    finally:
        torch.backends.cudnn.deterministic = deterministic
        sm.load_buffers(stats0)
    delayed_row = numbers["atc/int8 delayed"]
    delayed_row["opt_ms"] = delayed_row["zero_loss_ms"]
    log("train-step", f"fused step on a zero-cost loss: atc/int8 "
                      f"{numbers['atc/int8']['zero_loss_ms']:.1f} ms, atc/int8 delayed "
                      f"{delayed_row['zero_loss_ms']:.1f} ms")
    steps_run = warmup + timed
    one = {k: numbers["atc/int8"]["launches"][k] // steps_run
           for k in ("encode", "decode_accumulate")}
    capped = numbers.pop("atc/int8 4 MiB buckets")
    log("train-step", f"atc/int8 buckets: default (one bucket, the stacked transport), "
                      f"optimizer {numbers['atc/int8']['opt_ms']:.1f} ms, "
                      f"encode/decode_accumulate launches a step "
                      f"{one['encode']}/{one['decode_accumulate']}; BLUEFOG_BUCKET_BYTES="
                      f"{4 << 20} (JAX's default cap), optimizer {capped['opt_ms']:.1f} ms, "
                      f"launches a step {capped['launches']['encode']}/"
                      f"{capped['launches']['decode_accumulate']}; parameters bitwise equal; "
                      f"on {smi}")
    for name, row in numbers.items():
        row.pop("launches", None)
        opt_from = ("the two-program opt.step" if "two_program_step_s" in row
                    else "the fused step on a zero-cost loss")
        log("train-step", f"{name}: step {row['step_s']:.4f} s, "
                          f"{SIZE * images.shape[1] / row['step_s']:.1f} images/s, optimizer "
                          f"{row['opt_ms']:.1f} ms ({opt_from}), peak {row['peak_gib']:.2f} GiB; "
                          "losses "
                          f"{', '.join(f'{v:.5f}' for v in row['losses'])}"
                          + ("" if "two_program_step_s" not in row else
                             f"; two-program step {row['two_program_step_s']:.4f} s "
                             f"(forward+backward {row['fb_s']:.4f} s), parameters bitwise "
                             "equal to the fused step's")
                          + f"; on {smi}")
    log("train-step", f"launches of the fused steps {counts}")
    bft.init(size=SIZE, device=device)
    return counts, numbers


# the observability phase: (tier, wire); metrics on at interval 1 (every
# step sampled, the timeline and the flight recorder on) takes 1 warm-up and
# 3 timed steps; metrics off and metrics on at interval 10 take 1 warm-up and
# OBS_TIMED10 timed steps, a whole interval, whose last step is the sampled
# one; metrics off is read after OBS_WARMUP + OBS_TIMED steps as well
OBS_TIERS = (("atc/int8", "int8"), ("atc/int4_ef", "int4_ef"))
OBS_WARMUP, OBS_TIMED, OBS_TIMED10 = 1, 3, 10
OBS_GAUGE_TOL = 1e-6  # relative: the card's gauges against the CPU fold
OBS_ROOT = "build/observability"
# the top-level keys of the JAX package's flight dump (bluefog_tpu/flight.py
# _build_dump, without an elastic session)
FLIGHT_KEYS = ("version", "reason", "process_index", "clock", "world", "comm_plans",
               "fault_events", "advisories", "autotune_decisions", "slo_snapshots",
               "metrics", "events", "dump_history")


def obs_env(metrics_on, interval=1):
    """The metrics knobs of one run."""
    return {"BLUEFOG_METRICS": "1" if metrics_on else "0",
            "BLUEFOG_METRICS_INTERVAL": str(interval)}


def obs_run(device, sm, images, labels, stats0, params0, wire, env, warmup=OBS_WARMUP,
            timed=OBS_TIMED, snap=None):
    """``warmup + timed`` ATC steps on ``wire`` through
    ``opt.make_train_step(sm.worker_loss)`` under ``env``; the optimizer's
    part (``_combine_update``, the probe included) timed between two
    synchronisations. Returns the timed steps' seconds and every step's
    optimizer seconds, the final parameters, momentum and EF copies, the
    same after ``snap`` steps (when given), the first
    ``metrics.sample_elems_cap()`` columns of the last step's combine input
    (the ATC parameters just before the gossip), each step's launches and
    the optimizer."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        sm.load_buffers(stats0)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = wire
        params = params0.clone()
        state = opt.init(params)
        step = opt.make_train_step(sm.worker_loss)
        combine, opt_s = opt._combine_update, []

        def timed_combine(*args, **kwargs):
            sync(device)
            t0 = time.perf_counter()
            out = combine(*args, **kwargs)
            sync(device)
            opt_s.append(time.perf_counter() - t0)
            return out

        opt._combine_update = timed_combine
        drain, drain_s = opt._drain_after_sample, []

        def timed_drain(*args):
            t0 = time.perf_counter()
            drain(*args)
            drain_s.append(time.perf_counter() - t0)

        opt._drain_after_sample = timed_drain
        gossip, last_input = opt._gossip, []

        def capture_gossip(d, params):
            if len(opt_s) == warmup + timed - 1:  # the last step
                last_input.append(params[:, :metrics.sample_elems_cap()].clone())
            return gossip(d, params)

        opt._gossip = capture_gossip
        workers = torch.arange(SIZE)
        times, launches, snapped = [], [], None
        for i in range(warmup + timed):
            before = launch_counts()
            sync(device)
            t0 = time.perf_counter()
            params, state, loss = step(params, state, images, labels, workers)
            sync(device)
            if i >= warmup:
                times.append(time.perf_counter() - t0)
            after = launch_counts()
            launches.append({k: after[k] - before[k] for k in after})
            if not torch.isfinite(loss).all():
                raise AssertionError(f"observability {wire}: non-finite loss")
            if i + 1 == snap:
                snapped = {"params": params.clone(), "state": state.clone(),
                           "ef": [t.clone() for pair in (opt._ef or ()) for t in pair]}
        del opt._combine_update, opt._drain_after_sample, opt._gossip
        out = {"times": times, "opt_s": opt_s,
               # the host's fold of the previous sample and the start of this
               # one's copy (0 when no step was sampled)
               "drain_ms": 1e3 * statistics.median(drain_s[warmup:] or [0.0]),
               "params": params, "state": state,
               "ef": [t.clone() for pair in (opt._ef or ()) for t in pair],
               "snap": snapped, "last_input": last_input[0] if last_input else None,
               "launches": launches, "opt": opt}
        return out
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def obs_gauges():
    """The probe's ``bluefog.gossip.*`` gauges (not the accounting's rounds)."""
    return {k: v["value"] for k, v in metrics.snapshot().items()
            if k.startswith("bluefog.gossip.") and k != "bluefog.gossip.rounds"}


def obs_stall(device, root):
    """One ``synchronize`` that waits behind ``torch.cuda._sleep`` past the
    watchdog's deadline: ``bluefog.stalls`` must rise by one and the flight
    recorder must write a dump naming the wait. Returns ``(seconds waited,
    dump path)``."""
    stalls = metrics.counter("bluefog.stalls").value
    x = torch.ones(SIZE, 1 << 10, device=device)
    watchdog.set_stall_timeout(0.25)
    try:
        torch.cuda._sleep(int(2e9))  # about a second of a busy SM at ~1.8 GHz
        handle = bft.allreduce_nonblocking(x)
        t0 = time.perf_counter()
        bft.synchronize(handle)
        waited = time.perf_counter() - t0
        time.sleep(0.3)  # the watchdog polls every 0.0625 s at this deadline
    finally:
        watchdog.set_stall_timeout(60)
    path = os.path.join(root, "flight", "flight_0.json")
    if metrics.counter("bluefog.stalls").value != stalls + 1:
        raise AssertionError(f"observability: a {waited:.2f} s synchronize past a 0.25 s "
                             f"deadline counted {metrics.counter('bluefog.stalls').value - stalls}"
                             " stalls")
    dump = json.load(open(path))
    if dump["reason"] != f"stall:synchronize(handle {handle})":
        raise AssertionError(f"observability: the stall dump's reason is {dump['reason']!r}")
    return waited, path


def phase_observability(device, sm, images, labels, tiers=OBS_TIERS, root=OBS_ROOT, smi=""):
    """The observability base at the main path's width: ResNet50 on the
    weighted Exp2 graph through ``opt.make_train_step``, ATC on each wire
    of ``tiers``, ``OBS_WARMUP + OBS_TIMED10`` steps with metrics off, then
    ``OBS_WARMUP + OBS_TIMED`` with ``BLUEFOG_METRICS=1`` at interval 1
    (every step runs the probe) with the timeline and the flight recorder
    on, then ``OBS_WARMUP + OBS_TIMED10`` at interval 10 (the timed window
    is one whole interval, its last step sampled). Gates: the parameters,
    momentum and EF copies of metrics on bitwise those of metrics off
    after as many steps (cuDNN deterministic); the last step's probe
    output bitwise the first columns of that step's combine (the ATC
    parameters); each ``bluefog.gossip.*`` gauge, folded from the pinned
    copy, within ``OBS_GAUGE_TOL`` of the fold of a synchronous CPU copy
    of the same payload, and ``param_norm`` and ``disagreement`` within it
    of sums over the last step's combine input (copied just before its
    gossip) and output; at interval 10 exactly the warm-up and the last
    timed step sampled; each sampled step launching exactly the probe's
    kernels more than the step with metrics off (int8: one ``encode`` and
    one ``decode_accumulate``; int4_ef: one ``encode_diff`` and a
    ``decode_add`` a round); the timeline parses with the ``ENQUEUE``
    spans and ``ph:"C"`` counters; a flight dump parses with the JAX
    package's keys; on the card a forced stall. Returns the launch counts
    of the phase (zeroed just before each tier, read just after) and the
    numbers."""
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    os.environ["BLUEFOG_FLIGHT_DIR"] = os.path.join(root, "flight")
    try:
        bft.init(size=SIZE, device=device)
        bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
        rounds = len(bft.get_context().static_plan().rounds)
        stats0 = {k: v.clone() for k, v in sm.buffers.items()}
        params0 = sm.replicate()
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        counts = {k: 0 for k in launch_counts()}
        numbers = {}
        try:
            for name, wire in tiers:
                reset_launch_counts()
                off = obs_run(device, sm, images, labels, stats0, params0, wire, obs_env(False),
                              timed=OBS_TIMED10, snap=OBS_WARMUP + OBS_TIMED)
                metrics.reset()
                trace = os.path.join(root, f"trace_{wire}.json")
                bft.timeline_init(trace)
                on = obs_run(device, sm, images, labels, stats0, params0, wire,
                             obs_env(True, 1))
                opt = on["opt"]
                pairs = opt._last_probe
                payload = metrics._payload_map(opt._last_payload, lambda t: t.cpu())
                metrics.flush()  # the pinned copy, after its event
                card = obs_gauges()
                cpu = metrics.fold_device_payload(payload, wire=wire, export=False)
                bft.timeline_shutdown()
                on10 = obs_run(device, sm, images, labels, stats0, params0, wire,
                               obs_env(True, 10), timed=OBS_TIMED10)
                counts = {k: counts[k] + v for k, v in launch_counts().items()}
                # the training bits
                short = off["snap"]  # metrics off after as many steps as interval 1 took
                for what, a, b in (("parameters", short["params"], on["params"]),
                                   ("momentum", short["state"], on["state"]),
                                   ("parameters at interval 10", off["params"], on10["params"]),
                                   ("momentum at interval 10", off["state"], on10["state"])):
                    if not torch.equal(bits(a), bits(b)):
                        raise AssertionError(f"observability {name}: metrics on changed the "
                                             f"{what} (max diff {float((a - b).abs().max()):.3g})")
                for what, a, b in (("", short["ef"], on["ef"]),
                                   (" at interval 10", off["ef"], on10["ef"])):
                    if len(a) != len(b) or not all(torch.equal(bits(u), bits(v))
                                                   for u, v in zip(a, b)):
                        raise AssertionError(f"observability {name}: metrics on changed the "
                                             f"EF copies{what}")
                # the probe is the restriction of the full combine
                sub, y, scale, _ef = pairs[0]
                keep = y.shape[1]
                if not torch.equal(bits(y), bits(on["params"][:, :keep])):
                    raise AssertionError(f"observability {name}: the probe's output is not the "
                                         f"first {keep} columns of the combine")
                # the card's gauges against the CPU fold
                bad = {k: (card[k], cpu[k[len("bluefog.gossip."):]]) for k in card
                       if not math.isclose(card[k], cpu[k[len("bluefog.gossip."):]],
                                           rel_tol=OBS_GAUGE_TOL, abs_tol=1e-30)}
                if bad or not card:
                    raise AssertionError(f"observability {name}: gauges against the CPU fold "
                                         f"{bad or card}")
                # two gauges against the last step's own tensors, not the
                # payload: its combine input, copied just before the gossip,
                # and its output (the ATC parameters), each scaled by the
                # square root of the coverage in f32 as the payload is, the
                # per-worker sums in float64 on the card
                sq = torch.tensor(math.sqrt(on["params"].shape[1] / keep), device=device)
                x = (on["last_input"][:, :keep] * sq).double()
                y = (on["params"][:, :keep] * sq).double()
                own = {"bluefog.gossip.param_norm": (x * x).sum(1),
                       "bluefog.gossip.disagreement": ((y - x) ** 2).sum(1)}
                own = {k: float(v.sqrt().mean()) for k, v in own.items()}
                bad = {k: (card[k], v) for k, v in own.items()
                       if not math.isclose(card[k], v, rel_tol=OBS_GAUGE_TOL)}
                if bad:
                    raise AssertionError(f"observability {name}: gauges against the step's "
                                         f"own tensors {bad}")
                # launches: the probe's kernels on every sampled step
                want = ({"encode": 1, "decode_accumulate": 1} if wire == "int8"
                        else {"encode_diff": 1, "decode_add": rounds})
                extra = [{k: a[k] - b[k] for k in a if a[k] != b[k]}
                         for a, b in zip(on["launches"], off["launches"])]
                if device.type == "cuda" and any(e != want for e in extra):
                    raise AssertionError(f"observability {name}: sampled steps launched {extra} "
                                         f"more than steps with metrics off, not {want}")
                # interval 10: the timed window holds exactly one sampled step
                extra10 = [{k: a[k] - b[k] for k in a if a[k] != b[k]}
                           for a, b in zip(on10["launches"], off["launches"])]
                sampled10 = [i for i, e in enumerate(extra10) if e]
                if device.type == "cuda" and sampled10 != [0, OBS_WARMUP + OBS_TIMED10 - 1]:
                    raise AssertionError(f"observability {name}: at interval 10 the sampled "
                                         f"steps were {sampled10}, not the warm-up and the "
                                         "last timed step")
                # the timeline
                events = json.load(open(trace))
                spans = [e for e in events if e.get("cat") == "ENQUEUE"
                         and e["name"] == "fused_train_step"]
                counters = [e for e in events if e.get("ph") == "C"]
                if len(spans) != OBS_WARMUP + OBS_TIMED or not counters:
                    raise AssertionError(f"observability {name}: the timeline holds "
                                         f"{len(spans)} fused_train_step spans and "
                                         f"{len(counters)} counter events")
                w = OBS_WARMUP
                numbers[name] = dict(
                    # medians over interval 1's timed steps and the same
                    # steps of metrics off
                    off=(statistics.median(off["times"][:OBS_TIMED]),
                         1e3 * statistics.median(off["opt_s"][w:w + OBS_TIMED])),
                    on=(statistics.median(on["times"]), 1e3 * statistics.median(on["opt_s"][w:])),
                    # means over a whole interval of 10 steps, one sampled
                    off10=(statistics.mean(off["times"]), 1e3 * statistics.mean(off["opt_s"][w:])),
                    on10=(statistics.mean(on10["times"]),
                          1e3 * statistics.mean(on10["opt_s"][w:])),
                    drain_ms=on["drain_ms"], own=own,
                    extra=extra[-1], keep=keep,
                    scale=scale, gauges=card, trace_events=len(events),
                    counters=len(counters))
                for run in (off, on, on10):
                    run["opt"].free()
                del off, on, on10, opt, pairs, payload
            # the flight recorder
            path = bft.flight_dump()
            dump = json.load(open(path))
            missing = [k for k in FLIGHT_KEYS if k not in dump]
            kinds = {e["kind"] for e in dump["events"]}
            if missing or not {"session_start", "step_begin", "step_dispatched",
                               "plan_compile"} <= kinds:
                raise AssertionError(f"observability: the flight dump lacks {missing} or its "
                                     f"events are {sorted(kinds)}")
            numbers["flight"] = dict(path=path, events=len(dump["events"]), kinds=sorted(kinds))
            if device.type == "cuda":
                numbers["stall"] = obs_stall(device, root)
        finally:
            torch.backends.cudnn.deterministic = deterministic
            sm.load_buffers(stats0)
    finally:
        os.environ.pop("BLUEFOG_FLIGHT_DIR", None)
        bft.shutdown()
        bft.init(size=SIZE, device=device)
    for name, row in numbers.items():
        if name in ("flight", "stall"):
            continue
        (s0, o0), (s1, o1) = row["off"], row["on"]
        (m0, p0), (m10, p10) = row["off10"], row["on10"]
        log("observability", f"{name}: metrics off step {s0:.4f} s, optimizer {o0:.2f} ms; "
                             f"on at interval 1 step {s1:.4f} s ({100 * (s1 / s0 - 1):+.2f}%), "
                             f"optimizer {o1:.2f} ms ({100 * (o1 / o0 - 1):+.2f}%) (medians of "
                             f"{OBS_TIMED} steps; drain {row['drain_ms']:.2f} ms); over a whole "
                             f"interval of {OBS_TIMED10} steps (one sampled) metrics off mean "
                             f"step {m0:.4f} s, optimizer {p0:.2f} ms; on at interval 10 mean "
                             f"step {m10:.4f} s ({100 * (m10 / m0 - 1):+.3f}%), optimizer "
                             f"{p10:.2f} ms ({100 * (p10 / p0 - 1):+.2f}%); probe "
                             f"{row['keep']} columns (scale {row['scale']:.2f}), launches a "
                             f"sampled step adds {row['extra']}; parameters, momentum and EF "
                             f"copies bitwise metrics off; probe output bitwise the combine's; "
                             f"gauges within {OBS_GAUGE_TOL:g} of the CPU fold "
                             f"{ {k[len('bluefog.gossip.'):]: round(v, 6) for k, v in row['gauges'].items()} }"
                             f" and param_norm, disagreement within {OBS_GAUGE_TOL:g} of the "
                             f"step's own tensors in float64 "
                             f"{ {k[len('bluefog.gossip.'):]: round(v, 6) for k, v in row['own'].items()} }; "
                             f"timeline {row['trace_events']} events, {row['counters']} counters; "
                             f"on {smi}")
    log("observability", f"flight dump {numbers['flight']['path']}: "
                         f"{numbers['flight']['events']} events, kinds "
                         f"{numbers['flight']['kinds']}")
    if "stall" in numbers:
        waited, path = numbers["stall"]
        log("observability", f"forced stall: synchronize waited {waited:.2f} s behind "
                             f"torch.cuda._sleep past a 0.25 s deadline; bluefog.stalls +1, "
                             f"dump {path}")
    return counts, numbers


# examples/run_all_examples.sh's invocations, on the port's examples
EXAMPLES = (
    ("torch_average_consensus.py",),
    ("torch_decentralized_optimization.py",),
    ("torch_long_context.py",),
    ("torch_checkpoint_resume.py",),
    ("torch_mnist.py", "--dist-optimizer", "neighbor_allreduce", "--epochs", "80"),
    ("torch_mnist.py", "--dist-optimizer", "gradient_allreduce", "--epochs", "80"),
    ("torch_mnist.py", "--dist-optimizer", "win_put", "--epochs", "80"),
    ("torch_benchmark.py", "--model", "mlp", "--num-iters", "5"),
    ("torch_benchmark.py", "--model", "mlp", "--dynamic", "--num-iters", "5"),
)
EXAMPLE_TIMEOUT = 300


def phase_examples(device, examples=EXAMPLES, timeout=EXAMPLE_TIMEOUT, smi=""):
    """Every invocation of ``examples/run_all_examples.sh`` on the port's
    ``examples/torch_<name>.py`` with the same arguments, as subprocesses
    started together on ``device``: each must exit 0 (mnist's own gate is
    90% accuracy) within ``timeout`` seconds. One line each with its
    seconds and its last line."""
    from concurrent.futures import ThreadPoolExecutor

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BLUEFOG_")}

    def run(argv):
        start = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, os.path.join(root, argv[0]), "--device", device.type,
                 *argv[1:]], capture_output=True, text=True, env=env, timeout=timeout)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = "timeout", e.stdout or "", e.stderr or ""
            out, err = (t.decode() if isinstance(t, bytes) else t for t in (out, err))
        return argv, rc, time.perf_counter() - start, out, err

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(examples)) as pool:
        results = list(pool.map(run, examples))
    failed = []
    for argv, rc, took, out, err in results:
        lines = out.strip().splitlines() or ["(no output)"]
        body = [line for line in lines if line.startswith("[")]
        log("examples", f"{' '.join(argv)}: rc {rc}, {took:.1f} s; "
                        f"{body[-1] if body and body[-1] != lines[-1] else ''} | {lines[-1]}; "
                        f"on {smi}")
        if rc != 0:
            failed.append((argv, rc, err.strip().splitlines()[-5:]))
    log("examples", f"{len(examples)} invocations together in {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError(f"examples failed: {failed}")


def build_trainer(device, stage_sizes=None, num_filters=64, batch=BATCH, image=IMAGE,
                  num_classes=1000, seed=0, rows=None):
    """The ResNet50 of the train phases on ``SIZE`` workers, or on the
    workers ``rows`` of them (a process's rows; the same batches as theirs
    in the ``SIZE``-worker run)."""
    kw = {} if stage_sizes is None else {"stage_sizes": stage_sizes}
    model = resnet.init_flax_like(
        ResNet50(num_classes=num_classes, num_filters=num_filters, **kw), seed
    )
    rows = range(SIZE) if rows is None else rows
    sm = StackedModel(model, len(rows), device)
    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.randn(SIZE, batch, image, image, 3, generator=gen,
                         device=device).to(torch.bfloat16)
    labels = torch.randint(0, num_classes, (SIZE, batch), generator=gen, device=device)
    if len(rows) != SIZE:
        images, labels = images[rows.start:rows.stop].clone(), labels[rows.start:rows.stop].clone()
    return sm, images, labels


def build_lm(device, config=None, seq=LM_SEQ, batch=LM_BATCH, seed=0):
    """The transformer path's model (bf16 compute over f32 parameters) on
    ``SIZE`` workers with the next-token loss, and seeded random tokens
    ``[SIZE, batch, seq]`` (inputs and targets alike)."""
    config = LM_CONFIG if config is None else config
    model = transformer.init_flax_like(TransformerLM(dtype=torch.bfloat16, **config), seed)
    sm = StackedModel(model, SIZE, device, loss=next_token_loss)
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, config["vocab"], (SIZE, batch, seq), generator=gen,
                           device=device)
    return sm, tokens, tokens


class Trainer:
    """Runs and logs the tiers of the train phase on one parameter buffer."""

    def __init__(self, device, sm, inputs, targets):
        self.device, self.sm, self.inputs, self.targets = device, sm, inputs, targets
        self.params = sm.replicate()
        self.grads = torch.empty_like(self.params)
        self.tiers = {}

    def _timed(self, at, opt_step):
        """One step: the gradient at ``at``, then ``opt_step()``; returns
        ``(loss [N], forward+backward s, optimizer s)``. The split
        synchronises the card between the two parts."""
        t0 = time.perf_counter()
        loss, _ = self.sm.loss_and_grad(at, self.inputs, self.targets, self.grads)
        sync(self.device)
        t1 = time.perf_counter()
        opt_step()
        sync(self.device)
        return loss.float().cpu(), t1 - t0, time.perf_counter() - t1

    def run(self, name, warmup, timed, step):
        """``warmup + timed`` calls of ``step() -> (loss, fb s, opt s)``;
        logs the losses, the median timed step and the peak memory."""
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        losses, times = [], []
        for i in range(warmup + timed):
            loss, fb, opt = step()
            losses.append(loss)
            if i >= warmup:
                times.append((fb + opt, fb, opt))
        table = torch.stack(losses)
        if not torch.isfinite(table).all() or not torch.isfinite(self.params).all():
            raise AssertionError(f"{name}: non-finite loss or parameters")
        peak = (torch.cuda.max_memory_allocated(self.device) / 2**30
                if self.device.type == "cuda" else float("nan"))
        med = [statistics.median(t[k] for t in times) for k in range(3)] if times else None
        self.tiers[name] = {"times": times, "median": med, "peak_gib": peak,
                            "losses": [float(r.mean()) for r in table]}
        for i, row in enumerate(table):
            log("train", f"{name} step {i}: mean loss {float(row.mean()):.5f} "
                         f"(workers {float(row.min()):.4f}..{float(row.max()):.4f})")
        if med:
            log("train", f"{name}: median step {med[0]:.4f} s over {len(times)} (steps "
                         f"{', '.join(f'{t[0]:.4f}' for t in times)} s) = forward+backward "
                         f"{med[1]:.4f} s + optimizer {med[2]:.4f} s; peak memory "
                         f"{peak:.2f} GiB")

    def gossip(self, name, order, compression, warmup, timed, lr=0.1):
        make = {"atc": bft.DistributedAdaptThenCombineOptimizer,
                "cta": bft.DistributedNeighborAllreduceOptimizer}[order]
        opt = make(bft.sgd(lr, momentum=0.9))
        opt.compression = compression
        state = opt.init(self.params)
        self.run(name, warmup, timed, lambda: self._timed(
            self.params, lambda: opt.step(self.params, state, self.grads)))
        opt.free()

    def pushsum(self, name, warmup, timed):
        """Push-sum on the int4 window wire, the gradients taken at
        ``params()``; then one step at lr = 0 that must keep the x mass
        (values plus buffers, float64 sums) to 1e-5 of sum |x| and the p
        mass at 8. Returns that step's numbers."""
        os.environ["BLUEFOG_WINDOW_WIRE"] = "int4"
        opt = bft.DistributedPushSumOptimizer(bft.sgd(0.1, momentum=0.9))
        state = opt.init(self.params)
        est = [opt.params()]

        def step():
            def opt_step():
                est[0], _ = opt.step(state, self.grads)
            return self._timed(est[0], opt_step)

        self.run(name, warmup, timed, step)
        win = bft.get_context().windows[opt._name]

        def mass():
            f64 = torch.float64
            x = float(torch.sum(win.value, dtype=f64) + torch.sum(win.buffers, dtype=f64))
            total = float(torch.sum(win.value.abs(), dtype=f64)
                          + torch.sum(win.buffers.abs(), dtype=f64))
            p = float(torch.sum(win.p, dtype=f64) + torch.sum(win.p_buffers, dtype=f64))
            return x, total, p

        x0, abs0, _p0 = mass()
        opt.tx = bft.sgd(0.0, momentum=0.9)
        self.sm.loss_and_grad(est[0], self.inputs, self.targets, self.grads)
        opt.step(state, self.grads)
        sync(self.device)
        x1, _abs1, p1 = mass()
        self.params.copy_(win.value / win.p[:, None])
        opt.free()
        del os.environ["BLUEFOG_WINDOW_WIRE"]
        log("train", f"{name}: lr 0 step: x mass {x0:.9g} -> {x1:.9g} (drift "
                     f"{abs(x1 - x0) / abs0:.3g} of sum |x| = {abs0:.6g}), p mass {p1:.9g}")
        if not abs(x1 - x0) <= 1e-5 * abs0:
            raise AssertionError(f"push-sum x mass drifted {abs(x1 - x0):.4g} (> 1e-5 of {abs0:.4g})")
        if not abs(p1 - SIZE) <= 1e-5:
            raise AssertionError(f"push-sum p mass {p1} is not {SIZE}")


def log_tiers(trainer):
    for name, tier in trainer.tiers.items():
        if tier["median"]:
            step_s, fb_s, opt_s = tier["median"]
            log("train", f"tier {name}: step {step_s:.4f} s, forward+backward {fb_s:.4f} s, "
                         f"optimizer {opt_s:.4f} s, peak {tier['peak_gib']:.2f} GiB")


def phase_train(trainer, warmup=WARMUP, timed=TIMED):
    """The main path, in three paths; returns the launch counts of each,
    zeroed just before the path and read just after."""
    counts = {}
    reset_launch_counts()
    trainer.gossip("atc/int8", "atc", "int8", warmup, timed)
    trainer.gossip("atc/int4", "atc", "int4", 0, 1)
    trainer.gossip("cta/int8", "cta", "int8", 0, 1)
    counts["wire"] = launch_counts()
    reset_launch_counts()
    trainer.gossip("atc/int4_ef", "atc", "int4_ef", 1, 2)
    trainer.gossip("atc/int8_ef", "atc", "int8_ef", 0, 1)
    trainer.gossip("cta/int4_ef", "cta", "int4_ef", 0, 1)
    counts["ef"] = launch_counts()
    reset_launch_counts()
    trainer.pushsum("push-sum/int4", 1, 2)
    counts["push-sum"] = launch_counts()
    return counts


def window_mass(win, rows=None):
    """``(x mass, sum |x|, p mass)`` of a window (of its ``rows`` when
    given): values plus buffers, in float64 sums."""
    f64 = torch.float64
    lanes = (win.value, win.buffers, win.p, win.p_buffers)
    if rows is not None:
        idx = torch.as_tensor(rows, device=win.value.device)
        lanes = tuple(t.index_select(0, idx) for t in lanes)
    v, b, p, pb = lanes
    return (float(torch.sum(v, dtype=f64) + torch.sum(b, dtype=f64)),
            float(torch.sum(v.abs(), dtype=f64) + torch.sum(b.abs(), dtype=f64)),
            float(torch.sum(p, dtype=f64) + torch.sum(pb, dtype=f64)))


def async_ticks(device, sm, images, labels, wire, warmup, timed, max_age):
    """One wire of the async phase: ``make_async_train_step`` over the
    ResNet50 (CTA ``sgd(0.1, 0.9)`` on the ring), ``warmup + timed`` ticks
    with rank ``ASYNC_SLOW`` at one tenth of the cadence. Returns its
    numbers; the launch counts are zeroed just before the ticks and read
    just after."""
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9))
    params = sm.replicate()
    state = opt.init(params)
    step = bft.make_async_train_step(opt, sm.worker_loss, cadence={ASYNC_SLOW: ASYNC_FACTOR},
                                     max_age=max_age, policy="drop", wire=wire,
                                     buffers=sm.buffers)
    eng = step.engine
    local_s = []

    def timed_local_step(*args):
        # the due ranks' forward+backward and inner update, timed apart from
        # the exchange and the fold
        sync(device)
        t0 = time.perf_counter()
        eng_local(*args)
        sync(device)
        local_s.append(time.perf_counter() - t0)

    eng_local = eng._local_step
    eng._local_step = timed_local_step
    workers = torch.arange(SIZE)  # host-side worker indices: no read-back per worker
    start = float("nan")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        start = torch.cuda.memory_allocated(device) / 2**30
    losses, ticks, per_tick = [], [], []
    series = ("bluefog.async.ticks", "bluefog.async.local_steps")
    before_series = {k: metrics.counter(k).value for k in series}
    reset_launch_counts()
    for i in range(warmup + timed):
        before, steps_before = launch_counts(), eng._local_steps
        sync(device)
        t0 = time.perf_counter()
        params, state, loss = step(params, state, images, labels, workers)
        sync(device)
        tick_s = time.perf_counter() - t0
        after = launch_counts()
        losses.append(loss.float().cpu())
        per_tick.append({"participants": eng._local_steps - steps_before,
                         "launches": {k: after[k] - before[k] for k in after},
                         "tick_s": tick_s, "local_s": local_s[-1]})
        if i >= warmup:
            ticks.append(per_tick[-1])
    counts = launch_counts()
    del eng._local_step  # the class's method again (no cycle holds the engine)
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else float("nan"))
    win = bft.get_context().windows[eng._name]
    x_mass, abs_mass, p_mass = window_mass(win)
    table = torch.stack(losses)
    if not torch.isfinite(table).all() or not torch.isfinite(params).all():
        raise AssertionError(f"async/{wire}: non-finite loss or estimate")
    if not abs(p_mass - SIZE) <= 1e-5:
        raise AssertionError(f"async/{wire}: p mass {p_mass!r} is not {SIZE}")
    if device.type == "cuda" and wire in ("int8", "int4"):
        short = [i for i, t in enumerate(per_tick)
                 if t["launches"]["encode"] < 1 or t["launches"]["decode"] < 1]
        if short:
            raise AssertionError(f"async/{wire}: ticks {short} launched no encode or decode: "
                                 f"{[t['launches'] for t in per_tick]}")
    timed_s = sum(t["tick_s"] for t in ticks)
    summary = eng.summary()
    # the engine's series against its own summary
    got = {k: metrics.counter(k).value - before_series[k] for k in series}
    want = {"bluefog.async.ticks": summary["ticks"],
            "bluefog.async.local_steps": summary["local_steps"]}
    participants = metrics.gauge("bluefog.async.participants").value
    if got != want or participants != per_tick[-1]["participants"]:
        raise AssertionError(f"async/{wire}: the metrics {got}, participants {participants} "
                             f"differ from the engine's {want}, "
                             f"{per_tick[-1]['participants']}")
    out = {
        "wire": wire, "ticks": summary["ticks"], "local_steps": summary["local_steps"],
        "participation": summary["local_steps"] / (summary["ticks"] * SIZE),
        "participants": [t["participants"] for t in per_tick],
        "tick_s": statistics.median(t["tick_s"] for t in ticks),
        "exchange_ms": statistics.median(1e3 * (t["tick_s"] - t["local_s"]) for t in ticks),
        "local_s": statistics.median(t["local_s"] for t in ticks),
        "images_per_s": images.shape[1] * sum(t["participants"] for t in ticks) / timed_s,
        "start_gib": start, "peak_gib": peak, "stale_drops": summary["stale_drops"],
        "advisories": [a.to_json() for a in eng.advisories],
        "x_mass": x_mass, "abs_mass": abs_mass, "p_mass": p_mass,
        "losses": [float(r.mean()) for r in table], "counts": counts, "series": got,
    }
    if wire == "int8" and device.type == "cuda":
        profile_once(device, "async/int8 tick", lambda: step(params, state, images, labels,
                                                               workers))
    eng.free()
    return out


def phase_async(device, sm, images, labels, wires=ASYNC_WIRES, max_age=ASYNC_MAX_AGE, smi=""):
    """bench.py::run_async's straggler scenario at ResNet50's width:
    ``make_async_train_step`` on ``RingGraph(SIZE, connect_style=1)``, rank
    ``ASYNC_SLOW`` at one tenth of the cadence, ``max_age`` 4, the drop
    policy, on each wire of ``wires``; every loss finite, the p mass at
    ``SIZE``; over the first wire's run the participation ratio at least
    ``1 - 1.5 / SIZE``, ``stale_drops > 0`` and an ``async_staleness``
    advisory naming only the slow rank and only its edges; on the card,
    ``encode`` and ``decode`` launched on every int8/int4 tick. Returns the
    launch counts summed over the wires."""
    bft.init(size=SIZE, device=device)
    bft.set_topology(topo.RingGraph(SIZE, connect_style=1))
    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    counts = {k: 0 for k in launch_counts()}
    runs = []
    for wire, warmup, timed in wires:
        sm.load_buffers(stats0)
        run = async_ticks(device, sm, images, labels, wire, warmup, timed, max_age)
        runs.append(run)
        for k, v in run["counts"].items():
            counts[k] += v
        slow = sorted({r for a in run["advisories"] for r in a["slow_ranks"]})
        log("async", f"{wire}: {run['ticks']} ticks, median tick {run['tick_s']:.4f} s "
                     f"(forward+backward and update of the due ranks {run['local_s']:.4f} s, "
                     f"exchange and fold {run['exchange_ms']:.2f} ms), participants per tick "
                     f"{run['participants']}, participation {run['participation']:.4f}, "
                     f"{run['images_per_s']:.1f} images/s over local steps, peak "
                     f"{run['peak_gib']:.2f} GiB (allocated at the wire's start "
                     f"{run['start_gib']:.2f}), stale_drops {run['stale_drops']}, advisories "
                     f"{len(run['advisories'])} naming slow ranks {slow}, x mass "
                     f"{run['x_mass']:.9g}, p mass {run['p_mass']:.9g}, launches "
                     f"{ {k: v for k, v in run['counts'].items() if v} }, metrics "
                     f"{run['series']} (equal to the engine's summary); on {smi}")
    sm.load_buffers(stats0)
    first = runs[0]
    if first["participation"] < 1 - 1.5 / SIZE:
        raise AssertionError(f"async/{first['wire']}: participation {first['participation']} "
                             f"below {1 - 1.5 / SIZE}")
    if first["stale_drops"] <= 0:
        raise AssertionError(f"async/{first['wire']}: the gate dropped nothing")
    stale = [a for a in first["advisories"] if a["kind"] == "async_staleness"]
    if not stale or any(a["slow_ranks"] != [ASYNC_SLOW] or any(e[0] != ASYNC_SLOW
                                                              for e in a["edges"])
                        for a in stale):
        raise AssertionError(f"async/{first['wire']}: the advisories do not name rank "
                             f"{ASYNC_SLOW} alone: {first['advisories']}")
    log("async", f"{first['wire']}: advisory {stale[0]}")
    bft.init(size=SIZE, device=device)
    return counts, runs


def async_problem(device, wire, lr, ticks, dim=ASYNC_DIM):
    """bench.py::run_async's problem on ``device``: ``0.5 * mean((w -
    target)^2)``, ``z0`` and the targets from ``RandomState(0)``, ring(8),
    rank ``ASYNC_SLOW`` at one tenth of the cadence, ``max_age`` 4. Returns
    the estimates of every tick (on the host) and the window's masses."""
    bft.init(size=SIZE, device=device)
    bft.set_topology(topo.RingGraph(SIZE, connect_style=1))
    rng = np.random.RandomState(0)
    z0 = rng.randn(SIZE, dim).astype(np.float32)
    targets = torch.from_numpy(z0 + rng.randn(SIZE, dim).astype(np.float32)).to(device)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(lr))
    params = {"w": torch.from_numpy(z0).to(device)}
    state = opt.init(params)
    step = bft.make_async_train_step(
        opt, lambda p, t: 0.5 * torch.mean((p["w"] - t) ** 2),
        cadence={ASYNC_SLOW: ASYNC_FACTOR}, max_age=ASYNC_MAX_AGE, wire=wire)
    seq = []
    for _ in range(ticks):
        params, state, _loss = step(params, state, targets)
        seq.append(params["w"].cpu())
    masses = window_mass(bft.get_context().windows[step.engine._name])
    x0 = float(np.sum(z0, dtype=np.float64))
    step.engine.free()
    return torch.stack(seq), masses, x0


def phase_async_check(device, wires=("fp32", "bf16", "int8", "int4"), dim=ASYNC_DIM,
                      ticks=ASYNC_TICKS):
    """bench.py::run_async's problem on the card against a CPU run of the
    same ticks (the plain versions): every tick's estimates within
    ``ASYNC_TOL`` of the largest value; then at ``sgd(0.0)`` the value
    mass stays at its start to ``ASYNC_MASS_TOL`` of ``sum |x|``."""
    for wire in wires:
        cpu, _m, _x0 = async_problem(torch.device("cpu"), wire, ASYNC_LR, ticks, dim)
        card, _m, _x0 = async_problem(device, wire, ASYNC_LR, ticks, dim)
        err = float((card - cpu).abs().max())
        scale = float(cpu.abs().max())
        same = int((card != cpu).sum())
        _seq, (x1, abs1, p1), x0 = async_problem(device, wire, 0.0, ticks, dim)
        log("async", f"card against CPU, {wire}, [{SIZE}, {dim}], {ticks} ticks: max |diff| "
                     f"{err:.3g} ({err / scale:.3g} of the largest value), {same} elements "
                     f"differ of {card.numel()}; lr 0: x mass {x0:.9g} -> {x1:.9g} (drift "
                     f"{abs(x1 - x0) / abs1:.3g} of sum |x|), p mass {p1:.9g}")
        if not err <= ASYNC_TOL * scale:
            raise AssertionError(f"async check {wire}: card and CPU differ by {err} "
                                 f"(> {ASYNC_TOL} of {scale})")
        if not abs(x1 - x0) <= ASYNC_MASS_TOL * abs1 or not abs(p1 - SIZE) <= 1e-5:
            raise AssertionError(f"async check {wire}: mass {x0} -> {x1} (sum |x| {abs1}), "
                                 f"p mass {p1}")
    bft.init(size=SIZE, device=device)


def phase_train_lm(trainer, warmup=1, timed=3):
    """The transformer path: ATC int8 (``warmup + timed`` steps), then ATC
    int4_ef (one warm-up step, which allocates the CHOCO copies, and one
    timed step), under ``sgd(0.01, 0.9)``; returns ``(launch counts,
    flash route counts, steps)``, the counts zeroed just before and read
    just after."""
    reset_launch_counts()
    trainer.gossip("lm atc/int8", "atc", "int8", warmup, timed, lr=0.01)
    trainer.gossip("lm atc/int4_ef", "atc", "int4_ef", 1, 1, lr=0.01)
    return launch_counts(), flash.route_counts(), warmup + timed + 2


def shard_env(shard, grads):
    os.environ["BLUEFOG_SHARD"] = str(int(shard))
    os.environ["BLUEFOG_SHARD_GRADS"] = str(int(grads))


def clear_shard_env():
    for key in ("BLUEFOG_SHARD", "BLUEFOG_SHARD_GRADS"):
        os.environ.pop(key, None)


def plain_ring_scatter(grads, slot, wire, positions=None):
    """The ring reduce-scatter of ``grads [N, P]`` (the ZeRO-2 layout, mean
    over workers) through the plain quantizer, written out apart from the
    port's: worker ``j`` owns slot ``positions[j]`` (default ``j``: every
    worker live; after an elastic re-shard the layout's ``live_index()``,
    a dead worker at position 0, never gathered; zeros past ``P``); its
    own row first, then round ``t = 1 .. N-1``'s row from worker ``j - t``,
    block-quantized on ``wire`` and dequantized."""
    n, width = grads.shape
    positions = list(range(n)) if positions is None else [int(v) for v in positions]

    def owned(sender, j):
        row = grads.new_zeros(slot)
        lo, hi = positions[j] * slot, min((positions[j] + 1) * slot, width)
        if hi > lo:
            row[:hi - lo] = grads[sender, lo:hi]
        return row

    y = torch.stack([owned(j, j) for j in range(n)])
    for t in range(1, n):
        rows = torch.stack([owned((j - t) % n, j) for j in range(n)])
        payload, scales = kernels.encode_reference(kernels.pad_blocks(rows), wire)
        y = y + kernels.unpad_blocks(kernels.dequantize(payload, scales).reshape(n, -1), slot)
        del rows, payload, scales
    return y / torch.tensor(n, dtype=torch.float32)


def zero_scatter_check(opt, params, state, grads):
    """The ZeRO-2 scatter of the timed steps, on their last step's
    gradients ``grads [N, P]``: through the optimizer's own dispatch (its
    wire and chunk count; the EF residuals zeroed first), against the owned
    slots of ``inner.allreduce(grads)`` (the largest difference over the
    largest |gradient|); on int8/int4 also held bitwise against
    :func:`plain_ring_scatter`, at the optimizer's chunk count and at the
    ICI-priced chooser's (the chunked decode). Returns its numbers; the
    launches made here are not counted."""
    ctx = bft.get_context()
    d = opt._resolve_dispatch(ctx, params, True)
    opt._shard_dispatch(ctx, d, params, state, True)
    wire = d.scatter_wire
    if wire in ("int8_ef", "int4_ef"):
        opt._scatter_ef = [torch.zeros_like(e) for e in opt._scatter_ef]
    n, width = grads.shape
    own = opt._scatter_own_grads(d, grads)[0]
    scale = float(grads.abs().max())
    mean = inner.allreduce(grads)[0]
    out = dict(wire=wire or "fp32", chunks=d.scatter_chunks[0],
               dev=float((own.reshape(-1)[:width] - mean).abs().max()) / scale)
    del mean
    if wire in ("int8", "int4"):
        from bluefog_tpu_torch import scaling
        from bluefog_tpu_torch.collective import compiler

        slot = d.shard.groups[0].slot
        plain = plain_ring_scatter(grads, slot, wire)
        k_ici = compiler.reduce_scatter_chunks(
            n, scaling.wire_payload_bytes(slot, 4, wire), n_elems=slot)
        chunked = inner._reduce_scatter(grads, tuple(range(n)), slot, True, wire, k_ici,
                                        None, None)
        out.update(plain_bitwise=torch.equal(bits(own), bits(plain)),
                   plain_err=float((own - plain).abs().max()), ici_chunks=k_ici,
                   chunked_bitwise=torch.equal(bits(chunked), bits(plain)))
    return out


def phase_zero(device, sm, tokens, warmup=ZERO_WARMUP, timed=ZERO_TIMED, smi="",
               tiers=ZERO_TIERS):
    """The transformer path's model trained by
    ``DistributedGradientAllreduceOptimizer(adam(1e-4))`` in the tiers of
    ``ZERO_TIERS`` (``loss_and_grad`` then ``opt.step``): each from the same
    replicated parameters and batch statistics, the peak reset at its
    start. Gates: finite losses; zero1's and zero2/fp32's parameters
    bitwise repl's (Adam is elementwise, the gather moves data, and the
    one-chunk fp32 scatter's one sum is the allreduce's); the measured Adam
    state bytes per worker equal to the analytic ones; on the
    int8/int4 tiers ``encode`` and ``decode`` launched on every step; and
    on the last step's gradients (:func:`zero_scatter_check`) each zero2
    tier's scatter, as the optimizer dispatches it, within ``ZERO_SUM_TOL``
    (fp32) or ``ZERO_ENVELOPE`` of the owned slots of the allreduce's mean,
    and the int8/int4 scatters bitwise the plain ring's at the optimizer's
    and the ICI chooser's chunk counts. Returns ``(launch counts of the tiers' steps,
    each tier's zeroed just before its steps and read just after, {tier:
    numbers})``."""
    from bluefog_tpu_torch import scaling

    params0 = sm.replicate()
    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    grads = torch.empty_like(params0)
    counts = {k: 0 for k in launch_counts()}
    numbers, finals = {}, {}
    try:
        for name, shard, grads_on, wire in tiers:
            shard_env(shard, grads_on)
            sm.load_buffers(stats0)
            params = params0.clone()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(ZERO_LR))
            opt.compression = wire
            state = opt.init(params)
            measured = scaling.optimizer_state_bytes(state=state, world=SIZE)
            analytic = scaling.optimizer_state_bytes(params, opt, shard=bool(shard))
            times, losses, per_step = [], [], []
            for i in range(warmup + timed):
                reset_launch_counts()
                sync(device)
                t0 = time.perf_counter()
                loss = sm.loss_and_grad(params, tokens, tokens, grads)[0]
                sync(device)
                t1 = time.perf_counter()
                opt.step(params, state, grads)
                sync(device)
                t2 = time.perf_counter()
                step_counts = launch_counts()
                for key, v in step_counts.items():
                    counts[key] += v
                per_step.append((step_counts["encode"], step_counts["decode"]))
                losses.append(loss.float().cpu())
                if i >= warmup:
                    times.append((t2 - t0, t2 - t1))
            peak = (torch.cuda.max_memory_allocated(device) / 2**30
                    if device.type == "cuda" else float("nan"))
            table = torch.stack(losses)
            if not torch.isfinite(table).all() or not torch.isfinite(params).all():
                raise AssertionError(f"zero {name}: non-finite loss or parameters")
            check = zero_scatter_check(opt, params, state, grads) if grads_on else None
            step_s = statistics.median(t[0] for t in times)
            row = dict(step_s=step_s, tokens_per_s=SIZE * tokens.shape[1] * tokens.shape[2] / step_s,
                       opt_ms=statistics.median(t[1] for t in times) * 1e3, peak_gib=peak,
                       state_bytes=measured, state_bytes_analytic=analytic,
                       launches=per_step[-1], scatter=check,
                       losses=[float(r.mean()) for r in table])
            numbers[name] = row
            enc, dec = row["launches"]
            log("zero", f"{name}: step {row['step_s']:.4f} s, {row['tokens_per_s']:.1f} tokens/s, "
                        f"optimizer {row['opt_ms']:.1f} ms, peak {row['peak_gib']:.2f} GiB; Adam "
                        f"state {row['state_bytes']} B a worker measured, "
                        f"{row['state_bytes_analytic']} B analytic "
                        f"({row['state_bytes'] * SIZE / 1e9:.3f} GB for {SIZE} workers); "
                        f"encode/decode launches a step {enc}/{dec}"
                        + ("" if check is None else
                           f"; scatter ({check['chunks']} chunk(s)) within {check['dev']:.3g} "
                           "of the largest gradient from the allreduce's mean")
                        + ("" if check is None or "plain_bitwise" not in check else
                           f"; against the plain ring: bitwise {check['plain_bitwise']} "
                           f"(max |diff| {check['plain_err']:.3g}), at the ICI chooser's "
                           f"{check['ici_chunks']} chunks bitwise {check['chunked_bitwise']}")
                        + f"; losses {', '.join(f'{v:.5f}' for v in row['losses'])}; on {smi}")
            if measured != analytic:
                raise AssertionError(f"zero {name}: measured state {measured} B a worker, "
                                     f"analytic {analytic} B")
            if device.type == "cuda" and wire in ("int8", "int4") and \
                    not all(e > 0 and d > 0 for e, d in per_step):
                raise AssertionError(f"zero {name}: encode/decode not launched on every step "
                                     f"{per_step}")
            if check is not None:
                if not check["dev"] <= ZERO_ENVELOPE[check["wire"]]:
                    raise AssertionError(f"zero {name}: the scatter is {check['dev']:.3g} of "
                                         f"the largest gradient from the allreduce's mean "
                                         f"(> {ZERO_ENVELOPE[check['wire']]})")
                if not check.get("plain_bitwise", True) or \
                        not check.get("chunked_bitwise", True):
                    raise AssertionError(
                        f"zero {name}: the scatter differs from the plain ring (max |diff| "
                        f"{check['plain_err']:.3g}; at {check['ici_chunks']} chunks bitwise "
                        f"{check['chunked_bitwise']})")
            if name in ("repl", "zero1", "zero2/fp32"):
                finals[name] = params.cpu()
            opt.free()
            del opt, state, params
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        clear_shard_env()
        sm.load_buffers(stats0)
    if "zero1" in finals and not torch.equal(bits(finals["zero1"]), bits(finals["repl"])):
        raise AssertionError("zero: zero1's parameters differ from repl's (max diff "
                             f"{float((finals['zero1'] - finals['repl']).abs().max()):.3g})")
    if "zero2/fp32" in finals and not torch.equal(bits(finals["zero2/fp32"]),
                                                  bits(finals["repl"])):
        diff = (finals["zero2/fp32"] - finals["repl"]).abs()
        raise AssertionError(f"zero: zero2/fp32's parameters differ from repl's (max diff "
                             f"{float(diff.max()):.3g}, {int((diff > 0).sum())} elements)")
    log("zero", "zero1 parameters bitwise repl's" + (
        "; zero2/fp32's bitwise repl's" if "zero2/fp32" in finals else ""))
    return counts, numbers


def zero_problem(device, grads_on, wire, steps=ZERO_CHECK_STEPS):
    """bench.py::run_shard's trajectory problem on ``device`` under
    ZeRO-1/2: returns worker 0's parameters after ``steps`` steps."""
    bft.init(size=SIZE, device=device)
    rng = np.random.RandomState(0)
    rng.randn(SIZE, 262145)  # run_shard's memory problem draws first
    ct = torch.from_numpy(rng.randn(SIZE, ZERO_CHECK_DIM).astype(np.float32)).to(device)
    shard_env(True, grads_on)
    try:
        opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(ZERO_CHECK_LR))
        opt.compression = wire
        params = {"w": torch.zeros(SIZE, ZERO_CHECK_DIM, device=device)}
        state = opt.init(params)
        for _ in range(steps):
            opt.step(params, state, {"w": params["w"] - ct})
    finally:
        clear_shard_env()
    return params["w"][0].cpu(), ct.cpu().numpy()


def zero_oracle(ct, steps=ZERO_CHECK_STEPS, lr=ZERO_CHECK_LR, b1=0.9, b2=0.999, eps=1e-8):
    """bench.py's numpy Adam replay of the replicated run."""
    cm = ct.mean(axis=0)
    x = np.zeros(ct.shape[1], np.float32)
    m, v = x.copy(), x.copy()
    for t in range(1, steps + 1):
        g = x - cm
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        x = x - lr * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + eps)
    return x


def phase_zero_check(device, tiers=ZERO_CHECK_TIERS):
    """bench.py::run_shard's trajectory problem on the card and on the CPU
    in each tier: against the numpy Adam replay (fp32 tiers within
    ``ZERO_ORACLE_TOL``, quantized within ``ZERO_ENVELOPE``), and the card
    against the CPU within ``ZERO_CARD_TOL`` of the largest value (the
    scatter is bitwise; Adam's power and square root may round otherwise
    on the card), saying whether it is bitwise."""
    for name, grads_on, wire in tiers:
        card, ct = zero_problem(device, grads_on, wire)
        cpu, _ct = zero_problem(torch.device("cpu"), grads_on, wire)
        oracle = zero_oracle(ct)
        dev_oracle = float(np.abs(card.numpy() - oracle).max())
        diff = float((card - cpu).abs().max())
        scale = float(cpu.abs().max())
        tol = ZERO_ENVELOPE.get(wire, ZERO_ORACLE_TOL)
        log("zero check", f"{name}: card {dev_oracle:.3g} from the numpy Adam replay (tolerance "
                          f"{tol}); card against CPU max |diff| {diff:.3g} ("
                          f"{'bitwise' if torch.equal(bits(card), bits(cpu)) else 'not bitwise'})")
        if not dev_oracle <= tol:
            raise AssertionError(f"zero check {name}: {dev_oracle} from the numpy replay (> {tol})")
        if not diff <= ZERO_CARD_TOL * scale:
            raise AssertionError(f"zero check {name}: card and CPU differ by {diff} "
                                 f"(> {ZERO_CARD_TOL} of {scale})")
    bft.init(size=SIZE, device=device)


def checkpoint_run(device, sm, images, labels, make_opt, shard, root, steps=(1, 2)):
    """``steps[0]`` steps, a save, ``steps[1]`` more; then a fresh
    optimizer restored from the save and its ``steps[1]`` steps: returns
    ``(uninterrupted parameters, resumed parameters, bytes, save s,
    restore s)``. BatchNorm statistics ride in ``extra``."""
    from bluefog_tpu_torch import checkpoint as ckpt

    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    shard_env(shard, shard)
    try:
        params = sm.replicate()
        grads = torch.empty_like(params)
        opt = make_opt()
        state = opt.init(params)

        def run(opt, params, state, n):
            for _ in range(n):
                sm.loss_and_grad(params, images, labels, grads)
                opt.step(params, state, grads)

        run(opt, params, state, steps[0])
        sync(device)
        t0 = time.perf_counter()
        target = ckpt.save(root, steps[0], params, state, optimizer=opt, extra=sm.buffers)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(target, f)) for f in os.listdir(target))
        run(opt, params, state, steps[1])
        ref = params.cpu()
        opt.free()
        del opt, state, params
        sm.load_buffers(stats0)
        opt2 = make_opt()
        sync(device)
        t0 = time.perf_counter()
        _step, p2, s2 = ckpt.restore(root, optimizer=opt2, extra=sm.buffers)
        sync(device)
        restore_s = time.perf_counter() - t0
        run(opt2, p2, s2, steps[1])
        got = p2.cpu()
        opt2.free()
        del opt2, s2, p2, grads
    finally:
        clear_shard_env()
        sm.load_buffers(stats0)
    return ref, got, nbytes, save_s, restore_s


def phase_checkpoint(device, sm, images, labels, root="build/checkpoint", smi=""):
    """The ResNet50 of the train-step phase: zero2/int8 Adam and ATC
    int4_ef on ``sgd(0.1, 0.9)`` (the CHOCO copies): 1 step, ``save``,
    ``restore`` into a fresh optimizer, 2 more steps; the parameters must
    be bitwise those of 3 uninterrupted steps. cuDNN runs its
    deterministic algorithms; the directory is deleted afterwards."""
    import shutil

    def zero2():
        opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(ZERO_LR))
        opt.compression = "int8"
        return opt

    def atc_ef():
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = "int4_ef"
        return opt

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, make, shard in (("zero2/int8 adam", zero2, True),
                                  ("atc/int4_ef sgd", atc_ef, False)):
            path = os.path.join(root, name.split("/")[0])
            ref, got, nbytes, save_s, restore_s = checkpoint_run(
                device, sm, images, labels, make, shard, path)
            shutil.rmtree(path, ignore_errors=True)
            log("checkpoint", f"{name}: {nbytes / 1e9:.3f} GB saved in {save_s:.2f} s, restored "
                              f"in {restore_s:.2f} s; resumed parameters "
                              f"{'bitwise' if torch.equal(bits(ref), bits(got)) else 'NOT bitwise'}"
                              f" those of 3 uninterrupted steps; on {smi}")
            if not torch.equal(bits(ref), bits(got)):
                raise AssertionError(f"checkpoint {name}: the resumed parameters differ (max "
                                     f"{float((ref - got).abs().max()):.3g})")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)


# the elastic phase (11b): the gossip parts' kill (rank, session step), the
# ZeRO part's and the async part's killed rank; files under ELASTIC_ROOT
ELASTIC_ROOT = "build/elastic"
ELASTIC_KILL = (4, 2)
ELASTIC_REJOIN = 5  # the gossip part's step index the rejoin precedes
ELASTIC_ZERO_KILL = (3, 2)
ELASTIC_ASYNC_KILL = 5
# bench.py::run_elastic's problem: dim, kill step, gradient steps, steps, lr;
# its bound on the survivors' distance from the numpy oracle; the card
# against a CPU copy, of the largest value
ELASTIC_DIM, ELASTIC_KILL_STEP, ELASTIC_GRAD_STEPS, ELASTIC_STEPS = 4096, 5, 12, 48
ELASTIC_LR, ELASTIC_CONSENSUS_TOL, ELASTIC_CARD_TOL = 0.05, 1e-3, 1e-6
# the JAX package's keys of a dump's membership block and of a fault entry
# (bluefog_tpu/flight.py _build_dump)
ELASTIC_MEMBERSHIP_KEYS = ("epoch", "live", "dead", "history")
ELASTIC_FAULT_KEYS = ("kind", "rank", "step", "seconds", "factor")
ELASTIC_SERIES = ("faults", "repairs", "rejoins")  # counters read as deltas


def elastic_series():
    """The ``bluefog.elastic.*`` counters, gauges and the repair-time
    histogram's count."""
    out = {k: metrics.counter(f"bluefog.elastic.{k}").value for k in ELASTIC_SERIES}
    out.update({k: metrics.gauge(f"bluefog.elastic.{k}").value
                for k in ("dead_ranks", "epoch", "last_detect_steps")})
    out["repair_ms_count"] = metrics.histogram("bluefog.elastic.repair_ms").count
    out["repair_ms"] = metrics.histogram("bluefog.elastic.repair_ms").last
    return out


def elastic_gossip_run(device, sm, images, labels, stats0, params0, wire, n_steps,
                       session_on, rejoin_at=None, on_step=None):
    """ResNet50 on the weighted Exp2 graph through ATC ``sgd(0.1, 0.9)`` on
    ``wire``, ``n_steps`` fused steps from ``params0``: with ``session_on``
    through ``bft.elastic.guard(opt).make_train_step`` under a session
    (policy ``average``) that kills rank ``ELASTIC_KILL[0]`` at step
    ``ELASTIC_KILL[1]`` and rejoins it before step ``rejoin_at``; without,
    the twin: ``opt.make_train_step``, the repaired topology installed by
    hand before the kill step, and at the rejoin the topology the rejoin
    installs and ``consensus_restore``. ``on_step(i, params, state, opt,
    session)`` runs after each step. Returns ``(per-step rows, session)``;
    a row holds the step's seconds and launches."""
    from bluefog_tpu_torch.elastic import consensus_restore, repaired_topology

    bft.init(size=SIZE, device=device)
    bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
    base = bft.load_topology()
    rank, kill_step = ELASTIC_KILL
    live = [r for r in range(SIZE) if r != rank]
    sm.load_buffers(stats0)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    opt.compression = wire
    params = params0.clone()
    state = opt.init(params)
    session = None
    if session_on:
        session = bft.elastic.start(policy="average")
        session.inject("kill", rank=rank, step=kill_step)
        step = bft.elastic.guard(opt).make_train_step(sm.worker_loss)
    else:
        step = opt.make_train_step(sm.worker_loss)
    workers = torch.arange(SIZE)
    rows = []
    for i in range(n_steps):
        if i == rejoin_at:
            if session_on:
                params = session.rejoin(rank, params, opt)
            else:
                bft.set_topology(repaired_topology(base, range(SIZE), "average"),
                                 is_weighted=True)
                params = consensus_restore(params, rank, live)
        if not session_on and i == kill_step:
            bft.set_topology(repaired_topology(base, live, "average"), is_weighted=True)
        before = launch_counts()
        sync(device)
        t0 = time.perf_counter()
        params, state, loss = step(params, state, images, labels, workers)
        sync(device)
        after = launch_counts()
        rows.append({"step_s": time.perf_counter() - t0,
                     "launches": {k: after[k] - before[k] for k in after},
                     "loss": float(loss.float().mean())})
        if not torch.isfinite(params).all():
            raise AssertionError(f"elastic {wire}: non-finite parameters at step {i}")
        if on_step is not None:
            on_step(i, params, state, opt, session)
    opt.free()
    return rows, session


def elastic_twin_check(device, sm, images, labels, stats0, params0, wire, n_steps,
                       rejoin_at=None, on_step=None):
    """The session run and its twin (:func:`elastic_gossip_run`): the
    parameters and the momentum bitwise the twin's after every step.
    Returns the session run's rows and session."""
    kept = []

    def keep(i, params, state, opt, session):
        kept.append((params.clone(), state.clone()))
        if on_step is not None:
            on_step(i, params, state, opt, session)

    rows, session = elastic_gossip_run(device, sm, images, labels, stats0, params0, wire,
                                       n_steps, True, rejoin_at, keep)
    bft.elastic.stop()

    def compare(i, params, state, _opt, _session):
        want_p, want_s = kept[i]
        if not (torch.equal(bits(params), bits(want_p)) and torch.equal(bits(state),
                                                                        bits(want_s))):
            raise AssertionError(
                f"elastic {wire}: step {i} differs from the twin (parameters max "
                f"{float((params - want_p).abs().max()):.3g}, momentum max "
                f"{float((state - want_s).abs().max()):.3g})")
        kept[i] = None

    elastic_gossip_run(device, sm, images, labels, stats0, params0, wire, n_steps, False,
                       rejoin_at, compare)
    return rows, session


def elastic_session_gates(name, session, repair_step):
    """One repair at ``repair_step`` with detection and repair in the same
    step, and no stale dispatch."""
    recs = session.repairs
    if len(recs) != 1 or recs[0].step != repair_step or \
            recs[0].steps_to_detect != {ELASTIC_KILL[0]: 0} or recs[0].steps_to_repair != 0:
        raise AssertionError(f"elastic {name}: repairs {recs}")
    if session.stale_dispatches != 0:
        raise AssertionError(f"elastic {name}: {session.stale_dispatches} stale dispatches")


def elastic_gossip(device, sm, images, labels, stats0, params0, root, smi):
    """Part (a), gossip kill and rejoin on int8 (B1, B2), with part (e),
    the checkpoint under the changed live set, saved after step 3 of the
    session run and resumed for one step; returns the part's numbers."""
    from bluefog_tpu_torch import checkpoint as ckpt

    rank, kill_step = ELASTIC_KILL
    flight_dir = os.path.join(root, "flight")
    ckpt_dir = os.path.join(root, "checkpoint")
    os.environ["BLUEFOG_FLIGHT_DIR"] = flight_dir
    checks = {"dump": None, "plans": [], "series0": elastic_series()}

    def on_step(i, params, state, opt, session):
        ctx = bft.get_context()
        if i == kill_step:
            checks["dump"] = json.load(open(os.path.join(flight_dir, "flight_0.json")))
        if kill_step <= i < ELASTIC_REJOIN:
            checks["plans"].append(ctx.static_plan().perms)
        if i == ELASTIC_REJOIN - 2:
            ckpt.save(ckpt_dir, i + 1, params, state, optimizer=opt, extra=sm.buffers)
            checks["saved_info"] = json.load(open(os.path.join(
                ckpt_dir, f"{i + 1}.graph.json")))["graph_info"]
        if i == ELASTIC_REJOIN - 1:
            checks["resume_want"] = (params.clone(), state.clone())
            checks["series_pre_rejoin"] = elastic_series()
        if i == ELASTIC_REJOIN:
            checks["series"] = elastic_series()
            # the context is new and the session opened before any plan
            # was built: every key was built under the session
            checks["keys"] = list(ctx.plan_keys)

    try:
        rows, session = elastic_twin_check(device, sm, images, labels, stats0, params0,
                                           "int8", 1 + ELASTIC_REJOIN, ELASTIC_REJOIN,
                                           on_step)
    finally:
        del os.environ["BLUEFOG_FLIGHT_DIR"]
    elastic_session_gates("gossip int8", session, kill_step)
    touched = [p for p in checks["plans"] if any(rank in e for perm in p for e in perm)]
    if len(checks["plans"]) != ELASTIC_REJOIN - kill_step or touched:
        raise AssertionError(f"elastic gossip: a plan between the repair and the rejoin "
                             f"touches rank {rank}: {touched}")
    untokened = [k for k in checks["keys"] if k[-1] is None]
    if not checks["keys"] or untokened:
        raise AssertionError(f"elastic gossip: plans built without a live token {untokened}")
    dump = checks["dump"]
    if dump["reason"] != f"verdict:dead:rank={rank}" or \
            any(k not in dump for k in FLIGHT_KEYS + ("membership", "faults")) or \
            tuple(dump["membership"]) != ELASTIC_MEMBERSHIP_KEYS or \
            any(tuple(f) != ELASTIC_FAULT_KEYS for f in dump["faults"]) or \
            dump["membership"]["dead"] != [rank]:
        raise AssertionError(f"elastic gossip: the kill's dump {dump.get('reason')!r} has keys "
                             f"{sorted(dump)}, membership {dump.get('membership')}, faults "
                             f"{dump.get('faults')}")
    s0, pre, s1 = checks["series0"], checks["series_pre_rejoin"], checks["series"]
    rec = session.repairs[0]
    want_pre = {"faults": 1, "repairs": 1, "rejoins": 0}
    got_pre = {k: pre[k] - s0[k] for k in ELASTIC_SERIES}
    if got_pre != want_pre or pre["dead_ranks"] != 1 or pre["epoch"] != rec.epoch or \
            pre["last_detect_steps"] != 0 or pre["repair_ms_count"] - s0["repair_ms_count"] != 1 \
            or s1["rejoins"] - s0["rejoins"] != 1 or s1["dead_ranks"] != 0:
        raise AssertionError(f"elastic gossip: the series {pre} / {s1} (from {s0}) differ from "
                             f"the session's records {session.repairs}")
    short = [i for i, r in enumerate(rows)
             if r["launches"]["encode"] < 1 or r["launches"]["decode_accumulate"] < 1]
    if device.type == "cuda" and short:
        raise AssertionError(f"elastic gossip: steps {short} launched no encode or "
                             f"decode_accumulate: {[r['launches'] for r in rows]}")
    if checks["saved_info"]["live_ranks"] != [r for r in range(SIZE) if r != rank]:
        raise AssertionError(f"elastic checkpoint: the graph block lists "
                             f"{checks['saved_info']['live_ranks']}")
    resume = elastic_resume(device, sm, images, labels, ckpt_dir, checks["resume_want"])
    bft.init(size=SIZE, device=device)
    return {"rows": rows, "repair_ms": pre["repair_ms"], "record": rec,
            "resume": resume, "saved_live": checks["saved_info"]["live_ranks"]}


def elastic_resume(device, sm, images, labels, ckpt_dir, want):
    """Part (e): the checkpoint of the 7-live run restored into a fresh
    context under a fresh session, which condemns the missing rank and
    repairs; one step bitwise the uninterrupted run's next. Restored
    without a session it must be refused. Returns the numbers."""
    from bluefog_tpu_torch import checkpoint as ckpt

    rank = ELASTIC_KILL[0]
    bft.init(size=SIZE, device=device)
    bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
    try:
        ckpt.restore(ckpt_dir, optimizer=bft.DistributedAdaptThenCombineOptimizer(
            bft.sgd(0.1, momentum=0.9)))
        refused = None
    except ValueError as exc:
        refused = str(exc)
    if refused is None or "bft.elastic.start()" not in refused:
        raise AssertionError(f"elastic checkpoint: a restore without a session was not "
                             f"refused: {refused!r}")
    bft.init(size=SIZE, device=device)
    bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
    session = bft.elastic.start(policy="average")
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
    opt.compression = "int8"
    t0 = time.perf_counter()
    _step, params, state = ckpt.restore(ckpt_dir, optimizer=opt, extra=sm.buffers)
    restore_s = time.perf_counter() - t0
    if session.membership.dead_ranks() != (rank,) or len(session.repairs) != 1:
        raise AssertionError(f"elastic checkpoint: the restore left dead ranks "
                             f"{session.membership.dead_ranks()}, repairs {session.repairs}")
    step = bft.elastic.guard(opt).make_train_step(sm.worker_loss)
    params, state, _loss = step(params, state, images, labels, torch.arange(SIZE))
    same = torch.equal(bits(params), bits(want[0])) and torch.equal(bits(state), bits(want[1]))
    if not same:
        raise AssertionError(f"elastic checkpoint: the resumed step differs (max "
                             f"{float((params - want[0]).abs().max()):.3g})")
    opt.free()
    bft.elastic.stop()
    import shutil

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"restore_s": restore_s, "refused": refused[:60], "stale": session.stale_dispatches}


def elastic_ef(device, sm, images, labels, stats0, params0):
    """Part (b): the kill on ATC int4_ef (B3, B4), bitwise its twin; the
    CHOCO copies rebuilt exactly at the repair."""
    sigs = []

    def on_step(i, params, state, opt, session):
        sigs.append((opt._ef_sig, id(opt._ef)))

    rows, session = elastic_twin_check(device, sm, images, labels, stats0, params0,
                                       "int4_ef", 4, on_step=on_step)
    bft.elastic.stop()
    elastic_session_gates("ef int4_ef", session, ELASTIC_KILL[1])
    k = ELASTIC_KILL[1]
    changes = [i for i in range(1, len(sigs)) if sigs[i] != sigs[i - 1]]
    if changes != [k] or sigs[k][0][1] == sigs[k - 1][0][1]:
        raise AssertionError(f"elastic ef: the CHOCO copies were rebuilt at steps {changes}, "
                             f"not exactly at the repair step {k}")
    short = [i for i, r in enumerate(rows)
             if r["launches"]["encode_diff"] < 1 or r["launches"]["decode_add"] < 1]
    if device.type == "cuda" and short:
        raise AssertionError(f"elastic ef: steps {short} launched no encode_diff or "
                             f"decode_add: {[r['launches'] for r in rows]}")
    bft.init(size=SIZE, device=device)
    return {"rows": rows}


def elastic_async_run(device, sm, images, labels, stats0, slow, ticks, kept=None):
    """``ticks`` async int8 ticks of the async phase's ResNet50 scenario,
    rank ``ASYNC_SLOW`` at one tenth of the cadence: through ``cadence``
    (``slow=False``; each tick's estimate and due ranks appended to
    ``kept``), or through a session's ``slow`` fault (held bitwise to
    ``kept``). Returns ``(step, params, state, opt, session, dues, tick
    seconds)``; the engine's ``_local_step`` records the due ranks."""
    sm.load_buffers(stats0)
    opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9))
    params = sm.replicate()
    state = opt.init(params)
    kw = dict(max_age=ASYNC_MAX_AGE, policy="drop", wire="int8", buffers=sm.buffers)
    session = None
    if slow:
        session = bft.elastic.start(policy="push_sum")
        session.inject("slow", rank=ASYNC_SLOW, step=0, factor=ASYNC_FACTOR)
        step = bft.make_async_train_step(opt, sm.worker_loss, **kw)
    else:
        step = bft.make_async_train_step(opt, sm.worker_loss,
                                         cadence={ASYNC_SLOW: ASYNC_FACTOR}, **kw)
    eng = step.engine
    dues, times = [], []
    eng_local = eng._local_step

    def local_step(win, opt_state, batch, due):
        dues.append(sorted(int(r) for r in due))
        eng_local(win, opt_state, batch, due)

    eng._local_step = local_step
    workers = torch.arange(SIZE)
    for i in range(ticks):
        sync(device)
        t0 = time.perf_counter()
        params, state, _loss = step(params, state, images, labels, workers)
        sync(device)
        times.append(time.perf_counter() - t0)
        if slow:
            want, want_due = kept[i]
            if not torch.equal(bits(params), bits(want)) or dues[i] != want_due:
                raise AssertionError(f"elastic async: tick {i} under the slow fault differs "
                                     f"from cadence's (due {dues[i]}, cadence {want_due})")
            kept[i] = None
        else:
            kept.append((params.clone(), dues[i]))
    return step, params, state, opt, session, dues, times


def elastic_async(device, sm, images, labels, stats0, warmup=1, timed=4, after=3):
    """Part (d): the async phase's straggler on int8 given as bench.py gives
    it (a session with policy ``push_sum`` and a ``slow`` fault on rank
    ``ASYNC_SLOW`` at factor ``ASYNC_FACTOR``): ``warmup + timed`` ticks
    bitwise those of ``cadence``; then rank ``ELASTIC_ASYNC_KILL`` killed
    and ``after`` ticks at the inner learning rate 0: one re-window, no
    stale dispatch, the dead rank never due, the live p mass 7 and value
    mass kept to ``ASYNC_MASS_TOL`` of ``sum |x|``, each live estimate
    within the pre-kill estimates' elementwise range, widened by one int8
    quantum of their largest magnitude a tick (the wire rounds what it
    delivers; JAX's 1e-4 holds the exact wire), ``encode`` and ``decode``
    on every tick. Returns the part's numbers."""
    bft.init(size=SIZE, device=device)
    bft.set_topology(topo.RingGraph(SIZE, connect_style=1))
    kept = []
    ticks = warmup + timed
    step, *_ = elastic_async_run(device, sm, images, labels, stats0, False, ticks, kept)
    step.engine.free()
    step, params, state, opt, session, dues, times = elastic_async_run(
        device, sm, images, labels, stats0, True, ticks, kept)
    eng = step.engine
    dead = ELASTIC_ASYNC_KILL
    live = [r for r in range(SIZE) if r != dead]
    before = params.clone()
    # a tick on the int8 wire moves an estimate by at most about one int8
    # quantum of the largest value (half of it in what it receives, half in
    # the residual a sender keeps); JAX's 1e-4 holds the exact wire
    slack = after * float(before.abs().max()) / 127
    session.inject("kill", rank=dead, step=session.step)
    opt.tx = bft.sgd(0.0, momentum=0.9)
    workers = torch.arange(SIZE)
    masses, launches = [], []
    for _ in range(after):
        a = launch_counts()
        params, state, _loss = step(params, state, images, labels, workers)
        sync(device)
        b = launch_counts()
        launches.append({k: b[k] - a[k] for k in b})
        masses.append(window_mass(bft.get_context().windows[eng._name], live))
    post_dues = dues[ticks:]
    if len(session.repairs) != 1 or session.stale_dispatches != 0 or eng._rewindows != 1:
        raise AssertionError(f"elastic async: repairs {session.repairs}, stale "
                             f"{session.stale_dispatches}, rewindows {eng._rewindows}")
    if any(dead in d for d in post_dues) or len(post_dues) != after:
        raise AssertionError(f"elastic async: rank {dead} took part after its kill: {post_dues}")
    x0, abs0, _p0 = masses[0]
    for x, ax, p in masses:
        if not abs(x - x0) <= ASYNC_MASS_TOL * ax or not abs(p - len(live)) <= 1e-5:
            raise AssertionError(f"elastic async: live mass {x} (from {x0}, sum |x| {ax}), "
                                 f"p mass {p}")
    idx = torch.as_tensor(live, device=params.device)
    est = params.index_select(0, idx)
    over = float(torch.maximum(est.max(0).values - before.max(0).values,
                               before.min(0).values - est.min(0).values).max())
    if not over <= slack:
        raise AssertionError(f"elastic async: a live estimate left the pre-kill range by "
                             f"{over:.3g} (> {slack:.3g})")
    if device.type == "cuda":
        short = [i for i, c in enumerate(launches) if c["encode"] < 1 or c["decode"] < 1]
        if short:
            raise AssertionError(f"elastic async: ticks {short} after the kill launched no "
                                 f"encode or decode: {launches}")
    eng.free()
    bft.elastic.stop()
    bft.init(size=SIZE, device=device)
    return {"tick_s": statistics.median(times[warmup:]), "dues": dues[:ticks],
            "post_dues": post_dues, "mass": masses, "over": over, "slack": slack,
            "rewindows": eng._rewindows}


def elastic_problem(device):
    """Part (f): bench.py::run_elastic's problem on ``device`` (ATC
    ``sgd(0.05)`` on Exp2(8), rank 4 killed at step 5, 12 gradient steps
    of 48, ``RandomState(0)``). Returns the final parameters, the repair
    record, the consensus distance to the numpy survivor oracle (the
    survivors' mean at the repair plus the later gradients' drift), the
    stale dispatches and the plan keys built under the session."""
    bft.init(size=SIZE, device=device)
    bft.set_topology(topo.ExponentialTwoGraph(SIZE))
    ctx = bft.get_context()
    session = bft.elastic.start(policy="average")
    n0 = len(ctx.plan_keys)
    kill_rank = SIZE // 2
    session.inject("kill", rank=kill_rank, step=ELASTIC_KILL_STEP)
    lr = np.float32(ELASTIC_LR)
    opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(float(lr)))
    guard = bft.elastic.guard(opt)
    rng = np.random.RandomState(0)
    x0 = rng.randn(SIZE, ELASTIC_DIM).astype(np.float32)
    grads = [rng.randn(SIZE, ELASTIC_DIM).astype(np.float32) * 0.1
             for _ in range(ELASTIC_GRAD_STEPS)]
    zeros = torch.zeros(SIZE, ELASTIC_DIM, device=device)
    params = {"w": torch.from_numpy(x0).to(device)}
    state = opt.init(params)
    at_repair = None
    for t in range(ELASTIC_STEPS):
        g = torch.from_numpy(grads[t]).to(device) if t < ELASTIC_GRAD_STEPS else zeros
        if t == ELASTIC_KILL_STEP:
            at_repair = params["w"].cpu().numpy().copy()  # the step updates in place
        params, state = guard.step(params, state, {"w": g})
    final = params["w"].cpu().clone()
    live = list(session.membership.live_ranks())
    target = at_repair[live].mean(axis=0)
    for t in range(ELASTIC_KILL_STEP, ELASTIC_GRAD_STEPS):
        target = target - lr * grads[t][live].mean(axis=0)
    out = {"final": final, "record": session.repairs[0],
           "consensus_dist": float(np.abs(final.numpy()[live] - target).max()),
           "stale": session.stale_dispatches, "keys": list(ctx.plan_keys)[n0:]}
    bft.elastic.stop()
    return out


def elastic_liveness(device, root):
    """Part (g): a ``synchronize`` that waits behind ``torch.cuda._sleep``
    past ``BLUEFOG_LIVENESS_TIMEOUT`` files SUSPECT for every rank of the
    last dispatch, counts ``bluefog.elastic.suspects`` and writes a
    ``verdict:suspect:`` dump; a ``stall`` fault at the deadline is
    condemned and repaired at the next dispatch, a shorter one only counts
    ``bluefog.elastic.stalls``. Returns the numbers."""
    flight_dir = os.path.join(root, "liveness")
    os.environ["BLUEFOG_FLIGHT_DIR"] = flight_dir
    os.environ["BLUEFOG_LIVENESS_TIMEOUT"] = "0.25"
    try:
        bft.init(size=SIZE, device=device)
        bft.set_topology(topo.ExponentialTwoGraph(SIZE))
        session = bft.elastic.start()
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.0))
        guard = bft.elastic.guard(opt)
        params = {"w": torch.ones(SIZE, 1 << 10, device=device)}
        state = opt.init(params)
        params, state = guard.step(params, state, {"w": torch.zeros_like(params["w"])})
        ranks = session._last_dispatch_ranks
        suspects0 = metrics.counter("bluefog.elastic.suspects").value
        watchdog.set_stall_timeout(0.25)
        try:
            if device.type == "cuda":
                torch.cuda._sleep(int(2e9))  # about a second of a busy SM at ~1.8 GHz
            handle = bft.allreduce_nonblocking(params["w"])
            t0 = time.perf_counter()
            bft.synchronize(handle)
            waited = time.perf_counter() - t0
            time.sleep(0.3)  # the watchdog polls every 0.0625 s at this deadline
        finally:
            watchdog.set_stall_timeout(60)
        suspected = [r for r in range(SIZE) if session.membership.state(r).value == "suspect"]
        path = os.path.join(flight_dir, "flight_0.json")
        # the CPU has no late kernel to wait behind: no stall, no dump
        dump = json.load(open(path)) if os.path.exists(path) else {"reason": None}
        counted = metrics.counter("bluefog.elastic.suspects").value - suspects0
        if device.type == "cuda" and (suspected != sorted(ranks) or counted != len(ranks)
                                      or not dump["reason"].startswith("verdict:suspect:")):
            raise AssertionError(f"elastic liveness: a {waited:.2f} s wait past 0.25 s filed "
                                 f"suspects {suspected} of {ranks}, counted {counted}, dump "
                                 f"{dump['reason']!r}")
        stalls0 = metrics.counter("bluefog.elastic.stalls").value
        session.inject("stall", rank=2, step=session.step, seconds=0.1)
        session.inject("stall", rank=6, step=session.step + 1, seconds=0.25)
        for _ in range(2):
            params, state = guard.step(params, state, {"w": torch.zeros_like(params["w"])})
        stalls = metrics.counter("bluefog.elastic.stalls").value - stalls0
        if stalls != 1 or session.membership.dead_ranks() != (6,) or \
                [r.detected for r in session.repairs] != [(6,)] or session.stale_dispatches:
            raise AssertionError(f"elastic liveness: stalls {stalls}, dead "
                                 f"{session.membership.dead_ranks()}, repairs {session.repairs}")
        bft.elastic.stop()
    finally:
        del os.environ["BLUEFOG_FLIGHT_DIR"], os.environ["BLUEFOG_LIVENESS_TIMEOUT"]
    bft.init(size=SIZE, device=device)
    return {"waited": waited, "suspected": suspected, "reason": dump["reason"]}


def phase_elastic(device, sm, images, labels, root=ELASTIC_ROOT, smi=""):
    """The elastic phase's parts (a), (b), (d) and (e) on the ResNet50 of
    the train-step phase, (f) and (g); part (c) is
    :func:`phase_elastic_zero`, on the transformer path's model. cuDNN runs
    its deterministic algorithms. Returns ``(launch counts of the parts,
    each zeroed just before its part and read just after, numbers)``."""
    import shutil

    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    params0 = sm.replicate()
    counts = {k: 0 for k in launch_counts()}
    numbers = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def part(name, fn, *args):
        reset_launch_counts()
        t0 = time.perf_counter()
        numbers[name] = fn(*args)
        numbers[name]["seconds"] = time.perf_counter() - t0
        numbers[name]["counts"] = launch_counts()
        for k, v in numbers[name]["counts"].items():
            counts[k] += v

    try:
        shutil.rmtree(root, ignore_errors=True)
        part("gossip", elastic_gossip, device, sm, images, labels, stats0, params0, root, smi)
        part("ef", elastic_ef, device, sm, images, labels, stats0, params0)
        part("async", elastic_async, device, sm, images, labels, stats0)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        sm.load_buffers(stats0)
        bft.elastic.stop()
    card = elastic_problem(device)
    cpu = elastic_problem(torch.device("cpu"))
    err = float((card["final"] - cpu["final"]).abs().max())
    scale = float(cpu["final"].abs().max())
    detect = max(card["record"].steps_to_detect.values())
    if detect > 1 or card["record"].steps_to_repair != 0 or card["stale"] != 0 or \
            not card["consensus_dist"] < ELASTIC_CONSENSUS_TOL or not card["keys"] or \
            any(k[-1] is None for k in card["keys"]) or not err <= ELASTIC_CARD_TOL * scale:
        raise AssertionError(f"elastic problem: detect {detect}, record {card['record']}, stale "
                             f"{card['stale']}, consensus {card['consensus_dist']}, keys "
                             f"{card['keys']}, card against CPU {err} of {scale}")
    numbers["problem"] = {"detect": detect, "consensus_dist": card["consensus_dist"],
                          "card_err": err, "scale": scale,
                          "bitwise": torch.equal(bits(card["final"]), bits(cpu["final"]))}
    numbers["liveness"] = elastic_liveness(device, root)
    bft.init(size=SIZE, device=device)
    shutil.rmtree(root, ignore_errors=True)
    g, e, a = numbers["gossip"], numbers["ef"], numbers["async"]
    k, rj = ELASTIC_KILL[1], ELASTIC_REJOIN
    per_img = SIZE * images.shape[1]
    log("elastic", f"(a) gossip atc/int8, rank {ELASTIC_KILL[0]} killed at step {k}, rejoined "
                   f"before step {rj}: repair at step {g['record'].step} (detect "
                   f"{g['record'].steps_to_detect}, repair {g['record'].steps_to_repair} steps), "
                   f"repair {g['repair_ms']:.3f} ms; step s before the kill "
                   f"{g['rows'][k - 1]['step_s']:.4f}, at the repair {g['rows'][k]['step_s']:.4f}, "
                   f"after the rejoin {g['rows'][rj]['step_s']:.4f} "
                   f"({per_img / g['rows'][rj]['step_s']:.1f} images/s); parameters and momentum "
                   f"bitwise the twin's after all {len(g['rows'])} steps; no stale dispatch, no "
                   f"plan edge on rank {ELASTIC_KILL[0]} until the rejoin; part "
                   f"{g['seconds']:.1f} s; on {smi}")
    log("elastic", f"(e) checkpoint after the repair lists live {g['saved_live']}; restored "
                   f"under a fresh session in {g['resume']['restore_s']:.2f} s, repaired, one "
                   f"step bitwise the uninterrupted run's; without a session refused "
                   f"({g['resume']['refused']!r}...)")
    ef_steps = ", ".join(f"{r['step_s']:.4f}" for r in e["rows"])
    log("elastic", f"(b) ef atc/int4_ef: step s {ef_steps}; "
                   f"bitwise the twin's, the CHOCO copies rebuilt at step {k} only; part "
                   f"{e['seconds']:.1f} s")
    masses = [(round(x, 6), round(p, 9)) for x, _ax, p in a["mass"]]
    log("elastic", f"(d) async int8, slow rank {ASYNC_SLOW} at factor {ASYNC_FACTOR}: ticks "
                   f"bitwise cadence's (median tick {a['tick_s']:.4f} s, due {a['dues']}); rank "
                   f"{ELASTIC_ASYNC_KILL} killed: {a['rewindows']} re-window, due after "
                   f"{a['post_dues']}, live (x, p) masses {masses}, "
                   f"estimates within {a['over']:.3g} of the pre-kill range (bound {a['slack']:.3g}); "
                   f"part {a['seconds']:.1f} s")
    pr = numbers["problem"]
    lv = numbers["liveness"]
    log("elastic", f"(f) bench.py::run_elastic's problem: detect {pr['detect']} step, consensus "
                   f"distance {pr['consensus_dist']:.3g} (< {ELASTIC_CONSENSUS_TOL}), card against "
                   f"CPU {pr['card_err']:.3g} of {pr['scale']:.4g} "
                   f"({'bitwise' if pr['bitwise'] else 'not bitwise'}); (g) a {lv['waited']:.2f} s "
                   f"synchronize filed suspects {lv['suspected']}, dump {lv['reason']!r}; a 0.1 s "
                   f"stall counted, a 0.25 s stall condemned and repaired")
    log("elastic", f"launches of the parts {counts}")
    return counts, numbers


def phase_elastic_zero(device, sm, tokens, warmup=1, timed=4, smi=""):
    """Part (c) of the elastic phase on the transformer path's model:
    zero2/int8 ``DistributedGradientAllreduceOptimizer(adam(1e-4))`` under
    the guard, rank ``ELASTIC_ZERO_KILL[0]`` killed at step
    ``ELASTIC_ZERO_KILL[1]``, ``warmup + timed`` steps. Gates: exactly one
    re-shard, onto the 7 live ranks; every slot leaf's gathered vector
    bitwise across it; measured Adam state bytes a worker equal to the
    analytic ones for 8 live before and 7 after; the last step's scatter,
    as the optimizer dispatched it, bitwise :func:`plain_ring_scatter` at
    the 7-live owner positions; every parameter row equal and finite;
    ``encode`` and ``decode`` on every step, the flash kernels on ``sm90``.
    Returns the launch counts, zeroed just before and read just after."""
    from bluefog_tpu_torch import scaling
    from bluefog_tpu_torch.optimizers import _gather_slot_rows, tree_leaves

    rank, kill_step = ELASTIC_ZERO_KILL
    live = [r for r in range(SIZE) if r != rank]
    params = sm.replicate()
    grads = torch.empty_like(params)
    shard_env(True, True)
    reset_launch_counts()
    try:
        bft.init(size=SIZE, device=device)
        session = bft.elastic.start(policy="average")
        session.inject("kill", rank=rank, step=kill_step)
        opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(ZERO_LR))
        opt.compression = "int8"
        guard = bft.elastic.guard(opt)
        state = opt.init(params)
        byte_rows = [(scaling.optimizer_state_bytes(state=state, world=SIZE),
                      scaling.optimizer_state_bytes(params, opt, shard=True))]
        moved = {}
        reshard = opt._reshard_state

        def checked_reshard(ctx, old, new, st):
            slots = [(leaf, gi) for leaf in tree_leaves(st)
                     for gi in [opt._shard_slot_group(tuple(leaf.shape), old)] if gi is not None]
            before = [_gather_slot_rows(leaf, old, gi).clone() for leaf, gi in slots]
            reshard(ctx, old, new, st)
            moved["leaves"] = len(slots)
            moved["bitwise"] = all(torch.equal(bits(b), bits(_gather_slot_rows(leaf, new, gi)))
                                   for b, (leaf, gi) in zip(before, slots))
            del before

        opt._reshard_state = checked_reshard
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        rows, peaks = [], []
        for i in range(warmup + timed):
            if i == kill_step:
                peaks.append(torch.cuda.max_memory_allocated(device) / 2**30
                             if device.type == "cuda" else float("nan"))
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
            a = launch_counts()
            sync(device)
            t0 = time.perf_counter()
            sm.loss_and_grad(params, tokens, tokens, grads)
            sync(device)
            t1 = time.perf_counter()
            params, state = guard.step(params, state, grads)
            sync(device)
            b = launch_counts()
            rows.append({"step_s": time.perf_counter() - t0,
                         "opt_ms": (time.perf_counter() - t1) * 1e3,
                         "launches": {k: b[k] - a[k] for k in b}})
        peaks.append(torch.cuda.max_memory_allocated(device) / 2**30
                     if device.type == "cuda" else float("nan"))
        del opt._reshard_state
        byte_rows.append((scaling.optimizer_state_bytes(state=state, world=SIZE),
                          scaling.optimizer_state_bytes(params, opt, shard=True, live=live)))
        layout = opt._shard_layout
        ctx = bft.get_context()
        d = opt._resolve_dispatch(ctx, params, True)
        opt._shard_dispatch(ctx, d, params, state, True)
        own = opt._scatter_own_grads(d, grads)[0]
        plain = plain_ring_scatter(grads, layout.groups[0].slot, "int8",
                                   positions=layout.live_index())
        scatter_bitwise = torch.equal(bits(own), bits(plain))
        del own, plain
        counts = launch_counts()
        routes = flash.route_counts()
        rows_equal = bool((params == params[0:1]).all()) and bool(torch.isfinite(params).all())
        failures = []
        if opt._shard_reshards != 1 or layout.live != tuple(live):
            failures.append(f"reshards {opt._shard_reshards}, live {layout.live}")
        if not moved.get("bitwise") or moved.get("leaves") != 2:
            failures.append(f"the moments moved {moved}")
        if any(m != a for m, a in byte_rows):
            failures.append(f"state bytes measured/analytic {byte_rows}")
        if not scatter_bitwise:
            failures.append("the scatter differs from the plain ring at 7 live")
        if not rows_equal:
            failures.append("parameter rows differ or are not finite")
        if session.stale_dispatches or len(session.repairs) != 1:
            failures.append(f"stale {session.stale_dispatches}, repairs {session.repairs}")
        if device.type == "cuda":
            short = [i for i, r in enumerate(rows)
                     if r["launches"]["encode"] < 1 or r["launches"]["decode"] < 1]
            off = [k for k in FLASH_KERNELS if routes[k]["sm90"] < 1]
            if short or off:
                failures.append(f"steps {short} launched no encode/decode, or no sm90 {off}")
        if failures:
            raise AssertionError(f"elastic zero: {'; '.join(failures)}")
    finally:
        clear_shard_env()
        bft.elastic.stop()
    pre, post = rows[:kill_step], rows[kill_step + 1:]
    log("elastic", f"(c) zero2/int8 adam on the TransformerLM, rank {rank} killed at step "
                   f"{kill_step}: one re-shard onto {layout.live}, {moved['leaves']} moment "
                   f"leaves bitwise across it; step s {pre[-1]['step_s']:.4f} before, "
                   f"{rows[kill_step]['step_s']:.4f} at the re-shard, {post[-1]['step_s']:.4f} "
                   f"after; optimizer ms {pre[-1]['opt_ms']:.1f} / {rows[kill_step]['opt_ms']:.1f}"
                   f" / {post[-1]['opt_ms']:.1f}; peak {peaks[0]:.2f} GiB before, {peaks[1]:.2f} "
                   f"after; Adam state a worker {byte_rows[0][0]} B (8 live) -> {byte_rows[1][0]} "
                   f"B (7 live), measured = analytic; the scatter bitwise the plain ring at 7 "
                   f"live; launches {counts}; on {smi}")
    bft.init(size=SIZE, device=device)
    return counts


# -- 11c. observatories -------------------------------------------------------------------

OBSV_ROOT = "build/observatories"
# (a) the degraded edge, an edge of the weighted Exp2 plan, and its factor
OBSV_DEGRADE = (2, 3, 0.05)
# (b) the stalled edge, the fault's step and its extent, and the breach bound
OBSV_STALL = (2, 3, 2, 3)
OBSV_BOUND = 2
OBSV_OFF = {"BLUEFOG_DOCTOR": "0", "BLUEFOG_STALENESS": "0", "BLUEFOG_MEMORY": "0"}


class env_set:
    """Set environment variables for a ``with`` block, then restore them."""

    def __init__(self, env):
        self.env = {k: str(v) for k, v in env.items()}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def obsv_steps(device, sm, images, labels, stats0, params0, wire, steps, env, delayed=False,
               faults=(), swap_at=None):
    """ATC ``sgd(0.1, 0.9)`` on ``wire`` over the weighted Exp2 graph, ``steps``
    fused steps of ``opt.make_train_step(sm.worker_loss)`` from ``params0``
    and ``stats0``, under ``env`` (set before ``bft.init``, which opens the
    observatory sessions its knobs ask for); with ``faults`` (``(kind,
    kwargs)``) through the guard of an elastic session that injects them;
    ``swap_at``: the step before which the weighted ring replaces the graph.
    cuDNN's deterministic algorithms are the caller's. Returns the final
    parameters and momentum, the step seconds, the optimizer and the open
    sessions."""
    from bluefog_tpu_torch import attribution, memory, staleness

    with env_set({**OBSV_OFF, **env}):
        bft.init(size=SIZE, device=device)
        bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
        sm.load_buffers(stats0)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = wire
        params = params0.clone()
        state = opt.init(params)
        session = None
        if faults:
            session = bft.elastic.start(policy="average")
            for kind, kw in faults:
                session.inject(kind, **kw)
        step = (bft.elastic.guard(opt) if session else opt).make_train_step(
            sm.worker_loss, delayed=delayed)
        workers = torch.arange(SIZE)
        times = []
        for i in range(steps):
            if i == swap_at:
                bft.set_topology(topo.RingGraph(SIZE), is_weighted=True)
            sync(device)
            t0 = time.perf_counter()
            params, state, loss = step(params, state, images, labels, workers)
            sync(device)
            times.append(time.perf_counter() - t0)
            if not torch.isfinite(loss).all():
                raise AssertionError(f"observatories {wire}: non-finite loss at step {i}")
        out = {"params": params, "state": state, "times": times, "opt": opt,
               "session": session, "doctor": attribution.active(),
               "staleness": staleness.active(), "memory": memory.active()}
        bft.elastic.stop()
    return out


def obsv_bitwise(name, a, b):
    if not (torch.equal(bits(a["params"]), bits(b["params"]))
            and torch.equal(bits(a["state"]), bits(b["state"]))):
        raise AssertionError(f"observatories {name}: parameters or momentum differ from the "
                             f"run with the observatories off")


def obsv_tool(args):
    """Run a report tool of ``tools/`` on a dump; returns its JSON report."""
    out = subprocess.run([sys.executable, *args, "--json"], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=os.getcwd()))
    if out.returncode != 0:
        raise AssertionError(f"observatories: {' '.join(args)} exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    return json.loads(out.stdout)


def obsv_doctor(device, sm, images, labels, stats0, params0, rate, root, smi):
    """Part (a): the stacked transport's calibration, the doctor's clean run
    against a doctor-off run, and the degraded edge. Returns the part's
    numbers and the doctor-off run."""
    from bluefog_tpu_torch import attribution
    from bluefog_tpu_torch.collective import compiler

    bft.init(size=SIZE, device=device)
    t0 = time.perf_counter()
    cal = compiler.calibrate(link_class=compiler.TRANSPORT_LINK_CLASS, force=True)
    cal_s = time.perf_counter() - t0
    share = cal["beta_bytes_per_s"] * 2 * SIZE / rate
    if cal["source"] != "measured-probe" or not cal["alpha_s"] > 0 or not 0 < share <= 1:
        raise AssertionError(f"observatories (a): calibration {cal}, beta x 2 x {SIZE} is "
                             f"{share:.3f} of the memory rate {rate:.3g} B/s")
    compiler.clear_calibration(compiler.TRANSPORT_LINK_CLASS)
    off = obsv_steps(device, sm, images, labels, stats0, params0, "int8", 5, {})
    doctor_file = os.path.join(root, "doctor.jsonl")
    env = {"BLUEFOG_DOCTOR": "1", "BLUEFOG_DOCTOR_INTERVAL": "1",
           "BLUEFOG_DOCTOR_FILE": doctor_file}
    on = obsv_steps(device, sm, images, labels, stats0, params0, "int8", 5, env)
    obsv_bitwise("(a) doctor", off, on)
    doc = on["doctor"]
    rounds = len(bft.get_context().static_plan().perms)
    bad = [s["step"] for s in doc.samples
           if len(s.get("rounds", ())) != rounds
           or any("probe_ms" not in r or "predicted_ms" not in r for r in s["rounds"])]
    if len(doc.samples) != 5 or bad or doc.advisories:
        raise AssertionError(f"observatories (a): {len(doc.samples)} samples, samples without "
                             f"a probe a round {bad}, advisories "
                             f"{[a.to_json() for a in doc.advisories]}")
    timed = list(doc.samples)[1:]

    def med(key):
        return statistics.median(s[key] for s in timed)

    numbers = {"cal": cal, "cal_s": cal_s, "share": share, "rounds": rounds,
               "step_ms": med("step_ms"), "dispatch_ms": med("dispatch_ms"),
               "sync_lag_ms": med("sync_lag_ms"), "comm_wire_ms": med("comm_wire_ms"),
               "compute_ms": med("compute_ms"), "anchor_tflops": med("anchor_tflops"),
               "probe_ms": [r["probe_ms"] for r in timed[-1]["rounds"]],
               "predicted_ms": [r["predicted_ms"] for r in timed[-1]["rounds"]],
               "step_s": statistics.median(on["times"][1:]),
               "off_step_s": statistics.median(off["times"][1:])}
    # the degraded edge, on the same doctor session and parameters
    rank, peer, factor = OBSV_DEGRADE
    advisories0 = metrics.counter("bluefog.doctor.advisory.degraded_link").value
    with env_set(env):
        session = bft.elastic.start(policy="average")
        session.inject("degrade", rank=rank, step=0, factor=factor, peer=peer)
        step = bft.elastic.guard(on["opt"]).make_train_step(sm.worker_loss)
        params, state = on["params"], on["state"]
        for _ in range(3):
            params, state, _loss = step(params, state, images, labels, torch.arange(SIZE))
        sync(device)
        bft.elastic.stop()
    linked = [a for a in doc.advisories if a.kind == "degraded_link"]
    others = [a.to_json() for a in doc.advisories if a.kind != "degraded_link"]
    counted = metrics.counter("bluefog.doctor.advisory.degraded_link").value - advisories0
    table = [a for a in flight._build_dump("observatories")["advisories"]
             if a.get("kind") == "degraded_link"]
    lines = [json.loads(line) for line in open(doctor_file)]
    written = [r for r in lines if r.get("advisory_kind") == "degraded_link"]
    if not linked or any(a.detail["edge"] != [rank, peer] for a in linked) or others or \
            counted != len(linked) or not table or any(a["edge"] != [rank, peer] for a in table) \
            or len(written) != len(linked):
        raise AssertionError(f"observatories (a): degraded_link advisories "
                             f"{[a.to_json() for a in linked]}, others {others}, counted "
                             f"{counted}, flight table {table}, written {len(written)}")
    dump = os.path.join(root, "doctor_dump.json")
    bft.doctor.dump(dump)
    report = obsv_tool(["tools/doctor.py", "--attribution", dump])
    if f"{rank}->{peer}" not in " ".join(report["summary"]):
        raise AssertionError(f"observatories (a): tools/doctor.py's summary {report['summary']}")
    numbers.update(degraded=[a.to_json() for a in linked], triage=report["summary"][:2])
    attribution.stop()
    compiler.clear_calibration(compiler.TRANSPORT_LINK_CLASS)
    return numbers, off


def obsv_staleness_async(device, sm, images, labels, stats0, on, ticks=5):
    """The async phase's straggler on int8 (``ticks`` ticks) with the
    staleness observatory at interval 1 (``on``) or off; returns the
    estimate, the state, the observatory and the gate's ages a tick."""
    from bluefog_tpu_torch import staleness

    env = {"BLUEFOG_STALENESS": "1" if on else "0", "BLUEFOG_STALENESS_INTERVAL": "1",
           "BLUEFOG_STALENESS_BOUND": str(ASYNC_MAX_AGE)}
    with env_set({**OBSV_OFF, **env}):
        bft.init(size=SIZE, device=device)
        bft.set_topology(topo.RingGraph(SIZE, connect_style=1))
        sm.load_buffers(stats0)
        opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9))
        params = sm.replicate()
        state = opt.init(params)
        step = bft.make_async_train_step(opt, sm.worker_loss, cadence={ASYNC_SLOW: ASYNC_FACTOR},
                                         max_age=ASYNC_MAX_AGE, policy="drop", wire="int8",
                                         buffers=sm.buffers)
        eng = step.engine
        gate, ages = eng._gate, []

        def spy(ctx, win, participating, slot_ages):
            ages.append([int(slot_ages[r, k]) for r, srcs in enumerate(win.in_neighbors)
                         for k in range(len(srcs))])
            return gate(ctx, win, participating, slot_ages)

        eng._gate = spy
        workers = torch.arange(SIZE)
        for _ in range(ticks):
            params, state, _loss = step(params, state, images, labels, workers)
        win = bft.get_context().windows[eng._name]
        last = eng._slot_ages(win)
        ages.append([int(last[r, k]) for r, srcs in enumerate(win.in_neighbors)
                     for k in range(len(srcs))])
        del eng._gate
        out = {"params": params.clone(), "state": state.clone(), "obs": staleness.active(),
               "ages": ages[1:]}
        eng.free()
    return out


def obsv_staleness(device, sm, images, labels, stats0, params0, off, root):
    """Part (b): the sync, delayed, stalled and async surfaces, each bitwise
    its staleness-off run; the report tool on the dump."""
    from bluefog_tpu_torch import staleness

    env = {"BLUEFOG_STALENESS": "1", "BLUEFOG_STALENESS_INTERVAL": "1",
           "BLUEFOG_STALENESS_BOUND": str(OBSV_BOUND)}
    numbers = {}
    sync_run = obsv_steps(device, sm, images, labels, stats0, params0, "int8", 5, env)
    obsv_bitwise("(b) sync", off, sync_run)
    obs = sync_run["staleness"]
    fails = metrics.peek("bluefog.staleness.selfcheck_failures")
    if len(obs.samples) != 5 or any(s["age_max"] != 0 or not s["lane_ok"] for s in obs.samples) \
            or (fails is not None and fails.value):
        raise AssertionError(f"observatories (b) sync: samples {list(obs.samples)}")
    numbers["sync_edges"] = obs.samples[-1]["edges"]

    swap = 3
    d_off = obsv_steps(device, sm, images, labels, stats0, params0, "int8", 5, {}, delayed=True,
                       swap_at=swap)
    d_on = obsv_steps(device, sm, images, labels, stats0, params0, "int8", 5, env, delayed=True,
                      swap_at=swap)
    obsv_bitwise("(b) delayed", d_off, d_on)
    ages = [s["age_mean"] for s in d_on["staleness"].samples]
    if ages != [0.0, 1.0, 1.0, 0.0, 1.0] or \
            {s["surface"] for s in d_on["staleness"].samples} != {"delayed"}:
        raise AssertionError(f"observatories (b) delayed: ages {ages} (the swap before step "
                             f"{swap})")
    numbers["delayed_ages"] = ages

    src, dst, at, extent = OBSV_STALL
    fault = [("stall", dict(rank=src, step=at, steps=extent, peer=dst))]
    s_off = obsv_steps(device, sm, images, labels, stats0, params0, "int8", 8, {},
                       faults=fault)
    breaches0 = metrics.counter("bluefog.doctor.advisory.staleness_breach").value
    with env_set({"BLUEFOG_STALENESS_FILE": os.path.join(root, "staleness.jsonl")}):
        s_on = obsv_steps(device, sm, images, labels, stats0, params0, "int8", 8, env,
                          faults=fault)
    obsv_bitwise("(b) stall", s_off, s_on)
    obs = s_on["staleness"]
    ramp = [s["age_max"] for s in obs.samples]
    named = [s.get("max_edge") for s in obs.samples if s["age_max"] > 0]
    breaches = [a for a in obs.advisories if a.kind == "staleness_breach"]
    others = {e for e, rec in obs.report()["edge_ages"].items()
              if rec["max"] > 0 and e != f"{src}->{dst}"}
    # the session's step runs one ahead of the step index once the guard
    # has replayed the step's faults, so the hold starts at index at - 1
    if ramp != [0.0] * (at - 1) + [float(k) for k in range(1, extent + 1)] + \
            [0.0] * (9 - at - extent) or any(e != [src, dst] for e in named) or \
            len(breaches) != 1 or breaches[0].detail["edges"] != [[src, dst]] or others or \
            metrics.counter("bluefog.doctor.advisory.staleness_breach").value != breaches0 + 1:
        raise AssertionError(f"observatories (b) stall: ages {ramp} on {named}, breaches "
                             f"{[a.to_json() for a in breaches]}, other aged edges {others}")
    numbers["stall_ramp"] = ramp
    dump = os.path.join(root, "staleness_dump.json")
    staleness.dump(dump)
    report = obsv_tool(["tools/staleness_report.py", dump])
    if report["worst_edge"]["edge"] != f"{src}->{dst}" or not report["breaches"]:
        raise AssertionError(f"observatories (b): tools/staleness_report.py {report}")

    a_off = obsv_staleness_async(device, sm, images, labels, stats0, False)
    a_on = obsv_staleness_async(device, sm, images, labels, stats0, True)
    obsv_bitwise("(b) async", a_off, a_on)
    got = [(s["age_max"], s["age_mean"]) for s in a_on["obs"].samples
           if s["surface"] == "async"]
    want = [(float(max(a)), round(float(np.mean(a)), 4)) for a in a_on["ages"]]
    if got != want or len(got) != 5:
        raise AssertionError(f"observatories (b) async: folded (max, mean) {got}, the gate's "
                             f"{want}")
    numbers["async_ages"] = got
    return numbers


def obsv_all(device, sm, images, labels, stats0, params0, root):
    """Part (d): ATC int4_ef with the doctor, the staleness and the memory
    observatories at interval 10 against all three off, 1 + 10 steps (the
    sampled step 10 falls in the timed window); then a checkpoint save
    under the memory session."""
    from bluefog_tpu_torch import checkpoint as ckpt
    from bluefog_tpu_torch.collective import compiler

    env = {k: "1" for k in OBSV_OFF}
    env.update({f"{k}_INTERVAL": "10" for k in OBSV_OFF})
    off = obsv_steps(device, sm, images, labels, stats0, params0, "int4_ef", 11, {})
    on = obsv_steps(device, sm, images, labels, stats0, params0, "int4_ef", 11, env)
    obsv_bitwise("(d) all three", off, on)
    compiler.clear_calibration(compiler.TRANSPORT_LINK_CLASS)
    samples = (len(on["doctor"].samples), len(on["staleness"].samples), len(on["memory"].samples))
    if samples != (2, 2, 2):
        raise AssertionError(f"observatories (d): samples {samples}, expected 2 each")
    unsampled = statistics.mean(on["times"][1:10])
    with env_set(env):
        t0 = time.perf_counter()
        ckpt.save(os.path.join(root, "checkpoint"), 11, on["params"], on["state"],
                  optimizer=on["opt"], extra=sm.buffers)
        save_s = time.perf_counter() - t0
    phases = on["memory"].phase_peaks
    if phases.get("checkpoint_save", {}).get("count") != 1 or "dispatch" not in phases:
        raise AssertionError(f"observatories (d): phases {phases}")
    return {"off_ms": 1e3 * statistics.mean(off["times"][1:]),
            "on_ms": 1e3 * statistics.mean(on["times"][1:]),
            "unsampled_ms": 1e3 * unsampled,
            "sampled_extra_ms": 1e3 * (on["times"][10] - unsampled),
            "save_s": save_s}


def phase_observatories(device, sm, images, labels, rate, root=OBSV_ROOT, smi=""):
    """Parts (a), (b) and (d) of the observatories phase on the ResNet50 of
    the train-step phase; part (c) is :func:`phase_observatories_lm`. Returns
    ``({part: launch counts, each zeroed just before its part and read just
    after}, numbers)``."""
    import shutil

    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    params0 = sm.replicate()
    counts, numbers = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        a, off = obsv_doctor(device, sm, images, labels, stats0, params0, rate, root, smi)
        numbers["a"] = a
        a["seconds"] = time.perf_counter() - t0
        counts["observatories a"] = launch_counts()
        # the doctor-off run of part (a) is part (b)'s sync baseline
        reset_launch_counts()
        t0 = time.perf_counter()
        b = numbers["b"] = obsv_staleness(device, sm, images, labels, stats0, params0, off, root)
        b["seconds"] = time.perf_counter() - t0
        counts["observatories b"] = launch_counts()
        del off
        reset_launch_counts()
        t0 = time.perf_counter()
        d = numbers["d"] = obsv_all(device, sm, images, labels, stats0, params0, root)
        d["seconds"] = time.perf_counter() - t0
        counts["observatories d"] = launch_counts()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        sm.load_buffers(stats0)
        bft.elastic.stop()
        shutil.rmtree(root, ignore_errors=True)
        bft.init(size=SIZE, device=device)
    cal = a["cal"]
    log("observatories", f"(a) calibration of the stacked transport in {a['cal_s']:.2f} s: "
                         f"alpha {cal['alpha_s'] * 1e6:.2f} us, beta "
                         f"{cal['beta_bytes_per_s']:.4g} B/s (beta x 2 x {SIZE} = "
                         f"{100 * a['share']:.1f}% of {rate:.3g} B/s), pipeline_eff "
                         f"{cal['pipeline_eff']:.3f} (4-chunk gain "
                         f"{cal['probe_gain_2round_4chunk']:.3f}); doctor at interval 1 on "
                         f"ResNet50 atc/int8: bitwise the doctor-off run, {a['rounds']} rounds "
                         f"probed a sample (probe ms {a['probe_ms']}, predicted "
                         f"{a['predicted_ms']}), no advisory; medians step_ms "
                         f"{a['step_ms']:.2f}, dispatch_ms {a['dispatch_ms']:.2f}, sync_lag_ms "
                         f"{a['sync_lag_ms']:.2f}, comm_wire_ms {a['comm_wire_ms']:.3f}, "
                         f"compute_ms {a['compute_ms']:.2f}, anchor_tflops "
                         f"{a['anchor_tflops']:.3f}; step s {a['step_s']:.4f} (doctor off "
                         f"{a['off_step_s']:.4f}); degrade {OBSV_DEGRADE[0]}->{OBSV_DEGRADE[1]} "
                         f"at {OBSV_DEGRADE[2]}: {len(a['degraded'])} degraded_link advisories, "
                         f"all on that edge (ratios {[x['ratio'] for x in a['degraded']]}), "
                         f"triage {a['triage']}; part {a['seconds']:.1f} s; on {smi}")
    log("observatories", f"(b) staleness at interval 1, bound {OBSV_BOUND}: sync age 0 on all "
                         f"{b['sync_edges']} edges, no self-check failure; delayed ages "
                         f"{b['delayed_ages']} (swap before step 3); stall "
                         f"{OBSV_STALL[0]}->{OBSV_STALL[1]} at step {OBSV_STALL[2]} for "
                         f"{OBSV_STALL[3]}: age_max {b['stall_ramp']}, one breach on that edge; "
                         f"async int8 (max, mean) ages {b['async_ages']} = the gate's; every run "
                         f"bitwise staleness off; part {b['seconds']:.1f} s")
    log("observatories", f"(d) atc/int4_ef, all three at interval 10 against off: bitwise; mean "
                         f"step {d['on_ms']:.1f} ms (off {d['off_ms']:.1f} ms), the unsampled "
                         f"steps {d['unsampled_ms']:.1f} ms, the sampled step "
                         f"{d['sampled_extra_ms']:+.1f} ms more; checkpoint_save phase "
                         f"recorded ({d['save_s']:.2f} s); part {d['seconds']:.1f} s")
    log("observatories", f"launches of the parts {counts}")
    return counts, numbers


def obsv_lm_run(device, sm, tokens, params0, zero, env, steps=3, oom_at=None):
    """The TransformerLM under ``adam(ZERO_LR)`` gradient allreduce,
    replicated or zero2/int8 (``zero``), ``steps`` two-program steps under
    ``env``; with ``oom_at`` through the guard of a session that injects an
    ``oom`` fault at that step. Returns the memory observatory, the last
    sample's allocator reading beside it, the step the fault raised at and
    the analytic state bytes a worker."""
    from bluefog_tpu_torch import memory, scaling

    shard_env(zero, zero)
    raised = None
    try:
        with env_set({**OBSV_OFF, **env}):
            bft.init(size=SIZE, device=device)
            params = params0.clone()
            grads = torch.empty_like(params)
            opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(ZERO_LR))
            opt.compression = "int8" if zero else None
            state = opt.init(params)
            step = opt.step
            if oom_at is not None:
                session = bft.elastic.start(policy="average")
                session.inject("oom", rank=0, step=oom_at)
                step = bft.elastic.guard(opt).step
            for i in range(steps):
                sm.loss_and_grad(params, tokens, tokens, grads)
                try:
                    params, state = step(params, state, grads)
                except memory.SimulatedResourceExhausted:
                    raised = i
                    break
                if i == steps - 1:
                    reading = {"allocated": torch.cuda.memory_allocated(device)
                               if device.type == "cuda" else None,
                               "reserved": torch.cuda.memory_reserved(device)
                               if device.type == "cuda" else None}
            obs = memory.active()
            analytic = scaling.optimizer_state_bytes(params, opt, shard=zero)
            bft.elastic.stop()
            del params, grads, state, opt
    finally:
        clear_shard_env()
    return obs, (reading if raised is None else None), raised, analytic


def obsv_census_gates(name, obs, analytic, reading):
    s = obs.samples[-1]
    if s["measured_state_bytes"] != analytic or s["analytic_state_bytes"] != analytic:
        raise AssertionError(f"observatories (c) {name}: census opt_state {s['measured_state_bytes']}"
                             f" B a worker, analytic {analytic} B")
    dev = s["device_bytes_in_use"]
    classified = sum(r["bytes"] for c, r in s["census"].items() if c != "other")
    if dev is not None and (classified > dev or s["live_bytes_total"] > dev):
        raise AssertionError(f"observatories (c) {name}: census {classified} B classified, total "
                             f"{s['live_bytes_total']} B over the {dev} B allocated")
    gib = {c: r["bytes"] / 2**30 for c, r in s["census"].items()}
    return {"gib": gib, "allocated_gib": (dev or 0) / 2**30,
            "reserved_gib": (reading["reserved"] or 0) / 2**30 if reading else float("nan"),
            "rss_gib": s["host_peak_rss_bytes"] / 2**30, "state_bytes": analytic,
            "watermark": obs._peak_bytes}


def phase_observatories_lm(device, sm, tokens, root=OBSV_ROOT, smi=""):
    """Part (c) of the observatories phase on the transformer path's model:
    the memory observatory under replicated and zero2/int8 Adam, the budget,
    the ``oom`` fault and a real ``torch.OutOfMemoryError``. Returns the
    launch counts, zeroed just before and read just after."""
    import shutil

    from bluefog_tpu_torch import memory

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    params0 = sm.replicate()
    env = {"BLUEFOG_MEMORY": "1", "BLUEFOG_MEMORY_INTERVAL": "1"}
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        z_obs, z_read, _, z_bytes = obsv_lm_run(device, sm, tokens, params0, True, env)
        z = obsv_census_gates("zero2/int8", z_obs, z_bytes, z_read)
        budget = int(1.1 * z["watermark"])
        benv = {**env, "BLUEFOG_MEMORY_BUDGET": str(budget)}
        zb_obs, _, _, _ = obsv_lm_run(device, sm, tokens, params0, True, benv)
        r_obs, r_read, _, r_bytes = obsv_lm_run(device, sm, tokens, params0, False, benv)
        r = obsv_census_gates("replicated", r_obs, r_bytes, r_read)
        pressure = [a for a in r_obs.advisories if a.kind == "memory_pressure"]
        if zb_obs.advisories or len(pressure) != 1 or not pressure[0].detail["shard_hint"]:
            raise AssertionError(f"observatories (c): budget {budget} B, zero2 advisories "
                                 f"{[a.to_json() for a in zb_obs.advisories]}, replicated "
                                 f"{[a.to_json() for a in r_obs.advisories]}")
        flight_dir = os.path.join(root, "flight")
        faults0 = metrics.counter("bluefog.elastic.oom_faults").value
        events0 = metrics.counter("bluefog.memory.oom_events").value
        with env_set({"BLUEFOG_FLIGHT_DIR": flight_dir}):
            o_obs, _, raised, _ = obsv_lm_run(device, sm, tokens, params0, False, env,
                                              steps=4, oom_at=2)
        dump_path = os.path.join(flight_dir, "flight_0.json")
        dump = json.load(open(dump_path))
        ooms = [x for x in dump["advisories"] if x.get("kind") == "oom"]
        counted = (metrics.counter("bluefog.elastic.oom_faults").value - faults0,
                   metrics.counter("bluefog.memory.oom_events").value - events0)
        report = obsv_tool(["tools/memory_report.py", "--flight", dump_path])
        top = report["postmortems"][0]["top_category"] if report["postmortems"] else None
        if raised != 2 or len(ooms) != 1 or ooms[0]["ranked_census"][0]["category"] != \
                "opt_state" or counted != (1, 1) or top != "opt_state":
            raise AssertionError(f"observatories (c) oom: raised at {raised}, advisories {ooms}, "
                                 f"counted {counted}, tools/memory_report.py top {top}")
        # a real allocation failure, larger than the card, through the hook
        # (the CPU rehearsal hands the hook the exception's type alone)
        prev = memory._prev_excepthook
        memory._prev_excepthook = lambda *a: None
        try:
            if device.type == "cuda":
                torch.empty(1 << 40, dtype=torch.uint8, device=device)
                raise AssertionError("observatories (c): a 1 TiB allocation did not fail")
            raise torch.OutOfMemoryError("CUDA out of memory (rehearsal)")
        except torch.OutOfMemoryError as e:
            memory._excepthook(type(e), e, e.__traceback__)
        finally:
            memory._prev_excepthook = prev
        real = metrics.counter("bluefog.memory.oom_events").value - events0 - 1
        if real != 1:
            raise AssertionError(f"observatories (c): the real OOM counted {real} events")
    finally:
        clear_shard_env()
        bft.elastic.stop()
        shutil.rmtree(root, ignore_errors=True)
        bft.init(size=SIZE, device=device)
    counts = launch_counts()
    seconds = time.perf_counter() - t0

    def cats(c):
        return ", ".join(f"{k} {v:.3f}" for k, v in c["gib"].items())

    log("observatories", f"(c) memory at interval 1 on the TransformerLM: replicated adam "
                         f"census GiB [{cats(r)}], allocated {r['allocated_gib']:.3f}, reserved "
                         f"{r['reserved_gib']:.3f}, host RSS {r['rss_gib']:.3f}; zero2/int8 "
                         f"[{cats(z)}], allocated {z['allocated_gib']:.3f}, reserved "
                         f"{z['reserved_gib']:.3f}; opt_state a worker {r['state_bytes']} B / "
                         f"{z['state_bytes']} B = scaling.optimizer_state_bytes; budget "
                         f"{budget / 2**30:.3f} GiB a worker (1.1x zero2's watermark): "
                         f"memory_pressure with the shard hint on replicated only "
                         f"(opt_state fraction {pressure[0].detail['opt_state_fraction']}); oom "
                         f"fault at step 2 raised, the dump's ranked census "
                         f"{[x['category'] for x in ooms[0]['ranked_census'][:3]]}; a real "
                         f"torch.OutOfMemoryError counted once; launches {counts}; part "
                         f"{seconds:.1f} s; on {smi}")
    return counts


# -- 11d. health and relay -----------------------------------------------------------------

HR_ROOT = "build/health_relay"
# (a) the relay's fabrics (the serpentine ring, a declared 2 x 4 torus) and the
# ResNet50 tiers stepped on each (None: fp32)
HR_DIMS = (None, "2,4")
HR_WIRES = (None, "int8", "int4")
# (a) relay against direct after the first step, while the gradients are still
# the same: JAX's allclose(1e-5) (test_plan_compiler.py, relative and absolute;
# absolute here of the largest value) on every tier, since both plans combine
# the same terms (the same payload bits on int8/int4) in another order
HR_RELAY_TOL = 1e-5
# (b) the lane on the card against fleet_aggregate_np (bench.py::run_health
# claim 3: Exp2(8), rank 6 dead, 12 applications), of the largest value (10)
HR_LANE_TOL = 1e-5
# (b) JAX's bound on the health plane's cost at the default interval
# (bench.py::run_health claim 2): reported beside the measured share, not gated
HR_OVERHEAD_BOUND = 0.01
# (c) consensus steps and the bound on |mixing efficiency - 1| (claim 1)
HR_DECAY_STEPS = 40
HR_DECAY_TOL = 0.15
# (d) the lossy ring edge and its delivery share (claim 4), the killed rank
HR_LOSSY = (2, 3, 0.05)
HR_KILL = 5


def hr_plan_gates(name, plan, direct, dims):
    """A relay plan against its direct twin: every round a partial
    permutation of unit hops on the fabric, the deliveries the edge set
    (the relay simulation ``_check_relay`` passes), the weights the direct
    plan's."""
    from bluefog_tpu_torch.collective import compiler
    from bluefog_tpu_torch.topology import placement

    info = plan.compile_info
    fabric = tuple(int(d) for d in dims.split(",")) if dims else None
    for perm in plan.perms:
        if len({s for s, _ in perm}) != len(perm) or len({d for _, d in perm}) != len(perm) \
                or any(placement.hop_distance(s, d, SIZE, fabric) != 1 for s, d in perm):
            raise AssertionError(f"health-relay (a) {name}: round {perm} is not a partial "
                                 f"permutation of unit hops on {fabric}")
    edges = sorted((s, d) for s, d, _r in direct._edge_rounds())
    compiler._check_relay(plan.perms, info.inject, info.delivery, tuple(edges), SIZE)
    if sorted(e for e, _r in info.delivery) != edges or \
            not np.array_equal(plan.weight_matrix(), direct.weight_matrix()):
        raise AssertionError(f"health-relay (a) {name}: the deliveries or the weights differ "
                             f"from the direct plan's")


def hr_relay_parity(device, dims, n=RESNET50_WIDTH):
    """The relay's exactness and its kernels at full width, outside the
    counted run: integer payloads under dyadic weights (an all-to-all plan)
    bitwise the offset lowering; the int8/int4 relay combine's ``encode``
    and ``decode_accumulate`` (Exp2, and the star whose rounds feed two
    receivers from one origin) and the relay allgather's ``decode`` bitwise
    their plain versions on the card. Returns the largest difference (0)."""
    from bluefog_tpu_torch.collective.plan import plan_from_matrix

    gen = torch.Generator(device=device).manual_seed(7)
    rng = np.random.RandomState(23)
    w = rng.randint(-64, 65, size=(SIZE, SIZE)).astype(np.float64) / 64.0
    mask = rng.rand(SIZE, SIZE) < 0.5
    np.fill_diagonal(mask, True)
    w = np.where(mask, w, 0.0)
    edges = [(i, j) for i in range(SIZE) for j in range(SIZE) if i != j]
    relay = plan_from_matrix(w, edges=edges, method="shortcut")
    direct = plan_from_matrix(w, edges=edges, method="offset")
    x = torch.randint(-8, 9, (SIZE, n), generator=gen, device=device).float()
    got = inner.weighted_combine(x, relay)
    if not torch.equal(bits(got), bits(inner.weighted_combine(x, direct))):
        raise AssertionError(f"health-relay (a) dims {dims}: the dyadic relay combine differs "
                             "from the offset lowering's")
    del got
    x = torch.randn(SIZE, n, generator=gen, device=device) * 5.0
    err = 0.0
    dup = 0
    for graph in (topo.ExponentialTwoGraph(SIZE), topo.StarGraph(SIZE)):
        plan = plan_from_topology(graph, method="shortcut")
        src, _self_w, recv_w = inner.plan_operands(plan, device)
        dup += sum(len(set(r.tolist()) - {-1}) < int((r >= 0).sum()) for r in src.cpu())
        for wire in ("int8", "int4"):
            e, p, s = check_encode(x, wire)
            err = max(err, e, check_decode(x, p, s, src, recv_w, wire))
            for k in range(plan.max_in_degree):
                rows = [plan.in_neighbors[j][k] if k < len(plan.in_neighbors[j]) else -1
                        for j in range(SIZE)]
                err = max(err, check_decode_rows(
                    p, s, torch.tensor(rows, dtype=torch.int32, device=device), wire))
            del p, s
    if not dup:
        raise AssertionError("health-relay (a): no relay round fed two receivers from one "
                             "origin")
    return err


def hr_steps(device, sm, images, labels, stats0, params0, wire, env, steps=3, fused=False,
             capture=False, snap_at=None):
    """ATC ``sgd(0.1, 0.9)`` on ``wire`` over the weighted Exp2 graph under
    ``env`` (set before ``bft.init``): ``steps`` two-program steps
    (``loss_and_grad``, ``opt.step``) or, ``fused``, steps of
    ``opt.make_train_step(sm.worker_loss)`` from ``params0``. Per step
    (``rows``): its dispatch key, whether the federated fabric made it a DCN
    step, step s, optimizer ms (two-program) and launches. ``capture``: the
    combine's input and output on the first DCN step at full width (not the
    metrics probe's prefix). ``snap_at``: the parameters and momentum after
    that many steps. Returns them with the final parameters and momentum,
    those after the first step, the static plan, the median step s and
    optimizer ms over the steps after the first, the fabric, the SLO engine
    and, under a fabric, the ``bluefog.federation.*`` and
    ``bluefog.wire_bytes`` counters' deltas."""
    from bluefog_tpu_torch import federation, slo

    with env_set({**OBSV_OFF, **env}):
        bft.init(size=SIZE, device=device)
        bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
        fab = federation.get_fabric(SIZE)
        names = () if fab is None else (
            "bluefog.federation.ici_wire_bytes", "bluefog.federation.dcn_wire_bytes",
            "bluefog.wire_bytes")
        sm.load_buffers(stats0)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = wire
        params = params0.clone()
        state = opt.init(params)
        captured, keys = [], []
        resolve = opt._resolve_dispatch

        def recording(ctx, p, comm_now):
            d = resolve(ctx, p, comm_now)
            keys.append(d.key)
            combine, key = d.combine, d.key  # not ``d``: it holds ``recorded``

            def recorded(t):
                keep = capture and not captured and key[:2] == ("fed", "dcn") and \
                    t.shape == params.shape
                x = t.clone() if keep else None
                out = combine(t)
                if keep:
                    captured.append((key, x, out.clone()))
                return out

            d.combine = recorded
            return d

        opt._resolve_dispatch = recording
        counters0 = [metrics.counter(n).value for n in names]
        step_fn = opt.make_train_step(sm.worker_loss) if fused else None
        grads = None if fused else torch.empty_like(params)
        workers = torch.arange(SIZE)
        rows, snap = [], None
        for i in range(steps):
            dcn = fab is not None and fab.dcn_step(opt._comm_count)
            before = launch_counts()
            sync(device)
            t0 = time.perf_counter()
            if fused:
                params, state, loss = step_fn(params, state, images, labels, workers)
                t1 = None
            else:
                loss = sm.loss_and_grad(params, images, labels, grads)[0]
                sync(device)
                t1 = time.perf_counter()
                opt.step(params, state, grads)
            sync(device)
            t2 = time.perf_counter()
            after = launch_counts()
            if not torch.isfinite(loss).all():
                raise AssertionError(f"ATC {wire} under {env}: non-finite loss at step {i}")
            rows.append({"dcn": dcn, "key": keys[-1][:2], "step_s": t2 - t0,
                         "opt_ms": None if t1 is None else 1e3 * (t2 - t1),
                         "launches": {k: after[k] - before[k] for k in KERNEL_ROWS}})
            if i == 0:
                first = params.clone()
            if snap_at is not None and i + 1 == snap_at:
                snap = (params.clone(), state.clone())
        timed = rows[1:]
        out = {"params": params, "state": state, "first": first, "rows": rows,
               "captured": captured, "fab": fab, "snap": snap, "engine": slo.active(),
               "plan": bft.get_context().static_plan(),
               "step_s": statistics.median(r["step_s"] for r in timed) if timed else None,
               "opt_ms": None if fused or not timed else
               statistics.median(r["opt_ms"] for r in timed),
               "counters": [metrics.counter(n).value - c0 for n, c0 in zip(names, counters0)]}
        # the class's method again: ``recording`` holds the bound method, and
        # so the optimizer, whose attribute it is (a cycle the collector
        # alone would free, with its device tensors)
        del opt._resolve_dispatch
        opt.free()
    return out


def hr_relay(device, sm, images, labels, stats0, params0, n=RESNET50_WIDTH):
    """Part (a): the relay family on the ResNet50 train step, on the ring
    and a declared 2 x 4 torus: the plan gates and the kernel parity
    (uncounted), then the counted run: fp32, int8 and int4 two-program steps
    under ``BLUEFOG_PLAN_METHOD=shortcut`` against the direct plan (within
    ``HR_RELAY_TOL`` after the first step, the drift after the last
    printed), the relay ``neighbor_allgather`` (exact, int8, int4) bitwise the direct
    plan's; and the EF refusal. Returns ``(numbers, launch counts)``."""
    direct = {str(w): hr_steps(device, sm, images, labels, stats0, params0, w, {})
              for w in HR_WIRES}
    numbers = {"direct": {k: (v["step_s"], v["opt_ms"]) for k, v in direct.items()},
               "direct_rounds": len(direct["None"]["plan"].rounds)}
    counts = {k: 0 for k in launch_counts()}
    for dims in HR_DIMS:
        env = {"BLUEFOG_PLAN_METHOD": "shortcut"}
        if dims:
            env["BLUEFOG_TORUS_DIMS"] = dims
        tag = dims or "ring"
        with env_set(env):
            bft.init(size=SIZE, device=device)
            bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
            plan = bft.get_context().static_plan()
            hr_plan_gates(tag, plan, direct["None"]["plan"], dims)
            err = hr_relay_parity(device, dims, n)
        reset_launch_counts()
        runs = {str(w): hr_steps(device, sm, images, labels, stats0, params0, w, env)
                for w in HR_WIRES}
        drift = {k: float((runs[k]["params"] - direct[k]["params"]).abs().max()
                          / direct[k]["params"].abs().max()) for k in runs}
        first = {k: float((runs[k]["first"] - direct[k]["first"]).abs().max()
                          / direct[k]["first"].abs().max()) for k in runs}
        close = all(torch.allclose(runs[k]["first"], direct[k]["first"], rtol=HR_RELAY_TOL,
                                   atol=HR_RELAY_TOL * float(direct[k]["first"].abs().max()))
                    for k in runs)
        if not close or any(not math.isfinite(v) for v in drift.values()) or \
                any(not r["plan"].relay for r in runs.values()):
            raise AssertionError(f"health-relay (a) {tag}: after the first step {first} from "
                                 f"the direct run (relative to the largest value; allclose "
                                 f"{HR_RELAY_TOL}), after the last {drift}")
        with env_set(env):
            bft.init(size=SIZE, device=device)
            bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
            x = torch.randn(SIZE, n, device=device,
                            generator=torch.Generator(device=device).manual_seed(3))
            gathered = {wire: bft.neighbor_allgather(x, compression=wire)
                        for wire in (None, "int8", "int4")}
            part = launch_counts()
            # the direct plan's gathers, outside the counted run
            os.environ["BLUEFOG_PLAN_METHOD"] = "auto"
            for wire, got in gathered.items():
                want = bft.neighbor_allgather(x, compression=wire)
                if any(not torch.equal(bits(g), bits(v)) for g, v in zip(got, want)):
                    raise AssertionError(f"health-relay (a) {tag}: the relay allgather "
                                         f"({wire}) differs from the direct plan's")
                del want
            del gathered, x
        for k in counts:
            counts[k] += part[k]
        with env_set({**env, "BLUEFOG_PLAN_METHOD": "shortcut"}):
            bft.init(size=SIZE, device=device)
            opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1))
            opt.compression = "int8_ef"
            p = {"w": torch.zeros(SIZE, 1024, device=device)}
            try:
                opt.step(p, opt.init(p), {"w": torch.zeros(SIZE, 1024, device=device)})
            except ValueError as e:
                if "short-cut (relay)" not in str(e):
                    raise
            else:
                raise AssertionError("health-relay (a): int8_ef ran on a relay plan")
        numbers[tag] = {"rounds": len(runs["None"]["plan"].rounds),
                        "inject": runs["None"]["plan"].compile_info.inject,
                        "congestion": runs["None"]["plan"].compile_info.congestion,
                        "runs": {k: (v["step_s"], v["opt_ms"]) for k, v in runs.items()},
                        "first": first, "drift": drift, "parity_err": err,
                        "launches": {k: part[k] for k in ("encode", "decode_accumulate",
                                                          "decode")}}
        del runs
    del direct
    return numbers, counts


def hr_get(url):
    """``(status, body)`` of a GET, the status of an HTTP error included."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def hr_health(device, sm, images, labels, stats0, params0, root):
    """Part (b): the health plane on the ResNet50 ATC int8 step: at
    interval 1 bitwise a health-off twin, the lane's own op-cache key only,
    ``predicted_rate`` the dense oracle's, the three endpoints on
    127.0.0.1; with the staleness and memory observatories on too, their
    fleet slots; the lane on the card against ``fleet_aggregate_np``; then
    the default interval (20) against off over 20 steps. Returns the
    numbers and the launch counts of the health-on runs alone (each zeroed
    just before its run and read just after; the off twins, the lane and
    the scrapes are outside them)."""
    from bluefog_tpu_torch import health
    from bluefog_tpu_torch.topology import spectral

    counts = {k: 0 for k in launch_counts()}

    def counted(steps, env):
        reset_launch_counts()
        out = obsv_steps(device, sm, images, labels, stats0, params0, "int8", steps, env)
        part = launch_counts()
        for k in counts:
            counts[k] += part[k]
        return out

    off = obsv_steps(device, sm, images, labels, stats0, params0, "int8", 5, {})
    off_keys = set(bft.get_context().op_cache)
    env = {"BLUEFOG_HEALTH": "1", "BLUEFOG_HEALTH_INTERVAL": "1",
           "BLUEFOG_HEALTH_FILE": os.path.join(root, "health.jsonl")}
    on = counted(5, env)
    obsv_bitwise("health-relay (b) interval 1", off, on)
    ctx = bft.get_context()
    added = {k[0] for k in set(ctx.op_cache) - off_keys}
    plane = health.active()
    want_rate = spectral.dense_slem(on["opt"]._last_plan.weight_matrix())
    if added != {"health_pushsum"} or len(plane.samples) != 5 or \
            abs(plane.samples[-1]["predicted_rate"] - want_rate) > 1e-12 or \
            any("fleet_error" in s for s in plane.samples):
        raise AssertionError(f"health-relay (b): op-cache keys added {added}, "
                             f"{len(plane.samples)} samples, predicted "
                             f"{plane.samples[-1].get('predicted_rate')} against the oracle's "
                             f"{want_rate}, samples {list(plane.samples)[-1]}")
    srv = health.serve(0, host="127.0.0.1")
    base = f"http://127.0.0.1:{srv.port}"
    served = {p: hr_get(base + p) for p in ("/healthz", "/metrics", "/fleet")}
    srv.close()
    verdict = json.loads(served["/healthz"][1])
    fleet = json.loads(served["/fleet"][1])
    if served["/healthz"][0] != 200 or verdict["status"] != "ok" or \
            served["/metrics"][0] != 200 or \
            b"bluefog_health_samples_total" not in served["/metrics"][1] or \
            fleet["kind"] != "health_dump" or len(fleet["samples"]) != 5:
        raise AssertionError(f"health-relay (b): served {served['/healthz']}, /metrics "
                             f"{served['/metrics'][0]}, /fleet {str(fleet)[:300]}")
    # the lane on the card against the float64 oracle (claim 3)
    w = topo.mixing_matrix(topo.ExponentialTwoGraph(SIZE))
    vals = np.random.RandomState(0).rand(SIZE, len(health.FLEET_FIELDS)) * 10.0
    dev = health.fleet_aggregate(ctx, vals, rounds=12, w=w, dead=[6])
    ora = health.fleet_aggregate_np(w, vals, rounds=12, dead=[6])
    lane_err = max(float(np.max(np.abs(np.array(dev[k]) - np.array(ora[k]))))
                   for k in ("mean", "min", "max"))
    if not lane_err <= HR_LANE_TOL:
        raise AssertionError(f"health-relay (b): the lane is {lane_err:.3g} from the oracle")
    # with the staleness and memory observatories on: their fleet slots
    env_all = {**env, "BLUEFOG_STALENESS": "1", "BLUEFOG_STALENESS_INTERVAL": "1",
               "BLUEFOG_MEMORY": "1", "BLUEFOG_MEMORY_INTERVAL": "1"}
    both = counted(5, env_all)
    obsv_bitwise("health-relay (b) with staleness and memory", off, both)
    plane = health.active()
    srv = health.serve(0, host="127.0.0.1")
    status, body = hr_get(f"http://127.0.0.1:{srv.port}/fleet")
    srv.close()
    rep = json.loads(body)
    vec = plane._local_vector(bft.get_context(), None, list(range(SIZE)))
    fields = health.FLEET_FIELDS
    i_mem = fields.index("mem_bytes_per_rank")
    if status != 200 or "memory" not in rep or rep["memory"]["bytes_per_rank"] <= 0 or \
            not vec[0, i_mem] > 0 or rep["fields"] != list(fields) or \
            vec[0, fields.index("stale_age_max")] != both["staleness"].last_age_max():
        raise AssertionError(f"health-relay (b): /fleet {status} {str(rep)[:400]}, local "
                             f"vector {vec[0]}")
    # the default interval against off, 1 + 20 steps each
    off20 = obsv_steps(device, sm, images, labels, stats0, params0, "int8", 21, {})
    on20 = counted(21, {"BLUEFOG_HEALTH": "1"})
    obsv_bitwise("health-relay (b) interval 20", off20, on20)
    if len(health.active().samples) != 2:
        raise AssertionError(f"health-relay (b): {len(health.active().samples)} samples at "
                             "interval 20 over 21 steps")
    health.stop()
    off_ms = 1e3 * statistics.mean(off20["times"][1:])
    on_ms = 1e3 * statistics.mean(on20["times"][1:])
    return {"rate": want_rate, "lane_err": lane_err, "off_ms": off_ms, "on_ms": on_ms,
            "share": on_ms / off_ms - 1.0,
            "mem_bytes": float(vec[0, i_mem]),
            "age_max": float(vec[0, fields.index("stale_age_max")])}, counts


def hr_distance(x):
    """The mean over workers of each worker's distance to the worker mean,
    in float64 on the device."""
    x64 = x.double()
    return float((x64 - x64.mean(0, keepdim=True)).square().sum(1).sqrt().mean())


def hr_decay(device, n=RESNET50_WIDTH):
    """Part (c): consensus through the port's eager combine on the card at
    ``[8, 25 557 504]`` f32 on the ring and on Exp2, up to
    ``HR_DECAY_STEPS`` steps (stopped where the distance falls under 1e-4
    of the first, as bench.py does): the fitted rate within ``HR_DECAY_TOL``
    of the spectral prediction, Exp2 faster than the ring."""
    from bluefog_tpu_torch import health

    out = {}
    for name, graph in (("ring", topo.RingGraph(SIZE)), ("exp2", topo.ExponentialTwoGraph(SIZE))):
        bft.init(size=SIZE, device=device)
        bft.set_topology(graph)
        ctx = bft.get_context()
        predicted = topo.consensus_decay_rate(topo.mixing_matrix(graph))
        plane = health.start(interval=1)
        x = torch.randn(SIZE, n, device=device,
                        generator=torch.Generator(device=device).manual_seed(11))
        d0, last, steps = None, None, 0
        sync(device)
        t0 = time.perf_counter()
        for t in range(HR_DECAY_STEPS):
            x = bft.neighbor_allreduce(x)
            d = hr_distance(x)
            d0 = d if d0 is None else d0
            if d < d0 * 1e-4:
                break
            last = plane.observe(ctx, step=t, consensus=d)
            steps += 1
        seconds = time.perf_counter() - t0
        eff = last.get("mixing_efficiency")
        if eff is None or abs(eff - 1.0) > HR_DECAY_TOL:
            raise AssertionError(f"health-relay (c) {name}: efficiency {eff} (predicted "
                                 f"{predicted}, measured {last.get('measured_rate')})")
        out[name] = {"predicted": predicted, "measured": last["measured_rate"], "eff": eff,
                     "steps": steps, "ms": 1e3 * seconds / max(steps, 1),
                     "tte": last.get("time_to_eps_steps")}
        health.stop()
        del x
    if not out["exp2"]["measured"] < out["ring"]["measured"]:
        raise AssertionError(f"health-relay (c): Exp2 does not mix faster than the ring {out}")
    return out


def hr_chaos(device, root, n=RESNET50_WIDTH):
    """Part (d): a lossy ring edge (``HR_LOSSY``, replayed on the card's
    combine at full width) under a ``degrade`` fault on that edge:
    ``mixing_degraded`` fires naming it on the counter, the flight side
    table and ``BLUEFOG_HEALTH_FILE``, and ``/healthz`` says warn; then a
    killed rank makes it 503."""
    from bluefog_tpu_torch import health

    src, dst, factor = HR_LOSSY
    path = os.path.join(root, "chaos.jsonl")
    with env_set({"BLUEFOG_HEALTH_FILE": path}):
        bft.init(size=SIZE, device=device)
        bft.set_topology(topo.RingGraph(SIZE))
        ctx = bft.get_context()
        w = topo.mixing_matrix(topo.RingGraph(SIZE))
        session = bft.elastic.start(policy="average")
        session.inject("degrade", rank=src, step=0, factor=factor, peer=dst)
        plane = health.start(interval=1)
        counted0 = metrics.counter("bluefog.doctor.advisory.mixing_degraded").value
        x = torch.randn(SIZE, n, device=device,
                        generator=torch.Generator(device=device).manual_seed(12))
        fired_at = None
        for t in range(50):
            y = bft.neighbor_allreduce(x)
            if t >= 30:
                y[dst] += (1.0 - factor) * w[src, dst] * (x[dst] - x[src])
            x = y
            plane.observe(ctx, step=t, consensus=hr_distance(x))
            if fired_at is None and plane.advisories:
                fired_at = t
            if fired_at is not None and t >= fired_at + 2:
                break
        advs = [a for a in plane.advisories if a.kind == "mixing_degraded"]
        counted = metrics.counter("bluefog.doctor.advisory.mixing_degraded").value - counted0
        table = [a for a in flight._build_dump("health")["advisories"]
                 if a.get("kind") == "mixing_degraded"]
        written = [r for r in (json.loads(line) for line in open(path))
                   if r.get("advisory_kind") == "mixing_degraded"]
        srv = health.serve(0, host="127.0.0.1")
        warn = hr_get(f"http://127.0.0.1:{srv.port}/healthz")
        session.membership.mark_dead(HR_KILL, "killed", t)
        dead = hr_get(f"http://127.0.0.1:{srv.port}/healthz")
        srv.close()
        bft.elastic.stop()
        health.stop()
    if not advs or fired_at is None or fired_at < 30 or \
            any([src, dst] not in a.detail["suspect_edges"] for a in advs) or \
            counted != len(advs) or len(table) != len(advs) or len(written) != len(advs) or \
            any([src, dst] not in a["suspect_edges"] for a in table) or \
            warn[0] != 200 or json.loads(warn[1])["status"] != "warn" or dead[0] != 503 or \
            HR_KILL not in json.loads(dead[1])["dead_ranks"]:
        raise AssertionError(f"health-relay (d): fired at {fired_at}, advisories "
                             f"{[a.to_json() for a in advs]}, counted {counted}, table {table}, "
                             f"written {len(written)}, /healthz {warn} then {dead}")
    return {"fired_at": fired_at, "advisories": len(advs),
            "efficiency": advs[0].detail["mixing_efficiency"],
            "baseline": advs[0].detail["baseline_efficiency"],
            "suspects": advs[0].detail["suspect_edges"]}


def phase_health_relay(device, sm, images, labels, root=HR_ROOT, smi="", n=RESNET50_WIDTH):
    """Parts (a)-(d) of the health and relay phase on the ResNet50 of the
    train-step phase; ``n`` is the width of the payloads that are not the
    model's (the relay parity and allgather, the consensus of (c) and (d)).
    Returns ``({part: launch counts of its counted run}, numbers)``."""
    import shutil

    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    params0 = sm.replicate()
    counts, numbers = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        t0 = time.perf_counter()
        a, counts["health relay a"] = hr_relay(device, sm, images, labels, stats0, params0, n)
        a["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        b, counts["health relay b"] = hr_health(device, sm, images, labels, stats0, params0,
                                                root)
        b["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        c = hr_decay(device, n)
        c_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        d = hr_chaos(device, root, n)
        d_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
        sm.load_buffers(stats0)
        bft.elastic.stop()
        shutil.rmtree(root, ignore_errors=True)
        bft.init(size=SIZE, device=device)
    numbers.update(a=a, b=b, c=c, d=d)
    direct = a["direct"]
    for tag in ("ring",) + tuple(x for x in HR_DIMS if x):
        r = a[tag]
        runs = "; ".join(
            f"{'fp32' if k == 'None' else k}: step {v[0]:.4f} s (direct {direct[k][0]:.4f}), "
            f"optimizer {v[1]:.1f} ms (direct {direct[k][1]:.1f})"
            for k, v in r["runs"].items())
        log("health-relay", f"(a) relay on {tag}: {r['rounds']} rounds (direct "
                            f"{a['direct_rounds']}), congestion {r['congestion']}; {runs}; "
                            f"parameters after the first step within "
                            f"{ {k: f'{v:.2g}' for k, v in r['first'].items()} } of the direct "
                            f"run's (relative to the largest value; allclose {HR_RELAY_TOL}), "
                            f"after 3 steps "
                            f"{ {k: f'{v:.2g}' for k, v in r['drift'].items()} }; launches encode/decode_accumulate/decode "
                            f"{r['launches']}; the dyadic relay bitwise the offset lowering, "
                            f"the relay allgather bitwise the direct one, int8_ef refused; on "
                            f"one card a relay round is one more gather, so the relay costs "
                            f"more than direct here; on {smi}")
    log("health-relay", f"(a) part {a['seconds']:.1f} s")
    log("health-relay", f"(b) health at interval 1: bitwise off, only the health_pushsum key "
                        f"added, predicted_rate {b['rate']:.6f} = the dense oracle, /healthz "
                        f"/metrics /fleet served on 127.0.0.1; lane on the card within "
                        f"{b['lane_err']:.3g} of fleet_aggregate_np (bound {HR_LANE_TOL}); "
                        f"fleet slots mem_bytes_per_rank {b['mem_bytes']:.4g}, stale_age_max "
                        f"{b['age_max']}; interval 20: mean step {b['on_ms']:.1f} ms on, "
                        f"{b['off_ms']:.1f} ms off ({100 * b['share']:+.2f}%; JAX's bound "
                        f"{100 * HR_OVERHEAD_BOUND:.0f}%, reported, not gated); part "
                        f"{b['seconds']:.1f} s; on {smi}")
    log("health-relay", "(c) decay at [8, 25 557 504] f32: " + "; ".join(
        f"{k}: predicted {v['predicted']:.6f}, measured {v['measured']:.6f}, efficiency "
        f"{v['eff']:.4f} (tolerance {HR_DECAY_TOL}), {v['steps']} steps at {v['ms']:.2f} ms, "
        f"time to eps {v['tte']}" for k, v in c.items()) + f"; part {c_s:.1f} s; on {smi}")
    log("health-relay", f"(d) lossy {HR_LOSSY[0]}->{HR_LOSSY[1]} at {HR_LOSSY[2]} from step 30: "
                        f"mixing_degraded at step {d['fired_at']} ({d['advisories']} "
                        f"advisories, efficiency {d['efficiency']} against baseline "
                        f"{d['baseline']}, suspects {d['suspects']}) on the counter, the flight "
                        f"table and the JSONL; /healthz warn, then 503 with rank {HR_KILL} "
                        f"dead; part {d_s:.1f} s")
    log("health-relay", f"launches of the parts {counts}")
    return counts, numbers


# the declared fabric of part (a): 2 pods x 4 workers, a DCN step every 2nd
FS_PODS = {"BLUEFOG_PODS": "2", "BLUEFOG_DCN_PERIOD": "2"}
# (tier, the optimizer's compression, its DCN wire): BLUEFOG_DCN_WIRE is
# "exact" for fp32 and unset (int4) for the others
FS_TIERS = (("fp32", None, None), ("int8", "int8", "int4"), ("int4", "int4", "int4"),
            ("int4_ef", "int4_ef", "int4"))
FS_STEPS = 5  # 1 warm-up + 4 timed: comm steps 0..4 are DCN, ICI, DCN, ICI, DCN
FS_FP32_TOL = 1e-5  # relative: the fp32 combine against float64 W_dcn^T (W_ici^T x)
FS_MEAN_TOL = 1e-6  # of the largest value: the workers' mean through the fp32 combine
FS_TARGET_RATE = 0.9  # choose_dcn_period's target rate on the 2 x 4 fabric (reported)
FS_SLO_ON = {"BLUEFOG_SLO": "1", "BLUEFOG_SLO_INTERVAL": "1"}
FS_SLO_STEPS = 11  # the default interval (10) against off: 1 + 10 steps, two samples
FS_DEGRADE = (2, 3, 0.05)  # (b) the damaged Exp2(8) edge and its delivered share
FS_FLEET = 1024  # (c) the storm's virtual ranks


def fs_same(name, a, b):
    if not (torch.equal(bits(a["params"]), bits(b["params"]))
            and torch.equal(bits(a["state"]), bits(b["state"]))):
        raise AssertionError(f"federation-slo {name}: parameters or momentum differ")


def fs_plain_composition(key, x, fab):
    """The two-leg combine of a DCN step through the plain versions on a
    CPU copy of the combine's input: the intra leg on the optimizer's wire,
    then the gateway leg on the DCN wire, each in place."""
    xc = x.cpu()
    for plan, wire in ((fab.intra, key[2]), (fab.inter, key[6])):
        src, _self_w, recv_w = inner.plan_operands(plan, "cpu")
        xc = inner.weighted_combine_quantized_operands(xc, src, recv_w, wire=wire, inplace=True)
    return xc


def fs_federation(device, sm, images, labels, stats0, params0):
    """Part (a), see :func:`phase_federation_slo`. Returns the numbers and
    the launch counts of the federated runs (each zeroed just before its run
    and read just after; the flat twins and the CPU checks are outside)."""
    from bluefog_tpu_torch import federation

    counts = {k: 0 for k in launch_counts()}

    def counted(*args, **kw):
        reset_launch_counts()
        out = hr_steps(device, sm, images, labels, stats0, params0, *args, **kw)
        part = launch_counts()
        for k in counts:
            counts[k] += part[k]
        return out

    flat0 = hr_steps(device, sm, images, labels, stats0, params0, "int8", {}, 3)
    runs, numbers, plain_s = {}, {}, 0.0
    for name, wire, dcn_wire in FS_TIERS:
        env = {**FS_PODS, "BLUEFOG_METRICS": "1"}
        if dcn_wire is None:
            env["BLUEFOG_DCN_WIRE"] = "exact"
        run = runs[name] = counted(wire, env, FS_STEPS, capture=name in ("fp32", "int8", "int4"))
        fab, rows = run["fab"], run["rows"]
        ici_wire = None if wire is None else wire.replace("_ef", "")
        if fab is None or fab.wire != dcn_wire or fab.period != 2 or \
                [r["dcn"] for r in rows] != [True, False] * 2 + [True] or \
                [r["key"] for r in rows] != [("fed", "dcn" if r["dcn"] else "ici")
                                             for r in rows] or \
                any(k[2] != ici_wire for k in (r["key"] for r in rows) if len(k) > 2):
            raise AssertionError(f"federation-slo (a) {name}: fabric {fab}, steps "
                                 f"{[(r['dcn'], r['key']) for r in rows]}")
        # launches a timed step: each quantized leg is one encode and one
        # decode_accumulate (in place, whole blocks); exact legs none
        for r in rows[1:]:
            legs = (wire is not None) + (r["dcn"] and dcn_wire is not None)
            want = {k: 0 for k in KERNEL_ROWS}
            want.update(encode=legs, decode_accumulate=legs)
            if device.type == "cuda" and r["launches"] != want:  # no launch on the CPU
                raise AssertionError(f"federation-slo (a) {name}: a {'DCN' if r['dcn'] else 'ICI'}"
                                     f" step launched {r['launches']}, expected {want}")
        key, x, y = run["captured"][0] if run["captured"] else (None, None, None)
        if name == "fp32":
            w = [torch.from_numpy(p.weight_matrix()).to(device) for p in (fab.intra, fab.inter)]
            x64 = x.double()
            want = w[1].t() @ (w[0].t() @ x64)
            err = float((y.double() - want).abs().max() / want.abs().max())
            drift = float((y.double().mean(0) - x64.mean(0)).abs().max() / x64.abs().max())
            del x64, want
            if not (err <= FS_FP32_TOL and drift <= FS_MEAN_TOL):
                raise AssertionError(f"federation-slo (a) fp32: combine {err:.3g} from float64 "
                                     f"(bound {FS_FP32_TOL}), mean drift {drift:.3g} (bound "
                                     f"{FS_MEAN_TOL})")
            numbers["fp32_err"], numbers["fp32_drift"] = err, drift
        elif key is not None:
            t0 = time.perf_counter()
            want = fs_plain_composition(key, x, fab)
            plain_s += time.perf_counter() - t0
            if not torch.equal(bits(y.cpu()), bits(want)):
                raise AssertionError(f"federation-slo (a) {name}: the first DCN combine differs "
                                     f"from the plain two-leg composition in "
                                     f"{int((bits(y.cpu()) != bits(want)).sum())} elements")
        run["captured"] = None
        # per-leg counters against the wire summary: a worker's rounds (JAX's
        # convention) on ICI every step, on DCN every event; the summary's
        # event bytes count both directed gateway edges
        with env_set(env):  # the summary reads an exact DCN wire from the environment
            ws = federation.wire_summary(fab.layout, sm.width, 4, ici_wire=ici_wire,
                                         dcn_wire_tier=dcn_wire, period=fab.period)
        events = sum(r["dcn"] for r in rows)
        n_edges = sum(1 for (i, j) in federation.inter_edges(fab.layout) if i != j)
        want_dcn = events * ws["dcn_wire_bytes_per_event"] * len(fab.inter.rounds) // n_edges
        ici, dcn, total = run["counters"]
        if ici != FS_STEPS * ws["ici_wire_bytes_per_step"] or dcn != want_dcn or \
                total != ici + dcn:
            raise AssertionError(f"federation-slo (a) {name}: counters ici {ici}, dcn {dcn}, "
                                 f"total {total}; summary {ws}, {events} events")
        timed = rows[1:]
        numbers[name] = {
            leg: (statistics.median(r["step_s"] for r in timed if r["dcn"] == is_dcn),
                  statistics.median(r["opt_ms"] for r in timed if r["dcn"] == is_dcn))
            for leg, is_dcn in (("ici", False), ("dcn", True))}
        numbers[name]["summary"] = ws
        torch.cuda.empty_cache()
    fs_same("(a) int4_ef fallback against int4", runs["int4_ef"], runs["int4"])
    fused = counted("int8", {**FS_PODS, "BLUEFOG_METRICS": "1"}, FS_STEPS, fused=True)
    fs_same("(a) make_train_step against the two-program step, int8", fused, runs["int8"])
    flat1 = hr_steps(device, sm, images, labels, stats0, params0, "int8", {}, 3)
    fs_same("(a) flat int8 after BLUEFOG_PODS is unset against its flat twin", flat1, flat0)
    if any(r["key"][0] != "na_q" for r in flat0["rows"] + flat1["rows"]):
        raise AssertionError(f"federation-slo (a): a flat step's key "
                             f"{[r['key'] for r in flat1['rows']]}")
    with env_set(FS_PODS):
        layout = federation.get_fabric(SIZE).layout
        numbers["choice"] = federation.choose_dcn_period(layout, FS_TARGET_RATE)
    numbers["flat"] = (statistics.median(r["step_s"] for r in flat0["rows"][1:]),
                       statistics.median(r["opt_ms"] for r in flat0["rows"][1:]))
    numbers["plain_s"] = plain_s
    return numbers, counts


def fs_canary(wire, plan):
    """One canary probe on the current context: the verdict and the
    delivered blocks of the canary op."""
    from bluefog_tpu_torch import slo

    ctx = bft.get_context()
    verdict = slo.CanaryLane().probe(ctx, plan, wire)
    src = torch.from_numpy(slo._round_sources(plan.perms, SIZE)).to(ctx.device)
    c = torch.from_numpy(slo.canary_signal(SIZE)).to(ctx.device)
    return verdict, slo._canary_program(ctx, plan.perms, wire)(c, src).cpu()


def fs_slo(device, sm, images, labels, stats0, params0):
    """Part (b), see :func:`phase_federation_slo`. Returns the numbers and
    the launch counts of the engine's own runs (the two engine-on step runs
    and the observation under the damaged edge), each zeroed just before it
    and read just after; the engine-off twin and the canary's comparison
    with the CPU run outside them."""
    from bluefog_tpu_torch import health, slo

    counts = {k: 0 for k in launch_counts()}

    def add(part):
        for k in counts:
            counts[k] += part[k]

    off = hr_steps(device, sm, images, labels, stats0, params0, "int8", {}, FS_SLO_STEPS,
                   fused=True, snap_at=3)
    off_keys = set(bft.get_context().op_cache)
    reset_launch_counts()
    on = hr_steps(device, sm, images, labels, stats0, params0, "int8", FS_SLO_ON, 3, fused=True)
    add(launch_counts())
    eng = on["engine"]
    if not (torch.equal(bits(on["params"]), bits(off["snap"][0]))
            and torch.equal(bits(on["state"]), bits(off["snap"][1]))):
        raise AssertionError("federation-slo (b): three steps with the SLO engine on differ from "
                             "three with it off")
    plan = bft.get_context().static_plan()
    rounds = len(plan.rounds)
    added = {k[0] for k in set(bft.get_context().op_cache) - off_keys}
    want = {k: 0 for k in KERNEL_ROWS}
    want.update(encode=2, decode_accumulate=1, decode=rounds)
    bad = [r["launches"] for r in on["rows"]
           if r["launches"] != want and device.type == "cuda"]  # no launch on the CPU
    if eng is None or eng._samples != 3 or eng.canary.probes != 3 or \
            not eng.canary.last["ok"] or added != {"slo_canary"} or bad:
        raise AssertionError(f"federation-slo (b): engine {eng and eng.report()}, op-cache keys "
                             f"added {added}, sampled steps launched {bad} (expected {want})")
    reset_launch_counts()
    on10 = hr_steps(device, sm, images, labels, stats0, params0, "int8", {"BLUEFOG_SLO": "1"},
                    FS_SLO_STEPS, fused=True)
    add(launch_counts())
    fs_same("(b) default interval", on10, off)
    if on10["engine"]._samples != 2:
        raise AssertionError(f"federation-slo (b): {on10['engine']._samples} samples at the "
                             f"default interval over {FS_SLO_STEPS} steps")
    # the canary on every edge of the Exp2(8) plan, card against the CPU
    # (a comparison with the plain versions: its launches are not counted)
    canary = {}
    for wire in (None, "bf16", "int8", "int4"):
        got = {}
        for dev in (device, torch.device("cpu")):
            bft.init(size=SIZE, device=dev)
            bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
            got[dev.type] = fs_canary(wire, bft.get_context().static_plan())
        (v, blocks), (v_cpu, blocks_cpu) = got[device.type], got["cpu"]
        if not v["ok"] or v != v_cpu or not torch.equal(bits(blocks), bits(blocks_cpu)):
            raise AssertionError(f"federation-slo (b) canary {wire}: card {v}, CPU {v_cpu}, "
                                 f"blocks equal {torch.equal(bits(blocks), bits(blocks_cpu))}")
        canary[wire or "fp32"] = v["max_dev"]
    # a damaged edge: the canary names it and files its advisory
    src, dst, factor = FS_DEGRADE
    bft.init(size=SIZE, device=device)
    bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
    ctx = bft.get_context()
    session = bft.elastic.start(policy="average")
    session.inject("degrade", rank=src, step=0, factor=factor, peer=dst)
    eng = slo.start(interval=1, objectives=[], canary=True)
    fired0 = metrics.counter("bluefog.doctor.advisory.slo_canary_failed").value
    reset_launch_counts()
    eng.observe(ctx, step=0, plan=ctx.static_plan(), wire="int8")
    add(launch_counts())
    verdict = eng.canary.last
    advs = [a for a in eng.alerts if a.kind == "slo_canary_failed"]
    bft.elastic.stop()
    if verdict is None or verdict["ok"] or \
            {tuple(e[:2]) for e in verdict["edges"]} != {(src, dst)} or len(advs) != 1 or \
            advs[0].detail["edges"][0][:2] != [src, dst] or \
            metrics.counter("bluefog.doctor.advisory.slo_canary_failed").value != fired0 + 1:
        raise AssertionError(f"federation-slo (b) degrade {FS_DEGRADE}: verdict {verdict}, "
                             f"advisories {[a.to_json() for a in advs]}")
    # a spent budget: /healthz critical, /slo the report, /fleet the slo block
    slo.register(slo.Objective("avail", "chip_smoke", target=0.99, comparison="ge", window=20,
                               budget_frac=0.1, fast_window=3, fast_burn=5.0, slow_window=10,
                               slow_burn=1.5))
    for t in range(40):
        eng.observe(None, step=t, values={"avail": 0.0})
    plane = health.start(interval=1)
    i_burn = health.FLEET_FIELDS.index("slo_burn")
    burn = float(plane._local_vector(ctx, None, list(range(SIZE)))[0, i_burn])
    srv = health.serve(0, host="127.0.0.1")
    base = f"http://127.0.0.1:{srv.port}"
    served = {p: hr_get(base + p) for p in ("/healthz", "/slo", "/fleet")}
    srv.close()
    health.stop()
    slo.stop()
    verdict_h = json.loads(served["/healthz"][1])
    rep = json.loads(served["/slo"][1])
    fleet = json.loads(served["/fleet"][1])
    spent = [o for o in rep.get("objectives", []) if o["name"] == "avail"]
    if served["/healthz"][0] != 503 or verdict_h["status"] != "critical" or \
            verdict_h["slo_exhausted"] != ["avail"] or served["/slo"][0] != 200 or \
            rep.get("kind") != "slo_dump" or not spent or \
            spent[0]["budget"]["exhausted"] is not True or \
            fleet.get("slo", {}).get("exhausted") != ["avail"] or burn != eng.worst_burn():
        raise AssertionError(f"federation-slo (b): /healthz {served['/healthz']}, /slo "
                             f"{str(rep)[:300]}, /fleet slo {fleet.get('slo')}, burn slot {burn}")
    off_ms = 1e3 * statistics.mean(r["step_s"] for r in off["rows"][1:])
    on_ms = 1e3 * statistics.mean(r["step_s"] for r in on10["rows"][1:])
    return {"canary": canary, "rounds": rounds, "off_ms": off_ms, "on_ms": on_ms,
            "share": on_ms / off_ms - 1.0, "burn": burn, "dev": verdict["max_dev"],
            "steps_ms": {k: [round(1e3 * r["step_s"], 1) for r in run["rows"][1:]]
                         for k, run in (("on", on10), ("off", off))}}, counts


def fs_fleetsim():
    """Part (c), host only: the N = 1024 Exp2 storm and a 4 x 16 federated
    fleet losing pod 1."""
    from bluefog_tpu_torch import federation, fleetsim

    vf = fleetsim.VirtualFleet(FS_FLEET, topology="exp2", policy="receiver",
                               plan=fleetsim.storm_plan(FS_FLEET, 0.10, 5, seed=1), seed=1)
    t0 = time.perf_counter()
    vf.run(12)
    run_s = time.perf_counter() - t0
    s = vf.summary()
    decision = vf.decision_probe()
    ff = federation.FederatedFleet(federation.parse_pods("4x16", 64),
                                   plan=fleetsim.region_plan(64, 16, 32, step=3), audit_edges=True)
    ff.run(8)
    fs = ff.summary()
    repairs = [e for e in ff.fleet.events if e["metric"] == "fleetsim_repair"]
    if s["live"] != 922 or s["repairs"] != 1 or s["stale_dispatches"] != 0 or \
            fs["repairs"] != 1 or fs["stale_dispatches"] != 0 or len(repairs) != 1 or \
            repairs[0]["loss_class"] != "pod_loss" or repairs[0]["pods_lost"] != [1] or \
            fs["federation"]["gateways"] != [0, 32, 48]:
        raise AssertionError(f"federation-slo (c): storm {s}, federated fleet {fs}, repairs "
                             f"{repairs}")
    return {"run_s": run_s, "event_ms": s["worst_event_ms"],
            "decision_ms": decision["decision_ms"], "chosen": decision["chosen"],
            "pod_event_ms": repairs[0]["event_ms"]}


def phase_federation_slo(device, sm, images, labels, smi=""):
    """Phase 11e on the ResNet50 of the train-step phase at
    ``PATH_TRAINER``'s depth (8 workers, 64 images of 224 x 224 each,
    ``sgd(0.1, 0.9)``, bf16 compute), ATC over the weighted Exp2 graph,
    cuDNN deterministic. Returns ``({path: launch counts}, numbers)``.

    (a) Federation, ``BLUEFOG_PODS=2`` (2 x 4) and ``BLUEFOG_DCN_PERIOD=2``,
    with ``BLUEFOG_METRICS=1``: tiers fp32 (``BLUEFOG_DCN_WIRE=exact``),
    int8 and int4 (DCN wire int4), int4_ef (falls back to int4), each 1 + 4
    two-program steps (communicating steps 0..4: DCN, ICI, DCN, ICI, DCN).
    Gates: each step's key is ``("fed", "dcn" | "ici", base wire, ...)`` on
    that cadence; a timed step launches, per quantized leg, one ``encode``
    and one ``decode_accumulate`` (the f32 payload ``[8, 25 557 504]`` is
    whole 512-blocks and contiguous, so ``weighted_combine_quantized_operands``
    runs in place: one encode of every worker's row and one accumulate over
    the leg's rounds; the intra leg every step, the gateway leg on its
    output on a DCN step), so a DCN step 2 + 2, an ICI-only step 1 + 1, fp32
    0, and nothing else; on int8 and int4 the first DCN step's combine is
    bitwise the two legs through the plain versions on a CPU copy of its
    input; on fp32 it is within ``FS_FP32_TOL`` (relative) of ``W_dcn^T
    (W_ici^T x)`` in float64, and keeps the workers' mean to ``FS_MEAN_TOL``
    of the largest value; the ``bluefog.federation.ici_wire_bytes`` counter
    is 5 x ``wire_summary``'s ICI bytes a step, ``dcn_wire_bytes`` the DCN
    events x its bytes an event x the inter rounds / the directed gateway
    edges (the counter counts a worker's rounds, the summary the fleet's
    edges), ``bluefog.wire_bytes`` their sum; int4_ef bitwise int4;
    ``make_train_step`` bitwise the two-program int8 run; a flat int8 run
    after ``BLUEFOG_PODS`` is unset bitwise the flat twin run before any
    federation, on ``na_q`` keys. Reported: step s and optimizer ms of the
    ICI-only and DCN steps per tier beside the flat int8's, the per-leg
    bytes, ``dcn_cut_ratio``, and ``choose_dcn_period(FS_TARGET_RATE)``.

    (b) SLO on flat ATC int8: ``BLUEFOG_SLO=1`` at interval 1 (canary on)
    for 3 fused steps is bitwise the engine off; it adds only the
    ``slo_canary`` op-cache key, and every sampled step launches one more
    ``encode`` and one ``decode`` a round (3) beside the step's own encode
    and decode_accumulate; at the default interval (10) 1 + 10 steps are
    bitwise off with two samples (mean step reported against off). The
    canary on the card is ok on every edge of the Exp2(8) plan for fp32,
    bf16, int8 and int4, its verdict (deviation included) equal to the
    CPU's and its delivered blocks bitwise the plain versions'. A ``degrade``
    fault on edge ``FS_DEGRADE`` makes it name exactly that edge and file one
    ``slo_canary_failed`` advisory. An objective whose budget is spent turns
    ``/healthz`` 503 ``critical``, ``/slo`` serves the report, ``/fleet``
    carries the ``slo`` block and the ``slo_burn`` slot the engine's burn.

    (c) Fleetsim, host only: the N = 1024 Exp2 storm
    (``storm_plan(1024, 0.10, 5, seed=1)``, receiver) ends with 922 live, 1
    repair and 0 stale dispatches; a 4 x 16 ``FederatedFleet`` loses pod 1
    in one repair event (``pod_loss``, gateways [0, 32, 48]); the decision
    probe's ``decision_ms`` reported."""
    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    params0 = sm.replicate()
    counts = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        a, counts["federation"] = fs_federation(device, sm, images, labels, stats0, params0)
        a_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        b, counts["slo canary"] = fs_slo(device, sm, images, labels, stats0, params0)
        b_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        c = fs_fleetsim()
        c_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
        sm.load_buffers(stats0)
        bft.elastic.stop()
        bft.init(size=SIZE, device=device)
    for name, _wire, _dcn in FS_TIERS:
        r = a[name]
        log("federation-slo", f"(a) {name}: ICI-only step {r['ici'][0]:.4f} s, optimizer "
                              f"{r['ici'][1]:.1f} ms; DCN step {r['dcn'][0]:.4f} s, optimizer "
                              f"{r['dcn'][1]:.1f} ms (flat int8 {a['flat'][0]:.4f} s, "
                              f"{a['flat'][1]:.1f} ms); ICI {r['summary']['ici_wire_bytes_per_step']}"
                              f" B a step, DCN {r['summary']['dcn_wire_bytes_per_event']} B an "
                              f"event ({r['summary']['dcn_wire']}), dcn_cut_ratio "
                              f"{r['summary']['dcn_cut_ratio']}; on {smi}")
    ch = a["choice"]
    log("federation-slo", f"(a) gates met: cadence and keys, launches 2+2 a DCN step and 1+1 "
                          f"an ICI step (fp32 0), int8/int4 first DCN combine bitwise the plain "
                          f"legs (CPU {a['plain_s']:.1f} s), fp32 {a['fp32_err']:.3g} from "
                          f"float64 (bound {FS_FP32_TOL}), mean drift {a['fp32_drift']:.3g} "
                          f"(bound {FS_MEAN_TOL}), counters = wire_summary, int4_ef = int4, "
                          f"fused = two-program, flat after = flat before; choose_dcn_period("
                          f"{FS_TARGET_RATE}): period {ch['period']}, predicted "
                          f"{ch['predicted_rate']:.6f}, met {ch['met']}; part {a_s:.1f} s")
    log("federation-slo", f"(b) SLO at interval 1 bitwise off, +1 encode +{b['rounds']} decode "
                          f"a sampled step, canary ok on every edge (max deviation from "
                          f"wire_ref {b['canary']}, card = CPU), degrade {FS_DEGRADE} named "
                          f"alone (deviation {b['dev']}), spent budget: /healthz 503 critical, "
                          f"/slo served, slo_burn {b['burn']}; default interval: mean step "
                          f"{b['on_ms']:.1f} ms on, {b['off_ms']:.1f} off "
                          f"({100 * b['share']:+.2f}%, reported; steps ms {b['steps_ms']}, "
                          f"the last sampled); part {b_s:.1f} s; on {smi}")
    log("federation-slo", f"(c) storm N={FS_FLEET}: 922 live, 1 repair, 0 stale, 12 ticks in "
                          f"{c['run_s']:.3f} s, repair {c['event_ms']} ms, decision_ms "
                          f"{c['decision_ms']} ({c['chosen']}); pod 1 of 4 x 16 lost in one "
                          f"event ({c['pod_event_ms']} ms); part {c_s:.1f} s")
    log("federation-slo", f"launches of the parts {counts}")
    return counts, {"a": a, "b": b, "c": c}


AT_ROOT = "build/autotune"
AT_DEGRADE = (2, 3, 0.05)  # the damaged Exp2(8) edge and its delivered share
# the doctor's pinned probe model (stacked class, as tests/test_torch_doctor.py
# pins it): alpha 2 ms, so a probe crossing the damaged edge sleeps
# 19 x 2 ms = 38 ms more than its peers, whatever the host's load
AT_DOCTOR_PIN = (2e-3, 1e12, 0.0)
AT_TRIG = [{"kind": "degraded_link", "source": "doctor", "edge": [2, 3], "ratio": 20.0}]
AT_WARMUP = 3  # (a) steps before the controller is fed: their median pins its clock
AT_STEPS = 10  # (a) steps the controller observes
AT_DRY_STEPS = 6  # (c) steps the dry-run controller observes, cooldown AT_DRY_COOLDOWN
AT_DRY_COOLDOWN = 3
AT_ON = {"BLUEFOG_AUTOTUNE": "1", "BLUEFOG_AUTOTUNE_INTERVAL": "1"}
AT_OFF = {"BLUEFOG_AUTOTUNE": "0"}
AT_STEPS10 = 11  # (b) the interval 10 against off: 1 + 10 steps
AT_ROLLBACK_CLOCK = 5.0  # (d) the delivered step clock after the swap, x the baseline


class at_timer:
    """Milliseconds of one span: CUDA events on the card (read after a
    synchronize), the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.start, self.end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            self.end.record()
        else:
            self.t1 = time.perf_counter()
        return self

    def ms(self):
        return self.start.elapsed_time(self.end) if self.cuda else 1e3 * (self.t1 - self.t0)


def at_recorder(opt, device, width):
    """Wrap ``opt._resolve_dispatch``: every full-width combine is timed, and
    while ``rec["arm"]`` the next one is captured (its dispatch key, the plan
    it ran, its input and CHOCO copies before, its output and copies after)."""
    rec = {"arm": False, "captured": None, "timers": []}
    resolve = opt._resolve_dispatch

    def recording(ctx, p, comm_now):
        d = resolve(ctx, p, comm_now)
        # not ``d`` itself in ``recorded``: ``d`` holds it (a cycle)
        combine, plan, key = d.combine, opt._last_plan, d.key

        def recorded(*args):
            if args[0].shape[-1] != width:
                return combine(*args)
            keep = rec["arm"] and rec["captured"] is None
            if keep:
                before = (args[0].clone(),
                          tuple(s.clone() for s in args[1]) if len(args) > 1 else None)
            timer = at_timer(device)
            out = combine(*args)
            rec["timers"].append(timer.stop())
            if keep:
                rec["captured"] = {
                    "key": key, "plan": plan, "x": before[0], "state": before[1],
                    "y": out.clone(),
                    "state_after": tuple(s.clone() for s in args[1]) if len(args) > 1 else None}
            return out

        d.combine = recorded
        return d

    opt._resolve_dispatch = recording
    return rec


def at_plain_check(name, cap, wire):
    """The captured combine through the plain versions on a CPU copy of its
    input (and CHOCO copies), under the plan it ran: bitwise its output (and
    copies). Returns the plan's round count."""
    plan = cap["plan"]
    chunks = cap["key"][3]
    if chunks != 1:
        raise AssertionError(f"autotune {name}: the combine ran in {chunks} chunks")
    src, _self_w, recv_w = inner.plan_operands(plan, "cpu")
    x = cap["x"].cpu()
    if wire.endswith("_ef"):
        state = tuple(s.cpu() for s in cap["state"])
        want = inner.weighted_combine_quantized_ef_operands(x, state, src, recv_w,
                                                            wire=wire[:-3], inplace=True)
        pairs = [("output", cap["y"], want)] + [
            (f"copy {i}", got, ref) for i, (got, ref) in enumerate(zip(cap["state_after"], state))]
    else:
        want = inner.weighted_combine_quantized_operands(x, src, recv_w, wire=wire, inplace=True)
        pairs = [("output", cap["y"], want)]
    for what, got, ref in pairs:
        got = got.cpu()
        if not torch.equal(bits(got), bits(ref)):
            raise AssertionError(f"autotune {name}: the {wire} combine's {what} differs from the "
                                 f"plain versions in {int((bits(got) != bits(ref)).sum())} "
                                 f"elements")
    return len(plan.perms)


def at_plan_matches(name, plan, w):
    """The plan a step ran carries exactly the installed matrix's edges."""
    edges = {tuple(e) for r in plan.perms for e in r}
    want = {(int(i), int(j)) for i, j in zip(*np.nonzero(w)) if i != j}
    if edges != want:
        raise AssertionError(f"autotune {name}: the step's plan edges {sorted(edges)} are not "
                             f"the installed matrix's {sorted(want)}")


def at_run(device, sm, images, labels, stats0, params0, wire, steps, env=None, fault=True,
           tuner_kw=None, clock=None, triggers=None, warmup=1, after=0, capture_on="swap"):
    """ATC ``sgd(0.1, 0.9)`` on ``wire`` over the weighted Exp2 graph through
    ``opt.make_train_step(sm.worker_loss)`` from ``params0`` and ``stats0``,
    under ``env`` (set before ``bft.init``), with ``BLUEFOG_METRICS=1`` at
    interval 1000 (the wire-byte counter every step, the probe on step 0
    only). ``fault``: an elastic session (``policy="average"``) injects
    ``degrade`` on ``AT_DEGRADE`` at step 0, the step runs through its guard,
    and the doctor probes at interval 1 on ``AT_DOCTOR_PIN``. ``tuner_kw``: a
    ``TopologyAutotuner`` built after ``warmup`` steps and fed after each of
    the next ``steps`` steps with the step clock ``clock(tuner, base)``
    (``base``: the median warm-up step) and ``triggers`` (None: the live
    advisories); then ``after`` more steps. The combine of the step after
    the first ``capture_on`` decision is captured (:func:`at_recorder`).
    Returns the run's record; the context stays up for the caller."""
    from bluefog_tpu_torch import attribution, autotune
    from bluefog_tpu_torch.collective import compiler

    env = {"BLUEFOG_METRICS": "1", "BLUEFOG_METRICS_INTERVAL": "1000", **AT_OFF, **(env or {})}
    with env_set({**OBSV_OFF, **env}):
        bft.init(size=SIZE, device=device)
        bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
        ctx = bft.get_context()
        sm.load_buffers(stats0)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = wire
        params = params0.clone()
        state = opt.init(params)
        session = None
        if fault:
            compiler.set_calibration(*AT_DOCTOR_PIN, source="chip_smoke",
                                     link_class=compiler.TRANSPORT_LINK_CLASS)
            session = bft.elastic.start(policy="average")
            session.inject("degrade", rank=AT_DEGRADE[0], step=0, factor=AT_DEGRADE[2],
                           peer=AT_DEGRADE[1])
            attribution.start(interval=1)
        rec = at_recorder(opt, device, sm.width)
        step = (bft.elastic.guard(opt) if session else opt).make_train_step(sm.worker_loss)
        workers = torch.arange(SIZE)
        rows, tuner, seen, base, base_w = [], None, [], None, None
        counts = {k: 0 for k in launch_counts()}
        for i in range(warmup + steps + after):
            if i == warmup and tuner_kw is not None:
                base = statistics.median(r["step_s"] for r in rows)
                tuner = autotune.TopologyAutotuner(**tuner_kw)
                search = tuner._candidates

                def recorded(c, o, factors, search=search):
                    cands = search(c, o, factors)
                    seen.append((dict(factors), cands))
                    return cands

                tuner._candidates = recorded
                base_w = topo.mixing_matrix(bft.load_topology()).copy()
            ef_before = None if opt._ef is None else tuple(
                float(s.abs().max()) for grp in opt._ef for s in grp)
            n_timers = len(rec["timers"])
            before = launch_counts()
            sync(device)
            t0 = time.perf_counter()
            params, state, loss = step(params, state, images, labels, workers)
            sync(device)
            step_s = time.perf_counter() - t0
            after_c = launch_counts()
            if not torch.isfinite(loss).all():
                raise AssertionError(f"autotune: non-finite loss at step {i}")
            launches = {k: after_c[k] - before[k] for k in KERNEL_ROWS}
            for k in counts:
                counts[k] += after_c[k] - before[k]
            row = {"step_s": step_s, "launches": launches, "plan": opt._last_plan,
                   "captured": rec["arm"] and rec["captured"] is not None,
                   "combine_ms": sum(t.ms() for t in rec["timers"][n_timers:]),
                   "topo_version": ctx.topo_version, "ef_before": ef_before,
                   "swaps": None, "observe_ms": None, "record": None}
            rows.append(row)
            rec["arm"] = False
            if tuner is not None and i < warmup + steps:
                n_decisions = len(tuner.decisions)
                t0 = time.perf_counter()
                r = tuner.observe(ctx, step=i, optimizer=opt,
                                  step_s=clock(tuner, base) if clock else base,
                                  triggers=None if triggers is None else list(triggers))
                row["observe_ms"] = 1e3 * (time.perf_counter() - t0)
                row["record"] = r
                # a rollback is recorded inside the sample, not returned
                if rec["captured"] is None and any(
                        d.action == capture_on for d in tuner.decisions[n_decisions:]):
                    rec["arm"] = True
                row["swaps"] = (tuner.swaps, tuner.rollbacks)
        # the classes' methods again (each wrapper holds its object's bound
        # method: a cycle through the object's own attribute)
        del opt._resolve_dispatch
        if tuner is not None:
            del tuner._candidates
        out = {"params": params, "state": state, "rows": rows, "tuner": tuner, "seen": seen,
               "base_s": base, "base_w": base_w, "opt": opt, "captured": rec["captured"],
               "counts": counts, "doctor": attribution.active(),
               "stale": session.stale_dispatches if session else 0}
        if fault:
            bft.elastic.stop()
            compiler.clear_calibration(compiler.TRANSPORT_LINK_CLASS)
    return out


def at_replay(record, factors, cands):
    """The decision on the host: the record's candidates scored again by
    ``score_candidate`` from its factors and payload, each timed, and the
    controller's rule (the best eligible candidate beating the incumbent by
    ``MIN_GAIN_FRAC``) applied to them. Returns the scores, their ms and the
    choice."""
    from bluefog_tpu_torch import autotune

    if record.blamed != [[s, d] for (s, d) in sorted(factors)]:
        raise AssertionError(f"autotune (a): the record blames {record.blamed}, its factors "
                             f"are {factors}")
    payload = record.predicted["payload_bytes"]
    scored, ms = [], []
    for c in cands:
        t0 = time.perf_counter()
        scored.append(autotune.score_candidate(c, payload, factors))
        ms.append(1e3 * (time.perf_counter() - t0))
    incumbent = next(s for s in scored if s["name"] == "current")
    best = incumbent
    for s in scored:
        if s is incumbent or not s["eligible"]:
            continue
        if autotune._better(s["objective_s"], best["objective_s"],
                            autotune.MIN_GAIN_FRAC if best is incumbent else 0.0):
            best = s
    return scored, ms, None if best is incumbent else best["name"]


def at_closed_loop(device, sm, images, labels, stats0, params0, root):
    """Parts (a) and (f), see :func:`phase_autotune`."""
    from bluefog_tpu_torch import autotune, health

    jsonl = os.path.join(root, "decisions.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)
    metric_names = ("bluefog.autotune.decisions", "bluefog.autotune.action.swap")
    metrics0 = [metrics.counter(n).value for n in metric_names]
    run = at_run(device, sm, images, labels, stats0, params0, "int8", AT_STEPS,
                 env={"BLUEFOG_HEALTH": "1", "BLUEFOG_AUTOTUNE_FILE": jsonl},
                 tuner_kw={"interval": 1, "cooldown": 8}, warmup=AT_WARMUP, after=1)
    tuner, rows, doc = run["tuner"], run["rows"], run["doctor"]
    rank, peer, _factor = AT_DEGRADE
    # the doctor names the damaged edge at every step it blames one (a loaded
    # host can add a noisy edge beside it; those are reported)
    linked = [a for a in doc.advisories if a.kind == "degraded_link"]
    by_step = {}
    for adv in linked:
        by_step.setdefault(adv.step, []).append(adv.detail["edge"])
    if not linked or any([rank, peer] not in edges for edges in by_step.values()):
        raise AssertionError(f"autotune (a): degraded_link advisories "
                             f"{[a.to_json() for a in linked]}")
    others = sorted({tuple(e) for edges in by_step.values() for e in edges} - {(rank, peer)})
    swaps = [d for d in tuner.decisions if d.action == "swap"]
    if tuner.swaps != 1 or len(swaps) != 1 or tuner.rollbacks != 0 or \
            not any(t.get("edge") == [rank, peer] for t in swaps[0].triggers):
        raise AssertionError(f"autotune (a): decisions "
                             f"{[(d.action, d.chosen, d.triggers) for d in tuner.decisions]}, "
                             f"{tuner.swaps} swaps, {tuner.rollbacks} rollbacks")
    swap = swaps[0]
    w = topo.mixing_matrix(bft.load_topology())
    if not w[rank, peer] < run["base_w"][rank, peer] or \
            not swap.topo_version_after > swap.topo_version_before:
        raise AssertionError(f"autotune (a): w[{rank}, {peer}] {w[rank, peer]} after the swap, "
                             f"{run['base_w'][rank, peer]} before; versions "
                             f"{swap.topo_version_before} -> {swap.topo_version_after}")
    if run["stale"] != 0 or not torch.isfinite(run["params"]).all():
        raise AssertionError(f"autotune (a): {run['stale']} stale dispatches, finite parameters "
                             f"{bool(torch.isfinite(run['params']).all())}")
    # the first step after the swap: its plan is the installed matrix's, its
    # combine bitwise the plain versions, its launches one encode and one
    # decode_accumulate (in place over every round of the new plan)
    i_swap = next(i for i, r in enumerate(rows) if r["record"] is swap)
    post = rows[i_swap + 1] if i_swap + 1 < len(rows) else {}
    cap = run["captured"]
    if cap is None or not post.get("captured"):
        raise AssertionError("autotune (a): the step after the swap was not captured")
    at_plan_matches("(a)", post["plan"], w)
    t0 = time.perf_counter()
    rounds = at_plain_check("(a)", cap, "int8")
    plain_s = time.perf_counter() - t0
    if cap["plan"] is not post["plan"]:
        raise AssertionError("autotune (a): the captured combine ran another plan")
    want = {k: 0 for k in KERNEL_ROWS}
    want.update(encode=1, decode_accumulate=1)
    if device.type == "cuda" and post["launches"] != want:  # no launch on the CPU
        raise AssertionError(f"autotune (a): the step after the swap launched "
                             f"{post['launches']}, expected {want} ({rounds} rounds)")
    # the decision replayed on the host
    factors, cands = run["seen"][swap.seq]
    scored, score_ms, chosen = at_replay(swap, factors, cands)
    if scored != swap.candidates or chosen != swap.chosen:
        raise AssertionError(f"autotune (a): the host replay chose {chosen} with "
                             f"{[(s['name'], s['objective_s']) for s in scored]}, the record "
                             f"{swap.chosen} with "
                             f"{[(s['name'], s['objective_s']) for s in swap.candidates]}")
    # (f) every surface carries the swap
    autotune.activate(tuner)
    plane = health.active()
    srv = health.serve(0, host="127.0.0.1")
    status, body = hr_get(f"http://127.0.0.1:{srv.port}/fleet")
    srv.close()
    fleet = json.loads(body)
    dump = flight._build_dump("autotune")
    lines = [json.loads(line) for line in open(jsonl)]
    counted = [metrics.counter(n).value - v0 for n, v0 in zip(metric_names, metrics0)]
    dump_path = os.path.join(root, "autotune_dump.json")
    autotune.dump(dump_path)
    report = subprocess.run([sys.executable, "tools/autotune_report.py", dump_path],
                            capture_output=True, text=True, timeout=120,
                            env=dict(os.environ, PYTHONPATH=os.getcwd()))
    autotune.stop()
    health.stop()
    written = [r for r in lines if r.get("kind") == "decision" and r.get("action") == "swap"]
    if plane is None or status != 200 or fleet.get("autotune", {}).get("swaps") != 1 or \
            counted[0] != len(tuner.decisions) or counted[1] != 1 or \
            not any(d.get("action") == "swap" for d in dump["autotune_decisions"]) or \
            len(written) != 1 or written[0]["chosen"] != swap.chosen or \
            report.returncode != 0 or "decision #0" not in report.stdout:
        raise AssertionError(f"autotune (f): /fleet {status} {fleet.get('autotune')}, counters "
                             f"{counted}, flight {dump['autotune_decisions']}, JSONL swaps "
                             f"{written}, tools/autotune_report.py rc {report.returncode}: "
                             f"{report.stdout[-500:]} {report.stderr[-1000:]}")
    pre = rows[:i_swap + 1]
    return {"swap": swap, "chosen": swap.chosen, "rounds": rounds,
            "incumbent_rounds": len(rows[0]["plan"].perms),
            "gain": swap.predicted.get("gain_frac"), "predicted": swap.predicted,
            "pinned_ms": 1e3 * run["base_s"],
            "warmup_ms": [round(1e3 * r["step_s"], 1) for r in rows[:AT_WARMUP]],
            "steps_ms": [round(1e3 * r["step_s"], 1) for r in rows[AT_WARMUP:]],
            "combine_before_ms": statistics.median(r["combine_ms"] for r in pre[1:]),
            "combine_after_ms": statistics.median(r["combine_ms"] for r in rows[i_swap + 1:]),
            "observe_ms": rows[i_swap]["observe_ms"],
            "observe_quiet_ms": statistics.median(
                r["observe_ms"] for r in rows if r["observe_ms"] is not None
                and r["record"] is None),
            "score_ms": dict(zip((c["name"] for c in cands), score_ms)),
            "advisories": len(linked), "others": others,
            "decisions": [d.action for d in tuner.decisions],
            "plain_s": plain_s, "counts": run["counts"],
            "swap_step": i_swap, "n_cands": len(cands),
            "step_launches": [(r["launches"]["encode"], r["launches"]["decode_accumulate"])
                              for r in rows]}


def at_off_is_on(device, sm, images, labels, stats0, params0):
    """Part (b), see :func:`phase_autotune`."""
    from bluefog_tpu_torch import autotune

    counts = {k: 0 for k in launch_counts()}
    off = hr_steps(device, sm, images, labels, stats0, params0, "int8", AT_OFF, AT_STEPS10,
                   fused=True, snap_at=3)
    off_keys = set(bft.get_context().op_cache)
    reset_launch_counts()
    on = hr_steps(device, sm, images, labels, stats0, params0, "int8", AT_ON, 3, fused=True)
    for k, v in launch_counts().items():
        if k in counts:
            counts[k] += v
    tuner = autotune.active()
    on_keys = set(bft.get_context().op_cache)
    if not (torch.equal(bits(on["params"]), bits(off["snap"][0]))
            and torch.equal(bits(on["state"]), bits(off["snap"][1]))):
        raise AssertionError("autotune (b): three steps with the controller on differ from "
                             "three with it off")
    if tuner is None or tuner.interval != 1 or len(tuner.samples) != 3 or tuner.decisions or \
            on_keys != off_keys:
        raise AssertionError(f"autotune (b): controller {tuner and tuner.summary()}, op-cache "
                             f"keys added {on_keys - off_keys}")
    reset_launch_counts()
    on10 = hr_steps(device, sm, images, labels, stats0, params0, "int8",
                    {"BLUEFOG_AUTOTUNE": "1", "BLUEFOG_AUTOTUNE_INTERVAL": "10"}, AT_STEPS10,
                    fused=True)
    for k, v in launch_counts().items():
        if k in counts:
            counts[k] += v
    tuner10 = autotune.active()
    fs_same("autotune (b) interval 10", on10, off)
    if tuner10 is None or len(tuner10.samples) != 2 or tuner10.decisions:
        raise AssertionError(f"autotune (b): interval 10 controller "
                             f"{tuner10 and tuner10.summary()}")
    autotune.stop()
    off_ms = 1e3 * statistics.mean(r["step_s"] for r in off["rows"][1:])
    on_ms = 1e3 * statistics.mean(r["step_s"] for r in on10["rows"][1:])
    return {"off_ms": off_ms, "on_ms": on_ms, "share": on_ms / off_ms - 1.0,
            "steps_ms": {k: [round(1e3 * r["step_s"], 1) for r in run["rows"][1:]]
                         for k, run in (("on", on10), ("off", off))}}, counts


def at_dry_run(device, sm, images, labels, stats0, params0):
    """Part (c), see :func:`phase_autotune`."""
    twin = at_run(device, sm, images, labels, stats0, params0, "int8", AT_DRY_STEPS)
    with env_set({"BLUEFOG_AUTOTUNE_DRY_RUN": "1"}):
        run = at_run(device, sm, images, labels, stats0, params0, "int8", AT_DRY_STEPS,
                     tuner_kw={"interval": 1, "cooldown": AT_DRY_COOLDOWN})
    tuner = run["tuner"]
    acts = [d.action for d in tuner.decisions]
    marks = [d.comm_steps for d in tuner.decisions]
    versions = {r["topo_version"] for r in run["rows"]}
    if not tuner.dry_run or len(acts) < 2 or any(a != "dry_run_swap" for a in acts) or \
            any(b - a != AT_DRY_COOLDOWN for a, b in zip(marks, marks[1:])) or \
            tuner.swaps != 0 or len(versions) != 1 or \
            any(d.topo_version_after != d.topo_version_before for d in tuner.decisions):
        raise AssertionError(f"autotune (c): decisions {acts} at comm steps {marks}, "
                             f"{tuner.swaps} swaps, versions {versions}")
    obsv_bitwise("autotune (c) dry run", twin, run)
    return {"decisions": acts, "marks": marks, "chosen": tuner.decisions[0].chosen}, run["counts"]


def at_rollback(device, sm, images, labels, stats0, params0):
    """Part (d), see :func:`phase_autotune`."""
    def clock(tuner, base):
        return base if tuner.swaps == 0 else AT_ROLLBACK_CLOCK * base

    run = at_run(device, sm, images, labels, stats0, params0, "int8", 6, fault=False,
                 tuner_kw={"interval": 1, "cooldown": 4}, clock=clock, triggers=AT_TRIG,
                 capture_on="rollback")
    tuner, rows = run["tuner"], run["rows"]
    swaps = [d for d in tuner.decisions if d.action == "swap"]
    rbs = [d for d in tuner.decisions if d.action == "rollback"]
    w = topo.mixing_matrix(bft.load_topology())
    if tuner.rollbacks != 1 or len(rbs) != 1 or len(swaps) != 1 or \
            not rbs[0].topo_version_after > rbs[0].topo_version_before or \
            swaps[0].chosen not in tuner._blocked or \
            not tuner.verifications or tuner.verifications[0]["verdict"] != "regressed" or \
            not np.array_equal(w.view(np.uint64), run["base_w"].view(np.uint64)):
        raise AssertionError(f"autotune (d): decisions "
                             f"{[(d.action, d.chosen) for d in tuner.decisions]}, blocked "
                             f"{tuner._blocked}, verifications {tuner.verifications}, matrix "
                             f"restored {np.array_equal(w, run['base_w'])}")
    post = next((r for r in rows if r["captured"]), None)
    if post is None:
        raise AssertionError("autotune (d): the step after the rollback was not captured")
    at_plan_matches("(d)", post["plan"], w)
    rounds = at_plain_check("(d)", run["captured"], "int8")
    want = {k: 0 for k in KERNEL_ROWS}
    want.update(encode=1, decode_accumulate=1)
    if device.type == "cuda" and post["launches"] != want:
        raise AssertionError(f"autotune (d): the step after the rollback launched "
                             f"{post['launches']}, expected {want}")
    return {"chosen": swaps[0].chosen, "rounds": rounds,
            "delivered": tuner.verifications[0]["delivered"],
            "decisions": [d.action for d in tuner.decisions]}, run["counts"]


def at_wire(device, sm, images, labels, stats0, params0):
    """Part (e), see :func:`phase_autotune`."""
    with env_set({"BLUEFOG_AUTOTUNE_WIRE": "int4_ef"}):
        run = at_run(device, sm, images, labels, stats0, params0, "int8_ef", 2, fault=False,
                     tuner_kw={"interval": 1, "cooldown": 4}, triggers=AT_TRIG, after=1)
    tuner, rows, opt = run["tuner"], run["rows"], run["opt"]
    swaps = [d for d in tuner.decisions if d.action == "swap"]
    if len(swaps) != 1:
        raise AssertionError(f"autotune (e): decisions "
                             f"{[(d.action, d.chosen) for d in tuner.decisions]}")
    chosen, post = swaps[0].chosen, next((r for r in rows if r["captured"]), None)
    if post is None:
        raise AssertionError("autotune (e): the step after the swap was not captured")
    out = {"chosen": chosen, "wire": opt.compression, "rounds": len(post["plan"].perms)}
    if opt.compression == "int4_ef" and opt.schedule is None:
        cap = run["captured"]
        if post["ef_before"] is None or not all(v > 0 for v in post["ef_before"]) or \
                any(bool(s.any()) for s in cap["state"]) or opt._ef_sig[2] != "int4_ef":
            raise AssertionError(f"autotune (e): the int8_ef copies before the swap "
                                 f"(abs max {post['ef_before']}) or the int4_ef copies the "
                                 f"step started from are not fresh")
        at_plan_matches("(e)", post["plan"], topo.mixing_matrix(bft.load_topology()))
        at_plain_check("(e)", cap, "int4_ef")
        want = {k: 0 for k in KERNEL_ROWS}
        want.update(encode_diff=1, decode_add=out["rounds"])
        if device.type == "cuda" and post["launches"] != want:
            raise AssertionError(f"autotune (e): the step after the swap launched "
                                 f"{post['launches']}, expected {want}")
    return out, run["counts"]


def phase_autotune(device, sm, images, labels, root=AT_ROOT, smi=""):
    """Phase 11f on the ResNet50 of the train-step phase at
    ``PATH_TRAINER``'s depth (8 workers, 64 images of 224 x 224 each,
    ``sgd(0.1, 0.9)``, bf16 compute), ATC over the weighted Exp2(8) graph
    through ``opt.make_train_step(sm.worker_loss)``, cuDNN deterministic,
    ``BLUEFOG_METRICS=1`` at interval 1000 (so the
    controller's payload is the measured int8 bytes, and the probe runs on
    step 0 only). Returns ``(launch counts of the controller-on runs,
    numbers)``; each run's counts are zeroed just before it and read just
    after; the twins and the plain versions on the CPU are not counted.

    (a) The closed loop: an elastic session (``policy="average"``) injects
    ``degrade`` on the edge 2 -> 3 at 0.05 from step 0; the doctor probes at
    interval 1 on a pinned model (``AT_DOCTOR_PIN``); after 3 warm-up steps
    a ``TopologyAutotuner(interval=1, cooldown=8)`` is fed after each of 10
    steps with the step clock pinned to the warm-up median (the host moves a
    step by more than ``ROLLBACK_FRAC``) and the live advisories; then one
    more step. Gates: every ``degraded_link`` names [2, 3]; exactly one
    ``swap``, no rollback, its triggers name [2, 3], its version after above
    before; the installed ``w[2, 3]`` below its value before; zero stale
    dispatches, finite parameters; the first step after the swap runs the
    plan of the installed matrix (its edges), launches one ``encode`` and one
    ``decode_accumulate`` (in place over all the new plan's rounds, the
    payload being whole 512-blocks) and nothing else, and its combine is
    bitwise the same combine through the plain versions on a CPU copy of
    its input; the swap's candidates scored again on the host by
    ``score_candidate`` from its factors (whose edges are its ``blamed``) and
    its payload equal its record, names and objectives, and the controller's
    rule picks its choice. Reported: the pinned and measured step ms, the
    chosen candidate and its rounds against the incumbent's, the predicted
    ``gain_frac``, the host ms of the deciding sample, of a quiet one and of
    scoring each candidate, the combine ms (CUDA events) before and after.

    (b) Off is on: ``BLUEFOG_AUTOTUNE=1`` at interval 1 (set before
    ``bft.init``; the hook in ``make_train_step`` feeds it), no fault: three
    steps bitwise three with the controller off, no ``op_cache`` entry
    added, three samples and no decision; at interval 10, 1 + 10 steps
    bitwise off with two samples; the mean step on against off reported.

    (c) Dry run: ``BLUEFOG_AUTOTUNE_DRY_RUN=1`` with (a)'s fault and doctor,
    cooldown 3, 1 + 6 steps: only ``dry_run_swap`` decisions, at least two,
    spaced by the cooldown; no migration, the topology version unmoved; the
    parameters and momentum bitwise the same run without the controller.

    (d) Rollback, on the scripted trigger ``AT_TRIG`` (no session: a
    rollback through ``ctx.set_topology`` restores the pre-swap matrix
    itself; under an ``average`` session it would install that matrix's
    symmetrized repair): after the swap the controller's clock reads 5x the
    baseline. Gates: one rollback with a ``regressed`` verification under a
    fresh topology version; the installed matrix bitwise the weighted Exp2
    it replaced; the regressed candidate blocklisted; the next step runs the
    restored plan, one ``encode`` and one ``decode_accumulate``, its combine
    bitwise the plain versions.

    (e) Wire crossing, ``BLUEFOG_AUTOTUNE_WIRE=int4_ef`` from ATC int8_ef on
    ``AT_TRIG``: the chosen candidate and its wire reported; where the wire
    is ``int4_ef`` the step after the swap starts from zeroed CHOCO copies
    (the int8_ef ones before it were not), launches one ``encode_diff`` and
    a ``decode_add`` a round and nothing else, and its output and copies are
    bitwise the plain versions'.

    (f) Audit, on (a)'s run (``BLUEFOG_HEALTH=1`` at its default interval,
    ``BLUEFOG_AUTOTUNE_FILE``): the swap is on ``bluefog.autotune.decisions``
    (one a decision) and ``bluefog.autotune.action.swap`` (one), in the
    flight dump's ``autotune_decisions``, in the JSONL with its choice and
    in ``/fleet``'s ``autotune`` block (served on 127.0.0.1);
    ``tools/autotune_report.py`` on the dump exits 0 and prints
    ``decision #0``."""
    os.makedirs(root, exist_ok=True)
    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    params0 = sm.replicate()
    counts = {k: 0 for k in launch_counts()}

    def add(part):
        for k in counts:
            counts[k] += part[k]

    parts_s, parts_n = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        a = at_closed_loop(device, sm, images, labels, stats0, params0, root)
        add(a["counts"])
        parts_n["a+f"] = a["counts"]
        parts_s["a+f"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        b, part = at_off_is_on(device, sm, images, labels, stats0, params0)
        add(part)
        parts_n["b"] = part
        parts_s["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        c, part = at_dry_run(device, sm, images, labels, stats0, params0)
        add(part)
        parts_n["c"] = part
        parts_s["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        d, part = at_rollback(device, sm, images, labels, stats0, params0)
        add(part)
        parts_n["d"] = part
        parts_s["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        e, part = at_wire(device, sm, images, labels, stats0, params0)
        add(part)
        parts_n["e"] = part
        parts_s["e"] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
        sm.load_buffers(stats0)
        bft.elastic.stop()
        from bluefog_tpu_torch import autotune

        autotune.stop()
        bft.init(size=SIZE, device=device)
        for name in ("decisions.jsonl", "autotune_dump.json"):
            if os.path.exists(os.path.join(root, name)):
                os.remove(os.path.join(root, name))
    log("autotune", f"(a) degrade {AT_DEGRADE}: {a['advisories']} degraded_link advisories on "
                    f"[2, 3] (other edges named: {a['others']}); decisions {a['decisions']} (swap after step {a['swap_step']}): "
                    f"{a['chosen']}, {a['rounds']} rounds against the incumbent's "
                    f"{a['incumbent_rounds']}, predicted gain_frac {a['gain']} "
                    f"({a['predicted']}); step clock pinned at {a['pinned_ms']:.1f} ms "
                    f"(warm-up {a['warmup_ms']}, observed steps {a['steps_ms']}); combine "
                    f"{a['combine_before_ms']:.2f} ms before, {a['combine_after_ms']:.2f} after "
                    f"(CUDA events); host ms: deciding sample {a['observe_ms']:.2f}, a quiet "
                    f"sample {a['observe_quiet_ms']:.3f}, scoring {a['n_cands']} candidates "
                    f"{ {k: round(v, 3) for k, v in a['score_ms'].items()} }; gates met: one "
                    f"swap, none rolled back, w[2, 3] down, 0 stale, post-swap combine bitwise "
                    f"plain (CPU {a['plain_s']:.1f} s), 1 encode + 1 decode_accumulate, host "
                    f"replay = record; on {smi}")
    log("autotune", f"(b) controller at interval 1 bitwise off, no op-cache key, 3 samples, 0 "
                    f"decisions; interval 10: mean step {b['on_ms']:.1f} ms on, "
                    f"{b['off_ms']:.1f} off ({100 * b['share']:+.2f}%, reported; steps ms "
                    f"{b['steps_ms']}); on {smi}")
    log("autotune", f"(c) dry run: {c['decisions']} at comm steps {c['marks']} (chosen "
                    f"{c['chosen']}), 0 migrations, bitwise off")
    log("autotune", f"(d) rollback: swap to {d['chosen']}, delivered {d['delivered']}, "
                    f"decisions {d['decisions']}; Exp2 restored bitwise, blocklisted, next "
                    f"step ({d['rounds']} rounds) bitwise plain")
    log("autotune", f"(e) BLUEFOG_AUTOTUNE_WIRE=int4_ef from int8_ef: chosen {e['chosen']}, "
                    f"wire {e['wire']}, {e['rounds']} rounds"
                    + ("; fresh copies, 1 encode_diff + a decode_add a round, bitwise plain"
                       if e["wire"] == "int4_ef" else ""))
    log("autotune", f"(f) the swap on the counters, the flight table, the JSONL, /fleet and "
                    f"tools/autotune_report.py; parts "
                    f"{ {k: round(v, 1) for k, v in parts_s.items()} } s; launches {counts}, by "
                    f"part { {p: {k: v for k, v in n.items() if v} for p, n in parts_n.items()} }"
                    f"; (a) B1/B2 a step {a['step_launches']}")
    return counts, {"a": a, "b": b, "c": c, "d": d, "e": e, "parts_s": parts_s}


TP_ROOT = "build/transport"
# (b): two processes of four workers on the card, through the launcher
TP_HOSTS = "localhost:4,localhost:4"
TP_MACHINE = 4  # the hierarchical tier's machines: one per process in (b)
TP_TIMEOUT = 900  # seconds a spawned job may take before it is killed
TP_KERNELS = ("encode", "decode_accumulate", "encode_diff", "decode_add")


def transport_tiers():
    """``name -> (factory, compression)`` of the transport phase."""
    return {
        "atc": (bft.DistributedAdaptThenCombineOptimizer, None),
        "atc/int8": (bft.DistributedAdaptThenCombineOptimizer, "int8"),
        "atc/int4_ef": (bft.DistributedAdaptThenCombineOptimizer, "int4_ef"),
        "hier/int8": (bft.DistributedHierarchicalNeighborAllreduceOptimizer, "int8"),
        "grad-allreduce": (bft.DistributedGradientAllreduceOptimizer, None),
    }


def tp_log(msg):
    """One line in one write: the two processes of part (b) share a pipe."""
    sys.stdout.write(f"[transport] {msg}\n")
    sys.stdout.flush()


def tp_file(root, name):
    return os.path.join(root, name.replace("/", "_") + ".pt")


def tp_expected_bytes(ctx, name, width):
    """The bytes process ``ctx.process_index`` hands to ``isend`` in one
    step of tier ``name``: the gossip plan's edges from its rows to
    another process's, summed over the rounds (the machine plan's over the
    machines for hier/int8), times ``wire_payload_bytes`` of a row; the
    gradient allreduce sends all its rows to every other process."""
    from bluefog_tpu_torch.scaling import wire_payload_bytes

    _factory, wire = transport_tiers()[name]
    if name == "grad-allreduce":
        return ctx.n_local * (ctx.process_count - 1) * wire_payload_bytes(width, 4)
    bounds = np.concatenate([[0], np.cumsum(ctx.worker_counts)])
    if name.startswith("hier"):
        plan, bounds = ctx.machine_plan(), bounds // ctx.local_size
    else:
        plan = ctx.static_plan()
    lo, hi = bounds[ctx.process_index], bounds[ctx.process_index + 1]
    edges = sum(1 for rnd in plan.perms for j, i in rnd if lo <= j < hi and not lo <= i < hi)
    return edges * wire_payload_bytes(width, 4, wire)


def tp_run_tiers(device, sm, images, labels, names, warmup, timed):
    """Each tier ``warmup + timed`` two-program steps (``loss_and_grad``,
    then ``opt.step``) from the replicated parameters and the same batch
    statistics, on the active context; yields ``(name, parameters,
    numbers)``, the launch counts zeroed just before the tier and read just
    after."""
    from bluefog_tpu_torch.collective import transport

    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    params0 = sm.replicate()
    for name in names:
        factory, wire = transport_tiers()[name]
        sm.load_buffers(stats0)
        opt = factory(bft.sgd(0.1, momentum=0.9))
        opt.compression = wire
        params = params0.clone()
        state = opt.init(params)
        grads = torch.empty_like(params)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        times, sent = [], []
        for i in range(warmup + timed):
            sync(device)
            t0 = time.perf_counter()
            sm.loss_and_grad(params, images, labels, grads)
            sync(device)
            t1 = time.perf_counter()
            before = transport.stats()
            opt.step(params, state, grads)
            sync(device)
            t2 = time.perf_counter()
            after = transport.stats()
            sent.append(after["bytes"] - before["bytes"])
            if i >= warmup:
                times.append((t2 - t0, t1 - t0, t2 - t1, after["seconds"] - before["seconds"]))
        launches = launch_counts()
        if not torch.isfinite(params).all():
            raise AssertionError(f"transport {name}: non-finite parameters")
        med = [statistics.median(t[c] for t in times) for c in range(4)]
        peak = (torch.cuda.max_memory_allocated(device) / 2**30
                if device.type == "cuda" else float("nan"))
        row = dict(step_s=med[0], fb_s=med[1], opt_ms=med[2] * 1e3, transport_ms=med[3] * 1e3,
                   peak_gib=peak, bytes_per_step=sent, launches=launches)
        opt.free()
        del opt, state, grads
        yield name, params, row
    sm.load_buffers(stats0)


def tp_config(root, device, part, names, warmup, timed, trainer_kw):
    path = os.path.join(root, f"config_{part}.json")
    with open(path, "w") as f:
        json.dump(dict(root=root, device=device.type, part=part, tiers=list(names),
                       warmup=warmup, timed=timed, trainer=trainer_kw, machine=TP_MACHINE), f)
    return path


def tp_spawn(argv, env, timeout=TP_TIMEOUT):
    """Run ``argv`` in a session of its own, stdout and stderr captured;
    past ``timeout`` every process of the session is killed and the phase
    fails, as it does on a nonzero exit."""
    import signal

    proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"transport: {argv[2:6]} passed its {timeout} s timeout and was "
                             f"killed; output:\n{out[-3000:]}\n{err[-3000:]}")
    for line in out.splitlines():
        print(line, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"transport: {argv[2:6]} exited with {proc.returncode}:\n"
                             f"{err[-6000:]}")
    return out


def tp_child_env(extra=None):
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("BLUEFOG_")}
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def tp_free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_transport_child(config_path):
    """``python3 chip_smoke.py --transport-child <config>``: one process of
    part (b) (launched by ``bfrun-torch``) or the one process of part (c)
    (``BLUEFOG_COORDINATOR`` set, world size 1): joins the process group
    through ``bft.init``, builds its rows of the ResNet50 and of the batch,
    runs the tiers and holds its rows against part (a)'s, writing its
    numbers to ``child_<part>_<process>.json``."""
    import torch.distributed as dist

    with open(config_path) as f:
        cfg = json.load(f)
    device = torch.device(cfg["device"])
    ctx = bft.init(size=SIZE, device=device, nodes_per_machine=cfg["machine"])
    if device.type == "cuda":
        _build.wire_library()
    sm, images, labels = build_trainer(device, rows=ctx.rows, **cfg["trainer"])
    bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
    bft.set_machine_topology(topo.RingGraph(SIZE // cfg["machine"]))
    res = dict(process=ctx.process_index, process_count=ctx.process_count,
               rows=[ctx.rows.start, ctx.rows.stop], backend=dist.get_backend(),
               staged=ctx.staged, tiers={})
    if cfg["part"] == "c" and device.type == "cuda":
        t = torch.ones(4, device=device)
        dist.all_reduce(t)  # the NCCL communicator is built by its first call
        sync(device)
        res["nccl_all_reduce"] = float(t.sum())
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, params, row in tp_run_tiers(device, sm, images, labels, cfg["tiers"],
                                              cfg["warmup"], cfg["timed"]):
            ref = torch.load(tp_file(cfg["root"], name), map_location="cpu", weights_only=True)
            want, got = ref[ctx.rows.start:ctx.rows.stop], params.cpu()
            row["bitwise"] = bool(torch.equal(bits(got), bits(want)))
            row["max_diff"] = float((got - want).abs().max())
            row["expected_bytes"] = tp_expected_bytes(ctx, name, sm.width)
            res["tiers"][name] = row
            del ref, want, got, params
            tp_log(f"({cfg['part']}) process {ctx.process_index}/{ctx.process_count} rows "
                   f"{ctx.rows.start}..{ctx.rows.stop - 1} ({res['backend']}"
                   f"{', staged' if ctx.staged else ''}) {name}: step {row['step_s']:.4f} s, "
                   f"optimizer {row['opt_ms']:.1f} ms, transport {row['transport_ms']:.1f} ms "
                   f"a step, {row['bytes_per_step'][-1]} B sent a step (expected "
                   f"{row['expected_bytes']}), peak {row['peak_gib']:.2f} GiB, launches "
                   f"{ {k: v for k, v in row['launches'].items() if v} }, bitwise (a): "
                   f"{row['bitwise']}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    path = os.path.join(cfg["root"], f"child_{cfg['part']}_{ctx.process_index}.json")
    with open(path, "w") as f:
        json.dump(res, f)
    bft.shutdown()
    return 0


def phase_transport(device, sm, images, labels, root=TP_ROOT, smi="", trainer_kw=None,
                    names=None, warmup=1, timed=2):
    """Phase 11g: the multi-process transport on the ResNet50 of the
    train-step phase at ``PATH_TRAINER``'s depth (``bench.py::run_headline``'s
    settings: 8 workers, 64 images of 224 x 224 each, the weighted Exp2(8),
    ``sgd(0.1, 0.9)``, the seeds of phase 7), cuDNN deterministic, each tier
    1 warm-up and 2 timed
    two-program steps (``loss_and_grad``, ``opt.step``) from the replicated
    parameters: atc, atc/int8, atc/int4_ef, hier/int8 (2 machines of 4 on
    the ring of machines) and grad-allreduce.

    (a) The stacked reference in this process; each tier's parameters are
    saved under ``build/transport/``. Then this process frees its tensors
    and empties the allocator's cache.

    (b) Two processes sharing the card, started by the port's launcher
    (``bfrun-torch -np 8 -H localhost:4,localhost:4``), four workers each,
    the backend gloo with the CUDA rows staged through pinned host memory,
    the same tiers, seeds and batches. Gates: each process exits 0 within
    ``TP_TIMEOUT`` (else it is killed); its backend is gloo and staged; its
    parameters equal rows ``4p .. 4p + 3`` of (a) bit for bit on every tier
    (the allreduce gathers every row and reduces in the stacked order, so
    grad-allreduce is bitwise too); the bytes it hands to ``isend`` in every
    step equal the plan's edges from its rows to the other process's times
    ``wire_payload_bytes`` (:func:`tp_expected_bytes`); it launches
    ``encode`` and ``decode_accumulate`` (atc/int8, hier/int8) and
    ``encode_diff`` and ``decode_add`` (atc/int4_ef). Each prints a line a
    tier: step s, optimizer ms, transport ms a step (staging and gloo
    together), bytes sent, peak GiB, launches.

    (c) NCCL at world size 1: one process with ``BLUEFOG_COORDINATOR`` set,
    so the backend is nccl (one all_reduce builds the communicator); atc/int8
    for the same steps, bitwise (a). On the card only.

    Files under ``build/transport/``, deleted. Returns ``({"transport a":,
    "transport":, "transport nccl": launch counts}, numbers)``: (b)'s counts
    are the sum of its two processes'."""
    import shutil

    names = list(transport_tiers()) if names is None else list(names)
    trainer_kw = {} if trainer_kw is None else dict(trainer_kw)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    zero = {k: 0 for k in launch_counts()}
    counts = {"transport a": dict(zero), "transport": dict(zero), "transport nccl": dict(zero)}
    bft.init(size=SIZE, device=device, nodes_per_machine=TP_MACHINE)
    bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
    bft.set_machine_topology(topo.RingGraph(SIZE // TP_MACHINE))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    numbers = {"a": {}}
    try:
        for name, params, row in tp_run_tiers(device, sm, images, labels, names, warmup, timed):
            torch.save(params.cpu(), tp_file(root, name))
            del params
            numbers["a"][name] = row
            for k, v in row["launches"].items():
                counts["transport a"][k] += v
            log("transport", f"(a) stacked, one process, 8 workers: {name}: step "
                             f"{row['step_s']:.4f} s, optimizer {row['opt_ms']:.1f} ms, peak "
                             f"{row['peak_gib']:.2f} GiB, launches "
                             f"{ {k: v for k, v in row['launches'].items() if v} }")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    bft.init(size=SIZE, device=device)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "chip_smoke.py")
    root = os.path.abspath(root)
    t0 = time.perf_counter()
    cfg = tp_config(root, device, "b", names, warmup, timed, trainer_kw)
    tp_spawn([sys.executable, "-m", "bluefog_tpu_torch.run.run", "-np", str(SIZE), "-H", TP_HOSTS,
              "--coordinator", f"127.0.0.1:{tp_free_port()}", "--num-processes", "2",
              script, "--transport-child", cfg], tp_child_env())
    b_s = time.perf_counter() - t0
    numbers["b"] = []
    for p in range(2):
        with open(os.path.join(root, f"child_b_{p}.json")) as f:
            res = json.load(f)
        numbers["b"].append(res)
        if (res["process_count"], res["rows"], res["backend"]) != (2, [4 * p, 4 * p + 4], "gloo"):
            raise AssertionError(f"transport (b) process {p}: {res['process_count']} processes, "
                                 f"rows {res['rows']}, backend {res['backend']}")
        if res["staged"] != (device.type == "cuda"):
            raise AssertionError(f"transport (b) process {p}: staged {res['staged']}")
        for name in names:
            row = res["tiers"][name]
            if not row["bitwise"]:
                raise AssertionError(f"transport (b) process {p} {name}: rows {4 * p}..{4 * p + 3}"
                                     f" differ from (a) (max diff {row['max_diff']:.3g})")
            if any(b != row["expected_bytes"] for b in row["bytes_per_step"]):
                raise AssertionError(f"transport (b) process {p} {name}: sent "
                                     f"{row['bytes_per_step']} B a step, expected "
                                     f"{row['expected_bytes']}")
            for k, v in row["launches"].items():
                counts["transport"][k] += v
        launched = {k: sum(r["launches"][k] for r in res["tiers"].values()) for k in TP_KERNELS}
        want = [k for k, tier in (("encode", "atc/int8"), ("decode_accumulate", "atc/int8"),
                                  ("encode_diff", "atc/int4_ef"), ("decode_add", "atc/int4_ef"))
                if tier in names]
        missing = [k for k in want if launched[k] == 0]
        if device.type == "cuda" and missing:
            raise AssertionError(f"transport (b) process {p} launched no {missing}: {launched}")

    numbers["c"] = None
    if device.type == "cuda" and "atc/int8" in names:
        t0 = time.perf_counter()
        cfg = tp_config(root, device, "c", ["atc/int8"], warmup, timed, trainer_kw)
        tp_spawn([sys.executable, script, "--transport-child", cfg], tp_child_env(dict(
            BLUEFOG_COORDINATOR=f"127.0.0.1:{tp_free_port()}", BLUEFOG_NUM_PROCESSES="1",
            BLUEFOG_PROCESS_ID="0", BLUEFOG_NUM_WORKERS=str(SIZE))))
        c_s = time.perf_counter() - t0
        with open(os.path.join(root, "child_c_0.json")) as f:
            res = json.load(f)
        numbers["c"] = res
        row = res["tiers"]["atc/int8"]
        if (res["backend"], res["process_count"], res["rows"]) != ("nccl", 1, [0, SIZE]):
            raise AssertionError(f"transport (c): backend {res['backend']}, "
                                 f"{res['process_count']} processes, rows {res['rows']}")
        if res.get("nccl_all_reduce") != 4.0 or not row["bitwise"]:
            raise AssertionError(f"transport (c): all_reduce {res.get('nccl_all_reduce')}, "
                                 f"bitwise (a) {row['bitwise']} (max diff {row['max_diff']:.3g})")
        for k, v in row["launches"].items():
            counts["transport nccl"][k] += v
        log("transport", f"(c) NCCL at world size 1 (one process, BLUEFOG_COORDINATOR set): "
                         f"atc/int8 step {row['step_s']:.4f} s, optimizer {row['opt_ms']:.1f} ms, "
                         f"bitwise (a); process {c_s:.1f} s")
    else:
        log("transport", "(c) NCCL needs the card: skipped on the CPU")
    shutil.rmtree(root, ignore_errors=True)
    for name in names:
        per = [r["tiers"][name] for r in numbers["b"]]
        how = ("sharing the card, gloo staged through pinned host memory"
               if numbers["b"][0]["staged"] else "on the CPU, gloo")
        log("transport", f"(b) {name}: two processes x 4 workers {how}: step "
                         f"{max(r['step_s'] for r in per):.4f} s (stacked "
                         f"{numbers['a'][name]['step_s']:.4f}), optimizer "
                         f"{max(r['opt_ms'] for r in per):.1f} ms (stacked "
                         f"{numbers['a'][name]['opt_ms']:.1f}), transport "
                         f"{max(r['transport_ms'] for r in per):.1f} ms a step, "
                         f"{per[0]['bytes_per_step'][-1]} / {per[1]['bytes_per_step'][-1]} B "
                         f"sent a step, peak {max(r['peak_gib'] for r in per):.2f} GiB; "
                         f"rows bitwise (a); on {smi}")
    log("transport", f"launches {counts}; (b) {b_s:.1f} s of processes; phase "
                     f"{time.perf_counter() - t_phase:.1f} s")
    return counts, numbers


def run_transport_alone():
    """``python3 chip_smoke.py --phase transport``: phase 11g alone on the
    full-width ResNet50 at ``PATH_TRAINER``'s depth (the wire kernels built
    first); its gates as in the whole run, its lines and its launch counts.
    Prints no result line."""
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    _build.build(["wire_kernels"])
    _build.wire_library()
    bft.init(size=SIZE)
    sm, images, labels = build_trainer(device, **PATH_TRAINER)
    counts, _numbers = phase_transport(device, sm, images, labels, smi=smi,
                                       trainer_kw=PATH_TRAINER)
    for path in ("transport a", "transport"):
        missing = [k for k in PATH_KERNELS[path] if counts[path][k] == 0]
        if missing:
            raise AssertionError(f"the {path} path launched no {missing} kernel: {counts[path]}")
    return 0


TS_ROOT = "build/transport_state"
TS_KERNELS = ("encode", "decode")
TS_TICKS = 4  # async/int8: 1 warm-up and 3 timed ticks
TS_CKPT = "push-sum/int8"  # the tier whose checkpoint (c) restores
TS_LR0 = ("push-sum/int8", "push-sum/int4")  # the tiers with the mass gates
TS_QUANTIZED = ("push-sum/int8", "push-sum/int4", "async/int8", "zero2/int8")


def ts_tiers():
    """``name -> env`` of the transport-state phase, in the order it runs
    them: the window wire of the push-sum tiers, ZeRO-2's switches."""
    return {
        "push-sum/int8": {"BLUEFOG_WINDOW_WIRE": "int8"},
        "push-sum/int4": {"BLUEFOG_WINDOW_WIRE": "int4"},
        "win-put/fp32": {},
        "async/int8": {},
        "zero2/int8": {"BLUEFOG_SHARD": "1", "BLUEFOG_SHARD_GRADS": "1"},
    }


def ts_log(msg):
    """One line in one write: the two processes of part (b) share a pipe."""
    sys.stdout.write(f"[transport-state] {msg}\n")
    sys.stdout.flush()


def ts_masses(win):
    """``[x mass, sum |x|, p mass]`` of a window over every process, float64
    sums of values plus buffers: one ``gather_rows`` of the local rows'
    sums."""
    from bluefog_tpu_torch.collective import transport

    f64 = torch.float64
    rows = win.value.shape[0]
    v = win.value.to(f64).reshape(rows, -1)
    b = win.buffers.reshape(rows, -1)
    local = torch.stack([v.sum(1) + torch.sum(b, 1, dtype=f64),
                         v.abs().sum(1) + torch.sum(b.abs(), 1, dtype=f64),
                         win.p.to(f64) + win.p_buffers.to(f64).sum(1)], dim=1)
    if bft.get_context().process_count > 1:
        local = transport.gather_rows(local.contiguous())
    return [float(t) for t in local.sum(0)]


def ts_expected_bytes(ctx, name, width, slot=None):
    """The bytes process ``ctx.process_index`` hands to ``isend`` in one
    step of tier ``name``. Window tiers: the exchange's edges from its rows
    to another process's (push-sum and win-put: the Exp graph's out-edges,
    async: the ring's) times ``wire_payload_bytes`` of the window wire,
    plus 4 an edge for the p lane (push-sum, async). zero2/int8: the
    reduce-scatter's crossing edges over its rounds times
    ``wire_payload_bytes(slot, 4, 'int8')``, plus ZeRO's gather of the
    updated slots (its rows to every other process)."""
    from bluefog_tpu_torch.collective import compiler
    from bluefog_tpu_torch.scaling import wire_payload_bytes

    rows = ctx.rows
    crossing = lambda pairs: sum(1 for s, d in pairs if s in rows and d not in rows)  # noqa
    if name == "zero2/int8":
        perms = compiler.compile_reduce_scatter(SIZE).perms
        scatter = crossing([pair for perm in perms for pair in perm])
        return (scatter * wire_payload_bytes(slot, 4, "int8")
                + ctx.n_local * (ctx.process_count - 1) * slot * 4)
    outs = ctx.out_neighbor_ranks()
    edges = crossing([(s, d) for s in range(SIZE) for d in outs[s]])
    wire = {"push-sum/int8": "int8", "push-sum/int4": "int4", "async/int8": "int8"}.get(name)
    p_lane = 0 if name == "win-put/fp32" else 4
    return edges * (wire_payload_bytes(width, 4, wire) + p_lane)


def ts_run_tier(device, sm, images, labels, name, warmup, timed, ckpt=None, restore=None):
    """Tier ``name`` on the active context: ``warmup + timed`` steps from
    the replicated parameters and the phase's batch statistics (the async
    tier: ``TS_TICKS`` ticks). Returns ``(numbers, state)``: ``state`` holds
    this process's rows (on the CPU) of the parameters, the window lanes
    (value, p, versions) and the sharded state. With ``ckpt`` (push-sum)
    the run then saves a checkpoint there and takes one more step
    (``state["next"]``); with ``restore`` it starts from that checkpoint
    and takes one step only. The push-sum tiers end with an lr-0 step whose
    masses (gathered over the processes) are ``numbers["mass"]``."""
    from bluefog_tpu_torch import checkpoint
    from bluefog_tpu_torch.collective import transport

    ctx = bft.get_context()
    workers = torch.arange(ctx.n_local)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    times, sent, state_out = [], [], {}
    numbers = {}

    def timed_call(i, fb, opt_step):
        sync(device)
        t0 = time.perf_counter()
        fb()
        sync(device)
        t1 = time.perf_counter()
        before = transport.stats()
        opt_step()
        sync(device)
        t2 = time.perf_counter()
        after = transport.stats()
        sent.append(after["bytes"] - before["bytes"])
        if i >= warmup:
            times.append((t2 - t0, t1 - t0, t2 - t1, after["seconds"] - before["seconds"]))

    with env_set(ts_tiers()[name]):
        grads = torch.empty((ctx.n_local, sm.width), dtype=torch.float32, device=device)
        if name.startswith(("push-sum", "win-put")):
            bft.set_topology(topo.ExponentialGraph(SIZE))
            make = (bft.DistributedPushSumOptimizer if name.startswith("push-sum")
                    else bft.DistributedWinPutOptimizer)
            opt = make(bft.sgd(0.1, momentum=0.9))
            state = opt.init(sm.replicate())
            if restore is not None:
                _s, _p, state = checkpoint.restore(restore, optimizer=opt, extra=sm.buffers)
            box = [opt.params(), state]

            def step():
                box[0], box[1] = opt.step(box[1], grads)

            for i in range(1 if restore is not None else warmup + timed):
                timed_call(i, lambda: sm.loss_and_grad(box[0], images, labels, grads), step)
            win = ctx.windows[opt._name]
            # copies now: the next step updates the window value in place
            state_out = {k: v.detach().cpu().clone() for k, v in dict(
                params=box[0], value=win.value, p=win.p, versions=win.versions).items()}
            if ckpt is not None:
                checkpoint.save(ckpt, warmup + timed, box[0], box[1], optimizer=opt,
                                extra=sm.buffers)
                if ctx.process_count == 1:  # (a) takes the step (c) takes after a restore
                    sm.loss_and_grad(box[0], images, labels, grads)
                    step()
                    state_out["next"] = box[0].detach().cpu().clone()
            if name in TS_LR0 and restore is None:
                numbers["mass0"] = ts_masses(win)
                opt.tx = bft.sgd(0.0, momentum=0.9)
                sm.loss_and_grad(box[0], images, labels, grads)
                step()
                sync(device)
                numbers["mass"] = ts_masses(win)
            opt.free()
            del opt, box, win
        elif name == "async/int8":
            bft.set_topology(topo.RingGraph(SIZE, connect_style=1))
            opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9))
            params = sm.replicate()
            state = opt.init(params)
            tick = bft.make_async_train_step(opt, sm.worker_loss,
                                             cadence={ASYNC_SLOW: ASYNC_FACTOR},
                                             max_age=ASYNC_MAX_AGE, policy="drop", wire="int8",
                                             buffers=sm.buffers)
            eng = tick.engine
            box = [params, state]
            eng_local, local_s = eng._local_step, []

            def timed_local(*args):
                # the due ranks' forward+backward and update, timed apart
                # from the exchange and the fold (the optimizer part)
                sync(device)
                t0 = time.perf_counter()
                eng_local(*args)
                sync(device)
                local_s.append(time.perf_counter() - t0)

            eng._local_step = timed_local
            for i in range(TS_TICKS):
                sync(device)
                t0 = time.perf_counter()
                before = transport.stats()
                box[0], box[1], _loss = tick(box[0], box[1], images, labels, workers)
                sync(device)
                tick_s = time.perf_counter() - t0
                after = transport.stats()
                sent.append(after["bytes"] - before["bytes"])
                if i >= 1:
                    times.append((tick_s, local_s[-1], tick_s - local_s[-1],
                                  after["seconds"] - before["seconds"]))
            del eng._local_step  # the class's method again
            win = ctx.windows[eng._name]
            numbers["summary"] = eng.summary()
            numbers["advisories"] = [a.to_json() for a in eng.advisories]
            state_out = {k: v.detach().cpu().clone() for k, v in dict(
                params=box[0], value=win.value, p=win.p, versions=win.versions).items()}
            eng.free()
            del eng, tick, box, win, opt, state
        else:  # zero2/int8
            opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(ZERO_LR))
            opt.compression = "int8"
            params = sm.replicate()
            state = opt.init(params)
            for i in range(warmup + timed):
                timed_call(i, lambda: sm.loss_and_grad(params, images, labels, grads),
                           lambda: opt.step(params, state, grads))
            numbers["slot"] = opt._shard_layout.groups[0].slot
            from bluefog_tpu_torch.optimizers import tree_leaves

            state_out = {"params": params.detach().cpu().clone()}
            state_out.update({f"shard_{i}": t.detach().cpu().clone()
                              for i, t in enumerate(tree_leaves(state))})
            opt.free()
            del opt, state, params
        del grads
    numbers["launches"] = launch_counts()
    for key, v in state_out.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f"transport-state {name}: non-finite {key}")
    med = [statistics.median(t[c] for t in times) for c in range(4)]
    numbers.update(step_s=med[0], fb_s=med[1], opt_ms=med[2] * 1e3, transport_ms=med[3] * 1e3,
                   bytes_per_step=sent,
                   peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                             if device.type == "cuda" else float("nan")))
    return numbers, state_out


def ts_config(root, device, part, names, warmup, timed, trainer_kw):
    path = os.path.join(root, f"config_{part}.json")
    with open(path, "w") as f:
        json.dump(dict(root=root, device=device.type, part=part, tiers=list(names),
                       warmup=warmup, timed=timed, trainer=trainer_kw), f)
    return path


def run_transport_state_child(config_path):
    """``python3 chip_smoke.py --transport-state-child <config>``: one
    process of part (b) (launched by ``bfrun-torch``): joins the process
    group through ``bft.init``, builds its rows of the ResNet50 and of the
    batch, runs the tiers, holds its rows against part (a)'s, writes its own
    checkpoint, then restores (a)'s for part (c); its numbers go to
    ``child_<process>.json``."""
    import torch.distributed as dist

    with open(config_path) as f:
        cfg = json.load(f)
    device = torch.device(cfg["device"])
    root = cfg["root"]
    ctx = bft.init(size=SIZE, device=device)
    if device.type == "cuda":
        _build.wire_library()
    sm, images, labels = build_trainer(device, rows=ctx.rows, **cfg["trainer"])
    lo, hi = ctx.rows.start, ctx.rows.stop
    # (a)'s starting batch statistics, this process's rows
    stats0 = {k: v[lo:hi].to(device) for k, v in torch.load(
        tp_file(root, "stats0"), map_location="cpu", weights_only=True).items()}
    res = dict(process=ctx.process_index, process_count=ctx.process_count, rows=[lo, hi],
               backend=dist.get_backend(), staged=ctx.staged, tiers={})
    tag = (f"(b) process {ctx.process_index}/{ctx.process_count} rows {lo}..{hi - 1} "
           f"({res['backend']}{', staged' if ctx.staged else ''})")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in cfg["tiers"]:
            sm.load_buffers(stats0)
            ckpt = os.path.join(root, "ckpt_b") if name == TS_CKPT else None
            row, state = ts_run_tier(device, sm, images, labels, name, cfg["warmup"],
                                     cfg["timed"], ckpt=ckpt)
            ref = torch.load(tp_file(root, name), map_location="cpu", weights_only=True)
            row["bitwise"] = {k: bool(torch.equal(bits(v), bits(ref[k][lo:hi])))
                              for k, v in state.items() if k != "next"}
            row["expected_bytes"] = ts_expected_bytes(ctx, name, sm.width, row.get("slot"))
            res["tiers"][name] = row
            del ref, state
            ts_log(f"{tag} {name}: step {row['step_s']:.4f} s, optimizer {row['opt_ms']:.1f} ms, "
                   f"transport {row['transport_ms']:.1f} ms a step, {row['bytes_per_step'][-1]} "
                   f"B sent a step (expected {row['expected_bytes']}), peak "
                   f"{row['peak_gib']:.2f} GiB, launches "
                   f"{ {k: v for k, v in row['launches'].items() if v} }, bitwise (a): "
                   f"{row['bitwise']}"
                   + (f", masses {row['mass0']} -> {row['mass']}" if "mass" in row else ""))
        if TS_CKPT in cfg["tiers"]:
            # (c): (a)'s checkpoint restored here, one more step
            sm.load_buffers(stats0)
            row, state = ts_run_tier(device, sm, images, labels, TS_CKPT, 0, 1,
                                     restore=os.path.join(root, "ckpt_a"))
            ref = torch.load(tp_file(root, "next"), map_location="cpu", weights_only=True)
            row["bitwise"] = {"next": bool(torch.equal(bits(state["params"]),
                                                       bits(ref[lo:hi])))}
            res["restored"] = row
            ts_log(f"{tag} (c) {TS_CKPT} restored from (a)'s checkpoint, one step: "
                   f"{row['step_s']:.4f} s, bitwise (a)'s next step: {row['bitwise']['next']}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    with open(os.path.join(root, f"child_{ctx.process_index}.json"), "w") as f:
        json.dump(res, f)
    bft.shutdown()
    return 0


def ts_same_tree(a, b, where=""):
    """Two loaded checkpoints of one structure, every tensor bitwise
    equal; returns the tensors compared. Other leaves are not held: the
    window's name counts the windows a process created before."""
    if isinstance(a, torch.Tensor):
        if not (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(bits(a), bits(b))):
            raise AssertionError(f"transport-state (c): checkpoint leaf {where} differs")
        return 1
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            raise AssertionError(f"transport-state (c): checkpoint keys {where} differ")
        return sum(ts_same_tree(a[k], b[k], f"{where}.{k}") for k in a)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"transport-state (c): checkpoint {where} differs")
        return sum(ts_same_tree(x, y, f"{where}[{i}]") for i, (x, y) in enumerate(zip(a, b)))
    return 0


def phase_transport_state(device, sm, images, labels, root=TS_ROOT, smi="", trainer_kw=None,
                          names=None, warmup=1, timed=2):
    """Phase 11h: the window ops, the async engine, ZeRO and checkpoint
    across processes, on the ResNet50 of the train-step phase
    at ``PATH_TRAINER``'s depth (``bench.py::run_headline``'s settings: 8
    workers, 64 images of 224 x 224 each, the seeds of phase 7), cuDNN
    deterministic, each tier 1 warm-up and 2 timed steps from the
    replicated parameters:
    ``push-sum/int8`` and ``push-sum/int4`` (``DistributedPushSumOptimizer
    (sgd(0.1, 0.9))`` on ``BLUEFOG_WINDOW_WIRE``, the Exp graph, as phase 8
    builds it), ``win-put/fp32``, ``async/int8`` (phase 10's straggler:
    the ring, rank 6 at one tenth of the cadence, ``max_age`` 4, for 4
    ticks) and ``zero2/int8`` (``DistributedGradientAllreduceOptimizer(
    adam(1e-4))`` under ``BLUEFOG_SHARD=1 BLUEFOG_SHARD_GRADS=1``, the
    ``zero2/int8`` row of ``ZERO_TIERS``).

    (a) The stacked reference in this process, every tier from the batch
    statistics the phase is given (saved for (b)): each tier's parameters,
    window lanes (value, p, versions) and sharded state are saved under
    ``build/transport_state/``; ``push-sum/int8`` writes a checkpoint after
    its timed steps and takes one more step. Then this process frees its
    tensors and empties the allocator's cache.

    (b) Two processes sharing the card, started by the port's launcher
    (``bfrun-torch -np 8 -H localhost:4,localhost:4``), four workers each,
    gloo with the CUDA rows staged through pinned host memory. Gates: each
    process exits 0 within ``TP_TIMEOUT`` (else it is killed); its rows of
    every saved tensor equal rows ``4p .. 4p + 3`` of (a) bit for bit on
    every tier; the x mass summed over the two processes (one
    ``gather_rows``) stays within ``ASYNC_MASS_TOL`` of its start, relative
    to its ``sum |x|``, over an lr-0 step, and the p mass is exactly 8 (the
    push-sum tiers, in (a) too); the bytes it hands to ``isend`` in every
    step equal :func:`ts_expected_bytes`; it launches ``encode`` and
    ``decode`` on every quantized tier. Each prints a line a tier: step s,
    optimizer ms, transport ms a step, bytes sent, peak GiB, launches.

    (c) Checkpoint across layouts: (b)'s processes restore (a)'s
    ``push-sum/int8`` checkpoint and take one more step, bitwise (a)'s next
    step; the checkpoint (b) wrote after its timed steps has a ``state.pt``
    whose tensors are bitwise (a)'s, and the same sidecar.

    Files under ``build/transport_state/``, deleted. Returns
    ``({"transport-state a":, "transport-state":}, numbers)``: (b)'s counts
    are the sum of its two processes' (part (c) included)."""
    import shutil

    names = list(ts_tiers()) if names is None else list(names)
    trainer_kw = {} if trainer_kw is None else dict(trainer_kw)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    root = os.path.abspath(root)
    t_phase = time.perf_counter()
    zero = {k: 0 for k in launch_counts()}
    counts = {"transport-state a": dict(zero), "transport-state": dict(zero)}
    ctx = bft.init(size=SIZE, device=device)
    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    # the batch statistics every tier starts from, here and in (b)'s
    # processes: the checkpoint holds them, so they must agree bitwise
    torch.save({k: v.cpu() for k, v in stats0.items()}, tp_file(root, "stats0"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    numbers = {"a": {}}
    try:
        for name in names:
            sm.load_buffers(stats0)
            ckpt = os.path.join(root, "ckpt_a") if name == TS_CKPT else None
            row, state = ts_run_tier(device, sm, images, labels, name, warmup, timed, ckpt=ckpt)
            if "next" in state:
                torch.save(state.pop("next"), tp_file(root, "next"))
            torch.save(state, tp_file(root, name))
            del state
            numbers["a"][name] = row
            for k, v in row["launches"].items():
                counts["transport-state a"][k] += v
            ts_mass_gate(f"(a) {name}", row)
            log("transport-state", f"(a) stacked, one process, 8 workers: {name}: step "
                                   f"{row['step_s']:.4f} s, optimizer {row['opt_ms']:.1f} ms, "
                                   f"peak {row['peak_gib']:.2f} GiB, launches "
                                   f"{ {k: v for k, v in row['launches'].items() if v} }"
                                   + (f", masses {row['mass0']} -> {row['mass']}"
                                      if "mass" in row else ""))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    sm.load_buffers(stats0)
    a_s = time.perf_counter() - t_phase
    bft.init(size=SIZE, device=device)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "chip_smoke.py")
    t0 = time.perf_counter()
    cfg = ts_config(root, device, "b", names, warmup, timed, trainer_kw)
    tp_spawn([sys.executable, "-m", "bluefog_tpu_torch.run.run", "-np", str(SIZE), "-H", TP_HOSTS,
              "--coordinator", f"127.0.0.1:{tp_free_port()}", "--num-processes", "2",
              script, "--transport-state-child", cfg], tp_child_env())
    b_s = time.perf_counter() - t0
    numbers["b"] = []
    for p in range(2):
        with open(os.path.join(root, f"child_{p}.json")) as f:
            res = json.load(f)
        numbers["b"].append(res)
        if (res["process_count"], res["rows"], res["backend"]) != (2, [4 * p, 4 * p + 4], "gloo"):
            raise AssertionError(f"transport-state (b) process {p}: {res['process_count']} "
                                 f"processes, rows {res['rows']}, backend {res['backend']}")
        if res["staged"] != (device.type == "cuda"):
            raise AssertionError(f"transport-state (b) process {p}: staged {res['staged']}")
        for name in names:
            row = res["tiers"][name]
            wrong = [k for k, same in row["bitwise"].items() if not same]
            if wrong:
                raise AssertionError(f"transport-state (b) process {p} {name}: rows "
                                     f"{4 * p}..{4 * p + 3} of {wrong} differ from (a)")
            if any(b != row["expected_bytes"] for b in row["bytes_per_step"]):
                raise AssertionError(f"transport-state (b) process {p} {name}: sent "
                                     f"{row['bytes_per_step']} B a step, expected "
                                     f"{row['expected_bytes']}")
            ts_mass_gate(f"(b) process {p} {name}", row)
            if device.type == "cuda" and name in TS_QUANTIZED:
                missing = [k for k in TS_KERNELS if row["launches"][k] == 0]
                if missing:
                    raise AssertionError(f"transport-state (b) process {p} {name} launched no "
                                         f"{missing}: {row['launches']}")
            if name == "async/int8" and row["summary"] != numbers["a"][name]["summary"]:
                raise AssertionError(f"transport-state (b) process {p}: the async summary "
                                     f"{row['summary']} differs from (a)'s")
            for k, v in row["launches"].items():
                counts["transport-state"][k] += v
        if TS_CKPT in names:
            if not res["restored"]["bitwise"]["next"]:
                raise AssertionError(f"transport-state (c) process {p}: the step after "
                                     f"restoring (a)'s checkpoint differs from (a)'s next step")
            for k, v in res["restored"]["launches"].items():
                counts["transport-state"][k] += v

    numbers["c"] = None
    if TS_CKPT in names:
        from bluefog_tpu_torch import checkpoint

        t0 = time.perf_counter()
        step = checkpoint.latest_step(os.path.join(root, "ckpt_a"))
        paths = [os.path.join(root, d, str(step)) for d in ("ckpt_a", "ckpt_b")]
        loaded = [torch.load(os.path.join(p, "state.pt"), map_location="cpu", weights_only=True)
                  for p in paths]
        n_tensors = ts_same_tree(loaded[0], loaded[1])
        sides = []
        for d in ("ckpt_a", "ckpt_b"):
            with open(os.path.join(root, d, f"{step}.graph.json")) as f:
                sides.append(f.read())
        if sides[0] != sides[1]:
            raise AssertionError("transport-state (c): the sidecars differ")
        size = os.path.getsize(os.path.join(paths[0], "state.pt"))
        del loaded
        numbers["c"] = {"tensors": n_tensors, "bytes": size, "check_s": time.perf_counter() - t0}
        log("transport-state", f"(c) {TS_CKPT}: (b)'s checkpoint state.pt ({size} B, "
                               f"{n_tensors} tensors) bitwise (a)'s, the sidecars equal; (a)'s "
                               f"restored in both processes, the next step bitwise (a)'s")
    shutil.rmtree(root, ignore_errors=True)
    for name in names:
        per = [r["tiers"][name] for r in numbers["b"]]
        a = numbers["a"][name]
        how = ("sharing the card, gloo staged through pinned host memory"
               if numbers["b"][0]["staged"] else "on the CPU, gloo")
        log("transport-state", f"(b) {name}: two processes x 4 workers {how}: step "
                               f"{max(r['step_s'] for r in per):.4f} s (stacked "
                               f"{a['step_s']:.4f}), optimizer "
                               f"{max(r['opt_ms'] for r in per):.1f} ms (stacked "
                               f"{a['opt_ms']:.1f}), transport "
                               f"{max(r['transport_ms'] for r in per):.1f} ms a step, "
                               f"{per[0]['bytes_per_step'][-1]} / {per[1]['bytes_per_step'][-1]} "
                               f"B sent a step, peak {max(r['peak_gib'] for r in per):.2f} GiB "
                               f"(stacked {a['peak_gib']:.2f}); rows bitwise (a); on {smi}")
    log("transport-state", f"launches {counts}; (a) {a_s:.1f} s, (b) and (c) {b_s:.1f} s of "
                           f"processes; phase {time.perf_counter() - t_phase:.1f} s")
    return counts, numbers


def ts_mass_gate(where, row):
    """The push-sum tiers' masses over an lr-0 step: the x mass within
    ``ASYNC_MASS_TOL`` of its start, relative to its ``sum |x|``; the p mass
    exactly ``SIZE`` before and after."""
    if "mass" not in row:
        return
    (x0, abs0, p0), (x1, _abs1, p1) = row["mass0"], row["mass"]
    if not abs(x1 - x0) <= ASYNC_MASS_TOL * abs0:
        raise AssertionError(f"transport-state {where}: x mass drifted {abs(x1 - x0):.4g} "
                             f"(> {ASYNC_MASS_TOL} of {abs0:.4g})")
    if p0 != SIZE or p1 != SIZE:
        raise AssertionError(f"transport-state {where}: p mass {p0!r} -> {p1!r}, not {SIZE}")


def run_transport_state_alone():
    """``python3 chip_smoke.py --phase transport-state``: phase 11h alone on the
    full-width ResNet50 at ``PATH_TRAINER``'s depth (the wire kernels built
    first); its gates as in the whole run, its lines and its launch counts.
    Prints no result line."""
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    _build.build(["wire_kernels"])
    _build.wire_library()
    bft.init(size=SIZE)
    sm, images, labels = build_trainer(device, **PATH_TRAINER)
    counts, _numbers = phase_transport_state(device, sm, images, labels, smi=smi,
                                             trainer_kw=PATH_TRAINER)
    for path in ("transport-state a", "transport-state"):
        missing = [k for k in PATH_KERNELS[path] if counts[path][k] == 0]
        if missing:
            raise AssertionError(f"the {path} path launched no {missing} kernel: {counts[path]}")
    return 0


TT_ROOT = "build/transport_topology"
TT_KILL_STEP = 2  # the session step a case's rank dies at
TT_CKPT = "elastic/int8"  # the case whose checkpoint (c) restores
TT_CKPT_AFTER = 3  # its checkpoint is written after 3 steps (the kill's repaired)


def tt_cases():
    """``name -> spec`` of the transport-topology phase, in the order it
    runs them: ``env`` (the subsystem's switches), the optimizer's ``wire``,
    ``steps`` (ticks for the async case), the ``kill``ed rank (at session
    step ``TT_KILL_STEP``), ``rejoin`` (then one more step) and the
    ``kernels`` each process must launch."""
    fed = {"BLUEFOG_PODS": "2", "BLUEFOG_DCN_PERIOD": "2", "BLUEFOG_DCN_WIRE": "int4"}
    relay = {"BLUEFOG_PLAN_METHOD": "shortcut"}
    b12 = ("encode", "decode_accumulate")
    return {
        "fed/int8": dict(env=fed, wire="int8", steps=4, kernels=b12),
        "relay/fp32": dict(env=relay, wire=None, steps=3, kernels=()),
        "relay/int8": dict(env=relay, wire="int8", steps=3, kernels=b12),
        "elastic/int8": dict(env={}, wire="int8", steps=4, kill=5, rejoin=True, kernels=b12),
        "elastic/int4_ef": dict(env={}, wire="int4_ef", steps=4, kill=5, rejoin=True,
                                kernels=("encode_diff", "decode_add")),
        "elastic/zero2-int8": dict(env={"BLUEFOG_SHARD": "1", "BLUEFOG_SHARD_GRADS": "1"},
                                   wire="int8", steps=4, kill=6, kernels=("encode", "decode")),
        "elastic/async-int8": dict(env={}, wire="int8", steps=4, kill=2,
                                   kernels=("encode", "decode")),
    }


def tt_log(msg):
    """One line in one write: the two processes of part (b) share a pipe."""
    sys.stdout.write(f"[transport-topology] {msg}\n")
    sys.stdout.flush()


def tt_expected_bytes(ctx, name, sm, opt, i, reshard_slot=None):
    """The bytes process ``ctx.process_index`` hands to ``isend`` in step
    ``i`` of case ``name``, read after the step: fed, the intra plan's
    edges from its rows to another process's on int8 (none with a pod a
    process) plus, on a DCN step, the gateway plan's on int4; relay, the
    relay plan's hops from its rows to another process's; elastic, the
    (repaired) plan's crossing edges; zero2, the reduce-scatter's crossing
    rows of a slot on int8 plus the gather of the updated slots (and, at a
    re-shard, the gather of the old layout's two Adam slots); async, the
    window exchange's crossing edges on int8 plus 4 bytes of p each."""
    from bluefog_tpu_torch import federation
    from bluefog_tpu_torch.collective import compiler
    from bluefog_tpu_torch.scaling import wire_payload_bytes

    rows = ctx.rows
    crossing = lambda pairs: sum(1 for s, d in pairs if s in rows and d not in rows)  # noqa
    pairs = lambda perms: [pair for perm in perms for pair in perm]  # noqa
    others = ctx.n_local * (ctx.process_count - 1)
    if name == "fed/int8":
        fab = federation.get_fabric(SIZE)
        out = crossing(pairs(fab.intra.perms)) * wire_payload_bytes(sm.width, 4, "int8")
        if fab.dcn_step(i):
            out += crossing(pairs(fab.inter.perms)) * wire_payload_bytes(sm.width, 4, fab.wire)
        return out
    if name == "elastic/zero2-int8":
        slot = opt._shard_layout.groups[0].slot
        scatter = crossing(pairs(compiler.compile_reduce_scatter(SIZE).perms))
        out = scatter * wire_payload_bytes(slot, 4, "int8") + others * slot * 4
        return out + (others * 2 * reshard_slot * 4 if reshard_slot else 0)
    if name == "elastic/async-int8":
        outs = ctx.out_neighbor_ranks()
        edges = crossing([(s, d) for s in range(SIZE) for d in outs[s]])
        return edges * (wire_payload_bytes(sm.width, 4, "int8") + 4)
    wire = tt_cases()[name]["wire"]
    return crossing(pairs(ctx.static_plan().perms)) * wire_payload_bytes(sm.width, 4, wire)


def tt_record(session):
    """The session's repairs ``(step, dead, live, epoch, policy)``, its
    ``stale_dispatches`` and its live set."""
    return {"repairs": [[r.step, list(r.dead), list(r.live), r.epoch, r.policy]
                        for r in session.repairs],
            "stale": session.stale_dispatches, "live": list(session.membership.live_ranks())}


def tt_run_case(device, sm, images, labels, name, ckpt=None, restore=None):
    """Case ``name`` on the active context from the replicated parameters
    and the phase's batch statistics: its steps (an elastic case under a
    session that kills its rank at step ``TT_KILL_STEP``, then a rejoin and
    one more step where the case says so; the async case's ticks). Returns
    ``(numbers, state)``, ``state`` this process's rows (on the CPU) of the
    final parameters (and the sharded state, the window's value and p).
    With ``ckpt`` the run saves a checkpoint there after ``TT_CKPT_AFTER``
    steps and keeps the parameters of the step after (``state["next"]``);
    with ``restore`` it starts from that checkpoint under a fresh session
    and takes one step."""
    from bluefog_tpu_torch import checkpoint
    from bluefog_tpu_torch.collective import transport
    from bluefog_tpu_torch.optimizers import tree_leaves

    ctx = bft.get_context()
    case = tt_cases()[name]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    times, sent, want, state_out, numbers = [], [], [], {}, {}
    with env_set(case["env"]):
        session = None
        if name == "elastic/async-int8":
            bft.set_topology(topo.RingGraph(SIZE, connect_style=1))
        elif name == "fed/int8":
            bft.set_topology(topo.ExponentialTwoGraph(SIZE), is_weighted=True)
        else:
            bft.set_topology(topo.ExponentialGraph(SIZE))
        if name.startswith("elastic"):
            session = bft.elastic.start(policy="average")
            if restore is None:
                session.inject("kill", rank=case["kill"], step=TT_KILL_STEP)
        grads = torch.empty((ctx.n_local, sm.width), dtype=torch.float32, device=device)
        if name == "elastic/async-int8":
            opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9))
            box = [sm.replicate(), None]
            box[1] = opt.init(box[0])
            tick = bft.make_async_train_step(opt, sm.worker_loss,
                                             cadence={ASYNC_SLOW: ASYNC_FACTOR},
                                             max_age=ASYNC_MAX_AGE, policy="drop", wire="int8",
                                             buffers=sm.buffers)
            eng = tick.engine
            eng_local, local_s = eng._local_step, []

            def timed_local(*args):
                sync(device)
                t0 = time.perf_counter()
                eng_local(*args)
                sync(device)
                local_s.append(time.perf_counter() - t0)

            eng._local_step = timed_local
            workers = torch.arange(ctx.n_local)
            for i in range(case["steps"]):
                sync(device)
                t0 = time.perf_counter()
                before = transport.stats()
                box[0], box[1], _loss = tick(box[0], box[1], images, labels, workers)
                sync(device)
                tick_s = time.perf_counter() - t0
                after = transport.stats()
                sent.append(after["bytes"] - before["bytes"])
                want.append(tt_expected_bytes(ctx, name, sm, opt, i))
                times.append((tick_s, local_s[-1], tick_s - local_s[-1],
                              after["seconds"] - before["seconds"]))
            del eng._local_step
            win = ctx.windows[eng._name]
            numbers["rewindows"] = eng._rewindows
            state_out = {k: v.detach().cpu().clone() for k, v in dict(
                params=box[0], value=win.value, p=win.p).items()}
            eng.free()
            del eng, tick, box, win
        else:
            if name == "elastic/zero2-int8":
                opt = bft.DistributedGradientAllreduceOptimizer(bft.adam(ZERO_LR))
            else:
                opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
            opt.compression = case["wire"]
            box = [sm.replicate(), None]
            box[1] = opt.init(box[0])
            if restore is not None:
                _s, box[0], box[1] = checkpoint.restore(restore, optimizer=opt, extra=sm.buffers)
            step_fn = bft.elastic.guard(opt).step if session is not None else opt.step

            def one(i):
                sync(device)
                t0 = time.perf_counter()
                sm.loss_and_grad(box[0], images, labels, grads)
                sync(device)
                t1 = time.perf_counter()
                before = transport.stats()
                was = opt._shard_reshards, opt._shard_layout
                step_fn(box[0], box[1], grads)
                sync(device)
                t2 = time.perf_counter()
                after = transport.stats()
                sent.append(after["bytes"] - before["bytes"])
                resharded = was[1] is not None and opt._shard_reshards > was[0]
                want.append(tt_expected_bytes(ctx, name, sm, opt, i,
                                              was[1].groups[0].slot if resharded else None))
                times.append((t2 - t0, t1 - t0, t2 - t1, after["seconds"] - before["seconds"]))

            for i in range(1 if restore is not None else case["steps"]):
                one(i)
                if ckpt is not None and i == TT_CKPT_AFTER - 1:
                    checkpoint.save(ckpt, i + 1, box[0], box[1], optimizer=opt,
                                    extra=sm.buffers)
                if ckpt is not None and i == TT_CKPT_AFTER:
                    state_out["next"] = box[0].detach().cpu().clone()
            if case.get("rejoin") and restore is None:
                box[0] = session.rejoin(case["kill"], params=box[0], optimizer=opt)
                one(case["steps"])
            state_out["params"] = box[0].detach().cpu().clone()
            if name == "elastic/zero2-int8":
                numbers["reshards"] = opt._shard_reshards
                state_out.update({f"shard_{i}": t.detach().cpu().clone()
                                  for i, t in enumerate(tree_leaves(box[1]))})
            opt.free()
            del box
        del grads
        if session is not None:
            numbers["record"] = tt_record(session)
            bft.elastic.stop()
    numbers["launches"] = launch_counts()
    for key, v in state_out.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f"transport-topology {name}: non-finite {key}")
    med = [statistics.median(t[c] for t in times) for c in range(4)]
    numbers.update(step_s=med[0], fb_s=med[1], opt_ms=med[2] * 1e3, transport_ms=med[3] * 1e3,
                   transport_s=[t[3] for t in times], bytes_per_step=sent, expected_bytes=want,
                   peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                             if device.type == "cuda" else float("nan")))
    return numbers, state_out


def tt_check_record(where, name, rec, ref=None):
    """An elastic case's record: one repair, at ``TT_KILL_STEP``, no stale
    dispatch, and (across processes) equal to the stacked run's."""
    case = tt_cases()[name]
    if rec["stale"] != 0 or [r[0] for r in rec["repairs"]] != [TT_KILL_STEP]:
        raise AssertionError(f"transport-topology {where} {name}: repairs {rec['repairs']}, "
                             f"stale dispatches {rec['stale']}")
    live = list(range(SIZE)) if case.get("rejoin") else [r for r in range(SIZE)
                                                          if r != case["kill"]]
    if rec["live"] != live:
        raise AssertionError(f"transport-topology {where} {name}: live {rec['live']}")
    if ref is not None and rec != ref:
        raise AssertionError(f"transport-topology {where} {name}: record {rec} differs from "
                             f"the stacked run's {ref}")


def run_transport_topology_child(config_path):
    """``python3 chip_smoke.py --transport-topology-child <config>``: one
    process of part (b) (launched by ``bfrun-torch``): joins the process
    group, builds its rows of the ResNet50 and of the batch, runs the
    cases, holds its rows against part (a)'s, then (c) restores its own
    ``elastic/int8`` checkpoint under a fresh session and takes the next
    step; its numbers go to ``child_<process>.json``."""
    import torch.distributed as dist

    from bluefog_tpu_torch import checkpoint

    with open(config_path) as f:
        cfg = json.load(f)
    device = torch.device(cfg["device"])
    root = cfg["root"]
    ctx = bft.init(size=SIZE, device=device)
    if device.type == "cuda":
        _build.wire_library()
    sm, images, labels = build_trainer(device, rows=ctx.rows, **cfg["trainer"])
    lo, hi = ctx.rows.start, ctx.rows.stop
    stats0 = {k: v[lo:hi].to(device) for k, v in torch.load(
        tp_file(root, "stats0"), map_location="cpu", weights_only=True).items()}
    res = dict(process=ctx.process_index, process_count=ctx.process_count, rows=[lo, hi],
               backend=dist.get_backend(), staged=ctx.staged, cases={})
    tag = (f"(b) process {ctx.process_index}/{ctx.process_count} rows {lo}..{hi - 1} "
           f"({res['backend']}{', staged' if ctx.staged else ''})")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in cfg["cases"]:
            sm.load_buffers(stats0)
            ckpt = os.path.join(root, "ckpt_b") if name == TT_CKPT else None
            row, state = tt_run_case(device, sm, images, labels, name, ckpt=ckpt)
            ref = torch.load(tp_file(root, name), map_location="cpu", weights_only=True)
            row["bitwise"] = {k: bool(torch.equal(bits(v), bits(ref[k][lo:hi])))
                              for k, v in state.items() if k != "next"}
            res["cases"][name] = row
            del ref, state
            tt_log(f"{tag} {name}: step {row['step_s']:.4f} s, optimizer {row['opt_ms']:.1f} "
                   f"ms, transport {row['transport_ms']:.1f} ms a step, "
                   f"{row['bytes_per_step']} B sent (expected {row['expected_bytes']}), peak "
                   f"{row['peak_gib']:.2f} GiB, launches "
                   f"{ {k: v for k, v in row['launches'].items() if v} }, record "
                   f"{row.get('record')}, bitwise (a): {row['bitwise']}")
        if TT_CKPT in cfg["cases"]:
            sm.load_buffers(stats0)
            step = checkpoint.latest_step(os.path.join(root, "ckpt_b"))
            row, state = tt_run_case(device, sm, images, labels, TT_CKPT,
                                     restore=os.path.join(root, "ckpt_b"))
            ref = torch.load(tp_file(root, "next"), map_location="cpu", weights_only=True)
            row["bitwise"] = {"next": bool(torch.equal(bits(state["params"]),
                                                       bits(ref[lo:hi])))}
            res["restored"] = row
            tt_log(f"{tag} (c) {TT_CKPT}: (b)'s checkpoint of step {step} restored under a "
                   f"fresh session (live {row['record']['live']}), one step "
                   f"{row['step_s']:.4f} s, bitwise (a)'s next step: {row['bitwise']['next']}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    with open(os.path.join(root, f"child_{ctx.process_index}.json"), "w") as f:
        json.dump(res, f)
    bft.shutdown()
    return 0


def phase_transport_topology(device, sm, images, labels, root=TT_ROOT, smi="",
                             trainer_kw=None, names=None):
    """Phase 11i: federation, relay plans and elastic sessions across
    processes, on the ResNet50 of the train-step phase
    at ``PATH_TRAINER``'s depth (``bench.py::run_headline``'s settings: 8
    workers, 64 images of 224 x 224 each, the seeds of phase 7), cuDNN
    deterministic, ATC ``sgd(0.1, 0.9)`` unless a case names another
    optimizer (:func:`tt_cases`):
    ``fed/int8`` (``BLUEFOG_PODS=2``, ``BLUEFOG_DCN_PERIOD=2``, the int4
    DCN wire, 4 steps: two DCN steps), ``relay/fp32`` and ``relay/int8``
    (``BLUEFOG_PLAN_METHOD=shortcut`` on the default Exp graph, 3 steps),
    ``elastic/int8`` and ``elastic/int4_ef`` (rank 5 killed at step 2 of 4,
    then ``session.rejoin(5, params=...)`` and one more step),
    ``elastic/zero2-int8`` (``DistributedGradientAllreduceOptimizer(
    adam(1e-4))`` under ``BLUEFOG_SHARD=1 BLUEFOG_SHARD_GRADS=1``, rank 6
    killed at step 2 of 4: the re-shard moves slots between the processes)
    and ``elastic/async-int8`` (phase 10's straggler, 4 ticks, rank 2 killed
    at tick 2: a re-window).

    (a) The stacked reference in this process, each case from the batch
    statistics the phase is given (saved for (b)): each case's final
    parameters (the sharded state, the window's value and p) saved under
    ``build/transport_topology/``; ``elastic/int8`` writes a checkpoint
    after 3 steps and keeps its next step's parameters. Its elastic records
    are gated as (b)'s are.

    (b) Two processes sharing the card, started by ``bfrun-torch -np 8 -H
    localhost:4,localhost:4``, gloo with the rows staged through pinned
    host memory, each under ``TP_TIMEOUT``. Gates: every saved row bitwise
    rows ``4p .. 4p + 3`` of (a); each elastic case repairs once, at step
    2, with no stale dispatch, and its record (repairs, live set) equals
    (a)'s; the bytes handed to ``isend`` in every step equal
    :func:`tt_expected_bytes`; each process launches the case's kernels
    (B1 + B2 on fed/int8, relay/int8 and elastic/int8; B3 + B4 on
    elastic/int4_ef; B1 + B5 on zero2 and async). A line a case.

    (c) (b)'s ``elastic/int8`` processes wrote a checkpoint after the kill
    (its sidecar lists the live set without rank 5): restored in both
    processes under a fresh session (which adopts the saved live set) and
    in this one, the next step is bitwise (a)'s.

    Files under ``build/transport_topology/``, deleted. Returns
    ``({"transport-topology a":, "transport-topology":}, numbers)``."""
    import shutil

    from bluefog_tpu_torch import checkpoint

    names = list(tt_cases()) if names is None else list(names)
    trainer_kw = {} if trainer_kw is None else dict(trainer_kw)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    root = os.path.abspath(root)
    t_phase = time.perf_counter()
    zero = {k: 0 for k in launch_counts()}
    counts = {"transport-topology a": dict(zero), "transport-topology": dict(zero)}
    ctx = bft.init(size=SIZE, device=device)
    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    torch.save({k: v.cpu() for k, v in stats0.items()}, tp_file(root, "stats0"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    numbers = {"a": {}}
    try:
        for name in names:
            sm.load_buffers(stats0)
            ckpt = os.path.join(root, "ckpt_a") if name == TT_CKPT else None
            row, state = tt_run_case(device, sm, images, labels, name, ckpt=ckpt)
            if "next" in state:
                torch.save(state.pop("next"), tp_file(root, "next"))
            torch.save(state, tp_file(root, name))
            del state
            numbers["a"][name] = row
            if "record" in row:
                tt_check_record("(a)", name, row["record"])
            for k, v in row["launches"].items():
                counts["transport-topology a"][k] += v
            log("transport-topology", f"(a) stacked, one process, 8 workers: {name}: step "
                                      f"{row['step_s']:.4f} s, optimizer {row['opt_ms']:.1f} "
                                      f"ms, peak {row['peak_gib']:.2f} GiB, launches "
                                      f"{ {k: v for k, v in row['launches'].items() if v} }, "
                                      f"record {row.get('record')}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    sm.load_buffers(stats0)
    a_s = time.perf_counter() - t_phase
    bft.init(size=SIZE, device=device)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "chip_smoke.py")
    t0 = time.perf_counter()
    cfg = os.path.join(root, "config_b.json")
    with open(cfg, "w") as f:
        json.dump(dict(root=root, device=device.type, cases=names, trainer=trainer_kw), f)
    tp_spawn([sys.executable, "-m", "bluefog_tpu_torch.run.run", "-np", str(SIZE), "-H", TP_HOSTS,
              "--coordinator", f"127.0.0.1:{tp_free_port()}", "--num-processes", "2",
              script, "--transport-topology-child", cfg], tp_child_env())
    b_s = time.perf_counter() - t0
    numbers["b"] = []
    for p in range(2):
        with open(os.path.join(root, f"child_{p}.json")) as f:
            res = json.load(f)
        numbers["b"].append(res)
        if (res["process_count"], res["rows"], res["backend"]) != (2, [4 * p, 4 * p + 4], "gloo"):
            raise AssertionError(f"transport-topology (b) process {p}: {res['process_count']} "
                                 f"processes, rows {res['rows']}, backend {res['backend']}")
        if res["staged"] != (device.type == "cuda"):
            raise AssertionError(f"transport-topology (b) process {p}: staged {res['staged']}")
        for name in names:
            row = res["cases"][name]
            wrong = [k for k, same in row["bitwise"].items() if not same]
            if wrong:
                raise AssertionError(f"transport-topology (b) process {p} {name}: rows "
                                     f"{4 * p}..{4 * p + 3} of {wrong} differ from (a)")
            if row["bytes_per_step"] != row["expected_bytes"]:
                raise AssertionError(f"transport-topology (b) process {p} {name}: sent "
                                     f"{row['bytes_per_step']} B a step, expected "
                                     f"{row['expected_bytes']}")
            if "record" in row:
                tt_check_record(f"(b) process {p}", name, row["record"],
                                numbers["a"][name]["record"])
            if device.type == "cuda":
                missing = [k for k in tt_cases()[name]["kernels"] if row["launches"][k] == 0]
                if missing:
                    raise AssertionError(f"transport-topology (b) process {p} {name} launched "
                                         f"no {missing}: {row['launches']}")
            for k, v in row["launches"].items():
                counts["transport-topology"][k] += v
        if TT_CKPT in names:
            if not res["restored"]["bitwise"]["next"]:
                raise AssertionError(f"transport-topology (c) process {p}: the step after "
                                     "restoring (b)'s checkpoint differs from (a)'s next step")
            for k, v in res["restored"]["launches"].items():
                counts["transport-topology"][k] += v

    numbers["c"] = None
    if TT_CKPT in names:
        t0 = time.perf_counter()
        step = checkpoint.latest_step(os.path.join(root, "ckpt_b"))
        with open(os.path.join(root, "ckpt_b", f"{step}.graph.json")) as f:
            live = json.load(f)["graph_info"]["live_ranks"]
        kill = tt_cases()[TT_CKPT]["kill"]
        if live != [r for r in range(SIZE) if r != kill]:
            raise AssertionError(f"transport-topology (c): (b)'s checkpoint records live {live}")
        bft.init(size=SIZE, device=device)
        sm.load_buffers(stats0)
        torch.backends.cudnn.deterministic = True
        try:
            row, state = tt_run_case(device, sm, images, labels, TT_CKPT,
                                     restore=os.path.join(root, "ckpt_b"))
        finally:
            torch.backends.cudnn.deterministic = deterministic
        ref = torch.load(tp_file(root, "next"), map_location="cpu", weights_only=True)
        if not torch.equal(bits(state["params"]), bits(ref)):
            raise AssertionError("transport-topology (c): (b)'s checkpoint restored in one "
                                 "process steps off (a)'s next step")
        del ref, state
        for k, v in row["launches"].items():
            counts["transport-topology a"][k] += v
        numbers["c"] = {"step": step, "live": live, "s": time.perf_counter() - t0}
        log("transport-topology", f"(c) {TT_CKPT}: (b)'s checkpoint of step {step} (live "
                                  f"{live}) restored in both processes and in this one under a "
                                  f"fresh session, the next step bitwise (a)'s")
        sm.load_buffers(stats0)
        bft.init(size=SIZE, device=device)
    shutil.rmtree(root, ignore_errors=True)
    for name in names:
        per = [r["cases"][name] for r in numbers["b"]]
        a = numbers["a"][name]
        how = ("sharing the card, gloo staged through pinned host memory"
               if numbers["b"][0]["staged"] else "on the CPU, gloo")
        gbps = [sum(r["bytes_per_step"]) / sum(r["transport_s"]) / 1e9 if sum(r["transport_s"])
                else 0.0 for r in per]
        log("transport-topology", f"(b) {name}: two processes x 4 workers {how}: step "
                                  f"{max(r['step_s'] for r in per):.4f} s (stacked "
                                  f"{a['step_s']:.4f}), optimizer "
                                  f"{max(r['opt_ms'] for r in per):.1f} ms (stacked "
                                  f"{a['opt_ms']:.1f}), transport "
                                  f"{max(r['transport_ms'] for r in per):.1f} ms a step "
                                  f"({min(gbps):.3f} GB/s over the steps), bytes a step "
                                  f"{per[0]['bytes_per_step']} / {per[1]['bytes_per_step']}, "
                                  f"peak {max(r['peak_gib'] for r in per):.2f} GiB (stacked "
                                  f"{a['peak_gib']:.2f}); rows bitwise (a); on {smi}")
    log("transport-topology", f"launches {counts}; (a) {a_s:.1f} s, (b) {b_s:.1f} s of "
                              f"processes; phase {time.perf_counter() - t_phase:.1f} s")
    return counts, numbers


def run_transport_topology_alone():
    """``python3 chip_smoke.py --phase transport-topology``: phase 11i alone on
    the full-width ResNet50 at ``PATH_TRAINER``'s depth (the wire kernels
    built first); its gates as in the whole run, its lines and its launch
    counts. Prints no result line."""
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    _build.build(["wire_kernels"])
    _build.wire_library()
    bft.init(size=SIZE)
    sm, images, labels = build_trainer(device, **PATH_TRAINER)
    counts, _numbers = phase_transport_topology(device, sm, images, labels, smi=smi,
                                                trainer_kw=PATH_TRAINER)
    for path in ("transport-topology a", "transport-topology"):
        missing = [k for k in PATH_KERNELS[path] if counts[path][k] == 0]
        if missing:
            raise AssertionError(f"the {path} path launched no {missing} kernel: {counts[path]}")
    return 0


TF_ROOT = "build/transport_fleet"
# the six samplers of the samplers case, each at interval 1
TF_SAMPLERS = {"BLUEFOG_METRICS": "1", "BLUEFOG_METRICS_INTERVAL": "1",
               "BLUEFOG_DOCTOR": "1", "BLUEFOG_DOCTOR_INTERVAL": "1",
               "BLUEFOG_STALENESS": "1", "BLUEFOG_STALENESS_INTERVAL": "1",
               "BLUEFOG_MEMORY": "1", "BLUEFOG_MEMORY_INTERVAL": "1",
               "BLUEFOG_HEALTH": "1", "BLUEFOG_HEALTH_INTERVAL": "1",
               "BLUEFOG_SLO": "1", "BLUEFOG_SLO_INTERVAL": "1"}
# the doctor's model without a fault: no probe round can pass 3 x 1 s, so
# no degraded_link can fire in one run and not in another
TF_QUIET_PIN = (1.0, 1e12, 0.0)
TF_DEGRADE = (3, 4, 0.05)  # the damaged Exp(8) edge, from process 0's rows to process 1's
TF_OOM = (5, 2)  # the oom fault's rank (a row of process 1) and step
TF_STEPS = 3  # 1 warm-up and 2 timed steps (ticks) a case
# the lane's fields that are a process's own across processes: the step
# time is a wall clock, the memory fields the allocator's
TF_OWN_FIELDS = ("step_ms", "mem_bytes_per_rank", "mem_headroom")
# the SLO objectives that read those
TF_OWN_OBJECTIVES = ("step_time", "mass_residual", "memory_headroom")
TF_HOOKS = (("attribution", "observe_step"), ("health", "observe_step"),
            ("staleness", "observe_step"), ("staleness", "observe_window"),
            ("autotune", "observe_step"), ("memory", "observe_step"), ("slo", "observe_step"))


def tf_cases():
    """``name -> spec`` of the transport-fleet phase, in the order it runs
    them: ``env`` (the samplers' switches, set before ``bft.init``), the
    ``wire``, the doctor's ``pin``, an elastic ``degrade`` or ``oom``
    fault, ``serve`` (the health plane's endpoint) and the ``kernels`` each
    process must launch."""
    doc = {"BLUEFOG_DOCTOR": "1", "BLUEFOG_DOCTOR_INTERVAL": "1",
           "BLUEFOG_AUTOTUNE": "1", "BLUEFOG_AUTOTUNE_INTERVAL": "1"}
    stal_mem = {"BLUEFOG_STALENESS": "1", "BLUEFOG_STALENESS_INTERVAL": "1",
                "BLUEFOG_MEMORY": "1", "BLUEFOG_MEMORY_INTERVAL": "1"}
    stal_health = {"BLUEFOG_STALENESS": "1", "BLUEFOG_STALENESS_INTERVAL": "1",
                   "BLUEFOG_HEALTH": "1", "BLUEFOG_HEALTH_INTERVAL": "1"}
    return {
        "samplers/int8": dict(env=TF_SAMPLERS, wire="int8", pin=TF_QUIET_PIN, serve=True,
                              kernels=("encode", "decode_accumulate", "decode")),
        "doctor-autotune/int8": dict(env=doc, wire="int8", pin=AT_DOCTOR_PIN,
                                     degrade=TF_DEGRADE,
                                     kernels=("encode", "decode_accumulate")),
        "oom/int4_ef": dict(env=stal_mem, wire="int4_ef", oom=TF_OOM,
                            kernels=("encode_diff", "decode_add")),
        "async/int8": dict(env=stal_health, wire="int8", kernels=("encode", "decode")),
    }


def tf_log(msg):
    """One line in one write: the two processes of part (b) share a pipe."""
    sys.stdout.write(f"[transport-fleet] {msg}\n")
    sys.stdout.flush()


class tf_hook_timer:
    """Seconds spent in the samplers' hooks (the module functions the
    optimizers and the async engine call after a dispatch), wrapped for a
    ``with`` block and restored after it."""

    def __init__(self):
        import importlib

        self.seconds = 0.0
        self.calls = 0
        self._saved = []
        for mod_name, fn_name in TF_HOOKS:
            mod = importlib.import_module(f"bluefog_tpu_torch.{mod_name}")
            self._saved.append((mod, fn_name, getattr(mod, fn_name)))

    def __enter__(self):
        for mod, fn_name, fn in self._saved:
            def timed(*args, _fn=fn, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    self.seconds += time.perf_counter() - t0
            setattr(mod, fn_name, timed)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, fn in self._saved:
            setattr(mod, fn_name, fn)
        self._saved = []
        return False


def tf_view(ctx):
    """The samplers' outputs after a case, as plain values (JSON)."""
    from bluefog_tpu_torch import attribution, autotune, health, memory, slo, staleness

    metrics.flush()  # the pending probe payload, folded
    gauges = {}
    for name in ("disagreement", "param_norm", "grad_norm", "quant_err", "ef_residual"):
        for series in (f"bluefog.gossip.{name}", f"bluefog.gossip.{name}.max"):
            g = metrics.peek(series)
            gauges[series] = None if g is None else g.value
    view = {"gauges": gauges, "worker_rows": {
        k: [float(v) for v in vals] for k, vals in metrics.last_worker_rows().items()}}
    doc = attribution.active()
    view["doctor"] = None if doc is None else {
        "advisories": [[a.kind, a.step, a.detail.get("edge")] for a in doc.advisories],
        "rounds": [[r["edges"] for r in s.get("rounds", [])] for s in doc.samples]}
    obs = staleness.active()
    view["staleness"] = None if obs is None else {
        "samples": list(obs.samples), "advisories": [a.to_json() for a in obs.advisories]}
    mem = memory.active()
    view["memory"] = None if mem is None or mem.last_census is None else {
        "census": {c: r["bytes"] for c, r in mem.last_census.items()},
        "ranked": [[r["category"], r["bytes"]] for r in memory.ranked_census()]}
    plane = health.active()
    fleet = (plane.fleet or {}) if plane is not None else {}
    view["health"] = None if plane is None else {
        "fleet": {k: fleet.get(k) for k in ("mean", "min", "max", "residual", "live")},
        "samples": [{k: s.get(k) for k in ("step", "comm_steps", "consensus", "predicted_rate",
                                             "measured_rate", "mixing_efficiency")}
                    for s in plane.samples],
        "advisories": [a.to_json() for a in plane.advisories],
        "healthz": {k: v for k, v in health.healthz_verdict(plane).items() if k != "ts"},
        "async": plane.report().get("async")}
    eng = slo.active()
    view["slo"] = None if eng is None else {
        "rows": [{"step": r["step"], "canary": r.get("canary"),
                  "flags": {n: o["ok"] for n, o in r["objectives"].items()},
                  "values": {n: o["value"] for n, o in r["objectives"].items()
                             if n not in TF_OWN_OBJECTIVES}} for r in eng.samples],
        "alerts": [a.to_json() for a in eng.alerts]}
    tuner = autotune.active()
    view["autotune"] = None if tuner is None else [
        [d.action, d.step, d.chosen, [list(e) for e in d.blamed]] for d in tuner.decisions]
    return view


def tf_fleet_part(view):
    """The parts of a view that every process and the stacked run share:
    the lane's fields but the process's own (the step time, the allocator's
    memory fields) and its residual, the census but the allocator's
    ``other``, and the staleness samples but a window's name (its uid
    counts the windows this process made before)."""
    from bluefog_tpu_torch import health

    out = {k: v for k, v in view.items() if k not in ("health", "memory", "staleness")}
    if view.get("staleness") is not None:
        out["staleness"] = dict(view["staleness"], samples=[
            {k: v for k, v in s.items() if k != "window"} for s in view["staleness"]["samples"]])
    if view.get("memory") is not None:
        out["memory"] = {"census": {c: b for c, b in view["memory"]["census"].items()
                                    if c != "other"},
                         "ranked": [r for r in view["memory"]["ranked"] if r[0] != "other"]}
    if view.get("health") is not None:
        keep = [i for i, f in enumerate(health.FLEET_FIELDS) if f not in TF_OWN_FIELDS]
        fleet = view["health"]["fleet"]
        out["health"] = dict(view["health"], fleet={
            k: (None if fleet[k] is None else [fleet[k][i] for i in keep])
            for k in ("mean", "min", "max")})
        out["health"]["fleet"]["live"] = fleet["live"]
    return out


def tf_run_case(device, sm, images, labels, name, port=0):
    """Case ``name`` (:func:`tf_cases`) on a fresh context whose samplers
    its ``env`` switches on: ``TF_STEPS`` two-program steps (ticks for the
    async case) from the replicated parameters and the phase's batch
    statistics, under an elastic session where the case has a fault. The
    doctor-autotune case first runs one unpinned ``compiler.calibrate()``
    and times a healthy crossing edge (0 -> 4) against its prediction.
    Returns ``(numbers, state, view)``: ``state`` this process's rows (on
    the CPU) of the final parameters (and the window's p), ``view``
    :func:`tf_view` with the matrix installed after every step."""
    from bluefog_tpu_torch import attribution, health, memory
    from bluefog_tpu_torch.collective import compiler, transport

    case = tf_cases()[name]
    env = dict(case["env"], BLUEFOG_HEALTH_PORT=str(port) if case.get("serve") else "0")
    numbers, state = {}, {}
    with env_set({**OBSV_OFF, **AT_OFF, **env}):
        ctx = bft.init(size=SIZE, device=device)
        # the gauges of earlier phases must not reach a first sample
        metrics.reset()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        if name == "async/int8":
            bft.set_topology(topo.RingGraph(SIZE, connect_style=1))
        else:
            bft.set_topology(topo.ExponentialGraph(SIZE))
        if "degrade" in case:
            compiler.clear_calibration(compiler.TRANSPORT_LINK_CLASS)
            cal = compiler.calibrate()
            elems = attribution.probe_elems_cap()
            doc = attribution.StepDoctor()
            edge_s = transport.fleet_max([doc._time_probe(
                ctx, ((0, 4),), elems, doc._readback_s(ctx, elems))], ctx)[0]
            numbers["calibration"] = {
                "alpha_us": cal["alpha_s"] * 1e6, "beta_gbps": cal["beta_bytes_per_s"] / 1e9,
                "pipeline_eff": cal["pipeline_eff"], "edge_ms": edge_s * 1e3,
                "edge_predicted_ms": compiler.round_cost_s(
                    elems * 4.0, link_class=compiler.TRANSPORT_LINK_CLASS) * 1e3,
                "processes": cal.get("probe_processes", 1)}
            del doc
        if case.get("pin"):
            compiler.set_calibration(*case["pin"], source="chip_smoke",
                                     link_class=compiler.TRANSPORT_LINK_CLASS)
        session = None
        if "degrade" in case or "oom" in case:
            session = bft.elastic.start(policy="average")
            if "degrade" in case:
                r, peer, factor = case["degrade"]
                session.inject("degrade", rank=r, step=0, factor=factor, peer=peer)
            else:
                session.inject("oom", rank=case["oom"][0], step=case["oom"][1])
        matrices, times, raised = [], [], []
        hooks = tf_hook_timer()
        with hooks:
            if name == "async/int8":
                opt = bft.DistributedNeighborAllreduceOptimizer(bft.sgd(0.1, momentum=0.9))
                box = [sm.replicate(), None]
                box[1] = opt.init(box[0])
                tick = bft.make_async_train_step(opt, sm.worker_loss,
                                                 cadence={ASYNC_SLOW: ASYNC_FACTOR},
                                                 max_age=ASYNC_MAX_AGE, policy="drop",
                                                 wire=case["wire"], buffers=sm.buffers)
                workers = torch.arange(ctx.n_local)
                for _i in range(TF_STEPS):
                    sync(device)
                    h0, b0 = hooks.seconds, transport.stats()["seconds"]
                    t0 = time.perf_counter()
                    box[0], box[1], _loss = tick(box[0], box[1], images, labels, workers)
                    sync(device)
                    times.append((time.perf_counter() - t0, 0.0,
                                  transport.stats()["seconds"] - b0, hooks.seconds - h0))
                    matrices.append(np.asarray(ctx.load_topology()).tolist())
                state["p"] = ctx.windows[tick.engine._name].p.detach().cpu().clone()
                state["params"] = box[0].detach().cpu().clone()
                tick.engine.free()
                del tick
            else:
                opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
                opt.compression = case["wire"]
                box = [sm.replicate(), None]
                box[1] = opt.init(box[0])
                step_fn = bft.elastic.guard(opt).step if session is not None else opt.step
                grads = torch.empty((ctx.n_local, sm.width), dtype=torch.float32, device=device)
                for i in range(TF_STEPS):
                    sync(device)
                    t0 = time.perf_counter()
                    sm.loss_and_grad(box[0], images, labels, grads)
                    sync(device)
                    t1 = time.perf_counter()
                    h0, b0 = hooks.seconds, transport.stats()["seconds"]
                    try:
                        step_fn(box[0], box[1], grads)
                    except memory.SimulatedResourceExhausted as e:
                        # the forensics ran in every process; the fault is
                        # consumed, so the step runs again
                        raised.append([i, str(e)])
                        numbers["forensics"] = {
                            "ranked": [[r["category"], r["bytes"]]
                                       for r in memory.ranked_census()],
                            "events": memory.active().oom_events}
                        step_fn(box[0], box[1], grads)
                    sync(device)
                    t2 = time.perf_counter()
                    times.append((t2 - t0, (t2 - t1) * 1e3, transport.stats()["seconds"] - b0,
                                  hooks.seconds - h0))
                    matrices.append(np.asarray(ctx.load_topology()).tolist())
                state["params"] = box[0].detach().cpu().clone()
                del grads
                opt.free()
            del box
        view = tf_view(ctx)
        view["matrices"] = matrices
        if session is not None:
            view["stale"] = session.stale_dispatches
            bft.elastic.stop()
        view["raised"] = raised
        if case.get("serve"):
            srv = health.server()
            numbers["served"] = srv is not None
            if srv is not None:
                status, body = hr_get(f"http://127.0.0.1:{port}/healthz")
                verdict = json.loads(body)
                numbers["healthz"] = [status, {k: v for k, v in verdict.items() if k != "ts"}]
        compiler.clear_calibration(compiler.TRANSPORT_LINK_CLASS)
        numbers["launches"] = launch_counts()
        bft.shutdown()
    for key, v in state.items():
        if not torch.isfinite(v.float()).all():
            raise AssertionError(f"transport-fleet {name}: non-finite {key}")
    timed = times[1:]
    numbers.update(step_s=statistics.median(t[0] for t in timed),
                   opt_ms=statistics.median(t[1] for t in timed),
                   transport_ms=statistics.median(t[2] for t in timed) * 1e3,
                   sampler_ms=statistics.median(t[3] for t in timed) * 1e3,
                   peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                             if device.type == "cuda" else float("nan")))
    return numbers, state, view


def tf_check_case(where, name, view, numbers):
    """The gates a case's run must pass on its own, stacked or not."""
    from bluefog_tpu_torch import attribution

    if name == "doctor-autotune/int8":
        edges = {tuple(e) for kind, _s, e in view["doctor"]["advisories"]
                 if kind == "degraded_link"}
        swaps = [d for d in view["autotune"] if d[0] == "swap"]
        if edges != {TF_DEGRADE[:2]} or len(swaps) != 1 or view["stale"] != 0:
            raise AssertionError(f"transport-fleet {where} {name}: degraded_link on {edges}, "
                                 f"decisions {view['autotune']}, stale {view['stale']}")
        cal = numbers["calibration"]
        # across processes the doctor prices a probe with the route's own
        # calibration: a healthy crossing edge must stay under its ratio
        if not cal["alpha_us"] > 0 or not cal["beta_gbps"] > 0 or (
                cal["processes"] > 1
                and cal["edge_ms"] >= attribution.DEGRADE_RATIO * cal["edge_predicted_ms"]):
            raise AssertionError(f"transport-fleet {where} {name}: route calibration {cal}: a "
                                 "healthy crossing edge passes the doctor's degrade ratio")
    if name == "oom/int4_ef":
        if [r[0] for r in view["raised"]] != [TF_OOM[1]] or numbers["forensics"]["events"] != 1:
            raise AssertionError(f"transport-fleet {where} {name}: raised {view['raised']}, "
                                 f"forensics {numbers.get('forensics')}")
    if name == "samplers/int8":
        canaries = [r["canary"] for r in view["slo"]["rows"]]
        if len(canaries) != TF_STEPS or not all(c is not None and c["ok"] for c in canaries):
            raise AssertionError(f"transport-fleet {where} {name}: canary verdicts {canaries}")
        if view["doctor"]["advisories"] or len(view["staleness"]["samples"]) != TF_STEPS:
            raise AssertionError(f"transport-fleet {where} {name}: doctor "
                                 f"{view['doctor']['advisories']}, staleness samples "
                                 f"{len(view['staleness']['samples'])}")
    if name == "async/int8":
        surfaces = {s["surface"] for s in view["staleness"]["samples"]}
        if surfaces != {"async"}:
            raise AssertionError(f"transport-fleet {where} {name}: surfaces {surfaces}")


def tf_roundtrip(obj):
    """``obj`` as JSON gives it back (tuples as lists), so a view compares
    equal to one read from a file."""
    return json.loads(json.dumps(obj))


def run_transport_fleet_child(config_path):
    """``python3 chip_smoke.py --transport-fleet-child <config>``: one
    process of part (b) (launched by ``bfrun-torch``): builds its rows of
    the ResNet50 and of the batch, runs the cases, holds its rows against
    part (a)'s and writes its numbers and views to ``child_<process>.json``."""
    import torch.distributed as dist

    from bluefog_tpu_torch import health

    with open(config_path) as f:
        cfg = json.load(f)
    device = torch.device(cfg["device"])
    root = cfg["root"]
    ctx = bft.init(size=SIZE, device=device)
    if device.type == "cuda":
        _build.wire_library()
    health.DEFAULT_HOST = "127.0.0.1"
    sm, images, labels = build_trainer(device, rows=ctx.rows, **cfg["trainer"])
    lo, hi = ctx.rows.start, ctx.rows.stop
    stats0 = {k: v[lo:hi].to(device) for k, v in torch.load(
        tp_file(root, "stats0"), map_location="cpu", weights_only=True).items()}
    res = dict(process=ctx.process_index, process_count=ctx.process_count, rows=[lo, hi],
               backend=dist.get_backend(), staged=ctx.staged, cases={})
    tag = (f"(b) process {ctx.process_index}/{ctx.process_count} rows {lo}..{hi - 1} "
           f"({res['backend']}{', staged' if ctx.staged else ''})")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in cfg["cases"]:
            sm.load_buffers(stats0)
            row, state, view = tf_run_case(device, sm, images, labels, name, port=cfg["port"])
            ref = torch.load(tp_file(root, name), map_location="cpu", weights_only=True)
            row["bitwise"] = {k: bool(torch.equal(bits(v), bits(ref[k][lo:hi])))
                              for k, v in state.items()}
            row["view"] = tf_roundtrip(view)
            res["cases"][name] = row
            del ref, state
            tf_log(f"{tag} {name}: step {row['step_s']:.4f} s, optimizer {row['opt_ms']:.1f} "
                   f"ms, transport {row['transport_ms']:.1f} ms, samplers "
                   f"{row['sampler_ms']:.1f} ms a step, peak {row['peak_gib']:.2f} GiB, "
                   f"launches { {k: v for k, v in row['launches'].items() if v} }, bitwise "
                   f"(a): {row['bitwise']}")
        bft.init(size=SIZE, device=device)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    with open(os.path.join(root, f"child_{ctx.process_index}.json"), "w") as f:
        json.dump(res, f)
    bft.shutdown()
    return 0


def phase_transport_fleet(device, sm, images, labels, root=TF_ROOT, smi="", trainer_kw=None,
                          names=None):
    """Phase 11j: the fleet samplers across processes, on the ResNet50 of
    the train-step phase at ``PATH_TRAINER``'s depth (8 workers, 64 images
    of 224 x 224 each, the seeds of phase 7, the default Exp graph), cuDNN
    deterministic, ATC ``sgd(0.1, 0.9)`` (the async case: phase 10's
    straggler), 1 warm-up and
    2 timed steps a case (:func:`tf_cases`): ``samplers/int8`` (the
    metrics probe, the doctor on a quiet pin, the staleness lane, the
    memory observatory, the health plane serving ``/healthz`` and the SLO
    engine with its canary, each at interval 1), ``doctor-autotune/int8``
    (an elastic ``degrade`` of the crossing edge 3 -> 4 at 0.05, the doctor
    on ``AT_DOCTOR_PIN`` and the controller at interval 1, after one
    unpinned route calibration), ``oom/int4_ef`` (staleness and memory, an
    ``oom`` fault on rank 5 at step 2) and ``async/int8`` (staleness on the
    ``async`` surface and health).

    (a) Every case stacked in this process: its rows saved under
    ``build/transport_fleet/``, its samplers' outputs kept. (b) All cases
    in one launch of two processes of four workers sharing the card
    (``bfrun-torch -np 8 -H localhost:4,localhost:4``, gloo staged), each
    under ``TP_TIMEOUT``. Gates in every process: every row bitwise (a)'s;
    the samplers' outputs (:func:`tf_view`) equal the other process's, and
    (a)'s but for a process's own readings (:func:`tf_fleet_part`): the
    metrics gauges and worker rows, the staleness samples, the census's
    byte counts, the lane's fields, the canary's verdicts and the installed
    matrices bitwise, the advisories and the decision records equal; in
    doctor-autotune ``degraded_link`` on exactly [3, 4], one swap at (a)'s
    step, no stale dispatch, and a healthy crossing edge under
    ``DEGRADE_RATIO`` of the route calibration's prediction; the oom
    forensics at step 2 with (a)'s ranked census; the ``/healthz`` of the
    process that serves it, scraped, with (a)'s fields; each case's
    kernels launched in each process. A line a case with step, optimizer,
    transport and sampler ms and peak GiB.

    Returns ``({"transport-fleet a":, "transport-fleet":}, numbers)``."""
    import shutil

    from bluefog_tpu_torch import health

    names = list(tf_cases()) if names is None else list(names)
    trainer_kw = {} if trainer_kw is None else dict(trainer_kw)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    root = os.path.abspath(root)
    t_phase = time.perf_counter()
    zero = {k: 0 for k in launch_counts()}
    counts = {"transport-fleet a": dict(zero), "transport-fleet": dict(zero)}
    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    torch.save({k: v.cpu() for k, v in stats0.items()}, tp_file(root, "stats0"))
    host = health.DEFAULT_HOST
    health.DEFAULT_HOST = "127.0.0.1"
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    numbers = {"a": {}}
    try:
        for name in names:
            sm.load_buffers(stats0)
            row, state, view = tf_run_case(device, sm, images, labels, name,
                                           port=tp_free_port())
            torch.save(state, tp_file(root, name))
            del state
            row["view"] = tf_roundtrip(view)
            tf_check_case("(a)", name, row["view"], row)
            numbers["a"][name] = row
            for k, v in row["launches"].items():
                counts["transport-fleet a"][k] += v
            log("transport-fleet", f"(a) stacked, one process, 8 workers: {name}: step "
                                   f"{row['step_s']:.4f} s, optimizer {row['opt_ms']:.1f} ms, "
                                   f"samplers {row['sampler_ms']:.1f} ms a step, peak "
                                   f"{row['peak_gib']:.2f} GiB, launches "
                                   f"{ {k: v for k, v in row['launches'].items() if v} }"
                                   + (f", route calibration {row['calibration']}"
                                      if "calibration" in row else ""))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        health.DEFAULT_HOST = host
    sm.load_buffers(stats0)
    a_s = time.perf_counter() - t_phase
    bft.init(size=SIZE, device=device)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "chip_smoke.py")
    t0 = time.perf_counter()
    cfg = os.path.join(root, "config_b.json")
    with open(cfg, "w") as f:
        json.dump(dict(root=root, device=device.type, cases=names, trainer=trainer_kw,
                       port=tp_free_port()), f)
    tp_spawn([sys.executable, "-m", "bluefog_tpu_torch.run.run", "-np", str(SIZE), "-H", TP_HOSTS,
              "--coordinator", f"127.0.0.1:{tp_free_port()}", "--num-processes", "2",
              script, "--transport-fleet-child", cfg], tp_child_env())
    b_s = time.perf_counter() - t0
    numbers["b"] = []
    for p in range(2):
        with open(os.path.join(root, f"child_{p}.json")) as f:
            numbers["b"].append(json.load(f))
    for p, res in enumerate(numbers["b"]):
        if (res["process_count"], res["rows"], res["backend"]) != (2, [4 * p, 4 * p + 4], "gloo"):
            raise AssertionError(f"transport-fleet (b) process {p}: {res['process_count']} "
                                 f"processes, rows {res['rows']}, backend {res['backend']}")
        if res["staged"] != (device.type == "cuda"):
            raise AssertionError(f"transport-fleet (b) process {p}: staged {res['staged']}")
        other = numbers["b"][1 - p]
        for name in names:
            row, a = res["cases"][name], numbers["a"][name]
            wrong = [k for k, same in row["bitwise"].items() if not same]
            if wrong:
                raise AssertionError(f"transport-fleet (b) process {p} {name}: rows "
                                     f"{4 * p}..{4 * p + 3} of {wrong} differ from (a)")
            tf_check_case(f"(b) process {p}", name, row["view"], row)
            if row["view"] != other["cases"][name]["view"]:
                diff = [k for k in row["view"] if row["view"][k] != other["cases"][name]["view"][k]]
                raise AssertionError(f"transport-fleet (b) process {p} {name}: the samplers' "
                                     f"{diff} differ from the other process's")
            mine, want = tf_fleet_part(row["view"]), tf_fleet_part(a["view"])
            if mine != want:
                diff = [k for k in mine if mine[k] != want.get(k)]
                raise AssertionError(f"transport-fleet (b) process {p} {name}: the samplers' "
                                     f"{diff} differ from (a)'s: {[mine[k] for k in diff]} "
                                     f"against {[want.get(k) for k in diff]}")
            if name == "oom/int4_ef":
                strip = lambda ranked: [r for r in ranked if r[0] != "other"]  # noqa: E731
                if strip(row["forensics"]["ranked"]) != strip(a["forensics"]["ranked"]) or \
                        row["forensics"] != other["cases"][name]["forensics"]:
                    raise AssertionError(f"transport-fleet (b) process {p} {name}: forensics "
                                         f"{row['forensics']} against (a)'s {a['forensics']}")
            if device.type == "cuda":
                missing = [k for k in tf_cases()[name]["kernels"] if row["launches"][k] == 0]
                if missing:
                    raise AssertionError(f"transport-fleet (b) process {p} {name} launched "
                                         f"no {missing}: {row['launches']}")
            for k, v in row["launches"].items():
                counts["transport-fleet"][k] += v
    for name in names:
        if not tf_cases()[name].get("serve"):
            continue
        served = [res["cases"][name] for res in numbers["b"] if res["cases"][name]["served"]]
        want = numbers["a"][name]["healthz"]
        if len(served) != 1 or served[0]["healthz"] != want or want[0] != 200:
            raise AssertionError(f"transport-fleet (b) {name}: {len(served)} processes serve "
                                 f"/healthz, scraped {[s.get('healthz') for s in served]}, "
                                 f"(a) {want}")
    shutil.rmtree(root, ignore_errors=True)
    for name in names:
        per = [r["cases"][name] for r in numbers["b"]]
        a = numbers["a"][name]
        how = ("sharing the card, gloo staged through pinned host memory"
               if numbers["b"][0]["staged"] else "on the CPU, gloo")
        extra = (f", route calibration {[r['calibration'] for r in per][0]}"
                 if "calibration" in per[0] else "")
        log("transport-fleet", f"(b) {name}: two processes x 4 workers {how}: step "
                               f"{max(r['step_s'] for r in per):.4f} s (stacked "
                               f"{a['step_s']:.4f}), optimizer "
                               f"{max(r['opt_ms'] for r in per):.1f} ms (stacked "
                               f"{a['opt_ms']:.1f}), transport "
                               f"{max(r['transport_ms'] for r in per):.1f} ms a step, samplers "
                               f"{max(r['sampler_ms'] for r in per):.1f} ms a sample (stacked "
                               f"{a['sampler_ms']:.1f}), peak "
                               f"{max(r['peak_gib'] for r in per):.2f} GiB a process (stacked "
                               f"{a['peak_gib']:.2f}){extra}; rows and samplers as (a); "
                               f"on {smi}")
    log("transport-fleet", f"launches {counts}; (a) {a_s:.1f} s, (b) {b_s:.1f} s of "
                           f"processes; phase {time.perf_counter() - t_phase:.1f} s")
    return counts, numbers


def run_transport_fleet_alone():
    """``python3 chip_smoke.py --phase transport-fleet``: phase 11j alone on the
    full-width ResNet50 at ``PATH_TRAINER``'s depth (the wire kernels built
    first); its gates as in the whole run, its lines and its launch counts.
    Prints no result line."""
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    _build.build(["wire_kernels"])
    _build.wire_library()
    bft.init(size=SIZE)
    sm, images, labels = build_trainer(device, **PATH_TRAINER)
    counts, _numbers = phase_transport_fleet(device, sm, images, labels, smi=smi,
                                             trainer_kw=PATH_TRAINER)
    for path in ("transport-fleet a", "transport-fleet"):
        missing = [k for k in PATH_KERNELS[path] if counts[path][k] == 0]
        if missing:
            raise AssertionError(f"the {path} path launched no {missing} kernel: {counts[path]}")
    return 0


SC_ROOT = "build/scaling_trace"
SC_NS = (1, 2, 4, 8)  # weak scaling: workers on the card
SC_STEPS, SC_WARMUP = 3, 1
SC_TIMELINE_STEPS = (1, 2)  # (c): warm-up, then timed ATC/int8 steps
SC_RECORD_CALLS = 100_000  # (c): timeline_record_complete calls a median


def sc_log(msg):
    log("scaling-trace", msg)


def sc_one_peer_plan(n):
    """Step 0 of the one-peer Exp2 schedule over ``n`` workers, or the fully
    connected graph of one (bench.py::run_scaling's ``make_step``)."""
    from bluefog_tpu_torch.collective.plan import schedule_from_dynamic

    if n == 1:
        return plan_from_topology(topo.FullyConnectedGraph(1))
    return schedule_from_dynamic(n, lambda r: topo.GetDynamicOnePeerSendRecvRanks(
        topo.ExponentialGraph(n), r)).plans[0]


def sc_comm_stats(device, width=RESNET50_PARAMS):
    """(a) ``scaling.gossip_comm_stats`` on the card at ResNet50's width:
    one ``collective-permute`` of ``width * 4`` bytes for one-peer Exp2 at
    n = 2, 4, 8 (flat in n), 3 for the static Exp2(8), an ``all-reduce`` of
    the payload, and the ``include_plan`` summary equal to
    ``plan_comm_summary``. Returns ``{case: stats}``."""
    from bluefog_tpu_torch import scaling

    bft.init(size=SIZE, device=device)
    row = width * 4
    out = {}
    for n in (2, 4, 8):
        t0 = time.perf_counter()
        got = scaling.gossip_comm_stats(sc_one_peer_plan(n), width)
        sync(device)
        out[f"one-peer n={n}"] = got
        if got != {"collective-permute": {"count": 1, "bytes": row}}:
            raise AssertionError(f"scaling-trace (a): one-peer Exp2 at n = {n}: {got}, want one "
                                 f"collective-permute of {row} bytes")
        sc_log(f"(a) one-peer Exp2 n={n}: {got} in {time.perf_counter() - t0:.3f} s")
    exp2 = plan_from_topology(topo.ExponentialTwoGraph(SIZE))
    got = scaling.gossip_comm_stats(exp2, width, include_plan=True)
    summary = got.pop("plan")
    out["exp2(8)"] = got
    if got != {"collective-permute": {"count": 3, "bytes": 3 * row}}:
        raise AssertionError(f"scaling-trace (a): static Exp2(8): {got}, want 3 rounds")
    want = scaling.plan_comm_summary(exp2, row)
    if summary != want or summary["rounds"] != 3:
        raise AssertionError(f"scaling-trace (a): the include_plan summary {summary} is not "
                             f"plan_comm_summary's {want}")
    got = scaling.gossip_comm_stats(exp2, width, mode="allreduce")
    out["allreduce"] = got
    if got != {"all-reduce": {"count": 1, "bytes": row}}:
        raise AssertionError(f"scaling-trace (a): mode allreduce: {got}")
    sc_log(f"(a) static Exp2(8): {out['exp2(8)']}, plan summary rounds {summary['rounds']} "
           f"({summary['decomposition']}, {summary['wire_bytes_per_round']} B a round); "
           f"allreduce: {got}")
    bft.shutdown()
    return out


def sc_weak_scaling(device, sm, images, labels, ns=SC_NS, steps=SC_STEPS, warmup=SC_WARMUP,
                    smi=""):
    """(b) ``scaling.weak_scaling_times`` over ``opt.make_train_step`` of the
    ResNet50 (the phase's module on ``n`` workers, their images), ATC
    ``sgd(0.1, 0.9)`` on int8, the one-peer Exp2 plan (one worker: the fully
    connected graph of one), ``bft.init(size=n)`` anew for each ``n``. Gates:
    each step launches one ``encode`` and one ``decode_accumulate`` (the
    packed combine, one bucket), no other wire or flash kernel; at each n >= 2 the first
    step's combine bitwise the plain versions' on a CPU copy of its input.
    Returns ``(launch counts over every n, rows)``."""
    from bluefog_tpu_torch import scaling

    counts = {k: 0 for k in launch_counts()}
    per_n, checked = {}, {}
    live = {}  # the size in flight: n, its captured combine

    def close():
        """The size in flight's launches and its combine's plain check."""
        n = live.pop("n", None)
        if n is not None:
            per_n[n] = launch_counts()
            for k, v in per_n[n].items():
                counts[k] += v
            if live.get("captured") is not None:
                checked[n] = at_plain_check(f"scaling-trace (b) n={n}", live["captured"], "int8")
        live.clear()
        bft.shutdown()

    def make_step(n):
        close()
        bft.init(size=n, device=device)
        bft.set_topology(sc_one_peer_plan(n).weight_matrix(), is_weighted=True)
        stacked = StackedModel(sm.module, n, device)
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = "int8"
        params = stacked.replicate()
        state = opt.init(params)
        rec = at_recorder(opt, device, stacked.width) if n > 1 else None
        if rec is not None:
            rec["arm"] = True  # the first (warm-up) step's combine
        step = opt.make_train_step(stacked.worker_loss)
        batch = (images[:n].contiguous(), labels[:n].contiguous(), torch.arange(n))
        live["n"] = n

        def fn():
            out = step(params, state, *batch)
            if rec is not None and "captured" not in live:
                live["captured"] = rec["captured"]
                del opt._resolve_dispatch  # the recorder holds the optimizer: a cycle
            return out

        reset_launch_counts()
        return fn, ()

    rows = scaling.weak_scaling_times(make_step, ns, steps=steps, warmup=warmup)
    close()
    for n in ns:
        want = {k: (steps + warmup if k in PATH_KERNELS["scaling-trace"] else 0)
                for k in KERNEL_ROWS}
        if device.type == "cuda" and {k: per_n[n][k] for k in KERNEL_ROWS} != want:
            raise AssertionError(f"scaling-trace (b) n={n}: launches {per_n[n]}, a step "
                                 f"predicts one encode and one decode_accumulate: {want}")
    missing = [n for n in ns if n > 1 and n not in checked]
    if missing:
        raise AssertionError(f"scaling-trace (b): no combine captured at n = {missing}")
    for r in rows:
        n = r["n"]
        sc_log(f"(b) weak scaling n={n}: {r['ms_per_step']:.3f} ms a step, "
               f"{n * images.shape[1] / (r['ms_per_step'] / 1e3):.1f} images/s, efficiency "
               f"{r['efficiency']:.4f} (n stacked workers share one card: about 1/n is "
               f"expected, not a claim about scaling across cards); launches "
               f"{ {k: v for k, v in per_n[n].items() if v} }; "
               f"combine bitwise the plain versions: "
               f"{'n/a' if n == 1 else f'{checked[n]} round(s)'}; on {smi}")
    return counts, rows


def sc_timeline_run(device, sm, images, labels, root, python):
    """(c) ATC/int8 steps of the ResNet50 on the default Exp(8) graph with
    ``BLUEFOG_TIMELINE`` and ``BLUEFOG_FLIGHT_DIR`` under ``root`` (the
    Python writer if ``python``), then a flight dump. Returns the timeline's
    events."""
    from bluefog_tpu_torch import timeline as tl

    os.makedirs(root, exist_ok=True)
    writer = tl.python_writer() if python else contextlib.nullcontext()
    with env_set({"BLUEFOG_TIMELINE": os.path.join(root, "trace_"),
                  "BLUEFOG_FLIGHT_DIR": root}), writer:
        bft.init(size=SIZE, device=device)
        if tl.using_native_writer() == python:
            raise AssertionError(f"scaling-trace (c): the {'Python' if python else 'native'} "
                                 f"writer was not the one in use")
        opt = bft.DistributedAdaptThenCombineOptimizer(bft.sgd(0.1, momentum=0.9))
        opt.compression = "int8"
        params = sm.replicate()
        state = opt.init(params)
        step = opt.make_train_step(sm.worker_loss)
        for _ in range(sum(SC_TIMELINE_STEPS)):
            params, state, loss = step(params, state, images, labels, torch.arange(SIZE))
        sync(device)
        if not torch.isfinite(loss).all():
            raise AssertionError("scaling-trace (c): non-finite loss")
        bft.flight_dump()
        bft.shutdown()
    with open(os.path.join(root, "trace_0.json")) as f:
        events = json.load(f)
    if not isinstance(events, list) or not events:
        raise AssertionError(f"scaling-trace (c): {root}/trace_0.json is not a JSON array "
                             f"of events")
    return events


def sc_record_cost(root, python, threads, calls=SC_RECORD_CALLS):
    """Median host microseconds of one ``timeline_record_complete`` over
    ``calls`` calls, with ``threads - 1`` more threads recording too."""
    import threading

    from bluefog_tpu_torch import timeline as tl

    writer = tl.python_writer() if python else contextlib.nullcontext()
    with writer:
        if not tl.timeline_init(os.path.join(root, f"cost_{int(python)}_{threads}.json")):
            raise AssertionError("scaling-trace (c): a timeline was already open")
        stop = threading.Event()

        def other():
            while not stop.is_set():
                tl.timeline_record_complete("other", "BENCH", 0, 1, tid=1)

        others = [threading.Thread(target=other) for _ in range(threads - 1)]
        for t in others:
            t.start()
        times = []
        clock = time.perf_counter_ns
        for _ in range(calls):
            t0 = clock()
            tl.timeline_record_complete("span", "BENCH", 0, 1)
            times.append(clock() - t0)
        stop.set()
        for t in others:
            t.join()
        tl.timeline_shutdown()
    return statistics.median(times) / 1e3


def sc_native_writer(device, sm, images, labels, root, smi=""):
    """(c) The native writer: in use on this machine; an ATC/int8 run through
    it and through the Python writer give the same event names and counts;
    the record cost of each, one and two threads. Returns the native run's
    directory and the costs."""
    from collections import Counter

    from bluefog_tpu_torch import timeline as tl

    if not tl.using_native_writer():
        raise AssertionError("scaling-trace (c): the timeline writes through the Python writer "
                             "on this machine (no g++?)")
    native = sc_timeline_run(device, sm, images, labels, os.path.join(root, "native"), False)
    python = sc_timeline_run(device, sm, images, labels, os.path.join(root, "python"), True)
    names = Counter(e["name"] for e in native), Counter(e["name"] for e in python)
    if names[0] != names[1]:
        raise AssertionError(f"scaling-trace (c): the native and Python timelines differ: "
                             f"{names[0] - names[1]} / {names[1] - names[0]}")
    sc_log(f"(c) native writer in use; {len(native)} events in both timelines, "
           f"{len(names[0])} names, the same counts")
    costs = {}
    for python_writer in (False, True):
        for threads in (1, 2):
            costs[(python_writer, threads)] = sc_record_cost(root, python_writer, threads)
    sc_log("(c) host us a timeline_record_complete (median of "
           f"{SC_RECORD_CALLS} calls): native {costs[(False, 1)]:.3f} alone, "
           f"{costs[(False, 2)]:.3f} beside a second recording thread; Python "
           f"{costs[(True, 1)]:.3f} alone, {costs[(True, 2)]:.3f} beside a second; on {smi}")
    return os.path.join(root, "native"), costs


def sc_tools(run_dir):
    """(d) ``tools/trace_merge.py --report`` and ``tools/metrics_report.py
    --flight`` on (c)'s native run: both exit 0, 8 rank lanes, and every
    step's rounds ``len(plan.rounds)`` of the default Exp(8) plan."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    report_path = os.path.join(run_dir, "report.json")
    outs = {}
    for name, args in (("trace_merge", ["tools/trace_merge.py", run_dir, "--report",
                                        report_path]),
                       ("metrics_report", ["tools/metrics_report.py", "--flight", run_dir,
                                           "--json"])):
        out = subprocess.run([sys.executable, *args], capture_output=True, text=True,
                             timeout=120, cwd=here, env=env)
        if out.returncode != 0:
            raise AssertionError(f"scaling-trace (d): {name} exited {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
        outs[name] = out.stdout
    with open(report_path) as f:
        report = json.load(f)
    with open(os.path.join(run_dir, "merged_trace.json")) as f:
        merged = json.load(f)
    lanes = sorted(e["pid"] for e in merged["traceEvents"]
                   if e.get("ph") == "M" and e["args"]["name"].startswith("rank "))
    want = len(plan_from_topology(topo.ExponentialGraph(SIZE)).rounds)
    rounds = [s["rounds"] for s in report["per_step_rounds"]]
    if lanes != list(range(SIZE)) or report["ranks"] != list(range(SIZE)):
        raise AssertionError(f"scaling-trace (d): rank lanes {lanes}, want 0..{SIZE - 1}")
    if len(rounds) != sum(SC_TIMELINE_STEPS) or any(r != want for r in rounds):
        raise AssertionError(f"scaling-trace (d): per-step rounds {rounds}, want {want} on "
                             f"each of {sum(SC_TIMELINE_STEPS)} steps")
    flight_report = json.loads(outs["metrics_report"])
    sc_log(f"(d) trace_merge: {len(lanes)} rank lanes, per-step rounds {rounds} (the default "
           f"Exp(8) plan's {want}); metrics_report --flight: {len(flight_report['dumps'])} "
           f"dump(s), {flight_report['dumps'][0]['events']} events")
    return report


def phase_scaling_trace(device, sm, images, labels, root=SC_ROOT, smi="", width=RESNET50_PARAMS,
                        ns=SC_NS):
    """Phase 11k: (a) ``gossip_comm_stats`` on the card (:func:`sc_comm_stats`),
    (b) weak scaling of the ATC/int8 ResNet50 through B1 and B2
    (:func:`sc_weak_scaling`), (c) the native timeline writer
    (:func:`sc_native_writer`), (d) the trace tools on (c)'s artifacts
    (:func:`sc_tools`); files under ``root``, deleted. Returns ``(launch
    counts of (b), numbers)``."""
    import shutil

    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    stats = sc_comm_stats(device, width)
    t_a = time.perf_counter()
    counts, rows = sc_weak_scaling(device, sm, images, labels, ns=ns, smi=smi)
    t_b = time.perf_counter()
    run_dir, costs = sc_native_writer(device, sm, images, labels, root, smi=smi)
    sc_tools(run_dir)
    shutil.rmtree(root, ignore_errors=True)
    bft.init(size=SIZE, device=device)
    sc_log(f"phase in {time.perf_counter() - t0:.1f} s ((a) {t_a - t0:.1f}, (b) {t_b - t_a:.1f}, "
           f"(c) and (d) {time.perf_counter() - t_b:.1f})")
    return counts, {"stats": stats, "weak": rows, "record_us": costs}


def run_scaling_trace_alone():
    """``python3 chip_smoke.py --phase scaling-trace``: phase 11k alone on
    the full-width ResNet50 (the wire kernels built first); its gates as in
    the whole run, its lines and its launch counts. Prints no result line."""
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    _build.build(["wire_kernels"])
    _build.wire_library()
    bft.init(size=SIZE)
    sm, images, labels = build_trainer(device)
    counts, _numbers = phase_scaling_trace(device, sm, images, labels, smi=smi)
    missing = [k for k in PATH_KERNELS["scaling-trace"] if counts[k] == 0]
    if missing:
        raise AssertionError(f"the scaling-trace path launched no {missing} kernel: {counts}")
    return 0


# phase 11l, the torch frontend: (a) the wires of its neighbor_allreduce; the
# columns of the float64 check of its adjoint, and that check's tolerance, of
# max |g|
FE_WIRES = (None, "bf16", "int8", "int4")
FE_SLICE = 1 << 20
FE_ADJ_TOL = 1e-6
# (b) the wrapped SGD's warm-up and timed steps, the gradient allreduce's
# steps, and the steps held against the functional optimizer (before StepLR
# halves the rate), which is fed the wrapped run's gradients. The functional
# SGD rounds ``-lr * trace`` and the add apart, torch's SGD adds ``alpha *
# buf`` in one fused operation: a ulp of a parameter a step. On the int8
# wire such a ulp can move a value across a rounding boundary, one quantum
# (1/127 of its block's largest value) at most: the tolerance, of the
# largest parameter, and the share of the elements off by more than FE_NEAR
# of it
FE_WARMUP, FE_TIMED = 1, 3
FE_GRAD_STEPS = 3
FE_FUNC_STEPS = 2
FE_FUNC_TOL = {"int8": 1 / 127, "fp32": 1e-6}
FE_NEAR, FE_NEAR_SHARE = 1e-6, 1e-3


def host_copy(t):
    """A copy of ``t`` in host memory (``.cpu()`` of a CPU tensor is the
    tensor itself)."""
    return t.to("cpu", copy=True)


def fe_log(msg):
    log("frontend", msg)


def fe_same(name, got, want):
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(bits(got),
                                                                             bits(want)):
        diff = (float((got.double() - want.double()).abs().max())
                if got.shape == want.shape else float("nan"))
        raise AssertionError(f"frontend {name}: not bitwise equal (max diff {diff:.3g})")


def fe_wire_launches(name, counts, wire, device):
    """Gate: one ``encode`` and one ``decode_accumulate`` on int8 and int4
    on the card, no wire kernel otherwise (the CPU launches none)."""
    want = {k: 0 for k in counts}
    if wire in ("int8", "int4") and device.type == "cuda":
        want.update(encode=1, decode_accumulate=1)
    if counts != want:
        raise AssertionError(f"frontend {name}: launches {counts}, expected {want}")


def fe_ops(device, n=RESNET50_WIDTH):
    """(a): the frontend's ops on ``[8, n]`` f32 over the default Exp(8)
    plan against the facade's calls on the same input; returns the times."""
    from bluefog_tpu_torch.collective.plan import plan_from_matrix

    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn(SIZE, n, generator=gen, device=device) * 5.0
    g = torch.randn(SIZE, n, generator=gen, device=device)
    w = bft.get_context().static_plan().weight_matrix()
    adjoint = inner.neighbor_allreduce(g, plan_from_matrix(w.T))
    cols = min(FE_SLICE, n)
    ref64 = torch.from_numpy(w).to(device) @ g[:, :cols].double()
    err = float((adjoint[:, :cols].double() - ref64).abs().max())
    scale = float(g.abs().max())
    if not err <= FE_ADJ_TOL * scale:
        raise AssertionError(f"frontend: the transposed combine is {err:.3g} from W g in "
                             f"float64 (> {FE_ADJ_TOL} * {scale:.3g})")
    del ref64
    times = {}
    for wire in FE_WIRES:
        name = f"neighbor_allreduce/{wire or 'fp32'}"
        xg = x.clone().requires_grad_(True)
        sync(device)
        reset_launch_counts()
        y = bftt.neighbor_allreduce(xg, compression=wire)
        sync(device)
        fe_wire_launches(f"{name} forward", kernels.launch_counts(), wire, device)
        fe_same(f"{name} forward", y.detach(), bft.neighbor_allreduce(x, compression=wire))
        reset_launch_counts()
        y.backward(g)
        sync(device)
        fe_wire_launches(f"{name} backward", kernels.launch_counts(), None, device)
        fe_same(f"{name} backward", xg.grad, adjoint)
        del y, xg
        with torch.no_grad():
            times[name] = (time_ms(lambda: bftt.neighbor_allreduce(x, compression=wire), device,
                                   iters=5, warmup=1),
                           time_ms(lambda: bft.neighbor_allreduce(x, compression=wire), device,
                                   iters=5, warmup=1))
    for name, root in (("allreduce", None), ("broadcast", 3)):
        xg = x.clone().requires_grad_(True)
        if root is None:
            y, want = bftt.allreduce(xg), bft.allreduce(x)
        else:
            y, want = bftt.broadcast(xg, root), bft.broadcast(x, root)
        fe_same(f"{name} forward", y.detach(), want)
        y.backward(g)
        if root is None:
            want = bft.allreduce(g)
        else:
            summed = bft.allreduce(g, average=False)
            want = torch.zeros_like(summed)
            want[root] = summed[root]
        fe_same(f"{name} backward", xg.grad, want)
        del y, xg, want
    fe_log(f"(a) on [{SIZE}, {n}] f32, Exp(8): neighbor_allreduce (fp32, bf16, int8, int4) "
           f"forward bitwise the facade's, one encode and one decode_accumulate a call on "
           f"int8 and int4, none on the others; backward no wire kernel, bitwise the exact "
           f"combine over W^T, which is {err:.3g} from W g in float64 on {cols} columns "
           f"(tolerance {FE_ADJ_TOL * scale:.3g}); allreduce and broadcast forward and backward "
           f"bitwise the facade's calls; forward ms, frontend / facade: "
           + ", ".join(f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in times.items()))
    return times


def fe_wrapped(device, sm, images, labels, params0, stats0, wire, steps, timed=0,
               factory_name="DistributedNeighborAllreduceOptimizer", hand=False):
    """``steps`` ResNet50 steps of the user's ``torch.optim.SGD(lr=0.1,
    momentum=0.9)`` under ``StepLR(2, 0.5)`` on one ``nn.Parameter``, the
    flat stacked buffer: wrapped by the frontend's ``factory_name``, or
    (``hand``) unwrapped after the facade's combine composed by hand. The
    last ``timed`` steps are timed (the gradient and the step; the host
    copies below are not). Returns ``(optimizer, parameter, host copies
    of the parameters after each step and of each step's gradient,
    per-step launches, numbers)``."""
    sm.load_buffers(stats0)
    flat = torch.nn.Parameter(params0.clone())
    flat.grad = torch.empty_like(flat)
    opt = torch.optim.SGD([flat], lr=0.1, momentum=0.9)
    if not hand:
        assert getattr(bftt, factory_name)(opt) is opt
        if wire is not None:
            opt.compression = wire
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=2, gamma=0.5)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kept, grads, launches, times = [], [], [], []
    for i in range(steps):
        sync(device)
        t0 = time.perf_counter()
        sm.loss_and_grad(flat.detach(), images, labels, flat.grad)
        sync(device)
        t1 = time.perf_counter()
        grads.append(host_copy(flat.grad))  # before a gradient allreduce averages it
        before = kernels.launch_counts()
        sync(device)
        t2 = time.perf_counter()
        if hand:
            with torch.no_grad():
                flat.copy_(bft.neighbor_allreduce(flat.detach(), compression=wire))
        opt.step()
        sync(device)
        t3 = time.perf_counter()
        after = kernels.launch_counts()
        sched.step()
        launches.append({k: after[k] - before[k] for k in after})
        if i >= steps - timed:
            times.append((t1 - t0 + t3 - t2, t3 - t2))
        kept.append(host_copy(flat.detach()))
    numbers = {}
    if times:
        numbers = dict(step_s=statistics.median(t[0] for t in times),
                       opt_ms=statistics.median(t[1] for t in times) * 1e3,
                       peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                                 if device.type == "cuda" else float("nan")))
    if not torch.isfinite(flat).all():
        raise AssertionError(f"frontend {factory_name}/{wire}: non-finite parameters")
    return opt, flat, kept, grads, launches, numbers


def fe_step_lr(count):
    """``StepLR(step_size=2, gamma=0.5)`` of ``lr=0.1`` as a functional
    schedule of the step count."""
    return 0.1 * 0.5 ** (count // 2)


def fe_functional(device, params0, grads, factory, wire, lr=0.1):
    """The port's functional ``factory(bft.sgd(lr, momentum=0.9))``
    (``opt.step``) from ``params0``, fed the gradients ``grads`` (host
    copies, one a step) of a wrapped run; returns the parameters after
    each step (host copies) and the last step's optimizer ms."""
    opt = factory(bft.sgd(lr, momentum=0.9))
    opt.compression = wire
    params = params0.clone()
    state = opt.init(params)
    kept = []
    for g in grads:
        g = g.to(device)
        sync(device)
        t0 = time.perf_counter()
        opt.step(params, state, g)
        sync(device)
        opt_ms = (time.perf_counter() - t0) * 1e3
        kept.append(host_copy(params))
    opt.free()
    return kept, opt_ms


def fe_near(name, got, want, tol):
    """Gate: ``max |got - want|`` within ``tol`` of the largest |want|, and
    at most ``FE_NEAR_SHARE`` of the elements beyond ``FE_NEAR`` of it."""
    scale = float(want.abs().max())
    diff = (got - want).abs()
    err = float(diff.max())
    share = int((diff > FE_NEAR * scale).sum()) / diff.numel()
    if not (err <= tol * scale and share <= FE_NEAR_SHARE):
        raise AssertionError(f"frontend {name}: max diff {err:.3g} (tolerance {tol * scale:.3g}),"
                             f" share beyond {FE_NEAR} of the largest {share:.3g} "
                             f"(bound {FE_NEAR_SHARE})")
    return err / scale, share


def fe_train(device, sm, images, labels, smi=""):
    """(b): the whole ResNet50 through the wrapped ``torch.optim.SGD``;
    returns ``(launch counts of the wrapped int8 run, numbers)``."""
    stats0 = {k: v.clone() for k, v in sm.buffers.items()}
    params0 = sm.replicate()
    steps = FE_WARMUP + FE_TIMED
    reset_launch_counts()
    opt, flat, kept, grads, launches, numbers = fe_wrapped(
        device, sm, images, labels, params0, stats0, "int8", steps, timed=FE_TIMED)
    counts = launch_counts()
    for i, step in enumerate(launches):
        fe_wire_launches(f"wrapped SGD int8 step {i}", step, "int8", device)
    # the state_dict round trip: a fresh wrapped SGD loads a copy of it (as a
    # checkpoint would hand it back), then both take one more step on the
    # same gradient
    state = copy.deepcopy(opt.state_dict())
    twin = torch.nn.Parameter(flat.detach().clone())
    twin_opt = torch.optim.SGD([twin], lr=1.0)
    bftt.DistributedNeighborAllreduceOptimizer(twin_opt)
    twin_opt.compression = "int8"
    twin_opt.load_state_dict(state)
    buf, twin_buf = opt.state[flat]["momentum_buffer"], twin_opt.state[twin]["momentum_buffer"]
    if twin_buf.device != flat.device or twin_opt.param_groups[0]["lr"] != \
            opt.param_groups[0]["lr"]:
        raise AssertionError("frontend: the loaded state is off the card or has another lr")
    fe_same("state_dict round trip, momentum", twin_buf, buf)
    twin.grad = flat.grad.clone()
    opt.step()
    twin_opt.step()
    fe_same("state_dict round trip, one more step", twin.detach(), flat.detach())
    lr_after = opt.param_groups[0]["lr"]
    del opt, flat, twin_opt, twin, state, buf, twin_buf
    torch.cuda.empty_cache()
    hand = fe_wrapped(device, sm, images, labels, params0, stats0, "int8", steps, hand=True)[2]
    for i, (got, want) in enumerate(zip(kept, hand)):
        fe_same(f"wrapped SGD int8 after step {i} against the steps composed by hand", got, want)
    del hand
    func, func_opt_ms = fe_functional(device, params0, grads[:FE_FUNC_STEPS],
                                      bft.DistributedNeighborAllreduceOptimizer, "int8")
    na_err = [fe_near(f"wrapped SGD int8 after step {i} against the functional optimizer",
                      kept[i], want, FE_FUNC_TOL["int8"]) for i, want in enumerate(func)]
    del func, kept, grads
    _, ga_flat, ga_kept, ga_grads, ga_launches, _ = fe_wrapped(
        device, sm, images, labels, params0, stats0, None, FE_GRAD_STEPS,
        factory_name="DistributedGradientAllreduceOptimizer")
    if any(any(v for v in step.values()) for step in ga_launches):
        raise AssertionError(f"frontend: the gradient allreduce launched wire kernels "
                             f"{ga_launches}")
    if not torch.equal(bits(ga_flat.detach()), bits(ga_flat.detach()[:1].expand_as(ga_flat))):
        raise AssertionError("frontend: the wrapped gradient allreduce left the workers apart")
    func, _ = fe_functional(device, params0, ga_grads,
                            bft.DistributedGradientAllreduceOptimizer, None, lr=fe_step_lr)
    ga_err = [fe_near(f"wrapped gradient allreduce after step {i} against the functional "
                      "optimizer", ga_kept[i], want, FE_FUNC_TOL["fp32"])
              for i, want in enumerate(func)]
    del func, ga_flat, ga_kept, ga_grads
    sm.load_buffers(stats0)
    numbers.update(func_opt_ms=func_opt_ms, na_err=na_err, ga_err=ga_err, lr=lr_after)
    fe_log(f"(b) ResNet50 x{SIZE} workers, {images.shape[1]} images of "
           f"{images.shape[2]}x{images.shape[3]} each, "
           f"{sm.n_params} parameters per worker, torch.optim.SGD(0.1, momentum 0.9) under "
           f"StepLR(2, 0.5) wrapped by DistributedNeighborAllreduceOptimizer, int8: median "
           f"step {numbers['step_s']:.4f} s, {SIZE * images.shape[1] / numbers['step_s']:.1f} "
           f"images/s, optimizer {numbers['opt_ms']:.1f} ms (the functional optimizer's "
           f"{func_opt_ms:.1f} ms), peak {numbers['peak_gib']:.2f} GiB; encode and "
           f"decode_accumulate once a step; parameters bitwise the steps composed by hand "
           f"after each of {steps} steps; the functional optimizer fed the same gradients, "
           f"after steps 1 and 2: max diff of the largest parameter and share of the elements "
           f"beyond {FE_NEAR} of it {', '.join(f'{e:.3g} / {f:.3g}' for e, f in na_err)} "
           f"(tolerance {FE_FUNC_TOL['int8']:.3g} / {FE_NEAR_SHARE}); state_dict round trip "
           f"bitwise (lr {lr_after}); gradient allreduce, {FE_GRAD_STEPS} steps: workers "
           f"bitwise equal, from the functional optimizer on the same gradients "
           f"{', '.join(f'{e:.3g}' for e, _f in ga_err)} of the largest parameter "
           f"(tolerance {FE_FUNC_TOL['fp32']:.3g}); on {smi}")
    return counts, numbers


def phase_frontend(device, sm, images, labels, smi="", n=RESNET50_WIDTH):
    """Phase 11l: (a) the frontend's ops at full width (:func:`fe_ops`), (b)
    the whole ResNet50 through the wrapped ``torch.optim.SGD``
    (:func:`fe_train`). cuDNN runs its deterministic algorithms, so two
    runs of one gradient agree. Returns ``(launch counts of (b)'s wrapped
    int8 run, zeroed just before it and read just after, numbers)``."""
    t0 = time.perf_counter()
    bft.init(size=SIZE, device=device)
    times = fe_ops(device, n)
    torch.cuda.empty_cache()
    t_a = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        counts, numbers = fe_train(device, sm, images, labels, smi=smi)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    numbers["ops_ms"] = times
    fe_log(f"phase in {time.perf_counter() - t0:.1f} s ((a) {t_a - t0:.1f}, "
           f"(b) {time.perf_counter() - t_a:.1f}); launches of the wrapped int8 run {counts}")
    return counts, numbers


def run_frontend_alone():
    """``python3 chip_smoke.py --phase frontend``: phase 11l alone on the
    whole ResNet50 (the wire kernels built first); its gates as in the whole
    run. Prints no result line."""
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    _build.build(["wire_kernels"])
    _build.wire_library()
    sm, images, labels = build_trainer(device)
    counts, _numbers = phase_frontend(device, sm, images, labels, smi=smi)
    missing = [k for k in PATH_KERNELS["frontend"] if counts[k] == 0]
    if missing:
        raise AssertionError(f"the frontend path launched no {missing} kernel: {counts}")
    return 0


def lm_flops_per_step(sm, seq, batch):
    """bench.py's model FLOPs of one step of every worker: per token
    ``3 * (2 P + 2 T dim layers)`` (the parameters' products and causal
    attention at mean context T / 2, forward and twice that backward)."""
    m = sm.module
    return SIZE * batch * seq * 3 * (2 * sm.n_params + 2 * seq * m.dim * m.layers)


def lm_attention_check(sm, params, tokens):
    """Worker 0's forward on the trained parameters, in which every block's
    attention (the flash kernels on the card) is held against the plain
    version of the forward kernel on that block's own q, k and v: each
    query row to ``FLASH_ROW_TOL`` of its norm, as in flash-parity."""
    blocks = [getattr(sm.module, f"Block_{i}") for i in range(sm.module.layers)]
    saved = [b.attend for b in blocks]
    errs = []

    def checked(attend):
        def run(q, k, v):
            out = attend(q, k, v)
            want, _ = flash.flash_fwd_reference(q, k, v, True, 1.0 / math.sqrt(q.shape[-1]))
            errs.append(row_err(out, want))
            return out
        return run

    for b, attend in zip(blocks, saved):
        b.attend = checked(attend)
    try:
        with torch.no_grad():
            functional_call(sm.module, sm.views(params[0]), (tokens[0],))
    finally:
        for b, attend in zip(blocks, saved):
            b.attend = attend
    dtype = sm.module.dtype
    tol = FLASH_ROW_TOL[dtype]["out"]
    log("train", f"transformer worker 0, attention of each block against the plain version "
                 f"on its own q, k, v: largest row error relative to the row's norm "
                 f"{max(errs):.3g} (limit {tol:g}; by block "
                 f"{', '.join(f'{e:.3g}' for e in errs)})")
    if len(errs) != len(blocks) or not max(errs) <= tol:
        raise AssertionError(f"the transformer's attention differs from the plain version: {errs}")


def profile_once(device, name, run, top=12):
    """``run()`` once under ``torch.profiler``: logs the card's busy share
    of its wall time and the kernels that take the most device time;
    returns ``{kernel name: device us}`` (empty when the profiler reports
    no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels only: an operator's self device time repeats its kernels'
    rows = [
        (e.self_device_time_total, e.count, e.key)
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA
    ]
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        log("profile", f"{name}: the profiler reported no device time: busy share not measured")
        return {}
    log("profile", f"{name}: one profiled step (the profiler slows the host): wall "
                   f"{wall_us / 1e3:.1f} ms, kernels "
                   f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), idle "
                   f"{100 * (1 - busy_us / wall_us):.1f}%")
    for us, count, key in sorted(rows, reverse=True)[:top]:
        log("profile", f"{name}: {100 * us / busy_us:5.1f}% {us / 1e3:9.2f} ms x{count:5d} "
                       f"{key[:110]}")
    return {key: us for us, _count, key in rows}


def phase_kernels(device, params, rate):
    """Each wire kernel against its plain version at the main path's
    shapes, and timed; returns the rows of the kernels JSON line (their
    ``launches`` are filled in once every path has run)."""
    plan = bft.get_context().static_plan()
    src, _self_w, recv_w = inner.plan_operands(plan, device)
    n_workers, width = params.shape
    elems = n_workers * width
    rows, lines = {}, []
    plain_time = lambda fn: time_ms(fn, device, iters=3, warmup=1)
    for wire in ("int8", "int4"):
        x = params.clone()
        h = params * 0.999  # a CHOCO copy near the parameters
        errs = {}
        errs["encode"], p, s = check_encode(x, wire)
        errs["decode_accumulate"] = check_decode(x, p, s, src, recv_w, wire)
        errs["encode_diff"], pd, sd, _h = check_encode_diff(x, h, wire)
        # every source row the paths give these two: each round's, and
        # (decode) the sender's own payload
        errs["decode_add"] = max(check_decode_add(h, pd, sd, src[r], wire)
                                 for r in range(src.shape[0]))
        errs["decode"] = max(check_decode_rows(pd, sd, src_r, wire)
                             for src_r in [None] + list(src))
        acc, hk, base = x.clone(), h.clone(), h.clone()
        calls = {
            "encode": (lambda: kernels.encode(x, wire),
                       lambda: kernels.encode_reference(x, wire)),
            "decode_accumulate": (
                lambda: kernels.decode_accumulate(acc, p, s, src, recv_w, wire),
                lambda: kernels.decode_accumulate_reference(acc, p, s, src, recv_w, wire)),
            "encode_diff": (lambda: kernels.encode_diff(x, hk, wire),
                            lambda: kernels.encode_diff_reference(x, hk, wire)),
            "decode_add": (
                lambda: kernels.decode_add(base, pd, sd, src[0], wire, src_in_range=True),
                lambda: kernels.decode_add_reference(base, pd, sd, src[0], wire)),
            "decode": (lambda: kernels.decode(pd, sd, src[0], wire, src_in_range=True),
                       lambda: kernels.decode_reference(pd, sd, src[0], wire)),
        }
        wire_b = p.numel() * p.element_size() + s.numel() * s.element_size()
        f32_b = elems * 4
        # bytes: every input read once, every output written once
        nbytes = {
            "encode": f32_b + wire_b,
            "decode_accumulate": 2 * f32_b + wire_b + src.numel() * 4 + recv_w.numel() * 4,
            "encode_diff": 3 * f32_b + wire_b,
            "decode_add": 2 * f32_b + wire_b + n_workers * 4,
            "decode": f32_b + wire_b + n_workers * 4,
        }
        # f32 operations per element: encode |x|, max, divide, round (int4:
        # and pack); decode_accumulate the self dequant, then per round a
        # dequant, a subtract, a multiply and an add; encode_diff the
        # subtract, encode's four, and the copy's multiply and add;
        # decode_add a multiply and an add; decode a multiply
        ops = {"encode": 4, "decode_accumulate": 1 + 4 * src.shape[0], "encode_diff": 7,
               "decode_add": 2, "decode": 1}
        for name, (kernel, plain) in calls.items():
            ms, plain_ms = time_ms(kernel, device), plain_time(plain)
            t_bytes, t_ops = nbytes[name] / rate * 1e3, ops[name] * elems / F32_RATE * 1e3
            bound = max(t_bytes, t_ops)
            mapping = f" (lane mapping: {DECODE_MAPPING})" if name == "decode" else ""
            lines.append(
                f"{name}[{wire}] [{n_workers}, {width}]{mapping}: {ms:.4f} ms kernel, "
                f"{plain_ms:.4f} ms plain, bound {bound:.4f} ms "
                f"({nbytes[name] / 1e9:.4f} GB), {nbytes[name] / ms / 1e6:.1f} GB/s, "
                f"{100 * bound / ms:.1f}% of the bound"
            )
            if name not in rows:
                rows[name] = {
                    "name": name, "route": "cuda",
                    "source": "bluefog_tpu_torch/csrc/wire_kernels.cu",
                    "replaces": KERNEL_ROWS[name], "launches": None,
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": None,
                }
                if name == "decode":
                    rows[name]["design"] = DECODE_MAPPING
            else:
                rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], errs[name])
        del x, h, acc, hk, base, p, s, pd, sd, calls
    return list(rows.values()), lines


def bn_case(device, shape, with_residual, seed=0):
    """One BatchNorm case of phase 17a: ``shape`` bf16 channels-last with
    the ReLU fused, and the residual too if ``with_residual``, through the
    forward and backward kernels, held to the plain versions:

    - ``stats`` and ``finish``: mean and rstd within
      ``batch_norm_stats_bounds`` of the plain f32 statistics (another
      summation order), the clipped-variance flags equal;
    - ``apply``: bit for bit the plain normalization on the kernels'
      statistics;
    - ``bwd_reduce`` and ``bwd_finish``: dbias and dscale within
      ``batch_norm_sum_bound`` of the plain sums;
    - ``bwd_dx``: dx (and the residual's gradient) bit for bit the plain
      formula given the kernels' sums;
    - against the plain composite: the output within one bf16 ulp of each
      rounding (the normalization's, and the residual add's), at most
      ``2**-7`` of the largest value each rounds; dx within one ulp of the
      largest dx.

    Returns the operands, the kernels' calls and the composite's
    differences, and one line."""
    n, c, h, w = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def act(spread, shift):
        t = torch.randn(n, h, w, c, generator=gen, device=device) * spread + shift
        return t.to(torch.bfloat16).permute(0, 3, 1, 2)

    x = act(2.0, 0.5)
    res = act(1.0, 0.0) if with_residual else None
    dy = act(1.0, 0.0)
    scale = torch.randn(c, generator=gen, device=device)
    bias = torch.randn(c, generator=gen, device=device)
    rm, rv = torch.zeros(c, device=device), torch.ones(c, device=device)
    where = f"batchnorm [{n * h * w}, {c}]{' + residual' if with_residual else ''}"
    fwd = lambda: bn_ops.batch_norm_fwd(x, scale, bias, res, rm, rv, True, 0.9, 1e-5, True)
    y, stats = fwd()
    ref = bn_ops.batch_norm_stats_reference(x)
    d_mean, _, d_rstd = bn_ops.batch_norm_stats_bounds(x, ref)
    stat_share = max(float(((stats[0].double() - ref[0].double()).abs() / d_mean).max()),
                     float(((stats[1].double() - ref[1].double()).abs() / d_rstd).max()))
    if not stat_share <= 1 or not torch.equal(stats[2], ref[2]):
        raise AssertionError(f"{where}: stats + finish off the plain statistics by "
                             f"{stat_share:.3g} of their summation-order bound, or the "
                             f"clipped-variance flags differ")
    del ref, d_mean, d_rstd
    if not torch.equal(bits(y), bits(bn_ops.batch_norm_apply_reference(x, stats, scale, bias,
                                                                        res, True))):
        raise AssertionError(f"{where}: apply differs from the plain normalization on its "
                             f"statistics")
    plain_y = bn_ops.batch_norm_reference(x, scale, bias, rm.clone(), rv.clone(), True,
                                          residual=res, relu=True)
    fwd_err = float((y.float() - plain_y.float()).abs().max())
    fwd_lim = 2.0 ** -7 * float(plain_y.float().abs().max())
    if with_residual:
        fwd_lim += 2.0 ** -7 * float(
            bn_ops.batch_norm_apply_reference(x, stats, scale, bias).float().abs().max())
    del plain_y
    if not fwd_err <= fwd_lim:
        raise AssertionError(f"{where}: the output is {fwd_err:.4g} off the plain composite's, "
                             f"over one bf16 ulp a rounding ({fwd_lim:.4g})")

    bwd = lambda: bn_ops.batch_norm_bwd(dy, x, y, stats, scale, True, with_residual)
    dx, dscale, dbias, g = bwd()
    pdx, pdscale, pdbias, pg = bn_ops.batch_norm_backward_reference(dy, x, y, stats, scale)
    gd = torch.where(y > 0, dy.double(), 0.0)
    sum_share = float(((dbias.double() - pdbias.double()).abs()
                       / bn_ops.batch_norm_sum_bound(gd)).max())
    gd *= (x.double() - stats[0].double()[:, None, None]) * stats[1].double()[:, None, None]
    sum_share = max(sum_share, float(((dscale.double() - pdscale.double()).abs()
                                      / bn_ops.batch_norm_sum_bound(gd)).max()))
    del gd
    if not sum_share <= 1:
        raise AssertionError(f"{where}: bwd_reduce + bwd_finish's dbias or dscale off the "
                             f"plain sums by {sum_share:.3g} of their summation-order bound")
    sdx, _, _, sg = bn_ops.batch_norm_backward_reference(dy, x, y, stats, scale,
                                                         sums=(dbias, dscale))
    if not torch.equal(bits(dx), bits(sdx)) or (
            with_residual and not (torch.equal(bits(g), bits(sg))
                                   and torch.equal(bits(g), bits(pg)))):
        raise AssertionError(f"{where}: bwd_dx differs from the plain formula on its sums")
    del sdx, sg, pg
    bwd_err = float((dx.float() - pdx.float()).abs().max())
    bwd_lim = 2.0 ** -7 * float(pdx.float().abs().max())
    del pdx
    if not bwd_err <= bwd_lim:
        raise AssertionError(f"{where}: dx is {bwd_err:.4g} off the plain formula's, over one "
                             f"bf16 ulp of the largest dx ({bwd_lim:.4g})")
    line = (f"{where} bf16, ReLU fused: statistics at {stat_share:.3g} and dbias/dscale at "
            f"{sum_share:.3g} of their summation-order bounds, apply and bwd_dx bit for bit "
            f"the plain formulas on them; against the plain composite: output {fwd_err:.4g} "
            f"(limit {fwd_lim:.4g}), dx {bwd_err:.4g} (limit {bwd_lim:.4g})")
    return {"x": x, "dy": dy, "scale": scale, "bias": bias, "rm": rm, "rv": rv, "fwd": fwd,
            "bwd": bwd, "fwd_err": fwd_err, "bwd_err": bwd_err}, line


def phase_batchnorm_kernels(device, rate, cases=BN_CASES):
    """The BatchNorm kernels' forward triple (stats, finish, apply) and
    backward triple (bwd_reduce, bwd_finish, bwd_dx), each case of
    ``cases`` held to the plain versions (:func:`bn_case`); the first case
    (``bn_init``'s, the largest) timed beside two byte bounds at ``rate``:
    the two-pass design's (forward: x read twice, y written; backward: dy,
    y and x read twice, dx written) and the one-pass floor (each input read
    once, the output written once), the per-channel partials left out;
    beside the plain composite's forward and its autograd backward, and
    ``F.batch_norm`` (the library yardstick: the port never calls it).
    Returns the two rows of the kernels JSON line (``launches`` filled in
    from the main path's counts) and the phase's lines."""
    lines = []
    for shape, with_residual in cases[1:]:
        lines.append(bn_case(device, shape, with_residual, seed=len(lines) + 1)[1])
        torch.cuda.empty_cache()
    case, line = bn_case(device, *cases[0])
    lines.insert(0, line)
    x, dy, rm, rv = case["x"], case["dy"], case["rm"], case["rv"]
    ms_fwd, ms_bwd = time_ms(case["fwd"], device), time_ms(case["bwd"], device)
    xg, sg, bg = (t.detach().requires_grad_(True) for t in (x, case["scale"], case["bias"]))
    plain_fwd = lambda: bn_ops.batch_norm_reference(xg, sg, bg, rm, rv, True, relu=True)
    plain_fwd_ms = time_ms(plain_fwd, device, iters=3, warmup=1)
    out = plain_fwd()
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(out, (xg, sg, bg), dy, retain_graph=True),
                           device, iters=3, warmup=1)
    del out
    lib_fwd = lambda: F.relu(F.batch_norm(xg, rm, rv, sg, bg, True, 0.1, 1e-5))
    lib_fwd_ms = time_ms(lib_fwd, device)
    out = lib_fwd()
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(out, (xg, sg, bg), dy, retain_graph=True),
                         device)
    del out, xg

    n, c, h, w = x.shape
    elems, size = x.numel(), x.element_size()
    rows = []
    for name, ms, plain_ms, lib_ms, moved, least, err, kernels_, design in (
        ("batchnorm_fwd", ms_fwd, plain_fwd_ms, lib_fwd_ms, 3, 2, case["fwd_err"],
         "stats + finish + apply", "two passes over x: the statistics, then the output"),
        ("batchnorm_bwd", ms_bwd, plain_bwd_ms, lib_bwd_ms, 7, 4, case["bwd_err"],
         "bwd_reduce + bwd_finish + bwd_dx",
         "two passes over dy, y and x: the sums, then dx"),
    ):
        nbytes, floor_bytes = moved * elems * size, least * elems * size
        bound, floor = nbytes / rate * 1e3, floor_bytes / rate * 1e3
        lines.append(
            f"{name} ({kernels_}) [{n * h * w}, {c}] bf16, ReLU fused: {ms:.4f} ms kernels, "
            f"{plain_ms:.4f} ms plain, {lib_ms:.4f} ms F.batch_norm (+ relu); the two-pass "
            f"design's bound {bound:.4f} ms ({nbytes / 1e9:.4f} GB, {moved * size} B an "
            f"element), {100 * bound / ms:.1f}% of it; the one-pass floor {floor:.4f} ms "
            f"({least * size} B an element), {100 * floor / ms:.1f}% of it; "
            f"{nbytes / ms / 1e6:.1f} GB/s; max abs difference from the plain composite "
            f"{err:.4g}")
        rows.append({
            "name": name, "route": "cuda", "source": "bluefog_tpu_torch/csrc/batchnorm_kernels.cu",
            "replaces": "new, replaces no TPU kernel", "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "design": design, "floor_ms": floor, "library_ms": lib_ms,
        })
    return rows, lines


def run_batchnorm_alone():
    """``python3 chip_smoke.py --phase batchnorm``: phase 17a alone; prints
    its lines and its two rows (``launches`` None: no main path ran)."""
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log("device", f"{kind}; nvidia-smi: {smi}")
    libs = _build.build(["batchnorm_kernels"])
    for line in libs["batchnorm_kernels"].with_suffix(".log").read_text().splitlines():
        if any(w in line for w in ("registers", "spill", "built in", "warning")):
            log("build", f"batchnorm_kernels: {line.strip()}")
    rows, lines = phase_batchnorm_kernels(device, memory_rate(kind))
    for line in lines:
        log("kernels", f"{line}; on {smi}")
    print(json.dumps({"kernels": rows}))
    return 0


def phase_dryrun(device, steps=3):
    """The dry run of ``__graft_entry__.dryrun_multichip`` (``DryRun``: 8
    workers as 4 machines x 2, one-peer Exp2 gossip, the hierarchical loss
    average, ``MLP(16, 10)``, ring attention) for step indices ``0 ..
    steps - 1`` on ``device``, held against the same steps on the CPU (the
    plain versions): parameters, momentum and metric within ``DRYRUN_TOL``
    of each one's largest entry, and each step's ring attention (the
    metric takes it times 0, as in the JAX body) row by row within the f32
    ``FLASH_ROW_TOL`` of the CPU's. Returns the launch counts of the run on
    ``device``, zeroed just before it and read just after."""
    finals, attns, counts, routes = {}, {}, None, None
    for which, dev in (("card", device), ("cpu", torch.device("cpu"))):
        run = DryRun(SIZE, device=dev)
        params = run.init_params()
        state = run.tx.init(params)
        metrics, attns[which] = [], []
        if which == "card":
            reset_launch_counts()
        for i in range(steps):
            params, state, metric, attn = run.step(params, state, torch.tensor([i], device=dev))
            metrics.append(metric)
            attns[which].append(attn)
        sync(dev)
        if which == "card":
            counts, routes = launch_counts(), flash.route_counts()
        finals[which] = [x.cpu() for x in (params, state, torch.cat(metrics, 1))]
        attns[which] = [a.cpu() for a in attns[which]]
    errs = {name: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for name, a, b in zip(("params", "momentum", "metric"), finals["card"], finals["cpu"])}
    attn_err = max(row_err(a, b) for a, b in zip(attns["card"], attns["cpu"]))
    attn_tol = FLASH_ROW_TOL[torch.float32]["out"]
    log("dryrun", f"{steps} steps (indices 0..{steps - 1}, one period of the one-peer Exp2 "
                  f"schedule) on {SIZE} workers ({SIZE // 2} machines x 2): metric "
                  f"{finals['card'][2][:, -1].tolist()}; against the CPU run, largest difference "
                  "over the largest entry "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + f" (limit {DRYRUN_TOL:g}); ring attention's largest row error relative "
                  f"to the row's norm over the {steps} steps {attn_err:.3g} (limit "
                  f"{attn_tol:g}); flash launches {counts}, routes "
                  f"{ {k: {r: n for r, n in v.items() if n} for k, v in routes.items()} }")
    bad = [k for k, v in errs.items() if not v <= DRYRUN_TOL]
    if not attn_err <= attn_tol:
        bad.append("ring attention")
    if bad or not all(torch.isfinite(x).all() for x in finals["card"] + attns["card"]):
        raise AssertionError(f"the dry run on the card differs from the CPU run: {errs}, "
                             f"ring attention {attn_err}")
    if device.type == "cuda" and routes["flash_fwd"]["simt"] < SIZE * steps:
        raise AssertionError(f"the dry run's ring attention launched fewer than {SIZE} simt "
                             f"forwards a step: {routes}")
    return counts


def build_long_context(device, config=None, block=LC_BLOCK, batch=LC_BATCH, seed=0):
    """The long-context path's model (bf16 compute over f32 parameters,
    ring attention over ``SIZE`` workers) and its seeded token stream,
    sharded: ``(model, tokens, targets)`` with ``[SIZE, batch, block]``
    tokens and next-token targets (a block's last target is the next
    block's first token)."""
    config = LC_CONFIG if config is None else config
    model = transformer.init_flax_like(
        TransformerLM(dtype=torch.bfloat16, attend=long_context.ring_attend(SIZE), **config),
        seed).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    stream = torch.randint(0, config["vocab"], (batch, SIZE * block + 1), generator=gen,
                           device=device)
    return (model, long_context.shard_sequence(stream[:, :-1], SIZE),
            long_context.shard_sequence(stream[:, 1:], SIZE))


def phase_long_context(device, model, tokens, targets, warmup=1, timed=2):
    """The long-context path: ``sgd(0.01, 0.9)`` steps on the whole
    sequence's mean next-token loss through ring attention; returns
    ``(launch counts, flash route counts, steps, numbers)``, the counts
    zeroed just before the steps and read just after."""
    params = dict(model.named_parameters())
    names = sorted(params)
    tx = bft.sgd(0.01, momentum=0.9)
    state = tx.init(params)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def step():
        """One step; returns ``(loss, forward+backward s, optimizer s)``."""
        t0 = time.perf_counter()
        loss = long_context.sp_global_loss(model, tokens, targets)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        sync(device)
        t1 = time.perf_counter()
        with torch.no_grad():
            tx.apply_(params, state, dict(zip(names, grads)))
        sync(device)
        return loss.item(), t1 - t0, time.perf_counter() - t1

    reset_launch_counts()
    losses, times = [], []
    for i in range(warmup + timed):
        loss, fb, opt = step()
        losses.append(loss)
        if i >= warmup:
            times.append((fb + opt, fb, opt))
    counts, routes = launch_counts(), flash.route_counts()
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else float("nan"))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"long-context: non-finite loss {losses}")
    step_s, fb_s, opt_s = (statistics.median(t[k] for t in times) for k in range(3))
    size, batch, block = tokens.shape
    numbers = {"step_s": step_s, "fb_s": fb_s, "opt_s": opt_s, "peak_gib": peak,
               "tokens_per_s": size * batch * block / step_s, "losses": losses,
               "steps": [t[0] for t in times]}
    log("train", f"long-context: TransformerLM {model.dim} wide, {model.heads} heads, "
                 f"{model.layers} layers, {batch} sequences of {size * block} tokens, each "
                 f"sharded into {size} blocks of {block} on the ring; losses "
                 f"{', '.join(f'{x:.5f}' for x in losses)}; median step {step_s:.4f} s over "
                 f"{timed} (steps {', '.join(f'{t[0]:.4f}' for t in times)} s) = "
                 f"forward+backward {fb_s:.4f} s + optimizer {opt_s:.4f} s, "
                 f"{numbers['tokens_per_s']:.1f} tokens/s, peak memory {peak:.2f} GiB; "
                 f"launches {counts} over {warmup + timed} steps, flash routes "
                 f"{ {k: {r: n for r, n in v.items() if n} for k, v in routes.items()} }")
    kernel_us = profile_once(device, "long-context", step)
    if kernel_us:
        bwd = {k: us for k, us in kernel_us.items() if "flash_bwd" in k or "flash_split" in k}
        numbers["flash_bwd_share"] = sum(bwd.values()) / sum(kernel_us.values())
        log("profile", f"long-context: the flash backward kernels (dK/dV, dQ and the "
                       f"cotangent's split) take {sum(bwd.values()) / 1e3:.1f} ms, "
                       f"{100 * numbers['flash_bwd_share']:.1f}% of the profiled step's device "
                       "time")
    return counts, routes, warmup + timed, numbers


def lc_ring_check(device, model, tokens, seed=4):
    """Block 0's ring attention at full size on its own q, k, v (the first
    sequence of the path's tokens, after the steps) against the plain
    versions of the flash kernels on the whole sequence in f32: out, dQ, dK
    and dV for a seeded bf16 cotangent, every row within the bf16
    ``FLASH_ROW_TOL`` of its norm. Returns the row errors."""
    size, batch, block = tokens.shape
    blk, captured = model.Block_0, {}
    saved = blk.attend

    def grab(q, k, v):
        captured["qkv"] = (q, k, v)
        return saved(q, k, v)

    blk.attend = grab
    try:
        with torch.no_grad():
            offsets = torch.arange(size).repeat_interleave(batch) * block
            model(tokens.reshape(size * batch, block), pos_offset=offsets)
    finally:
        blk.attend = saved
    first = lambda x: x.reshape((size, batch) + tuple(x.shape[1:]))[:, :1].detach()
    q, k, v = (first(x).requires_grad_(True) for x in captured.pop("qkv"))
    gen = torch.Generator(device=device).manual_seed(seed)
    out = ring_attention(q, k, v, causal=True)
    do = torch.randn(out.shape, generator=gen, device=device).to(out.dtype)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    whole = lambda x: x.detach().permute(1, 0, 2, 3, 4).reshape(
        (1, size * block) + tuple(x.shape[3:]))
    # the exact attention of these bf16 inputs: the plain versions on q, k,
    # v and dO upcast to f32 (the bf16 plain version's own roundings differ
    # from the ring's per-round ones by more than the kernels' limits on the
    # small rows early in the causal sequence)
    qw, kw, vw, dow = (whole(x).float() for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(qw.shape[-1])
    rout, rlse = flash.flash_fwd_reference(qw, kw, vw, True, scale)
    delta = flash.attention_delta(rout, dow)
    args = (qw, kw, vw, dow, rlse, delta, None, True, scale)
    rdk, rdv = flash.flash_bwd_dkv_reference(*args)
    rdq = flash.flash_bwd_dq_reference(*args)
    errs = {"out": row_err(whole(out), rout), "dq": row_err(whole(dq), rdq),
            "dk": row_err(whole(dk), rdk), "dv": row_err(whole(dv), rdv)}
    tol = FLASH_ROW_TOL[torch.bfloat16]
    log("train", f"long-context: block 0's ring attention over {size} blocks of {block} "
                 f"(first sequence) against the plain version on the whole {size * block}-token "
                 "sequence: largest row error relative to the row's norm "
                 + ", ".join(f"{n} {e:.3g} (limit {tol[n]:g})" for n, e in errs.items()))
    bad = [n for n, e in errs.items() if not e <= tol[n]]
    if bad:
        raise AssertionError(f"long-context ring attention differs from the plain version: {errs}")
    return errs


def phase_lse_kernels(device, lc_routes, lc_steps, lc_splits, rate, b=SIZE * LC_BATCH,
                      t=LC_BLOCK, h=LC_CONFIG["heads"], d=LC_CONFIG["dim"] // LC_CONFIG["heads"]):
    """The flash kernels' lse form at the ring block's shape (b 16, T 1024,
    16 heads of 64, bf16 q/k/v, not causal): the forward with f32 out,
    dK/dV and dQ with an f32 cotangent (split into two bf16 halves) and a
    nonzero lse cotangent, all three on ``sm90``; each held against its
    plain version (every row within the bf16 ``FLASH_ROW_TOL``), timed
    (CUDA events, mean of 10 after 2 warm-ups) beside its operation bound
    at the bf16 tensor-core rate (the reference's products: 2, 4 and 3,
    whatever the split adds), ``F.scaled_dot_product_attention`` on the
    same shape (the yardstick only) and, for the backward, the ``simt``
    kernel on the same inputs (``earlier_ms``). The split kernel is timed beside its byte bound and
    its plain version. Each entry's launches per long-context step are
    that path's measured launches on the kernel's route (``lc_routes``,
    ``lc_splits``, from ``phase_long_context``) over its ``lc_steps``
    steps. Returns ``({kernel: lse_route entry}, the split kernel's JSON
    row, lines)``."""
    q, k, v, do, dlse = flash_operands(device, b, t, h, h, d, torch.bfloat16, True, seed=2)
    scale = 1.0 / math.sqrt(d)
    out, lse = flash.flash_fwd(q, k, v, False, scale, torch.float32)
    delta = flash.attention_delta(out, do)
    args = (q, k, v, do, lse, delta, dlse, False, scale)
    route = {"flash_fwd": flash._route(q, k, v, scale=scale),
             "flash_bwd_dkv": flash._route(q, k, v, do, scale),
             "flash_bwd_dq": flash._route(q, k, v, do, scale)}
    if device.type == "cuda" and any(r != "sm90" for r in route.values()):
        raise AssertionError(f"the ring block's lse form took the routes {route}")
    # the kernels against their plain versions on these inputs
    rout, rlse = flash.flash_fwd_reference(q, k, v, False, scale, torch.float32)
    dk, dv = flash.flash_bwd_dkv(*args)
    dq = flash.flash_bwd_dq(*args)
    rdk, rdv = flash.flash_bwd_dkv_reference(*args)
    rdq = flash.flash_bwd_dq_reference(*args)
    tol = FLASH_ROW_TOL[torch.bfloat16]
    errs = {"out": row_err(out, rout), "dq": row_err(dq, rdq), "dk": row_err(dk, rdk),
            "dv": row_err(dv, rdv)}
    lse_err = float((lse - rlse).abs().max())
    bad = [n for n, e in errs.items() if not e <= tol[n]]
    if bad or not lse_err <= FLASH_LSE_TOL:
        raise AssertionError(f"the ring block's lse form differs from the plain versions: "
                             f"{errs}, lse {lse_err}")
    absdiff = lambda a, b: float((a.float() - b.float()).abs().max())
    max_abs = {"flash_fwd": max(absdiff(out, rout), lse_err),
               "flash_bwd_dkv": max(absdiff(dk, rdk), absdiff(dv, rdv)),
               "flash_bwd_dq": absdiff(dq, rdq)}
    del rout, rlse, dk, dv, dq, rdk, rdv, rdq
    calls = {"flash_fwd": lambda: flash.flash_fwd(q, k, v, False, scale, torch.float32),
             "flash_bwd_dkv": lambda: flash.flash_bwd_dkv(*args),
             "flash_bwd_dq": lambda: flash.flash_bwd_dq(*args)}
    earlier = {"flash_bwd_dkv": lambda: flash._dkv_kernel(*args, "simt"),
               "flash_bwd_dq": lambda: flash._dq_kernel(*args, "simt")}
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous().to(torch.bfloat16)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)
    o = sdpa()
    library = {"flash_fwd": time_ms(sdpa, device)}
    library["flash_bwd_dkv"] = library["flash_bwd_dq"] = time_ms(
        lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True), device)
    products = {"flash_fwd": 2, "flash_bwd_dkv": 4, "flash_bwd_dq": 3}
    shape = f"b {b}, T {t}, h {h}, d {d}, full, bf16 q/k/v, f32 out and dO, nonzero dlse"
    entries, lines = {}, []
    for name, call in calls.items():
        ms = time_ms(call, device)
        earlier_ms = (time_ms(earlier[name], device)
                      if name in earlier and device.type == "cuda" else None)
        per_step = lc_routes[name][route[name]] // lc_steps
        ops = products[name] * 2 * d * b * h * t * t
        bound = ops / BF16_RATE * 1e3
        entries[name] = {"route": route[name], "shape": shape, "ms": ms, "bound_ms": bound,
                         "bound_by": "operations", "tflops": ops / ms / 1e9,
                         "library_ms": library[name], "launches_per_step": per_step,
                         "max_abs_err": max_abs[name], "earlier_ms": earlier_ms,
                         "earlier_route": "simt" if name in earlier else None}
        was = (f", {earlier_ms:.4f} ms on simt (the earlier route; {earlier_ms / ms:.1f}x)"
               if earlier_ms is not None else "")
        lines.append(f"{name} lse form ({shape}): {ms:.4f} ms, route {route[name]}, "
                     f"{ops / ms / 1e9:.1f} TFLOP/s, bound {bound:.4f} ms "
                     f"({ops / 1e9:.1f} GFLOP at {BF16_RATE / 1e12:.0f} TFLOP/s; "
                     f"{100 * bound / ms:.2f}% of it){was}, {library[name]:.4f} ms "
                     f"scaled_dot_product_attention "
                     f"{'forward' if name == 'flash_fwd' else 'backward (dQ, dK, dV together)'}; "
                     f"{per_step} launches per long-context step on {route[name]}")
    lines.append("lse form row errors against the plain versions at the ring block: "
                 + ", ".join(f"{n} {e:.3g} (limit {tol[n]:g})" for n, e in errs.items())
                 + f"; lse abs {lse_err:.3g}")
    # the split: 4 bytes read and 4 written an element
    split_ms = time_ms(lambda: flash.split_cotangent(do), device)
    split_plain_ms = time_ms(lambda: flash.split_cotangent_reference(do), device)
    nbytes = do.numel() * 8
    split_bound = nbytes / rate * 1e3
    split_row = {
        "name": "flash_split_cotangent", "route": "cuda",
        "source": "bluefog_tpu_torch/csrc/flash_sm90.cu",
        "replaces": KERNEL_ROWS["flash_split_cotangent"], "launches": None,
        "max_abs_err": check_split(do), "ms": split_ms, "plain_ms": split_plain_ms,
        "bound_ms": split_bound, "bound_by": "bytes", "library_ms": None,
        "launches_per_step": lc_splits // lc_steps,
    }
    lines.append(f"flash_split_cotangent [{b}, {t}, {h}, {d}] f32 -> two bf16: {split_ms:.4f} ms "
                 f"kernel, {split_plain_ms:.4f} ms plain, bound {split_bound:.4f} ms "
                 f"({nbytes / 1e6:.1f} MB), {nbytes / split_ms / 1e6:.1f} GB/s, "
                 f"{100 * split_bound / split_ms:.1f}% of the bound; "
                 f"{lc_splits // lc_steps} launches per long-context step")
    return entries, split_row, lines


# (name, b, t, h, h_kv, d, causal, dtype, with_lse, offset); "main" is the
# transformer path's shape. head_dim 36 and an operand buffer shifted by
# one element (offset 1) leave rows off 16 bytes: the bf16 route then
# stages its tiles with scalar loads.
FLASH_CASES = [
    ("main", 2, 4096, 16, 16, 64, True, torch.bfloat16, False, 0),
    ("full", 2, 4096, 16, 16, 64, False, torch.bfloat16, False, 0),
    ("ragged", 1, 1000, 16, 16, 64, True, torch.bfloat16, False, 0),
    ("d96", 1, 1000, 16, 16, 96, True, torch.bfloat16, False, 0),
    ("d128", 1, 1024, 16, 16, 128, False, torch.bfloat16, False, 0),
    ("gqa", 2, 1000, 16, 4, 64, True, torch.bfloat16, False, 0),
    ("d36", 1, 300, 4, 2, 36, True, torch.bfloat16, False, 0),
    ("unaligned", 1, 300, 4, 2, 64, True, torch.bfloat16, False, 1),
    ("f32", 1, 257, 4, 2, 64, True, torch.float32, False, 0),
    ("lse", 1, 1000, 16, 4, 64, True, torch.bfloat16, True, 0),
    ("lse128", 1, 1000, 16, 16, 128, False, torch.bfloat16, True, 0),
    ("split-dv", 1, 1000, 16, 4, 64, False, torch.bfloat16, True, 0),
    ("split-dp", 1, 1000, 16, 4, 128, False, torch.bfloat16, True, 0),
    ("d256", 1, 1024, 16, 16, 256, True, torch.bfloat16, False, 0),
    ("d160f32", 1, 1000, 16, 4, 160, True, torch.float32, True, 0),
]
# The split cases (``split_operands``): an f32 cotangent whose high bf16
# halves cancel in one product, so that product is all low halves and a
# kernel without that low-half chain is off by O(1). Each holds the
# outputs named here (the lse always); the others are cancellation noise.
SPLIT_HELD = {"split-dv": ("out", "dq", "dv"), "split-dp": ("out", "dq", "dk", "dv")}

# Limits of the flash kernels against their plain versions on the same
# inputs. Each row of an output (a query's out or dQ, a key's dK or dV,
# over head_dim) is held to its own norm: the largest ``||got - want|| /
# ||want||`` over the rows, so the small rows (late causal queries, late
# keys) count as much as the large ones; only a row below ``ROW_FLOOR`` of
# the rows' root-mean-square norm is held to that floor. Each limit is
# about 3x the largest value measured over these cases and the ``-m cuda``
# tests' on an H100 (PERF.md; bf16: each side rounds its outputs to bf16,
# and the kernels round P to bf16 at a running row maximum, the plain
# version at the final one; f32: sums in another order). The lse is held
# absolutely: an error e in it is a relative error e of every probability
# recomputed from it.
FLASH_ROW_TOL = {
    torch.bfloat16: {"out": 1.6e-2, "dq": 1.6e-2, "dk": 2.2e-2, "dv": 1.2e-2},
    torch.float32: {"out": 2e-6, "dq": 2e-6, "dk": 2e-6, "dv": 2e-6},
}
# f32 above head_dim 128 (the d160f32 case: 160 columns in every score and
# 1000 queries in every dK/dV sum, where the f32 readings at head_dim <= 128
# were at most 5.85e-7) read dK 1.75e-6 and dV 1.63e-6 on an H100; its own
# limit is about 3x the larger, still far below a wrong kernel's O(1).
FLASH_ROW_TOL_F32_WIDE = 5.3e-6


def flash_row_tol(dtype, d):
    """The row limits of a flash case of ``dtype`` at head_dim ``d``."""
    if dtype == torch.float32 and d > 128:
        return dict.fromkeys(FLASH_ROW_TOL[dtype], FLASH_ROW_TOL_F32_WIDE)
    return FLASH_ROW_TOL[dtype]
FLASH_LSE_TOL = 6e-6
ROW_FLOOR = 1e-3
# The routes each case's flash_fwd, flash_bwd_dkv and flash_bwd_dq must take
# on the card (``ops/flash.py::_route``): sm90 where TMA can address every
# row of bf16 q/k/v up to head_dim 128 (the lse form's f32 cotangent as two
# bf16 halves); mma for bf16 rows off 16 bytes or above head_dim 128; simt
# for f32 operands (dK/dV and dQ always take the same route).
FLASH_ROUTES = {
    "main": ("sm90",) * 3, "full": ("sm90",) * 3, "ragged": ("sm90",) * 3,
    "d96": ("sm90",) * 3, "d128": ("sm90",) * 3, "gqa": ("sm90",) * 3,
    "d36": ("mma",) * 3, "unaligned": ("mma",) * 3, "f32": ("simt",) * 3,
    "lse": ("sm90",) * 3, "lse128": ("sm90",) * 3, "split-dv": ("sm90",) * 3,
    "split-dp": ("sm90",) * 3, "d256": ("mma",) * 3, "d160f32": ("simt",) * 3,
}


def flash_operands(device, b, t, h, h_kv, d, dtype, with_lse, seed=0, offset=0):
    """q, k, v split from one fused ``[b, t, (h + 2 h_kv) d]`` projection
    (strided views, as the model gives them; ``offset`` elements into their
    buffer), the output cotangent in the output's dtype (f32 for the lse
    form) and the lse cotangent (lse form only, else None)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    width = (h + 2 * h_kv) * d
    flat = torch.randn(offset + b * t * width, generator=gen, device=device).to(dtype)
    qkv = flat[offset:].view(b, t, width)
    q, k, v = (x.reshape(b, t, -1, d) for x in qkv.split([h * d, h_kv * d, h_kv * d], -1))
    do = torch.randn(b, t, h, d, generator=gen, device=device).to(
        torch.float32 if with_lse else dtype)
    dlse = torch.randn(b, h, t, generator=gen, device=device) if with_lse else None
    return q, k, v, do, dlse


def split_exact(x):
    """``x`` (f32) moved to the nearest value that is the exact sum of its
    two bf16 halves (``hi + lo``, each rounded as ``split_cotangent``)."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def paired_cotangent(x, gen):
    """``(x, -bf16(x) + e)``, f32, with ``|e| < 2^-11 |bf16(x)|``: ``e`` is
    below half a bf16 step of ``bf16(x)``, so the second's high half is
    exactly ``-bf16(x)`` and the two high halves cancel; the pair's sum
    ``x - bf16(x) + e`` lives in the low halves. Both are ``split_exact``,
    so the split carries that sum exactly and a case reads the low-half
    chains and the kernels' own bf16 roundings. With arbitrary f32 pairs
    the low halves carry the sum to 8 bits (dO's 2^-17 is 2^-8 of a sum
    2^-9 its size), and split-dp's dQ read 0.0154 of its 0.016 limit on an
    H100, the same as a PyTorch composite of the kernel's products on the
    same inputs: the design's precision, which the lse cases, the ring
    check and tests/test_torch_flash_split.py hold."""
    x = split_exact(x)
    hx = x.to(torch.bfloat16).float()
    e = (torch.rand(x.shape, generator=gen, device=x.device) * 2 - 1) * 2.0 ** -11 * (
        1 - 2.0 ** -7) * hx.abs()
    return x, split_exact(e - hx)


def split_operands(device, name, b, t, h, h_kv, d, seed=0):
    """q, k, v (views of one fused bf16 projection, as ``flash_operands``),
    an f32 cotangent and no lse cotangent for a split case:

    - ``split-dv``: query rows 2m and 2m + 1 share their q, so their rows of
      P are equal and ``dV = P^T dO`` sums their dO rows, a pair of
      ``paired_cotangent``: the high halves cancel in ``P_hi^T hi`` and dV
      is all ``P_hi^T lo`` (``P_lo^T hi`` cancels too). dK sums the pair's
      dS rows against one q, which cancel below bf16's rounding of dS on
      both sides, so it is noise and not held; dQ (a row of dS against K)
      is held.
    - ``split-dp``: V's columns 2c and 2c + 1 are equal in every row, and
      every dO row's columns 2c and 2c + 1 a pair: ``hi V^T`` is exactly 0,
      and O has the same paired columns, so ``dP - delta`` is all ``lo
      V^T``; a kernel without that chain is off by O(1) in dS, dK and dQ."""
    q, k, v, _do, _dlse = flash_operands(device, b, t, h, h_kv, d, torch.bfloat16, True, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.empty(b, t, h, d, device=device)
    if name == "split-dv":
        q[:, 1::2] = q[:, 0::2]  # in the fused buffer
        x = torch.randn(b, t // 2, h, d, generator=gen, device=device)
        do[:, 0::2], do[:, 1::2] = paired_cotangent(x, gen)
    elif name == "split-dp":
        v[..., 1::2] = v[..., 0::2]
        x = torch.randn(b, t, h, d // 2, generator=gen, device=device)
        do[..., 0::2], do[..., 1::2] = paired_cotangent(x, gen)
    else:
        raise ValueError(f"no split case {name!r}")
    return q, k, v, do, None


def row_err(got, want, floor=ROW_FLOOR):
    """Largest ``||got - want|| / ||want||`` over the rows (the last axis),
    each row's norm floored at ``floor`` times the rows' root-mean-square
    norm: a row that cancels to rounding noise (causal dQ of the first
    query, whose ``dS = P (dP - delta)`` is 0 in exact arithmetic) is held
    to that floor, not to its own noise. An all-zero ``want`` must be
    matched exactly."""
    want = want.float()
    diff = (got.float() - want).norm(dim=-1)
    norm = want.norm(dim=-1)
    denom = norm.clamp_min(floor * float(norm.square().mean().sqrt()))
    rel = torch.where(denom > 0, diff / denom, torch.where(diff > 0, math.inf, 0.0))
    return float(rel.max())


def with_poisoned_tail(x, value, n=256):
    """``x`` copied to the front of a longer buffer whose last ``n`` elements
    hold ``value``: a kernel that reads past the end of ``x`` meets them."""
    buf = torch.full((x.numel() + n,), value, dtype=x.dtype, device=x.device)
    buf[:x.numel()] = x.flatten()
    return buf[:x.numel()].view(x.shape)


def check_flash_case(device, case):
    """The three kernels against their plain versions on one case, each
    output row held to ``flash_row_tol`` of its own norm and the lse to
    ``FLASH_LSE_TOL``; returns ``{kernel: max abs difference}``. The
    backward's per-row vectors lie in front of poisoned tails (lse a huge
    negative number, delta and dlse NaN), so a kernel that reads the rows
    past t of the last head without masking them gives NaN."""
    name, b, t, h, h_kv, d, causal, dtype, with_lse, offset = case
    if name in SPLIT_HELD:
        q, k, v, do, dlse = split_operands(device, name, b, t, h, h_kv, d)
    else:
        q, k, v, do, dlse = flash_operands(device, b, t, h, h_kv, d, dtype, with_lse,
                                           offset=offset)
    held = SPLIT_HELD.get(name, ("out", "dq", "dk", "dv")) + ("lse",)
    scale = 1.0 / math.sqrt(d)
    out_dtype = torch.float32 if with_lse else dtype
    before = flash.route_counts()
    out, lse = flash.flash_fwd(q, k, v, causal, scale, out_dtype)
    rout, rlse = flash.flash_fwd_reference(q, k, v, causal, scale, out_dtype)
    # both backward versions take the plain forward's out and lse
    delta = with_poisoned_tail(flash.attention_delta(rout, do), math.nan)
    if dlse is not None:
        dlse = with_poisoned_tail(dlse, math.nan)
    args = (q, k, v, do, with_poisoned_tail(rlse, -1e30), delta, dlse, causal, scale)
    dk, dv = flash.flash_bwd_dkv(*args)
    dq = flash.flash_bwd_dq(*args)
    rdk, rdv = flash.flash_bwd_dkv_reference(*args)
    rdq = flash.flash_bwd_dq_reference(*args)
    sync(device)
    after = flash.route_counts()
    routes = tuple(next((r for r in flash.ROUTES if after[k][r] > before[k][r]), "plain")
                   for k in FLASH_KERNELS)
    if device.type == "cuda" and name in FLASH_ROUTES and routes != FLASH_ROUTES[name]:
        raise AssertionError(f"flash[{name}]: {', '.join(FLASH_KERNELS)} took the routes "
                             f"{routes}, not {FLASH_ROUTES[name]}")
    if not torch.equal(torch.isneginf(lse), torch.isneginf(rlse)):
        raise AssertionError(f"flash[{name}]: lse is -inf on other rows than the plain version's")
    finite = torch.isfinite(rlse)
    errs = {"out": row_err(out, rout), "dq": row_err(dq, rdq), "dk": row_err(dk, rdk),
            "dv": row_err(dv, rdv),
            "lse": float((lse[finite] - rlse[finite]).abs().max())}
    limits = {**flash_row_tol(dtype, d), "lse": FLASH_LSE_TOL}
    log("flash-parity", f"{name} (b {b}, T {t}, h {h}/{h_kv}, d {d}, "
                        f"{'causal' if causal else 'full'}, {str(dtype)[6:]}"
                        f"{', lse form' if with_lse else ''}"
                        f"{f', offset {offset}' if offset else ''}; routes "
                        f"{', '.join(routes)}): largest row error "
                        "relative to the row's norm "
                        + ", ".join(f"{key} {errs[key]:.3g} "
                                    + (f"(limit {limits[key]:g})" if key in held else "(not held)")
                                    for key in ("out", "dq", "dk", "dv"))
                        + f"; lse abs {errs['lse']:.3g} (limit {FLASH_LSE_TOL:g})")
    bad = [key for key in held if not errs[key] <= limits[key]]
    if bad:
        raise AssertionError(f"flash[{name}]: {bad} differ from the plain versions: {errs}")
    absdiff = lambda a, b: float((a.float() - b.float()).abs().max())
    return {"flash_fwd": max(absdiff(out, rout), absdiff(lse[finite], rlse[finite])),
            "flash_bwd_dkv": max(absdiff(dk, rdk), absdiff(dv, rdv)),
            "flash_bwd_dq": absdiff(dq, rdq)}


def phase_flash_parity(device, cases=FLASH_CASES):
    """Every case of ``cases``; returns the max abs differences of the
    first (the main path's shape)."""
    errs = [check_flash_case(device, case) for case in cases]
    return errs[0]


def phase_flash_kernels(device, errs, rate, b=LM_BATCH, t=LM_SEQ, h=LM_CONFIG["heads"],
                        d=LM_CONFIG["dim"] // LM_CONFIG["heads"]):
    """The flash kernels at the transformer path's shape (causal bf16, q/k/v
    split from the fused projection), timed beside their operation bound,
    their plain versions and ``F.scaled_dot_product_attention`` (forward on
    the forward's row; its backward, which gives dQ, dK and dV together, on
    both backward rows) and the ``mma`` route's kernel on the same inputs
    (``earlier_ms``); returns ``(rows, lines)``."""
    q, k, v, do, _ = flash_operands(device, b, t, h, h, d, torch.bfloat16, False, seed=1)
    scale = 1.0 / math.sqrt(d)
    out, lse = flash.flash_fwd(q, k, v, True, scale)
    delta = flash.attention_delta(out, do)
    args = (q, k, v, do, lse, delta, None, True, scale)
    # the route each kernel's row times, its source and design, and the
    # mma.sync kernel of the same function
    route = {"flash_fwd": flash._route(q, k, v, scale=scale),
             "flash_bwd_dkv": flash._route(q, k, v, do, scale),
             "flash_bwd_dq": flash._route(q, k, v, do, scale)}
    earlier = {
        "flash_fwd": lambda: flash._fwd_kernel(q, k, v, True, scale, q.dtype, "mma"),
        "flash_bwd_dkv": lambda: flash._dkv_kernel(*args, "mma"),
        "flash_bwd_dq": lambda: flash._dq_kernel(*args, "mma"),
    }
    calls = {
        "flash_fwd": (lambda: flash.flash_fwd(q, k, v, True, scale),
                      lambda: flash.flash_fwd_reference(q, k, v, True, scale)),
        "flash_bwd_dkv": (lambda: flash.flash_bwd_dkv(*args),
                          lambda: flash.flash_bwd_dkv_reference(*args)),
        "flash_bwd_dq": (lambda: flash.flash_bwd_dq(*args),
                         lambda: flash.flash_bwd_dq_reference(*args)),
    }
    # the library call on [b, h, t, d] copies of the same inputs
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    o = sdpa()
    library = {"flash_fwd": time_ms(sdpa, device)}
    library["flash_bwd_dkv"] = library["flash_bwd_dq"] = time_ms(
        lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True), device)
    # (query, key) pairs the causal mask keeps; a product over them is
    # 2 d operations per pair: S = Q K^T and O = P V forward; S, dP = dO
    # V^T, dV = P^T dO and dK = dS^T Q for dK/dV; S, dP and dQ = dS K for dQ
    pairs = b * h * t * (t + 1) // 2
    products = {"flash_fwd": 2, "flash_bwd_dkv": 4, "flash_bwd_dq": 3}
    # bytes: every input read once, every output written once
    tile = b * t * h * d * 2
    row = b * h * t * 4
    nbytes = {"flash_fwd": 4 * tile + row,  # q, k, v -> out, lse
              "flash_bwd_dkv": 6 * tile + 2 * row,  # q, k, v, dO, lse, delta -> dK, dV
              "flash_bwd_dq": 5 * tile + 2 * row}  # q, k, v, dO, lse, delta -> dQ
    if any(r != "sm90" for r in route.values()):
        raise AssertionError(f"the transformer's shape did not take the sm90 route: {route}")
    rows, lines = [], []
    for name, (kernel, plain) in calls.items():
        ms = time_ms(kernel, device)
        earlier_ms = (time_ms(earlier[name], device)
                      if name in earlier and device.type == "cuda" else None)
        plain_ms = time_ms(plain, device, iters=3, warmup=1)
        ops = products[name] * 2 * d * pairs
        t_ops, t_bytes = ops / BF16_RATE * 1e3, nbytes[name] / rate * 1e3
        bound = max(t_ops, t_bytes)
        was = (f"{earlier_ms:.4f} ms on the mma route ({ops / earlier_ms / 1e9:.1f} TFLOP/s), "
               if earlier_ms is not None else "")
        lines.append(
            f"{name} (b {b}, T {t}, h {h}, d {d}, causal, bf16): {ms:.4f} ms kernel, route "
            f"{route[name]} ({ops / ms / 1e9:.1f} TFLOP/s), {was}{plain_ms:.4f} ms plain, "
            f"{library[name]:.4f} ms scaled_dot_product_attention "
            f"{'forward' if name == 'flash_fwd' else 'backward (dQ, dK, dV together)'}, "
            f"bound {bound:.4f} ms ({ops / 1e9:.1f} GFLOP at {BF16_RATE / 1e12:.0f} TFLOP/s; "
            f"{nbytes[name] / 1e6:.1f} MB: {t_bytes:.4f} ms), {100 * bound / ms:.1f}% of the bound")
        sm90 = route[name] == "sm90"
        rows.append({
            "name": name, "route": "cuda",
            "source": f"bluefog_tpu_torch/csrc/{'flash_sm90' if sm90 else 'flash_kernels'}.cu",
            "replaces": KERNEL_ROWS[name], "launches": None,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library[name],
            "design": "wgmma+tma" if sm90 else "mma.sync", "earlier_ms": earlier_ms,
        })
    return rows, lines


# Faults planted in scratch copies of csrc/flash_sm90.cu (``--planted-faults``):
# (name, text of the source, its faulty replacement, flash-parity cases run).
# Each must fail ``check_flash_case`` on some case.
PLANTED_FAULTS = [
    ("consumer reads a K/V stage one phase early (mbarrier parity)",
     "mbar_wait(&full[st], (kt / kStages) & 1);",
     "mbar_wait(&full[st], ((kt / kStages) & 1) ^ 1);",
     ("main", "ragged", "d128")),
    ("dK/dV walk starts one Q tile late",
     "const int qt0 = a.causal ? k0 / BM : 0;",
     "const int qt0 = (a.causal ? k0 / BM : 0) + 1;",
     ("main", "ragged", "gqa")),
    ("lse, delta and dlse rows past t left unmasked in dK/dV",
     "const float lse = ok ? a.lse[base + row] : -INFINITY;",
     "const float lse = a.lse[base + row];",
     ("ragged", "gqa")),
    ("K tile 1 skipped in the forward",
     "fwd_softmax(s, pn, m_run, l_run, corr, a, kt * BN, row_lo, masked(kt));",
     "fwd_softmax(s, pn, m_run, l_run, corr, a, kt * BN, row_lo, masked(kt));\n"
     "      if (kt == 1) for (int i = 0; i < BN / 4; ++i) pn[i] = 0u;",
     ("main", "ragged", "d128")),
    ("dQ walk stops one K tile short of the diagonal",
     "const int n_kt = a.causal ? min(all, (q0 + BM + BN - 1) / BN) : all;",
     "const int n_kt = a.causal ? min(all, (q0 + BM + BN - 1) / BN - 1) : all;",
     ("main", "ragged", "gqa")),
    ("dQ's causal mask left off the diagonal tiles",
     "return (a.causal && j * BN + BN - 1 > q0 + 64 * wg) || (j * BN + BN > a.t);",
     "return j * BN + BN > a.t;",
     ("main", "ragged", "d96")),
    ("dQ's lse, delta and dlse read one row off",
     "const int vrow = row_lo + 8 * r;",
     "const int vrow = row_lo + 8 * r + 1;",
     ("main", "ragged", "gqa")),
    ("dV's P_hi^T lo chain dropped (split cotangent)",
     "wgmma_rs<DP>(dv, &pa[4 * kk], desc_sw128(l_st + kk * 16 * kRowBytes, kQPanel), 1);",
     "(void)l_st;",
     ("split-dv",)),
    ("dK/dV's dP^T without dO's low half (split cotangent)",
     "wgmma_ss<BM>(dp, desc_sw128(v_rows + off, 16), desc_sw128(l_st + qoff, 16), 1);",
     "(void)off;\n          (void)qoff;",
     ("split-dp",)),
    ("dQ's dP without dO's low half (split cotangent)",
     "if constexpr (kSplit) dq_issue_rows<DP, BN>(acc, l_rows, v_st, true);",
     "(void)l_rows;",
     ("split-dp",)),
]


def run_fault_cases(names):
    """flash-parity's cases ``names`` on this checkout's kernels; prints one
    JSON line per case: ``{"case", "passed", "errors"}``."""
    device = torch.device("cuda")
    for case in [c for c in FLASH_CASES if c[0] in names]:
        try:
            check_flash_case(device, case)
            print(json.dumps({"case": case[0], "passed": True, "errors": None}), flush=True)
        except torch.OutOfMemoryError:
            raise  # the copies that share the card, not the fault
        except (AssertionError, RuntimeError) as e:  # a wrong row, or a CUDA error
            print(json.dumps({"case": case[0], "passed": False,
                              "errors": f"{type(e).__name__}: {str(e)[:300]}"}), flush=True)


def planted_faults(root="build/faults"):
    """Each fault of ``PLANTED_FAULTS`` in its own copy of the package under
    ``root`` (built and run there, four copies at a time, so their plain
    versions fit on the card together); fails unless every fault fails
    flash-parity on some case. Returns the result lines."""
    import shutil

    at_once = 4
    src = os.path.dirname(os.path.abspath(__file__))
    jobs = []
    for i, (name, old, new, cases) in enumerate(PLANTED_FAULTS):
        copy = os.path.join(src, root, f"fault{i}")
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(os.path.join(src, "bluefog_tpu_torch"),
                        os.path.join(copy, "bluefog_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(src, "chip_smoke.py"), copy)
        cu = os.path.join(copy, "bluefog_tpu_torch", "csrc", "flash_sm90.cu")
        text = open(cu).read()
        if text.count(old) != 1:
            raise AssertionError(f"fault {name!r}: its text is not once in flash_sm90.cu")
        open(cu, "w").write(text.replace(old, new))
        cmd = [sys.executable, "-c", "import chip_smoke as cs; cs.run_fault_cases(%r)" % (cases,)]
        jobs.append((name, cmd, copy))
    finished = []
    for first in range(0, len(jobs), at_once):
        procs = [(name, subprocess.Popen(cmd, cwd=copy, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
                 for name, cmd, copy in jobs[first:first + at_once]]
        for name, proc in procs:
            out, _ = proc.communicate(timeout=900)
            finished.append((name, proc.returncode, out))
    lines, missed = [], []
    for name, returncode, out in finished:
        if "OutOfMemoryError" in out:
            raise AssertionError(f"fault {name!r}: the card ran out of memory: {out[-600:]}")
        results = [json.loads(l) for l in out.splitlines() if l.startswith('{"case"')]
        caught = [r for r in results if not r["passed"]]
        if returncode != 0:
            caught.append({"case": "-", "errors": f"exit {returncode}: {out[-600:]}"})
        for r in results:
            lines.append(f"{name}: {r['case']} {'passed' if r['passed'] else 'FAILED'}"
                         f"{'' if r['passed'] else ': ' + r['errors']}")
        if returncode != 0:
            lines.append(f"{name}: exit {returncode}: {out[-600:]}")
        if not caught:
            missed.append(name)
    for line in lines:
        log("faults", line)
    if missed:
        raise AssertionError(f"planted faults that flash-parity did not catch: {missed}")
    return lines


def run_health_relay_alone():
    """``python3 chip_smoke.py --phase health-relay``: phase 11d alone on the
    full-width ResNet50 at ``PATH_TRAINER``'s depth (the wire kernels built
    first); its gates as in the whole run, its lines and the launch counts
    of its parts. Prints no result line."""
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    _build.build(["wire_kernels"])
    _build.wire_library()
    bft.init(size=SIZE)
    sm, images, labels = build_trainer(device, **PATH_TRAINER)
    t0 = time.perf_counter()
    counts, _numbers = phase_health_relay(device, sm, images, labels, smi=smi)
    for path in ("health relay a", "health relay b"):
        missing = [k for k in PATH_KERNELS[path] if counts[path][k] == 0]
        if missing:
            raise AssertionError(f"the {path} path launched no {missing} kernel: {counts[path]}")
    log("health-relay", f"phase in {time.perf_counter() - t0:.1f} s")
    return 0


def run_federation_slo_alone():
    """``python3 chip_smoke.py --phase federation-slo``: phase 11e alone on the
    full-width ResNet50 at ``PATH_TRAINER``'s depth (the wire kernels built
    first); its gates as in the whole run, its lines and the launch counts
    of its parts. Prints no result line."""
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    _build.build(["wire_kernels"])
    _build.wire_library()
    bft.init(size=SIZE)
    sm, images, labels = build_trainer(device, **PATH_TRAINER)
    t0 = time.perf_counter()
    counts, _numbers = phase_federation_slo(device, sm, images, labels, smi=smi)
    for path in ("federation", "slo canary"):
        missing = [k for k in PATH_KERNELS[path] if counts[path][k] == 0]
        if missing:
            raise AssertionError(f"the {path} path launched no {missing} kernel: {counts[path]}")
    log("federation-slo", f"phase in {time.perf_counter() - t0:.1f} s")
    return 0


def run_autotune_alone():
    """``python3 chip_smoke.py --phase autotune``: phase 11f alone on the
    full-width ResNet50 at ``PATH_TRAINER``'s depth (the wire kernels built
    first); its gates as in the whole run, its lines and its launch counts.
    Prints no result line."""
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    _build.build(["wire_kernels"])
    _build.wire_library()
    bft.init(size=SIZE)
    sm, images, labels = build_trainer(device, **PATH_TRAINER)
    t0 = time.perf_counter()
    counts, _numbers = phase_autotune(device, sm, images, labels, smi=smi)
    missing = [k for k in PATH_KERNELS["autotune"] if counts[k] == 0]
    if missing:
        raise AssertionError(f"the autotune path launched no {missing} kernel: {counts}")
    log("autotune", f"phase in {time.perf_counter() - t0:.1f} s")
    return 0


def main():
    if sys.argv[1:2] == ["--transport-child"] and len(sys.argv) == 3:
        return run_transport_child(sys.argv[2])
    if sys.argv[1:2] == ["--transport-state-child"] and len(sys.argv) == 3:
        return run_transport_state_child(sys.argv[2])
    if sys.argv[1:2] == ["--transport-topology-child"] and len(sys.argv) == 3:
        return run_transport_topology_child(sys.argv[2])
    if sys.argv[1:2] == ["--transport-fleet-child"] and len(sys.argv) == 3:
        return run_transport_fleet_child(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--planted-faults"]:
        planted_faults()
        return 0
    if sys.argv[1:] == ["--phase", "health-relay"]:
        return run_health_relay_alone()
    if sys.argv[1:] == ["--phase", "federation-slo"]:
        return run_federation_slo_alone()
    if sys.argv[1:] == ["--phase", "autotune"]:
        return run_autotune_alone()
    if sys.argv[1:] == ["--phase", "transport"]:
        return run_transport_alone()
    if sys.argv[1:] == ["--phase", "transport-state"]:
        return run_transport_state_alone()
    if sys.argv[1:] == ["--phase", "transport-topology"]:
        return run_transport_topology_alone()
    if sys.argv[1:] == ["--phase", "transport-fleet"]:
        return run_transport_fleet_alone()
    if sys.argv[1:] == ["--phase", "scaling-trace"]:
        return run_scaling_trace_alone()
    if sys.argv[1:] == ["--phase", "frontend"]:
        return run_frontend_alone()
    if sys.argv[1:] == ["--phase", "batchnorm"]:
        return run_batchnorm_alone()
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log("device", f"{kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
                  f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    laps, t_lap = [], [t_start]

    def lap(name):
        """Closes the phase ``name``: its seconds since the last lap."""
        now = time.perf_counter()
        laps.append(f"{name} {now - t_lap[0]:.1f}")
        t_lap[0] = now

    t0 = time.perf_counter()
    names = ["wire_kernels", "flash_kernels", "flash_sm90", "batchnorm_kernels"]
    libs = _build.build(names)
    _build.wire_library()
    _build.flash_library()
    _build.flash_sm90_library()
    _build.batchnorm_library()
    log("build", f"{', '.join(names)} built together in {time.perf_counter() - t0:.1f} s")
    for name in names:
        log("build", f"{name} -> {libs[name]}")
        for line in libs[name].with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "built in",
                                       "Performance Loss", "setmaxnreg", "warning")):
                log("build", f"{name}: {line.strip()}")

    lap("build")
    bft.init(size=SIZE)
    phase_parity(device)
    phase_consensus(device)
    phase_ef(device)
    lap("parity, consensus, ef")
    counts = {"facade": phase_facade(device, memory_rate(kind))}
    torch.cuda.empty_cache()
    lap("facade")

    sm, images, labels = build_trainer(device)
    # the ResNet50 of the phases that check the subsystems (7a, 10, 11a-11j)
    p_sm, _, _ = build_trainer(device, **PATH_TRAINER)
    if sm.n_params != RESNET50_PARAMS or sm.width != RESNET50_WIDTH:
        raise AssertionError(f"ResNet50 has {sm.n_params} parameters ({sm.width} packed), "
                             f"expected {RESNET50_PARAMS} ({RESNET50_WIDTH})")
    counts["train-step"], _tiers = phase_train_step(device, sm, images, labels, smi=smi)
    torch.cuda.empty_cache()
    lap("train-step")
    t0 = time.perf_counter()
    counts["observability"], _obs = phase_observability(device, p_sm, images, labels, smi=smi)
    log("observability", f"phase in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    lap("observability")
    trainer = Trainer(device, sm, images, labels)
    counts.update(phase_train(trainer))
    med = trainer.tiers["atc/int8"]["median"]
    log("train", f"ResNet50 x{SIZE} workers, {BATCH} images of {IMAGE}x{IMAGE} each, "
                 f"{sm.n_params} parameters per worker ({sm.width} packed); atc/int8: "
                 f"median step {med[0]:.4f} s, {SIZE * BATCH / med[0]:.1f} images/s; "
                 f"launches per path {counts}; on {smi}")
    log_tiers(trainer)
    params = trainer.params
    del trainer
    torch.cuda.empty_cache()
    lap("train")
    counts["async"], _runs = phase_async(device, p_sm, images, labels, smi=smi)
    phase_async_check(device)
    torch.cuda.empty_cache()
    lap("async, async check")
    reset_launch_counts()
    phase_checkpoint(device, p_sm, images, labels, smi=smi)
    counts["checkpoint"] = launch_counts()
    torch.cuda.empty_cache()
    lap("checkpoint")
    t0 = time.perf_counter()
    counts["elastic"], _elastic = phase_elastic(device, p_sm, images, labels, smi=smi)
    elastic_s = time.perf_counter() - t0
    lap("elastic")
    t0 = time.perf_counter()
    obsv_counts, _obsv = phase_observatories(device, p_sm, images, labels, memory_rate(kind),
                                             smi=smi)
    counts.update(obsv_counts)
    observatories_s = time.perf_counter() - t0
    lap("observatories")
    t0 = time.perf_counter()
    hr_counts, _hr = phase_health_relay(device, p_sm, images, labels, smi=smi)
    counts.update(hr_counts)
    log("health-relay", f"phase in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    lap("health-relay")
    t0 = time.perf_counter()
    fs_counts, _fs = phase_federation_slo(device, p_sm, images, labels, smi=smi)
    counts.update(fs_counts)
    log("federation-slo", f"phase in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    lap("federation-slo")
    t0 = time.perf_counter()
    counts["autotune"], _at = phase_autotune(device, p_sm, images, labels, smi=smi)
    log("autotune", f"phase in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    lap("autotune")
    tp_counts, _tp = phase_transport(device, p_sm, images, labels, smi=smi,
                                     trainer_kw=PATH_TRAINER)
    counts.update(tp_counts)
    torch.cuda.empty_cache()
    lap("transport")
    ts_counts, _ts = phase_transport_state(device, p_sm, images, labels, smi=smi,
                                           trainer_kw=PATH_TRAINER)
    counts.update(ts_counts)
    torch.cuda.empty_cache()
    lap("transport-state")
    tt_counts, _tt = phase_transport_topology(device, p_sm, images, labels, smi=smi,
                                              trainer_kw=PATH_TRAINER)
    counts.update(tt_counts)
    torch.cuda.empty_cache()
    lap("transport-topology")
    tf_counts, _tf = phase_transport_fleet(device, p_sm, images, labels, smi=smi,
                                           trainer_kw=PATH_TRAINER)
    counts.update(tf_counts)
    del p_sm
    torch.cuda.empty_cache()
    lap("transport-fleet")
    counts["scaling-trace"], _sc = phase_scaling_trace(device, sm, images, labels, smi=smi)
    torch.cuda.empty_cache()
    lap("scaling-trace")
    counts["frontend"], _fe = phase_frontend(device, sm, images, labels, smi=smi)
    del images, labels
    torch.cuda.empty_cache()
    lap("frontend")
    rows, lines = phase_kernels(device, params, memory_rate(kind))
    del sm, params
    torch.cuda.empty_cache()
    lap("kernels")

    flash_errs = phase_flash_parity(device)
    lap("flash-parity")
    sm, tokens, _ = build_lm(device)
    if sm.n_params != LM_PARAMS:
        raise AssertionError(f"TransformerLM has {sm.n_params} parameters, expected {LM_PARAMS}")
    trainer = Trainer(device, sm, tokens, tokens)
    counts["transformer"], routes, steps = phase_train_lm(trainer)
    per_step = SIZE * sm.module.layers  # attention calls per step
    short = [k for k in FLASH_KERNELS if counts["transformer"][k] < per_step * steps]
    short += [f"{k} (sm90)" for k in FLASH_KERNELS if routes[k]["sm90"] < per_step * steps]
    if short:
        raise AssertionError(f"the transformer path launched fewer than {per_step} {short} "
                             f"per step over {steps} steps: {counts['transformer']}, "
                             f"routes {routes}")
    step_s = trainer.tiers["lm atc/int8"]["median"][0]
    tokens_per_step = SIZE * LM_BATCH * LM_SEQ
    log("train", f"TransformerLM x{SIZE} workers, {LM_BATCH} x {LM_SEQ} tokens each, "
                 f"{sm.n_params} parameters per worker ({sm.width} packed); lm atc/int8: "
                 f"median step {step_s:.4f} s, {tokens_per_step / step_s:.1f} tokens/s, mfu "
                 f"{lm_flops_per_step(sm, LM_SEQ, LM_BATCH) / step_s / BF16_RATE:.4f} "
                 f"({lm_flops_per_step(sm, LM_SEQ, LM_BATCH) / 1e12:.1f} TFLOP per step at "
                 f"{BF16_RATE / 1e12:.0f} TFLOP/s); launches {counts['transformer']} over "
                 f"{steps} steps, flash routes "
                 f"{ {k: {r: n for r, n in v.items() if n} for k, v in routes.items()} }; "
                 f"on {smi}")
    log_tiers(trainer)
    lm_attention_check(sm, trainer.params, tokens)
    del trainer
    torch.cuda.empty_cache()
    lap("transformer")
    counts["zero"], _zero = phase_zero(device, sm, tokens, smi=smi)
    torch.cuda.empty_cache()
    lap("zero")
    t0 = time.perf_counter()
    counts["elastic zero"] = phase_elastic_zero(device, sm, tokens, smi=smi)
    elastic_s += time.perf_counter() - t0
    log("elastic", f"phase in {elastic_s:.1f} s (parts a, b, d-g and c)")
    lap("elastic c")
    t0 = time.perf_counter()
    counts["observatories c"] = phase_observatories_lm(device, sm, tokens, smi=smi)
    observatories_s += time.perf_counter() - t0
    log("observatories", f"phase in {observatories_s:.1f} s (parts a, b, d and c)")
    del sm, tokens
    torch.cuda.empty_cache()
    lap("observatories c")
    phase_zero_check(device)
    lap("zero check")

    counts["dryrun"] = phase_dryrun(device)
    lap("dryrun")
    model, lc_tokens, lc_targets = build_long_context(device)
    counts["long-context"], lc_routes, lc_steps, lc = phase_long_context(
        device, model, lc_tokens, lc_targets)
    per_step = SIZE * model.layers  # ring rounds x layers
    short = [f"{k} (sm90)" for k in FLASH_KERNELS if lc_routes[k]["sm90"] < per_step * lc_steps]
    if counts["long-context"]["flash_split_cotangent"] < per_step * lc_steps:
        short.append("flash_split_cotangent")
    off_route = {k: {r: n for r, n in lc_routes[k].items() if r != "sm90" and n}
                 for k in FLASH_KERNELS}
    if short or any(off_route.values()):
        raise AssertionError(f"the long-context path launched fewer than {per_step} {short} "
                             f"per step over {lc_steps} steps, or launched off sm90 "
                             f"{off_route}: routes {lc_routes}, counts {counts['long-context']}")
    lc_ring_check(device, model, lc_tokens)
    log("train", f"long-context: median step {lc['step_s']:.4f} s, {lc['tokens_per_s']:.1f} "
                 f"tokens/s, forward+backward {lc['fb_s']:.4f} s, peak {lc['peak_gib']:.2f} GiB, "
                 f"flash backward share of the profiled step "
                 f"{100 * lc.get('flash_bwd_share', float('nan')):.1f}%; on {smi}")
    del model, lc_tokens, lc_targets
    torch.cuda.empty_cache()
    lap("long-context")
    for path, kernel_names in PATH_KERNELS.items():
        missing = [k for k in kernel_names if counts[path][k] == 0]
        if missing:
            raise AssertionError(f"the {path} path launched no {missing} kernel: {counts[path]}")

    phase_examples(device, smi=smi)
    lap("examples")

    flash_rows, flash_lines = phase_flash_kernels(device, flash_errs, memory_rate(kind))
    lse_entries, split_row, lse_lines = phase_lse_kernels(
        device, lc_routes, lc_steps, counts["long-context"]["flash_split_cotangent"],
        memory_rate(kind))
    for row in flash_rows:
        row["lse_route"] = lse_entries[row["name"]]
    bn_rows, bn_lines = phase_batchnorm_kernels(device, memory_rate(kind))
    rows += flash_rows + [split_row] + bn_rows
    lines += flash_lines + lse_lines + bn_lines
    launches = {k: sum(c[k] for c in counts.values())
                for k in (*KERNEL_ROWS, "bn_stats", "bn_bwd_reduce")}
    launches.update(batchnorm_fwd=launches["bn_stats"], batchnorm_bwd=launches["bn_bwd_reduce"])
    for row in rows:
        row["launches"] = launches[row["name"]]
    for line in lines:
        log("kernels", f"{line}; on {smi}")
    lap("flash and lse kernels")
    log("done", f"all phases in {time.perf_counter() - t_start:.1f} s; seconds a phase: "
                f"{', '.join(laps)}")
    print("kernels: " + json.dumps([r["name"] for r in rows]))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
