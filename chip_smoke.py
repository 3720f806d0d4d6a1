"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the main path from ``csrc/`` (one ``nvcc``
   per source, started together) and print the build time and each
   kernel's ptxas line (registers, shared memory, spills); then the native
   CSV writer (``csrc/csv_writer.cpp``, g++);
3. hold B2 (arrival tables) against its plain torch version on the card at
   the main path's shapes (the paper fleet's S=16 streams, n=4096 entries;
   then R=32 lanes in one launch; both at n = 1, 1,024, 2,047, 2,048, 4,096
   and 4,097): key words, uniform draws, sizes, next arrivals and
   cumulative folds bitwise; time kernel (device time, and at R=32 with the
   bench's 512-step chunks) and plain version, compute the card's bound
   and the fold chain's floor;
4. (a) hold B1 (the event scan) against its plain version on the card,
   bitwise (final state leaves, key words, emissions; the largest absolute
   difference is computed and reported): the duo/single-DC loads of the CPU
   engine tests for both algorithms over 2 chunks of 300 events, then the
   paper fleet exactly as the CLI of phase (b) builds it (auto queue_cap,
   seed 123, 4,096-step chunks) over 2 chunks for both; time the kernel and
   the plain version on the paper-fleet chunks and bound the kernel by the
   bytes and operations those chunks needed; then B1's extended instance
   (carbon_cost, debug, bandit, eco and weighted routing, the cap
   controllers) the same way: the CPU tests' loads, their hour-crossing
   world (price 0 in hour 7, a DC free of carbon), and the paper fleet at
   the CLI's shape for each configuration of ``EXT_RUNS`` (2 chunks of 512
   steps, caps the fleet passes within seconds): the controllers'
   ticks and iterations equal to the plain step's, their device time per
   tick from the kernel's ``clock64`` counters;
5. (b) drive the main path through the CLI entry point
   (``distributed_cluster_gpus_tpu_torch.run_sim``) on the paper fleet (8 DCs,
   8 ingresses, 1,488 GPUs, job_cap 512, auto queue_cap) for 600 simulated
   seconds, ``default_policy`` then ``joint_nf``, then every configuration
   of ``EXT_RUNS`` (``cap_uniform``, ``cap_greedy`` with --power-cap 150000,
   ``bandit``, ``carbon_cost``, ``eco_route``, ``debug``, ``default_policy``
   with --router-weights) at run.sh's settings (``RUN_SH_ARGV``), with the
   launch counters zeroed just before each run and read just after: both
   kernels launched (the extended instance by exactly those runs),
   no synchronizing CUDA call (so no host read) made while the B1 wrapper or
   the plain step is on the stack (a second run under torch's sync debug
   mode), queue conservation, the energy integral against the CSV;
   print events/s;
6. (c) batched rollouts at the repo's bench shape (paper fleet, R=32,
   J=128, queue_cap 256, log tick 20 s; ``bench.py:328-332``), 4 chunks of
   512 steps in one launch each, both counters zeroed before the run: one
   B1 and one B2 launch per chunk, every lane bitwise equal to the
   single-lane kernel run of its key, lanes 0 and 1 equal to the plain
   engine over every chunk and in their final state, for ``default_policy``
   and ``joint_nf``, then ``bandit`` (the extended instance; lane 0 against
   the plain engine); print the aggregate events/s;
7. (d) the engine on the card against the engine on the CPU: the same small
   duo-fleet run with the same arrival tables must end in a
   bitwise-identical state and identical CSV bytes;
8. (e) profile one paper-fleet chunk on the kernel path (``torch.profiler``):
   device ops, device-to-host copies (host reads) and the device busy share
   per event;
9. (g) B1 in RL mode against the plain step, bitwise, the paper fleet as
   the chsac_af CLI builds it (2 chunks), then R=4 lanes each against its
   single-lane run; the policy's biases and kernels perturbed with seeded
   values (``perturb_policy``: flax's init, the CLI's, zeroes the biases);
   then at ``--max-gpus-per-job 128`` (8 x 128 joint actions) a 1,024-step
   chunk bitwise and the kernel's us per event;
10. (f) chsac_af's B3 (windowed p99) and B4 (policy forward and sample)
    through the standalone launch of B1's RL-mode device code, against
    their plain versions on the card, bitwise, with (g)'s perturbed policy:
    seeded rings with counts 0, 1, 4, 5, W-1, W and beyond W, seeded
    observations and masks (all but one action masked in two rows), and
    (g)'s final latency windows and one of its decisions, on which both are
    timed (device time of launches queued back to back) beside the plain
    versions and one-call PyTorch yardsticks; then B4's GPU-count head at
    n_g = 33, 64, 128 (paper fleet) and 255 (single-DC fleet), sampled and
    greedy, rows with all but one action masked, bitwise, a decision timed
    at each width beside the event scan's cluster plan;
11. (h) B6a (the replay ingest window) against ``_add_window``'s plain
    version on windows that wrap, are all or none valid, or overwrite valid
    rows, and in both layouts (``_add_window``, ``_add_scatter``) on
    windows of 1, 4,096, 8,193 and C = 200,000 rows; a 4,096-row window
    into the CLI's ring timed (device time, the wrapper's host time) in
    both layouts;
12. (i) the chsac_af CLI for 600 s on the paper fleet, warm-up above the
    run: B1, B2 and B6a launched once per chunk, no synchronizing call with
    the B1 or B6a wrapper on the stack, the replay's n_seen against the
    emitted transitions, conservation and energy as in (b);
13. (j) the learning half's kernels against their plain versions on the
    card, bitwise, at the update's published shapes: B5a (the quantile-Huber
    loss and gradient; |td| exactly at kappa and at 0), B5b (the target and
    the actor marginalization with its gradient, both critics' layouts;
    masked and all-masked heads, done in {0, 1}), B5c (clipped Adam on the
    four parameter groups in one call, with B5g's casts inside: the
    networks' gradients read as bf16, their shadows written, and with
    float32 gradients; the clip on and off, a zero gradient, steps 1 and
    1,000, the count at saturation, the Polyak target, the alpha clamp),
    B5g's own kernel (the shadows' refresh) and B6b (the replay sample on
    200,000-row
    rings: empty, full, wrapped with gaps, one valid row; batches 1, 256
    and 4,096; the key given or derived on the card from a chunk key and
    an update index), each timed beside its plain version, its bound and a
    one-call PyTorch yardstick where there is one; the update's tail (R1d)
    inside those kernels (B5a's taken action of the heads critic with its
    gradient's scatter and q_mean, B5b target's PID step and r_eff mean,
    B5b actor's entropy mean and temperature loss and gradient) bitwise
    against the plain versions, and timed as the host calls with their
    tail outputs less the same calls without; then the update's small
    fused regions, B5d (each Dense layer's product with its epilogue, a
    hidden layer's gradient fused into the dX product, a top layer's
    standalone backward; the one-hot critic's first layer building its
    input rows, B5e, inside its product; the actor's two heads with their
    masked log-softmax, B5f's forward, in one launch), B5f's backward fused
    with the heads' top-layer backward and
    each called with the inputs one eager
    update at the published shape gave it (recorded at the call; the
    all-actions layers' 16,384 rows, the heads critic's 2,048-wide output
    from a second, heads-critic update), bitwise against its plain version
    (B5d's forward on the encoder's 49-wide observations: its product
    within a bf16 ulp of cuBLAS's, its epilogue bitwise), the share of
    B5d's product elements that differ from cuBLAS's per shape, and one
    update's calls timed back to back beside the plain versions, the bound
    and the library call (B5d: cuBLAS's products alone), B5d's also shape
    by shape, the two fused input layers beside the B5d launches of the
    unfused route they replace; then the widened envelope (B5b and the
    heads' backward at batches 1-4,096 and heads up to 8 x 128, B5d at 1 to
    4,096 rows, a NaN logit, one or no valid action; every fused call of
    one update at ``--rl-batch 512 --max-gpus-per-job 64``), bitwise;
14. (k) whole updates at the published shape (the learning CLI's agent,
    batch 256, a 200,000-row ring filled through B6a): one chunk of updates
    three ways from one state and key chain, as the CLI runs it (one
    update captured as a CUDA graph and replayed once per update), every
    update eager through the kernels, and the plain path: graph and eager
    bitwise in every state leaf and metric (cuBLAS deterministic), the
    plain path bitwise or within the update's parity bounds (B5d's
    products and cuBLAS's differ on the 49-wide observations), every
    path's bf16 shadows bf16 of its parameters, with the
    heads critic and the one-hot critic, at the published shape and at
    ``--rl-batch 512 --max-gpus-per-job 64``; one eager kernel-path update
    at the envelope's corner (``--rl-batch 4096 --max-gpus-per-job 128``,
    both critics) within the parity bounds of the plain path's; for the
    one-hot critic ms per update each way and profiled updates (device ops per update, busy
    share, by kind, and device us per update by kernel name) and the
    bounds of the dW products and of the update's tail; fails if a
    replayed update runs a plain-torch launch or a copy
    (``UPDATE_TORCH_OPS``: none; the chunk's own three fills,
    ``CHUNK_TORCH_OPS``, run outside the graph);
15. (l) B1 in RL mode with the weights (k) trained, one 1,024-step chunk at
    the chsac_af CLI's shape, bitwise against the plain step;
16. (m) the learning CLI: chsac_af for 600 s at the default warm-up: B1, B2
    and B6a once per chunk, every update after the first a replay of the
    one captured graph (each update kernel counted by its wrapper in the
    first, eager update and in the capture), the updates the schedule asks
    for, no synchronizing call with B1, B6a or train_steps on the stack
    apart from the capture's, metrics finite, alpha capped; then the heads
    critic for 300 s and a widened setting (``--rl-batch 300
    --max-gpus-per-job 128``, 120 s) with the same checks; B5g's kernel
    launched once a run (the new agent's shadows);
17. (n) the float64 clock's kernels (``SimParams.time_dtype`` "float64",
    csrc/event_scan64.cu and the double instances of B2, B6b and B5c)
    against their plain versions on the card, bitwise: B1's double
    instances on the paper fleet at the CLI's shape from a state bridged to
    t = 6e5 s (base ``default_policy`` and ``joint_nf``, the extended
    instance's eco_route from just before hour 7 of day 7 and cap_greedy
    with its controller firing, RL mode at 8 x 8 and 8 x 128), two chunks
    each, with their us per event beside the float32 instances' (both from
    init_state, a warm chunk each); R = 32 lanes of the double instance at
    the bench shape, each equal to its single-lane run, lanes 0-1 to the
    plain step; B2's double instance at R = 1 and 32 at the fold's edges;
    B6b's float64 draw on a 200,000-row ring; B5c's float64 bias
    corrections on the update's four groups; each timed beside its plain
    version and its bound;
18. (o) the float64 clock's main path through the CLI past the auto
    threshold (``--duration 200000`` with run.sh's training traffic, no
    inference, a 20 s log tick; no ``--time-dtype``): ``joint_nf``, then
    ``chsac_af`` learning at the default warm-up with ``learning_run``'s
    checks; the run's clock float64, every B1 and B2 launch the double
    instance, the update's B6b and B5c calls the float64 ones;
19. (p) checkpoints, resume and graceful shutdown through the CLI: chsac_af
    learning on the paper fleet at the CLI's defaults (job_cap 512, the
    published nets, batch 256, a 200,000-row ring, warm-up 1,000) with
    ``--ckpt-dir`` and a save every chunk on the float32 clock, three ways:
    uninterrupted in this process; a child process sent SIGTERM once its
    store holds the middle chunk (exit 143, ``run_summary.json``
    "interrupted"); the resume of that store to the end, here.  The resumed
    CSVs byte for byte and the final SimState, learner, ring and agent key
    bitwise against the uninterrupted run's, updates on both sides of the
    save, the update captured again after the restore, every kernel of the
    path launched in the resumed run (counts zeroed just before it); the
    same stop and resume on the float64 clock just past the auto threshold;
    ``default_policy`` in a child sent SIGTERM mid-run (exit 143, CSVs a
    strict byte prefix of the uninterrupted run's); save ms (the copy off
    the card and the store's write), restore ms, a step's and the store's
    bytes beside the card's name and power limit;
20. (q) the host loop: the main path's ``run_simulation`` pipelined (the
    CLI's path: chunk N+1 dispatched before chunk N is rendered on the
    drain's worker) against the serial loop, ``default_policy`` and
    ``joint_nf`` on the paper fleet for 600 s, turns serial, pipelined,
    pipelined, serial: the CSVs byte for byte and every final SimState leaf
    bitwise; each run's events/s, phase split (``obs.trace.PhaseTimer``),
    B1's device time and the device's busy share (the chunks' spans on the
    stream over the wall); one chunk of real emissions through the native
    CSV writer and the Python renderer, byte for byte, both timed; then the
    harness: ``eval --config 3 --duration 120`` and ``eval --config 4
    --rollouts 1 --duration 120``, B1 and B2 launched in every algorithm's
    run (B1's RL mode, B6a and the update's kernels in chsac_af's), each
    row equal field by field to ``_summarize`` of the same params run
    through ``run_sim.main``;
21. (r) the workload layer: B2's trace, ``rate_timeline`` and thinning
    families against the plain version, bitwise, on the paper fleet's 16
    streams (a trace with sizes, a periodic and a finite timeline with a
    zero-rate bin, thinning at amp 2; ``workload_doc``) at R = 1, n =
    4,096 and R = 32, n = 512, both clocks, two chunks each (the second
    from the carried cursors, clocks and folds), timed beside the plain
    version and the bound, then each family alone on the 16 streams; B1's
    signal builds against the plain step, bitwise (every leaf, the cost
    and carbon accumulators and the 16-column rows included), two
    512-event chunks each at the CLI's shape: the base instance under
    ``flash_crowd``, the extended one (``carbon_cost``, ``eco_route``,
    ``--router-weights``) under ``diurnal_flash_week``, RL mode with the
    observed timelines, the float64 build from t = 6e5 s, each beside its
    signal-free twin's us per event; the CLIs ``--workload flash_crowd
    --algo eco_route`` (3,600 s), ``--workload diurnal_flash_week --algo
    carbon_cost`` over the week (float64), ``--workload
    diurnal_flash_week --workload-observe --algo chsac_af`` (a day,
    learning) and the phase's JSON spec (1,800 s): events/s, B1's device
    time, the busy share, ``energy_cost_usd`` and ``carbon_kg``, the CSV
    header's two columns, every launch the signal build; the agent's
    ``select_action`` against the plain policy, and ``train_step`` with an
    energy budget and a power-cap constraint on the kernels against the
    plain path within the parity bounds;
22. print the card line, the kernel JSON line, then the device line.

Details go to ``smoke_out/chip_smoke.json`` (git-ignored).

Opt-in studies replace the smoke when asked for:

    python3 chip_smoke.py --b1-phases [CHECKOUT]
        B1 in both modes from an instrumented copy of the ``event_scan.cu``
        of the checkout at CHECKOUT (default: this one; ``clock64`` per
        phase of each event on thread 0): ``default_policy`` at the CLI's
        paper-fleet shape, then RL mode at the chsac_af CLI's shape, cycles
        per event by phase over three 4,096-step chunks each.
    python3 chip_smoke.py --b1-phases-signals
        B1's signal builds against their signal-free twins (``default_policy``
        under flash_crowd, ``carbon_cost`` and observed ``chsac_af`` under
        diurnal_flash_week, at the CLI's paper-fleet shape): us per event
        over 4,096-step chunks, then cycles per event by phase from the
        instrumented copies of both builds, and each phase's difference.
    python3 chip_smoke.py --b1-widths
        B1 of this checkout at every block width the kernel is built for,
        both modes at the A/B's shapes: us per event.
    python3 chip_smoke.py --b1-ab PARENT
        B1 of the checkout at PARENT (unpack it with ``git archive`` into a
        git-ignored directory) and of this one, in both modes
        (``default_policy`` and ``joint_nf`` at the CLI's shape; RL mode at
        the chsac_af CLI's shape with the seeded perturbed policy),
        alternating parent,
        change, change, parent, each in its own process: us per event;
        then the change alone at ``--max-gpus-per-job 128``, twice.
    python3 chip_smoke.py --b1-ext [OTHER]
        B1's extended instance (every configuration of ``EXT_RUNS``, phase
        (a)'s flags) beside the base instance (``default_policy``) at the
        A/B's shape, each in its own process, in turns, twice: us per event
        and the ratio to the base's (and, given a second checkout OTHER,
        to its runs, interleaved).
    python3 chip_smoke.py --b2-ab PARENT
        B2 of the checkout at PARENT and of this one, alternating as
        above: device ms per call at the CLI's shape (R = 1, n = 4,096)
        and the bench's (R = 32, n = 512).
    python3 chip_smoke.py --cells-ab PARENT
        The cells' events/s of the checkout at PARENT and of this one,
        alternating as above: the CLI's ``default_policy``, ``joint_nf``
        and ``chsac_af`` acting at the main path's settings (wall around
        ``run_sim.main``, CSVs included) and R=32 lanes at the bench
        shape, as phases (b), (i) and (c) time them.
    python3 chip_smoke.py --host-loop
        Phase (q) alone, after building B1 and B2 (and the update's
        kernels, which chsac_af's eval run launches).
    python3 chip_smoke.py --workload
        Phase (r) alone, after building what it runs (B1's builds, the
        signal-free twins' too, B2, B6a and the update's kernels); the
        phase's record in ``smoke_out/workload.json``.
    python3 chip_smoke.py --b5d-plans
        B5d's forward at the update's layer shapes with every tile and ring
        that fits: each bitwise against the plain version, device us per
        call, fastest first (the wrapper's tile plan takes the fastest).
    python3 chip_smoke.py --b5-tails
        B5a and B5b's actor term at the update's published shape, whole,
        cut short at each stage (no batch tail, a tail without its loads,
        no arrival, the launch alone; the actor's phase 1 alone) and with
        the alternatives measured against the kept design: device us per
        call, where the time of a call goes.
    python3 chip_smoke.py --update-ab PARENT [onehot|heads]
        The learning update (the one-hot critic, or the heads critic) of
        the checkout at PARENT and of this one (alternating as above, each
        in its own process): ms per replayed update, the graph's span, device ops and device us per update, B5d's
        route per call at each one-hot update shape, the learning CLI's
        events/s.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import torch

MAIN_DURATION_S = 600.0
LOG_INTERVAL_S = 1.0
ALGOS = ("default_policy", "joint_nf")
#: run.sh's traffic and log tick (its 3,600 s cut to MAIN_DURATION_S)
RUN_SH_ARGV = ("--log-interval", "20", "--inf-mode", "sinusoid", "--inf-rate",
               "6.0", "--trn-mode", "poisson", "--trn-rate", "0.02")
#: the weighted-routing runs' weights: latency s, energy J, carbon g, USD,
#: queue length
ROUTER_WEIGHTS = "1.0,0.00001,0.01,1.0,0.5"
#: the extended B1 instance's configurations, label: (algo, the flags phase
#: (a) adds to the CLI's shape on the paper fleet -- a cap the fleet passes
#: within seconds, so the controllers fire --, the flags phase (b) adds to
#: run.sh's settings: its --power-cap 150000 for the cap controllers)
EXT_RUNS = {
    "cap_uniform": ("cap_uniform", ("--power-cap", "25000"),
                    ("--power-cap", "150000")),
    "cap_greedy": ("cap_greedy", ("--power-cap", "25000"),
                   ("--power-cap", "150000")),
    "bandit": ("bandit", (), ()),
    "carbon_cost": ("carbon_cost", ("--power-cap", "25000"), ()),
    "eco_route": ("eco_route", ("--eco-objective", "cost", "--power-cap",
                                "25000"), ()),
    "debug": ("debug", ("--num_fixed_gpus", "4"), ()),
    "weighted": ("default_policy", ("--router-weights", ROUTER_WEIGHTS),
                 ("--router-weights", ROUTER_WEIGHTS)),
}
#: phase (a)'s chunks of the extended instance on the paper fleet (2 of them;
#: the caps of EXT_RUNS fire from the first seconds)
EXT_PAPER_STEPS = 512
#: the extended instance on the CPU tests' loads (tests/test_torch_algos.py,
#: tests/test_torch_cap.py; the gpu tests take every family at both block
#: widths): (B1_LOADS key, algo, SimParams fields)
EXT_LOADS = (
    ("duo", "debug", dict(num_fixed_gpus=12, fixed_freq=0.75)),
    ("single", "bandit", {}),
    ("duo", "eco_route", dict(power_cap=100.0)),
    ("duo", "cap_uniform", dict(power_cap=4000.0)),
    ("single", "cap_greedy", dict(power_cap=12000.0)),
)
#: tests/test_torch_algos.py's hour-crossing world: the duo fleet with no
#: price in hour 7 and DC 0 free of carbon, its clocks bridged to WORLD_T0
WORLD_T0 = 7 * 3600.0 - 0.25
#: the controllers' operations per slot and iteration (cap_uniform: two
#: clamped powers and the apply; cap_greedy: ~20 per ladder step of a job),
#: beside the per-DC trees each iteration sums
CTL_SLOT_OPS = {"cap_uniform": 40, "cap_greedy": 160}
RL_WARMUP = 1_000_000_000  # above any run's transitions: act, never update
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # non-tensor float32 peak, H100 SXM data sheet
SPIN_CYCLES = 100_000_000  # ~50 ms at the H100's clock: time to queue launches
#: device_ms's profiled pass: median us of each kernel it saw, by the kernel
#: name device_ms was asked for (several kernels when a call launches several)
KERNEL_US = {}
# integer ops of one threefry-2x32 block: 20 rounds of add/rotate(3)/xor
# plus 5 key injections of 4 adds and the 2 initial adds
THREEFRY_OPS = 20 * 5 + 5 * 4 + 2
BLOCKS_PER_ENTRY = 7  # 2 fold_in + split(2) + size split + 2 bit draws
SAMPLER_OPS = 60  # mantissa trick, log1p, pow/exp or erf_inv, clamps
BISECT_OPS = 30 * 14  # 30 iterations of mid, the integral (with cos), compare
# B1, per event: the head touches every slot (status, finish projection
# with its pinned product, two argmin compares, EMPTY test: ~12 ops) and the
# progress pass divides and clamps every slot (~5 ops); a DC's power sum is
# a masked pass over the P padded slots plus its tree (~2 ops per padded
# slot), redone only for a DC where a job started or finished; a log tick
# adds the 1/spu pass (~4 per slot), a dc_sum over every DC and the counts
# (~2 per slot and DC)
B1_SLOT_OPS = 17
B1_LOG_SLOT_OPS = 4
EV_FINISH, EV_LOG = 0, 3
#: profiled chunks phase (e) tries before it fails for want of device events
PROFILE_TRIES = 3
BENCH_SHAPE = dict(algo="joint_nf", duration=1e9, log_interval=20.0,
                   inf_mode="sinusoid", inf_rate=6.0, trn_mode="poisson",
                   trn_rate=0.1, job_cap=128, lat_window=512, seed=0,
                   queue_mode="ring", queue_cap=256)
B1_LOADS = {
    # the loads of tests/test_torch_engine.py: the rings fill, drain, drop
    "duo": ("duo", dict(inf_mode="poisson", inf_rate=300.0, trn_rate=0.5,
                        job_cap=6, queue_cap=2, log_interval=0.05)),
    "single": ("single", dict(inf_mode="poisson", inf_rate=4000.0, trn_rate=5.0,
                              job_cap=32, queue_cap=64, log_interval=0.02)),
    "duo_options": ("duo", dict(inf_rate=300.0, inf_amp=0.9, inf_period=2.0,
                                trn_rate=0.5, job_cap=6, queue_cap=2,
                                log_interval=0.05, policy_name="perf_first",
                                inf_priority=False, reserve_inf_gpus=4,
                                max_gpus_per_job=4, dvfs_low=0.5,
                                dvfs_high=0.9)),
}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    exe = shutil.which("nvidia-smi")
    if exe is None:
        fail("nvidia-smi not found")
    out = subprocess.run([exe, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps, runs=5, warmup=2):
    """Milliseconds per ``fn()`` call: CUDA events around ``reps`` calls in a
    row, over the count; the median of ``runs`` such runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def device_ms(fn, kernel, reps=20, runs=5):
    """(ms, profiler launches seen): device time per call of ``fn``, whose
    only device work must be one launch of ``kernel`` (a substring of the
    kernel's name).  The ``reps`` calls are queued behind a spin kernel, so
    they run back to back on the card and the CUDA events around them time
    the launches, not the wrapper's host time (``_behind_spin``); the median
    of ``runs``.  A
    profiled pass of ``reps`` calls fails on any other device op it sees;
    it records only some of many short launches (0 to 6 of 20 on an H100),
    so the count of ``kernel`` launches it saw is reported, not required."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    names = [e.name for e in dev_events]
    seen = sum(kernel in n for n in names)
    per = {}
    for e in dev_events:
        per.setdefault(e.name[:80], []).append(e.time_range.elapsed_us())
    KERNEL_US[kernel] = {k: statistics.median(v) for k, v in per.items()}
    others = sorted(set(n for n in names if kernel not in n))
    if others:
        fail(f"{reps} calls meant to launch only {kernel} ran other device "
             f"ops: {others}")
    return _queued_ms(fn, reps, runs, kernel), seen


def _behind_spin(queue, n, what):
    """Device ms per item of ``queue()``, which queues ``n`` items: CUDA
    events around them, queued behind a spin kernel so that they run back
    to back on the card and the events time the device, not the host's
    launches.  The host must finish queueing before the spin ends; where it
    did not (a host slowed by other work), the run is made again behind a
    spin twice as long, up to 16 times ``SPIN_CYCLES``, and then fails."""
    cycles = SPIN_CYCLES
    while True:
        s0, s1, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(cycles)
        s1.record()
        t0 = time.perf_counter()
        queue()
        host_ms = (time.perf_counter() - t0) * 1e3
        e.record()
        e.synchronize()
        spin_ms = s0.elapsed_time(s1)
        if host_ms < spin_ms:
            return s1.elapsed_time(e) / n
        if cycles >= 16 * SPIN_CYCLES:
            fail(f"{what}: queueing {n} calls took {host_ms:.2f} ms, longer "
                 f"than the {spin_ms:.2f} ms spin ahead of them")
        cycles *= 2


def _queued_ms(fn, reps=20, runs=5, what="timed calls"):
    """Device ms per ``fn()``: ``reps`` calls queued behind a spin kernel
    (``_behind_spin``); the median of ``runs``."""
    fn()
    torch.cuda.synchronize()

    def queue():
        for _ in range(reps):
            fn()

    return statistics.median(_behind_spin(queue, reps, what)
                             for _ in range(runs))


def bound(bytes_moved, ops):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_b = bytes_moved / H100_BYTES_PER_S
    t_o = ops / H100_F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def cli_argv(algo, out):
    """The main path's command line (phases (b) and (i)); chsac_af acts
    without learning (warm-up above the run's transitions)."""
    argv = ["--algo", algo, "--duration", str(MAIN_DURATION_S), "--out", out,
            "--log-interval", str(LOG_INTERVAL_S), "--device", "cuda", "--quiet"]
    if algo == "chsac_af":
        argv += ["--rl-warmup", str(RL_WARMUP)]
    return argv


def cli_params(algo, extra=()):
    """(fleet, params, chunk steps) exactly as the CLI builds them for the
    main path's command line with the ``extra`` flags."""
    from distributed_cluster_gpus_tpu_torch import run_sim
    from distributed_cluster_gpus_tpu_torch.configs.paper import (
        build_fleet, build_single_dc_fleet)

    a = run_sim.parse_args(cli_argv(algo, "unused") + list(extra))
    fleet = build_single_dc_fleet() if a.single_dc else build_fleet()
    return fleet, run_sim.finalize_queue_cap(run_sim.build_params(a), fleet), \
        a.chunk_steps


def max_abs_diff(a, b):
    """Largest |a - b| over two tensors of one shape; entries that compare
    equal (infinities included) and NaN against NaN count 0."""
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def state_diff(a, b):
    from distributed_cluster_gpus_tpu_torch.models.structs import leaves

    return max(max_abs_diff(x, y) for x, y in zip(leaves(a), leaves(b)))


def bound2(bytes_moved, f32_ops, bf16_ops):
    """``bound`` with operations of two types, each at its own peak."""
    t_b = bytes_moved / H100_BYTES_PER_S
    t_o = f32_ops / H100_F32_OPS_PER_S + bf16_ops / H100_BF16_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def bits_equal(a, b):
    """Bitwise equality of two float32 tensors, NaN payloads aside."""
    nan = torch.isnan(a) & torch.isnan(b)
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.where(nan, 0, a.view(torch.int32)),
        torch.where(nan, 0, b.view(torch.int32)))


def em_diff(a, b, where):
    """Fail unless two (nested) emission dicts are bitwise equal; returns
    the largest absolute difference (0.0)."""
    err = 0.0
    if set(a) != set(b):
        fail(f"{where}: emission keys {sorted(a)} vs {sorted(b)}")
    for k in a:
        if isinstance(a[k], dict):
            err = max(err, em_diff(a[k], b[k], f"{where} rl"))
            continue
        err = max(err, max_abs_diff(a[k], b[k]))
        if not torch.equal(a[k], b[k]):
            fail(f"{where}: emission {k} differs from the plain version "
                 f"(max abs {max_abs_diff(a[k], b[k]):.3g})")
    return err


class SyncCounter:
    """Counts the synchronizing CUDA calls made from Python while it is on
    (a host read is one: ``.item()``, ``.tolist()``, a copy to the host).
    torch's sync debug mode turns each into a warning raised at its calling
    line; the counter sees it while that line's stack is live, so it counts
    a call as inside a chunk when the B1 wrapper (which spans the launch),
    the plain step loop, the B6a wrapper or the agent's ``train_steps`` (a
    chunk's updates, the graph's replays among them) is on the stack, apart
    from the calls of the update's one CUDA-graph capture (``in_capture``:
    the capture synchronizes the device once before it records), and also
    counts every call by the file of its line."""

    def __enter__(self):
        from distributed_cluster_gpus_tpu_torch.kernels.event_scan import (
            event_scan)
        from distributed_cluster_gpus_tpu_torch.kernels.replay_ingest import (
            replay_ingest)
        from distributed_cluster_gpus_tpu_torch.rl.agent import CHSAC_AF
        from distributed_cluster_gpus_tpu_torch.sim.step import StepProgram

        self._chunk_code = {event_scan.__code__, StepProgram.scan_plain.__code__,
                            replay_ingest.__code__,
                            CHSAC_AF.train_steps.__code__}
        self._capture_code = CHSAC_AF._capture.__code__
        self.by_file, self.in_chunk, self.in_capture = {}, 0, 0
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._seen
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def _seen(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        self.by_file[filename] = self.by_file.get(filename, 0) + 1
        f = sys._getframe(1)
        while f is not None:
            if f.f_code is self._capture_code:
                self.in_capture += 1
                return
            if f.f_code in self._chunk_code:
                self.in_chunk += 1
                return
            f = f.f_back

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        self.total = sum(self.by_file.values())

    def count(self, *suffixes):
        return sum(n for f, n in self.by_file.items()
                   if f.replace(os.sep, "/").endswith(suffixes))


def phase_b2(report):
    from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
    from distributed_cluster_gpus_tpu_torch.parallel.rollout import batched_init
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state

    fleet, params, n = cli_params("default_policy")
    eng = Engine(fleet, params, device="cuda")
    wl = eng.workload
    S = wl.n_streams

    def args_of(st, lanes=()):
        shape = lanes + (S,)
        return (st.arr_key, st.arr_count.reshape(shape).contiguous(),
                st.next_arrival.reshape(shape).contiguous(),
                st.arr_cum.reshape(shape).contiguous(),
                st.arr_epoch.reshape(shape).contiguous(), wl.family_t, wl.sparams)

    st = init_state(params.seed, fleet, params, workload=wl, device="cuda")
    args = args_of(st)
    out = b2.arrival_tables(*args, n, with_aux=True)
    ref = b2.arrival_tables_reference(*args, n, with_aux=True)
    torch.cuda.synchronize()
    if not torch.equal(out["aux_key"], ref["aux_key"]):
        fail("B2 key words differ from the plain version")
    if not torch.equal(out["aux_u"], ref["aux_u"]):
        fail("B2 uniform draws differ from the plain version")
    max_err, max_rel = 0.0, 0.0
    for k in ("sizes", "tnext", "cum"):
        a, b = out[k], ref[k]
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            fail(f"B2 {k}: non-finite entries differ")
        fin = torch.isfinite(b)
        err = (a[fin] - b[fin]).abs()
        rel = float((err / b[fin].abs().clamp(min=1e-30)).max())
        max_err = max(max_err, float(err.max()))
        max_rel = max(max_rel, rel)
        if rel > 1e-6:
            fail(f"B2 {k}: relative error {rel:.3g} > 1e-6")
    # R=32 lanes in one launch, each against its plain version; both lane
    # counts at the fold's edges (one entry, a vector tail, whole vectors,
    # a second tile of B2_TILE)
    lanes = batched_init(fleet, params, 32, workload=wl, device="cuda")
    largs = args_of(lanes, (32,))
    for R_, a_ in ((1, args), (32, largs)):
        for n_ in (1, 1024, 2047, 2048, n, 4097):
            lout = b2.arrival_tables(*a_, n_, with_aux=True)
            lref = b2.arrival_tables_reference(*a_, n_, with_aux=True)
            torch.cuda.synchronize()
            for k in ("sizes", "tnext", "cum", "aux_key", "aux_u"):
                if not bits_equal(lout[k], lref[k]):
                    fail(f"B2 with {R_} lane(s), n = {n_}: {k} differs from "
                         "the plain version")
    # device time (calls queued back to back behind a spin) and the
    # wrapper's time per call
    ms, _ = device_ms(lambda: b2.arrival_tables(*args, n), "_kernel", reps=50)
    kernel_us = dict(KERNEL_US["_kernel"])  # each of its launches, median us
    call_ms = time_cuda(lambda: b2.arrival_tables(*args, n), reps=50)
    n_bench = 512  # the bench shape's chunk (phase (c)): S x R = 512 folds
    ms_r32 = _queued_ms(lambda: b2.arrival_tables(*largs, n_bench), reps=50)
    plain_ms = time_cuda(lambda: b2.arrival_tables_reference(*args, n), reps=1,
                         runs=3, warmup=1)
    fams = wl.family_t.tolist()
    n_active = sum(1 for f in fams if f != b2.FAM_OFF)
    n_sin = sum(1 for f in fams if f == b2.FAM_SIN_INV)
    bytes_moved = (2 * 8 + S * (4 * 5 + 16)) + 3 * S * n * 4
    ops = (n_active * n * (BLOCKS_PER_ENTRY * THREEFRY_OPS + SAMPLER_OPS)
           + n_sin * n * BISECT_OPS + S * n)
    bound_ms, bound_by = bound(bytes_moved, ops)
    # the dependent float32 fold: n adds on one thread at ~4 cycles each
    chain_ms = 4 * n / 1.755e9 * 1e3
    print(f"B2 arrival_tables S={S} n={n}: max_abs_err={max_err:.3g} "
          f"max_rel_err={max_rel:.3g}; R = 1 and 32 lanes bitwise at n = 1, "
          f"1,024, 2,047, 2,048, {n:,} and 4,097; kernel {ms:.4f} ms device "
          f"time ({call_ms:.4f} ms per wrapper call; R = 32, n = {n_bench}: "
          f"{ms_r32:.4f} ms), plain {plain_ms:.2f} "
          f"ms, bound {bound_ms:.5f} ms ({bound_by}: {bytes_moved} B, {ops} "
          f"ops), the fold chain's floor {chain_ms:.4f} ms; its launches, "
          f"median us: {kernel_us}")
    report["b2"] = {"S": S, "n": n, "max_abs_err": max_err, "max_rel_err": max_rel,
                    "ms": ms, "call_ms": call_ms, "ms_r32_bench": ms_r32,
                    "kernel_us": kernel_us,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "fold_chain_ms": chain_ms, "bytes": bytes_moved, "ops": ops}


def b1_work(eng, before, after, pre, em, n_steps):
    """(bytes, ops) one lane's chunk must move and do, counted from what this
    chunk's data needed.  Bytes: the job slab and the small state leaves
    read and written once; of the rings, the records pushed (written) and
    popped (read); one latency-window entry per finish; the table entries
    the chunk's arrivals consumed and the stream cursors; the fleet
    constants read once; the emissions written (t and branch per step, a
    cluster row per log tick, a job row per finish).  Operations: the head
    and progress passes over every slot on every event, every DC's power
    sum once at the launch and again only for a DC where a job started or
    finished, and the log ticks' passes."""
    from distributed_cluster_gpus_tpu_torch.kernels.event_scan import (
        EXT_PTRS, ext_plan, pow2_at_least)
    from distributed_cluster_gpus_tpu_torch.models.structs import (
        JobStatus, leaves)

    J, n_dc = eng.params.job_cap, eng.fleet.n_dc
    P = pow2_at_least(J)
    nbytes = lambda xs: sum(x.numel() * x.element_size() for x in xs)  # noqa: E731
    moved = lambda a, b: int((a - b).sum())  # noqa: E731
    running = lambda st: int((st.jobs.status == JobStatus.RUNNING).sum())  # noqa: E731
    events = moved(after.n_events, before.n_events)
    finishes = moved(after.n_finished, before.n_finished)
    pushes = moved(after.queues.tail, before.queues.tail)
    pops = moved(after.queues.head, before.queues.head)
    arrivals = moved(after.arr_count, before.arr_count)
    starts = running(after) - running(before) + finishes
    n_log = int((em["branch"] == EV_LOG).sum())
    slab = nbytes(leaves(before.jobs))
    # the leaves and constants the launch's instance reads (the extended
    # one also the bandit's arms, the uncapped grid, the price and carbon)
    ext = ext_plan(eng.params)[0]
    small = (nbytes(leaves(before)) - slab - nbytes([before.queues.recs])
             - nbytes([before.lat.buf])
             - (0 if ext else nbytes(leaves(before.bandit))))
    consts = [v for k, v in eng.kernel_consts().items()
              if ext or k not in EXT_PTRS]
    # a ring record is N_REC fields and a table entry a size and a next
    # arrival, each in the clock's dtype (8 bytes under the float64 clock)
    tb = before.t.element_size()
    bytes_moved = (2 * (slab + small) + 11 * tb * (pushes + pops)
                   + 4 * finishes + (4 + tb) * arrivals + nbytes([pre["c0"]])
                   + nbytes(consts)
                   + 8 * n_steps + 4 * n_log * n_dc * 14 + 4 * finishes * 15)
    ops = (events * J * B1_SLOT_OPS + (n_dc + starts + finishes) * 2 * P
           + n_log * (J * B1_LOG_SLOT_OPS + 2 * n_dc * P + 2 * n_dc * J))
    counts = {"events": events, "finishes": finishes, "starts": starts,
              "pushes": pushes, "pops": pops, "arrivals": arrivals,
              "log_ticks": n_log}
    return bytes_moved, ops, counts


def phase_b1(report):
    """(a) B1 against its plain version on the card, bitwise."""
    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.configs.paper import (
        build_duo_fleet, build_single_dc_fleet)
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.models.structs import (
        SimParams, clone_state, with_lane_axis)
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state

    fleets = {"duo": build_duo_fleet, "single": build_single_dc_fleet}
    cases = [(name, algo, fleets[fl](), SimParams(algo=algo, duration=400.0,
                                                  lat_window=64, seed=5, **kw),
              300)
             for name, (fl, kw) in B1_LOADS.items() for algo in ALGOS]
    for algo in ALGOS:
        cases.append(("paper", algo) + cli_params(algo))
    rows = []
    timing = {}
    max_err = 0.0
    for name, algo, fleet, params, n_steps in cases:
        eng = Engine(fleet, params, device="cuda")
        st = with_lane_axis(init_state(params.seed, fleet, params,
                                       workload=eng.workload, device="cuda"))
        other = clone_state(st)
        events = 0
        for c in range(2):
            pre = eng.workload.tables(st, n_steps)
            before = clone_state(st)
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            em_k, _ = b1.event_scan(eng, st, pre, n_steps)
            b.record()
            b.synchronize()
            k_ms = a.elapsed_time(b)
            t0 = time.perf_counter()
            em_r, _ = b1.event_scan_reference(eng, other, pre, n_steps)
            torch.cuda.synchronize()
            p_ms = (time.perf_counter() - t0) * 1e3
            for k in em_r:
                err = max_abs_diff(em_k[k], em_r[k])
                max_err = max(max_err, err)
                if not torch.equal(em_k[k], em_r[k]):
                    fail(f"B1 {name}/{algo} chunk {c}: emission {k} differs from "
                         f"the plain version (max abs {err:.3g})")
            eng.workload.advance_carries(st, pre)
            eng.workload.advance_carries(other, pre)
            max_err = max(max_err, state_diff(st, other))
            bad = bridge.tree_mismatches(bridge.state_to_numpy(other),
                                         bridge.state_to_numpy(st))
            if bad:
                fail(f"B1 {name}/{algo} chunk {c}: state differs from the plain "
                     f"version at {bad[:5]}")
            ev = int((st.n_events - before.n_events).sum())
            events += ev
            if name == "paper":
                by, ops, counts = b1_work(eng, before, st, pre, em_k, n_steps)
                timing.setdefault(algo, []).append(
                    {"steps": n_steps, "events": ev, "ms": k_ms, "plain_ms": p_ms,
                     "bytes": by, "ops": ops, "counts": counts,
                     "queue_cap": params.queue_cap, "seed": params.seed})
        rows.append({"load": name, "algo": algo, "events": events,
                     "queue_cap": params.queue_cap, "n_steps": n_steps,
                     "dropped": int(st.n_dropped.sum())})
    print("B1 event_scan vs plain version on the card, bitwise identical "
          f"(state, key words, emissions; max_abs_err {max_err}): " + ", ".join(
              f"{r['load']}/{r['algo']} {r['events']} events" for r in rows))
    # the paper-fleet chunks: the second chunk of each algorithm (warm)
    chunks = [timing[a][1] for a in ALGOS]
    ms = statistics.mean(c["ms"] for c in chunks)
    plain_ms = statistics.mean(c["plain_ms"] for c in chunks)
    ev = statistics.mean(c["events"] for c in chunks)
    by = statistics.mean(c["bytes"] for c in chunks)
    ops = statistics.mean(c["ops"] for c in chunks)
    bound_ms, bound_by = bound(by, ops)
    q, n_steps = chunks[0]["queue_cap"], chunks[0]["steps"]
    print(f"B1 paper fleet as the CLI runs it (queue_cap {q}, seed "
          f"{chunks[0]['seed']}), {n_steps}-step chunk ({ev:.0f} events, R=1): "
          f"kernel {ms:.3f} ms ({ms / ev * 1e3:.2f} us/event), plain "
          f"{plain_ms:.1f} ms, bound {bound_ms:.6f} ms ({bound_by}: {by:.0f} B, "
          f"{ops:.0f} ops)")
    report["b1"] = {"loads": rows, "paper_chunks": timing, "ms": ms,
                    "plain_ms": plain_ms, "events_per_chunk": ev,
                    "us_per_event": ms / ev * 1e3, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": by, "ops": ops,
                    "max_abs_err": max_err}


def world_fleet():
    """tests/test_torch_algos.py's world: the duo fleet, price 0 in hour 7,
    DC 0 of carbon intensity 0."""
    import dataclasses

    import numpy as np
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_duo_fleet

    fleet = build_duo_fleet()
    price = np.array(fleet.price_hourly, np.float32)
    price[7] = 0.0
    return dataclasses.replace(fleet, price_hourly=price,
                               carbon=np.array([0.0, 400.0], np.float32))


def phase_b1_ext(report):
    """(a) continued: B1's extended instance (carbon_cost, debug, bandit,
    eco and weighted routing, the cap controllers) against the plain step
    on the card, bitwise: the CPU tests' loads, the hour-crossing world, and
    the paper fleet as the CLI builds it for each configuration of
    ``EXT_RUNS`` (2 chunks of ``EXT_PAPER_STEPS``; the caps fire within
    seconds).
    The controllers' log ticks and iterations must be the plain step's;
    their device time per tick is their share of the launch's cycles
    (``clock64`` on the lane's thread 0) times the launch's time."""
    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.configs.paper import (
        build_duo_fleet, build_single_dc_fleet)
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.models.structs import (
        SimParams, clone_state, with_lane_axis)
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state

    fleets = {"duo": build_duo_fleet, "single": build_single_dc_fleet}
    cases = []
    for fl, algo, kw in EXT_LOADS:
        tag = " ".join(f"{k}={v}" if k != "router_weights" else "weighted"
                       for k, v in kw.items())
        cases.append((f"{fl}/{algo} {tag}".strip(), fleets[fl](), SimParams(
            algo=algo, duration=400.0, lat_window=64, seed=5,
            **B1_LOADS[fl][1], **kw), 300, None))
    for algo, kw in (("carbon_cost", {}), ("eco_route", dict(eco_objective="cost"))):
        cases.append((f"world/{algo}", world_fleet(), SimParams(
            algo=algo, duration=WORLD_T0 + 400.0, lat_window=64, seed=5,
            **B1_LOADS["duo"][1], **kw), 300, WORLD_T0))
    for label, (algo, flags, _) in EXT_RUNS.items():
        fleet, params, _ = cli_params(algo, flags)
        cases.append((f"paper/{label}", fleet, params, EXT_PAPER_STEPS, None))
    rows, paper = [], {}
    max_err = 0.0
    for name, fleet, params, n_steps, t0 in cases:
        if not b1.ext_plan(params)[0]:
            fail(f"B1 {name}: the configuration does not take the extended "
                 "instance")
        eng = Engine(fleet, params, device="cuda")
        st0 = init_state(params.seed, fleet, params, workload=eng.workload,
                         device="cuda")
        if t0 is not None:  # bridge the clocks to just before an hour
            st0.t.fill_(t0)
            st0.next_arrival += t0
            st0.next_log_t.fill_(t0 + params.log_interval)
        st = with_lane_axis(st0)
        other = clone_state(st)
        events, ctl = 0, torch.zeros(4, dtype=torch.int64)
        for c in range(2):
            pre = eng.workload.tables(st, n_steps)
            before = clone_state(st)
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            em_k, stats_k = b1.event_scan(eng, st, pre, n_steps)
            b.record()
            b.synchronize()
            k_ms = a.elapsed_time(b)
            t_0 = time.perf_counter()
            em_r, stats_r = b1.event_scan_reference(eng, other, pre, n_steps)
            torch.cuda.synchronize()
            p_ms = (time.perf_counter() - t_0) * 1e3
            for k in em_r:
                err = max_abs_diff(em_k[k], em_r[k])
                max_err = max(max_err, err)
                if not torch.equal(em_k[k], em_r[k]):
                    fail(f"B1 {name} chunk {c}: emission {k} differs from the "
                         f"plain version (max abs {err:.3g})")
            eng.workload.advance_carries(st, pre)
            eng.workload.advance_carries(other, pre)
            max_err = max(max_err, state_diff(st, other))
            bad = bridge.tree_mismatches(bridge.state_to_numpy(other),
                                         bridge.state_to_numpy(st))
            if bad:
                fail(f"B1 {name} chunk {c}: state differs from the plain "
                     f"version at {bad[:5]}")
            ck = stats_k["ctl"].cpu()[0]
            if not torch.equal(ck[:2], stats_r["ctl"][0, :2]):
                fail(f"B1 {name} chunk {c}: the controller's ticks and "
                     f"iterations {ck[:2].tolist()} differ from the plain "
                     f"step's {stats_r['ctl'][0, :2].tolist()}")
            ctl += ck
            ev = int((st.n_events - before.n_events).sum())
            events += ev
            if name.startswith("paper/") and c == 1:
                by, ops, counts = b1_work(eng, before, st, pre, em_k, n_steps)
                algo = params.algo
                if algo in CTL_SLOT_OPS:
                    P = b1.pow2_at_least(params.job_cap)
                    ops += int(ck[1]) * (params.job_cap * CTL_SLOT_OPS[algo]
                                         + 2 * fleet.n_dc * P)
                paper[name[6:]] = {
                    "steps": n_steps, "events": ev, "ms": k_ms,
                    "plain_ms": p_ms, "bytes": by, "ops": ops,
                    "counts": counts, "ctl_ticks": int(ck[0]),
                    "ctl_iters": int(ck[1]),
                    "ctl_ms": (float(ck[2]) / float(ck[3]) * k_ms
                               if int(ck[3]) > 0 else 0.0)}
        if name.startswith("paper/cap") and int(ctl[0]) == 0:
            fail(f"B1 {name}: the controller never ran")
        rows.append({"case": name, "events": events, "n_steps": n_steps,
                     "ctl_ticks": int(ctl[0]), "ctl_iters": int(ctl[1]),
                     "dropped": int(st.n_dropped.sum()),
                     "t": float(st.t.max())})
    if not any(r["ctl_iters"] > r["ctl_ticks"] > 0 for r in rows):
        fail("B1 extended instance: no controller iterated twice in a tick")
    print("B1 extended instance vs plain version on the card, bitwise "
          f"identical (state, bandit arms, emissions, controller counts; "
          f"max_abs_err {max_err}): " + ", ".join(
              f"{r['case']} {r['events']} events"
              + (f" ({r['ctl_iters']} controller iterations in {r['ctl_ticks']} "
                 "ticks)" if r["ctl_ticks"] else "") for r in rows))
    for label, c in paper.items():
        per_tick = (f"; controller {c['ctl_iters'] / c['ctl_ticks']:.2f} "
                    f"iterations and {c['ctl_ms'] / c['ctl_ticks'] * 1e3:.2f} "
                    f"us per tick over {c['ctl_ticks']} ticks"
                    if c["ctl_ticks"] else "")
        print(f"B1 extended instance, paper fleet {label} (second {c['steps']}"
              f"-step chunk, {c['events']} events): kernel {c['ms']:.3f} ms "
              f"({c['ms'] / c['events'] * 1e3:.2f} us/event), plain "
              f"{c['plain_ms']:.1f} ms{per_tick}")
    chunks = list(paper.values())
    ms = statistics.mean(c["ms"] for c in chunks)
    ev = statistics.mean(c["events"] for c in chunks)
    by = statistics.mean(c["bytes"] for c in chunks)
    ops = statistics.mean(c["ops"] for c in chunks)
    bound_ms, bound_by = bound(by, ops)
    report["b1_ext"] = {"cases": rows, "paper_chunks": paper, "ms": ms,
                        "plain_ms": statistics.mean(c["plain_ms"] for c in chunks),
                        "events_per_chunk": ev, "us_per_event": ms / ev * 1e3,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "bytes": by, "ops": ops, "max_abs_err": max_err}


def _read_csv(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


class B1Tally:
    """While on, times every B1 launch of a run with CUDA events recorded
    around it on the launch's stream and sums the extended instance's
    controller counters (``stats["ctl"]``, on the card): no host read inside
    a chunk.  ``ms()`` after the run: B1's device ms over the run."""

    def __enter__(self):
        from distributed_cluster_gpus_tpu_torch.sim import engine

        self._engine, self._orig = engine, engine.event_scan
        self.total, self.events = None, []

        def tallied(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            em, stats = self._orig(*args, **kw)
            b.record()
            self.events.append((a, b))
            if stats.get("ctl") is not None:
                c = stats["ctl"].sum(0)
                self.total = c if self.total is None else self.total + c
            return em, stats

        engine.event_scan = tallied
        return self

    def __exit__(self, *exc):
        self._engine.event_scan = self._orig

    def ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def phase_main_path(report, out_root):
    """(b) the CLI main path on the paper fleet: both base algorithms at the
    main path's settings, then every configuration of ``EXT_RUNS`` at
    run.sh's (``RUN_SH_ARGV``)."""
    from distributed_cluster_gpus_tpu_torch import run_sim
    from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1

    runs = {}
    launches = {"event_scan": 0, "arrival_tables": 0, "ext": 0}
    plan = [(algo, algo, ()) for algo in ALGOS] + [
        (label, algo, RUN_SH_ARGV + flags)
        for label, (algo, _, flags) in EXT_RUNS.items()]
    for label, algo, extra in plan:
        out = os.path.join(out_root, label)
        argv = lambda o: cli_argv(algo, o) + list(extra)  # noqa: E731
        torch.cuda.synchronize()
        b1.event_scan.launches = 0
        b1.event_scan.ext_launches = 0
        b2.arrival_tables.launches = 0
        t0 = time.perf_counter()
        with B1Tally() as tally:
            st = run_sim.main(argv(out))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b1_ms = tally.ms()
        n_b1, n_b2 = b1.event_scan.launches, b2.arrival_tables.launches
        n_ext = b1.event_scan.ext_launches
        if n_b1 <= 0:
            fail(f"{label}: the main path never launched the B1 kernel")
        if n_b2 <= 0:
            fail(f"{label}: the main path never launched the B2 kernel")
        if (n_ext == n_b1) != (label in EXT_RUNS):
            fail(f"{label}: {n_ext} of {n_b1} B1 launches took the extended "
                 "instance")
        ctl = [int(x) for x in tally.total.cpu()] if tally.total is not None else None
        # the same run again (its own output directory), counting the
        # synchronizing CUDA calls by the file that made them; the timed
        # run above goes without the counter's warnings
        with SyncCounter() as syncs:
            run_sim.main(argv(out + "_syncs"))
        in_chunk = syncs.in_chunk
        port = syncs.count(*(f"distributed_cluster_gpus_tpu_torch/{d}" for d in
                             ("sim/io.py", "sim/engine.py", "run_sim.py")))
        if port == 0:
            fail(f"{label}: the sync counter saw no sync made by the run loop, "
                 f"so it measures nothing ({syncs.by_file})")
        if in_chunk:
            fail(f"{label}: {in_chunk} synchronizing CUDA calls inside the "
                 f"chunks ({syncs.by_file})")
        launches["event_scan"] += n_b1
        launches["arrival_tables"] += n_b2
        launches["ext"] += n_ext
        events = int(st.n_events)
        arrived = int(st.jid_counter) - 1
        finished = int(st.n_finished.sum())
        queued = int((st.queues.tail - st.queues.head).sum())
        placed = int((st.jobs.status != 0).sum())
        dropped = int(st.n_dropped)
        jobs = _read_csv(os.path.join(out, "job_log.csv"))
        cl = _read_csv(os.path.join(out, "cluster_log.csv"))
        if len(jobs) != finished:
            fail(f"{label}: job_log has {len(jobs)} rows for {finished} finishes")
        if arrived != finished + queued + placed + dropped:
            fail(f"{label}: conservation broken: {arrived} arrived != "
                 f"{finished} + {queued} + {placed} + {dropped}")
        if not bool(st.done) or abs(float(st.t) - MAIN_DURATION_S) > 1e-3:
            fail(f"{label}: run did not reach its end (t={float(st.t)})")
        # energy: the growth of sum-over-DCs energy_kJ between the first and
        # last log tick against the trapezoid sum of power_W over the ticks
        # (the engine integrates P*dt exactly between events; sampled at 1 s
        # the two agree to a few percent)
        ticks = sorted({float(r["time_s"]) for r in cl})
        if len(ticks) < 2:
            fail(f"{label}: too few log ticks")
        by_t = {}
        for r in cl:
            by_t.setdefault(float(r["time_s"]), []).append(r)
        e_last = sum(float(r["energy_kJ"]) for r in by_t[ticks[-1]]) * 1e3
        e_first = sum(float(r["energy_kJ"]) for r in by_t[ticks[0]]) * 1e3
        p_t = [sum(float(r["power_W"]) for r in by_t[t]) for t in ticks]
        riemann = sum(0.5 * (p_t[i] + p_t[i + 1]) * (ticks[i + 1] - ticks[i])
                      for i in range(len(ticks) - 1))
        if not (e_last > 0 and abs((e_last - e_first) - riemann) <= 0.05 * riemann):
            fail(f"{label}: energy {e_last - e_first:.1f} J vs sum P*dt {riemann:.1f} J")
        vals = [float(v) for r in jobs for k, v in r.items()
                if k not in ("ingress", "type", "dc")]
        if not all(map(lambda x: x == x and abs(x) != float("inf"), vals)):
            fail(f"{label}: non-finite job_log values")
        rate = events / wall
        b1_us = b1_ms / max(events, 1) * 1e3
        ctl_s = ""
        if ctl is not None and ctl[0]:
            ctl_s = (f"; the cap controller ran in {ctl[0]} log ticks, {ctl[1]} "
                     f"iterations ({ctl[1] / ctl[0]:.2f} a tick)")
        elif label.startswith("cap_"):
            ctl_s = "; the fleet's power never called for the cap controller"
        print(f"{label} ({' '.join(extra) or 'main path settings'}): B1 "
              f"{b1_ms:.2f} ms on the card ({b1_us:.3f} us/event); {events} events in {MAIN_DURATION_S:.0f} s simulated, "
              f"{wall:.2f} s wall, {rate:.1f} events/s, {finished} finished, "
              f"{arrived} arrived, {dropped} dropped, B1 launches {n_b1}, "
              f"B2 launches {n_b2}; synchronizing CUDA calls: {in_chunk} inside "
              f"the {n_b1} chunks, {syncs.total} in the whole run "
              f"({syncs.total / n_b1:.1f} per chunk, between the chunks); energy "
              f"{e_last / 3.6e6:.4f} kWh at the last tick{ctl_s}")
        runs[label] = {"algo": algo, "flags": list(extra), "ctl": ctl,
                       "b1_ms": b1_ms, "b1_us_per_event": b1_us,
                       "ext_launches": n_ext, "events": events, "wall_s": wall, "events_per_s": rate,
                      "arrived": arrived, "finished": finished, "queued": queued,
                      "placed": placed, "dropped": dropped, "b1_launches": n_b1,
                      "b2_launches": n_b2, "syncs_in_chunks": in_chunk,
                      "syncs_total": syncs.total,
                      "syncs_by_file": {os.path.relpath(f): n for f, n in
                                        syncs.by_file.items()}}
    report["main_path"] = runs
    return launches


def phase_rollouts(report):
    """(c) R=32 lanes at the bench shape, one launch per chunk."""
    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_fleet
    from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.models.structs import (
        SimParams, lane_state, lane_view, unstack_states, with_lane_axis)
    from distributed_cluster_gpus_tpu_torch.parallel.rollout import batched_init
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine

    R, n_steps, n_chunks = 32, 512, 4
    fleet = build_fleet()
    out = {}
    max_err = 0.0
    for algo in ALGOS + ("bandit",):
        # bandit: the extended instance; its lane 0 against the plain engine
        plain_lanes = (0,) if algo == "bandit" else (0, 1)
        params = SimParams(**dict(BENCH_SHAPE, algo=algo))
        eng = Engine(fleet, params, device="cuda")
        st = batched_init(fleet, params, R, workload=eng.workload, device="cuda")
        singles = unstack_states(st)
        plain = [with_lane_axis(lane_state(st, r)) for r in plain_lanes]
        ems, pres = [], []
        torch.cuda.synchronize()
        b1.event_scan.launches = 0
        b2.arrival_tables.launches = 0
        walls = []  # each chunk's host wall: the first carries one-time costs
        for c in range(n_chunks):
            t0 = time.perf_counter()
            pres.append(eng.workload.tables(st, n_steps))
            st, em = eng.run_chunk(st, n_steps, pre=pres[-1])
            ems.append(em)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if c == 0:
                events_1 = int(st.n_events.sum())
        wall = sum(walls)
        n_b1, n_b2 = b1.event_scan.launches, b2.arrival_tables.launches
        if n_b1 != n_chunks or n_b2 != n_chunks:
            fail(f"rollouts/{algo}: {n_b1} B1 and {n_b2} B2 launches for "
                 f"{n_chunks} chunks of {R} lanes (one each per chunk)")
        events = int(st.n_events.sum())
        # each lane against the single-lane kernel run of its key
        for r, s in enumerate(singles):
            for c in range(n_chunks):
                s, em = eng.run_chunk(s, n_steps)
                for k, v in em.items():
                    if not torch.equal(v, ems[c][k][r]):
                        fail(f"rollouts/{algo}: lane {r} chunk {c} emission {k} "
                             "differs from its single-lane run")
            bad = bridge.tree_mismatches(bridge.state_to_numpy(lane_view(st, r)),
                                         bridge.state_to_numpy(s))
            if bad:
                fail(f"rollouts/{algo}: lane {r} differs from its single-lane "
                     f"run at {bad[:5]}")
        # those lanes against the plain engine, every chunk and the end
        for r, ps in zip(plain_lanes, plain):
            for c, pre in enumerate(pres):
                pre_r = {k: v[r:r + 1] for k, v in pre.items()}
                em_r, _ = b1.event_scan_reference(eng, ps, pre_r, n_steps)
                eng.workload.advance_carries(ps, pre_r)
                em_k = ems[c]
                pairs = [(em_r[k][0], em_k[k][r]) for k in ("t", "cluster", "job")]
                pairs += [(em_r["branch"][0] == EV_LOG, em_k["cluster_valid"][r]),
                          (em_r["branch"][0] == EV_FINISH, em_k["job_valid"][r])]
                for i, (x, y) in enumerate(pairs):
                    max_err = max(max_err, max_abs_diff(x, y))
                    if not torch.equal(x, y):
                        fail(f"rollouts/{algo}: lane {r} chunk {c} emission "
                             f"#{i} differs from the plain engine")
            max_err = max(max_err, state_diff(lane_view(ps, 0), lane_view(st, r)))
            bad = bridge.tree_mismatches(bridge.state_to_numpy(lane_view(ps, 0)),
                                         bridge.state_to_numpy(lane_view(st, r)))
            if bad:
                fail(f"rollouts/{algo}: lane {r} final state differs from the "
                     f"plain engine at {bad[:5]}")
        rate = events / wall
        rest = (events - events_1) / sum(walls[1:])
        print(f"rollouts/{algo}: R={R} lanes x {n_chunks} chunks of {n_steps} "
              f"steps, {events} events in {wall:.3f} s wall, {rate:.0f} events/s "
              f"aggregate (chunk walls {[round(w * 1e3, 3) for w in walls]} ms; "
              f"chunks 2-{n_chunks} {rest:.0f} events/s); B1 and B2 "
              f"{n_chunks} launches each; every lane bitwise equal to its "
              f"single-lane run, lanes {list(plain_lanes)} to the plain engine "
              f"(every chunk, "
              f"final state)")
        out[algo] = {"R": R, "events": events, "wall_s": wall, "events_per_s": rate,
                     "chunk_walls_s": walls, "events_per_s_after_chunk_1": rest,
                     "b1_launches": n_b1, "b2_launches": n_b2}
    report["rollouts"] = out
    report["b1"]["max_abs_err"] = max(report["b1"]["max_abs_err"], max_err)


def phase_cuda_vs_cpu(report, out_root):
    """(d) the engine on the card (B1) against the engine on the CPU (the
    plain loop), same tables."""
    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_duo_fleet
    from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine
    from distributed_cluster_gpus_tpu_torch.sim.io import run_simulation

    fleet = build_duo_fleet()
    params = SimParams(algo="joint_nf", duration=20.0, log_interval=2.0,
                       job_cap=32, queue_cap=256, lat_window=128, seed=9)
    tables = []
    cpu_eng = Engine(fleet, params, device="cpu")
    orig = cpu_eng.workload.tables

    def recording_tables(state, n):
        out = orig(state, n)
        tables.append({k: v[0].clone() for k, v in out.items()})
        return out

    cpu_eng.workload.tables = recording_tables
    s_cpu = run_simulation(fleet, params, out_dir=os.path.join(out_root, "cpu"),
                           chunk_steps=512, engine=cpu_eng)
    t0 = time.perf_counter()
    s_gpu = run_simulation(fleet, params, out_dir=os.path.join(out_root, "gpu"),
                           chunk_steps=512, device="cuda", pre_tables=tables)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = bridge.tree_mismatches(bridge.state_to_numpy(s_cpu),
                                 bridge.state_to_numpy(s_gpu))
    if bad:
        fail(f"engine on the card differs from the CPU engine at {bad[:5]}")
    for name in ("job_log.csv", "cluster_log.csv"):
        with open(os.path.join(out_root, "cpu", name), "rb") as f:
            a = f.read()
        with open(os.path.join(out_root, "gpu", name), "rb") as f:
            b = f.read()
        if a != b:
            fail(f"{name} differs between the card and the CPU")
    events = int(s_gpu.n_events)
    print(f"card (B1) vs CPU engine (duo fleet, joint_nf, {events} events): "
          f"bitwise identical state and CSVs")
    report["cuda_vs_cpu"] = {"events": events, "wall_s": wall}


def phase_profile(report):
    """(e) where an event's time goes on the kernel path: one profiled chunk
    of the main path's shape (paper fleet as the CLI builds it,
    ``default_policy``) after a warm-up chunk.  The host reads are the
    device-to-host copies the profiler saw (``.item()`` and ``.tolist()``
    both make one): ``run_chunk`` makes none (the events it ran stay on the
    card, read here after the profile); the warm-up chunk runs under the
    sync counter."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state

    fleet, params, n_steps = cli_params("default_policy")
    eng = Engine(fleet, params, device="cuda")
    st = init_state(params.seed, fleet, params, workload=eng.workload,
                    device="cuda")
    with SyncCounter() as syncs:
        st, _ = eng.run_chunk(st, n_steps)
    in_chunk = syncs.in_chunk
    if in_chunk:
        fail(f"profile: {in_chunk} synchronizing CUDA calls inside the chunk "
             f"({syncs.by_file})")
    # the profiler records only some of a chunk's short launches, and now
    # and then none: up to PROFILE_TRIES profiled chunks, the first in which
    # it saw device work is read
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st, _ = eng.run_chunk(st, n_steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = int(eng.stats["events"])
        dev_us, n_dev, b1_us, b2_us, n_dtoh, n_scalar = 0.0, 0, 0.0, 0.0, 0, 0
        for e in prof.events():
            if e.name == "aten::_local_scalar_dense":
                n_scalar += 1
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            dur = e.time_range.elapsed_us()
            dev_us += dur
            n_dev += 1
            if "DtoH" in e.name:
                n_dtoh += 1
            if "event_scan_kernel" in e.name:
                b1_us += dur
            if any(k in e.name for k in ("draws_kernel", "fold_kernel",
                                         "tnext_kernel")):
                b2_us += dur
        if n_dev:
            break
    if n_dev == 0:
        fail(f"profile: the profiler saw no device activity in "
             f"{PROFILE_TRIES} profiled chunks")
    reads_in_chunk = n_dtoh
    if reads_in_chunk:
        fail(f"profile: {n_dtoh} device-to-host copies in one run_chunk, "
             "expected none")
    busy = dev_us / (wall * 1e6)
    ev = max(events, 1)
    print(f"profile (paper fleet as the CLI runs it, default_policy, {n_steps}"
          f"-step chunk, {events} events, profiler on): {wall / ev * 1e6:.2f} "
          f"us/event wall, {n_dev} device ops in the chunk ({n_dev / ev:.5f} per "
          f"event), device busy share {busy:.3f}, B1 {b1_us:.1f} us and B2 "
          f"{b2_us:.1f} us of {dev_us:.1f} us device time; host reads: {n_dtoh} "
          f"device-to-host copies ({n_scalar} scalar reads) in run_chunk, "
          f"{reads_in_chunk} inside the chunk; {in_chunk} synchronizing calls "
          f"inside the warm-up chunk, {syncs.total} in its run_chunk")
    report["profile"] = {"events": events, "n_steps": n_steps, "wall_s": wall,
                         "profiled_chunks": attempt + 1,
                         "device_us": dev_us, "device_ops": n_dev,
                         "device_busy_share": busy, "b1_us": b1_us,
                         "b2_us": b2_us, "dtoh_copies": n_dtoh,
                         "scalar_reads": n_scalar,
                         "host_reads_in_chunk": reads_in_chunk,
                         "warmup_syncs_in_chunk": in_chunk,
                         "warmup_syncs_total": syncs.total}


# ---------------------------------------------------------------- chsac_af


def perturb_policy(sac, seed=21):
    """Seeded non-zero biases and perturbed kernels in every layer, in
    place: flax's default init (the CLI's) zeroes every bias, which would
    leave the forward's bias add unchecked.  A write of the parameters
    outside the update: the shadows are refreshed after it (a parent
    checkout of an A/B, before PR 12, has no refresh: its updates cast the
    shadows at their head)."""
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # the parameters are trainable leaves
        for layer in sac.layers():
            for p, std in ((layer.kernel, 0.02), (layer.bias, 0.1)):
                p.add_((torch.randn(p.shape, generator=g) * std).to(p.device))
    if hasattr(rsac, "refresh_shadows"):
        rsac.refresh_shadows(sac)


def rl_setup(extra=()):
    """(fleet, params, chunk steps, engine, agent) of the chsac_af main path
    as its CLI builds them (``cli_argv("chsac_af")`` and the ``extra``
    flags), with the policy's biases and kernels perturbed by
    ``perturb_policy``."""
    from distributed_cluster_gpus_tpu_torch.rl.train import make_agent
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine

    fleet, params, n = cli_params("chsac_af", extra)
    agent = make_agent(fleet, params, device="cuda")
    perturb_policy(agent.sac)
    eng = Engine(fleet, params, device="cuda", policy_apply=agent.policy_apply)
    return fleet, params, n, eng, agent


def seeded_rings(W, seed=7):
    """Latency rings at the engine's window length and their counts: the
    edge cases 0, 1, 4, 5, W-1, W and beyond W, ties (values rounded to the
    millisecond, a ring of one repeated value, a top of repeated values)
    and random counts."""
    g = torch.Generator().manual_seed(seed)
    counts = [0, 1, 4, 5, W - 1, W, 3 * W + 7] + torch.randint(
        1, 2 * W, (25,), generator=g).tolist()
    B = len(counts) + 3
    buf = torch.empty((B, W)).exponential_(5.0, generator=g)
    buf[: B // 2] = torch.round(buf[: B // 2] * 1000) / 1000
    buf[-3] = 0.25  # one repeated value
    buf[-2, : W // 2] = 3.0  # many ties at the top
    counts += [W, W, W // 3]
    return (buf.float().contiguous(),
            torch.tensor(counts, dtype=torch.int32))


def seeded_decisions(M, obs_dim, n_dc, n_g, seed=11):
    """Observations in the policy's O(1) ranges, masks (rows 0 and 1 with all
    but one action masked) and action keys."""
    from distributed_cluster_gpus_tpu_torch.ops import prng

    g = torch.Generator().manual_seed(seed)
    obs = torch.rand((M, obs_dim), generator=g)
    m_dc = torch.rand((M, n_dc), generator=g) < 0.7
    m_g = torch.rand((M, n_g), generator=g) < 0.6
    m_dc[:, 0] |= ~m_dc.any(-1)
    m_g[:, 0] = True
    m_dc[0] = False
    m_dc[0, n_dc - 1] = True
    m_g[1] = False
    m_g[1, n_g // 2] = True
    keys = prng.split(prng.key(seed, "cpu"), M)
    return obs.contiguous(), m_dc.contiguous(), m_g.contiguous(), keys.contiguous()


def phase_rl_tail(report, real):
    """(f) B3 and B4 against their plain versions on the card, through the
    standalone batched launch of the RL-mode device code: every ring's p99
    bitwise, every row's log-probabilities bitwise and its sampled actions
    equal; time both on the main path's data (``real``, from phase (g): B3
    on the two latency windows of the chsac_af CLI's state after two chunks,
    B4 on one decision's observation and masks) beside their plain versions
    and a one-call PyTorch yardstick the port never calls."""
    import torch.nn.functional as F

    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.rl.sac import policy_logp, select_action
    from distributed_cluster_gpus_tpu_torch.sim import algos

    fleet, params, _, eng, agent = rl_setup()
    sac, cfg = agent.sac, agent.cfg
    W = params.lat_window
    K = algos.percentile_k(W)
    buf, cnt = (t.cuda() for t in seeded_rings(W))
    M = 128
    obs, m_dc, m_g, keys = (t.cuda() for t in seeded_decisions(
        M, cfg.obs_dim, cfg.n_dc, cfg.n_g))
    ops = b1.policy_operands(eng, sac, eng.device)
    out = b1.rl_tail_batch(eng, sac, buf, cnt, obs, m_dc, m_g, keys, operands=ops)
    ref_p99 = algos.windowed_percentile(buf, cnt, 99.0)
    ref_dc, ref_g = policy_logp(sac, obs, m_dc, m_g)
    torch.cuda.synchronize()
    if not bits_equal(out["p99"], ref_p99):
        bad = (~((out["p99"] == ref_p99) | (torch.isnan(out["p99"])
                                            & torch.isnan(ref_p99)))).nonzero()
        fail(f"B3 p99 differs from the plain version at rings "
             f"{bad[:5, 0].tolist()} (counts {cnt[bad[:5, 0]].tolist()}): "
             f"{out['p99'][bad[:5, 0]].tolist()} vs {ref_p99[bad[:5, 0]].tolist()}")
    b3_err = max_abs_diff(out["p99"], ref_p99)
    b4_err = max(max_abs_diff(out["logp_dc"], ref_dc),
                 max_abs_diff(out["logp_g"], ref_g))
    if not (torch.equal(out["logp_dc"], ref_dc) and torch.equal(out["logp_g"], ref_g)):
        fail(f"B4 log-probabilities differ from the plain version (max abs "
             f"{b4_err:.3g})")
    for i in range(M):
        a = select_action(cfg, sac, obs[i], m_dc[i], m_g[i], keys[i])
        if (int(out["a_dc"][i]), int(out["a_g"][i])) != (int(a[0]), int(a[1])):
            fail(f"B4 row {i}: kernel actions {int(out['a_dc'][i])}, "
                 f"{int(out['a_g'][i])} vs plain {int(a[0])}, {int(a[1])}")
    # timings on the main path's data; both held against the plain version
    b2r, c2 = real["lat_buf"], real["lat_count"]
    one = real["row"]
    chk = b1.rl_tail_batch(eng, sac, b2r, c2, *one, operands=ops)
    if not bits_equal(chk["p99"], algos.windowed_percentile(b2r, c2, 99.0)):
        fail("B3 on the main path's latency windows differs from the plain version")
    ld, lg = policy_logp(sac, *one[:3])
    if not (torch.equal(chk["logp_dc"], ld) and torch.equal(chk["logp_g"], lg)):
        fail("B4 on a main-path decision differs from the plain version")
    none_obs = obs[:0].contiguous()

    def b3_call():
        return b1.rl_tail_batch(eng, sac, b2r, c2, none_obs,
                                m_dc[:0].contiguous(), m_g[:0].contiguous(),
                                keys[:0].contiguous(), operands=ops)

    # the kernel's device time (launches back to back) and the wrapper's
    # time per call
    ms_b3, seen_b3 = device_ms(b3_call, "rl_tail_batch_kernel")
    call_b3 = time_cuda(b3_call, reps=50)
    plain_b3 = time_cuda(lambda: algos.windowed_percentile(b2r, c2, 99.0), reps=20)

    def lib_p99():
        m = torch.clamp(c2, max=W)
        valid = torch.arange(W, device=b2r.device) < m[:, None]
        top = torch.topk(torch.where(valid, b2r, -torch.inf), K, dim=-1).values
        mf = torch.clamp(m, min=1)
        pos = 0.99 * (mf - 1).float()
        lo = torch.floor(pos)
        frac = pos - lo
        hi = torch.minimum(lo + 1, (mf - 1).float())
        s_lo = top.gather(-1, (mf - 1 - lo.long()).clamp(0, K - 1)[:, None])[:, 0]
        s_hi = top.gather(-1, (mf - 1 - hi.long()).clamp(0, K - 1)[:, None])[:, 0]
        return s_lo * (1 - frac) + s_hi * frac

    lib_b3 = time_cuda(lib_p99, reps=50)
    no_ring, no_cnt = buf[:0].contiguous(), cnt[:0].contiguous()
    def b4_call():
        return b1.rl_tail_batch(eng, sac, no_ring, no_cnt, *one, operands=ops)

    ms_b4, seen_b4 = device_ms(b4_call, "rl_tail_batch_kernel")
    call_b4 = time_cuda(b4_call, reps=50)
    plain_b4 = time_cuda(lambda: select_action(cfg, sac, one[0][0], one[1][0],
                                               one[2][0], one[3][0]), reps=10)
    lin = [(l.kernel.detach().t().to(torch.bfloat16).contiguous(),
            l.bias.detach().to(torch.bfloat16)) for l in sac.layers()]

    def lib_forward():
        x = one[0].to(torch.bfloat16)
        for w, b in lin[:4]:
            x = F.relu(F.linear(x, w, b))
        return (F.log_softmax(F.linear(x, *lin[4]).float(), -1),
                F.log_softmax(F.linear(x, *lin[5]).float(), -1))

    lib_b4 = time_cuda(lib_forward, reps=50)
    # bounds: B3 reads the valid prefix of each window and its count once
    # and writes the p99 (3 operations an entry); B4 reads the layers' bf16
    # weights and biases (unpadded) once per decision and does 2 operations
    # per multiply-add at bf16
    valid_entries = int(torch.clamp(c2, max=W).sum())
    b3_bytes = 4 * valid_entries + 2 * 4 + 2 * 4
    b3_ops = 3 * valid_entries
    b3_bound, b3_by = bound(b3_bytes, b3_ops)
    w_bytes = sum(2 * l.kernel.numel() + 2 * l.bias.numel() for l in sac.layers())
    macs = sum(l.kernel.numel() for l in sac.layers())
    b4_bytes = w_bytes + cfg.obs_dim * 4 + cfg.n_dc + cfg.n_g + 8 + \
        4 * (cfg.n_dc + cfg.n_g) + 8
    b4_bound, b4_by = bound2(b4_bytes, 0, 2 * macs)
    print(f"B3 windowed p99 (W={W}, K={K}): {len(cnt)} seeded rings bitwise "
          f"equal to the plain version; on the CLI state's windows (counts "
          f"{c2.tolist()}): kernel {ms_b3:.4f} ms device time per "
          f"step's two windows (launches back to back; the profiler saw "
          f"{seen_b3} of 20; {call_b3:.4f} ms per wrapper call), plain "
          f"{plain_b3:.3f} ms, torch.topk yardstick {lib_b3:.4f} ms, bound "
          f"{b3_bound:.6f} ms ({b3_by})")
    print(f"B4 policy (obs {cfg.obs_dim} -> 256x3 -> 256 -> {cfg.n_dc}+{cfg.n_g}, "
          f"{macs} weights): {M} rows' log-probabilities bitwise equal and "
          f"actions equal to the plain version; kernel {ms_b4:.4f} ms device "
          f"time per decision (back to back; the profiler saw {seen_b4} of "
          f"20; {call_b4:.4f} ms per wrapper call), plain "
          f"{plain_b4:.3f} ms, bf16 F.linear chain {lib_b4:.4f} ms, bound "
          f"{b4_bound:.6f} ms ({b4_by}: {b4_bytes} B)")
    report["b3"] = {"W": W, "K": K, "rings": len(cnt), "max_abs_err": b3_err,
                    "ms": ms_b3, "call_ms": call_b3, "plain_ms": plain_b3,
                    "library_ms": lib_b3, "bound_ms": b3_bound,
                    "bound_by": b3_by, "bytes": b3_bytes, "ops": b3_ops,
                    "profiler_launches_seen": seen_b3}
    report["b4"] = {"rows": M, "max_abs_err": b4_err, "ms": ms_b4,
                    "call_ms": call_b4, "plain_ms": plain_b4,
                    "library_ms": lib_b4, "bound_ms": b4_bound,
                    "bound_by": b4_by, "bytes": b4_bytes, "bf16_ops": 2 * macs,
                    "profiler_launches_seen": seen_b4}


#: phase (f)'s widened GPU-count heads: (n_g, its CLI flags) on the paper
#: fleet, 255 on the single-DC fleet (n_dc + n_g <= 256)
WIDE_HEAD_N = ((33, ()), (64, ()), (128, ()), (255, ("--single-dc",)))


def phase_wide_heads(report):
    """(f, widened) B4's GPU-count head at n_g = 33, 64, 128 (paper fleet)
    and 255 (single-DC fleet) through the standalone launch, sampled and
    greedy, against the plain version on the card: every row's
    log-probabilities bitwise and its actions equal, on seeded observations
    and masks with all but one action masked (the first, a middle, the
    last) and every action feasible; then a decision's device time at
    8 x 128 beside 8 x 8 (the event scan's cluster size for each)."""
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.rl.sac import (make_policy_apply,
                                                           policy_logp,
                                                           select_action)
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine

    out = {}
    M = 40
    for n_g, flags in WIDE_HEAD_N:
        fleet, params, _, eng, agent = rl_setup(
            flags + ("--max-gpus-per-job", str(n_g)))
        sac, cfg = agent.sac, agent.cfg
        obs, m_dc, m_g, keys = (t.cuda() for t in seeded_decisions(
            M, cfg.obs_dim, cfg.n_dc, n_g, seed=n_g))
        m_g[2:5] = False
        m_g[2, 0] = m_g[3, n_g // 2] = m_g[4, n_g - 1] = True
        m_g[5] = True
        ops = b1.policy_operands(eng, sac, eng.device)
        ring = torch.zeros((0, params.lat_window), device="cuda")
        cnt = torch.zeros((0,), dtype=torch.int32, device="cuda")
        ref_dc, ref_g = policy_logp(sac, obs, m_dc, m_g)
        for greedy in (False, True):
            e_ = Engine(fleet, params, device="cuda",
                        policy_apply=make_policy_apply(cfg, greedy=greedy))
            got = b1.rl_tail_batch(e_, sac, ring, cnt, obs, m_dc, m_g, keys,
                                   operands=ops)
            torch.cuda.synchronize()
            where = f"B4 at {cfg.n_dc} x {n_g} ({'greedy' if greedy else 'sampled'})"
            if not (bits_equal(got["logp_dc"], ref_dc)
                    and bits_equal(got["logp_g"], ref_g)):
                fail(f"{where}: log-probabilities differ from the plain version")
            for i in range(M):
                a = select_action(cfg, sac, obs[i], m_dc[i], m_g[i], keys[i],
                                  greedy=greedy)
                if (int(got["a_dc"][i]), int(got["a_g"][i])) != (int(a[0]),
                                                                 int(a[1])):
                    fail(f"{where} row {i}: kernel actions "
                         f"{int(got['a_dc'][i])}, {int(got['a_g'][i])} vs "
                         f"plain {int(a[0])}, {int(a[1])}")
            if int(got["a_g"][4]) != n_g - 1 or int(got["a_g"][2]) != 0:
                fail(f"{where}: a one-feasible row took another action")
        one = [obs[:1].contiguous(), m_dc[:1].contiguous(),
               m_g[:1].contiguous(), keys[:1].contiguous()]

        def call(one=one, eng=eng, sac=sac, ops=ops, ring=ring, cnt=cnt):
            return b1.rl_tail_batch(eng, sac, ring, cnt, *one, operands=ops)

        ms, _ = device_ms(call, "rl_tail_batch_kernel")
        widths = tuple(int(ops[0][2 * k].shape[0]) for k in range(4))
        plan = b1.block_plan(eng, b1.THREADS, widths)
        out[f"{cfg.n_dc}x{n_g}"] = {"us_per_decision": ms * 1e3,
                                    "cluster": plan[1], "lead": plan[2],
                                    "sum_warps": plan[0]}
        del agent, sac, ops
    fleet, params, _, eng, agent = rl_setup()
    ops = b1.policy_operands(eng, agent.sac, eng.device)
    plan = b1.block_plan(eng, b1.THREADS,
                         tuple(int(ops[0][2 * k].shape[0]) for k in range(4)))
    out["8x8"] = {"cluster": plan[1], "lead": plan[2], "sum_warps": plan[0],
                  "us_per_decision": report["b4"]["ms"] * 1e3}
    print("B4 widened GPU-count heads (n_g 33, 64, 128 on the paper fleet, "
          "255 on the single-DC fleet): log-probabilities bitwise and actions "
          "equal to the plain version, sampled and greedy, rows with all but "
          "one action masked; per decision (device time, back to back) and "
          "the event scan's (summing warps, cluster, lead) at each: " +
          "; ".join(f"{k}: {v['us_per_decision']:.2f} us, ({v['sum_warps']}, "
                    f"{v['cluster']}, {v['lead']})" for k, v in out.items()))
    report["b4_wide"] = out


#: phase (g)'s widest setting on the paper fleet, and its bitwise chunk
WIDE_B1_ARGV = ("--max-gpus-per-job", "128")
WIDE_B1_STEPS = 1024


def phase_b1_rl_wide(report):
    """(g, widened) B1 in RL mode on the paper fleet at ``WIDE_B1_ARGV``
    (8 x 128 joint actions) against the plain step on the card, bitwise
    over a ``WIDE_B1_STEPS``-step chunk from the run's start (every
    emission, ``rl`` with its 128-wide masks included, and the state); then
    the kernel alone over three 4,096-step chunks: us per event."""
    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.models.structs import (
        clone_state, with_lane_axis)
    from distributed_cluster_gpus_tpu_torch.sim.engine import init_state

    fleet, params, n_steps, eng, agent = rl_setup(WIDE_B1_ARGV)
    sac = agent.sac
    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device="cuda"))
    other = clone_state(st)
    pre = eng.workload.tables(st, WIDE_B1_STEPS)
    em_k, _ = b1.event_scan(eng, st, pre, WIDE_B1_STEPS, sac)
    em_r, _ = b1.event_scan_reference(eng, other, pre, WIDE_B1_STEPS, sac)
    torch.cuda.synchronize()
    where = f"B1 RL mode at 8 x {params.max_gpus_per_job}"
    em_diff(em_k, em_r, where)
    bad = bridge.tree_mismatches(bridge.state_to_numpy(other),
                                 bridge.state_to_numpy(st))
    if bad:
        fail(f"{where}: state differs from the plain version at {bad[:5]}")
    eng.workload.advance_carries(st, pre)
    mg = em_k["rl"]["mask_g"]
    decisions = int(em_k["rl"]["valid"].sum())
    if tuple(mg.shape[-1:]) != (params.max_gpus_per_job,) or not bool(
            mg[..., 8:].any()):
        fail(f"{where}: no GPU-count action past 8 was ever feasible")
    ms, events = [], []
    for _ in range(3):
        pre = eng.workload.tables(st, n_steps)
        before = int(st.n_events.sum())
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        b1.event_scan(eng, st, pre, n_steps, sac)
        b.record()
        b.synchronize()
        eng.workload.advance_carries(st, pre)
        ms.append(a.elapsed_time(b))
        events.append(int(st.n_events.sum()) - before)
    us = statistics.mean(ms) / statistics.mean(events) * 1e3
    print(f"{where} vs plain step on the card (paper fleet as the chsac_af "
          f"CLI runs it with {' '.join(WIDE_B1_ARGV)}): a {WIDE_B1_STEPS}-step "
          f"chunk bitwise identical (emissions incl. rl, state; "
          f"{decisions} transitions); the kernel over 3 more {n_steps}-step "
          f"chunks {[round(m, 3) for m in ms]} ms, {us:.3f} us/event")
    report["b1_rl_wide"] = {"argv": WIDE_B1_ARGV, "steps": WIDE_B1_STEPS,
                            "chunk_ms": ms, "events": events,
                            "us_per_event": us}


def rl_b1_work(eng, before, after, pre, em, n_steps, agent):
    """``b1_work`` plus what the RL tail needs.  Bytes: the valid prefix of
    the two latency windows read once (``b1_work`` counts the entry each
    finish appends), the policy's bf16 weights and biases read once, the
    per-step RL records and the per-decision trace writes.  Operations
    (float32): a window's p99 (3 per valid entry) once per window at the
    launch and again only when a finish appends to it, at its count of that
    moment, and the observation on every event; (bf16) two per multiply-add
    of the forward at each decision."""
    bytes_moved, ops, counts = b1_work(eng, before, after, pre, em, n_steps)
    p, n_dc = eng.params, eng.fleet.n_dc
    cfg = agent.cfg
    d, g, W = cfg.obs_dim, cfg.n_g, p.lat_window
    dropped = int((after.n_dropped - before.n_dropped).sum())
    decisions = counts["arrivals"] - dropped + counts["finishes"]
    w_bytes = sum(2 * l.kernel.numel() + 2 * l.bias.numel()
                  for l in agent.sac.layers())
    macs = sum(l.kernel.numel() for l in agent.sac.layers())
    rec = n_steps * (4 * d + 16 + n_dc + g)
    fin = counts["finishes"] * (4 * d + 13 + n_dc + g)
    trace = decisions * (4 * d + 9 + n_dc + g)
    c0 = before.lat.count.reshape(-1).tolist()
    c1 = after.lat.count.reshape(-1).tolist()
    entries = sum(min(a, W) for a in c0)  # valid entries at the launch
    p99_entries = entries + sum(min(k, W) for a, b in zip(c0, c1)
                                for k in range(a + 1, b + 1))
    bytes_moved += 4 * entries + w_bytes + rec + fin + trace
    f32_ops = ops + 3 * p99_entries + counts["events"] * 12 * n_dc
    bf16_ops = decisions * 2 * macs
    counts.update(decisions=decisions, dropped=dropped,
                  p99_entries=p99_entries)
    return bytes_moved, f32_ops, bf16_ops, counts


def phase_b1_rl(report, lanes=4, steps=None):
    """(g) B1 in RL mode against the plain step on the card, bitwise: the
    paper fleet as the chsac_af CLI builds it (auto queue_cap, seed 123,
    4,096-step chunks, lat_window 2,048, job_cap 512), 2 chunks, every
    emission (``rl`` included) and state leaf; then R lanes in one launch,
    each bitwise equal to its single-lane run.  Times the kernel and the
    plain step on the second chunk and bounds the kernel by that chunk."""
    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.models.structs import (
        clone_state, lane_view, unstack_states, with_lane_axis)
    from distributed_cluster_gpus_tpu_torch.parallel.rollout import batched_init
    from distributed_cluster_gpus_tpu_torch.sim.engine import init_state

    fleet, params, n_steps, eng, agent = rl_setup()
    n_steps = steps or n_steps
    sac = agent.sac
    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device="cuda"))
    other = clone_state(st)
    max_err, chunks = 0.0, []
    for c in range(2):
        pre = eng.workload.tables(st, n_steps)
        before = clone_state(st)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        em_k, _ = b1.event_scan(eng, st, pre, n_steps, sac)
        b.record()
        b.synchronize()
        k_ms = a.elapsed_time(b)
        t0 = time.perf_counter()
        em_r, _ = b1.event_scan_reference(eng, other, pre, n_steps, sac)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        max_err = max(max_err, em_diff(em_k, em_r, f"B1 RL paper chunk {c}"))
        eng.workload.advance_carries(st, pre)
        eng.workload.advance_carries(other, pre)
        max_err = max(max_err, state_diff(st, other))
        bad = bridge.tree_mismatches(bridge.state_to_numpy(other),
                                     bridge.state_to_numpy(st))
        if bad:
            fail(f"B1 RL paper chunk {c}: state differs from the plain version "
                 f"at {bad[:5]}")
        by, f32_ops, bf16_ops, counts = rl_b1_work(eng, before, st, pre, em_k,
                                                   n_steps, agent)
        ev = int((st.n_events - before.n_events).sum())
        chunks.append({"events": ev, "ms": k_ms, "plain_ms": p_ms, "bytes": by,
                       "f32_ops": f32_ops, "bf16_ops": bf16_ops,
                       "counts": counts,
                       "valid": int(em_k["rl"]["valid"].sum())})
    c = chunks[1]
    bound_ms, bound_by = bound2(c["bytes"], c["f32_ops"], c["bf16_ops"])
    # R lanes in one launch against their single-lane kernel runs
    lanes_st = batched_init(fleet, params, lanes, workload=eng.workload,
                            device="cuda")
    singles = unstack_states(lanes_st)
    lane_ems = []
    for c2 in range(2):
        lanes_st, em = eng.run_chunk(lanes_st, n_steps, policy_params=sac)
        lane_ems.append(em)
    for r, s in enumerate(singles):
        for c2 in range(2):
            s, em = eng.run_chunk(s, n_steps, policy_params=sac)
            em_diff({k: v for k, v in em.items()},
                    {k: (v[r] if not isinstance(v, dict) else
                         {kk: vv[r] for kk, vv in v.items()})
                     for k, v in lane_ems[c2].items()},
                    f"B1 RL lane {r} chunk {c2} vs its single-lane run")
        bad = bridge.tree_mismatches(bridge.state_to_numpy(lane_view(lanes_st, r)),
                                     bridge.state_to_numpy(s))
        if bad:
            fail(f"B1 RL lane {r}: state differs from its single-lane run at "
                 f"{bad[:5]}")
    print(f"B1 RL mode vs plain step on the card (paper fleet as the chsac_af "
          f"CLI runs it: queue_cap {params.queue_cap}, lat_window "
          f"{params.lat_window}, {n_steps}-step chunks), 2 chunks bitwise "
          f"identical (emissions incl. rl, state; max_abs_err {max_err}); "
          f"second chunk {c['events']} events ({c['counts']['decisions']} "
          f"decisions, {c['valid']} transitions): kernel {c['ms']:.3f} ms "
          f"({c['ms'] / c['events'] * 1e3:.2f} us/event), plain "
          f"{c['plain_ms']:.1f} ms, bound {bound_ms:.6f} ms ({bound_by}); "
          f"R={lanes} lanes each bitwise equal to its single-lane run")
    report["b1_rl"] = {"chunks": chunks, "ms": c["ms"], "plain_ms": c["plain_ms"],
                       "us_per_event": c["ms"] / c["events"] * 1e3,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "max_abs_err": max_err, "lanes": lanes,
                       "queue_cap": params.queue_cap}
    # the main path's data for timing B3 and B4 alone (phase (f))
    rl = em_k["rl"]
    i = int(torch.nonzero(rl["valid"][0])[0, 0])  # a finish: a drain decision
    row = [rl["s1"][0, i:i + 1].contiguous(), rl["mask_dc"][0, i:i + 1].contiguous(),
           rl["mask_g"][0, i:i + 1].contiguous(),
           torch.tensor([[0, i]], dtype=torch.int64, device=rl["s1"].device)]
    return {"lat_buf": st.lat.buf[0].contiguous(),
            "lat_count": st.lat.count[0].contiguous(), "row": row}


def seeded_window(g, N, obs_dim, n_dc, n_g, p_valid):
    return {"valid": torch.rand(N, generator=g) < p_valid,
            "s0": torch.randn((N, obs_dim), generator=g),
            "s1": torch.randn((N, obs_dim), generator=g),
            "a_dc": torch.randint(0, n_dc, (N,), generator=g, dtype=torch.int32),
            "a_g": torch.randint(0, n_g, (N,), generator=g, dtype=torch.int32),
            "r": torch.randn(N, generator=g),
            "costs": torch.randn((N, 4), generator=g),
            "mask_dc": torch.rand((N, n_dc), generator=g) < 0.5,
            "mask_g": torch.rand((N, n_g), generator=g) < 0.5,
            "mask_dc0": torch.rand((N, n_dc), generator=g) < 0.5,
            "mask_g0": torch.rand((N, n_g), generator=g) < 0.5}


#: B6a's windows past the small cases, both layouts: (ring C, window sizes,
#: valid fraction); 8,193 rows is past the one-block kernel's old limit,
#: N = C above 32,768 rows takes the count launch first
B6A_SIZES = {"sizes_slotring": (200_000, [1, 4096, 8193, 200_000, 4096], 0.35),
             "sizes_scatter": (200_000, [1, 4096, 8193, 200_000, 4096], 0.35)}


def phase_b6a(report):
    """(h) B6a against its plain versions on the card: seeded windows that
    wrap, are all valid, have none valid and overwrite valid rows, into a
    ring on the card and its twin (every leaf bitwise after every window),
    then windows of 1, 4,096, 8,193 and C = 200,000 rows in both layouts
    (`_add_window`, `_add_scatter`; the 4,096-row ones with no ``done``
    column, which the kernel fills); then one 4,096-row window into the
    CLI's 200,000-row ring timed beside the plain version (device time, and
    the wrapper's host time a call), in both layouts."""
    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.kernels import replay_ingest as b6
    from distributed_cluster_gpus_tpu_torch.rl import replay

    obs_dim, n_dc, n_g = 49, 8, 8
    g = torch.Generator().manual_seed(3)
    cases = {"wrap": (300, [70] * 9, 0.6), "all_valid": (300, [64] * 6, 1.0),
             "none_valid": (300, [64] * 3, 0.0),
             "overwrite": (257, [100, 100, 100, 100, 100], 0.9)}
    n_win = 0
    for name, (C, sizes, pv) in cases.items():
        rk = replay.replay_init(C, obs_dim, n_dc, n_g, 4, device="cuda")
        rp = replay.replay_init(C, obs_dim, n_dc, n_g, 4, device="cuda")
        for N in sizes:
            tr = {k: v.cuda() for k, v in seeded_window(g, N, obs_dim, n_dc, n_g,
                                                        pv).items()}
            b6.replay_ingest(rk, tr)
            replay._add_window(rp, tr)
            n_win += 1
            bad = bridge.tree_mismatches(bridge.tree_to_numpy(rp, bridge.tensor_leaf),
                                         bridge.tree_to_numpy(rk, bridge.tensor_leaf))
            if bad:
                fail(f"B6a {name}: ring differs from the plain version at {bad[:5]}")
        if name == "overwrite" and not int(rk.size) < int(rk.n_seen):
            fail("B6a overwrite case overwrote no valid row")
    for name, (C, sizes, pv) in B6A_SIZES.items():
        mode = name.split("_")[1]
        plain = replay._add_window if mode == "slotring" else replay._add_scatter
        rk = replay.replay_init(C, obs_dim, n_dc, n_g, 4, device="cuda")
        rp = replay.replay_init(C, obs_dim, n_dc, n_g, 4, device="cuda")
        for N in sizes:
            tr = {k: v.cuda() for k, v in seeded_window(g, N, obs_dim, n_dc, n_g,
                                                        pv).items()}
            if N != 4096:
                tr["done"] = (torch.rand(N, generator=g) < 0.5).float().cuda()
            b6.replay_ingest(rk, tr, mode)
            plain(rp, tr)
            n_win += 1
            bad = bridge.tree_mismatches(bridge.tree_to_numpy(rp, bridge.tensor_leaf),
                                         bridge.tree_to_numpy(rk, bridge.tensor_leaf))
            if bad:
                fail(f"B6a {mode}, a {N}-row window into {C}: ring differs "
                     f"from the plain version at {bad[:5]}")
        if mode == "slotring" and not int(rk.size) < int(rk.n_seen):
            fail(f"B6a {mode}: the {C}-row window overwrote no valid row")
        if mode == "scatter" and int(rk.size) != min(int(rk.n_seen), C):
            fail(f"B6a {mode}: size {int(rk.size)} for {int(rk.n_seen)} "
                 f"rows seen in a ring of {C}")
        del rk, rp
    C, N = 200_000, 4096
    rk = replay.replay_init(C, obs_dim, n_dc, n_g, 4, device="cuda")
    rp = replay.replay_init(C, obs_dim, n_dc, n_g, 4, device="cuda")
    tr = {k: v.cuda() for k, v in seeded_window(g, N, obs_dim, n_dc, n_g,
                                                0.35).items()}
    # the window's own done column, so that the wrapper's only device work
    # is the kernel (it fills a missing one with ones)
    tr["done"] = torch.ones(N, device="cuda")
    for _ in range(3):
        b6.replay_ingest(rk, tr)
        replay._add_window(rp, tr)
    bad = bridge.tree_mismatches(bridge.tree_to_numpy(rp, bridge.tensor_leaf),
                                 bridge.tree_to_numpy(rk, bridge.tensor_leaf))
    if bad:
        fail(f"B6a at the CLI's shape: ring differs at {bad[:5]}")
    ms, seen = device_ms(lambda: b6.replay_ingest(rk, tr), "replay_ingest_kernel")
    call_ms = time_cuda(lambda: b6.replay_ingest(rk, tr), reps=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        b6.replay_ingest(rk, tr)
    host_ms = (time.perf_counter() - t0) * 1e3 / 200
    torch.cuda.synchronize()
    plain_ms = time_cuda(lambda: replay._add_window(rp, tr), reps=5, runs=3)
    rs = replay.replay_init(C, obs_dim, n_dc, n_g, 4, device="cuda")
    scatter_ms, _ = device_ms(lambda: b6.replay_ingest(rs, tr, "scatter"),
                              "replay_ingest_kernel")
    # the floor: a one-row window (the launch and the kernel's chain of
    # dependent loads), and a window of 16,384 rows
    by_n = {}
    for n_ in (1, 16384):
        tn = {k: v.cuda() for k, v in seeded_window(g, n_, obs_dim, n_dc, n_g,
                                                    0.35).items()}
        tn["done"] = torch.ones(n_, device="cuda")
        by_n[n_] = device_ms(lambda: b6.replay_ingest(rs, tn),
                             "replay_ingest_kernel")[0]
    scatter_plain_ms = time_cuda(lambda: replay._add_scatter(rs, tr), reps=5,
                                 runs=3)
    row = sum(v[0].numel() * v.element_size() for k, v in tr.items()
              if k != "valid")
    bytes_moved = N * (2 * row + 1) + 2 * N + 12
    bound_ms, bound_by = bound(bytes_moved, 4 * N)
    print(f"B6a replay ingest: {n_win} seeded windows (wrap, all/none valid, "
          f"overwrite; 1, 4,096, 8,193 and 200,000 rows in both layouts) "
          f"bitwise equal to the plain versions; {N}-row window "
          f"into C={C}: kernel {ms:.5f} ms device time (launches back to "
          f"back; the profiler saw {seen} of 20; {call_ms:.4f} ms per "
          f"wrapper call on the stream, {host_ms:.4f} ms of host time a "
          f"call), plain {plain_ms:.3f} ms; scatter layout {scatter_ms:.5f} "
          f"ms (plain {scatter_plain_ms:.3f} ms); bound {bound_ms:.6f} ms "
          f"({bound_by}: {bytes_moved} B); a 1-row window {by_n[1]:.5f} ms, "
          f"16,384 rows {by_n[16384]:.5f} ms")
    report["b6a"] = {"windows": n_win, "max_abs_err": 0.0, "ms": ms,
                     "call_ms": call_ms, "host_ms": host_ms,
                     "plain_ms": plain_ms, "scatter_ms": scatter_ms,
                     "scatter_plain_ms": scatter_plain_ms,
                     "ms_by_rows": by_n,
                     "profiler_launches_seen": seen,
                     "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": bytes_moved, "N": N, "C": C}


def phase_chsac_cli(report, out_root):
    """(i) the chsac_af main path through its CLI: paper fleet, 600 s,
    warm-up above the run, 4,096-step chunks, CSVs written; the counters
    zeroed just before the run and read just after: B1 (in RL mode), B2 and
    B6a launched once per chunk; queue conservation, the energy integral,
    the replay's n_seen against the transitions the chunks emitted; a
    second run under torch's sync debug mode counts the synchronizing calls
    made with the B1 or B6a wrapper on the stack (none allowed)."""
    from distributed_cluster_gpus_tpu_torch import run_sim
    from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.kernels import replay_ingest as b6
    from distributed_cluster_gpus_tpu_torch.rl.agent import CHSAC_AF

    algo = "chsac_af"
    out = os.path.join(out_root, algo)
    seen = {"agents": [], "valid": []}
    orig = CHSAC_AF.ingest_chunk

    def counting_ingest(self, rl_em):
        seen["agents"].append(self)
        seen["valid"].append(rl_em["valid"].sum())  # stays on the card
        return orig(self, rl_em)

    CHSAC_AF.ingest_chunk = counting_ingest
    try:
        torch.cuda.synchronize()
        b1.event_scan.launches = b1.event_scan.rl_launches = 0
        b2.arrival_tables.launches = 0
        b6.replay_ingest.launches = 0
        t0 = time.perf_counter()
        st = run_sim.main(cli_argv(algo, out))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_b1, n_rl = b1.event_scan.launches, b1.event_scan.rl_launches
        n_b2, n_b6 = b2.arrival_tables.launches, b6.replay_ingest.launches
    finally:
        CHSAC_AF.ingest_chunk = orig
    n_chunks = len(seen["valid"])
    if not (n_b1 == n_rl == n_b2 == n_b6 == n_chunks > 0):
        fail(f"chsac_af: {n_b1} B1 ({n_rl} in RL mode), {n_b2} B2 and {n_b6} B6a "
             f"launches for {n_chunks} chunks (one each per chunk)")
    agent = seen["agents"][-1]
    valid = int(torch.stack(seen["valid"]).sum())
    n_seen = int(agent.replay.n_seen)
    if n_seen != valid or valid <= 0:
        fail(f"chsac_af: replay n_seen {n_seen} vs {valid} valid transitions "
             "emitted")
    with SyncCounter() as syncs:
        run_sim.main(cli_argv(algo, out + "_syncs"))
    if syncs.in_chunk:
        fail(f"chsac_af: {syncs.in_chunk} synchronizing CUDA calls with the B1 "
             f"or B6a wrapper on the stack ({syncs.by_file})")
    events = int(st.n_events)
    arrived = int(st.jid_counter) - 1
    finished = int(st.n_finished.sum())
    queued = int((st.queues.tail - st.queues.head).sum())
    placed = int((st.jobs.status != 0).sum())
    dropped = int(st.n_dropped)
    jobs = _read_csv(os.path.join(out, "job_log.csv"))
    cl = _read_csv(os.path.join(out, "cluster_log.csv"))
    if len(jobs) != finished:
        fail(f"chsac_af: job_log has {len(jobs)} rows for {finished} finishes")
    if arrived != finished + queued + placed + dropped:
        fail(f"chsac_af: conservation broken: {arrived} arrived != {finished} + "
             f"{queued} + {placed} + {dropped}")
    if not bool(st.done) or abs(float(st.t) - MAIN_DURATION_S) > 1e-3:
        fail(f"chsac_af: run did not reach its end (t={float(st.t)})")
    ticks = sorted({float(r["time_s"]) for r in cl})
    by_t = {}
    for r in cl:
        by_t.setdefault(float(r["time_s"]), []).append(r)
    e_last = sum(float(r["energy_kJ"]) for r in by_t[ticks[-1]]) * 1e3
    e_first = sum(float(r["energy_kJ"]) for r in by_t[ticks[0]]) * 1e3
    p_t = [sum(float(r["power_W"]) for r in by_t[t]) for t in ticks]
    riemann = sum(0.5 * (p_t[i] + p_t[i + 1]) * (ticks[i + 1] - ticks[i])
                  for i in range(len(ticks) - 1))
    if not (e_last > 0 and abs((e_last - e_first) - riemann) <= 0.05 * riemann):
        fail(f"chsac_af: energy {e_last - e_first:.1f} J vs sum P*dt {riemann:.1f} J")
    dcs = {r["dc"] for r in jobs}
    rate = events / wall
    print(f"chsac_af: {events} events in {MAIN_DURATION_S:.0f} s simulated, "
          f"{wall:.2f} s wall, {rate:.1f} events/s, {finished} finished on "
          f"{len(dcs)} DCs, {arrived} arrived, {dropped} dropped, {n_seen} "
          f"transitions in the replay ring (= the chunks' valid records); "
          f"launches per chunk: B1 {n_b1}, B2 {n_b2}, B6a {n_b6} for {n_chunks} "
          f"chunks; synchronizing CUDA calls with the B1 or B6a wrapper on the "
          f"stack: {syncs.in_chunk} ({syncs.total} in the whole run); energy "
          f"{e_last / 3.6e6:.4f} kWh at the last tick")
    report["chsac_cli"] = {"events": events, "wall_s": wall, "events_per_s": rate,
                           "arrived": arrived, "finished": finished,
                           "dropped": dropped, "n_seen": n_seen,
                           "chunks": n_chunks, "b1_launches": n_b1,
                           "b2_launches": n_b2, "b6a_launches": n_b6,
                           "syncs_in_chunks": syncs.in_chunk,
                           "syncs_total": syncs.total, "dcs_used": len(dcs)}
    return {"event_scan": n_b1, "rl": n_rl, "arrival_tables": n_b2,
            "replay_ingest": n_b6}


# ------------------------------------------------- chsac_af: the update

N_Q, UPDATE_B = 32, 256  # the published quantiles and batch


def _bits(a, b):
    """Bitwise equality of two tensors of one dtype and shape (float32 by
    their bits, so -0.0 and +0.0 differ)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def _bits16(a, b):
    """Bitwise equality of two bf16 tensors of one shape."""
    return a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape and \
        torch.equal(a.contiguous().view(torch.int16),
                    b.contiguous().view(torch.int16))


def seeded_policy_logp(g, B, n_dc, n_g):
    """Masked log-probabilities of both heads: random masks, row 0 with every
    DC masked (a uniform head), row 1 with every GPU count masked, row 2 with
    one feasible DC."""
    from distributed_cluster_gpus_tpu_torch.rl.nets import masked_log_softmax

    m_dc = torch.rand((B, n_dc), generator=g) < 0.6
    m_g = torch.rand((B, n_g), generator=g) < 0.6
    m_dc[:, 0] = True
    m_g[:, min(1, n_g - 1)] = True
    m_dc[0] = False
    m_g[min(1, B - 1)] = False
    m_dc[min(2, B - 1)] = False
    m_dc[min(2, B - 1), n_dc - 1] = True
    return (masked_log_softmax(torch.randn((B, n_dc), generator=g), m_dc),
            masked_log_softmax(torch.randn((B, n_g), generator=g), m_g))


def seeded_ring(C, windows, N, p_valid, seed, obs_dim=49, n_dc=8, n_g=8,
                one_valid=False):
    """A replay ring on the card filled through B6a (``replay_add_chunk``)
    with seeded windows (``done`` in {0, 1})."""
    from distributed_cluster_gpus_tpu_torch.rl import replay

    rb = replay.replay_init(C, obs_dim, n_dc, n_g, 4, device="cuda")
    g = torch.Generator().manual_seed(seed)
    for _ in range(windows):
        tr = seeded_window(g, N, obs_dim, n_dc, n_g, p_valid)
        tr["costs"] = tr["costs"].abs() * 400
        tr["done"] = (torch.rand(N, generator=g) < 0.5).float()
        if one_valid:
            tr["valid"][N // 3] = True
        replay.replay_add_chunk(rb, {k: v.cuda() for k, v in tr.items()})
    return rb


#: phase (j)'s edge shapes of B5a (B, N, M) and B5b's actor term (B,
#: n_dc, n_g, N, q layout), beside the update's published shape
EDGE_B5A = ((257, 33, 64), (3, 7, 5))
EDGE_B5B = ((257, 3, 4, 64, "heads"), (3, 16, 16, 32, "onehot"))


#: the outputs ``tail_calls`` returns, in order
TAIL_OUTPUTS = ("B5a loss", "B5a gradient", "target_q", "r_eff", "actor loss",
                "H", "dlogp_dc", "dlogp_g", "lam", "integral", "prev_err",
                "critic_loss", "q_mean", "r_eff_mean", "actor_loss", "entropy",
                "alpha_loss", "alpha (unused)", "lambda", "violation",
                "alpha_grad")


def tail_state():
    """(gains, CMDP state, metric buffers) on the card for the tail calls:
    seeded multipliers and PID memories, gains with every term non-zero."""
    from distributed_cluster_gpus_tpu_torch.rl import cmdp

    g = torch.Generator().manual_seed(4)
    st = cmdp.CMDPState(lam=torch.rand(4, generator=g).cuda(),
                        integral=torch.rand(4, generator=g).cuda(),
                        prev_err=(torch.rand(4, generator=g) * 50).cuda())
    gains = cmdp._gains((cmdp.ConstraintSpec("lat", 500.0, kd=0.02),
                         cmdp.ConstraintSpec("pow", 300.0, kp=0.1),
                         cmdp.ConstraintSpec("over", 0.0, lambda_max=1.0),
                         cmdp.ConstraintSpec("en", 1e30)), "cuda")
    outs = [torch.zeros((), device="cuda") for _ in range(7)] + [
        torch.zeros(4, device="cuda") for _ in range(2)] + [
        torch.zeros(1, device="cuda")]
    return gains, st, outs


def tail_calls(fns, q, tgt, taus, take, qa, ldc, lg, x, gains, st, outs):
    """B5a with the taken action and q_mean, B5b's target with its PID
    tail and its actor term with the temperature's, through ``fns`` (the
    wrappers or the plain versions): every output (``TAIL_OUTPUTS``)."""
    from distributed_cluster_gpus_tpu_torch.rl.sac import PidTail, TempTail

    huber, target, actor = fns
    loss, qm, r_mean, a_loss, h, al_loss, _, lam, viol, al_grad = outs
    l_, dq = huber(q, tgt, taus, 1.0, take, loss, qm)
    tq, r_eff = target(qa, ldc, lg, x["r"], x["costs"], st.lam, gains[0],
                       x["done"], x["log_alpha"], 0.99,
                       PidTail(st, gains, r_mean, lam, viol))
    a_ = actor(qa, ldc, lg, x["log_alpha"], a_loss,
               TempTail(-3.0, h, al_loss, al_grad))
    return [l_, dq, tq, r_eff, *a_, st.lam, st.integral, st.prev_err, *outs]


def tail_bytes(B, obs, n_dc, n_g, N):
    """The bytes R1d's ops must move once (phase (k)'s bound): the
    observations read as float32 and written as bf16, the costs, rewards,
    entropies and the scalars, the taken quantiles read for their mean,
    the CMDP state and the metrics."""
    return B * (2 * obs * (4 + 2) + 4 * 4 + 2 * 4 + 2 * 4
                + 2 * (n_dc + n_g)) + B * 2 * N * 4 + 64 * 4


def tail_timing(b5, b5c, b6b, rsac, replay, optim, q, tgt, taus, t_args, ldc,
                lg, log_alpha, groups, cfg, rb, key, index):
    """R1d's device time per update at the main path's shapes (the one-hot
    critic): for each host kernel, its call with the tail outputs less the
    same call without, both timed back to back (``device_ms``); the plain
    tail's time; its bound."""
    import dataclasses

    from distributed_cluster_gpus_tpu_torch.rl.sac import PidTail, TempTail

    gains, st, outs = tail_state()
    loss, qm, r_mean, a_loss, h, al_loss, _, lam, viol, al_grad = outs
    qa = t_args[0]
    exp_out = torch.zeros((), device="cuda")
    with_exp = [dataclasses.replace(gr, exp_out=exp_out)
                if gr.clamp is not None else gr for gr in groups]
    pairs = {
        "b5a q_mean": ((lambda: b5.quantile_huber(q, tgt, taus, 1.0, None,
                                                  loss, qm)),
                       (lambda: b5.quantile_huber(q, tgt, taus)),
                       "quantile_huber_kernel"),
        "b5b target PID": ((lambda: b5.marginal_target(
            *t_args[:5], st.lam, gains[0], t_args[7], log_alpha, 0.99,
            PidTail(st, gains, r_mean, lam, viol))),
            (lambda: b5.marginal_target(*t_args)), "marginal_target_kernel"),
        "b5b actor temperature": ((lambda: b5.marginal_actor(
            qa, ldc, lg, log_alpha, a_loss, TempTail(-3.0, h, al_loss,
                                                     al_grad))),
            (lambda: b5.marginal_actor(qa, ldc, lg, log_alpha)),
            "marginal_actor_kernel"),
        "b5c exp(log alpha)": ((lambda: b5c.adam_update(with_exp, cfg)),
                               (lambda: b5c.adam_update(groups, cfg)),
                               "adam_"),
        "b6b casts + index": ((lambda: b6b.replay_sample(
            rb, key, UPDATE_B, index=index, bf16_obs=True, advance=True)),
            (lambda: b6b.replay_sample(rb, key, UPDATE_B, index=index)),
            "replay_sample_"),
    }
    deltas = {}
    for name, (with_tail, without, kern) in pairs.items():
        # in turns: without, with, with, without
        a1 = device_ms(without, kern)[0]
        b1_ = device_ms(with_tail, kern)[0]
        b2_ = device_ms(with_tail, kern)[0]
        a2 = device_ms(without, kern)[0]
        deltas[name] = (b1_ + b2_ - a1 - a2) / 2
    ms = sum(deltas.values())
    # the plain tail as the parent's update ran it in torch: the casts, the
    # exp, the q mean, the temperature, the PID step, the index's step
    s0 = rb.s0[:UPDATE_B]
    ent = torch.rand(UPDATE_B, device="cuda") * 4
    r_eff = torch.randn(UPDATE_B, device="cuda")
    costs = rb.costs[:UPDATE_B]
    pid = PidTail(st, gains, r_mean, lam, viol)

    def plain_tail():
        s0.to(torch.bfloat16)
        s0.to(torch.bfloat16)
        torch.exp(log_alpha)
        qm.copy_(rsac.batch_mean(rsac.tree_sum_last(q).reshape(-1)))
        for o, v in zip((h, al_loss, al_grad),
                        rsac.temperature(ent, log_alpha, -3.0)):
            o.copy_(v)
        rsac.pid_tail(pid, r_eff, costs)
        index.add_(1)

    plain_ms = time_cuda(plain_tail, reps=20)
    by = tail_bytes(UPDATE_B, rb.s0.shape[1], ldc.shape[1], lg.shape[1], N_Q)
    bnd, bnd_by = bound(by, 0)
    print("R1d, the update's tail inside its host kernels (device us, the "
          "call with its tail less the call without): "
          + "; ".join(f"{k} {v * 1e3:.3f}" for k, v in deltas.items()))
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd, "bound_by": bnd_by, "bytes": by,
            "library_ms": None, "deltas_ms": deltas,
            "profiler_launches_seen": None}


def phase_update_kernels(report):
    """(j) B5a, B5b, B5c and B6b against their plain versions on the card,
    bitwise, at the update's published shapes (B = 256, N = 32, 8 x 8 joint
    actions, the four parameter groups, a 200,000-row ring), on seeded
    inputs with the edge cases (B5a and B5b's actor term also at the edge
    shapes ``EDGE_B5A``, ``EDGE_B5B``); each timed (device time of launches queued
    back to back) beside its plain version, its bound and, where one
    PyTorch call computes the same function, that call.  Then the update's
    tail (R1d) inside those kernels, bitwise (``tail_calls``), and timed
    (``tail_timing``)."""
    from distributed_cluster_gpus_tpu_torch.kernels import adam as b5c
    from distributed_cluster_gpus_tpu_torch.kernels import replay_sample as b6b
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5
    from distributed_cluster_gpus_tpu_torch.ops import prng
    from distributed_cluster_gpus_tpu_torch.rl import optim, replay
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac

    B, N, n_dc, n_g = UPDATE_B, N_Q, 8, 8
    A = n_dc * n_g
    g = torch.Generator().manual_seed(41)
    out = {}
    # ---- B5a: |td| exactly at kappa (row 0) and at 0 (row 1)
    q = torch.randn((B, 2, N), generator=g)
    tgt = torch.randn((B, N), generator=g) * 2
    q[0, 0, :4] = torch.tensor([0.25, -0.5, 1.5, 2.0])
    tgt[0, :4] = q[0, 0, :4] + 1.0
    tgt[1, :4] = q[1, 1, :4]
    taus = (torch.arange(N, dtype=torch.float32) + 0.5) / N
    q, tgt, taus = q.cuda(), tgt.cuda(), taus.cuda()
    lk, gk = b5.quantile_huber(q, tgt, taus)
    lp, gp = rsac.quantile_huber_loss(q, tgt, taus)
    if not (_bits(lk, lp) and _bits(gk, gp)):
        fail(f"B5a differs from its plain version (loss {float(lk)} vs "
             f"{float(lp)}, grad max abs {max_abs_diff(gk, gp):.3g})")
    # the redesigned kernel at two edges of its envelope: M != N, a batch
    # tail of 257 rows, N > 32 (a register level over i), widths not powers
    # of two
    for Bx, Nx, Mx in EDGE_B5A:
        qx = torch.randn((Bx, 2, Nx), generator=g)
        tx = torch.randn((Bx, Mx), generator=g) * 2
        n = min(Nx, Mx, 2)
        tx[0, :n] = qx[0, 0, :n] + 1.0
        tx[-1, :n] = qx[-1, 1, :n]
        qx[0, 1, 0], tx[0, 0] = 0.0, -0.0
        taux = (torch.arange(Nx, dtype=torch.float32) + 0.5) / Nx
        qx, tx, taux = qx.cuda(), tx.cuda(), taux.cuda()
        for k_, p_ in zip(b5.quantile_huber(qx, tx, taux),
                          rsac.quantile_huber_loss(qx, tx, taux)):
            if not _bits(k_, p_):
                fail(f"B5a differs from its plain version at B = {Bx}, "
                     f"N = {Nx}, M = {Mx}")
    ms, seen = device_ms(lambda: b5.quantile_huber(q, tgt, taus),
                         "quantile_huber_kernel")
    plain = time_cuda(lambda: rsac.quantile_huber_loss(q, tgt, taus), reps=10)
    by = 4 * (2 * B * N + B * N + N + 2 * B * N + 1)
    bnd, bnd_by = bound(by, 2 * B * N * N * 16)
    out["b5a"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
                  "bound_ms": bnd, "bound_by": bnd_by, "bytes": by,
                  "library_ms": None, "profiler_launches_seen": seen}
    # ---- B5b: the one-hot critic's [B, A, 2, N] layout (the main path's)
    # and the heads critic's [B, 2, A, N]; masked and all-masked heads,
    # done in {0, 1}
    q_oh = torch.randn((B, A, 2, N), generator=g).cuda().permute(0, 2, 1, 3)
    q_h = torch.randn((B, 2, A, N), generator=g).cuda()
    ldc, lg = (t.cuda() for t in seeded_policy_logp(g, B, n_dc, n_g))
    r = torch.randn(B, generator=g).cuda()
    costs = (torch.rand((B, 4), generator=g) * 900).cuda()
    lam = torch.tensor([0.4, 0.0, 2.0, 0.0]).cuda()
    tg = torch.tensor([500.0, 1e30, 0.0, 1e30]).cuda()
    done = (torch.arange(B) % 2).float().cuda()
    alpha = torch.tensor(-1.6).cuda()  # log alpha: the kernels take exp
    for name, qq in (("onehot", q_oh), ("heads", q_h)):
        args = (qq, ldc, lg, r, costs, lam, tg, done, alpha, 0.99)
        for k_, p_ in zip(b5.marginal_target(*args), rsac.marginal_target(*args)):
            if not _bits(k_, p_):
                fail(f"B5b target ({name} layout) differs from its plain version")
        ko = b5.marginal_actor(qq, ldc, lg, alpha)
        po = rsac.marginal_actor(qq, ldc, lg, alpha)
        for what, k_, p_ in zip(("loss", "H", "dlogp_dc", "dlogp_g"), ko, po):
            if not (_bits(k_, p_) and bool(torch.isfinite(k_).all())):
                fail(f"B5b actor ({name} layout): {what} differs from its plain "
                     "version or is not finite")
    # the redesigned actor term at two edges of its envelope: heads that
    # are not powers of two with N = 64 (the tree over N in registers and
    # shuffles) and a batch tail of 257 rows; 16 x 16 heads (Ap = 256)
    for Bx, d_, c_, Nx, lay in EDGE_B5B:
        A_ = d_ * c_
        qx = (torch.randn((Bx, 2, A_, Nx), generator=g).cuda() if lay == "heads"
              else torch.randn((Bx, A_, 2, Nx), generator=g).cuda().permute(0, 2, 1, 3))
        lx = [t.cuda() for t in seeded_policy_logp(g, Bx, d_, c_)]
        for what, k_, p_ in zip(("loss", "H", "dlogp_dc", "dlogp_g"),
                                b5.marginal_actor(qx, *lx, alpha),
                                rsac.marginal_actor(qx, *lx, alpha)):
            if not _bits(k_, p_):
                fail(f"B5b actor ({lay} layout, B = {Bx}, {d_} x {c_}, "
                     f"N = {Nx}): {what} differs from its plain version")
    t_args = (q_oh, ldc, lg, r, costs, lam, tg, done, alpha, 0.99)
    ms, seen = device_ms(lambda: b5.marginal_target(*t_args),
                         "marginal_target_kernel")
    plain = time_cuda(lambda: rsac.marginal_target(*t_args), reps=10)
    by = 4 * (B * 2 * A * N + B * (n_dc + n_g) + 6 * B + 8 + B * N + B)
    bnd, bnd_by = bound(by, 5 * B * A * N)
    out["b5b_target"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
                         "bound_ms": bnd, "bound_by": bnd_by, "bytes": by,
                         "library_ms": None, "profiler_launches_seen": seen}
    ms, seen = device_ms(lambda: b5.marginal_actor(q_oh, ldc, lg, alpha),
                         "marginal_actor_kernel")
    plain = time_cuda(lambda: rsac.marginal_actor(q_oh, ldc, lg, alpha), reps=10)
    by = 4 * (B * 2 * A * N + 2 * B * (n_dc + n_g) + B + 2)
    bnd, bnd_by = bound(by, 3 * B * A * N + 10 * B * A)
    out["b5b_actor"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
                        "bound_ms": bnd, "bound_by": bnd_by, "bytes": by,
                        "library_ms": None, "profiler_launches_seen": seen}
    # ---- B5c: the four groups at their published sizes in one call (the
    # update's: the networks' gradients bf16, their shadows written, the
    # critic's target and its shadow; log alpha's gradient float32, its
    # clamp), and the same with float32 gradients and no shadows; the clip
    # on and off, a zero gradient, steps 1 and 1,000, the count at
    # saturation
    sizes = {"critic": 287_808, "actor": 69_904, "enc": 144_384, "alpha": 1}
    cfg = optim.AdamConfig()
    clamp = float(torch.log(torch.tensor(10.0)))
    bf16 = torch.bfloat16

    def b5c_groups(host, casts):
        """The update's AdamGroups on the card from host tensors; with
        ``casts`` the networks' gradients bf16 and their shadows given."""
        out_ = []
        for grp, p, grad, step, mu, nu, tgt0 in host:
            net = casts and grp != "alpha"
            out_.append(b5c.AdamGroup(
                p.cuda(), (grad.to(bf16) if net else grad).cuda(),
                optim.AdamState(torch.tensor(step, dtype=torch.int32).cuda(),
                                mu.cuda(), nu.cuda()),
                None if tgt0 is None else tgt0.cuda(), tau=0.005,
                clamp=clamp if grp == "alpha" else None,
                shadow=torch.empty(p.numel(), dtype=bf16, device="cuda")
                if net else None,
                target_shadow=torch.empty(p.numel(), dtype=bf16, device="cuda")
                if net and tgt0 is not None else None))
        return out_

    n_case = 0
    for case in ("clip", "no_clip", "zero", "step1000", "saturated"):
        host = []
        for grp, n in sizes.items():
            p = torch.randn(n, generator=g)
            if grp == "alpha":
                p.fill_(clamp - 1e-4)
            grad = torch.randn(n, generator=g) * (0.1 if case == "clip" else 1e-4)
            if case == "zero":
                grad.zero_()
            step = {"step1000": 999, "saturated": optim.INT32_MAX}.get(case, 0)
            mu = torch.randn(n, generator=g) * 0.01 if step else torch.zeros(n)
            nu = torch.rand(n, generator=g) * 1e-4 if step else torch.zeros(n)
            tgt0 = torch.randn(n, generator=g) if grp == "critic" else None
            host.append((grp, p, grad, step, mu, nu, tgt0))
        for casts in (True, False):
            res = []
            for plain_path in (False, True):
                groups = b5c_groups(host, casts)
                b5c.adam_update(groups, cfg, plain=plain_path)
                res.append([t for gr in groups for t in
                            (gr.p, gr.st.mu, gr.st.nu, gr.st.count)
                            + tuple(x for x in (gr.target, gr.shadow,
                                                gr.target_shadow)
                                    if x is not None)])
            if not all((_bits16 if x.dtype == bf16 else _bits)(x, y)
                       for x, y in zip(*res)):
                what = "bf16 gradients, shadows" if casts else "float32 gradients"
                fail(f"B5c {case} ({what}): differs from its plain version")
            if casts and not all(_bits16(gr.shadow, gr.p.to(bf16))
                                 for gr in groups if gr.shadow is not None):
                fail(f"B5c {case}: a shadow is not bf16 of its parameters")
            n_case += 1
    groups = b5c_groups([
        (grp, torch.randn(n, generator=g), torch.randn(n, generator=g) * 0.01,
         0, torch.zeros(n), torch.zeros(n),
         torch.randn(n, generator=g) if grp == "critic" else None)
        for grp, n in sizes.items()], True)

    def adam_update(plain_path=False):
        b5c.adam_update(groups, cfg, plain=plain_path)

    ms, seen = device_ms(adam_update, "adam_")
    plain = time_cuda(lambda: adam_update(True), reps=5)
    lib_params = [torch.nn.Parameter(gr.p.clone()) for gr in groups]
    for lp_, gr in zip(lib_params, groups):
        lp_.grad = gr.g.float()
    lib_opt = torch.optim.Adam([{"params": [lp_]} for lp_ in lib_params],
                               lr=cfg.lr, fused=True)

    def lib_update():
        for lp_ in lib_params:
            torch.nn.utils.clip_grad_norm_([lp_], cfg.max_norm)
        lib_opt.step()

    lib = time_cuda(lib_update, reps=20)
    n_all = sum(sizes.values())
    # a bf16 gradient read (float32 for log alpha), p, mu, nu read and
    # written, the shadow written; the critic's target read and written and
    # its shadow written
    by = 28 * n_all + 10 * sizes["critic"]
    bnd, bnd_by = bound(by, 20 * n_all)
    out["b5c"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
                  "bound_ms": bnd, "bound_by": bnd_by, "bytes": by,
                  "library_ms": lib, "cases": n_case,
                  "profiler_launches_seen": seen}
    # ---- B5g's kernel, the shadows' refresh outside the update (the four
    # groups at their published sizes: the target's as large as the
    # critic's), bitwise against its plain version
    from distributed_cluster_gpus_tpu_torch.kernels.param_pack import param_pack

    nets = dict(sizes, target=sizes["critic"])
    del nets["alpha"]
    srcs = [torch.randn(n, generator=g).cuda() * 3 for n in nets.values()]
    srcs[0][:4] = torch.tensor([0.0, -0.0, 1e-40, 3.4e38])
    dsts = [[torch.empty(n, dtype=bf16, device="cuda") for n in nets.values()]
            for _ in range(2)]
    param_pack(list(zip(srcs, dsts[0])))
    optim.pack_plain(list(zip(srcs, dsts[1])))
    if not all(_bits16(a, b) for a, b in zip(*dsts)):
        fail("B5g (the shadows' refresh) differs from its plain version")
    pairs = list(zip(srcs, dsts[0]))
    ms, seen = device_ms(lambda: param_pack(pairs), "param_pack_kernel")
    plain = time_cuda(lambda: optim.pack_plain(pairs), reps=20)
    lib = time_cuda(lambda: [x.to(bf16) for x in srcs], reps=20)
    by = 6 * sum(nets.values())
    bnd, bnd_by = bound(by, sum(nets.values()))
    out["b5g"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
                  "bound_ms": bnd, "bound_by": bnd_by, "bytes": by,
                  "library_ms": lib, "profiler_launches_seen": seen}
    # ---- B6b: 200,000-row rings: empty, full, wrapped with invalid gaps,
    # one valid row; batches 1, 256 and 4,096; the sample key given or
    # derived on the card from a chunk key and an update index
    C = 200_000
    rings = {"empty": seeded_ring(C, 0, 4000, 0.0, 1),
             "full": seeded_ring(C, 50, 4000, 1.0, 2),
             "wrapped_gaps": seeded_ring(C, 60, 4000, 0.7, 3),
             "one_valid": seeded_ring(C, 1, 4000, 0.0, 4, one_valid=True)}
    if int(rings["full"].size) != C:
        fail("B6b: the full ring is not full")
    index = torch.tensor(5, dtype=torch.int32, device="cuda")
    for name, rb in rings.items():
        for i, (bs, idx_arg) in enumerate(((B, None), (B, index), (1, None),
                                           (4096, index))):
            key = prng.split(prng.key(60 + i, "cuda"), 2)[0]
            ko = b6b.replay_sample(rb, key, bs, index=idx_arg)
            po = replay.replay_sample(rb, b6b.sample_key(key, idx_arg), bs)
            for f in (*replay.ROW_FIELDS, "idx"):
                if not _bits(ko[f], po[f]):
                    fail(f"B6b {name} ring, batch {bs}: {f} differs from its "
                         "plain version")
    rb = rings["wrapped_gaps"]
    key = prng.split(prng.key(77, "cuda"), 2)[0]
    ms, seen = device_ms(lambda: b6b.replay_sample(rb, key, B, index=index),
                         "replay_sample_")
    plain = time_cuda(lambda: replay.replay_sample(
        rb, b6b.sample_key(key, index), B), reps=10)
    u = prng.uniform_vec(b6b.sample_key(key, index), B)

    def lib_sample():
        cdf = torch.cumsum(rb.valid.to(torch.float32), 0)
        idx = torch.searchsorted(cdf, u * cdf[-1].clamp(min=1.0), right=True)
        idx = idx.clamp(0, C - 1)
        return [getattr(rb, f).index_select(0, idx) for f in replay.ROW_FIELDS]

    lib = time_cuda(lib_sample, reps=20)
    row = sum(getattr(rb, f)[0].numel() * getattr(rb, f).element_size()
              for f in replay.ROW_FIELDS)
    by = C + 2 * B * row + 4 * B
    # three threefry blocks a draw (the update's key, the sample key, the
    # draw) and a count per validity byte
    bnd, bnd_by = bound(by, B * 3 * THREEFRY_OPS + 2 * C)
    out["b6b"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
                  "bound_ms": bnd, "bound_by": bnd_by, "bytes": by,
                  "library_ms": lib, "profiler_launches_seen": seen}
    # ---- R1d, the update's tail inside its host kernels (the heads
    # critic's layout for B5a's taken action and gradient scatter; the
    # one-hot critic's, the main path's, for the rest): every output and
    # the CMDP state bitwise against the plain versions; then its device
    # time, each host kernel called as the main path calls it less the same
    # call without its tail outputs
    take = (torch.randint(0, n_dc, (B,), dtype=torch.int32, generator=g).cuda(),
            torch.randint(0, n_g, (B,), dtype=torch.int32, generator=g).cuda(),
            n_g)
    tail_in = (q_h, tgt[:, :N].contiguous(), taus, take, q_oh, ldc, lg,
               {"r": r, "costs": costs, "done": done, "log_alpha": alpha})
    res = []
    for fns in ((b5.quantile_huber, b5.marginal_target, b5.marginal_actor),
                (rsac.quantile_huber_loss, rsac.marginal_target,
                 rsac.marginal_actor)):
        res.append(tail_calls(fns, *tail_in, *tail_state()))
    torch.cuda.synchronize()
    for i, (k_, p_) in enumerate(zip(*res)):
        if not _bits(k_, p_):
            fail(f"R1d: the tail's output {TAIL_OUTPUTS[i]} differs from its "
                 "plain version")
    out["update_tail"] = tail_timing(b5, b5c, b6b, rsac, replay, optim, q, tgt,
                                     taus, t_args, ldc, lg, alpha, groups, cfg,
                                     rings["wrapped_gaps"], key, index)
    names = {"b5a": "B5a quantile-Huber (loss + gradient)",
             "b5b_target": "B5b target marginalization",
             "b5b_actor": "B5b actor marginalization (+ gradient)",
             "b5c": "B5c clipped Adam, four groups (one update, B5g's casts "
                    "inside)",
             "b5g": "B5g's kernel, the four shadows' refresh (outside the "
                    "update)",
             "b6b": "B6b replay sample (C=200,000)",
             "update_tail": "R1d the update's tail inside B5a, B5b, B5c, B6b "
                            "(the calls with their tail outputs less the "
                            "calls without)"}
    out["b5c"]["kernel_us"] = KERNEL_US.get("adam_")
    out["b6b"]["kernel_us"] = KERNEL_US.get("replay_sample_")
    print(f"B5c kernels (profiled, median us): {out['b5c']['kernel_us']}; "
          f"B6b: {out['b6b']['kernel_us']}")
    for k, v in out.items():
        lib_s = "none" if v["library_ms"] is None else f"{v['library_ms']:.4f} ms"
        print(f"{names[k]}: bitwise equal to its plain version; kernel "
              f"{v['ms']:.4f} ms device time (back to back; the profiler saw "
              f"{v['profiler_launches_seen']} launches), plain "
              f"{v['plain_ms']:.4f} ms, library {lib_s}, bound "
              f"{v['bound_ms']:.6f} ms ({v['bound_by']}: {v['bytes']} B)")
    print(f"B5a also bitwise at (B, N, M) = {EDGE_B5A}; B5b actor at (B, n_dc, "
          f"n_g, N, layout) = {EDGE_B5B}")
    out["b5a"]["edge_shapes"] = EDGE_B5A
    out["b5b_actor"]["edge_shapes"] = EDGE_B5B
    report.update(out)


def _clone(x):
    """A copy of a nest of tensors, each with its own strides (a strided
    view stays strided)."""
    if isinstance(x, torch.Tensor):
        out = torch.empty_strided(x.size(), x.stride(), dtype=x.dtype,
                                  device=x.device)
        return out.copy_(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _same_bits(a, b):
    """Bitwise equality of two tensors (float32 and bf16 by their bits)."""
    views = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    v = views.get(a.dtype)
    if v is None:
        return torch.equal(a, b)
    return torch.equal(a.contiguous().view(v), b.contiguous().view(v))


def record_fused_calls(agent):
    """One eager update of ``agent`` with the fused regions' wrappers
    (``FUSED``) recording a copy of every call's arguments as the main
    path gives them: {wrapper: [(args, kwargs), ...]}."""
    import importlib

    mods = {name: importlib.import_module(
        f"distributed_cluster_gpus_tpu_torch.kernels.{mod}")
        for name, (mod, _, _) in FUSED.items()}
    orig = {name: getattr(m, name) for name, m in mods.items()}
    rec = {name: [] for name in mods}

    def recording(name):
        def call(*args, **kw):
            rec[name].append(_clone((args, kw)))
            return orig[name](*args, **kw)
        call.launches = 0  # the wrapper counts into its module's name
        return call

    for name, m in mods.items():
        setattr(m, name, recording(name))
    try:
        agent.train_steps(1, 1, graph=False)
        torch.cuda.synchronize()
    finally:
        for name, m in mods.items():
            setattr(m, name, orig[name])
    return rec, orig


def _fused_bytes(name, args, kw=None):
    """(bytes, float32 operations, bf16 tensor operations) one call (its
    positional ``args`` and keywords ``kw``) must move and do: each input
    read once, each output written once; a product 2 R K N operations at
    the bf16 tensor peak, an epilogue's float32."""
    nb = lambda t: t.numel() * t.element_size()  # noqa: E731
    if name == "dense_fwd":
        x, w, bias, _ = args[:4]
        out32 = args[4] if len(args) > 4 else None
        R, N = x.shape[0], w.shape[1]
        return (nb(x) + nb(w) + nb(bias) + 2 * R * N
                + (0 if out32 is None else 4 * R * N)), 3 * R * N, \
            2 * R * x.shape[1] * N
    if name == "dense_dx":
        g, w, y, db = args[:4]
        pairs = [(g, w)] + ([tuple(args[4:6])] if len(args) > 4
                            and args[4] is not None else [])
        R, N = g.shape[0], w.shape[0]
        return (sum(nb(a) + nb(b) for a, b in pairs) + 2 * R * N + nb(db)
                + (0 if y is None else nb(y))), 4 * R * N, \
            sum(2 * R * a.shape[1] * N for a, _ in pairs)
    if name == "dense_backward":
        g, y, db = args[:3]
        g2 = args[3] if len(args) > 3 else None
        n = g.numel()
        return (nb(g) + 2 * n + nb(db) + (0 if y is None else nb(y))
                + (0 if g2 is None else nb(g2))), 4 * n, 0
    if name == "critic_first_fwd":  # the rows are built, not read
        lat, n_dc, n_g, w, bias = args[:5]
        acts = [a for a in args[5:7] if a is not None]
        R, (K, N) = lat.shape[0] * (1 if acts else n_dc * n_g), w.shape
        keep = (kw or {}).get("keep_rows", False)
        return (nb(lat) + sum(nb(a) for a in acts) + nb(w) + nb(bias)
                + 2 * R * N + (2 * R * K if keep else 0)), 3 * R * N, \
            2 * R * K * N
    if name == "actor_heads_fwd":
        x, k_dc, b_dc, k_g, b_g, m_dc, m_g = args[:7]
        n = m_dc.numel() + m_g.numel()
        return (sum(nb(t) for t in args[:7]) + 8 * n), 43 * n, \
            2 * x.numel() * (k_dc.shape[1] + k_g.shape[1])
    # heads_backward: logits, masks, g in; G, db out
    entries = args[0].numel() + args[1].numel()
    return (sum(nb(t) for t in args[:6]) + 2 * entries + nb(args[6])
            + nb(args[7])), 40 * entries, 0


def _products(name, args):
    """The bf16 products a B5d call computes, as (a, b) with a @ b the
    product (cuBLAS's ``torch.matmul`` of them is the library call)."""
    if name == "dense_fwd":
        return [(args[0], args[1])]
    if name == "dense_dx":
        pairs = [(args[0], args[1])]
        if len(args) > 4 and args[4] is not None:
            pairs.append((args[4], args[5]))
        return [(a, b.t()) for a, b in pairs]
    return []


def _library_call(name, calls):
    """One PyTorch call computing the same function for each recorded call,
    or None: the log-softmax of the masked logits (its backward from the
    forward's output), B5d's products alone (cuBLAS's ``torch.matmul``,
    without the epilogue)."""
    if name == "critic_first_fwd":  # the product on prebuilt rows (cuBLAS)
        from distributed_cluster_gpus_tpu_torch.rl.nets import critic_input
        ins = [(critic_input(*a[:3], *a[5:7]), a[3]) for a, _ in calls]
        return lambda: [torch.matmul(x, w) for x, w in ins]
    if name == "heads_backward":  # each head: the gradient, cast, sum
        ins = []
        for a, _ in calls:
            for l_, m, g in ((a[0], a[2], a[4]), (a[1], a[3], a[5])):
                out = torch.log_softmax(l_.masked_fill(~m, -1e9), -1)
                ins.append((g.clone(), out, (~m).contiguous()))
        return lambda: [torch.ops.aten._log_softmax_backward_data(
            g, out, -1, torch.float32).masked_fill_(m, 0.0).to(
                torch.bfloat16).float().sum(0).to(torch.bfloat16)
            for g, out, m in ins]
    if name in ("dense_fwd", "dense_dx"):  # the products alone (cuBLAS)
        ins = [(a.clone(), b) for args, _ in calls for a, b in _products(name, args)]
        return lambda: [torch.matmul(a, b) for a, b in ins]
    return None


def _ulp_gap(a, b):
    """The largest distance in bf16 ulps between two bf16 tensors."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def _differ(a, b):
    """The share of elements whose bits differ between two tensors."""
    v = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return float((a.contiguous().view(v) != b.contiguous().view(v)).float().mean())


def _fwd_standing(args, kw, fn):
    """B5d forward on a call whose kernel product may sum otherwise than
    cuBLAS's (ROADMAP queue C): fails unless the kernel's product (bias 0,
    no ReLU) is within one bf16 ulp of cuBLAS's and the kernel's output is
    bitwise the plain epilogue applied to the kernel's own product.
    Returns (share of product elements that differ, largest gap in ulps)."""
    from distributed_cluster_gpus_tpu_torch.rl import nets

    x, w, bias, relu = args[:4]
    out32 = args[4] if len(args) > 4 else None
    own = fn(x, w, torch.zeros_like(bias), False)
    ref = torch.matmul(x, w)
    gap = _ulp_gap(own, ref)
    o_k = None if out32 is None else _clone(out32)
    o_p = None if out32 is None else _clone(out32)
    y = fn(x, w, bias, relu, o_k, **kw)
    want = nets.dense_epilogue(own.clone(), bias, relu, o_p)
    if gap > 1 or not _same_bits(y, want) or (
            out32 is not None and not _same_bits(o_k, o_p)):
        fail(f"fused regions: dense_fwd {tuple(x.shape)} x {tuple(w.shape)}: "
             f"the product {gap} ulp from cuBLAS's (at most 1), or the "
             "epilogue not its plain version's")
    return _differ(own, ref), gap


def _shape_key(name, args, kw=None):
    """A recorded call's shape: (R, K, N) forward, (R, N, K' of each
    product) dX, (R, N, g's dtype) for the standalone backward, (R, K, N,
    whether the rows are kept) for the critic's first layer, (R, K, n_dc,
    n_g) for the heads."""
    if name == "dense_fwd":
        return (args[0].shape[0], args[0].shape[1], args[1].shape[1])
    if name == "dense_dx":
        return (args[0].shape[0], args[1].shape[0],
                *(a.shape[1] for a, _ in _products(name, args)))
    if name == "critic_first_fwd":
        lat, n_dc, n_g, w = args[:4]
        rows = lat.shape[0] * (n_dc * n_g if args[5] is None else 1)
        return (rows, *w.shape, "rows" if (kw or {}).get("keep_rows") else "")
    if name == "actor_heads_fwd":
        return (*args[0].shape, args[1].shape[1], args[3].shape[1])
    return (*args[0].shape, str(args[0].dtype).replace("torch.", ""))


#: the fused input layers: their kernels, and the B5d launches of the
#: unfused route they replace
FUSED_INPUTS = ("critic_first_fwd", "actor_heads_fwd")


def _unfused_route(name, args):
    """The unfused route's B5d launches for a fused input layer's call,
    from this checkout's ``dense_fwd``: the product on prebuilt rows (the
    critic), each head's layer with its float32 copy (the actor).  The
    route's third launch, B5e's rows or B5f's forward, is gone from this
    checkout; ``--update-ab`` times the parent's whole route."""
    from distributed_cluster_gpus_tpu_torch.kernels.dense import dense_fwd
    from distributed_cluster_gpus_tpu_torch.rl.nets import critic_input

    if name == "critic_first_fwd":
        lat, n_dc, n_g, w, bias = args[:5]
        x0 = critic_input(lat, n_dc, n_g, *args[5:7])
        return lambda: dense_fwd(x0, w, bias, True)
    x, k_dc, b_dc, k_g, b_g = args[:5]
    heads = [(k, b, torch.empty((x.shape[0], k.shape[1]), device=x.device))
             for k, b in ((k_dc, b_dc), (k_g, b_g))]
    return lambda: [dense_fwd(x, k, b, False, o) for k, b, o in heads]


def _per_shape(name, calls, fn):
    """The calls of one update of a B5d wrapper grouped by shape, each
    group timed per call: the kernel (device time, back to back), the
    plain version, the bound of the fused work and cuBLAS's product alone;
    for the fused input layers also the unfused route's B5d launches."""
    groups = {}
    for args, kw in calls:
        groups.setdefault(_shape_key(name, args, kw), []).append((args, kw))
    out = {}
    for key, grp in sorted(groups.items()):
        sets = [(_clone(a), kw) for a, kw in grp]

        def run(plain=False, sets=sets):
            for a, kw in sets:
                fn(*a, **{**kw, "plain": plain})

        ms, _ = device_ms(run, FUSED[name][1])
        plain = time_cuda(lambda: run(True), reps=5)
        lib_fn = _library_call(name, grp)
        lib = None if lib_fn is None else _queued_ms(lib_fn)
        by, f32_ops, bf16_ops = (sum(v) for v in zip(
            *(_fused_bytes(name, a, kw) for a, kw in grp)))
        bnd, bnd_by = bound2(by, f32_ops, bf16_ops)
        n = len(grp)
        row = {"calls": n, "ms_per_call": ms / n, "plain_ms_per_call": plain / n,
               "bound_ms_per_call": bnd / n, "bound_by": bnd_by,
               "library_ms_per_call": None if lib is None else lib / n}
        if name in FUSED_INPUTS:
            routes = [_unfused_route(name, a) for a, _ in sets]
            row["unfused_b5d_ms_per_call"] = device_ms(
                lambda: [r() for r in routes], "dense_fwd_gemm")[0] / n
        out["x".join(map(str, key))] = row
    return out


def check_recorded_calls(fleet, params, ring, cublas):
    """One eager update of the learning CLI's agent at ``params`` (both
    critics) on ``ring``, every call of each fused wrapper recorded and run
    again through the kernel and through the plain version from copies of
    its inputs: every output bitwise, but for B5d's forward on an x whose
    rows TMA cannot load (``_fwd_standing``); each B5d product's share of
    elements that differ from cuBLAS's into ``cublas`` by shape.  Returns
    ({arch: calls per wrapper}, {arch: (records, the wrappers)})."""
    import dataclasses

    from distributed_cluster_gpus_tpu_torch.kernels.dense import tma_ok
    from distributed_cluster_gpus_tpu_torch.rl.train import make_agent

    n_calls, recs = {}, {}
    for arch in ("onehot", "heads"):
        ag = make_agent(fleet, dataclasses.replace(params, critic_arch=arch),
                        device="cuda")
        ag.replay = ring
        rec, orig = record_fused_calls(ag)
        n_calls[arch] = {k: len(v) for k, v in rec.items()}
        want = {k: v for k, v in per_update(arch).items() if k in FUSED}
        where = f"fused regions ({arch}, batch {params.rl_batch}, {fleet.n_dc} x " \
                f"{params.max_gpus_per_job})"
        if n_calls[arch] != want:
            fail(f"{where}: calls in one update {n_calls[arch]}, expected {want}")
        for name, calls in rec.items():
            for i, (args, kw) in enumerate(calls):
                if name in ("dense_fwd", "dense_dx"):
                    key = f"{name} " + "x".join(map(str, _shape_key(name, args)))
                    prods = [torch.matmul(a, b) for a, b in _products(name, args)]
                    if name == "dense_fwd":
                        mine = [orig[name](args[0], args[1],
                                           torch.zeros_like(args[2]), False)]
                    else:  # each product alone, unmasked
                        mine = [orig[name](a, b.t(), None, torch.empty_like(args[3]))
                                for a, b in _products(name, args)]
                    agree = cublas.setdefault(key, {"calls": 0, "share_differing": 0.0,
                                                    "max_ulps": 0})
                    agree["calls"] += 1
                    agree["share_differing"] = max(agree["share_differing"], max(
                        _differ(m, p) for m, p in zip(mine, prods)))
                    agree["max_ulps"] = max(agree["max_ulps"], max(
                        _ulp_gap(m, p) for m, p in zip(mine, prods)))
                if name == "dense_fwd" and not tma_ok(args[0]):
                    _fwd_standing(_clone(args), kw, orig[name])
                    continue
                a_k, a_p = _clone(args), _clone(args)
                r_k = orig[name](*a_k, **kw)
                r_p = orig[name](*a_p, **{**kw, "plain": True})
                got, want_ = _tensors((r_k, a_k)), _tensors((r_p, a_p))
                if len(got) != len(want_) or not all(
                        _same_bits(x, y) for x, y in zip(got, want_)):
                    err = max(max_abs_diff(x.float(), y.float())
                              for x, y in zip(got, want_))
                    fail(f"{where}: {name} call {i} differs from its plain "
                         f"version (max abs {err:.3g})")
        recs[arch] = (rec, orig)
    return n_calls, recs


def phase_fused_regions(report):
    """(j, continued) the update's small fused regions (B5d-B5f): every call
    one eager update at the published shape (the learning CLI's agent,
    batch 256, both critics) makes of each wrapper, recorded with its
    inputs, run again through the kernel and through the plain version
    from copies of those inputs: every output bitwise, but for B5d's
    forward on an x whose rows TMA cannot load (the encoder's first layer,
    49 observations): there cuBLAS runs another product kernel, so the
    kernel's product is held within one bf16 ulp of cuBLAS's and its
    epilogue bitwise (``_fwd_standing``).  The share of product elements
    that differ from cuBLAS's is recorded per call shape.  Then the one-hot
    update's calls of each wrapper timed back to back (device time of one
    update's calls), beside the plain versions, the bound (the larger of
    the bytes these calls move at the HBM peak and their operations at
    their peaks) and a one-call PyTorch yardstick where one computes the
    same function (for B5d cuBLAS's products alone); B5d's calls also shape
    by shape."""
    from distributed_cluster_gpus_tpu_torch.rl.nets import pin_f32_accumulation

    pin_f32_accumulation()
    fleet, params, _ = learning_params()
    ring = seeded_ring(params.rl_buffer, 5, 4096, 0.5, 8)
    out, cublas = {}, {}
    n_calls, recs = check_recorded_calls(fleet, params, ring, cublas)
    print("B5d against cuBLAS (pinned float32 accumulation) on the products "
          "one update's calls gave it: " + "; ".join(
              f"{k}: {v['share_differing']:.6f} of elements differ, at most "
              f"{v['max_ulps']} ulp ({v['calls']} calls)" for k, v in cublas.items()))
    rec, orig = recs["onehot"]
    shapes, per_shape = {}, {}
    for name, calls in rec.items():
        sets = [_clone(args) for args, _ in calls]
        kws = [kw for _, kw in calls]

        def run(plain=False, sets=sets, kws=kws, fn=orig[name]):
            for a, kw in zip(sets, kws):
                fn(*a, **{**kw, "plain": plain})

        ms, seen = device_ms(run, FUSED[name][1])
        plain = time_cuda(lambda: run(True), reps=5)
        lib_fn = _library_call(name, calls)
        # B5d's yardstick, cuBLAS's products, as device time (queued behind
        # a spin, as the kernels' are); the others' host to host
        lib = None if lib_fn is None else (
            _queued_ms(lib_fn) if name.startswith("dense") or name in FUSED_INPUTS
            else time_cuda(lib_fn, reps=20))
        by, f32_ops, bf16_ops = (sum(v) for v in zip(
            *(_fused_bytes(name, a, kw) for a, kw in calls)))
        bnd, bnd_by = bound2(by, f32_ops, bf16_ops)
        shapes[name] = sorted({tuple(a[0].shape) for a, _ in calls})
        if name.startswith("dense") or name in FUSED_INPUTS:
            per_shape[name] = _per_shape(name, calls, orig[name])
        out[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
                     "bound_ms": bnd, "bound_by": bnd_by, "bytes": by,
                     "bf16_ops": bf16_ops,
                     "library_ms": lib, "calls_per_update": len(calls),
                     "profiler_launches_seen": seen,
                     "kernel_us": KERNEL_US.get(FUSED[name][1])}
    for name, v in out.items():
        lib_s = "none" if v["library_ms"] is None else f"{v['library_ms']:.4f} ms"
        print(f"{name} ({v['calls_per_update']} calls an update; first operand "
              f"shapes {shapes[name]}): equal to its plain version in every "
              f"call of a one-hot and a heads update; one update's calls "
              f"{v['ms']:.4f} ms device time (back to back), plain "
              f"{v['plain_ms']:.4f} ms, library {lib_s}, bound "
              f"{v['bound_ms']:.6f} ms ({v['bound_by']}: {v['bytes']} B, "
              f"{v['bf16_ops']} bf16 ops)")
    for name, rows in per_shape.items():
        for key, v in rows.items():
            lib_s = ("none" if v["library_ms_per_call"] is None
                     else f"{v['library_ms_per_call'] * 1e3:.2f} us")
            unfused = v.get("unfused_b5d_ms_per_call")
            unfused_s = "" if unfused is None else (
                f"; the unfused route's B5d launches {unfused * 1e3:.2f} us")
            print(f"  {name} {key}: {v['calls']} calls, "
                  f"{v['ms_per_call'] * 1e3:.2f} us a call (plain "
                  f"{v['plain_ms_per_call'] * 1e3:.2f}, cuBLAS's product "
                  f"{lib_s}, bound {v['bound_ms_per_call'] * 1e3:.3f} us, "
                  f"{v['bound_by']}{unfused_s})")
    report["fused"] = {"calls_per_update": n_calls, "shapes": {
        k: [list(x) for x in v] for k, v in shapes.items()},
        "per_shape": per_shape, "against_cublas": cublas, **out}


#: phase (j)'s widened envelope: batch rows and (n_dc, n_g) heads of B5b
#: and the heads' backward, and the widened update shape whose every fused
#: call is held against its plain version (``--rl-batch 512
#: --max-gpus-per-job 64``: A = 512, 72 heads' columns)
WIDE_B = (1, 100, 256, 512, 4096)
WIDE_HEADS = ((8, 8), (3, 65), (8, 64), (8, 128))
WIDE_ARGV = ("--rl-batch", "512", "--max-gpus-per-job", "64")


def _nan_aware_bits(a, b):
    """The same elements NaN, bitwise equal elsewhere."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and _same_bits(a[~na], b[~nb])


def _small_ints(g, shape, lo=-3, hi=4):
    """bf16 small integers on the card: every float32 sum of their products
    is exact in any order."""
    return torch.randint(lo, hi, shape, generator=g).to(torch.bfloat16).cuda()


def phase_widened_kernels(report):
    """(j, widened) every widened kernel and both new ones against their
    plain versions on the card, bitwise, over the envelope: B5b's target
    and actor term and the heads' fused backward at
    batches ``WIDE_B`` and heads ``WIDE_HEADS`` (masked, all-masked and
    one-feasible heads; a NaN logit, NaN-aware); B5d's forward, dX and
    top-layer backward at 1, 100, 512 and 4,096 rows (exactly summed
    operands), the heads' forward at 72, 68 and 136 columns, the critic's
    first layer at 100 x 512 rows; then every fused call of one eager
    update at ``WIDE_ARGV``, both critics (``check_recorded_calls``).  The
    two new kernels are also timed at the widened update's shapes."""
    from distributed_cluster_gpus_tpu_torch.kernels import dense
    from distributed_cluster_gpus_tpu_torch.kernels import log_softmax as b5f
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5
    from distributed_cluster_gpus_tpu_torch.rl import nets
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac

    g = torch.Generator().manual_seed(43)
    n_cases = 0
    timed = {}
    for B in WIDE_B:
        for n_dc, n_g in WIDE_HEADS:
            A = n_dc * n_g
            q = torch.randn((B, A, 2, N_Q), generator=g).cuda().permute(0, 2, 1, 3)
            ldc, lg = (t.cuda() for t in seeded_policy_logp(g, B, n_dc, n_g))
            r = torch.randn(B, generator=g).cuda()
            costs = (torch.rand((B, 4), generator=g) * 900).cuda()
            lam = torch.tensor([0.4, 0.0, 2.0, 0.0]).cuda()
            tg = torch.tensor([500.0, 1e30, 0.0, 1e30]).cuda()
            done = (torch.arange(B) % 2).float().cuda()
            alpha = torch.tensor(0.2).cuda()
            for nan in (False, True):
                if nan:  # a NaN logit's log-probabilities in the last row
                    ldc[-1, 0] = float("nan")
                t_args = (q, ldc, lg, r, costs, lam, tg, done, alpha, 0.99)
                outs = [*zip(b5.marginal_target(*t_args),
                             rsac.marginal_target(*t_args)),
                        *zip(b5.marginal_actor(q, ldc, lg, alpha),
                             rsac.marginal_actor(q, ldc, lg, alpha))]
                if not all(_nan_aware_bits(k_, p_) for k_, p_ in outs):
                    fail(f"B5b at B = {B}, {n_dc} x {n_g} (NaN logit {nan}): "
                         "differs from its plain version")
                n_cases += 1
            heads = []
            for n in (n_dc, n_g):
                m = torch.rand((B, n), generator=g) < 0.6
                m[0] = False  # no valid action
                if B > 1:
                    m[1] = False
                    m[1, n - 1] = True  # one
                heads.append([(torch.randn((B, n), generator=g) * 3).cuda(),
                              m.cuda(), torch.randn((B, n), generator=g).cuda()])
            heads[1][0][-1, 0] = float("nan")  # a NaN logit in the last row
            heads[1][1][-1, 0] = True
            (l0, m0, c0), (l1, m1, c1) = heads
            want_db = [torch.empty(n, dtype=torch.bfloat16, device="cuda")
                       for n in (n_dc, n_g)]
            want = nets.heads_backward_plain(l0, l1, m0, m1, c0, c1, *want_db)
            dbs = [torch.empty_like(d) for d in want_db]
            got = b5f.heads_backward(l0, l1, m0, m1, c0, c1, *dbs)
            if not all(_nan_aware_bits(k_.float(), p_.float()) for k_, p_ in
                       zip((*got, *dbs), (*want, *want_db))):
                fail(f"heads_backward at B = {B}, {n_dc} + {n_g}: differs "
                     "from its plain version")
            n_cases += 1
            if B == 512 and (n_dc, n_g) == (8, 64):
                heads[1][0][-1, 0] = 0.0
                timed["marginal_target 512x(8x64)x32"] = device_ms(
                    lambda: b5.marginal_target(*t_args), "marginal_target_kernel")[0]
                dbs = [torch.empty_like(d) for d in want_db]
                timed["heads_backward 512x(8+64)"] = device_ms(
                    lambda: b5f.heads_backward(l0, l1, m0, m1, c0, c1, *dbs),
                    "heads_backward")[0]
    # B5d at the widened rows, exactly summed operands
    for R in (1, 100, 512, 4096):
        x, w = _small_ints(g, (R, 256)), _small_ints(g, (256, 256))
        b = _small_ints(g, (256,))
        for relu in (False, True):
            o = [torch.empty((R, 256), device="cuda") for _ in range(2)]
            if not (_same_bits(dense.dense_fwd(x, w, b, relu, o[0]),
                               dense.dense_fwd(x, w, b, relu, o[1], plain=True))
                    and _same_bits(o[0], o[1])):
                fail(f"dense_fwd at {R} rows differs from its plain version")
        gd, wd, y = _small_ints(g, (R, 256)), _small_ints(g, (256, 256)), \
            _small_ints(g, (R, 256))
        dbs = [torch.empty(256, dtype=torch.bfloat16, device="cuda")
               for _ in range(2)]
        if not (_same_bits(dense.dense_dx(gd, wd, y, dbs[0]),
                           dense.dense_dx(gd, wd, y, dbs[1], plain=True))
                and _same_bits(dbs[0], dbs[1])):
            fail(f"dense_dx at {R} rows differs from its plain version")
        gf = (torch.randn((R, 2, N_Q), generator=g) * 3).cuda()[:, 1]
        dbs = [torch.empty(N_Q, dtype=torch.bfloat16, device="cuda")
               for _ in range(2)]
        if not (_same_bits(dense.dense_backward(gf, None, dbs[0]),
                           dense.dense_backward(gf, None, dbs[1], plain=True))
                and _same_bits(dbs[0], dbs[1])):
            fail(f"dense_backward at {R} rows differs from its plain version")
        n_cases += 4
        for n_dc, n_g in ((8, 64), (3, 65), (8, 128)):
            ks = [_small_ints(g, (256, n)) for n in (n_dc, n_g)]
            bs = [_small_ints(g, (n,)) for n in (n_dc, n_g)]
            ms = [(torch.rand((R, n), generator=g) < 0.7).cuda()
                  for n in (n_dc, n_g)]
            hargs = (x, ks[0], bs[0], ks[1], bs[1], *ms)
            if not all(_nan_aware_bits(k_, p_) for k_, p_ in zip(
                    dense.actor_heads_fwd(*hargs),
                    dense.actor_heads_fwd(*hargs, plain=True))):
                fail(f"actor_heads_fwd at {R} rows, {n_dc} + {n_g}: differs "
                     "from its plain version")
            n_cases += 1
    lat = torch.randint(-3, 4, (100, 256), generator=g).float().cuda()
    wc, bc = _small_ints(g, (256 + 72, 256)), _small_ints(g, (256,))
    a_dc = torch.randint(0, 8, (100,), generator=g, dtype=torch.int32).cuda()
    a_g = torch.randint(0, 64, (100,), generator=g, dtype=torch.int32).cuda()
    for acts in ((None, None), (a_dc, a_g)):
        got = dense.critic_first_fwd(lat, 8, 64, wc, bc, *acts, keep_rows=True)
        want = dense.critic_first_fwd(lat, 8, 64, wc, bc, *acts, keep_rows=True,
                                      plain=True)
        if not all(_same_bits(k_, p_) for k_, p_ in zip(got, want)):
            fail("critic_first_fwd at 100 x 8 x 64 differs from its plain version")
        n_cases += 1
    # every fused call of one update at the widened shape, both critics
    fleet, params, _ = learning_params(WIDE_ARGV)
    ring = seeded_ring(params.rl_buffer, 5, 4096, 0.5, 9, n_g=64)
    cublas = {}
    n_calls, _ = check_recorded_calls(fleet, params, ring, cublas)
    print(f"widened envelope: {n_cases} kernel cases bitwise equal to their "
          f"plain versions (B5b and the heads' backward at B = {WIDE_B} x heads "
          f"{WIDE_HEADS}, a NaN logit; B5d's forward, dX, top-layer backward "
          f"and heads at 1-4,096 rows; the critic's first layer at 100 x 512 "
          f"rows); every fused call of one update at {' '.join(WIDE_ARGV)} "
          f"bitwise, both critics ({n_calls['onehot']}); B5d against cuBLAS "
          f"there: {cublas}; timed there (ms a call): {timed}")
    report["widened"] = {"cases": n_cases, "calls": n_calls, "argv": WIDE_ARGV,
                         "against_cublas": cublas, "timed_ms": timed}


def learning_params(extra=()):
    """(fleet, params, chunk steps) of the learning CLI (default warm-up),
    with the ``extra`` flags, for an agent driven alone, parsed as the CLI
    on the card parses them (its envelopes checked)."""
    from distributed_cluster_gpus_tpu_torch import run_sim
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_fleet

    a = run_sim.parse_args(learning_argv("unused") + list(extra))
    fleet = build_fleet()
    return fleet, run_sim.finalize_queue_cap(run_sim.build_params(a), fleet), \
        a.chunk_steps


def learning_argv(out, arch="onehot", duration=MAIN_DURATION_S, extra=()):
    """The learning main path's command line: chsac_af at the default
    warm-up (1,000 transitions), with the ``arch`` critic and the ``extra``
    flags."""
    return ["--algo", "chsac_af", "--duration", str(duration), "--out", out,
            "--log-interval", str(LOG_INTERVAL_S), "--device", "cuda",
            "--critic-arch", arch, "--quiet", *extra]


UPDATE_COUNTERS = ("quantile_huber", "marginal_target", "marginal_actor",
                   "adam_update", "replay_sample",
                   "dense_fwd", "dense_dx", "dense_backward",
                   "critic_first_fwd", "actor_heads_fwd", "heads_backward")
#: the update's small fused regions (B5d-B5f; B5g's casts run inside B5c):
#: {wrapper: (its module and
#: CUDA source, the profiler's name of its kernel, the JAX package's code
#: it replaces)}
FUSED = {"dense_fwd": ("dense", "dense_fwd_gemm", "rl/nets.py:37"),
         "dense_dx": ("dense", "dense_dx_gemm", "rl/sac.py:246"),
         "dense_backward": ("dense", "dense_bwd_kernel", "rl/sac.py:264"),
         "critic_first_fwd": ("dense", "critic_first_gemm", "rl/nets.py:85"),
         "actor_heads_fwd": ("dense", "actor_heads_gemm", "rl/nets.py:58"),
         "heads_backward": ("log_softmax", "heads_backward", "rl/nets.py:62")}
#: the kernels the parents' updates launched that this checkout's does not
#: (B5e's rows, B5f's forward alone, B5f's backward alone, B5g's casts on
#: their own, which run inside B5c since PR 12): an A/B counts them as port
#: kernels, and phase (k) fails if one runs in a replayed update
PARENT_KERNELS = ("critic_input_kernel", "log_softmax_kernel",
                  "log_softmax_backward_kernel", "param_pack_kernel")


def update_counters():
    """{name: the wrapper whose ``launches`` counts it} of the update."""
    import importlib

    from distributed_cluster_gpus_tpu_torch.kernels import adam as b5c
    from distributed_cluster_gpus_tpu_torch.kernels import replay_sample as b6b
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5

    out = {"quantile_huber": b5.quantile_huber,
           "marginal_target": b5.marginal_target,
           "marginal_actor": b5.marginal_actor,
           "adam_update": b5c.adam_update, "replay_sample": b6b.replay_sample}
    for name, (mod, _, _) in FUSED.items():
        out[name] = getattr(importlib.import_module(
            f"distributed_cluster_gpus_tpu_torch.kernels.{mod}"), name)
    return out


def per_update(arch):
    """Wrapper calls of each update kernel per update, with the ``arch``
    critic: 30 Dense layers forward (the encoder twice, the actor twice, the
    critics' two twins three times, the all-actions passes among them): the
    one-hot critic's 6 first layers each one ``critic_first_fwd`` (its rows
    built inside), the actor's two heads with their log-softmax one
    ``actor_heads_fwd`` a forward, the rest ``dense_fwd``; 12 backward: 8
    fused into a dX product (each critic twin's two lower layers, the
    actor's hidden layer with both heads' products, the encoder's three
    layers), 2 standalone (the twins' top layers) and the actor's heads in
    one ``heads_backward`` with the log-softmax's backward; B5c with the
    gradients' widening and the shadows' casts inside."""
    first = 6 if arch == "onehot" else 0
    return {"quantile_huber": 1, "marginal_target": 1, "marginal_actor": 1,
            "adam_update": 1, "replay_sample": 1,
            "dense_fwd": 26 - first, "dense_dx": 8, "dense_backward": 2,
            "critic_first_fwd": first, "actor_heads_fwd": 2,
            "heads_backward": 1}


#: updates in the chunk that phase (k) holds bitwise across the three paths
GRAPH_CHUNK = 16
#: phase (m)'s widened learning CLI run
WIDE_CLI_S = 120.0
WIDE_CLI_ARGV = ("--rl-batch", "300", "--max-gpus-per-job", "128")


#: the plain-torch launches and copies a chunk of updates makes outside the
#: update (``CHSAC_AF.train_steps``: the chunk key's two words filled, the
#: update index zeroed, the last metrics copied out), once a chunk, at most;
#: and those each replayed update may make: none since the update's tail
#: (R1d) runs inside its kernels
CHUNK_TORCH_OPS = ("fill_ of the chunk key's word 0", "fill_ of word 1",
                   "zero_ of the update index",
                   *(f"clone of the {k} metric" for k in (
                       "critic_loss", "actor_loss", "alpha_loss", "alpha",
                       "entropy", "q_mean", "r_eff_mean", "lambda",
                       "violation")))
UPDATE_TORCH_OPS = ()

#: the update's kernels by the names the profiler gives them
UPDATE_KERNELS = ("quantile_huber_kernel", "marginal_target_kernel",
                  "marginal_actor_kernel", "adam_norm_kernel",
                  "adam_apply_kernel", "replay_sample_count_kernel",
                  "replay_sample_draw_kernel",
                  *dict.fromkeys(k for _, k, _ in FUSED.values()))


def _profile_updates(agent, n, graph=True, ours=UPDATE_KERNELS):
    """Profile ``agent.train_steps(n, n)``: (wall us, device busy us by kind,
    device ops by kind, port kernel names seen, device ops by name, device
    us by name); a kernel whose name holds one of ``ours`` is the port's."""
    from torch.profiler import ProfilerActivity, profile

    kinds = {"matmul": 0.0, "port kernels": 0.0, "other torch ops": 0.0}
    n_ops = {"matmul": 0, "port kernels": 0, "other torch ops": 0}
    seen = {k: 0 for k in ours}
    by_name, us_by_name = {}, {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.train_steps(n, n, graph=graph)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name
        hit = [k for k in ours if k in name]
        if hit:
            kind = "port kernels"
            seen[hit[0]] += 1
        elif any(x in name.lower() for x in ("gemm", "cutlass", "xmma", "nvjet",
                                             "cublas", "sm90_")):
            kind = "matmul"
        elif "memcpy" in name.lower() or "memset" in name.lower():
            # counted by name only (not a kernel: outside the kinds)
            by_name[name[:80]] = by_name.get(name[:80], 0) + 1
            us_by_name[name[:80]] = us_by_name.get(name[:80], 0.0) + \
                e.time_range.elapsed_us()
            continue
        else:
            kind = "other torch ops"
        us = e.time_range.elapsed_us()
        kinds[kind] += us
        n_ops[kind] += 1
        by_name[name[:80]] = by_name.get(name[:80], 0) + 1
        us_by_name[name[:80]] = us_by_name.get(name[:80], 0.0) + us
    return wall_us, kinds, n_ops, seen, by_name, us_by_name


def _graph_device_ms(agent, n=2, runs=5):
    """Device time per update of ``n`` graph replays queued behind a spin
    kernel (``_behind_spin``: the graph's span on the card, its gaps between
    kernels included, not the host's launch time; a replay queues ~600
    kernels, so only a few fit in the launch queue at once); the median of
    ``runs``."""
    agent.train_steps(2, 2)
    torch.cuda.synchronize()
    return statistics.median(
        _behind_spin(lambda: agent.train_steps(n, n), n, "graph device time")
        for _ in range(runs))


#: the initial weights drawn on the card against the same draw on the CPU
#: (which ``tests/test_torch_rl_init.py`` holds to the JAX package's): the
#: threefry bits are equal, torch's ``log1p`` inside ``erf_inv`` may differ
#: by an ulp between the two devices
INIT_CARD_ULP = 4


def init_on_card(fleet, params):
    """The learning CLI's agent's initial weights (its ``k_init``, both
    critics) drawn on the card against the same draw on the CPU: every
    kernel within ``INIT_CARD_ULP`` ulp, everything else bitwise; returns
    the largest ulp distance and the card's ``sac_init`` ms."""
    import dataclasses

    import numpy as np

    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.ops import prng
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac
    from distributed_cluster_gpus_tpu_torch.rl.agent import AGENT_FOLD
    from distributed_cluster_gpus_tpu_torch.rl.train import make_agent

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}.{k}")
        else:
            yield path, np.asarray(tree)

    def key32(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    k_init = prng.split(prng.fold_in(prng.key(params.seed, "cpu"), AGENT_FOLD),
                        2)[1]
    out = {}
    for arch in ("onehot", "heads"):
        cfg = make_agent(fleet, dataclasses.replace(params, critic_arch=arch),
                         device="cpu").cfg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = rsac.sac_init(cfg, k_init, "cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cpu = dict(leaves(bridge.sac_to_numpy(cfg, rsac.sac_init(cfg, k_init,
                                                                 "cpu"))))
        worst = 0
        for path, x in leaves(bridge.sac_to_numpy(cfg, card)):
            y = cpu[path]
            if x.dtype == np.float32 and path.endswith(".kernel"):
                worst = max(worst, int(np.abs(key32(x) - key32(y)).max()))
            elif not np.array_equal(x, y):
                fail(f"initial weights ({arch}): {path} differs between the "
                     "card's draw and the CPU's")
        if worst > INIT_CARD_ULP:
            fail(f"initial weights ({arch}): the card's draw is {worst} ulp "
                 f"from the CPU's (bound {INIT_CARD_ULP})")
        out[arch] = {"max_ulp": worst, "card_ms": ms}
    print(f"initial weights drawn on the card vs on the CPU (the CLI's k_init): "
          f"{out}")
    return out


def three_paths(fleet, params, ring, arch, n):
    """(graph, eager kernel, plain) agents of the learning CLI with the
    ``arch`` critic after one chunk of ``n`` updates each from the same
    state, ring and key chain (matmuls deterministic), and whether the
    plain path matched bitwise; fails unless every metric and every leaf
    of the state is bitwise equal between the graph and the eager kernel
    path, and the plain path's is bitwise equal too or, where B5d's
    products sum otherwise than cuBLAS's (the encoder's first layer: 49
    observations, rows TMA cannot load; ROADMAP queue C), within the
    bounds the update's parity tests use (``bridge.sac_far_apart``)."""
    import dataclasses

    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.rl.train import make_agent

    agents = []
    for _ in range(3):
        ag = make_agent(fleet, dataclasses.replace(params, critic_arch=arch),
                        device="cuda")
        ag.replay = ring
        agents.append(ag)
    g_ag, e_ag, p_ag = agents
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mg, ng = g_ag.train_steps(n, n)
        me, ne = e_ag.train_steps(n, n, graph=False)
        mp, np_ = p_ag.train_steps(n, n, plain=True)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    where = f"whole update ({arch})"
    from distributed_cluster_gpus_tpu_torch.rl.sac import SHADOWED

    for path, ag in zip(("graph", "eager", "plain"), agents):
        stale = [grp for grp in SHADOWED if not _bits16(
            ag.sac.shadow[grp], ag.sac.flat[grp].to(torch.bfloat16))]
        if stale:
            fail(f"{where}: after the {path} path's updates the shadows of "
                 f"{stale} are not bf16 of their parameters")
    if not ng == ne == np_ == n:
        fail(f"{where}: {ng}, {ne} and {np_} updates run, {n} asked for")
    if (g_ag.graph_captures, g_ag.graph_replays) != (1, n - 1):
        fail(f"{where}: {g_ag.graph_captures} captures and "
             f"{g_ag.graph_replays} replays for a chunk of {n} updates")
    cfg = g_ag.cfg
    for k in mg:
        if not _bits(mg[k], me[k]):
            fail(f"{where}: metric {k} differs between the graph and the eager "
                 f"kernel path ({mg[k].tolist()} vs {me[k].tolist()})")
    g_tree = bridge.sac_to_numpy(cfg, g_ag.sac)
    bad = bridge.tree_mismatches(bridge.sac_to_numpy(cfg, e_ag.sac), g_tree)
    if bad:
        fail(f"{where}: state differs between the graph and the eager kernel "
             f"path at {bad[:5]}")
    p_tree = bridge.sac_to_numpy(cfg, p_ag.sac)
    bitwise = not bridge.tree_mismatches(p_tree, g_tree) and all(
        _bits(mg[k], mp[k]) for k in mg)
    far = bridge.sac_far_apart(cfg, p_tree, g_tree, n, (mp, mg))
    if far:
        fail(f"{where}: the plain path's state lies beyond the parity bounds "
             f"from the graph's at {far[:5]}")
    return g_ag, e_ag, p_ag, bitwise


#: the envelope's corner, the largest update the card takes: batch 4,096
#: at 8 x 128 joint actions (A = 1,024, 136 heads' columns; the one-hot
#: critic's all-actions layers 4,194,304 rows)
CORNER_ARGV = ("--rl-batch", "4096", "--max-gpus-per-job", "128")


def corner_update():
    """One eager kernel-path update at ``CORNER_ARGV`` against the plain
    path's from the same state and sample, both critics (matmuls
    deterministic): metrics finite, the state within the parity bounds
    (``bridge.sac_far_apart``).  Returns {arch: {bitwise, ms, plain_ms,
    peak_gib}}."""
    import dataclasses

    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.rl.train import make_agent

    fleet, params, _ = learning_params(CORNER_ARGV)
    ring = seeded_ring(32768, 8, 4096, 0.35, 8, n_g=128)
    out = {}
    for arch in ("heads", "onehot"):
        where = f"update at the envelope's corner ({arch})"
        agents = [make_agent(fleet, dataclasses.replace(params, critic_arch=arch),
                             device="cuda") for _ in range(2)]
        for ag in agents:
            ag.replay = ring
        e_ag, p_ag = agents
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            t0 = time.perf_counter()
            me, ne = e_ag.train_steps(1, 1, graph=False)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mp, np_ = p_ag.train_steps(1, 1, plain=True)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        finally:
            torch.use_deterministic_algorithms(False)
        if (ne, np_) != (1, 1):
            fail(f"{where}: {ne} and {np_} updates run, 1 asked for")
        if not all(bool(torch.isfinite(v).all()) for v in me.values()):
            fail(f"{where}: the kernel path's metrics are not finite {me}")
        cfg = e_ag.cfg
        e_tree = bridge.sac_to_numpy(cfg, e_ag.sac)
        p_tree = bridge.sac_to_numpy(cfg, p_ag.sac)
        far = bridge.sac_far_apart(cfg, p_tree, e_tree, 1, (mp, me))
        if far:
            fail(f"{where}: the plain path's state lies beyond the parity "
                 f"bounds from the kernel path's at {far[:5]}")
        out[arch] = {"bitwise": not bridge.tree_mismatches(p_tree, e_tree) and
                     all(_bits(me[k], mp[k]) for k in me),
                     "ms": (t1 - t0) * 1e3, "plain_ms": (t2 - t1) * 1e3,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del agents, e_ag, p_ag
        torch.cuda.empty_cache()
    del ring
    torch.cuda.empty_cache()
    print(f"one update at the envelope's corner ({' '.join(CORNER_ARGV)}: "
          f"A = 1,024): the eager kernel path against the plain path, within "
          f"the parity bounds, both critics: {out}", flush=True)
    return out


def phase_update_whole(report):
    """(k) whole updates at the published shape (the learning CLI's agent:
    256-wide networks, N = 32, 8 x 8 actions, batch 256, a 200,000-row ring
    filled through B6a with seeded windows, done in {0, 1}): one chunk of
    ``GRAPH_CHUNK`` updates three ways from the same state and key chain,
    the update captured as a CUDA graph and replayed (the main path), every
    update run eagerly through the kernels, and the plain path; the matmuls
    deterministic in all three; every leaf of the state and every metric
    bitwise, with the heads critic and with the one-hot critic (the CLI's);
    the same at ``WIDE_ARGV`` and one eager update at the envelope's corner
    (``corner_update``).  Then, for the one-hot critic, ms per update each way, and profiled
    updates: device ops per update and the device's busy share, by kind
    (matmuls, the port's kernels, other torch ops), for the replayed graph
    and the eager path.  Returns the graph path's trained agent."""
    fleet, params, _ = learning_params()
    init = init_on_card(fleet, params)
    n = GRAPH_CHUNK
    # the widened envelope first (its agents are dropped before the
    # published shape's timings): batch 512, 8 x 64 joint actions
    wfleet, wparams, _ = learning_params(WIDE_ARGV)
    wring = seeded_ring(wparams.rl_buffer, 50, 4096, 0.35, 6, n_g=64)
    wide_bitwise = {}
    for arch in ("heads", "onehot"):
        wide_bitwise[arch] = three_paths(wfleet, wparams, wring, arch, n)[3]
    del wring
    print(f"whole update at {' '.join(WIDE_ARGV)} (A = 512, 72 heads' "
          f"columns): a chunk of {n} updates bitwise equal between the CUDA "
          f"graph and the eager kernel path, the plain path bitwise "
          f"({wide_bitwise}) or within the parity bounds, both critics")
    corner = corner_update()
    ring = seeded_ring(params.rl_buffer, 50, 4096, 0.35, 5)
    plain_bitwise = {}
    for arch in ("heads", "onehot"):
        g_ag, e_ag, p_ag, plain_bitwise[arch] = three_paths(fleet, params, ring,
                                                            arch, n)
    cfg = g_ag.cfg
    # the graph above was captured under deterministic mode, which fills
    # every new allocation (~200 fills an update); the CLI's is not: capture
    # again for the timings and profiles below
    g_ag.drop_graph()
    # ms per update: the graph (replays only), the eager kernel path, plain
    timing = {}
    for name, ag, reps, kw in (("graph", g_ag, 64, {}),
                               ("eager", e_ag, 24, {"graph": False}),
                               ("plain", p_ag, 4, {"plain": True})):
        ag.train_steps(2, 2, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ag.train_steps(reps, reps, **kw)
        torch.cuda.synchronize()
        timing[name] = (time.perf_counter() - t0) * 1e3 / reps
    timing["graph_device"] = _graph_device_ms(g_ag)
    counters = update_counters()
    before = {k: w.launches for k, w in counters.items()}
    n_eager = 4
    e_prof = _profile_updates(e_ag, n_eager, graph=False)
    launched = {k: w.launches - before[k] for k, w in counters.items()}
    want = per_update(g_ag.cfg.critic_arch)
    if launched != {k: v * n_eager for k, v in want.items()}:
        fail(f"whole update: kernel calls in {n_eager} eager updates "
             f"{launched}, expected {want} each")
    launched = {k: v // n_eager for k, v in launched.items()}
    replays0 = g_ag.graph_replays
    before = {k: w.launches for k, w in counters.items()}
    n_prof = 8
    g_prof = _profile_updates(g_ag, n_prof)
    if g_ag.graph_replays - replays0 != n_prof or any(
            w.launches != before[k] for k, w in counters.items()):
        fail("whole update: the profiled chunk did not run as graph replays")
    prof = {}
    for name, (wall_us, kinds, n_ops, seen, by_name, us_by_name), per in (
            ("graph", g_prof, n_prof), ("eager", e_prof, n_eager)):
        busy = sum(kinds.values())
        if busy == 0:
            fail(f"whole update ({name}): the profiler saw no device activity")
        prof[name] = {"wall_us_per_update": wall_us / per,
                      "busy_us_per_update": busy / per,
                      "busy_share": busy / wall_us,
                      "busy_share_unprofiled": busy / per / (
                          1e3 * timing[name]),
                      "ops_by_name": by_name,
                      "device_us_per_update_by_name": dict(sorted(
                          ((k, v / per) for k, v in us_by_name.items()),
                          key=lambda kv: -kv[1])[:20]),
                      "device_us_per_update": {k: v / per for k, v in kinds.items()},
                      "device_ops_per_update": {k: v / per for k, v in n_ops.items()},
                      "launches_per_update": sum(n_ops.values()) / per,
                      "port_kernels_seen": seen}
    missing = [k for k in UPDATE_KERNELS if not prof["graph"]["port_kernels_seen"][k]]
    if missing:
        fail(f"whole update: the profiled graph replays launched none of {missing}")
    stale = [k for k in g_prof[4] if any(p in k for p in PARENT_KERNELS)]
    if stale:
        fail(f"whole update: the replayed graph launched {stale}, which this "
             "checkout's update runs inside other kernels")
    # R1d: the replayed graph runs no plain-torch launch or copy but the
    # ones named (UPDATE_TORCH_OPS: none).  A chunk of r replays also runs
    # its own ops outside the graph (CHUNK_TORCH_OPS, once a chunk; a fill
    # the runtime turns into a memset counts as a copy), so it may show at
    # most len(CHUNK_TORCH_OPS) + r len(UPDATE_TORCH_OPS): one op more a
    # replay adds r.  The profiler can miss a chunk's first launches (the
    # chunk's fills, queued as its tracing starts), so each chunk is held to
    # that ceiling on its own: differencing two chunks' counts would read a
    # missed fill as an op a replay
    def torch_ops(prof):
        copies = sum(v for k, v in prof[4].items()
                     if "memcpy" in k.lower() or "memset" in k.lower())
        return prof[2]["other torch ops"] + copies

    g_prof2 = _profile_updates(g_ag, 2 * n_prof)
    if g_ag.graph_replays - replays0 != 3 * n_prof:
        fail("whole update: the second profiled chunk did not run as graph "
             "replays")
    chunk_ops = {}
    for r, p in ((n_prof, g_prof), (2 * n_prof, g_prof2)):
        chunk_ops[r] = torch_ops(p)
        cap = len(CHUNK_TORCH_OPS) + r * len(UPDATE_TORCH_OPS)
        if chunk_ops[r] > cap:
            others = {k: v for k, v in p[4].items() if not any(
                u in k for u in UPDATE_KERNELS)}
            fail(f"whole update: {chunk_ops[r]} plain-torch launches or copies "
                 f"in a chunk of {r} replays, at most {cap} "
                 f"({len(CHUNK_TORCH_OPS)} the chunk's own, "
                 f"{len(UPDATE_TORCH_OPS)} named a replay): {others}")
    # the most plain-torch ops a replay can have run, were every one of the
    # chunk's own ops missed
    per_replay = chunk_ops[2 * n_prof] / (2 * n_prof)
    print(f"whole update, replayed graph: {chunk_ops[n_prof]} and "
          f"{chunk_ops[2 * n_prof]} plain-torch launches and copies in chunks "
          f"of {n_prof} and {2 * n_prof} replays, at most "
          f"{len(CHUNK_TORCH_OPS)} a chunk outside the graph (the key's fills, "
          f"the index's zero, the metrics' copies) and "
          f"{UPDATE_TORCH_OPS or 'none named'} a replay: at most "
          f"{per_replay:.3f} a replay, so none runs in every replay")
    top = list(prof["graph"]["device_us_per_update_by_name"].items())[:10]
    print("whole update, replayed graph: device us per update by kernel name "
          "(top 10): " + "; ".join(f"{k[:48]} {v:.1f}" for k, v in top))
    ours = {k: (v / n_prof, g_prof[5][k] / n_prof) for k, v in g_prof[4].items()
            if any(u in k for u in UPDATE_KERNELS)}
    print("whole update, replayed graph: the port's kernels, device ops and us "
          "per update by name (none of B5e's or B5f's forward alone): " +
          "; ".join(f"{k[:60]} {o:.2f} ops {us:.2f} us"
                    for k, (o, us) in sorted(ours.items())))
    # the bounds of what the port leaves to torch: the 12 dW products
    # (x^T G of every layer with a gradient, each operand read once and the
    # product written once; 2 B K N bf16 operations) and the update's small
    # ops (the sample's fields read, the observations' bf16 casts written,
    # the taken quantiles' mean, the CMDP and metric scalars)
    from distributed_cluster_gpus_tpu_torch.rl.nets import dense_layers

    B = cfg.batch
    kn = [tuple(l.kernel.shape) for m in (g_ag.sac.critic, g_ag.sac.actor,
                                          g_ag.sac.enc) for l in dense_layers(m)]
    dw_bytes = sum(2 * (B * K + B * N_ + K * N_) for K, N_ in kn)
    dw_ops = sum(2 * B * K * N_ for K, N_ in kn)
    dw_bound, dw_by = bound2(dw_bytes, 0, dw_ops)
    small_bytes = tail_bytes(B, cfg.obs_dim, cfg.n_dc, cfg.n_g,
                             cfg.n_quantiles)
    small_bound, small_by = bound(small_bytes, 0)
    pg_us, pg_ops = prof["graph"]["device_us_per_update"], \
        prof["graph"]["device_ops_per_update"]
    print(f"whole update, what torch runs: the {len(kn)} dW products bound "
          f"{dw_bound * 1e3:.3f} us ({dw_by}: {dw_bytes} B, {dw_ops} bf16 ops) "
          f"against {pg_us['matmul']:.1f} us in {pg_ops['matmul']:.2f} launches; "
          f"the small ops bound {small_bound * 1e3:.4f} us ({small_by}: "
          f"{small_bytes} B) against {pg_us['other torch ops']:.1f} us in "
          f"{pg_ops['other torch ops']:.2f} launches (replayed graph)")
    layers = g_ag.sac.layers()
    nonzero_bias = all(bool(l.bias.ne(0).any()) for l in layers)
    # the two all-actions products (the target critic's on s1, the online
    # critic's on s0), the bulk of an update's matmul work: B * A rows
    # through both twins, 2 operations per multiply-add, at the bf16 peak
    rows = cfg.batch * cfg.n_dc * cfg.n_g
    mm_ops = 2 * 2 * rows * sum(l.kernel.numel() for l in g_ag.sac.critic.layers)
    mm_bound_ms = mm_ops / H100_BF16_OPS_PER_S * 1e3
    pg, pe = prof["graph"], prof["eager"]
    print(f"whole update at the published shape (batch {cfg.batch}, N "
          f"{cfg.n_quantiles}, {cfg.n_dc}x{cfg.n_g} actions, ring "
          f"{params.rl_buffer}): a chunk of {n} updates bitwise equal between "
          f"the CUDA graph (1 capture, {n - 1} replays) and the eager kernel "
          f"path (every state leaf and metric), the plain path bitwise equal "
          f"too ({plain_bitwise}) or within the parity bounds, with the heads "
          f"and the one-hot critic; one-hot, ms per update: "
          f"graph {timing['graph']:.3f}, eager kernels {timing['eager']:.3f}, "
          f"plain {timing['plain']:.3f}; the graph's span on the card "
          f"{timing['graph_device']:.3f} ms per update; profiled: graph "
          f"{pg['wall_us_per_update']:.0f} us wall per update, "
          f"{pg['launches_per_update']:.0f} device ops per update, busy "
          f"{pg['busy_us_per_update']:.0f} us (share {pg['busy_share']:.3f} "
          f"of the profiled wall, {pg['busy_share_unprofiled']:.3f} of the "
          f"unprofiled; {pg['device_us_per_update']}); eager "
          f"{pe['wall_us_per_update']:.0f} us wall, "
          f"{pe['launches_per_update']:.0f} device ops, busy "
          f"{pe['busy_us_per_update']:.0f} us (share {pe['busy_share']:.3f}, "
          f"{pe['busy_share_unprofiled']:.3f}; {pe['device_us_per_update']}); "
          f"the two all-actions products "
          f"{mm_ops / 1e9:.2f} GFLOP, {mm_bound_ms:.4f} ms at the bf16 peak; "
          f"kernel calls per eager update {launched}; trained biases non-zero: "
          f"{nonzero_bias}")
    report["update"] = {"chunk": n, "init": init, "ms_per_update": timing["graph"],
                        "graph_device_ms_per_update": timing["graph_device"],
                        "eager_ms_per_update": timing["eager"],
                        "plain_ms_per_update": timing["plain"],
                        "plain_bitwise": plain_bitwise,
                        "widened": {"argv": WIDE_ARGV,
                                    "plain_bitwise": wide_bitwise},
                        "corner": {"argv": CORNER_ARGV, **corner},
                        "dw_bound_ms": dw_bound, "dw_bound_by": dw_by,
                        "dw_bytes": dw_bytes, "dw_ops": dw_ops,
                        "small_ops_bound_ms": small_bound,
                        "small_ops_bytes": small_bytes,
                        "profile": prof, "all_actions_ops": mm_ops,
                        "torch_ops_per_replay_at_most": per_replay,
                        "torch_ops_per_chunk": chunk_ops,
                        "all_actions_bound_ms": mm_bound_ms,
                        "calls_per_update": launched}
    if not nonzero_bias:
        fail("whole update: training left a layer's biases all zero")
    return g_ag


def phase_b1_after_learning(report, agent, steps=1024):
    """(l) B1 in RL mode with weights that training produced (phase (k)'s
    agent: non-zero biases from its updates) against the plain step, one
    chunk at the chsac_af CLI's shape, bitwise.  The chunk is cut to
    ``steps`` events: the plain step takes ~20 ms an event."""
    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.models.structs import (
        clone_state, with_lane_axis)
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state

    fleet, params, _ = learning_params()
    eng = Engine(fleet, params, device="cuda", policy_apply=agent.policy_apply)
    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device="cuda"))
    other = clone_state(st)
    pre = eng.workload.tables(st, steps)
    em_k, _ = b1.event_scan(eng, st, pre, steps, agent.sac)
    em_r, _ = b1.event_scan_reference(eng, other, pre, steps, agent.sac)
    err = em_diff(em_k, em_r, "B1 RL with trained weights")
    bad = bridge.tree_mismatches(bridge.state_to_numpy(other),
                                 bridge.state_to_numpy(st))
    if bad:
        fail(f"B1 RL with trained weights: state differs at {bad[:5]}")
    dec = int(em_k["rl"]["valid"].sum())
    print(f"B1 RL mode with trained weights (after {agent.sac.step} updates) "
          f"vs the plain step, one {steps}-step chunk at the chsac_af CLI's "
          f"shape: bitwise identical ({dec} transitions)")
    report["b1_trained"] = {"steps": steps, "updates": agent.sac.step,
                            "transitions": dec, "max_abs_err": err}


def learning_run(out, arch="onehot", duration=MAIN_DURATION_S, extra=()):
    """One learning CLI run with the launch counters zeroed just before it
    and read just after; fails unless B1 (RL mode), B2 and B6a ran once per
    chunk, every update but the first ran as a replay of the one captured
    CUDA graph, each update kernel ran its per-update count in the eager
    first update and was recorded once by the capture (so launched on the
    card its per-update count times the updates), the updates the schedule
    asked for ran (one per new transition, at most 256 a chunk, once warm)
    and every metric is finite with alpha <= alpha_max.  Returns (final
    state, wall s, record, launches: the update kernels' launches on the
    card, B5g's one refresh, the captures and the replays)."""
    from distributed_cluster_gpus_tpu_torch import run_sim
    from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.kernels import replay_ingest as b6
    from distributed_cluster_gpus_tpu_torch.kernels.param_pack import param_pack
    from distributed_cluster_gpus_tpu_torch.rl.agent import CHSAC_AF

    rec = {"agents": [], "valid": [], "asked": [], "done": [], "metrics": [],
           "ms": [], "replays": []}
    orig_ingest, orig_train = CHSAC_AF.ingest_chunk, CHSAC_AF.train_steps

    def ingest(self, rl_em):
        rec["agents"].append(self)
        rec["valid"].append(rl_em["valid"].sum())
        return orig_ingest(self, rl_em)

    def train(self, n_train, max_steps=256, plain=False, graph=True):
        t0 = time.perf_counter()
        replays0 = self.graph_replays
        m, n = orig_train(self, n_train, max_steps, plain, graph)
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["asked"].append((n_train, max_steps, self._warm))
        rec["done"].append(n)
        rec["replays"].append(self.graph_replays - replays0)
        if m is not None:
            rec["metrics"].append({k: v.detach().cpu() for k, v in m.items()})
        return m, n

    counters = update_counters()
    CHSAC_AF.ingest_chunk, CHSAC_AF.train_steps = ingest, train
    try:
        torch.cuda.synchronize()
        b1.event_scan.launches = b1.event_scan.rl_launches = 0
        b2.arrival_tables.launches = 0
        b6.replay_ingest.launches = 0
        param_pack.launches = 0
        for w in counters.values():
            w.launches = 0
        t0 = time.perf_counter()
        st = run_sim.main(learning_argv(out, arch, duration, extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"event_scan": b1.event_scan.launches,
                    "rl": b1.event_scan.rl_launches,
                    "arrival_tables": b2.arrival_tables.launches,
                    "replay_ingest": b6.replay_ingest.launches,
                    "param_pack": param_pack.launches,
                    **{k: w.launches for k, w in counters.items()}}
    finally:
        CHSAC_AF.ingest_chunk, CHSAC_AF.train_steps = orig_ingest, orig_train
    where = f"learning CLI ({arch}{' ' if extra else ''}{' '.join(extra)})"
    n_chunks = len(rec["valid"])
    per_chunk = [launches[k] for k in ("event_scan", "rl", "arrival_tables",
                                       "replay_ingest")]
    if not (n_chunks > 0 and per_chunk == [n_chunks] * 4):
        fail(f"{where}: B1, B1 in RL mode, B2, B6a launches {per_chunk} for "
             f"{n_chunks} chunks (one each per chunk)")
    # B5g's kernel fills the shadows once, when the agent is built; the
    # updates keep them in step inside B5c
    if launches["param_pack"] != 1:
        fail(f"{where}: {launches['param_pack']} launches of B5g's kernel, "
             "expected the one refresh of the new agent's shadows")
    updates = sum(rec["done"])
    if updates <= 0:
        fail(f"{where}: no update ran at the default warm-up")
    for (n_train, max_steps, warm), n in zip(rec["asked"], rec["done"]):
        want = min(n_train, max_steps) if warm else 0
        if n != want:
            fail(f"{where}: {n} updates in a chunk that asked for {want}")
    # the wrappers count their launches when they run: in the eager
    # updates (one per capture, before it) and once in each capture, which
    # records them; a replay relaunches the captured ones
    agent = rec["agents"][-1]
    replays, captures = sum(rec["replays"]), agent.graph_captures
    if replays != updates - captures or replays != agent.graph_replays:
        fail(f"{where}: {replays} graph replays and {captures} captures for "
             f"{updates} updates")
    calls = {k: launches[k] for k in counters}
    want = per_update(arch)
    want_calls = {k: want[k] * 2 * captures for k in counters}
    if calls != want_calls:
        fail(f"{where}: update kernel calls {calls}, expected {want_calls}")
    for k in counters:
        launches[k] = want[k] * updates  # launched on the card
    launches["graph_captures"], launches["graph_replays"] = captures, replays
    if agent.sac.step != updates or agent.cfg.critic_arch != arch:
        fail(f"{where}: the agent ({agent.cfg.critic_arch}) took "
             f"{agent.sac.step} steps, {updates} ran")
    for m in rec["metrics"]:
        for k, v in m.items():
            if not bool(torch.isfinite(v).all()):
                fail(f"{where}: metric {k} not finite: {v.tolist()}")
        if float(m["alpha"]) > agent.cfg.alpha_max:
            fail(f"{where}: alpha {float(m['alpha'])} above {agent.cfg.alpha_max}")
    finished = int(st.n_finished.sum())
    jobs = _read_csv(os.path.join(out, "job_log.csv"))
    if len(jobs) != finished or not bool(st.done):
        fail(f"{where}: {len(jobs)} job rows for {finished} finishes, done "
             f"{bool(st.done)}")
    return st, wall, rec, launches


def phase_learning_cli(report, out_root):
    """(m) the learning main path through its CLI: chsac_af on the paper
    fleet for 600 s at the default warm-up, 4,096-step chunks, CSVs
    written, checked by ``learning_run``; a second run under torch's sync
    debug mode counts the synchronizing calls made with the B1, B6a or
    ``train_steps`` code on the stack (none allowed; the one capture's are
    counted apart, every replay's with the rest); then the heads critic
    (``--critic-arch heads``) for 300 s, checked the same way."""
    import gc

    from distributed_cluster_gpus_tpu_torch import run_sim

    # each run starts as a fresh CLI process would: no memory cached by the
    # earlier phases (a capture's pool would otherwise go through freeing it)
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(out_root, "chsac_af_learning")
    st, wall, rec, launches = learning_run(out)
    with SyncCounter() as syncs:
        run_sim.main(learning_argv(out + "_syncs"))
    if syncs.in_chunk:
        fail(f"learning CLI: {syncs.in_chunk} synchronizing CUDA calls with the "
             f"B1, B6a or train_steps code on the stack, the capture's aside "
             f"({syncs.by_file})")
    events, updates = int(st.n_events), sum(rec["done"])
    replays = [r for r, n in zip(rec["replays"], rec["done"]) if n]
    upd = report["update"]["profile"]
    upd_ms = sum(m for m, n in zip(rec["ms"], rec["done"]) if n)
    ms_per_update = upd_ms / updates
    last = rec["metrics"][-1]
    per_chunk = [n for n in rec["done"] if n]
    n_chunks = len(rec["valid"])
    h_dur = MAIN_DURATION_S / 2
    h_st, h_wall, h_rec, h_launch = learning_run(out + "_heads", "heads", h_dur)
    h_upd = sum(h_rec["done"])
    h_ms = sum(m for m, n in zip(h_rec["ms"], h_rec["done"]) if n) / h_upd
    # a widened setting: an odd batch over two 256-row tiles, 8 x 128 joint
    # actions (the paper fleet's widest, acted with by B1's RL mode)
    w_st, w_wall, w_rec, w_launch = learning_run(
        out + "_wide", "onehot", WIDE_CLI_S, WIDE_CLI_ARGV)
    w_upd = sum(w_rec["done"])
    w_ms = sum(m for m, n in zip(w_rec["ms"], w_rec["done"]) if n) / w_upd
    print(f"learning CLI chsac_af (default warm-up 1,000): {events} events in "
          f"{MAIN_DURATION_S:.0f} s simulated, {wall:.2f} s wall, "
          f"{events / wall:.1f} events/s; {updates} updates in {len(per_chunk)} "
          f"of {n_chunks} chunks ({per_chunk}), {ms_per_update:.3f} ms per "
          f"update (train_steps wall, synchronized), {upd_ms / 1e3:.2f} s of "
          f"the wall (ms per updating chunk "
          f"{[round(m, 1) for m, n in zip(rec['ms'], rec['done']) if n]}); graph replays per updating chunk {replays} (1 capture); "
          f"device ops per update {upd['graph']['launches_per_update']:.0f}, "
          f"device busy share in an update {upd['graph']['busy_share']:.3f} "
          f"(eager: {upd['eager']['launches_per_update']:.0f}, "
          f"{upd['eager']['busy_share']:.3f}; phase (k)); launches {launches} "
          f"for {n_chunks} chunks; synchronizing calls with B1, B6a or "
          f"train_steps on the stack: {syncs.in_chunk}, in the capture: "
          f"{syncs.in_capture} ({syncs.total} in the run); last metrics: critic_loss "
          f"{float(last['critic_loss']):.4g}, actor_loss "
          f"{float(last['actor_loss']):.4g}, alpha {float(last['alpha']):.4g}, "
          f"entropy {float(last['entropy']):.4g}, lambda "
          f"{last['lambda'].tolist()}; heads critic, {h_dur:.0f} s: "
          f"{int(h_st.n_events)} events, {h_wall:.2f} s wall, {h_upd} updates, "
          f"{h_ms:.3f} ms per update, launches {h_launch}; "
          f"{' '.join(WIDE_CLI_ARGV)}, {WIDE_CLI_S:.0f} s: {int(w_st.n_events)} "
          f"events, {w_wall:.2f} s wall, {w_upd} updates, {w_ms:.3f} ms per "
          f"update, launches {w_launch}")
    report["learning_cli"] = {
        "events": events, "wall_s": wall, "events_per_s": events / wall,
        "updates": updates, "updates_per_chunk": rec["done"],
        "ms_per_update": ms_per_update, "update_wall_s": upd_ms / 1e3,
        "chunks": n_chunks, "launches": launches,
        "graph_replays_per_chunk": rec["replays"],
        "launches_per_update": upd["graph"]["launches_per_update"],
        "busy_share_per_update": upd["graph"]["busy_share"],
        "syncs_in_chunks": syncs.in_chunk, "syncs_in_capture": syncs.in_capture,
        "syncs_total": syncs.total,
        "last_metrics": {k: v.tolist() for k, v in last.items()},
        "heads": {"duration_s": h_dur, "events": int(h_st.n_events),
                  "wall_s": h_wall, "updates": h_upd, "ms_per_update": h_ms,
                  "launches": h_launch},
        "widened": {"argv": WIDE_CLI_ARGV, "duration_s": WIDE_CLI_S,
                    "events": int(w_st.n_events), "wall_s": w_wall,
                    "updates": w_upd, "ms_per_update": w_ms,
                    "launches": w_launch}}
    return launches


# ------------------------------------------------- the float64 clock (n, o)

#: the float64 clock's bridged start: a float32 clock's ulp there is 1/16 s
T_LATE = 6.0e5
#: a quarter second before hour 7 of day 7: the eco sites' hour changes
T_HOUR = 6 * 86400 + 7 * 3600.0 - 0.25
#: the float64 clock on the CLI's command line
X64_ARGV = ("--time-dtype", "float64")
#: phase (o)'s CLI runs: past the auto threshold (no --time-dtype given),
#: run.sh's training traffic without inference, the reference's 20 s tick
CLOCK64_CLI_S = 200_000.0
CLOCK64_CLI_ARGV = ("--inf-mode", "off", "--trn-rate", "0.02",
                    "--log-interval", "20")
#: phase (n)'s B1 double instances at the CLI's shape: label -> (algo, the
#: flags added to the CLI's, the bridged start)
CLOCK64_B1 = {
    "base/default_policy": ("default_policy", (), T_LATE),
    "base/joint_nf": ("joint_nf", (), T_LATE),
    "extended/eco_route": ("eco_route", ("--eco-objective", "cost",
                                         "--power-cap", "25000"), T_HOUR),
    "extended/cap_greedy": ("cap_greedy", ("--power-cap", "25000"), T_LATE),
    "rl/8x8": ("chsac_af", (), T_LATE),
    "rl/8x128": ("chsac_af", ("--max-gpus-per-job", "128"), T_LATE),
}
#: phase (n)'s chunks: two of CLOCK64_CHECK_STEPS held against the plain
#: step (its host time bounds the depth), and the us per event of a warm
#: chunk of the CLI's 4,096 steps
CLOCK64_CHECK_STEPS = 512
CLOCK64_TIME_STEPS = 4096
#: float64 outside the tensor cores, H100 SXM data sheet (the guide's table
#: has no float64 rate)
H100_F64_OPS_PER_S = 34e12


def bridged(state, t0, log_interval):
    """A lane-stacked state moved to clock ``t0`` in place: the streams'
    next arrivals and epochs (the sinusoid's inversion anchors at its
    epoch) and the log tick shifted with it."""
    shift = torch.tensor(t0, dtype=state.t.dtype, device=state.t.device)
    state.t.fill_(t0)
    state.next_arrival.add_(shift)
    state.arr_epoch.add_(shift)
    state.next_log_t.fill_(t0 + log_interval)
    return state


def clock64_setup(algo, extra, x64=True, duration=None):
    """(fleet, params, engine, agent or None) of the CLI's shape with the
    ``extra`` flags (and ``--duration``), in the float64 clock (or the
    float32 one); chsac_af's policy perturbed as ``rl_setup`` does."""
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine

    flags = tuple(extra) + (X64_ARGV if x64 else ("--time-dtype", "float32"))
    if duration is not None:
        flags += ("--duration", str(duration))
    if algo == "chsac_af":
        fleet, params, _, eng, agent = rl_setup(flags)
        return fleet, params, eng, agent
    fleet, params, _ = cli_params(algo, flags)
    return fleet, params, Engine(fleet, params, device="cuda"), None


def _timed_chunk(eng, st, pre, n_steps, sac):
    """(kernel ms, emissions) of one B1 launch."""
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    em, _ = b1.event_scan(eng, st, pre, n_steps, sac)
    b.record()
    b.synchronize()
    return a.elapsed_time(b), em


def _us_per_event(algo, extra, n_steps, x64):
    """B1's us per event of one clock's instance at the CLI's shape from
    init_state: the second of two chunks (warm)."""
    from distributed_cluster_gpus_tpu_torch.models.structs import with_lane_axis
    from distributed_cluster_gpus_tpu_torch.sim.engine import init_state

    fleet, params, eng, agent = clock64_setup(algo, extra, x64)
    sac = agent.sac if agent is not None else None
    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device="cuda"))
    for _ in range(2):
        pre = eng.workload.tables(st, n_steps)
        ev0 = int(st.n_events.sum())
        ms, _ = _timed_chunk(eng, st, pre, n_steps, sac)
        eng.workload.advance_carries(st, pre)
    return ms / (int(st.n_events.sum()) - ev0) * 1e3


def phase_clock64(report):
    """(n) the float64 clock's kernels against their plain versions on the
    card, bitwise, at the main path's shapes: each double instance of B1
    (base, extended with the hour changing and a controller firing, RL at
    8 x 8 and 8 x 128) on the paper fleet as the CLI builds it, from a state
    bridged to t = 6e5 s (the eco run to just before hour 7 of day 7), two
    chunks, with its us per event beside its float32 instance's (both from
    init_state, a warm chunk each); R = 32 lanes of the double instance at
    the bench shape in one launch, each lane equal to its single-lane run,
    lanes 0-1 to the plain step; B2's double instance at R = 1 and 32 and
    the fold's edges; B6b's float64 draw on a 200,000-row ring and B5c's
    float64 bias corrections on the update's four groups.  Each timed
    beside its plain version and its bound."""
    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.kernels import adam as b5c
    from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.kernels import replay_sample as b6b
    from distributed_cluster_gpus_tpu_torch.models.structs import (
        SimParams, clone_state, lane_view, unstack_states, with_lane_axis)
    from distributed_cluster_gpus_tpu_torch.ops import prng
    from distributed_cluster_gpus_tpu_torch.parallel.rollout import batched_init
    from distributed_cluster_gpus_tpu_torch.rl import optim, replay
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state

    rows, max_err = {}, 0.0
    n_steps = CLOCK64_CHECK_STEPS
    for label, (algo, extra, t0) in CLOCK64_B1.items():
        # the run's end past the bridged start
        fleet, params, eng, agent = clock64_setup(algo, extra,
                                                  duration=t0 + MAIN_DURATION_S)
        if not params.x64:
            fail(f"B1 float64 {label}: the CLI's flags did not give the float64 clock")
        sac = agent.sac if agent is not None else None
        st = bridged(with_lane_axis(init_state(params.seed, fleet, params,
                                               workload=eng.workload,
                                               device="cuda")),
                     t0, params.log_interval)
        other = clone_state(st)
        x0 = b1.event_scan.x64_launches
        ctl_k, ctl_r = [], []
        for c in range(2):
            pre = eng.workload.tables(st, n_steps)
            before = clone_state(st)
            k_ms, em_k = _timed_chunk(eng, st, pre, n_steps, sac)
            t1 = time.perf_counter()
            em_r, st_r = b1.event_scan_reference(eng, other, pre, n_steps, sac)
            torch.cuda.synchronize()
            p_ms = (time.perf_counter() - t1) * 1e3
            max_err = max(max_err, em_diff(em_k, em_r, f"B1 float64 {label} "
                                                       f"chunk {c}"))
            eng.workload.advance_carries(st, pre)
            eng.workload.advance_carries(other, pre)
            max_err = max(max_err, state_diff(st, other))
            bad = bridge.tree_mismatches(bridge.state_to_numpy(other),
                                         bridge.state_to_numpy(st))
            if bad:
                fail(f"B1 float64 {label} chunk {c}: state differs from the "
                     f"plain version at {bad[:5]}")
            ctl_r += st_r["ctl"][:, :2].tolist()
        if b1.event_scan.x64_launches != x0 + 2:
            fail(f"B1 float64 {label}: {b1.event_scan.x64_launches - x0} "
                 "launches of the double instance for 2 chunks")
        ev = int((st.n_events - before.n_events).sum())
        if agent is not None:
            by, f32_ops, bf16_ops, counts = rl_b1_work(eng, before, st, pre,
                                                       em_k, n_steps, agent)
            bnd, bnd_by = bound2(by, f32_ops, bf16_ops)
        else:
            by, ops, counts = b1_work(eng, before, st, pre, em_k, n_steps)
            bnd, bnd_by = bound(by, ops)
        us64 = _us_per_event(algo, extra, CLOCK64_TIME_STEPS, True)
        us32 = _us_per_event(algo, extra, CLOCK64_TIME_STEPS, False)
        rows[label] = {"algo": algo, "flags": list(extra), "t0": t0,
                       "n_steps": n_steps, "events": ev, "ms": k_ms,
                       "plain_ms": p_ms, "bound_ms": bnd, "bound_by": bnd_by,
                       "bytes": by, "counts": counts,
                       "us_per_event": us64, "us_per_event_float32": us32,
                       "t_end": float(st.t.max()),
                       "ctl_ticks": sum(t for t, _ in ctl_r)}
        print(f"B1 float64 {label}: 2 chunks of {n_steps} from t = {t0:.2f} s "
              f"bitwise equal to the plain step (to t = {float(st.t.max()):.4f}"
              f" s); second chunk {ev} events, kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.1f} ms, bound {bnd:.6f} ms ({bnd_by}); from init_state, "
              f"{CLOCK64_TIME_STEPS}-step chunks: {us64:.3f} us/event (float32 "
              f"instance {us32:.3f}, x{us64 / us32:.3f})")
        if label.startswith("extended/cap") and not rows[label]["ctl_ticks"]:
            fail(f"B1 float64 {label}: the cap controller never fired")
        if label == "extended/eco_route" and float(st.t.max()) <= T_HOUR + 0.25:
            fail("B1 float64 extended/eco_route: the run never reached hour 7")
    # ---- R = 32 lanes of the double instance at the bench shape
    fleet, _, _ = cli_params("default_policy")
    params = SimParams(**dict(BENCH_SHAPE, algo="default_policy",
                              time_dtype="float64"))
    eng = Engine(fleet, params, device="cuda")
    lanes = batched_init(fleet, params, 32, workload=eng.workload, device="cuda")
    singles = unstack_states(lanes)
    plain = [clone_state(with_lane_axis(singles[r])) for r in range(2)]
    lane_ems = []
    ev0 = int(lanes.n_events.sum())
    for c in range(2):
        pre = eng.workload.tables(lanes, 512)
        l_ms, em = _timed_chunk(eng, lanes, pre, 512, None)
        eng.workload.advance_carries(lanes, pre)
        lane_ems.append(em)
    lane_us = l_ms / (int(lanes.n_events.sum()) - ev0) * 2 * 1e3
    for r, s in enumerate(singles):
        s = with_lane_axis(s)
        for c in range(2):
            pre = eng.workload.tables(s, 512)
            em, _ = b1.event_scan(eng, s, pre, 512)
            eng.workload.advance_carries(s, pre)
            em_diff({k: v[0] for k, v in em.items()},
                    {k: v[r] for k, v in lane_ems[c].items()},
                    f"B1 float64 lane {r} chunk {c} vs its single-lane run")
            if r < 2:
                em_p, _ = b1.event_scan_reference(eng, plain[r], pre, 512)
                eng.workload.advance_carries(plain[r], pre)
                em_diff(em, em_p, f"B1 float64 lane {r} chunk {c} vs the plain step")
        for other in ([s] + ([plain[r]] if r < 2 else [])):
            bad = bridge.tree_mismatches(
                bridge.state_to_numpy(lane_view(lanes, r)),
                bridge.state_to_numpy(lane_view(other, 0)))
            if bad:
                fail(f"B1 float64 lane {r}: state differs at {bad[:5]}")
    print(f"B1 float64, R = 32 lanes at the bench shape in one launch: every "
          f"lane bitwise equal to its single-lane run, lanes 0-1 to the plain "
          f"step; {lane_us:.3f} us per event and lane (the second chunk)")
    # ---- B2's double instance
    fleet, params, n = cli_params("default_policy", X64_ARGV)
    eng = Engine(fleet, params, device="cuda")
    wl = eng.workload
    S = wl.n_streams

    def args_of(st, lanes_=()):
        shape = lanes_ + (S,)
        return (st.arr_key, st.arr_count.reshape(shape).contiguous(),
                st.next_arrival.reshape(shape).contiguous(),
                st.arr_cum.reshape(shape).contiguous(),
                st.arr_epoch.reshape(shape).contiguous(), wl.family_t,
                wl.sparams)

    st1 = bridged(with_lane_axis(init_state(params.seed, fleet, params,
                                            workload=wl, device="cuda")),
                  T_LATE, params.log_interval)
    st32 = bridged(batched_init(fleet, params, 32, workload=wl, device="cuda"),
                   T_LATE, params.log_interval)
    args = tuple(a[0] if i < 5 else a for i, a in enumerate(args_of(st1, (1,))))
    largs = args_of(st32, (32,))
    for R_, a_ in ((1, args), (32, largs)):
        for n_ in (1, 2047, n, 4097):
            out = b2.arrival_tables(*a_, n_, with_aux=True)
            ref = b2.arrival_tables_reference(*a_, n_, with_aux=True)
            torch.cuda.synchronize()
            for k in ("sizes", "tnext", "cum", "aux_key", "aux_u"):
                if not torch.equal(out[k].view(torch.uint8),
                                   ref[k].view(torch.uint8)):
                    fail(f"B2 float64 with {R_} lane(s), n = {n_}: {k} "
                         "differs from the plain version")
    b2_ms, _ = device_ms(lambda: b2.arrival_tables(*args, n), "_kernel", reps=50)
    b2_r32 = _queued_ms(lambda: b2.arrival_tables(*largs, 512), reps=50)
    b2_plain = time_cuda(lambda: b2.arrival_tables_reference(*args, n), reps=1,
                         runs=3, warmup=1)
    fams = wl.family_t.tolist()
    n_active = sum(1 for f in fams if f != b2.FAM_OFF)
    n_sin = sum(1 for f in fams if f == b2.FAM_SIN_INV)
    b2_bytes = (2 * 8 + S * (4 + 8 * 4)) + (4 + 8 + 8) * S * n
    int_ops = n_active * n * BLOCKS_PER_ENTRY * THREEFRY_OPS
    f64_ops = n_active * n * SAMPLER_OPS + n_sin * n * BISECT_OPS + S * n
    t_b = b2_bytes / H100_BYTES_PER_S
    t_o = int_ops / H100_F32_OPS_PER_S + f64_ops / H100_F64_OPS_PER_S
    b2_bound, b2_by = max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")
    print(f"B2 float64 (S={S}, from t = 6e5 s): R = 1 and 32 bitwise at n = 1, "
          f"2,047, {n:,}, 4,097; {b2_ms:.4f} ms device time at R = 1, n = "
          f"{n} (R = 32, n = 512: {b2_r32:.4f} ms), plain {b2_plain:.2f} ms, "
          f"bound {b2_bound:.5f} ms ({b2_by})")
    # ---- B6b's float64 draw on the CLI's 200,000-row ring
    C, B = 200_000, UPDATE_B
    rb = seeded_ring(C, 60, 4000, 0.7, 3)
    index = torch.tensor(5, dtype=torch.int32, device="cuda")
    for i, (bs, idx_arg) in enumerate(((B, None), (B, index), (1, None),
                                       (4096, index))):
        key = prng.split(prng.key(80 + i, "cuda"), 2)[0]
        ko = b6b.replay_sample(rb, key, bs, index=idx_arg, x64=True)
        po = replay.replay_sample(rb, b6b.sample_key(key, idx_arg), bs, x64=True)
        for f in (*replay.ROW_FIELDS, "idx"):
            if not torch.equal(ko[f], po[f]):
                fail(f"B6b float64 draw, batch {bs}: {f} differs from its "
                     "plain version")
    key = prng.split(prng.key(77, "cuda"), 2)[0]
    b6_ms, _ = device_ms(lambda: b6b.replay_sample(rb, key, B, index=index,
                                                   x64=True), "replay_sample_")
    b6_plain = time_cuda(lambda: replay.replay_sample(
        rb, b6b.sample_key(key, index), B, x64=True), reps=10)
    row = sum(getattr(rb, f)[0].numel() * getattr(rb, f).element_size()
              for f in replay.ROW_FIELDS)
    b6_bytes = C + 2 * B * row + 4 * B
    b6_bound, b6_by = bound(b6_bytes, B * 3 * THREEFRY_OPS + 2 * C)
    # ---- B5c's float64 bias corrections on the update's four groups
    sizes = {"critic": 287_808, "actor": 69_904, "enc": 144_384, "alpha": 1}
    g = torch.Generator().manual_seed(43)
    cfg = optim.AdamConfig(x64=True)
    for step in (0, 999, 4999):
        res = []
        for plain_path in (False, True):
            g2 = torch.Generator().manual_seed(step)
            groups = [b5c.AdamGroup(
                torch.randn(n_, generator=g2).cuda(),
                (torch.randn(n_, generator=g2) * 0.01).cuda(),
                optim.AdamState(torch.tensor(step, dtype=torch.int32).cuda(),
                                torch.zeros(n_).cuda(), torch.zeros(n_).cuda()))
                for n_ in sizes.values()]
            b5c.adam_update(groups, cfg, plain=plain_path)
            res.append([t for gr in groups for t in (gr.p, gr.st.mu, gr.st.nu,
                                                    gr.st.count)])
        if not all(torch.equal(x, y) for x, y in zip(*res)):
            fail(f"B5c float64 bias corrections at step {step}: differs from "
                 "its plain version")
    groups = [b5c.AdamGroup(torch.randn(n_, generator=g).cuda(),
                            (torch.randn(n_, generator=g) * 0.01).cuda(),
                            optim.AdamState(torch.tensor(0, dtype=torch.int32).cuda(),
                                            torch.zeros(n_).cuda(),
                                            torch.zeros(n_).cuda()))
              for n_ in sizes.values()]
    b5_ms, _ = device_ms(lambda: b5c.adam_update(groups, cfg), "adam_")
    b5_plain = time_cuda(lambda: b5c.adam_update(groups, cfg, plain=True), reps=5)
    n_all = sum(sizes.values())
    b5_bytes = 28 * n_all
    b5_bound, b5_by = bound(b5_bytes, 20 * n_all)
    print(f"B6b float64 draw (C = {C:,}, batch {B}): bitwise at batches 1, "
          f"{B} and 4,096; {b6_ms:.4f} ms device time, plain {b6_plain:.4f} ms, "
          f"bound {b6_bound:.6f} ms ({b6_by}); B5c float64 bias corrections "
          f"(four groups): bitwise at steps 1, 1,000, 5,000; {b5_ms:.4f} ms, "
          f"plain {b5_plain:.4f} ms, bound {b5_bound:.6f} ms ({b5_by})")
    base = rows["base/joint_nf"]
    report["clock64"] = {
        "b1": rows, "b1_max_abs_err": max_err, "b1_lanes_us_per_event": lane_us,
        "b1_summary": {"ms": base["ms"], "plain_ms": base["plain_ms"],
                       "bound_ms": base["bound_ms"], "bound_by": base["bound_by"],
                       "max_abs_err": max_err},
        "b2": {"ms": b2_ms, "ms_r32_bench": b2_r32, "plain_ms": b2_plain,
               "bound_ms": b2_bound, "bound_by": b2_by, "bytes": b2_bytes,
               "max_abs_err": 0.0},
        "b6b": {"ms": b6_ms, "plain_ms": b6_plain, "bound_ms": b6_bound,
                "bound_by": b6_by, "bytes": b6_bytes, "max_abs_err": 0.0},
        "b5c": {"ms": b5_ms, "plain_ms": b5_plain, "bound_ms": b5_bound,
                "bound_by": b5_by, "bytes": b5_bytes, "max_abs_err": 0.0}}


def phase_clock64_cli(report, out_root):
    """(o) the float64 clock's main path through the CLI, past the auto
    threshold (``--duration 200000``, no ``--time-dtype``): ``joint_nf``,
    then ``chsac_af`` learning at the default warm-up (``learning_run``'s
    checks), run.sh's training traffic without inference, a 20 s log tick;
    each run resolved to the float64 clock, every B1 and B2 launch the
    double instance, the update's B6b and B5c calls the float64 ones."""
    from distributed_cluster_gpus_tpu_torch import run_sim
    from distributed_cluster_gpus_tpu_torch.kernels import adam as b5c
    from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.kernels import replay_sample as b6b

    out = os.path.join(out_root, "clock64_joint_nf")
    argv = cli_argv("joint_nf", out) + ["--duration", str(CLOCK64_CLI_S),
                                        *CLOCK64_CLI_ARGV]
    if not run_sim.build_params(run_sim.parse_args(argv)).x64:
        fail("the CLI did not resolve --duration 200000 to the float64 clock")
    torch.cuda.synchronize()
    b1.event_scan.launches = b1.event_scan.x64_launches = 0
    b2.arrival_tables.launches = b2.arrival_tables.x64_launches = 0
    t0 = time.perf_counter()
    st = run_sim.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_b1, n_b2 = b1.event_scan.launches, b2.arrival_tables.launches
    if st.t.dtype != torch.float64 or not bool(st.done) or abs(
            float(st.t) - CLOCK64_CLI_S) > 1e-6:
        fail(f"float64 CLI joint_nf: clock {st.t.dtype} at {float(st.t)}")
    if not (n_b1 > 0 and n_b1 == b1.event_scan.x64_launches):
        fail(f"float64 CLI joint_nf: {b1.event_scan.x64_launches} of {n_b1} "
             "B1 launches the double instance")
    if not (n_b2 > 0 and n_b2 == b2.arrival_tables.x64_launches):
        fail(f"float64 CLI joint_nf: {b2.arrival_tables.x64_launches} of {n_b2} "
             "B2 launches the double instance")
    finished = int(st.n_finished.sum())
    arrived = int(st.jid_counter) - 1
    queued = int((st.queues.tail - st.queues.head).sum())
    placed = int((st.jobs.status != 0).sum())
    if arrived != finished + queued + placed + int(st.n_dropped):
        fail("float64 CLI joint_nf: conservation broken")
    if len(_read_csv(os.path.join(out, "job_log.csv"))) != finished:
        fail("float64 CLI joint_nf: job_log rows differ from the finishes")
    events = int(st.n_events)
    print(f"float64 CLI joint_nf (--duration {CLOCK64_CLI_S:.0f} "
          f"{' '.join(CLOCK64_CLI_ARGV)}, auto -> float64): {events} events, "
          f"{wall:.2f} s wall, {events / wall:.1f} events/s, {finished} "
          f"finished; B1 launches {n_b1}, B2 {n_b2}, all double instances")
    # chsac_af learning past the threshold
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    b6b.replay_sample.x64_launches = 0
    b5c.adam_update.x64_launches = 0
    b1.event_scan.x64_launches = b2.arrival_tables.x64_launches = 0
    l_st, l_wall, rec, launches = learning_run(
        os.path.join(out_root, "clock64_chsac_af"), "onehot", CLOCK64_CLI_S,
        CLOCK64_CLI_ARGV)
    captures = launches["graph_captures"]
    if l_st.t.dtype != torch.float64:
        fail("float64 learning CLI: the clock is not float64")
    x64 = {"event_scan": b1.event_scan.x64_launches,
           "arrival_tables": b2.arrival_tables.x64_launches,
           "replay_sample": b6b.replay_sample.x64_launches,
           "adam_update": b5c.adam_update.x64_launches}
    if (x64["event_scan"] != launches["event_scan"]
            or x64["arrival_tables"] != launches["arrival_tables"]
            or x64["replay_sample"] != 2 * captures
            or x64["adam_update"] != 2 * captures or captures < 1):
        fail(f"float64 learning CLI: float64 calls {x64} for launches "
             f"{launches} and {captures} captures")
    updates = sum(rec["done"])
    l_events = int(l_st.n_events)
    print(f"float64 learning CLI chsac_af (--duration {CLOCK64_CLI_S:.0f} "
          f"{' '.join(CLOCK64_CLI_ARGV)}): {l_events} events, {l_wall:.2f} s "
          f"wall, {l_events / l_wall:.1f} events/s, {updates} updates "
          f"({captures} capture); float64 calls {x64}")
    report["clock64_cli"] = {
        "joint_nf": {"events": events, "wall_s": wall,
                     "events_per_s": events / wall, "b1_launches": n_b1,
                     "b2_launches": n_b2, "finished": finished},
        "chsac_af": {"events": l_events, "wall_s": l_wall,
                     "events_per_s": l_events / l_wall, "updates": updates,
                     "launches": launches, "x64_calls": x64}}
    return {"event_scan": n_b1 + launches["event_scan"],
            "arrival_tables": n_b2 + launches["arrival_tables"],
            "replay_sample": launches["replay_sample"],
            "adam_update": launches["adam_update"]}


# ------------------------------------- checkpoints, resume and shutdown (p)

#: the checkpointed learning run: the paper fleet at the CLI's defaults,
#: about six 4,096-step chunks (240 s ran ten on an H100), a save after
#: every chunk (the two newest kept), the float32 clock
CKPT_S = 150.0
CKPT_ARGV = ("--time-dtype", "float32", "--ckpt-every", "1", "--ckpt-keep",
             "2")
#: the float64 clock's: just past the auto threshold with run.sh's training
#: traffic and no inference (as phase (o)), a save every 4 chunks
CKPT64_S = 100_500.0
CKPT64_ARGV = (*CLOCK64_CLI_ARGV, "--ckpt-every", "4", "--ckpt-keep", "2")
#: the heuristic stopped by SIGTERM: default_policy at the main path's
#: settings over a horizon long enough for a signal to land mid-run
SHUTDOWN_S = 1800.0
SHUTDOWN_CSV_BYTES = 200_000


#: the stages of a restore that CkptTally times, by (module, function):
#: the verified walk (sha256 of each file, the manifest), the npz read, and
#: each tree placed on the card (the learner's with ``sac_from_flax``'s CPU
#: prototype and the shadows' refill); "other" is the rest of the restore
RESTORE_STAGES = {"verify": ("ck", "verify_checkpoint"),
                  "read": ("ck", "_restore_dir"),
                  "sac": ("bridge", "sac_from_numpy"),
                  "replay": ("bridge", "replay_from_numpy"),
                  "sim": ("bridge", "state_from_numpy")}


class CkptTally:
    """While on, records each checkpoint save of a run (``ms_copy``: the
    trees' copy off the card, ``ms_write``: the store's write, digests,
    fsyncs and commit, ``bytes``: the step's payload) and each restore
    (``ms_restore``: verify, read, place on the card, refill the shadows;
    ``restore_split``: its stages' ms, ``RESTORE_STAGES``), every time
    synchronized; and the agents the run used."""

    def __enter__(self):
        from distributed_cluster_gpus_tpu_torch import bridge
        from distributed_cluster_gpus_tpu_torch.rl import train
        from distributed_cluster_gpus_tpu_torch.rl.agent import CHSAC_AF
        from distributed_cluster_gpus_tpu_torch.utils import checkpoint as ck

        self._mods = (train, ck, CHSAC_AF)
        self._orig = (train.ckpt_trees, ck.save_checkpoint, train.restore_run,
                      CHSAC_AF.ingest_chunk)
        o_trees, o_save, o_restore, o_ingest = self._orig
        self.ms_copy, self.ms_write, self.ms_restore, self.bytes = [], [], [], []
        self.agents, self.chunks, self.after_chunk = [], 0, None

        def trees(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = o_trees(*a, **kw)
            self.ms_copy.append((time.perf_counter() - t0) * 1e3)
            return out

        def save(*a, **kw):
            t0 = time.perf_counter()
            d = o_save(*a, **kw)
            self.ms_write.append((time.perf_counter() - t0) * 1e3)
            self.bytes.append(ck.verify_checkpoint(d, digests=False)["total_bytes"])
            return d

        def restore(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.restore_split = dict.fromkeys(RESTORE_STAGES, 0.0)
            self._restoring = True
            try:
                out = o_restore(*a, **kw)
            finally:
                self._restoring = False
            torch.cuda.synchronize()
            self.ms_restore.append((time.perf_counter() - t0) * 1e3)
            self.restore_split["other"] = self.ms_restore[-1] - sum(
                self.restore_split.values())
            return out

        self.restore_split, self._restoring = None, False
        mods = {"ck": ck, "bridge": bridge}
        self._stages = [(mods[m], attr, getattr(mods[m], attr))
                        for m, attr in RESTORE_STAGES.values()]

        def staged(stage, fn):
            def timed_stage(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                if self._restoring:
                    self.restore_split[stage] += (time.perf_counter() - t0) * 1e3
                return out
            return timed_stage

        def ingest(agent, rl_em):
            if agent not in self.agents:
                self.agents.append(agent)
            out = o_ingest(agent, rl_em)
            self.chunks += 1
            if self.after_chunk is not None:
                self.after_chunk(self.chunks)
            return out

        train.ckpt_trees, ck.save_checkpoint, train.restore_run = trees, save, restore
        CHSAC_AF.ingest_chunk = ingest
        for stage, (mod, attr, fn) in zip(RESTORE_STAGES, self._stages):
            setattr(mod, attr, staged(stage, fn))
        return self

    def __exit__(self, *exc):
        train, ck, CHSAC_AF = self._mods
        (train.ckpt_trees, ck.save_checkpoint, train.restore_run,
         CHSAC_AF.ingest_chunk) = self._orig
        for mod, attr, fn in self._stages:
            setattr(mod, attr, fn)


def _final_leaves(st, agent):
    """A run's final SimState, learner, replay ring and agent key as trees."""
    from distributed_cluster_gpus_tpu_torch import bridge

    return {"sim": bridge.state_to_numpy(st),
            "sac": bridge.sac_to_numpy(agent.cfg, agent.sac),
            "replay": bridge.replay_to_numpy(agent.replay),
            "key": agent.key.numpy()}


def _same_bytes(a_dir, b_dir, where, prefix=False):
    """The two runs' CSVs byte for byte (or ``b``'s a strict prefix of
    ``a``'s); returns their sizes."""
    sizes = {}
    for name in ("cluster_log.csv", "job_log.csv"):
        with open(os.path.join(a_dir, name), "rb") as f:
            a = f.read()
        with open(os.path.join(b_dir, name), "rb") as f:
            b = f.read()
        ok = (0 < len(b) < len(a) and a.startswith(b)) if prefix else a == b
        if not ok:
            fail(f"{where}: {name} ({len(b)} bytes) is not "
                 f"{'a strict byte prefix of' if prefix else 'byte for byte'} "
                 f"the uninterrupted run's ({len(a)} bytes)")
        sizes[name] = (len(a), len(b))
    return sizes


def _summary_status(out):
    with open(os.path.join(out, "run_summary.json")) as f:
        return json.load(f)["status"]


def _sigterm_child(argv, ready, where, timeout=600):
    """The CLI in a child process, sent SIGTERM once ``ready()`` holds:
    (exit code, output, wall s).  Fails if the run ended before the
    signal could be sent."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_cluster_gpus_tpu_torch.run_sim",
         *argv], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + timeout
        while proc.poll() is None and not ready() and time.time() < deadline:
            time.sleep(0.005)
        if proc.poll() is not None:
            fail(f"{where}: the run ended (exit {proc.returncode}) before "
                 f"the signal was sent:\n{proc.stdout.read()[-2000:]}")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, out, time.perf_counter() - t0


def _zero_launches():
    from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.kernels import replay_ingest as b6
    from distributed_cluster_gpus_tpu_torch.kernels.param_pack import param_pack

    counters = {"event_scan": b1.event_scan, "arrival_tables": b2.arrival_tables,
                "replay_ingest": b6.replay_ingest, "param_pack": param_pack,
                **update_counters()}
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    b1.event_scan.rl_launches = 0

    def read():
        torch.cuda.synchronize()
        out = {k: w.launches for k, w in counters.items()}
        out["rl"] = b1.event_scan.rl_launches
        return out

    return read


def gc_cuda():
    """Free what the earlier runs cached on the card, as a fresh CLI
    process would start."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _resume_case(label, argv_of, out_root, external):
    """One learning run three ways: uninterrupted, stopped by SIGTERM after
    about half its chunks, resumed from the stopped run's store.
    ``external``: the stop is a child process sent SIGTERM once its store
    holds that chunk's step; else the CLI in this process signals itself
    after that chunk.  Holds the CSVs byte for byte and the final SimState,
    learner, ring and key bitwise; returns the case's record."""
    import signal

    from distributed_cluster_gpus_tpu_torch import bridge, run_sim
    from distributed_cluster_gpus_tpu_torch.utils import checkpoint as ck

    full, part = (os.path.join(out_root, f"{label}_{s}") for s in ("full", "part"))
    gc_cuda()
    with CkptTally() as t_full:
        st_full = run_sim.main(argv_of(full))
    n_chunks = t_full.chunks
    agent_full = t_full.agents[-1]
    k = max(1, n_chunks // 2 - 1)
    if n_chunks < 3 or not (0 < agent_full.sac.step) or not bool(st_full.done):
        fail(f"{label}: {n_chunks} chunks, {agent_full.sac.step} updates, done "
             f"{bool(st_full.done)}: too short a run to stop and resume")
    store = os.path.join(part, "ckpt")
    wall_child = None
    if external:
        rc, text, wall_child = _sigterm_child(
            argv_of(part), lambda: max(ck.steps(store), default=-1) >= k - 1,
            f"{label} (child)")
        if rc != 143 or "interrupted by signal 15: artifacts flushed, exiting 143" \
                not in text:
            fail(f"{label}: the child sent SIGTERM exited {rc}:\n{text[-2000:]}")
    else:
        def stop(chunks):  # after chunk k (the count is 1-based)
            if chunks == k + 1:
                os.kill(os.getpid(), signal.SIGTERM)

        gc_cuda()
        with CkptTally() as t_stop:
            t_stop.after_chunk = stop
            try:
                run_sim.main(argv_of(part))
                rc = 0
            except SystemExit as e:
                rc = e.code
        if rc != 143:
            fail(f"{label}: the CLI sent SIGTERM exited {rc}, not 143")
    stopped_at = ck.latest_step(store, verified=True)
    status = _summary_status(part)
    if stopped_at is None or not (0 < stopped_at < n_chunks - 1) or \
            status != "interrupted":
        fail(f"{label}: stopped at step {stopped_at} of {n_chunks} chunks, "
             f"run_summary.json {status!r}")
    before = int(ck.restore_checkpoint(store, stopped_at,
                                       names=["sac"])["sac"]["step"])
    gc_cuda()
    read = _zero_launches()
    with CkptTally() as t_res:
        st_res = run_sim.main(argv_of(part))
    launches = read()
    agent_res = t_res.agents[-1]
    n_res = t_res.chunks
    sizes = _same_bytes(full, part, label)
    bad = bridge.tree_mismatches(_final_leaves(st_full, agent_full),
                                 _final_leaves(st_res, agent_res))
    if bad:
        fail(f"{label}: the resumed run's final leaves differ bitwise from the "
             f"uninterrupted run's: {bad[:8]}")
    if _summary_status(part) != "completed":
        fail(f"{label}: the resumed run's run_summary.json is not completed")
    # the resumed run launched every kernel of its path: B1 (RL mode) and B2
    # once a chunk, B6a, the update's kernels (its eager update and its
    # capture), B5g for the new agent's shadows and again for the restored
    want_chunks = [launches[k_] for k_ in ("event_scan", "rl", "arrival_tables")]
    if want_chunks != [n_res] * 3 or launches["replay_ingest"] < n_res or \
            launches["param_pack"] != 2 or min(
                launches[k_] for k_ in update_counters()
                if per_update("onehot")[k_]) <= 0:
        fail(f"{label}: the resumed run's launches {launches} for {n_res} chunks")
    if not 0 < before < agent_res.sac.step:
        fail(f"{label}: {before} updates before the stop, "
             f"{agent_res.sac.step} at the end: not both sides of the save")
    if agent_res.graph_captures < 1 or agent_res.graph_replays <= 0:
        fail(f"{label}: after the restore the update was captured "
             f"{agent_res.graph_captures} times, replayed "
             f"{agent_res.graph_replays}")
    saves = t_full.ms_copy + t_res.ms_copy
    writes = t_full.ms_write + t_res.ms_write
    store_bytes = sum(os.path.getsize(os.path.join(dp, f))
                      for dp, _, fs in os.walk(store) for f in fs)
    rec = {"chunks": n_chunks, "stop_after": k, "stopped_at_step": stopped_at,
           "resumed_chunks": n_res, "external_sigterm": external,
           "child_wall_s": wall_child, "events": int(st_full.n_events),
           "updates": agent_full.sac.step, "updates_before_stop": before,
           "csv_bytes": sizes,
           "graph_captures_after_restore": agent_res.graph_captures,
           "graph_replays_after_restore": agent_res.graph_replays,
           "save_copy_ms": saves, "save_write_ms": writes,
           "save_ms_median": statistics.median(
               [a + b for a, b in zip(saves, writes)]),
           "restore_ms": t_res.ms_restore,
           "restore_split_ms": t_res.restore_split,
           "step_bytes": t_full.bytes[-1],
           "store_bytes": store_bytes, "launches": launches,
           "clock": str(st_res.t.dtype)}
    print(f"{label}: {n_chunks} chunks ({int(st_full.n_events)} events, "
          f"{agent_full.sac.step} updates) uninterrupted; SIGTERM "
          f"{'to a child process' if external else 'to this process'} after "
          f"chunk {k}: exit 143, stopped at step {stopped_at} after {before} "
          f"updates, "
          f"run_summary.json interrupted; resumed for {n_res} chunks: CSVs byte "
          f"for byte ({sizes}), the final SimState, learner, ring and key "
          f"bitwise; the update captured again after the restore "
          f"({agent_res.graph_captures} capture, {agent_res.graph_replays} "
          f"replays); save {statistics.median(saves):.1f} ms copy + "
          f"{statistics.median(writes):.1f} ms write (median of {len(saves)}), "
          f"restore {t_res.ms_restore[0]:.1f} ms ("
          + ", ".join(f"{k} {v:.1f}" for k, v in t_res.restore_split.items())
          + f"), {t_full.bytes[-1]} bytes a "
          f"step, {store_bytes} bytes in the store; launches in the resumed "
          f"run {launches}")
    return rec


def phase_checkpoint_cli(report, out_root):
    """(p) checkpoints, resume and graceful shutdown through the CLI: the
    learning main path (chsac_af on the paper fleet at the CLI's defaults,
    ``--ckpt-dir`` with a save every chunk, the float32 clock) three ways:
    uninterrupted; a child process sent SIGTERM once its store holds the
    middle chunk (it exits 143, ``run_summary.json`` says "interrupted");
    the resume of that store to the end.  The resumed CSVs byte for byte,
    the final SimState, learner, ring and agent key bitwise against the
    uninterrupted run's, the update captured again after the restore.  The
    same for the float64 clock just past the auto threshold (the CLI
    signalling itself after the middle chunk).  Then ``default_policy`` in
    a child sent SIGTERM mid-run: exit 143, its CSVs a strict byte prefix
    of the uninterrupted run's.  Save and restore ms and the store's bytes
    beside the card's name and power limit."""
    from distributed_cluster_gpus_tpu_torch import run_sim

    rec = {"card": card_line()}
    rec["float32"] = _resume_case(
        "chsac_af checkpoints (float32)",
        lambda o: learning_argv(o, duration=CKPT_S, extra=(
            *CKPT_ARGV, "--ckpt-dir", os.path.join(o, "ckpt"))),
        out_root, external=True)
    argv64 = lambda o: learning_argv(o, duration=CKPT64_S, extra=(  # noqa: E731
        *CKPT64_ARGV, "--ckpt-dir", os.path.join(o, "ckpt")))
    if not run_sim.build_params(run_sim.parse_args(argv64("unused"))).x64:
        fail("the CLI did not resolve the checkpoint case to the float64 clock")
    rec["float64"] = _resume_case("chsac_af checkpoints (float64)", argv64,
                                  out_root, external=False)
    # default_policy: the uninterrupted run here, the stopped one a child
    full = os.path.join(out_root, "shutdown_full")
    part = os.path.join(out_root, "shutdown_part")
    argv = lambda o: cli_argv("default_policy", o) + [  # noqa: E731
        "--duration", str(SHUTDOWN_S)]
    st = run_sim.main(argv(full))
    cl = os.path.join(part, "cluster_log.csv")
    rc, text, wall = _sigterm_child(
        argv(part), lambda: os.path.exists(cl) and os.path.getsize(cl)
        > SHUTDOWN_CSV_BYTES, "default_policy (child)")
    if rc != 143 or _summary_status(part) != "interrupted":
        fail(f"default_policy sent SIGTERM: exit {rc}, run_summary.json "
             f"{_summary_status(part)!r}:\n{text[-2000:]}")
    sizes = _same_bytes(full, part, "default_policy under SIGTERM", prefix=True)
    print(f"default_policy ({SHUTDOWN_S:.0f} s) in a child sent SIGTERM: exit "
          f"143, CSVs a strict byte prefix of the uninterrupted run's "
          f"({sizes}; {int(st.n_events)} events uninterrupted), "
          f"run_summary.json interrupted; {rec['card']}")
    rec["default_policy"] = {"exit": rc, "csv_bytes": sizes,
                             "child_wall_s": wall}
    report["checkpoints"] = rec
    return rec


# ------------------------------------------- (q) the host loop and harness

#: phase (q)'s turns of each base algorithm, in the A/B order of the studies
HOST_LOOP_TURNS = ("serial", "pipelined", "pipelined", "serial")
#: the harness runs of phase (q): (config, eval flags)
EVAL_S = 120.0
EVAL_RUNS = (("3", ()), ("4", ("--rollouts", "1")))


class ChunkSpans:
    """While on, records CUDA events on the stream around every
    ``Engine.run_chunk`` (a chunk's work as the host queues it: B2, B1 and
    the carries' small ops); ``ms()`` after the run sums the spans, the
    device's busy time as the stream saw it (idle gaps inside a chunk's
    queueing included)."""

    def __enter__(self):
        from distributed_cluster_gpus_tpu_torch.sim import engine

        self._cls, self._orig = engine.Engine, engine.Engine.run_chunk
        self.events = []
        orig = self._orig

        def spanned(eng, *args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(eng, *args, **kw)
            b.record()
            self.events.append((a, b))
            return out

        self._cls.run_chunk = spanned
        return self

    def __exit__(self, *exc):
        self._cls.run_chunk = self._orig

    def ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def _host_loop_run(algo, loop, out):
    """One main-path run (the CLI's fleet and params for ``algo``) through
    ``run_simulation``'s ``loop`` ("serial": a no-op hook; "pipelined": the
    CLI's path); returns (final state, record, the first chunk's host
    copy)."""
    from distributed_cluster_gpus_tpu_torch.obs.trace import PhaseTimer
    from distributed_cluster_gpus_tpu_torch.sim import io as sio

    fleet, params, n_steps = cli_params(algo)
    timer, first = PhaseTimer(), []

    def hook(state, em, engine):
        if not first:
            first.append(sio.HostChunk.of(em, state).wait())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with B1Tally() as tally, ChunkSpans() as spans:
        st = sio.run_simulation(fleet, params, out_dir=out,
                                chunk_steps=n_steps, device="cuda",
                                timer=timer,
                                on_chunk=hook if loop == "serial" else None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = int(st.n_events)
    rec = {"loop": loop, "events": events, "wall_s": wall,
           "events_per_s": events / wall, "b1_ms": tally.ms(),
           "chunk_span_ms": spans.ms(), "chunks": len(spans.events),
           "phases_s": dict(timer.totals)}
    rec["b1_us_per_event"] = rec["b1_ms"] / max(events, 1) * 1e3
    rec["busy_share"] = rec["chunk_span_ms"] / (wall * 1e3)
    # the engine's and the writers' set-up and the worker's last render
    rec["outside_phases_s"] = wall - sum(
        v for k, v in timer.totals.items() if k != "io_render")
    return st, rec, (first[0] if first else None)


def _native_vs_plain(fleet, host, root):
    """One chunk of real emissions through the native writer and the
    Python renderer: byte for byte; returns the two renders' ms."""
    import numpy as np

    from distributed_cluster_gpus_tpu_torch.sim import io as sio

    em = host.emissions()
    cl = np.nonzero(em["cluster_valid"])[0]
    jb = np.nonzero(em["job_valid"])[0]
    if not len(cl) or not len(jb):
        fail(f"native writer: the first chunk has {len(cl)} log ticks and "
             f"{len(jb)} job rows; the check needs both")
    ms, data = {}, {}
    for name, plain in (("native", False), ("python", True)):
        d = os.path.join(root, f"render_{name}")
        w = sio.CSVWriters(d, fleet, plain=plain)
        t0 = time.perf_counter()
        w.write_cluster_chunk(em["cluster"], cl)
        w.write_job_chunk(em["job"], jb)
        ms[name] = (time.perf_counter() - t0) * 1e3
        data[name] = [open(p, "rb").read() for p in (w.cluster_path,
                                                     w.job_path)]
    if data["native"] != data["python"]:
        fail("native writer: its bytes differ from the Python renderer's on "
             "one chunk of real emissions")
    return {"cluster_rows": int(len(cl)) * fleet.n_dc, "job_rows": int(len(jb)),
            "bytes": sum(map(len, data["native"])), "native_ms": ms["native"],
            "python_ms": ms["python"]}


def _eval_cli_argv(base, algo, chunk_steps, out):
    """run_sim's command line for ``base`` with ``algo``: the params the
    harness runs (checked equal field by field before the run)."""
    argv = ["--algo", algo, "--duration", repr(base.duration),
            "--log-interval", repr(base.log_interval), "--seed", str(base.seed),
            "--inf-mode", base.inf_mode, "--inf-rate", repr(base.inf_rate),
            "--inf-amp", repr(base.inf_amp), "--inf-period",
            repr(base.inf_period), "--trn-mode", base.trn_mode,
            "--trn-rate", repr(base.trn_rate), "--job-cap", str(base.job_cap),
            "--queue-cap", str(base.queue_cap), "--rl-warmup",
            str(base.rl_warmup), "--rl-batch", str(base.rl_batch),
            "--eco-objective", base.eco_objective, "--time-dtype",
            base.time_dtype, "--chunk-steps", str(chunk_steps),
            "--device", "cuda", "--quiet", "--out", out]
    return argv


def _same_row(a, b):
    if set(a) != set(b):
        return False
    return all(a[k] == b[k] or (isinstance(a[k], float) and a[k] != a[k]
                                and b[k] != b[k]) for k in a)


def _phase_eval(report, root):
    """The harness on the card: each run of ``EVAL_RUNS`` through the
    port's eval CLI, B1 and B2 launched in every algorithm's run (B1's RL
    mode, B6a and the update's kernels in chsac_af's), each row equal to
    ``_summarize`` of the same params run through ``run_sim.main``."""
    import dataclasses

    from distributed_cluster_gpus_tpu_torch import evaluation, run_sim
    from distributed_cluster_gpus_tpu_torch import eval as port_eval
    from distributed_cluster_gpus_tpu_torch.rl import train as rtrain

    out = {}
    orig_run_algo = evaluation.run_algo
    for n, flags in EVAL_RUNS:
        counts = {}

        def counted(fleet, params, *a, **kw):
            read = _zero_launches()
            s = orig_run_algo(fleet, params, *a, **kw)
            counts[params.algo] = read()
            return s

        argv = ["--config", n, "--duration", str(EVAL_S), *flags]
        evaluation.run_algo = counted
        t0 = time.perf_counter()
        try:
            res = port_eval.main(argv)
        finally:
            evaluation.run_algo = orig_run_algo
        wall = time.perf_counter() - t0
        spec = (evaluation.baseline_config(int(n), EVAL_S))
        rows = res[f"config{n}"]["per_seed"]["123"]
        got = {}
        for row in rows:
            algo = row["algo"]
            c = counts[algo]
            if c["event_scan"] <= 0 or c["arrival_tables"] <= 0:
                fail(f"eval config {n}: {algo} launched B1 {c['event_scan']} "
                     f"and B2 {c['arrival_tables']} times")
            if algo == "chsac_af":
                upd = {k: c[k] for k in update_counters()}
                if c["rl"] <= 0 or c["replay_ingest"] <= 0 or not all(
                        upd.values()):
                    fail(f"eval config {n}: chsac_af launched B1 in RL mode "
                         f"{c['rl']}, B6a {c['replay_ingest']} times, the "
                         f"update's kernels {upd}")
            params = dataclasses.replace(spec["base"], algo=algo)
            cli = _eval_cli_argv(spec["base"], algo, 4096,
                                 os.path.join(root, f"eval{n}_{algo}"))
            built = run_sim.build_params(run_sim.parse_args(cli))
            if built != params:
                fail(f"eval config {n} {algo}: the CLI builds other params "
                     f"than the harness runs ({built} != {params})")
            agents = []
            orig_train = rtrain.train_chsac

            def train_chsac(*a, **kw):
                r = orig_train(*a, **kw)
                agents.append(r[1])
                return r

            rtrain.train_chsac = train_chsac
            try:
                st = run_sim.main(cli)
            finally:
                rtrain.train_chsac = orig_train
            extra = ({"train_steps": int(agents[0].sac.step)}
                     if algo == "chsac_af" else None)
            want = evaluation._summarize(algo, spec["fleet"], st, extra).row()
            if not _same_row(row, want):
                fail(f"eval config {n} {algo}: the harness's row {row} is not "
                     f"run_sim's {want}")
            got[algo] = {"row": row, "launches": c}
            upd = sum(c[k] for k in update_counters())
            print(f"eval config {n} ({' '.join(argv)}) {algo}: {row}; B1 "
                  f"{c['event_scan']} launches ({c['rl']} RL mode), B2 "
                  f"{c['arrival_tables']}, B6a {c['replay_ingest']}, the "
                  f"update's wrappers {upd}; equal to run_sim.main's row")
        out[n] = {"argv": argv, "wall_s": wall, "algos": got}
    report["host_loop"]["eval"] = out


def phase_host_loop(report, out_root):
    """(q) the pipelined host loop against the serial one on the main path
    (``default_policy`` and ``joint_nf``, paper fleet, 600 s; turns
    serial, pipelined, pipelined, serial): the CSVs byte for byte and every
    final SimState leaf bitwise; events/s, the timer's split, B1's device
    time and the device's busy share for each; the native writer against
    the Python renderer on one chunk of real emissions; then the harness
    (``eval``) on the card."""
    from distributed_cluster_gpus_tpu_torch import bridge

    card = card_line()
    rec = {"card": card, "runs": {}}
    report["host_loop"] = rec
    for algo in ALGOS:
        turns, ref, first = [], None, None
        for i, loop in enumerate(HOST_LOOP_TURNS):
            out = os.path.join(out_root, f"host_{algo}_{i}_{loop}")
            st, r, host = _host_loop_run(algo, loop, out)
            if host is not None and first is None:
                first = host
            leaves = bridge.state_to_numpy(st)
            if ref is None:
                ref = (out, leaves)
            else:
                _same_bytes(ref[0], out, f"host loop {algo} turn {i} ({loop})")
                for k in leaves:
                    if not _same_tree(ref[1][k], leaves[k]):
                        fail(f"host loop {algo} turn {i} ({loop}): final "
                             f"SimState leaf {k} differs from turn 0's")
            turns.append(r)
            ph = r["phases_s"]
            print(f"host loop {algo} {loop}: {r['events_per_s']:.1f} events/s "
                  f"({r['events']} events, {r['wall_s']:.3f} s wall, "
                  f"{r['chunks']} chunks); B1 {r['b1_ms']:.2f} ms "
                  f"({r['b1_us_per_event']:.3f} us/event); chunks' device "
                  f"spans {r['chunk_span_ms']:.2f} ms, busy share "
                  f"{r['busy_share']:.3f}; phases "
                  + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in
                              sorted(ph.items()))
                  + f", outside them {r['outside_phases_s'] * 1e3:.2f} ms; "
                  f"{card}")
        native = _native_vs_plain(cli_params(algo)[0], first, out_root)
        print(f"native writer, {algo}'s first chunk: {native['cluster_rows']} "
              f"cluster + {native['job_rows']} job rows, {native['bytes']} "
              f"bytes, byte for byte the Python renderer's; "
              f"{native['native_ms']:.3f} ms native, {native['python_ms']:.3f} "
              "ms Python")
        rec["runs"][algo] = {"turns": turns, "native_writer": native}
    _phase_eval(report, out_root)
    return rec


def _same_tree(a, b):
    import numpy as np

    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_tree(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


# ------------------------------------------------- opt-in studies of B1

#: the instrumented kernel's ``g_prof`` slots: cycles on thread 0 by phase
#: of an event (the head's four parts, the branches, the RL tail), then
#: counts (B3 calls, B3 rounds, B3 window walks, forwards)
B1_PHASES = ("head: slab pass + argmins", "head: dc_tree_sums",
             "head: scalar (choice, accrual, key split)", "head: progress pass",
             "finish commit", "drain", "xfer (evict or start plan)", "arrival",
             "log_tick", "B3 (2 windows)", "running power + obs",
             "masks/costs/record", "forward", "softmax+sample",
             "commit (route/drain)", "commit (none/xfer)", "event count")
B1_COUNTS = {20: "B3 calls", 21: "B3 rounds", 22: "B3 window walks",
             23: "forwards", 24: "B3 listed values"}
#: parts of a phase, in cycles (not in the total): the RL forward's
#: barriers of the lane's cluster
B1_PARTS = {25: "forward: the request's cluster barrier",
            26: "forward: the layers' cluster barriers",
            27: "forward: the hidden layers' arithmetic",
            28: "forward: the request's writes"}
# the RL step's branch phase goes to the slot of its branch
_RL_BRANCH_SLOT = ("(branch == EV_FINISH ? 4 : branch == EV_XFER ? 6 : "
                   "branch == EV_ARRIVAL ? 7 : branch == EV_LOG ? 8 : 16)")

# Anchors of the kernel's phases: (text, text with marks), where @k@ stands
# for a mark into slot k and @@ for the start of the clock; B3's counts
# (windows computed, fallback rounds and walks, listed values) written out
B1_ANCHORS = (
    ("  __device__ void step(int i) {\n    head(i);\n",
     "  __device__ void step(int i) {\n@@    head(i);\n"),
    ("  __device__ void step_rl(int i) {\n    head(i);\n",
     "  __device__ void step_rl(int i) {\n@@    head(i);\n"),
    ("    if (lane == 0) atomicMin(&sm.afe[p], fe);\n    bar();\n",
     "    if (lane == 0) atomicMin(&sm.afe[p], fe);\n    bar();\n@0@"),
    ("    dc_tree_sums(sm.active, true);\n    if constexpr (kD) {\n",
     "    dc_tree_sums(sm.active, true);\n@1@    if constexpr (kD) {\n"),
    ("    // job progress over the gap (every slot; running ones advance)\n",
     "@2@    // job progress over the gap (every slot; running ones advance)\n"),
    ("      F(JF_UDONE, j) = minimum(F(JF_SIZE, j), F(JF_UDONE, j) + prog);\n"
     "    }\n    bar();\n  }\n",
     "      F(JF_UDONE, j) = minimum(F(JF_SIZE, j), F(JF_UDONE, j) + prog);\n"
     "    }\n    bar();\n@3@  }\n"),
    ("      if (tid == 0) finish(i);\n      bar();\n"
     "      drain(I(JI_DC, sm.j_fin), true, -1);\n",
     "      if (tid == 0) finish(i);\n      bar();\n@4@"
     "      drain(I(JI_DC, sm.j_fin), true, -1);\n@5@"),
    ("        bar();\n      } else {  // iteration 0 of the shared drain "
     "is the xfer start\n        drain(dcj, false, j);\n      }\n",
     "        bar();\n@6@      } else {  // iteration 0 of the shared "
     "drain is the xfer start\n        drain(dcj, false, j);\n@5@      }\n"),
    ("      if (tid == 0) arrival();\n      bar();\n"
     "    } else if (branch == EV_LOG) {\n      log_tick(i);\n    }\n"
     "    if (tid == 0) sm.n_events = wadd(sm.n_events, 1);\n",
     "      if (tid == 0) arrival();\n      bar();\n@7@"
     "    } else if (branch == EV_LOG) {\n      log_tick(i);\n@8@    }\n"
     "    if (tid == 0) sm.n_events = wadd(sm.n_events, 1);\n@16@"),
    ("    tail(i);\n    if (tid == 0 && branch != EV_NOOP)",
     "@B@    tail(i);\n    if (tid == 0 && branch != EV_NOOP)"),
    ("    if (tid == 0 && branch != EV_NOOP) sm.n_events = wadd(sm.n_events, 1);\n",
     "    if (tid == 0 && branch != EV_NOOP) sm.n_events = wadd(sm.n_events, 1);\n@16@"),
    ("      if (tid < 2) sm.p99_ok[tid] = 1;\n    }\n",
     "      if (tid < 2) sm.p99_ok[tid] = 1;\n      if (tid == 0) atomicAdd("
     "&g_prof[20], (unsigned long long)(stale[0] + stale[1]));\n    }\n@9@"),
    ("    build_obs();\n    bar();\n    if (tid == 0) {\n",
     "    build_obs();\n    bar();\n@10@    if (tid == 0) {\n"),
    ("    if (req == REQ_NONE) {\n", "@11@    if (req == REQ_NONE) {\n"),
    ("    rlk::forward<NT>(*pol, *slice, wsm, obs, act0, act1, logit, cmd, cs, tid);\n",
     "    rlk::forward<NT>(*pol, *slice, wsm, obs, act0, act1, logit, cmd, cs, tid);\n"
     "@12@@C23@"),
    ("&sm.a_g, tid);\n    bar();\n", "&sm.a_g, tid);\n    bar();\n@13@"),
    ("      write_trace(slot);\n      bar();\n      return;",
     "      write_trace(slot);\n      bar();\n@14@      return;"),
    ("    if (sm.flag) write_trace(sm.fin_slot);\n    bar();\n  }",
     "    if (sm.flag) write_trace(sm.fin_slot);\n    bar();\n@14@  }"),
    ("                  sm.st_t0, sm.st_pt0, sm.st_tpt0);\n"
     "      bar();\n      return;",
     "                  sm.st_t0, sm.st_pt0, sm.st_tpt0);\n"
     "      bar();\n@15@      return;"),
    ("    if (cnt == 0) break;  // cannot happen for r_lo < m; a guard\n",
     "    if (lane == 0) atomicAdd(&g_prof[21], 1ull);\n"
     "    if (cnt == 0) break;  // cannot happen for r_lo < m; a guard\n"),
    ("                lane);\n    if (lane == 0) {\n      sc.s_bits[2 * w] = ordered(s_lo);",
     "                lane);\n    if (lane == 0) atomicAdd(&g_prof[22], 1ull);\n"
     "    if (lane == 0) {\n      sc.s_bits[2 * w] = ordered(s_lo);"),
    ("    dense_rows_kp<NT>(P.kp[k], x, true, xs, wsm + S.off[k], bsm + S.boff[k],\n"
     "                      S.lo[k], S.n[k], out, kp_out, true, cs, tid);\n",
     "    { long long _b = clock64();\n"
     "    dense_rows_kp<NT>(P.kp[k], x, true, xs, wsm + S.off[k], bsm + S.boff[k],\n"
     "                      S.lo[k], S.n[k], out, kp_out, true, cs, tid);\n"
     "    if (tid == 0 && cg::this_cluster().block_rank() == 0) atomicAdd("
     "&g_prof[27], (unsigned long long)(clock64() - _b)); }\n"),
    ("  const int kp0 = P.kp[0];\n  for (int e = tid; e < kp0 * cs; e += NT) {",
     "  const long long _f0 = clock64();\n"
     "  const int kp0 = P.kp[0];\n  for (int e = tid; e < kp0 * cs; e += NT) {"),
    ("  if (tid > 0 && tid < cs) *cl.map_shared_rank(cmd, tid) = CMD_FORWARD;\n"
     "  cl.sync();\n",
     "  if (tid > 0 && tid < cs) *cl.map_shared_rank(cmd, tid) = CMD_FORWARD;\n"
     "  if (tid == 0) atomicAdd(&g_prof[28], (unsigned long long)(clock64() - _f0));\n"
     "  cl.sync();\n"),
    ("    cg::this_cluster().sync();\n  }\n  // the heads share their input",
     "    { long long _b = clock64();\n    cg::this_cluster().sync();\n"
     "    if (tid == 0 && cg::this_cluster().block_rank() == 0) atomicAdd("
     "&g_prof[26], (unsigned long long)(clock64() - _b)); }\n  }\n"
     "  // the heads share their input"),
    ("                    S.lo[5], S.n[5], logit + 32, 0, false, cs, tid);\n"
     "  cg::this_cluster().sync();\n",
     "                    S.lo[5], S.n[5], logit + 32, 0, false, cs, tid);\n"
     "  { long long _b = clock64();\n  cg::this_cluster().sync();\n"
     "  if (tid == 0 && cg::this_cluster().block_rank() == 0) atomicAdd("
     "&g_prof[26], (unsigned long long)(clock64() - _b)); }\n"),
    ("  cl.sync();\n  forward_cluster<NT>(P, S, wsm, act0, act1, logit, cs, tid);\n",
     "  { long long _b = clock64();\n  cl.sync();\n"
     "  if (tid == 0) atomicAdd(&g_prof[25], (unsigned long long)(clock64() - _b)); }\n"
     "  forward_cluster<NT>(P, S, wsm, act0, act1, logit, cs, tid);\n"),
    ("    const int n = sc.n_cand[w];\n",
     "    const int n = sc.n_cand[w];\n"
     "    if (tid == 0) atomicAdd(&g_prof[24], (unsigned long long)n);\n"),
)


def instrumented_event_scan(src):
    """``csrc/event_scan.cu`` with ``clock64`` accumulators on the first
    thread in a device array ``g_prof`` (slots 0-16 the phases of
    ``B1_PHASES``, 20-24 the counts of ``B1_COUNTS``, 25-28 the parts of
    ``B1_PARTS``) and entry points to read and reset it; exits if an
    anchor of ``B1_ANCHORS`` is gone."""

    def expand(text):
        out = text
        for k in B1_COUNTS:
            out = out.replace(f"@C{k}@", f"    if (tid == 0) atomicAdd(&g_prof[{k}], 1ull);\n")
        out = out.replace("@@", "    t_mark = clock64();\n")
        out = out.replace("@B@", "@%s@" % _RL_BRANCH_SLOT)
        parts = out.split("@")
        for n in range(1, len(parts), 2):
            parts[n] = ("    { long long _t = clock64(); if (tid == 0) atomicAdd("
                        "&g_prof[%s], (unsigned long long)(_t - t_mark)); "
                        "t_mark = _t; }\n" % parts[n])
        return "".join(parts)

    def rep(old, new):
        if src.count(old) != 1:
            fail(f"instrumenting event_scan.cu: anchor found {src.count(old)} "
                 f"times, not once: {old!r}")
        return src.replace(old, new, 1)

    src = rep('#include "threefry.cuh"\n',
              '#include "threefry.cuh"\n__device__ unsigned long long g_prof[32];\n')
    src = rep("  int n_ing;\n};", "  int n_ing;\n  long long t_mark;\n};")
    for old, new in B1_ANCHORS:
        src = rep(old, expand(new))
    return src + (
        '\nextern "C" int prof_read(unsigned long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n}\n"
        'extern "C" int prof_reset() {\n  unsigned long long z[32] = {0};\n'
        "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n")


def _phase_table(label, out, n_steps, wall_ms):
    tot = sum(out[k] for k in range(len(B1_PHASES)))
    print(f"{label}: {wall_ms:.1f} ms wall, " + ", ".join(
        f"{out[k]} {name}" for k, name in B1_COUNTS.items()))
    rows = {}
    for k, name in enumerate(B1_PHASES):
        if out[k]:
            print(f"   {name:42s} {out[k]:>13d} cycles {100 * out[k] / max(tot, 1):5.1f}%"
                  f"  per event {out[k] / n_steps:9.0f}")
        rows[name] = out[k] / n_steps
    for k, name in B1_PARTS.items():
        if out[k]:
            print(f"     of which {name:32s} {out[k]:>13d} cycles  per event "
                  f"{out[k] / n_steps:9.0f}")
        rows[name] = out[k] / n_steps
    print(f"   total {tot} cycles = {tot / n_steps:.0f} per event")
    return {"cycles_per_event": rows, "total_per_event": tot / n_steps,
            "counts": {name: out[k] for k, name in B1_COUNTS.items()},
            "wall_ms": wall_ms}


def _instrumented_b1(d, names):
    """Build ``B1_ANCHORS``' instrumented copy of this checkout's
    ``csrc/event_scan.cu`` into ``d`` under each of ``names`` (``event_scan``
    itself; ``event_scan_sig``, the same with ``DCG_SIGNALS``), all ``nvcc``
    processes started together, and make B1's wrapper launch them; returns
    {name: ctypes handle}."""
    import ctypes

    from distributed_cluster_gpus_tpu_torch.kernels import build
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1

    os.makedirs(d, exist_ok=True)
    with open(os.path.join(build.CSRC_DIR, "event_scan.cu")) as f:
        src = instrumented_event_scan(f.read())
    with open(os.path.join(d, "event_scan.cu"), "w") as f:
        f.write(src)
    with open(os.path.join(d, "event_scan_sig.cu"), "w") as f:
        f.write('#define DCG_SIGNALS 1\n#include "event_scan.cu"\n')
    for h in os.listdir(build.CSRC_DIR):
        if h.endswith(".cuh"):
            shutil.copy(os.path.join(build.CSRC_DIR, h), d)
    procs = {name: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(d, f"lib{name}.so"), os.path.join(d, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in names}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"instrumented {name}.cu: nvcc failed\n{log}")
        lib = ctypes.CDLL(os.path.join(d, f"lib{name}.so"))
        lib.prof_read.argtypes = [ctypes.c_void_p]
        build._libs[name] = lib  # the wrapper declares its entry points
        b1._argtypes.discard(name)
        libs[name] = lib
    print(f"instrumented {build.CSRC_DIR}/event_scan.cu as {sorted(libs)}")
    return libs


def _b1_phase_chunks(lib, name, eng, params, fleet, n_steps, sac, result):
    """Three ``n_steps`` chunks of B1 through the instrumented ``lib`` from
    the run's start: ``_phase_table`` of each into ``result``."""
    import ctypes

    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.models.structs import with_lane_axis
    from distributed_cluster_gpus_tpu_torch.sim.engine import init_state

    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device="cuda"))
    print(f"{name}: {b1.THREADS} threads per lane")
    for c in range(3):
        pre = eng.workload.tables(st, n_steps)
        lib.prof_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b1.event_scan(eng, st, pre, n_steps, sac)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        eng.workload.advance_carries(st, pre)
        out = (ctypes.c_ulonglong * 32)()
        lib.prof_read(ctypes.cast(out, ctypes.c_void_p))
        result[f"{name} chunk {c}"] = _phase_table(
            f"{name} chunk {c}", list(out), n_steps, wall)


def study_b1_phases(root):
    """``--b1-phases [CHECKOUT]``: where B1's cycles go, both modes, in the
    kernel of the checkout at CHECKOUT (default: this one).  Builds the
    instrumented copy of its ``csrc/event_scan.cu`` into its
    ``smoke_out/b1_phases/``, makes its B1 wrapper launch it, and runs three
    4,096-step chunks from the run's start of ``default_policy`` at the
    CLI's paper-fleet shape, then of the chsac_af CLI's shape
    (``rl_setup``): cycles per event by phase (thread 0's clock), B3's
    call, round and window-walk counts; one JSON line at the end."""
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine

    lib = _instrumented_b1(os.path.join(root, "smoke_out", "b1_phases"),
                           ["event_scan"])["event_scan"]
    fleet, params, n = cli_params("default_policy")
    runs = [("default_policy", Engine(fleet, params, device="cuda"), fleet,
             params, n, None)]
    fleet, params, n, eng, agent = rl_setup()
    runs.append(("chsac_af", eng, fleet, params, n, agent.sac))
    result = {}
    for name, eng, fleet, params, n_steps, sac in runs:
        _b1_phase_chunks(lib, name, eng, params, fleet, n_steps, sac, result)
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), "(SM clock, max)")
    print(json.dumps({"b1_phases": result}))


#: ``--b1-phases-signals``' pairs: label -> (algo, the signal run's flags);
#: each against its signal-free twin (the same streams, no timelines).  The
#: week's rates end the CLI's 600 s within one chunk: its runs take a day
SIG_PHASE_RUNS = {
    "base/flash_crowd": ("default_policy", ("--workload", "flash_crowd")),
    "ext/carbon_cost": ("carbon_cost", ("--workload", "diurnal_flash_week",
                                        "--duration", "86400")),
    "rl/observed": ("chsac_af", ("--workload", "diurnal_flash_week",
                                 "--workload-observe", "--duration", "86400")),
}


def study_b1_phases_signals(root):
    """``--b1-phases-signals``: where B1's signal builds spend what their
    signal-free twins do not.  For each run of ``SIG_PHASE_RUNS`` at the
    CLI's paper-fleet shape (float32 clock) and its twin (the same params
    with ``signals=None``; chsac_af's with its own perturbed policy at the
    narrower observation): us per event of the uninstrumented kernels over
    chunks 2-4 of four CLI-sized chunks (CUDA events), then cycles per
    event by phase from the instrumented copies of ``event_scan.cu`` and
    its signal build over three chunks each (``--b1-phases``' counters);
    one JSON line at the end."""
    import dataclasses

    from distributed_cluster_gpus_tpu_torch.kernels import build
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.models.structs import with_lane_axis
    from distributed_cluster_gpus_tpu_torch.rl.train import make_agent
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state

    build.build(["event_scan", "event_scan_sig", "arrival_tables"])
    runs = []
    for label, (algo, flags) in SIG_PHASE_RUNS.items():
        fleet, params, n = cli_params(algo, flags)
        twin = dataclasses.replace(params, workload=dataclasses.replace(
            params.workload, signals=None))
        for side, p in (("signals", params), ("twin", twin)):
            sac = apply = None
            if algo == "chsac_af":
                agent = make_agent(fleet, p, device="cuda")
                perturb_policy(agent.sac)
                sac, apply = agent.sac, agent.policy_apply
            eng = Engine(fleet, p, device="cuda", policy_apply=apply)
            if (eng.signals is None) != (side == "twin"):
                fail(f"--b1-phases-signals {label} {side}: signals wrong")
            runs.append((f"{label} {side}", eng, fleet, p, n, sac))
    result = {"us_per_event": {}}
    for name, eng, fleet, params, n, sac in runs:
        st = with_lane_axis(init_state(params.seed, fleet, params,
                                       workload=eng.workload, device="cuda"))
        us = []
        for c in range(4):
            pre = eng.workload.tables(st, n)
            ev0 = int(st.n_events.sum())
            ms, _ = _timed_chunk(eng, st, pre, n, sac)
            eng.workload.advance_carries(st, pre)
            if c:
                us.append(ms / max(int(st.n_events.sum()) - ev0, 1) * 1e3)
        result["us_per_event"][name] = statistics.mean(us)
        print(f"{name}: {statistics.mean(us):.4f} us/event over chunks 2-4 "
              f"of {n} steps ({us})", flush=True)
    for label in SIG_PHASE_RUNS:
        u = result["us_per_event"]
        print(f"{label}: signals over twin x"
              f"{u[label + ' signals'] / u[label + ' twin']:.4f}")
    libs = _instrumented_b1(os.path.join(root, "smoke_out", "b1_phases_sig"),
                            ["event_scan", "event_scan_sig"])
    for name, eng, fleet, params, n, sac in runs:
        lib = libs["event_scan" if name.endswith("twin") else "event_scan_sig"]
        _b1_phase_chunks(lib, name, eng, params, fleet, n, sac, result)
    for label in SIG_PHASE_RUNS:
        sig = result[f"{label} signals chunk 2"]["cycles_per_event"]
        twin = result[f"{label} twin chunk 2"]["cycles_per_event"]
        print(f"{label}, chunk 2, cycles per event, signals - twin: " + ", ".join(
            f"{k} {sig[k] - twin.get(k, 0.0):+.0f}" for k in sig
            if abs(sig[k] - twin.get(k, 0.0)) >= 1.0))
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), "(SM clock, max)")
    print(json.dumps({"b1_phases_signals": result}))


AB_MODES = ("default_policy", "joint_nf", "chsac_af")
#: the RL mode at the paper fleet's widest GPU-count head, which only a
#: checkout since its widening runs: timed on the change alone
AB_WIDE_MODE = "chsac_af_g128"


def study_b1_chunk_ms(mode):
    """``--b1-chunk-ms ROOT MODE`` (the A/B's child process): B1 of the
    package at ROOT, four 4,096-step chunks from the run's start, each timed
    with CUDA events; MODE ``default_policy`` is the heuristic kernel on the
    paper fleet as the CLI builds it (``joint_nf`` likewise), ``chsac_af``
    the RL mode at the
    chsac_af CLI's shape with the seeded perturbed policy (``rl_setup``).
    One JSON line."""
    from distributed_cluster_gpus_tpu_torch.kernels import build
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.models.structs import with_lane_axis
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state

    build.build(["event_scan"])
    if mode in ("chsac_af", AB_WIDE_MODE):
        fleet, params, n, eng, agent = rl_setup(
            WIDE_B1_ARGV if mode == AB_WIDE_MODE else ())
        sac = agent.sac
    else:
        algo, flags = (EXT_RUNS[mode][:2] if mode in EXT_RUNS else (mode, ()))
        fleet, params, n = cli_params(algo, flags)
        eng, sac = Engine(fleet, params, device="cuda"), None
    st = with_lane_axis(init_state(params.seed, fleet, params,
                                   workload=eng.workload, device="cuda"))
    ms, events = [], []
    for _ in range(4):
        pre = eng.workload.tables(st, n)
        before = int(st.n_events.sum())
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        b1.event_scan(eng, st, pre, n, sac)
        b.record()
        b.synchronize()
        eng.workload.advance_carries(st, pre)
        ms.append(a.elapsed_time(b))
        events.append(int(st.n_events.sum()) - before)
    print(json.dumps({"ms": ms, "events": events, "steps": n}))


def study_b1_ext(other=None):
    """``--b1-ext [OTHER]``: B1 of this checkout at the A/B's shape (the
    paper fleet as the CLI builds it, four 4,096-step chunks from the run's
    start, each in its own process, ``--b1-chunk-ms``) for
    ``default_policy`` (the base instance) and every configuration of
    ``EXT_RUNS`` with phase (a)'s flags (the extended instance), in turns,
    twice: us per event (the mean of chunks 2-4), each against the base's;
    with OTHER (a checkout of the same configurations), each run of this
    checkout follows OTHER's and the ratio to OTHER's is given too.  One
    JSON line."""
    here = os.path.dirname(os.path.abspath(__file__))
    modes = ("default_policy",) + tuple(EXT_RUNS)
    roots = ((("other", other),) if other else ()) + (("here", here),)
    per = {(n, m): [] for n, _ in roots for m in modes}
    for _ in range(2):
        for mode in modes:
            for name, root in roots:
                r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                    "--b1-chunk-ms", root, mode], cwd=root,
                                   capture_output=True, text=True, timeout=900)
                if r.returncode != 0:
                    fail(f"B1 ext: {mode} ({root}) failed:\n{r.stderr[-2000:]}")
                d = json.loads(r.stdout.strip().splitlines()[-1])
                us = statistics.mean(d["ms"][1:]) / statistics.mean(
                    d["events"][1:]) * 1e3
                per[(name, mode)].append(us)
                print(f"{mode} {name}: chunks {[round(m, 3) for m in d['ms']]} "
                      f"ms, events {d['events']}; {us:.3f} us/event", flush=True)
    result = {}
    for name, _ in roots:
        base = statistics.mean(per[(name, "default_policy")])
        for m in modes:
            us = statistics.mean(per[(name, m)])
            row = {"us_per_event": per[(name, m)], "over_base": us / base}
            if other and name == "here":
                row["over_other"] = us / statistics.mean(per[("other", m)])
            result[f"{name}/{m}"] = row
            print(f"{name} {m}: {us:.3f} us/event, {us / base:.4f} x the base "
                  "instance's" + (f", {row['over_other']:.4f} x other's"
                                  if "over_other" in row else ""))
    print(json.dumps({"b1_ext": result}))


#: the one-hot update's B5d calls by shape for the A/B: forward (R, K, N,
#: ReLU, float32 copy with the twins' row stride), fused dX (R, N, K' of
#: each product), standalone backward (R, N, float32 row stride)
AB_FWD = [(256, 49, 256, True, 0), (256, 256, 256, True, 0),
          (256, 256, 8, False, 8), (256, 272, 256, True, 0),
          (256, 256, 32, False, 64), (16_384, 272, 256, True, 0),
          (16_384, 256, 256, True, 0), (16_384, 256, 32, False, 64)]
AB_DX = [(256, 256, (256,)), (256, 256, (32,)), (256, 256, (8, 8))]
AB_BWD = [(256, 32, 64), (256, 8, 8)]


def _b5d_routes():
    """us per call of the B5d route of the package on sys.path at each
    one-hot update shape: this checkout's fused kernels, or the parent's
    ``torch.matmul`` + epilogue kernel (``dense_epilogue``) and matmul +
    backward kernel (``dense_backward``)."""
    from distributed_cluster_gpus_tpu_torch.kernels import dense

    g = torch.Generator().manual_seed(5)
    r = lambda *sh: (torch.randn(sh, generator=g) * 0.1).to(  # noqa: E731
        torch.bfloat16).cuda()
    fused = hasattr(dense, "dense_fwd")
    out = {}
    for R, K, N, relu, ld in AB_FWD:
        x, w, b = r(R, K), r(K, N), r(N)
        o32 = None if not ld else torch.empty((R, ld), device="cuda")[:, :N]
        if fused:
            fn = lambda: dense.dense_fwd(x, w, b, relu, o32)  # noqa: E731
        else:
            fn = lambda: dense.dense_epilogue(  # noqa: E731
                torch.matmul(x, w), b, relu, o32)
        out[f"fwd {R}x{K}x{N}"] = _queued_ms(fn) * 1e3
    for R, N, kcs in AB_DX:
        ops = [t for kc in kcs for t in (r(R, kc), r(N, kc))]
        y, db = r(R, N), torch.empty(N, dtype=torch.bfloat16, device="cuda")
        if fused:
            fn = lambda: dense.dense_dx(ops[0], ops[1], y, db, *ops[2:])  # noqa: E731
        else:
            def fn(ops=ops, y=y, db=db):
                ds = [torch.matmul(a, w.t()) for a, w in zip(ops[::2], ops[1::2])]
                dense.dense_backward(ds[0], y, db, *ds[1:])
        out[f"dx {R}x{N}x" + "x".join(map(str, kcs))] = _queued_ms(fn) * 1e3
    for R, N, ld in AB_BWD:
        gf = torch.randn((R, ld), generator=g).cuda()[:, :N]
        db = torch.empty(N, dtype=torch.bfloat16, device="cuda")
        out[f"bwd {R}x{N}"] = _queued_ms(
            lambda: dense.dense_backward(gf, None, db)) * 1e3
    out.update(_fused_input_routes(r))
    return out


def _fused_input_routes(r):
    """us per call of the one-hot critic's first layer (all actions; the
    taken actions with their rows kept) and of the actor's two heads with
    their log-softmax at the update's shapes; then of B5b's target and of
    the heads' backward by the route of the package on sys.path: this
    checkout's heads_backward (one launch), or the parent's three launches
    (B5f's backward, then two B5d top-layer backwards)."""
    from distributed_cluster_gpus_tpu_torch.kernels import dense
    from distributed_cluster_gpus_tpu_torch.kernels import log_softmax as b5f
    from distributed_cluster_gpus_tpu_torch.kernels import sac_update as b5

    g = torch.Generator().manual_seed(6)
    lat = torch.randn((256, 256), generator=g).abs().cuda()
    acts = [torch.randint(0, 8, (256,), generator=g, dtype=torch.int32).cuda()
            for _ in range(2)]
    w, b = r(272, 256), r(256)
    hid, heads = r(256, 256), [(r(256, 8), r(8)) for _ in range(2)]
    masks = [(torch.rand((256, 8), generator=g) < 0.7).cuda() for _ in range(2)]
    calls = {"critic all 16384x272x256": lambda: dense.critic_first_fwd(
        lat, 8, 8, w, b),
        "critic taken 256x272x256 (rows kept)": lambda: dense.critic_first_fwd(
            lat, 8, 8, w, b, *acts, keep_rows=True),
        "actor heads 256x256x8+8": lambda: dense.actor_heads_fwd(
            hid, *heads[0], *heads[1], *masks)}
    q = torch.randn((256, 64, 2, N_Q), generator=g).cuda().permute(0, 2, 1, 3)
    ldc, lg = (t.cuda() for t in seeded_policy_logp(g, 256, 8, 8))
    t_args = (q, ldc, lg, torch.randn(256, generator=g).cuda(),
              (torch.rand((256, 4), generator=g) * 900).cuda(),
              torch.tensor([0.4, 0.0, 2.0, 0.0]).cuda(),
              torch.tensor([500.0, 1e30, 0.0, 1e30]).cuda(),
              (torch.arange(256) % 2).float().cuda(), torch.tensor(0.2).cuda(),
              0.99)
    calls["B5b target 256x64x32"] = lambda: b5.marginal_target(*t_args)
    lg_ = [torch.randn((256, 8), generator=g).cuda() for _ in range(2)]
    cg = [torch.randn((256, 8), generator=g).cuda() for _ in range(2)]
    dbs = [torch.empty(8, dtype=torch.bfloat16, device="cuda") for _ in range(2)]
    if hasattr(b5f, "heads_backward"):
        calls["heads backward 256x(8+8)"] = lambda: b5f.heads_backward(
            *lg_, *masks, *cg, *dbs)
    else:
        def heads_route():
            for d, db in zip(b5f.log_softmax2_backward(*lg_, *masks, *cg), dbs):
                dense.dense_backward(d, None, db)

        calls["heads backward 256x(8+8)"] = heads_route
    out = {}
    for name, fn in calls.items():
        out[name] = _queued_ms(fn) * 1e3
    return out


#: the forward tiles and rings ``--b5d-plans`` times: (bm, bn)
B5D_TILES = [(128, 256), (128, 128), (64, 256), (64, 128), (128, 64), (64, 64)]


def study_host_loop(here):
    """``--host-loop``: phase (q) alone, with its details in
    ``smoke_out/host_loop.json``."""
    from distributed_cluster_gpus_tpu_torch.kernels import build
    from distributed_cluster_gpus_tpu_torch.utils.native import csv_writer_lib

    t0 = time.perf_counter()
    build.build(["event_scan", "arrival_tables", "replay_ingest",
                 "quantile_huber", "marginal", "adam", "replay_sample",
                 "param_pack", "dense", "log_softmax"])
    print(f"built CUDA kernels in {time.perf_counter() - t0:.1f} s")
    csv_writer_lib()
    out_root = os.path.join(here, "smoke_out", "host_loop")
    shutil.rmtree(out_root, ignore_errors=True)
    os.makedirs(out_root)
    report = {}
    t0 = time.perf_counter()
    try:
        phase_host_loop(report, out_root)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t0
    print(f"[phase_host_loop: {report['phase_s']:.1f} s]")
    with open(os.path.join(here, "smoke_out", "host_loop.json"), "w") as f:
        json.dump(report, f, indent=1)


def study_b5d_plans():
    """``--b5d-plans``: B5d's forward at the one-hot update's 16,384-row
    layers and three 256-row ones with every tile of ``B5D_TILES`` and every
    ring of 1-4 stages (and the whole K) that fits a block's shared memory,
    launched through the C entry point with the plan given; each output
    bitwise against the plain version, device us per call (queued behind a
    spin), fastest first.  The wrapper's ``fwd_plan`` takes the fastest."""
    import ctypes

    from distributed_cluster_gpus_tpu_torch.kernels import build, dense
    from distributed_cluster_gpus_tpu_torch.rl.nets import pin_f32_accumulation

    pin_f32_accumulation()
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = build.bind("dense", "dense_fwd_launch",
                    [P, LL, P, P, P, P, LL, I, I, I, I, I, I, I, P])
    g = torch.Generator().manual_seed(3)
    out = {}
    for R, K, N, relu, ld in [s for s in AB_FWD if s[0] > 256] + [
            (256, 256, 256, True, 0), (256, 256, 8, False, 8),
            (256, 256, 2048, False, 4096)]:
        x = (torch.randn((R, K), generator=g)).to(torch.bfloat16).cuda()
        w = (torch.randn((K, N), generator=g) * K ** -0.5).to(torch.bfloat16).cuda()
        b = torch.randn(N, generator=g).to(torch.bfloat16).cuda()
        o32 = None if not ld else torch.empty((R, ld), device="cuda")[:, :N]
        want = dense.dense_fwd(x, w, b, relu, plain=True)
        kt = -(-K // 64)
        res = []
        for bm, bn in B5D_TILES:
            for st in sorted({1, 2, 3, 4, kt}):
                ring = max(st * (bm + bn) * 128, bm * (bn + 8) * 2)
                if st > kt or 1024 + ring + st * 8 + 16 + 2 * bn > dense.SMEM_MAX:
                    continue
                y = torch.empty((R, N), dtype=torch.bfloat16, device="cuda")

                def launch(y=y, plan=(bm, bn, st)):
                    rc = fn(x.data_ptr(), K, w.data_ptr(), b.data_ptr(),
                            y.data_ptr(), None if o32 is None else o32.data_ptr(),
                            0 if o32 is None else o32.stride(0), R, K, N,
                            int(relu), *plan, build.stream_of(y.device))
                    if rc != 0:
                        fail(f"b5d plans: {R}x{K}x{N} {plan}: launch failed {rc}")

                launch()
                torch.cuda.synchronize()
                if not _same_bits(y, want):
                    fail(f"b5d plans: {R}x{K}x{N} {bm}x{bn} S{st} differs from "
                         "the plain version")
                res.append((_queued_ms(launch) * 1e3, f"{bm}x{bn} S{st}"))
        res.sort()
        chosen = "{}x{} S{}".format(*dense.fwd_plan(R, K, N))
        out[f"{R}x{K}x{N}"] = {"us": dict((k, t) for t, k in res), "plan": chosen}
        print(f"{R}x{K}x{N} (plan {chosen}): " + "; ".join(
            f"{k} {t:.2f}" for t, k in res), flush=True)
    out.update(_critic_first_plans())
    print(json.dumps({"b5d_plans": out}))


#: the critic's first layer's tiles ``--b5d-plans`` times: (bm, bn)
CRITIC_TILES = [(128, 256), (128, 128), (64, 128), (128, 64), (64, 64)]


def _critic_first_plans():
    """The one-hot critic's first layer, its rows built in the kernel, at
    the update's all-actions call (16,384 rows) and taken-action call (256
    rows, the rows kept) with every tile of ``CRITIC_TILES`` and every ring
    of 1-5 stages that fits: the rows built as a ring shallower than K
    cycles, or the whole K in the ring; each output bitwise against the
    plain composition, device us per call, fastest first."""
    import ctypes

    from distributed_cluster_gpus_tpu_torch.kernels import build, dense

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = build.bind("dense", "critic_first_launch",
                    [P, P, P, P, I, I, I, I, P, P, P, I, I, I, I, P])
    g = torch.Generator().manual_seed(4)
    lat = torch.randn((256, 256), generator=g).abs().cuda()
    acts = [torch.randint(0, 8, (256,), generator=g, dtype=torch.int32).cuda()
            for _ in range(2)]
    w = (torch.randn((272, 256), generator=g) / 16).to(torch.bfloat16).cuda()
    b = torch.randn(256, generator=g).to(torch.bfloat16).cuda()
    out = {}
    for what, taken in (("all actions", False), ("taken actions", True)):
        a = acts if taken else (None, None)
        want, rows = dense.critic_first_fwd(lat, 8, 8, w, b, *a,
                                            keep_rows=taken, plain=True)
        R = want.shape[0]
        res = []
        for bm, bn in CRITIC_TILES:
            for st in range(1, 6):
                ring = max(st * (bm + bn) * 128, bm * (bn + 8) * 2)
                aux = dense.critic_aux(bm, 256, 1 if taken else 64, taken)
                if 1024 + ring + aux + st * 8 + 16 + 2 * bn > dense.SMEM_MAX:
                    continue
                y = torch.empty_like(want)
                x0 = None if rows is None else torch.empty_like(rows)

                def launch(y=y, x0=x0, plan=(bm, bn, st)):
                    rc = fn(lat.data_ptr(), *(None if t is None else t.data_ptr()
                                              for t in a),
                            None if x0 is None else x0.data_ptr(), 256, 256, 8,
                            8, w.data_ptr(), b.data_ptr(), y.data_ptr(), 256,
                            *plan, build.stream_of(y.device))
                    if rc != 0:
                        fail(f"critic plans: {what} {plan}: launch failed {rc}")

                launch()
                torch.cuda.synchronize()
                if not _same_bits(y, want) or (
                        x0 is not None and not _same_bits(x0, rows)):
                    fail(f"critic plans: {what} {bm}x{bn} S{st} differs from "
                         "the plain composition")
                res.append((_queued_ms(launch) * 1e3, f"{bm}x{bn} S{st}" + (
                    " (ring cycles)" if st < 5 else " (whole K)")))
        res.sort()
        chosen = "{}x{} S{}".format(*dense.critic_plan(R, 256, 8, 8, 256, taken))
        key = f"critic first {what} {R}x272x256"
        out[key] = {"us": dict((k, t) for t, k in res), "plan": chosen}
        print(f"{key} (plan {chosen}): " + "; ".join(
            f"{k} {t:.2f}" for t, k in res), flush=True)
    return out


def study_update_child(arch="onehot"):
    """``--update-ab-child ROOT [ARCH]`` (the A/B's child process): the
    learning update of the package at ROOT at the published shape (the
    learning CLI's agent, the ``arch`` critic, batch 256, a seeded
    200,000-row ring):
    ms per replayed update (host wall), the graph's span on the card,
    device ops and device us per update by kind from 8 profiled replays,
    B5d's route per call at each shape, then the learning CLI's events/s
    (600 s). One JSON line."""
    from distributed_cluster_gpus_tpu_torch import run_sim
    from distributed_cluster_gpus_tpu_torch.kernels import build
    from distributed_cluster_gpus_tpu_torch.rl.train import make_agent

    build.build([f[:-3] for f in os.listdir(build.CSRC_DIR) if f.endswith(".cu")])
    fleet, params, _ = learning_params(("--critic-arch", arch))
    ag = make_agent(fleet, params, device="cuda")
    ag.replay = seeded_ring(params.rl_buffer, 50, 4096, 0.35, 5)
    ag.train_steps(2, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ag.train_steps(64, 64)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 64
    span = _graph_device_ms(ag)
    _, kinds, n_ops, _, _, us_by_name = _profile_updates(
        ag, 8, ours=UPDATE_KERNELS + PARENT_KERNELS + ("dense_fwd_kernel",))
    routes = _b5d_routes()
    out = os.path.join(os.getcwd(), "smoke_out", "ab_learning")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    st = run_sim.main(learning_argv(out, arch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    shutil.rmtree(out, ignore_errors=True)
    top = sorted(us_by_name.items(), key=lambda kv: -kv[1])
    print(json.dumps({
        "ms_per_update": ms, "span_ms": span,
        "device_us_per_update": {k: v / 8 for k, v in kinds.items()},
        "launches_per_update": sum(n_ops.values()) / 8,
        "device_us_by_name": {k: v / 8 for k, v in top},
        "b5d_us_per_call": routes, "cli_events_per_s": int(st.n_events) / wall,
        "cli_wall_s": wall}))


def study_update_ab(parent, change, arch="onehot"):
    """``--update-ab PARENT [ARCH]``: the learning update (the ``arch``
    critic) and B5d's route of two checkouts, the parent and this one,
    alternating parent, change, change, parent, each in its own process
    (``--update-ab-child``); one JSON line at the end with every run and
    the means."""
    runs = {"parent": [], "change": []}
    for name, root in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--update-ab-child", root, arch], cwd=root,
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            fail(f"update A/B: {name} ({root}) failed:\n{r.stderr[-3000:]}")
        d = json.loads(r.stdout.strip().splitlines()[-1])
        runs[name].append(d)
        print(f"{name}: {d['ms_per_update']:.4f} ms per update, span "
              f"{d['span_ms']:.4f} ms, {d['launches_per_update']:.2f} device ops "
              f"per update, device us {d['device_us_per_update']}, learning CLI "
              f"{d['cli_events_per_s']:.1f} events/s; B5d us per call "
              f"{d['b5d_us_per_call']}", flush=True)
    mean = {name: {k: statistics.mean(d[k] for d in ds) for k in (
        "ms_per_update", "span_ms", "launches_per_update", "cli_events_per_s")}
        for name, ds in runs.items()}
    print(f"update A/B means: {mean}")
    print(json.dumps({"update_ab": {"arch": arch, "runs": runs, "mean": mean}}))


#: where a call of B5a and of B5b's actor term goes: copies of the kernel
#: cut short at one stage each, as (text, replacement) edits of its source
B5_LAST = "if (!__shfl_sync(rd::kFullMask, last, 0)) return;"
B5_ARRIVE = "rd::arrive_last(counter)"
B5_CUTS = {
    "quantile_huber": {
        "no batch tail": ((B5_LAST, B5_LAST[:-9] + " || B > 0) return;"),),
        "tail without its loads": ((
            "const float l0 = __ldcg(partial + k), l1 = __ldcg(partial + B + k);",
            "const float l0 = 1.0f, l1 = 2.0f;"),),
        "no arrival": ((B5_ARRIVE, "false"),),
        "launch alone": ((
            "const int b = blockIdx.x * kRows + (warp >> 1);",
            "const int b = blockIdx.x * kRows + (warp >> 1);"
            " if (b >= 0) { if (lane == 0 && b < B) partial[t * B + b] = 0.0f;"
            " return; }"),),
    },
    "marginal": {
        "no batch tail": ((B5_LAST, B5_LAST[:-9] + " || B > 0) return;"),),
        "tail without its loads": ((
            "const float v = __ldcg(partial + k);", "const float v = 1.0f;"),),
        "no arrival": ((B5_ARRIVE, "false"),),
        "phase 1 alone": ((
            "if (warp != 0) return;",
            "if (warp >= 0) { if (threadIdx.x == 0) partial[b] = s_pl[0];"
            " return; }"),),
        "launch alone": ((
            "const int b = blockIdx.x, lane = threadIdx.x & 31, warp = "
            "threadIdx.x >> 5;",
            "const int b = blockIdx.x, lane = threadIdx.x & 31, warp = "
            "threadIdx.x >> 5; if (b >= 0) { if (threadIdx.x == 0) "
            "partial[b] = 0.0f; return; }"),),
    },
}


#: the alternatives to the kept design that were measured, as edits of the
#: same kind; each is still bitwise equal to the plain version
B5_FIXED_HEADS = ("if (n_dc == 8 && n_g == 8)", "if (B < 0 && n_g == 8)")
B5_ALTERNATIVES = {
    "quantile_huber": {
        "one row a block": (("kRows = 2;", "kRows = 1;"),),
        "eight rows a block": (("kRows = 2;", "kRows = 8;"),),
        "a streamed batch tail": (("const rd::Quad s = rd::tree_regs(",
                                   "const rd::Quad s = rd::tree_stream("),),
    },
    "marginal": {
        "4-byte loads": (("const int vec = N == 32 &&",
                          "const int vec = 0 && N == 32 &&"),),
        "a streamed batch tail": (("const rd::Quad s = rd::tree_regs(",
                                   "const rd::Quad s = rd::tree_stream("),),
        "phase 2 with the heads' sizes at run time": (B5_FIXED_HEADS,),
        "phase 2 at the largest register size": (
            B5_FIXED_HEADS, ("else if (Ap <= 64 && E <= 64)",
                             "else if (B < 0 && E <= 64)"),
            ("else if (Ap <= 256 && E <= 256)", "else if (B < 0 && E <= 256)")),
    },
}


def study_b5_tails():
    """``--b5-tails``: where a call of B5a and of B5b's actor term goes, at
    the update's published shape (B = 256, N = M = 32, 8 x 8 actions, the
    one-hot layout).  Copies of this checkout's two kernels, each cut short
    at one stage (``B5_CUTS``) or changed to a measured alternative
    (``B5_ALTERNATIVES``), are built beside the whole kernel into
    ``smoke_out/b5_tails/``; the whole kernel and the alternatives are held
    bitwise against the plain version; each copy is timed (launches queued
    behind a spin, the arrival count zeroed first) in three rounds.  One
    JSON line."""
    import ctypes

    from distributed_cluster_gpus_tpu_torch.kernels import build
    from distributed_cluster_gpus_tpu_torch.rl import sac as rsac

    d = os.path.join(os.getcwd(), "smoke_out", "b5_tails")
    shutil.rmtree(d, ignore_errors=True)
    procs = {}
    for src, cuts in B5_CUTS.items():
        with open(os.path.join(build.CSRC_DIR, src + ".cu")) as f:
            text = f.read()
        for cut, edits in (("whole kernel", ()), *cuts.items(),
                           *B5_ALTERNATIVES[src].items()):
            t = text
            for a, b in edits:
                if t.count(a) != 1:
                    fail(f"--b5-tails: {src}.cu no longer holds {a!r}")
                t = t.replace(a, b)
            vd = os.path.join(d, f"{src}_{len(procs)}")
            os.makedirs(vd)
            for h in os.listdir(build.CSRC_DIR):
                if h.endswith(".cuh"):
                    shutil.copy(os.path.join(build.CSRC_DIR, h), vd)
            with open(os.path.join(vd, src + ".cu"), "w") as f:
                f.write(t)
            lib = os.path.join(vd, "lib.so")
            procs[(src, cut)] = (subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
                 os.path.join(vd, src + ".cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"--b5-tails: {key} failed to build\n{log}")
        libs[key] = ctypes.CDLL(lib)
    P, I, LL, FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    B, N, n_dc, n_g = UPDATE_B, N_Q, 8, 8
    A = n_dc * n_g
    g = torch.Generator().manual_seed(41)
    q = torch.randn((B, 2, N), generator=g).cuda()
    tgt = (torch.randn((B, N), generator=g) * 2).cuda()
    taus = ((torch.arange(N, dtype=torch.float32) + 0.5) / N).cuda()
    q_oh = torch.randn((B, A, 2, N), generator=g).cuda().permute(0, 2, 1, 3)
    ldc, lg = (t.cuda() for t in seeded_policy_logp(g, B, n_dc, n_g))
    alpha = torch.tensor(0.2).cuda()
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    outs = {"quantile_huber": [torch.empty((), device="cuda"), torch.empty_like(q)],
            "marginal": [torch.empty((), device="cuda"),
                         torch.empty(B, device="cuda"),
                         torch.empty((B, n_dc), device="cuda"),
                         torch.empty((B, n_g), device="cuda")]}
    want = {"quantile_huber": rsac.quantile_huber_loss(q, tgt, taus),
            "marginal": rsac.marginal_actor(q_oh, ldc, lg, alpha)}
    part = torch.empty(2 * B, device="cuda")

    def call(src, lib):
        if src == "quantile_huber":
            f = lib.quantile_huber_launch
            f.argtypes = [P, P, P, P, P, P, P, I, I, I, FL, FL, P]
            args = (q.data_ptr(), tgt.data_ptr(), taus.data_ptr(),
                    *(o.data_ptr() for o in outs[src]), part.data_ptr(),
                    count.data_ptr(), B, N, N, 1.0, 0.5, stream)
        else:
            f = lib.marginal_actor_launch
            f.argtypes = [P, LL, LL, LL, P, P, P, P, P, P, P, P, P, I, I, I, I, P]
            args = (q_oh.data_ptr(), *q_oh.stride()[:3], ldc.data_ptr(),
                    lg.data_ptr(), alpha.data_ptr(),
                    *(o.data_ptr() for o in outs[src]), part.data_ptr(),
                    count.data_ptr(), B, n_dc, n_g, N, stream)

        def run():
            if f(*args) != 0:
                fail(f"--b5-tails: {src} launch failed")
        return run

    runs = {key: call(key[0], lib) for key, lib in libs.items()}
    for src in B5_CUTS:
        for cut in ("whole kernel", *B5_ALTERNATIVES[src]):
            count.zero_()
            runs[(src, cut)]()
            torch.cuda.synchronize()
            if not all(_bits(k, p) for k, p in zip(outs[src], want[src])):
                fail(f"--b5-tails: {src}, {cut}: differs from its plain "
                     "version")
    us = {key: [] for key in runs}
    for _ in range(3):
        for key, run in runs.items():
            count.zero_()
            us[key].append(_queued_ms(run, what=f"{key}") * 1e3)
    result = {}
    for (src, cut), t in us.items():
        result.setdefault(src, {})[cut] = t
        print(f"{src}, {cut}: {', '.join(f'{x:.2f}' for x in t)} us per call")
    print(json.dumps({"b5_tails": result}))


#: where a call of the fused input layers goes: copies of csrc/dense.cu
#: with one part cut (timing only; a cut copy computes something else)
FUSED_INPUT_CUTS = {
    "no row builds": ((
        "#pragma unroll\n  for (int i = 0; i < 4; ++i) v[i] = critic_chunk<BM>(a, src, t, i, col0);",
        "#pragma unroll\n  for (int i = 0; i < 4; ++i) v[i] = make_uint4(col0, i, 0, 0);"),
        ("  if (kRows && a.bcast) build_atoms<BM>(aux, a, m0);", "")),
    "no latent atoms": (("  if (kRows && a.bcast) build_atoms<BM>(aux, a, m0);", ""),),
    "heads: no log-softmax": ((
        "  const int h = tid / BM, r = tid % BM, row = m0 + r;  // a warp, one head\n"
        "  if (row >= a.R) return;",
        "  const int h = tid / BM, r = tid % BM, row = m0 + r;  // a warp, one head\n"
        "  if (row >= 0) return;"),),
    "heads: no W load": (("    if (kHeads) load_heads<BM, BN>(smem, a);", ""),),
}


def study_fused_input_cuts():
    """``--fused-input-cuts``: where a call of the one-hot critic's first
    layer (every joint action, 16,384 rows; the taken actions, 256 rows
    with the rows kept) and of the actor's heads (256 rows, 8 + 8) goes, at
    the update's shapes and plans.  Copies of this checkout's
    ``csrc/dense.cu``, each with one part cut (``FUSED_INPUT_CUTS``), are
    built beside the whole kernel into ``smoke_out/fused_input_cuts/``; the
    whole kernel is held bitwise against the plain compositions; each copy
    is timed (launches queued behind a spin) in three rounds, beside B5d's
    forward alone on the prebuilt rows and the two heads' B5d launches.
    One JSON line."""
    import ctypes

    from distributed_cluster_gpus_tpu_torch.kernels import build, dense
    from distributed_cluster_gpus_tpu_torch.rl.nets import critic_input

    d = os.path.join(os.getcwd(), "smoke_out", "fused_input_cuts")
    shutil.rmtree(d, ignore_errors=True)
    with open(os.path.join(build.CSRC_DIR, "dense.cu")) as f:
        text = f.read()
    procs = {}
    for cut, edits in (("whole kernel", ()), *FUSED_INPUT_CUTS.items()):
        t = text
        for a, b in edits:
            if t.count(a) != 1:
                fail(f"--fused-input-cuts: dense.cu no longer holds {a!r}")
            t = t.replace(a, b)
        vd = os.path.join(d, str(len(procs)))
        os.makedirs(vd)
        for h in os.listdir(build.CSRC_DIR):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(build.CSRC_DIR, h), vd)
        with open(os.path.join(vd, "dense.cu"), "w") as f:
            f.write(t)
        lib = os.path.join(vd, "lib.so")
        procs[cut] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
             os.path.join(vd, "dense.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for cut, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"--fused-input-cuts: {cut} failed to build\n{log}")
        libs[cut] = ctypes.CDLL(lib)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    g = torch.Generator().manual_seed(43)
    r = lambda *sh: (torch.randn(sh, generator=g) * 0.1).to(  # noqa: E731
        torch.bfloat16).cuda()
    B, L = UPDATE_B, 256
    lat = torch.randn((B, L), generator=g).abs().cuda()
    acts = [torch.randint(0, 8, (B,), generator=g, dtype=torch.int32).cuda()
            for _ in range(2)]
    w, b = r(L + 16, 256), r(256)
    hid, heads = r(B, 256), [(r(256, 8), r(8)) for _ in range(2)]
    masks = [(torch.rand((B, 8), generator=g) < 0.7).cuda() for _ in range(2)]
    stream = torch.cuda.current_stream().cuda_stream
    cases = {"critic, every joint action": (False, B * 64),
             "critic, taken actions (rows kept)": (True, B)}
    outs = {k: (torch.empty((R, 256), dtype=torch.bfloat16, device="cuda"),
                torch.empty((R, L + 16), dtype=torch.bfloat16, device="cuda")
                if taken else None) for k, (taken, R) in cases.items()}
    h_out = [torch.empty((B, 8), device="cuda") for _ in range(4)]

    def call(name, lib):
        if name.startswith("critic"):
            taken, R = cases[name]
            f = lib.critic_first_launch
            f.argtypes = [P, P, P, P, I, I, I, I, P, P, P, I, I, I, I, P]
            a = acts if taken else (None, None)
            y, x0 = outs[name]
            plan = dense.critic_plan(R, L, 8, 8, 256, taken, True, taken)
            args = (lat.data_ptr(), *(None if t is None else t.data_ptr()
                                      for t in a),
                    None if x0 is None else x0.data_ptr(), B, L, 8, 8,
                    w.data_ptr(), b.data_ptr(), y.data_ptr(), 256, *plan, stream)
        else:
            f = lib.actor_heads_launch
            f.argtypes = [P, LL] + [P] * 10 + [I] * 7 + [P]
            args = (hid.data_ptr(), 256, heads[0][0].data_ptr(),
                    heads[0][1].data_ptr(), heads[1][0].data_ptr(),
                    heads[1][1].data_ptr(), masks[0].data_ptr(),
                    masks[1].data_ptr(), *(o.data_ptr() for o in h_out), B, 256,
                    8, 8, *dense.heads_plan(B, 256, 16), stream)

        def run():
            if f(*args) != 0:
                fail(f"--fused-input-cuts: {name} launch failed")
        return run

    names = [*cases, "actor heads"]
    runs = {(n, cut): call(n, lib) for cut, lib in libs.items() for n in names
            if not (cut.startswith("heads") and n.startswith("critic"))
            and not (n == "actor heads" and not cut.startswith("heads")
                     and cut != "whole kernel")}
    for n in names:  # the whole kernel, bitwise
        runs[(n, "whole kernel")]()
        torch.cuda.synchronize()
        if n.startswith("critic"):
            taken, R = cases[n]
            a = acts if taken else (None, None)
            want, rows = dense.critic_first_fwd(lat, 8, 8, w, b, *a,
                                                keep_rows=taken, plain=True)
            ok = _same_bits(outs[n][0], want) and (
                not taken or _same_bits(outs[n][1], rows))
        else:
            want = dense.actor_heads_fwd(hid, *heads[0], *heads[1], *masks,
                                         plain=True)  # logp_dc, logp_g, l_dc, l_g
            ok = all(_same_bits(k, p) for k, p in zip(h_out[2:] + h_out[:2], want))
        if not ok:
            fail(f"--fused-input-cuts: {n} differs from its plain composition")
    x_all, x_t = critic_input(lat, 8, 8), critic_input(lat, 8, 8, *acts)
    lo = [torch.empty((B, 8), device="cuda") for _ in range(2)]
    runs[("critic, every joint action", "B5d alone on prebuilt rows")] = \
        lambda: dense.dense_fwd(x_all, w, b, True)
    runs[("critic, taken actions (rows kept)", "B5d alone on prebuilt rows")] = \
        lambda: dense.dense_fwd(x_t, w, b, True)
    runs[("actor heads", "the two heads' B5d launches")] = lambda: [
        dense.dense_fwd(hid, k, bb, False, o) for (k, bb), o in zip(heads, lo)]
    us = {key: [] for key in runs}
    for _ in range(3):
        for key, run in runs.items():
            us[key].append(_queued_ms(run, what=f"{key}") * 1e3)
    result = {}
    for (n, cut), t in us.items():
        result.setdefault(n, {})[cut] = t
        print(f"{n}, {cut}: {', '.join(f'{x:.2f}' for x in t)} us per call")
    print(json.dumps({"fused_input_cuts": result}))


def study_b1_widths():
    """``--b1-widths``: B1 of this checkout at every block width it is built
    for (``BLOCK_WIDTHS``), both modes at the shapes of ``--b1-chunk-ms``,
    each width from the run's start over four 4,096-step chunks: us per
    event (the mean of chunks 2-4); one JSON line at the end."""
    from distributed_cluster_gpus_tpu_torch.kernels import build
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.models.structs import with_lane_axis
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state

    build.build(["event_scan"])
    fleet, params, n = cli_params("default_policy")
    runs = [("default_policy", Engine(fleet, params, device="cuda"), fleet,
             params, n, None)]
    fleet, params, n, eng, agent = rl_setup()
    runs.append(("chsac_af", eng, fleet, params, n, agent.sac))
    result = {}
    for name, eng, fleet, params, n_steps, sac in runs:
        for threads in b1.BLOCK_WIDTHS:
            st = with_lane_axis(init_state(params.seed, fleet, params,
                                           workload=eng.workload, device="cuda"))
            ms, events = [], []
            for _ in range(4):
                pre = eng.workload.tables(st, n_steps)
                before = int(st.n_events.sum())
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                b1.event_scan(eng, st, pre, n_steps, sac, threads=threads)
                b.record()
                b.synchronize()
                eng.workload.advance_carries(st, pre)
                ms.append(a.elapsed_time(b))
                events.append(int(st.n_events.sum()) - before)
            us = statistics.mean(ms[1:]) / statistics.mean(events[1:]) * 1e3
            print(f"{name} {threads} threads: chunks {[round(m, 3) for m in ms]} ms, "
                  f"{us:.3f} us/event", flush=True)
            result[f"{name}/{threads}"] = us
    print(json.dumps({"b1_widths": result}))


def study_b1_ab(parent, change):
    """``--b1-ab PARENT``: B1 of two checkouts, the parent and this one, in
    both modes (``AB_MODES``), alternating parent, change, change, parent,
    each in its own process (``--b1-chunk-ms``): the mean of chunks 2-4 per
    run, then per checkout; then the change alone at the paper fleet's
    widest GPU-count head (``AB_WIDE_MODE``, 8 x 128), twice; one JSON
    line at the end."""
    result = {}
    for mode in AB_MODES:
        per = {"parent": [], "change": []}
        for name, root in (("parent", parent), ("change", change),
                           ("change", change), ("parent", parent)):
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--b1-chunk-ms", root, mode], cwd=root,
                               capture_output=True, text=True, timeout=900)
            if r.returncode != 0:
                fail(f"B1 A/B: {mode} {name} ({root}) failed:\n{r.stderr[-2000:]}")
            d = json.loads(r.stdout.strip().splitlines()[-1])
            m = statistics.mean(d["ms"][1:])
            ev = statistics.mean(d["events"][1:])
            per[name].append(m / ev * 1e3)
            print(f"{mode} {name}: chunks {d['ms']} ms, events {d['events']}; "
                  f"{m:.3f} ms per {d['steps']}-step chunk ({m / ev * 1e3:.3f} "
                  f"us/event)", flush=True)
        p, c = (statistics.mean(per[k]) for k in ("parent", "change"))
        print(f"{mode}: parent {p:.3f} us/event, change {c:.3f} us/event, "
              f"change/parent {c / p:.4f}")
        result[mode] = {"parent_us_per_event": per["parent"],
                        "change_us_per_event": per["change"], "ratio": c / p}
    # the widened head, which the parent refuses: the change alone, twice
    wide = []
    for _ in range(2):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--b1-chunk-ms", change, AB_WIDE_MODE], cwd=change,
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            fail(f"B1 A/B: {AB_WIDE_MODE} failed:\n{r.stderr[-2000:]}")
        d = json.loads(r.stdout.strip().splitlines()[-1])
        wide.append(statistics.mean(d["ms"][1:]) / statistics.mean(
            d["events"][1:]) * 1e3)
        print(f"{AB_WIDE_MODE} change: chunks {d['ms']} ms, events "
              f"{d['events']}; {wide[-1]:.3f} us/event", flush=True)
    result[AB_WIDE_MODE] = {"change_us_per_event": wide}
    print(json.dumps({"b1_ab": result}))


#: the cells ``--cells-ab`` times: the main path's CLI runs (phases (b),
#: (i)) and the R=32 lanes at the bench shape (phase (c))
CELLS_AB_CLI = ("default_policy", "joint_nf", "chsac_af")
CELLS_AB_LANES = ("default_policy", "joint_nf")


def study_cells_child(root):
    """``--cells-child ROOT``: events/s of the cells on the package at ROOT,
    one JSON line.  Each CLI run of ``CELLS_AB_CLI`` at the main path's
    settings (wall around ``run_sim.main``, CSVs included, after a 20 s
    warm-up run of each), and the R=32 lanes of ``CELLS_AB_LANES`` at the
    bench shape (phase (c)'s 4 chunks of 512 steps, tables and scan, wall
    over all four, synchronized)."""
    sys.path.insert(0, root)
    from distributed_cluster_gpus_tpu_torch import run_sim
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_fleet
    from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
    from distributed_cluster_gpus_tpu_torch.parallel.rollout import batched_init
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine

    out_root = os.path.join(root, "smoke_out", "cells_ab")
    shutil.rmtree(out_root, ignore_errors=True)
    res = {"cli": {}, "lanes": {}}
    for algo in CELLS_AB_CLI:
        run_sim.main(cli_argv(algo, os.path.join(out_root, algo + "_warm"))
                     + ["--duration", "20"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = run_sim.main(cli_argv(algo, os.path.join(out_root, algo)))
        torch.cuda.synchronize()
        res["cli"][algo] = int(st.n_events) / (time.perf_counter() - t0)
    fleet = build_fleet()
    for algo in CELLS_AB_LANES:
        params = SimParams(**dict(BENCH_SHAPE, algo=algo))
        eng = Engine(fleet, params, device="cuda")
        st = batched_init(fleet, params, 32, workload=eng.workload,
                          device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4):
            st, _ = eng.run_chunk(st, 512, pre=eng.workload.tables(st, 512))
        torch.cuda.synchronize()
        res["lanes"][algo] = int(st.n_events.sum()) / (time.perf_counter() - t0)
    shutil.rmtree(out_root, ignore_errors=True)
    print(json.dumps(res))


def study_cells_ab(parent, change):
    """``--cells-ab PARENT``: the cells' events/s (``--cells-child``) of two
    checkouts, the parent and this one, alternating parent, change,
    change, parent, each in its own process; the mean per checkout and the
    change over the parent per cell; one JSON line at the end."""
    per = {"parent": [], "change": []}
    for name, root in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--cells-child", root], cwd=root,
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            fail(f"cells A/B: {name} ({root}) failed:\n{r.stderr[-2000:]}")
        d = json.loads(r.stdout.strip().splitlines()[-1])
        per[name].append(d)
        print(f"{name}: {json.dumps(d)}", flush=True)
    result = {}
    for kind, algos in (("cli", CELLS_AB_CLI), ("lanes", CELLS_AB_LANES)):
        for algo in algos:
            p, c = (statistics.mean(d[kind][algo] for d in per[k])
                    for k in ("parent", "change"))
            print(f"{kind} {algo}: parent {p:.1f} events/s, change {c:.1f} "
                  f"events/s, change/parent {c / p:.4f}")
            result[f"{kind}/{algo}"] = {
                "parent": [d[kind][algo] for d in per["parent"]],
                "change": [d[kind][algo] for d in per["change"]],
                "ratio": c / p}
    print(json.dumps({"cells_ab": result}))


#: the B2 A/B's shapes: the CLI's (one lane, a 4,096-step chunk) and the
#: bench's (32 lanes, 512-step chunks)
B2_AB_SHAPES = ((1, 4096), (32, 512))


#: B6a's measured alternatives to the kept design, as edits of
#: csrc/replay_ingest.cu (each still bitwise equal to the plain versions:
#: ``--b6a-only`` runs phase (h) on it)
B6A_VARIANTS = {
    "256 threads, 4 rows a warp ahead": (
        ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),
        ("constexpr int kRowsAhead = 2;", "constexpr int kRowsAhead = 4;")),
    "256 threads, 2 rows a warp ahead": (
        ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),),
    "512 threads, 2 units a lane a pass": (
        ("constexpr int kPass = 4;", "constexpr int kPass = 2;"),),
    "512 threads, 64-row tiles": (
        ("if (groups < 1) groups = 1;", "if (groups < 2) groups = 2;"),),
}


def study_b6a_only(root):
    """``--b6a-only ROOT``: phase (h) alone on the package at ROOT."""
    sys.path.insert(0, root)
    report = {}
    phase_b6a(report)
    print(json.dumps({k: v for k, v in report["b6a"].items()
                      if k.endswith("ms") or k == "ms_by_rows"}))


def study_b6a_variants(here):
    """``--b6a-variants``: phase (h)'s B6a timings of this checkout and of
    each ``B6A_VARIANTS`` copy (the package copied into
    ``smoke_out/b6a_variants/<i>/`` with the edit, built there), in turns
    (this checkout, every variant, every variant again, this checkout),
    each run its own process (``--b6a-only``); one JSON line at the end."""
    base = os.path.join(here, "smoke_out", "b6a_variants")
    shutil.rmtree(base, ignore_errors=True)
    pkg = "distributed_cluster_gpus_tpu_torch"
    roots = {"kept": here}
    for i, (name, edits) in enumerate(B6A_VARIANTS.items()):
        root = os.path.join(base, str(i))
        shutil.copytree(os.path.join(here, pkg), os.path.join(root, pkg),
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = os.path.join(root, pkg, "csrc", "replay_ingest.cu")
        with open(src) as f:
            t = f.read()
        for a, b in edits:
            if t.count(a) != 1:
                fail(f"B6a variant {name!r}: anchor {a!r} found {t.count(a)} "
                     "times")
            t = t.replace(a, b)
        with open(src, "w") as f:
            f.write(t)
        roots[name] = root
    order = ["kept", *B6A_VARIANTS, *reversed(list(B6A_VARIANTS)), "kept"]
    runs = {name: [] for name in roots}
    for name in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--b6a-only", roots[name]], cwd=here,
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            fail(f"B6a variant {name!r} failed:\n{r.stderr[-3000:]}")
        d = json.loads(r.stdout.strip().splitlines()[-1])
        runs[name].append(d)
        print(f"{name}: 4,096 rows {d['ms'] * 1e3:.2f} us, scatter "
              f"{d['scatter_ms'] * 1e3:.2f} us, 1 row "
              f"{d['ms_by_rows']['1'] * 1e3:.2f} us, 16,384 rows "
              f"{d['ms_by_rows']['16384'] * 1e3:.2f} us", flush=True)
    print(json.dumps({"b6a_variants": runs}))


def study_b2_ms():
    """``--b2-ms ROOT`` (the A/B's child process): B2 of the package at ROOT
    at ``B2_AB_SHAPES`` on the paper fleet as the CLI builds it, ms per
    call: device time (50 calls queued back to back behind a spin, the
    median of 5 runs) and the wrapper's time per call.  One JSON line."""
    from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
    from distributed_cluster_gpus_tpu_torch.kernels import build
    from distributed_cluster_gpus_tpu_torch.parallel.rollout import batched_init
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine

    build.build(["arrival_tables"])
    fleet, params, _ = cli_params("default_policy")
    eng = Engine(fleet, params, device="cuda")
    wl = eng.workload
    out = {}
    for R, n in B2_AB_SHAPES:
        st = batched_init(fleet, params, R, workload=wl, device="cuda")
        S = wl.n_streams
        args = (st.arr_key, st.arr_count.reshape(R, S).contiguous(),
                st.next_arrival.reshape(R, S).contiguous(),
                st.arr_cum.reshape(R, S).contiguous(),
                st.arr_epoch.reshape(R, S).contiguous(), wl.family_t,
                wl.sparams)
        if R == 1:  # the single-lane call the CLI makes
            args = tuple(a[0] if i < 5 else a for i, a in enumerate(args))
        out[f"R{R}_n{n}"], _ = device_ms(
            lambda: b2.arrival_tables(*args, n), "_kernel", reps=50)
        out[f"R{R}_n{n}_kernel_us"] = dict(KERNEL_US["_kernel"])
        out[f"R{R}_n{n}_call"] = time_cuda(
            lambda: b2.arrival_tables(*args, n), reps=50)
    print(json.dumps(out))


def study_b2_ab(parent, change):
    """``--b2-ab PARENT``: B2 of two checkouts, alternating parent, change,
    change, parent, each in its own process (``--b2-ms``): ms per call at
    each of ``B2_AB_SHAPES``; one JSON line at the end."""
    runs = {"parent": [], "change": []}
    for name, root in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--b2-ms", root], cwd=root, capture_output=True,
                           text=True, timeout=600)
        if r.returncode != 0:
            fail(f"B2 A/B: {name} ({root}) failed:\n{r.stderr[-2000:]}")
        d = json.loads(r.stdout.strip().splitlines()[-1])
        runs[name].append(d)
        print(f"B2 {name}: {d}", flush=True)
    print(json.dumps({"b2_ab": runs}))


# ---------------------------------------------------------------- (r) workload

#: phase (r)'s JSON spec on the paper fleet: every new B2 family on ingresses
#: 0 and 1 (a replayed trace with sizes, a periodic rate timeline with a
#: zero-rate bin; a finite one, thinning at amp 2), Poisson elsewhere, and a
#: price and carbon timeline with a price-0 bin.  The thinning stream's
#: silent third of a period (20 s at 0.5 arrivals/s) takes ~10 candidates
#: to cross, inside the plain replay's first block of 32
WORKLOAD_BIN_S = 600.0
WORKLOAD_TRACE_N = 20000


def workload_doc(n_ing=8, n_dc=8):
    """Phase (r)'s workload document (``workload_from_dict``)."""
    import numpy as np

    g = np.random.RandomState(18)
    times = np.cumsum(g.exponential(1 / 25.0, WORKLOAD_TRACE_N))
    poisson = ({"kind": "poisson", "rate": 4.0}, {"kind": "poisson", "rate": 0.05})
    streams = [
        {"ingress": 0,
         "inference": {"kind": "trace", "times": times.round(4).tolist(),
                       "sizes": g.uniform(1.0, 60.0, WORKLOAD_TRACE_N)
                       .round(3).tolist()},
         "training": {"kind": "rate_timeline", "rates": [0.2, 0.0, 0.5, 0.1],
                      "bin_s": WORKLOAD_BIN_S, "periodic": True}},
        {"ingress": 1,
         "inference": {"kind": "rate_timeline", "rates": [6.0, 0.0, 20.0, 3.0],
                       "bin_s": WORKLOAD_BIN_S, "periodic": False},
         "training": {"kind": "sinusoid", "rate": 0.5, "amp": 2.0,
                      "period": 20.0, "phase_s": 3.0}}]
    streams += [{"ingress": i, "inference": poisson[0], "training": poisson[1]}
                for i in range(2, n_ing)]
    carbon = (g.uniform(0, 600, (6, n_dc)) * (g.random((6, n_dc)) > 0.2))
    return {"name": "smoke_families", "streams": streams,
            "signals": {"price": [0.12, 0.0, 0.31, 0.18, 0.09],
                        "carbon": carbon.round(1).tolist(),
                        "bin_s": 300.0, "periodic": True}}


#: B2's per-family timing calls: (label, family code's name, the stream of
#: workload_doc the family's streams copy)
B2_FAMILIES = (("trace", "FAM_TRACE", (0, "inference")),
               ("rate_timeline", "FAM_RATE_TL", (1, "inference")),
               ("thinning", "FAM_THIN", (1, "training")))
#: the JAX package's functions the new families replace
B2_FAMILY_SITES = {"trace": "workload/compiler.py:322",
                   "rate_timeline": "workload/compiler.py:410",
                   "thinning": "workload/compiler.py:386"}
#: phase (r)'s CLI runs: label -> argv past the output directory
WORKLOAD_CLIS = {
    "flash_eco": ("--workload", "flash_crowd", "--algo", "eco_route",
                  "--duration", "3600"),
    "week_carbon": ("--workload", "diurnal_flash_week", "--algo",
                    "carbon_cost", "--duration", "604800"),
    "day_rl": ("--workload", "diurnal_flash_week", "--workload-observe",
               "--algo", "chsac_af", "--duration", "86400"),
    "spec_default": ("--workload", "SPEC", "--algo", "default_policy",
                     "--duration", "1800"),
}
#: B1's signal instances in phase (r): label -> (algo, workload, extra CLI
#: flags, start time or None)
SIG_B1_CASES = {
    "base/flash_crowd": ("default_policy", "flash_crowd", (), None),
    "ext/carbon_cost": ("carbon_cost", "diurnal_flash_week", (), None),
    "ext/eco_route": ("eco_route", "diurnal_flash_week",
                      ("--eco-objective", "carbon"), None),
    "ext/weighted": ("default_policy", "diurnal_flash_week",
                     ("--router-weights", ROUTER_WEIGHTS), None),
    "rl/observed": ("chsac_af", "diurnal_flash_week", ("--workload-observe",),
                    None),
    "f64/eco_route": ("eco_route", "legacy_signals",
                      ("--eco-objective", "cost", "--inf-mode", "poisson",
                       "--duration", "604800"), 6.0e5),
}
SIG_B1_STEPS = 512
#: the entries of B2's per-family calls (the thinning family's plain version
#: replays every candidate with a host read: 1,024 keeps it to seconds)
B2_FAMILY_N = 1024
#: B2's mixed configurations (lanes, entries): the CLI's chunk and the
#: bench's 32 lanes of 512
B2_WORKLOAD_SHAPES = ((1, 4096), (32, 512))


def _b2_args(wl, st, lanes=()):
    S = wl.n_streams
    shape = lanes + (S,)
    return (st.arr_key, st.arr_count.reshape(shape).contiguous(),
            st.next_arrival.reshape(shape).contiguous(),
            st.arr_cum.reshape(shape).contiguous(),
            st.arr_epoch.reshape(shape).contiguous(), wl.family_t, wl.sparams)


def _b2_work(b2, wl, out, n, R):
    """(bytes, ops) of one B2 call: the outputs written once, the inputs and
    the packed constants read once; per entry the key chains and samplers
    of every drawing stream, a timeline's search (log2 T + a few ops), and
    for a thinning stream the candidates its entries needed (lam_max times
    the span its entries cover, 3 threefry blocks, an Exp, a uniform and
    the sinusoid each)."""
    import math

    fams = wl.family_t.tolist()
    S = len(fams)
    c = wl.consts(out["tnext"].dtype)
    tb = out["tnext"].element_size()
    cbytes = 0 if c is None else sum(x.numel() * x.element_size()
                                     for x in (c.cbuf, c.sbuf, c.meta))
    bytes_moved = R * S * (8 + 4 + 3 * tb) + cbytes + R * S * n * (4 + 2 * tb)
    ops = 0
    tn = out["tnext"].reshape(R, S, n)
    for s, f in enumerate(fams):
        if f == b2.FAM_OFF:
            continue
        ops += R * n * (BLOCKS_PER_ENTRY * THREEFRY_OPS + SAMPLER_OPS)
        if f == b2.FAM_RATE_TL:
            T = int(c.meta[s, 1])
            ops += R * n * (2 * int(math.log2(T + 1) + 1) + 12)
        if f == b2.FAM_THIN:
            rate, amp = (float(x) for x in wl.sparams[s, :2])
            lam_max = rate * (1.0 + abs(amp))
            for r in range(R):
                row = tn[r, s]
                fin = row[torch.isfinite(row)]
                span = float(fin[-1] - fin[0]) if fin.numel() > 1 else 0.0
                cands = lam_max * span + n
                ops += int(cands * (3 * THREEFRY_OPS + SAMPLER_OPS + 40))
    return bytes_moved, ops


def _b2_same(out, ref, where):
    for k in ref:
        a, b = out[k], ref[k]
        if a.dtype == torch.float64:
            a, b = a.view(torch.int64), b.view(torch.int64)
        if not _same_bits(a, b):
            fail(f"{where}: {k} differs from the plain version")


def _b2_carry(wl, st, out, used):
    """The engine's carry over ``used`` consumed entries: cursors, clocks
    (the last consumed entry) and the cumulative folds."""
    c0 = st.arr_count.reshape(out["tnext"].shape[:-1]).clone()
    st.arr_count += used
    st.next_arrival.copy_(out["tnext"][..., used - 1].reshape(st.next_arrival.shape))
    wl.advance_carries(st, dict(out, c0=c0))


def phase_workload_b2(report):
    """(r, B2) the new families against the plain version, bitwise."""
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_fleet
    from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
    from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
    from distributed_cluster_gpus_tpu_torch.parallel.rollout import batched_init
    from distributed_cluster_gpus_tpu_torch.sim.engine import init_state
    from distributed_cluster_gpus_tpu_torch.workload import workload_from_dict
    from distributed_cluster_gpus_tpu_torch.workload.compiler import (
        compile_workload)

    fleet = build_fleet()
    doc = workload_doc(fleet.n_ing, fleet.n_dc)
    rec = {"configs": {}, "families": {}}
    for td in ("float32", "float64"):
        spec = workload_from_dict(doc, n_ing=fleet.n_ing)
        params = SimParams(workload=spec, time_dtype=td, job_cap=512,
                           queue_cap=1024, seed=123)
        wl = compile_workload(fleet, params, "cuda")
        fams = wl.family_t.tolist()
        for name in ("FAM_TRACE", "FAM_RATE_TL", "FAM_THIN"):
            if getattr(b2, name) not in fams:
                fail(f"B2 phase (r): the workload has no {name} stream")
        for R, n in B2_WORKLOAD_SHAPES:
            where = f"B2 families {td} R={R} n={n}"
            st = (init_state(params.seed, fleet, params, workload=wl,
                             device="cuda") if R == 1 else
                  batched_init(fleet, params, R, workload=wl, device="cuda"))
            lanes = () if R == 1 else (R,)
            for chunk in range(2):
                args = _b2_args(wl, st, lanes)
                c = wl.consts(st.t.dtype)
                out = b2.arrival_tables(*args, n, with_aux=True, consts=c)
                t0 = time.perf_counter()
                ref = b2.arrival_tables_reference(*args, n, with_aux=True,
                                                  consts=c)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                _b2_same(out, ref, f"{where} chunk {chunk}")
                if chunk == 1:
                    ms = _queued_ms(lambda: b2.arrival_tables(*args, n, consts=c),
                                    reps=10, runs=3, what=where)
                    by, ops = _b2_work(b2, wl, out, n, R)
                    bms, bby = bound(by, ops)
                    rec["configs"][f"{td}/R{R}/n{n}"] = {
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                        "bound_by": bby, "bytes": by, "ops": ops}
                    print(f"{where}: bitwise over 2 chunks; kernel {ms:.4f} ms, "
                          f"plain {plain_ms:.1f} ms, bound {bms:.5f} ms ({bby})")
                _b2_carry(wl, st, out, n // 2 + 1)
    # each family alone on every stream (S = 16, R = 1, n = B2_FAMILY_N,
    # float32): its own kernel time, plain time and bound
    for label, fam_name, (ing, jt) in B2_FAMILIES:
        src = doc["streams"][ing][jt]
        fdoc = {"name": label, "streams": [
            {"ingress": i, "inference": src, "training": src}
            for i in range(fleet.n_ing)]}
        params = SimParams(workload=workload_from_dict(fdoc, n_ing=fleet.n_ing),
                           job_cap=512, queue_cap=1024, seed=123)
        wl = compile_workload(fleet, params, "cuda")
        st = init_state(params.seed, fleet, params, workload=wl, device="cuda")
        args, c, n = _b2_args(wl, st), wl.consts(torch.float32), B2_FAMILY_N
        out = b2.arrival_tables(*args, n, with_aux=True, consts=c)
        t0 = time.perf_counter()
        ref = b2.arrival_tables_reference(*args, n, with_aux=True, consts=c)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        _b2_same(out, ref, f"B2 {label} alone")
        ms = _queued_ms(lambda: b2.arrival_tables(*args, n, consts=c), reps=10,
                        runs=3, what=f"B2 {label}")
        by, ops = _b2_work(b2, wl, out, n, 1)
        bms, bby = bound(by, ops)
        rec["families"][label] = {"ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": bms, "bound_by": bby,
                                  "bytes": by, "ops": ops, "max_abs_err": 0.0}
        print(f"B2 {label} alone (S = 16, n = {n:,}, float32): bitwise; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bms:.5f} ms ({bby})")
    report["workload_b2"] = rec


def _signal_free_twin_us(fleet, params, sac, t_start):
    """B1's us per event of the same run without its signal timelines (the
    signal-free build, the same streams), over its second 512-step chunk
    (kernel only); chsac_af with its own perturbed policy at the narrower
    observation."""
    import dataclasses

    from distributed_cluster_gpus_tpu_torch.models.structs import with_lane_axis
    from distributed_cluster_gpus_tpu_torch.rl.train import make_agent
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state

    twin = dataclasses.replace(params, workload=dataclasses.replace(
        params.workload, signals=None))
    apply = None
    if twin.algo == "chsac_af":
        agent = make_agent(fleet, twin, device="cuda")
        perturb_policy(agent.sac)
        sac, apply = agent.sac, agent.policy_apply
    eng = Engine(fleet, twin, device="cuda", policy_apply=apply)
    st = with_lane_axis(init_state(twin.seed, fleet, twin,
                                   workload=eng.workload, device="cuda"))
    if t_start is not None:
        bridged(st, t_start, twin.log_interval)
    for _ in range(2):
        pre = eng.workload.tables(st, SIG_B1_STEPS)
        ev0 = int(st.n_events.sum())
        ms, _ = _timed_chunk(eng, st, pre, SIG_B1_STEPS, sac)
        eng.workload.advance_carries(st, pre)
    return ms / max(int(st.n_events.sum()) - ev0, 1) * 1e3


def phase_workload_b1(report):
    """(r, B1) the signal instances against the plain step, bitwise, two
    512-event chunks each at the CLI's paper-fleet shape."""
    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1
    from distributed_cluster_gpus_tpu_torch.models.structs import (
        clone_state, with_lane_axis)
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state

    rec = {}
    for label, (algo, wl_name, extra, t_start) in SIG_B1_CASES.items():
        flags = ("--workload", wl_name) + tuple(extra)
        if algo == "chsac_af":
            fleet, params, _, eng, agent = rl_setup(flags)
            sac = agent.sac
        else:
            fleet, params, _ = cli_params(algo, flags)
            eng, sac = Engine(fleet, params, device="cuda"), None
        if eng.signals is None:
            fail(f"B1 signals {label}: the run has no signal timelines")
        st = with_lane_axis(init_state(params.seed, fleet, params,
                                       workload=eng.workload, device="cuda"))
        if t_start is not None:
            bridged(st, t_start, params.log_interval)
        other = clone_state(st)
        before_sig = b1.event_scan.sig_launches
        for c in range(2):
            pre = eng.workload.tables(st, SIG_B1_STEPS)
            before = clone_state(st)
            k_ms, em_k = _timed_chunk(eng, st, pre, SIG_B1_STEPS, sac)
            t0 = time.perf_counter()
            em_r, _ = b1.event_scan_reference(eng, other, pre, SIG_B1_STEPS, sac)
            torch.cuda.synchronize()
            p_ms = (time.perf_counter() - t0) * 1e3
            em_diff(em_k, em_r, f"B1 signals {label} chunk {c}")
            eng.workload.advance_carries(st, pre)
            eng.workload.advance_carries(other, pre)
            bad = bridge.tree_mismatches(bridge.state_to_numpy(other),
                                         bridge.state_to_numpy(st))
            if bad:
                fail(f"B1 signals {label} chunk {c}: state differs from the "
                     f"plain step at {bad[:5]}")
        if b1.event_scan.sig_launches != before_sig + 2:
            fail(f"B1 signals {label}: {b1.event_scan.sig_launches - before_sig} "
                 "signal launches, 2 expected")
        twin_us = _signal_free_twin_us(fleet, params, sac, t_start)
        by, ops, counts = b1_work(eng, before, st, pre, em_k, SIG_B1_STEPS)
        n_log, n_dc = counts["log_ticks"], fleet.n_dc
        sg = eng.signals
        by += (8 * n_log * n_dc + sg.price.numel() * 4 + sg.carbon.numel() * 4
               + 2 * 2 * n_dc * 4)  # the two columns, the timelines, the sums
        ops += counts["events"] * 4 * n_dc  # the accrual's two products a DC
        bms, bby = bound(by, ops)
        ev = counts["events"]
        rec[label] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bms,
                      "bound_by": bby, "events": ev,
                      "us_per_event": k_ms / max(ev, 1) * 1e3,
                      "twin_us_per_event": twin_us,
                      "x64": params.x64, "max_abs_err": 0.0,
                      "cost_usd": float(st.signals.cost_usd.sum()),
                      "carbon_g": float(st.signals.carbon_g.sum())}
        print(f"B1 signals {label} ({algo}, --workload {wl_name}"
              f"{', from t = %.0f s' % t_start if t_start else ''}"
              f"{', float64' if params.x64 else ''}): 2 x {SIG_B1_STEPS} steps "
              f"bitwise (every leaf, signals.cost_usd and carbon_g included); "
              f"second chunk {ev} events, kernel {k_ms:.3f} ms "
              f"({rec[label]['us_per_event']:.2f} us/event; the signal-free "
              f"twin {twin_us:.2f}, x{rec[label]['us_per_event'] / twin_us:.3f}), "
              f"plain {p_ms:.0f} ms, bound {bms:.6f} ms ({bby})")
    report["workload_b1"] = rec


def phase_workload_cli(report, out_root):
    """(r, CLIs) the workload CLIs: events/s, B1's device time, the busy
    share, the energy cost and carbon; every kernel of each path launched."""
    from distributed_cluster_gpus_tpu_torch import run_sim
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1

    spec_path = os.path.join(out_root, "smoke_families.json")
    with open(spec_path, "w") as f:
        json.dump(workload_doc(), f)
    rec = {}
    for label, flags in WORKLOAD_CLIS.items():
        flags = tuple(spec_path if x == "SPEC" else x for x in flags)
        out = os.path.join(out_root, f"workload_{label}")
        argv = ["--out", out, "--device", "cuda", "--quiet", *flags]
        gc_cuda()
        read = _zero_launches()
        b1.event_scan.sig_launches = b1.event_scan.x64_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with B1Tally() as tally, ChunkSpans() as spans:
            st = run_sim.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read()
        launches["sig"] = b1.event_scan.sig_launches
        launches["x64"] = b1.event_scan.x64_launches
        if launches["event_scan"] == 0 or launches["arrival_tables"] == 0:
            fail(f"workload CLI {label}: B1 or B2 never launched {launches}")
        if launches["sig"] != launches["event_scan"]:
            fail(f"workload CLI {label}: {launches['sig']} of "
                 f"{launches['event_scan']} B1 launches took the signal build")
        if "--algo" in flags and flags[flags.index("--algo") + 1] == "chsac_af":
            if launches["rl"] == 0 or launches["replay_ingest"] == 0 or \
                    launches["quantile_huber"] == 0:
                fail(f"workload CLI {label}: RL mode, B6a or the update never "
                     f"ran {launches}")
        with open(os.path.join(out, "cluster_log.csv")) as f:
            header = f.readline().strip()
        if not header.endswith("price_usd_kwh,carbon_g_kwh"):
            fail(f"workload CLI {label}: cluster_log.csv header {header!r}")
        from distributed_cluster_gpus_tpu_torch.evaluation import signal_metrics

        sm = signal_metrics(st)
        events = int(st.n_events)
        r = {"events": events, "wall_s": wall, "events_per_s": events / wall,
             "b1_ms": tally.ms(), "busy_share": spans.ms() / (wall * 1e3),
             "time_dtype": str(st.t.dtype), "launches": launches, **sm}
        if not all(map(lambda v: v == v and abs(v) < 1e30, sm.values())) or \
                not sm.get("energy_cost_usd", 0) > 0:
            fail(f"workload CLI {label}: signal totals {sm}")
        rec[label] = r
        print(f"workload CLI {label} ({' '.join(flags)}): {events} events in "
              f"{wall:.2f} s, {r['events_per_s']:.1f} events/s; B1 "
              f"{r['b1_ms']:.1f} ms device; busy share {r['busy_share']:.3f}; "
              f"energy_cost_usd {sm['energy_cost_usd']:.4f}, carbon_kg "
              f"{sm['carbon_kg']:.4f}; clock {r['time_dtype']}; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    report["workload_cli"] = rec
    return rec


def phase_workload_agent(report):
    """(r, A9) the agent's host calls on the card: ``select_action`` equal
    to the plain policy's action for the same key (B4's device code through
    ``rl_tail_batch``); ``train_step`` with a finite energy budget and a
    power-cap constraint on the kernels against the plain path's update
    from the same state and sample, within the parity bounds."""
    import dataclasses

    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.ops import prng
    from distributed_cluster_gpus_tpu_torch.rl.sac import sac_train_step

    flags = ("--workload", "diurnal_flash_week", "--workload-observe",
             "--energy_budget_j", "300", "--power-cap-constraint", "300",
             "--rl-warmup", "100")
    fleet, params, _, eng, agent = rl_setup(flags)
    n_dc, n_g, obs_dim = fleet.n_dc, params.max_gpus_per_job, params.obs_dim(8)
    obs, m_dc, m_g, _ = seeded_decisions(16, obs_dim, n_dc, n_g, seed=31)
    for i in range(obs.shape[0]):
        k = prng.split(agent.key, 2)[1]
        got = agent.select_action(obs[i], m_dc[i], m_g[i], program=eng)
        a_dc, a_g = agent.policy_apply(agent.sac, obs[i].cuda(), m_dc[i].cuda(),
                                       m_g[i].cuda(), k.cuda())
        if got != {"dc": int(a_dc), "g": int(a_g)}:
            fail(f"select_action row {i}: {got} against the plain policy's "
                 f"({int(a_dc)}, {int(a_g)})")
    cons = [c.target for c in agent.cfg.constraints]
    if cons[1] != 300.0 or cons[3] != 300.0:
        fail(f"train_step: the constraints' targets are {cons}")
    ring = seeded_ring(8192, 2, 2048, 0.6, 32, obs_dim=obs_dim, n_dc=n_dc,
                       n_g=n_g)
    agents = [agent]
    from distributed_cluster_gpus_tpu_torch.rl.train import make_agent

    agents.append(make_agent(fleet, params, device="cuda"))
    agents[1].sac = bridge.sac_from_numpy(agents[0].cfg, bridge.sac_to_numpy(
        agents[0].cfg, agents[0].sac), device="cuda")
    agents[1].key = agents[0].key.clone()
    for ag in agents:
        ag.replay = ring
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        k = prng.split(agents[1].key, 2)[1]
        mk = agents[0].train_step()
        sac_train_step(agents[1].cfg, agents[1].sac, ring, k.cuda(), plain=True)
        mp = {n: v.clone() for n, v in agents[1].sac.metrics.items()}
    finally:
        torch.use_deterministic_algorithms(False)
    if mk is None:
        fail("train_step: not warmed up on a filled ring")
    cfg = agents[0].cfg
    e_tree = bridge.sac_to_numpy(cfg, agents[0].sac)
    p_tree = bridge.sac_to_numpy(cfg, agents[1].sac)
    far = bridge.sac_far_apart(cfg, p_tree, e_tree, 1, (mp, mk))
    if far:
        fail(f"train_step with the constraints: the plain path lies beyond "
             f"the parity bounds at {far[:5]}")
    lam = agents[0].sac.cmdp.lam.tolist()
    print(f"A9 on the card: select_action equal to the plain policy on 16 "
          f"seeded decisions (obs_dim {obs_dim}); train_step with "
          f"energy_budget_j 300 and power_cap_constraint 300 within the parity "
          f"bounds of the plain path; lambda {lam}")
    report["workload_agent"] = {"lambda": lam, "obs_dim": obs_dim}


def workload_entries(report, runs, entry):
    """Phase (r)'s kernel-line entries: B2's three new families (launches:
    B2's in the workload CLI runs whose workload has the family) and B1's
    signal instances by clock (launches: the signal builds' in those runs;
    ms, plain_ms and bound_ms from the same chunk)."""
    fam_runs = {"trace": ("spec_default",), "thinning": ("spec_default",),
                "rate_timeline": tuple(WORKLOAD_CLIS)}
    out = []
    fams = report["workload_b2"]["families"]
    for label, _, _ in B2_FAMILIES:
        out.append(dict(entry(f"arrival_tables_{label}", "arrival_tables.cu",
                              B2_FAMILY_SITES[label],
                              sum(runs[r]["launches"]["arrival_tables"]
                                  for r in fam_runs[label]),
                              fams[label], None),
                        configs={k: v for k, v in
                                 report["workload_b2"]["configs"].items()}))
    b1r = report["workload_b1"]
    for name, src, x64 in (("event_scan_signals", "event_scan_sig.cu", False),
                           ("event_scan_signals_f64", "event_scan_sig64.cu",
                            True)):
        labels = [k for k, v in b1r.items() if v["x64"] == x64]
        main = b1r[labels[0]]
        launches = sum(r["launches"]["sig"] for r in runs.values()
                       if (r["time_dtype"] == "torch.float64") == x64)
        out.append(dict(entry(name, src, "sim/engine.py:725", launches, main,
                              None),
                        instances={k: {f: b1r[k][f] for f in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "us_per_event")} for k in labels}))
    return out


def study_workload(here):
    """``--workload``: phase (r) alone, after building what it runs."""
    from distributed_cluster_gpus_tpu_torch.kernels import build
    from distributed_cluster_gpus_tpu_torch.utils.native import csv_writer_lib

    t0 = time.perf_counter()
    build.build(["event_scan", "event_scan64", "event_scan_sig",
                 "event_scan_sig64", "arrival_tables", "replay_ingest",
                 "quantile_huber", "marginal", "adam", "replay_sample",
                 "param_pack", "dense", "log_softmax"])
    csv_writer_lib()
    print(f"built the phase's kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in build.ptxas_reports.items():
        print(f"[ptxas {name}] " + " | ".join(
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line))
    report = {"card": card_line()}
    out_root = os.path.join(here, "smoke_out", "workload")
    shutil.rmtree(out_root, ignore_errors=True)
    os.makedirs(out_root)
    try:
        phase_workload(report, out_root)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    print(f"[phase_workload: {report['workload_s']:.1f} s]")
    with open(os.path.join(here, "smoke_out", "workload.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in ("workload_b2", "workload_b1")}))


def phase_workload(report, out_root):
    """(r) the workload layer: B2's new families, B1's signal instances, the
    workload CLIs and the agent's host calls."""
    t0 = time.perf_counter()
    split = report["workload_phase_s"] = {}
    for fn, args in ((phase_workload_b2, ()), (phase_workload_b1, ()),
                     (phase_workload_cli, (out_root,)),
                     (phase_workload_agent, ())):
        t = time.perf_counter()
        out = fn(report, *args)
        split[fn.__name__] = time.perf_counter() - t
        print(f"[{fn.__name__}: {split[fn.__name__]:.1f} s]", flush=True)
        if fn is phase_workload_cli:
            launches = out
    report["workload_s"] = time.perf_counter() - t0
    return launches


def main():
    # cuBLAS's deterministic mode (phase (k) compares two paths' matmuls)
    # needs its workspace fixed before the first product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs an NVIDIA GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "distributed_cluster_gpus_tpu_torch")):
        fail("run from the repository root: the port's package is not beside "
             "this script")
    sys.path.insert(0, here)
    args = sys.argv[1:]
    if args:
        if args[0] == "--b1-phases" and len(args) <= 2:
            root = os.path.abspath(args[1]) if len(args) == 2 else here
            sys.path.insert(0, root)
            print(card_line())
            return study_b1_phases(root)
        if args == ["--b1-phases-signals"]:
            print(card_line())
            return study_b1_phases_signals(here)
        if args == ["--b1-widths"]:
            print(card_line())
            return study_b1_widths()
        if len(args) == 2 and args[0] == "--b1-ab":
            print(card_line())
            return study_b1_ab(os.path.abspath(args[1]), here)
        if len(args) == 2 and args[0] == "--cells-ab":
            print(card_line())
            return study_cells_ab(os.path.abspath(args[1]), here)
        if len(args) == 2 and args[0] == "--cells-child":
            return study_cells_child(os.path.abspath(args[1]))
        if len(args) == 2 and args[0] == "--b2-ab":
            print(card_line())
            return study_b2_ab(os.path.abspath(args[1]), here)
        if len(args) == 2 and args[0] == "--b2-ms":
            sys.path.insert(0, os.path.abspath(args[1]))
            return study_b2_ms()
        if args[0] == "--b1-ext" and len(args) <= 2:
            print(card_line())
            return study_b1_ext(*(os.path.abspath(x) for x in args[1:]))
        if len(args) == 3 and args[0] == "--b1-chunk-ms" and args[2] in (
                *AB_MODES, AB_WIDE_MODE, *EXT_RUNS):
            sys.path.insert(0, os.path.abspath(args[1]))
            return study_b1_chunk_ms(args[2])
        if len(args) == 2 and args[0] == "--b6a-only":
            return study_b6a_only(os.path.abspath(args[1]))
        if args == ["--host-loop"]:
            print(card_line())
            return study_host_loop(here)
        if args == ["--workload"]:
            print(card_line())
            return study_workload(here)
        if args == ["--b6a-variants"]:
            print(card_line())
            return study_b6a_variants(here)
        if args == ["--b5d-plans"]:
            print(card_line())
            return study_b5d_plans()
        if args == ["--b5-tails"]:
            print(card_line())
            return study_b5_tails()
        if args == ["--fused-input-cuts"]:
            print(card_line())
            return study_fused_input_cuts()
        if len(args) in (2, 3) and args[0] == "--update-ab" and (
                args[2:] in ([], ["onehot"], ["heads"])):
            print(card_line())
            return study_update_ab(os.path.abspath(args[1]), here, *args[2:])
        if len(args) in (2, 3) and args[0] == "--update-ab-child":
            sys.path.insert(0, os.path.abspath(args[1]))
            return study_update_child(*args[2:])
        fail(f"unknown arguments {args}: run with none for the smoke, or "
             "--b1-phases [CHECKOUT], --b1-phases-signals, --b1-widths, "
             "--b1-ab PARENT_CHECKOUT, "
             "--b1-ext [CHECKOUT], --cells-ab PARENT_CHECKOUT, "
             "--b2-ab PARENT_CHECKOUT, --b6a-variants, --host-loop, "
             "--workload, "
             "--b5d-plans, --b5-tails, --fused-input-cuts or --update-ab "
             "PARENT_CHECKOUT [onehot|heads]")
    report = {}
    card = card_line()
    print(card)
    report["card"] = card
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda

    from distributed_cluster_gpus_tpu_torch.kernels import build
    from distributed_cluster_gpus_tpu_torch.utils.native import csv_writer_lib

    t0 = time.perf_counter()
    build.build(["event_scan", "event_scan64", "event_scan_sig",
                 "event_scan_sig64", "arrival_tables",
                 "replay_ingest", "quantile_huber", "marginal", "adam",
                 "replay_sample", "param_pack", "dense", "log_softmax"])
    build_s = time.perf_counter() - t0
    print(f"built CUDA kernels in {build_s:.1f} s")
    t0 = time.perf_counter()
    csv_writer_lib()
    print(f"built the native CSV writer in {time.perf_counter() - t0:.1f} s")
    for name, log in build.ptxas_reports.items():
        print(f"[ptxas {name}] " + " | ".join(
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line))
    report["build_s"] = build_s

    report["phase_s"] = {}

    def timed(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t
        report["phase_s"][fn.__name__] = dt
        print(f"[{fn.__name__}: {dt:.1f} s]", flush=True)
        return out

    timed(phase_b2, report)
    timed(phase_b1, report)
    timed(phase_b1_ext, report)
    timed(phase_clock64, report)
    # run outputs stay inside the checkout (smoke_out/ is git-ignored)
    out_root = os.path.join(here, "smoke_out", "runs")
    shutil.rmtree(out_root, ignore_errors=True)
    os.makedirs(out_root)
    try:
        launches = timed(phase_main_path, report, out_root)
        timed(phase_rollouts, report)
        timed(phase_cuda_vs_cpu, report, out_root)
        timed(phase_profile, report)
        real = timed(phase_b1_rl, report)
        timed(phase_b1_rl_wide, report)
        timed(phase_rl_tail, report, real)
        timed(phase_wide_heads, report)
        timed(phase_b6a, report)
        rl_launches = timed(phase_chsac_cli, report, out_root)
        timed(phase_update_kernels, report)
        timed(phase_fused_regions, report)
        timed(phase_widened_kernels, report)
        trained = timed(phase_update_whole, report)
        timed(phase_b1_after_learning, report, trained)
        upd_launches = timed(phase_learning_cli, report, out_root)
        x64_launches = timed(phase_clock64_cli, report, out_root)
        timed(phase_checkpoint_cli, report, out_root)
        timed(phase_host_loop, report, out_root)
        wl_runs = timed(phase_workload, report, out_root)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)

    b1r, b2r = report["b1"], report["b2"]
    c64 = report["clock64"]
    rl = {k: report[k] for k in ("b1_rl", "b3", "b4", "b6a")}

    def entry(name, source, replaces, launches, r, library_ms):
        return {"name": name, "route": "cuda",
                "source": f"distributed_cluster_gpus_tpu_torch/csrc/{source}",
                "replaces": f"distributed_cluster_gpus_tpu/{replaces}",
                "launches": launches, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": library_ms}
    kernels = {"kernels": [{
        "name": "event_scan",
        "route": "cuda",
        "source": "distributed_cluster_gpus_tpu_torch/csrc/event_scan.cu",
        "replaces": "distributed_cluster_gpus_tpu/sim/engine.py:4581",
        "launches": launches["event_scan"],
        "max_abs_err": max(b1r["max_abs_err"], report["b1_ext"]["max_abs_err"]),
        "ms": b1r["ms"],
        "plain_ms": b1r["plain_ms"],
        "bound_ms": b1r["bound_ms"],
        "bound_by": b1r["bound_by"],
        "library_ms": None,
        # the heuristic launches by instance: default_policy / joint_nf, and
        # the extended one (carbon_cost, debug, bandit, eco and weighted
        # routing, the cap controllers; phase (a)'s paper-fleet chunks)
        "instances": {
            "base": {"launches": launches["event_scan"] - launches["ext"],
                     "ms": b1r["ms"], "us_per_event": b1r["us_per_event"]},
            "extended": {k: report["b1_ext"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "us_per_event",
                "max_abs_err")} | {"launches": launches["ext"]}},
    }, {
        "name": "arrival_tables",
        "route": "cuda",
        "source": "distributed_cluster_gpus_tpu_torch/csrc/arrival_tables.cu",
        "replaces": "distributed_cluster_gpus_tpu/workload/compiler.py:218",
        "launches": launches["arrival_tables"],
        "max_abs_err": b2r["max_abs_err"],
        "ms": b2r["ms"],
        "plain_ms": b2r["plain_ms"],
        "bound_ms": b2r["bound_ms"],
        "bound_by": b2r["bound_by"],
        "library_ms": None,
    },
        entry("event_scan_rl_mode", "event_scan.cu", "sim/engine.py:4581",
              rl_launches["rl"], rl["b1_rl"], None),
        entry("windowed_p99", "event_scan.cu", "sim/algos.py:210",
              rl_launches["rl"], rl["b3"], rl["b3"]["library_ms"]),
        entry("policy_tail", "event_scan.cu", "sim/engine.py:3454",
              rl_launches["rl"], rl["b4"], rl["b4"]["library_ms"]),
        dict(entry("replay_ingest", "replay_ingest.cu", "rl/replay.py:165",
                   rl_launches["replay_ingest"], rl["b6a"], None),
             redesigned=True, host_ms=rl["b6a"]["host_ms"],
             scatter_layout={"replaces": "distributed_cluster_gpus_tpu/rl/"
                             "replay.py:132", "ms": rl["b6a"]["scatter_ms"],
                             "plain_ms": rl["b6a"]["scatter_plain_ms"]}),
        dict(entry("quantile_huber", "quantile_huber.cu", "rl/sac.py:178",
                   upd_launches["quantile_huber"], report["b5a"], None),
             redesigned=True),
        dict(entry("marginal_target", "marginal.cu", "rl/sac.py:223",
                   upd_launches["marginal_target"], report["b5b_target"], None),
             redesigned=True),
        dict(entry("marginal_actor", "marginal.cu", "rl/sac.py:251",
                   upd_launches["marginal_actor"], report["b5b_actor"], None),
             redesigned=True),
        dict(entry("clip_adam_polyak", "adam.cu", "rl/sac.py:279",
                   upd_launches["adam_update"], report["b5c"],
                   report["b5c"]["library_ms"]), redesigned=True),
        # B5g: the update's casts run inside B5c's launches (held bitwise in
        # phase (j) and by the shadows' check of phase (k)); its own kernel
        # fills the shadows outside the update, once per agent
        dict(entry("param_pack", "param_pack.cu", "rl/sac.py:206",
                   upd_launches["param_pack"], report["b5g"],
                   report["b5g"]["library_ms"]), redesigned=True,
             update_casts_run_inside="clip_adam_polyak (csrc/adam.cu)"),
        dict(entry("replay_sample", "replay_sample.cu", "rl/replay.py:212",
                   upd_launches["replay_sample"], report["b6b"],
                   report["b6b"]["library_ms"]), redesigned=True),
        # R1d: the update's last plain-torch region, no launch of its own;
        # it runs in the batch tails of B5a, B5b (target and actor), B5c
        # and B6b, once an update (their launches; ms: those calls less the
        # same calls without their tail outputs, phase (j))
        dict(entry("update_tail", "marginal.cu", "rl/sac.py:268",
                   upd_launches["marginal_target"], report["update_tail"],
                   None),
             runs_inside=["quantile_huber (csrc/quantile_huber.cu)",
                          "marginal_target, marginal_actor (csrc/marginal.cu)",
                          "clip_adam_polyak (csrc/adam.cu)",
                          "replay_sample (csrc/replay_sample.cu)"],
             ms_by_host=report["update_tail"]["deltas_ms"]),
        *(dict(entry(name, f"{mod}.cu", replaces, upd_launches[name],
                     report["fused"][name], report["fused"][name]["library_ms"]),
               **({"redesigned": True} if mod in ("dense", "log_softmax")
                  else {}))
          for name, (mod, _, replaces) in FUSED.items()),
        # the float64 clock's instances (phases (n) and (o); launches: the
        # float64 CLI runs of (o))
        dict(entry("event_scan_f64", "event_scan64.cu", "sim/engine.py:4581",
                   x64_launches["event_scan"], c64["b1_summary"], None),
             instances={k: {f: v[f] for f in (
                 "us_per_event", "us_per_event_float32", "ms", "plain_ms",
                 "bound_ms", "bound_by")} for k, v in c64["b1"].items()},
             lanes_us_per_event=c64["b1_lanes_us_per_event"]),
        dict(entry("arrival_tables_f64", "arrival_tables.cu",
                   "workload/compiler.py:218", x64_launches["arrival_tables"],
                   c64["b2"], None), ms_r32_bench=c64["b2"]["ms_r32_bench"]),
        entry("replay_sample_x64", "replay_sample.cu", "rl/replay.py:212",
              x64_launches["replay_sample"], c64["b6b"], None),
        entry("clip_adam_polyak_x64", "adam.cu", "rl/sac.py:279",
              x64_launches["adam_update"], c64["b5c"], None),
        *workload_entries(report, wl_runs, entry),
    ]}
    report["kernels"] = kernels["kernels"]
    with open(os.path.join(here, "smoke_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
