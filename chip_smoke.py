"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the main path from ``csrc/`` (one ``nvcc``
   per source, started together) and print the build time and each
   kernel's ptxas line (registers, shared memory, spills);
3. hold B2 (arrival tables) against its plain torch version on the card at
   the main path's shapes (the paper fleet's S=16 streams, n=4096 entries;
   then R=32 lanes in one launch): key words and uniform draws bit-exact,
   sizes / next arrivals / cumulative folds within 1e-6 relative (measured
   bit-identical); time kernel and plain version, compute the card's bound;
4. (a) hold B1 (the event scan) against its plain version on the card,
   bitwise (final state leaves, key words, emissions; the largest absolute
   difference is computed and reported): the duo/single-DC loads of the CPU
   engine tests for both algorithms over 2 chunks of 300 events, then the
   paper fleet exactly as the CLI of phase (b) builds it (auto queue_cap,
   seed 123, 4,096-step chunks) over 2 chunks for both; time the kernel and
   the plain version on the paper-fleet chunks and bound the kernel by the
   bytes and operations those chunks needed;
5. (b) drive the main path through the CLI entry point
   (``distributed_cluster_gpus_tpu_torch.run_sim``) on the paper fleet (8 DCs,
   8 ingresses, 1,488 GPUs, job_cap 512, auto queue_cap) for 600 simulated
   seconds, ``default_policy`` then ``joint_nf``, with the launch counters
   zeroed just before each run and read just after: both kernels launched,
   no synchronizing CUDA call (so no host read) made while the B1 wrapper or
   the plain step is on the stack (a second run under torch's sync debug
   mode), queue conservation, the energy integral against the CSV;
   print events/s;
6. (c) batched rollouts at the repo's bench shape (paper fleet, R=32,
   J=128, queue_cap 256, log tick 20 s; ``bench.py:328-332``), 4 chunks of
   512 steps in one launch each, both counters zeroed before the run: one
   B1 and one B2 launch per chunk, every lane bitwise equal to the
   single-lane kernel run of its key, lanes 0 and 1 equal to the plain
   engine over every chunk and in their final state; print the aggregate
   events/s;
7. (d) the engine on the card against the engine on the CPU: the same small
   duo-fleet run with the same arrival tables must end in a
   bitwise-identical state and identical CSV bytes;
8. (e) profile one paper-fleet chunk on the kernel path (``torch.profiler``):
   device ops, device-to-host copies (host reads) and the device busy share
   per event;
9. print the card line, the kernel JSON line, then the device line.

Details go to ``smoke_out/chip_smoke.json`` (git-ignored).
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
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # non-tensor float32 peak, H100 SXM data sheet
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
QREC_BYTES = 11 * 4  # one ring record
EV_FINISH, EV_LOG = 0, 3
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


def bound(bytes_moved, ops):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_b = bytes_moved / H100_BYTES_PER_S
    t_o = ops / H100_F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def cli_argv(algo, out):
    """The main path's command line (phase (b))."""
    return ["--algo", algo, "--duration", str(MAIN_DURATION_S), "--out", out,
            "--log-interval", str(LOG_INTERVAL_S), "--device", "cuda", "--quiet"]


def cli_params(algo):
    """(fleet, params, chunk steps) exactly as the CLI builds them for the
    main path's command line."""
    from distributed_cluster_gpus_tpu_torch import run_sim
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_fleet

    a = run_sim.parse_args(cli_argv(algo, "unused"))
    fleet = build_fleet()
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


class SyncCounter:
    """Counts the synchronizing CUDA calls made from Python while it is on
    (a host read is one: ``.item()``, ``.tolist()``, a copy to the host).
    torch's sync debug mode turns each into a warning raised at its calling
    line; the counter sees it while that line's stack is live, so it counts
    a call as inside a chunk when the B1 wrapper (which spans the launch) or
    the plain step loop is on the stack, and also counts every call by the
    file of its line."""

    def __enter__(self):
        from distributed_cluster_gpus_tpu_torch.kernels.event_scan import (
            event_scan)
        from distributed_cluster_gpus_tpu_torch.sim.step import StepProgram

        self._chunk_code = {event_scan.__code__, StepProgram.scan_plain.__code__}
        self.by_file, self.in_chunk = {}, 0
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
    # R=32 lanes in one launch, each against its plain version
    lanes = batched_init(fleet, params, 32, workload=wl, device="cuda")
    largs = args_of(lanes, (32,))
    lout = b2.arrival_tables(*largs, 1024)
    lref = b2.arrival_tables_reference(*largs, 1024)
    torch.cuda.synchronize()
    for k in ("sizes", "tnext", "cum"):
        if not torch.equal(lout[k], lref[k]):
            fail(f"B2 with 32 lanes: {k} differs from the plain version")
    ms = time_cuda(lambda: b2.arrival_tables(*args, n), reps=50)
    plain_ms = time_cuda(lambda: b2.arrival_tables_reference(*args, n), reps=1,
                         runs=3, warmup=1)
    fams = wl.family_t.tolist()
    n_active = sum(1 for f in fams if f != b2.FAM_OFF)
    n_sin = sum(1 for f in fams if f == b2.FAM_SIN_INV)
    bytes_moved = (2 * 8 + S * (4 * 5 + 16)) + 3 * S * n * 4
    ops = (n_active * n * (BLOCKS_PER_ENTRY * THREEFRY_OPS + SAMPLER_OPS)
           + n_sin * n * BISECT_OPS + S * n)
    bound_ms, bound_by = bound(bytes_moved, ops)
    print(f"B2 arrival_tables S={S} n={n}: max_abs_err={max_err:.3g} "
          f"max_rel_err={max_rel:.3g}, 32 lanes bit-identical; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}: {bytes_moved} B, {ops} ops)")
    report["b2"] = {"S": S, "n": n, "max_abs_err": max_err, "max_rel_err": max_rel,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": bytes_moved, "ops": ops}


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
        pow2_at_least)
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
    small = (nbytes(leaves(before)) - slab - nbytes([before.queues.recs])
             - nbytes([before.lat.buf]))
    bytes_moved = (2 * (slab + small) + QREC_BYTES * (pushes + pops)
                   + 4 * finishes + 8 * arrivals + nbytes([pre["c0"]])
                   + nbytes(eng.kernel_consts().values())
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


def _read_csv(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def phase_main_path(report, out_root):
    """(b) the CLI main path on the paper fleet, both algorithms."""
    from distributed_cluster_gpus_tpu_torch import run_sim
    from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
    from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1

    runs = {}
    launches = {"event_scan": 0, "arrival_tables": 0}
    for algo in ALGOS:
        out = os.path.join(out_root, algo)
        torch.cuda.synchronize()
        b1.event_scan.launches = 0
        b2.arrival_tables.launches = 0
        t0 = time.perf_counter()
        st = run_sim.main(cli_argv(algo, out))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_b1, n_b2 = b1.event_scan.launches, b2.arrival_tables.launches
        if n_b1 <= 0:
            fail(f"{algo}: the main path never launched the B1 kernel")
        if n_b2 <= 0:
            fail(f"{algo}: the main path never launched the B2 kernel")
        # the same run again (its own output directory), counting the
        # synchronizing CUDA calls by the file that made them; the timed
        # run above goes without the counter's warnings
        with SyncCounter() as syncs:
            run_sim.main(cli_argv(algo, out + "_syncs"))
        in_chunk = syncs.in_chunk
        port = syncs.count(*(f"distributed_cluster_gpus_tpu_torch/{d}" for d in
                             ("sim/io.py", "sim/engine.py", "run_sim.py")))
        if port == 0:
            fail(f"{algo}: the sync counter saw no sync made by the run loop, "
                 f"so it measures nothing ({syncs.by_file})")
        if in_chunk:
            fail(f"{algo}: {in_chunk} synchronizing CUDA calls inside the "
                 f"chunks ({syncs.by_file})")
        launches["event_scan"] += n_b1
        launches["arrival_tables"] += n_b2
        events = int(st.n_events)
        arrived = int(st.jid_counter) - 1
        finished = int(st.n_finished.sum())
        queued = int((st.queues.tail - st.queues.head).sum())
        placed = int((st.jobs.status != 0).sum())
        dropped = int(st.n_dropped)
        jobs = _read_csv(os.path.join(out, "job_log.csv"))
        cl = _read_csv(os.path.join(out, "cluster_log.csv"))
        if len(jobs) != finished:
            fail(f"{algo}: job_log has {len(jobs)} rows for {finished} finishes")
        if arrived != finished + queued + placed + dropped:
            fail(f"{algo}: conservation broken: {arrived} arrived != "
                 f"{finished} + {queued} + {placed} + {dropped}")
        if not bool(st.done) or abs(float(st.t) - MAIN_DURATION_S) > 1e-3:
            fail(f"{algo}: run did not reach its end (t={float(st.t)})")
        # energy: the growth of sum-over-DCs energy_kJ between the first and
        # last log tick against the trapezoid sum of power_W over the ticks
        # (the engine integrates P*dt exactly between events; sampled at 1 s
        # the two agree to a few percent)
        ticks = sorted({float(r["time_s"]) for r in cl})
        if len(ticks) < 2:
            fail(f"{algo}: too few log ticks")
        by_t = {}
        for r in cl:
            by_t.setdefault(float(r["time_s"]), []).append(r)
        e_last = sum(float(r["energy_kJ"]) for r in by_t[ticks[-1]]) * 1e3
        e_first = sum(float(r["energy_kJ"]) for r in by_t[ticks[0]]) * 1e3
        p_t = [sum(float(r["power_W"]) for r in by_t[t]) for t in ticks]
        riemann = sum(0.5 * (p_t[i] + p_t[i + 1]) * (ticks[i + 1] - ticks[i])
                      for i in range(len(ticks) - 1))
        if not (e_last > 0 and abs((e_last - e_first) - riemann) <= 0.05 * riemann):
            fail(f"{algo}: energy {e_last - e_first:.1f} J vs sum P*dt {riemann:.1f} J")
        vals = [float(v) for r in jobs for k, v in r.items()
                if k not in ("ingress", "type", "dc")]
        if not all(map(lambda x: x == x and abs(x) != float("inf"), vals)):
            fail(f"{algo}: non-finite job_log values")
        rate = events / wall
        print(f"{algo}: {events} events in {MAIN_DURATION_S:.0f} s simulated, "
              f"{wall:.2f} s wall, {rate:.1f} events/s, {finished} finished, "
              f"{arrived} arrived, {dropped} dropped, B1 launches {n_b1}, "
              f"B2 launches {n_b2}; synchronizing CUDA calls: {in_chunk} inside "
              f"the {n_b1} chunks, {syncs.total} in the whole run "
              f"({syncs.total / n_b1:.1f} per chunk, between the chunks); energy "
              f"{e_last / 3.6e6:.4f} kWh at the last tick")
        runs[algo] = {"events": events, "wall_s": wall, "events_per_s": rate,
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
    for algo in ALGOS:
        params = SimParams(**dict(BENCH_SHAPE, algo=algo))
        eng = Engine(fleet, params, device="cuda")
        st = batched_init(fleet, params, R, workload=eng.workload, device="cuda")
        singles = unstack_states(st)
        plain = [with_lane_axis(lane_state(st, r)) for r in (0, 1)]
        ems, pres = [], []
        torch.cuda.synchronize()
        b1.event_scan.launches = 0
        b2.arrival_tables.launches = 0
        t0 = time.perf_counter()
        for c in range(n_chunks):
            pres.append(eng.workload.tables(st, n_steps))
            st, em = eng.run_chunk(st, n_steps, pre=pres[-1])
            ems.append(em)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
        # lanes 0 and 1 against the plain engine, every chunk and the end
        for r, ps in zip((0, 1), plain):
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
        print(f"rollouts/{algo}: R={R} lanes x {n_chunks} chunks of {n_steps} "
              f"steps, {events} events in {wall:.3f} s wall, {rate:.0f} events/s "
              f"aggregate; B1 and B2 {n_chunks} launches each; every lane "
              f"bitwise equal to its single-lane run, lanes 0-1 to the plain "
              f"engine (every chunk, final state)")
        out[algo] = {"R": R, "events": events, "wall_s": wall, "events_per_s": rate,
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
    both make one), less the one read ``run_chunk`` makes after the chunk
    (the events it ran); the warm-up chunk runs under the sync counter."""
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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, _ = eng.run_chunk(st, n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = eng.stats["events"]
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
        if "draws_kernel" in e.name or "fold_kernel" in e.name:
            b2_us += dur
    if n_dev == 0:
        fail("profile: the profiler saw no device activity")
    if n_dtoh < 1:
        fail("profile: no device-to-host copy seen, though run_chunk reads the "
             "chunk's event count after it")
    reads_in_chunk = n_dtoh - 1
    if reads_in_chunk:
        fail(f"profile: {n_dtoh} device-to-host copies in one run_chunk, "
             "expected only the read after the chunk")
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
                         "device_us": dev_us, "device_ops": n_dev,
                         "device_busy_share": busy, "b1_us": b1_us,
                         "b2_us": b2_us, "dtoh_copies": n_dtoh,
                         "scalar_reads": n_scalar,
                         "host_reads_in_chunk": reads_in_chunk,
                         "warmup_syncs_in_chunk": in_chunk,
                         "warmup_syncs_total": syncs.total}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs an NVIDIA GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "distributed_cluster_gpus_tpu_torch")):
        fail("run from the repository root: the port's package is not beside "
             "this script")
    sys.path.insert(0, here)
    report = {}
    card = card_line()
    print(card)
    report["card"] = card
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda

    from distributed_cluster_gpus_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build(["event_scan", "arrival_tables"])
    build_s = time.perf_counter() - t0
    print(f"built CUDA kernels in {build_s:.1f} s")
    for name, log in build.ptxas_reports.items():
        print(f"[ptxas {name}] " + " | ".join(
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line))
    report["build_s"] = build_s

    phase_b2(report)
    phase_b1(report)
    # run outputs stay inside the checkout (smoke_out/ is git-ignored)
    out_root = os.path.join(here, "smoke_out", "runs")
    shutil.rmtree(out_root, ignore_errors=True)
    os.makedirs(out_root)
    try:
        launches = phase_main_path(report, out_root)
        phase_rollouts(report)
        phase_cuda_vs_cpu(report, out_root)
        phase_profile(report)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)

    b1r, b2r = report["b1"], report["b2"]
    kernels = {"kernels": [{
        "name": "event_scan",
        "route": "cuda",
        "source": "distributed_cluster_gpus_tpu_torch/csrc/event_scan.cu",
        "replaces": "distributed_cluster_gpus_tpu/sim/engine.py:4581",
        "launches": launches["event_scan"],
        "max_abs_err": b1r["max_abs_err"],
        "ms": b1r["ms"],
        "plain_ms": b1r["plain_ms"],
        "bound_ms": b1r["bound_ms"],
        "bound_by": b1r["bound_by"],
        "library_ms": None,
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
    }]}
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
