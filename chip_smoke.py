"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the main path from ``csrc/`` (one ``nvcc``
   per source, started together) and print the build time;
3. hold each kernel against its plain torch version on the card at the
   main path's shapes (B2 arrival tables: the paper fleet's S=16 streams,
   n=4096 entries): key words and uniform draws bit-exact, sizes / next
   arrivals / cumulative folds within 1e-6 relative; time kernel and plain
   version with CUDA events and compute the card's bound for the work;
4. drive the main path through the CLI entry point
   (``distributed_cluster_gpus_tpu_torch.run_sim``) on the paper fleet (8 DCs,
   8 ingresses, 1,488 GPUs, job_cap 512, auto queue_cap) for
   ``default_policy`` then ``joint_nf``, with the launch counters zeroed
   just before each run and read just after; check queue conservation,
   the energy integral against the CSV, and print events/s;
5. check the engine on the card against the engine on the CPU: the same
   small duo-fleet run with the same arrival tables must end in a
   bitwise-identical state and identical CSV bytes;
6. profile one paper-fleet chunk (``torch.profiler``): device ops, host
   reads and the device busy share per event;
7. print the kernel JSON line, then the device line.

Details go to ``smoke_out/chip_smoke.json`` (git-ignored).
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

DURATION_S = 60.0
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


def phase_b2(report):
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_fleet
    from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2
    from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
    from distributed_cluster_gpus_tpu_torch.run_sim import finalize_queue_cap
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state

    fleet = build_fleet()
    params = finalize_queue_cap(
        SimParams(duration=DURATION_S, log_interval=LOG_INTERVAL_S), fleet)
    eng = Engine(fleet, params, device="cuda")
    st = init_state(params.seed, fleet, params, workload=eng.workload,
                    device="cuda")
    wl = eng.workload
    S, n = wl.n_streams, 4096
    args = (st.arr_key, st.arr_count.reshape(S).contiguous(),
            st.next_arrival.reshape(S).contiguous(),
            st.arr_cum.reshape(S).contiguous(),
            st.arr_epoch.reshape(S).contiguous(), wl.family_t, wl.sparams)
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
    ms = time_cuda(lambda: b2.arrival_tables(*args, n), reps=50)
    plain_ms = time_cuda(lambda: b2.arrival_tables_reference(*args, n), reps=1,
                         runs=3, warmup=1)
    fams = wl.family_t.tolist()
    n_active = sum(1 for f in fams if f != b2.FAM_OFF)
    n_sin = sum(1 for f in fams if f == b2.FAM_SIN_INV)
    bytes_moved = (2 * 8 + S * (4 * 5 + 16)) + 3 * S * n * 4
    ops = (n_active * n * (BLOCKS_PER_ENTRY * THREEFRY_OPS + SAMPLER_OPS)
           + n_sin * n * BISECT_OPS + S * n)
    bound_s = max(bytes_moved / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S)
    bound_by = ("bytes" if bytes_moved / H100_BYTES_PER_S
                >= ops / H100_F32_OPS_PER_S else "operations")
    print(f"B2 arrival_tables S={S} n={n}: max_abs_err={max_err:.3g} "
          f"max_rel_err={max_rel:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
          f"bound {bound_s * 1e3:.5f} ms ({bound_by}: {bytes_moved} B, {ops} ops)")
    report["b2"] = {"S": S, "n": n, "max_abs_err": max_err, "max_rel_err": max_rel,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
                    "bound_by": bound_by, "bytes": bytes_moved, "ops": ops}


def _read_csv(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def phase_main_path(report, out_root):
    from distributed_cluster_gpus_tpu_torch import run_sim
    from distributed_cluster_gpus_tpu_torch.kernels import arrival_tables as b2

    runs = {}
    total_launches = 0
    for algo in ALGOS:
        out = os.path.join(out_root, algo)
        argv = ["--algo", algo, "--duration", str(DURATION_S), "--out", out,
                "--log-interval", str(LOG_INTERVAL_S), "--device", "cuda",
                "--quiet"]
        torch.cuda.synchronize()
        b2.arrival_tables.launches = 0
        t0 = time.perf_counter()
        st = run_sim.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = b2.arrival_tables.launches
        if launches <= 0:
            fail(f"{algo}: the main path never launched the B2 kernel")
        total_launches += launches
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
        if not bool(st.done) or abs(float(st.t) - DURATION_S) > 1e-3:
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
        print(f"{algo}: {events} events, {wall:.2f} s wall, {rate:.1f} events/s, "
              f"{finished} finished, {arrived} arrived, {dropped} dropped, "
              f"B2 launches {launches}, energy {e_last / 3.6e6:.4f} kWh at the last tick")
        runs[algo] = {"events": events, "wall_s": wall, "events_per_s": rate,
                      "arrived": arrived, "finished": finished, "queued": queued,
                      "placed": placed, "dropped": dropped, "b2_launches": launches}
    report["main_path"] = runs
    return total_launches


def phase_cuda_vs_cpu(report, out_root):
    """The engine on the card against the engine on the CPU, same tables."""
    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_duo_fleet
    from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine
    from distributed_cluster_gpus_tpu_torch.sim.io import run_simulation

    fleet = build_duo_fleet()
    params = SimParams(algo="joint_nf", duration=20.0, log_interval=2.0,
                       job_cap=32, queue_cap=256, lat_window=128, seed=9)
    tables = []
    stats = []

    def keep(state, em, eng):
        stats.append(dict(eng.stats))

    cpu_eng = Engine(fleet, params, device="cpu")
    orig = cpu_eng.workload.tables

    def recording_tables(state, n):
        out = orig(state, n)
        tables.append({k: v.clone() for k, v in out.items()})
        return out

    cpu_eng.workload.tables = recording_tables
    s_cpu = run_simulation(fleet, params, out_dir=os.path.join(out_root, "cpu"),
                           chunk_steps=512, engine=cpu_eng)
    t0 = time.perf_counter()
    s_gpu = run_simulation(fleet, params, out_dir=os.path.join(out_root, "gpu"),
                           chunk_steps=512, device="cuda", pre_tables=tables,
                           on_chunk=keep)
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
    reads = sum(s["host_reads"] for s in stats)
    events = int(s_gpu.n_events)
    print(f"card vs CPU engine (duo fleet, joint_nf, {events} events): bitwise "
          f"identical state and CSVs; {reads / max(events, 1):.3f} host reads "
          f"per event, {events / wall:.1f} events/s on the card")
    report["cuda_vs_cpu"] = {"events": events, "host_reads": reads,
                             "events_per_s": events / wall}


def phase_profile(report):
    """Where an event's time goes on the card: one profiled chunk of the
    paper fleet (default_policy) after a warm-up chunk."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_cluster_gpus_tpu_torch.configs.paper import build_fleet
    from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
    from distributed_cluster_gpus_tpu_torch.run_sim import finalize_queue_cap
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine, init_state

    fleet = build_fleet()
    params = finalize_queue_cap(
        SimParams(duration=DURATION_S, log_interval=LOG_INTERVAL_S), fleet)
    eng = Engine(fleet, params, device="cuda")
    st = init_state(params.seed, fleet, params, workload=eng.workload,
                    device="cuda")
    st, _ = eng.run_chunk(st, 512)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, _ = eng.run_chunk(st, 1024)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = eng.stats["events"]
    dev_us, n_dev, b2_us = 0.0, 0, 0.0
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            dur = e.time_range.elapsed_us()
            dev_us += dur
            n_dev += 1
            if "draws_kernel" in e.name or "fold_kernel" in e.name:
                b2_us += dur
    busy = dev_us / (wall * 1e6) if dev_us > 0 else None
    print(f"profile (paper fleet, default_policy, {events} events, profiler on): "
          f"{wall / max(events, 1) * 1e3:.3f} ms/event wall, "
          f"{n_dev / max(events, 1):.1f} device ops/event, device busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'}, "
          f"B2 {b2_us:.1f} us of {dev_us:.1f} us device time, "
          f"{eng.stats['host_reads'] / max(events, 1):.3f} host reads/event")
    report["profile"] = {"events": events, "wall_s": wall, "device_us": dev_us,
                         "device_ops": n_dev, "device_busy_share": busy,
                         "b2_us": b2_us, "host_reads": eng.stats["host_reads"]}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs an NVIDIA GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    report = {}
    card = card_line()
    print(card)
    report["card"] = card
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda

    from distributed_cluster_gpus_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.build(["arrival_tables"])
    build_s = time.perf_counter() - t0
    print(f"built CUDA kernels in {build_s:.1f} s")
    for name, log in build.ptxas_reports.items():
        print(f"[ptxas {name}] " + " | ".join(
            line.strip() for line in log.splitlines() if "registers" in line))
    report["build_s"] = build_s

    phase_b2(report)
    # run outputs stay inside the checkout (smoke_out/ is git-ignored)
    out_root = os.path.join(here, "smoke_out", "runs")
    shutil.rmtree(out_root, ignore_errors=True)
    os.makedirs(out_root)
    try:
        launches = phase_main_path(report, out_root)
        phase_cuda_vs_cpu(report, out_root)
        phase_profile(report)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)

    b2r = report["b2"]
    kernels = {"kernels": [{
        "name": "arrival_tables",
        "route": "cuda",
        "source": "distributed_cluster_gpus_tpu_torch/csrc/arrival_tables.cu",
        "replaces": "distributed_cluster_gpus_tpu/workload/compiler.py:218",
        "launches": launches,
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
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
