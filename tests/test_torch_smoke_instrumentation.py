"""``chip_smoke.py``'s B1 and B5 studies against the kernel sources, on the CPU.

``--b1-phases`` instruments ``csrc/event_scan.cu`` by text: it inserts a
``clock64`` mark at fixed anchors of the heuristic step, the RL step and
its tail.  An edit of the kernel that moves an anchor would only show on
the card; these tests apply the instrumentation to the current source here,
with no ``nvcc``.  They also hold the wrapper's block widths and shared-
memory count against the constants the kernel is built with.  ``--b5-tails``
cuts B5a and B5b's actor term short, or swaps in an alternative, by text
edits, and ``--fused-input-cuts`` cuts parts of the fused input layers out
of ``csrc/dense.cu``; each edit's anchor must be in the current source
exactly once.
"""

import os
import re

import pytest

import chip_smoke
from distributed_cluster_gpus_tpu_torch.kernels import build
from distributed_cluster_gpus_tpu_torch.kernels import event_scan as b1

SRC = os.path.join(build.CSRC_DIR, "event_scan.cu")


@pytest.fixture(scope="module")
def src():
    with open(SRC) as f:
        return f.read()


@pytest.fixture(scope="module")
def instrumented(src):
    return chip_smoke.instrumented_event_scan(src)


def test_current_kernel_takes_the_block_anchors(src):
    """The anchors are the block kernel's: thread 0 runs the scalar chain
    between block barriers, and no anchor waits on a warp barrier."""
    olds = [old for old, _ in chip_smoke.B1_ANCHORS]
    assert not any("__syncwarp" in old or "lane == 0) finish" in old
                   for old in olds)
    assert any("if (tid == 0) finish(i);\n      bar();" in old for old in olds)


def test_every_anchor_is_found_once(src):
    missing = [old for old, _ in chip_smoke.B1_ANCHORS if src.count(old) != 1]
    assert missing == []


@pytest.mark.parametrize("step", ["step", "step_rl"])
def test_both_modes_start_the_clock(instrumented, step):
    """The heuristic step and the RL step each start thread 0's clock."""
    assert (f"  __device__ void {step}(int i) {{\n    t_mark = clock64();\n"
            "    head(i);\n") in instrumented


@pytest.mark.parametrize("slot", list(range(len(chip_smoke.B1_PHASES)))
                         + sorted(chip_smoke.B1_COUNTS) + sorted(chip_smoke.B1_PARTS))
def test_every_phase_and_count_has_a_mark(instrumented, slot):
    """Every phase of ``B1_PHASES`` and every count of ``B1_COUNTS`` is
    written somewhere (the RL branch's slot is chosen at run time)."""
    if slot in (4, 6, 7, 8, 16):
        assert chip_smoke._RL_BRANCH_SLOT in instrumented
    assert f"g_prof[{slot}]" in instrumented


def test_marks_are_taken_on_thread_zero(instrumented):
    marks = re.findall(r"if \((\w+ == 0)\) atomicAdd\(&g_prof", instrumented)
    assert marks and set(marks) <= {"tid == 0", "lane == 0"}
    assert "tid == 0" in marks


def test_wrapper_widths_are_built(src):
    """The widths the wrapper may launch are the kernel's instantiations,
    and each mode's choice is one of them."""
    built = sorted(int(n) for n in re.findall(
        r"case (\d+): return event_scan_kernel<kRL, \1, kWide, kExt, Clock>;",
        src))
    assert built == sorted(b1.BLOCK_WIDTHS)
    # the standalone launch: each width in both head instances
    tail = sorted(int(n) for n in re.findall(
        r"case (\d+): return wide \? rl_tail_batch_kernel<\1, true>\s*"
        r": rl_tail_batch_kernel<\1, false>;", src))
    assert tail == sorted(b1.BLOCK_WIDTHS)
    assert b1.THREADS in b1.BLOCK_WIDTHS


def test_shared_memory_count_matches_the_kernel(src):
    """``smem_bytes`` uses the kernel's scratch sizes (kRed, the activation
    rows, kRegSlots) and lays an RL cluster out as the kernel does: the
    activation rows in every block, then the weight slices, block 0's slab
    after its own slice or in place of one."""
    warps = int(re.search(r"constexpr int kMaxWarps = (\d+);", src).group(1))
    red = re.search(r"constexpr int kRed = (\d+) \* kMaxWarps;", src)
    assert b1.RED_WORDS == int(red.group(1)) * warps
    assert re.search(r"constexpr int kActLen = kMaxWidth \+ kMaxWidth / 16;", src)
    assert b1.ACT_LEN == b1.MAX_WIDTH + b1.MAX_WIDTH // 16
    heads = int(re.search(r"constexpr int kMaxHeads = (\d+);", src).group(1))
    assert b1.MAX_HEADS == heads
    assert "  return 32 + (n_g + 3) / 4 * 4;\n" in src
    assert [b1.logit_len(n) for n in (1, 4, 5, 8, 128, 255)] == [
        36, 36, 40, 40, 160, 288]
    assert "return 4LL * (2 * kActLen + logit_len(ints[I_MAXGPU]) + 4) + rest;" in src
    assert b1.act_bytes(8) == 4 * (2 * b1.ACT_LEN + b1.logit_len(8) + 4)
    for name, val in (("kRegSlots", b1.REG_SLOTS), ("kMaxCluster", b1.MAX_CLUSTER)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == val
    assert max(b1.CLUSTERS) <= b1.MAX_CLUSTER
    # a scratch row per DC-summing warp past P = 512; the RL windows and
    # observation; no slab term for the block width
    base = b1.slab_bytes(1024, 2048, True, 1)
    assert b1.slab_bytes(1024, 2048, True, 3) - base == 4 * 2 * 1024
    assert b1.slab_bytes(512, 2048, True, 3) == b1.slab_bytes(512, 2048, True, 1)
    assert "2LL * ints[I_W] + kMaxObs : 0;" in src
    assert base - b1.slab_bytes(1024, 2048, False, 1) == 4 * (2 * 2048 + 256)
    assert b1.slab_bytes(512) == 4 * (18 * 512 + 512 + b1.RED_WORDS)
    w = (49, 256, 256, 256, 256, 8, 8)
    assert b1.smem_bytes(512, 2048, False, 1, w, 4, True) == b1.slab_bytes(512)
    assert b1.smem_bytes(1024, 2048, True, 1, w, 4, True) == (
        b1.act_bytes(8) + b1.slice_bytes(w, 4) + base)
    assert b1.smem_bytes(1024, 2048, True, 1, w, 4, False) == (
        b1.act_bytes(8) + max(b1.slice_bytes(w, 3), base))
    assert b1.smem_bytes(16, 64, True, 1, w, 2, False) == (
        b1.act_bytes(8) + b1.slice_bytes(w, 1))


def test_cluster_rows_split_the_weights():
    """A slice is ceil(out / nb) rows of every layer, rows padded to a
    power of two, in bf16, with their float biases; the paper policy's
    429 KB need four blocks."""
    w = (49, 256, 256, 256, 256, 8, 8)
    elems = 256 * 64 + 3 * 256 * 256 + 2 * 8 * 256
    assert b1.slice_bytes(w, 1) == 2 * elems + 4 * (4 * 256 + 16)
    assert b1.slice_bytes(w, 4) == (
        2 * (64 * 64 + 3 * 64 * 256 + 2 * 2 * 256) + 4 * (4 * 64 + 4))
    assert b1.slice_bytes((5, 7, 7, 7, 7, 3, 3), 8) == 2 * (4 * 8 + 2 * 8) + 2 * 16
    room = b1.SMEM_BUDGET - b1.act_bytes(8)
    assert b1.slice_bytes(w, 2) + b1.slab_bytes(16, 2048, True) > room
    assert b1.slice_bytes(w, 4) + b1.slab_bytes(512, 2048, True) <= room


def _engine(algo, job_cap, lat_window=2048):
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_fleet
    from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
    from distributed_cluster_gpus_tpu_torch.sim.engine import Engine

    def act(pp, o, md, mg, k):
        return k[0], k[1]

    act.kernel_mode = "sample"  # as rl.sac.make_policy_apply marks its own
    return Engine(build_fleet(), SimParams(algo=algo, job_cap=job_cap,
                                           queue_cap=8, lat_window=lat_window),
                  device="cpu", policy_apply=act if algo == "chsac_af" else None)


PAPER_POLICY = (256,) * 4


def test_sum_warps_and_cluster_fit():
    """A slab near the limit leaves room for fewer DC-summing warps; in RL
    mode the policy's weights take the fewest blocks that fit, block 0
    holding a slice where its slab leaves room, and fewer summing warps
    before more blocks."""
    small = _engine("default_policy", 512)
    assert b1.block_plan(small, 256) == (8, 1, True)
    assert b1.block_plan(small, 64) == (2, 1, True)
    big = _engine("default_policy", 2400)
    n = b1.block_plan(big, 256)[0]
    assert 1 <= n < 8
    assert b1.slab_bytes(2400, 2048, False, n) <= b1.SMEM_BUDGET
    assert b1.slab_bytes(2400, 2048, False, n + 1) > b1.SMEM_BUDGET
    assert b1.block_plan(_engine("chsac_af", 512), 256, PAPER_POLICY) == (8, 4, True)
    assert b1.block_plan(_engine("chsac_af", 512), 256, (16,) * 4) == (8, 1, True)
    assert b1.block_plan(_engine("chsac_af", 800), 256, PAPER_POLICY) == (7, 4, True)
    assert b1.block_plan(_engine("chsac_af", 1025), 256, PAPER_POLICY) == (1, 4, True)
    assert b1.block_plan(_engine("chsac_af", 1100), 256, PAPER_POLICY) == (8, 4, False)
    assert b1.block_plan(_engine("chsac_af", 2048), 256, PAPER_POLICY) == (5, 4, False)


@pytest.mark.parametrize("job_cap", [16, 512, 1024, 1025, 1100, 1600, 2048, 2346])
@pytest.mark.parametrize("threads", [32, 256])
def test_rl_mode_fits_every_slab_that_fits(job_cap, threads):
    """Every RL-mode job_cap whose slab fits beside the activation rows
    gets a launch at the paper policy's widths (the evaluation's job_cap
    2,048 among them), within the budget in every block."""
    eng = _engine("chsac_af", job_cap)
    b1.check_kernel_covers(eng)
    n, cs, lead = b1.block_plan(eng, threads, PAPER_POLICY)
    w = (eng.params.obs_dim(8), *PAPER_POLICY, 8, eng.params.max_gpus_per_job)
    assert b1.smem_bytes(job_cap, 2048, True, n, w, cs, lead) <= b1.SMEM_BUDGET
    # block 0 gives up its slice only where it has no room for one
    assert lead or b1.smem_bytes(job_cap, 2048, True, 1, w, cs, True) > b1.SMEM_BUDGET
    ints = dict(zip(b1.INT_NAMES, b1.kernel_ints(eng, 1, 16, 4, False,
                                                 PAPER_POLICY, threads)))
    assert (ints["sum_warps"], ints["cluster"], ints["lead"]) == (n, cs, int(lead))


@pytest.mark.parametrize("src", sorted(chip_smoke.B5_CUTS))
def test_b5_tail_cuts_apply_to_the_sources(src):
    with open(os.path.join(build.CSRC_DIR, src + ".cu")) as f:
        text = f.read()
    variants = {**chip_smoke.B5_CUTS[src], **chip_smoke.B5_ALTERNATIVES[src]}
    for cut, edits in variants.items():
        for old, _ in edits:
            assert text.count(old) == 1, (cut, old)


@pytest.mark.parametrize("variant", sorted(chip_smoke.B6A_VARIANTS))
def test_b6a_variants_apply_to_the_source(variant):
    """Every ``--b6a-variants`` edit's anchor is in csrc/replay_ingest.cu
    once."""
    with open(os.path.join(build.CSRC_DIR, "replay_ingest.cu")) as f:
        text = f.read()
    for old, _ in chip_smoke.B6A_VARIANTS[variant]:
        assert text.count(old) == 1, (variant, old)


@pytest.mark.parametrize("cut", sorted(chip_smoke.FUSED_INPUT_CUTS))
def test_fused_input_cuts_apply_to_the_source(cut):
    """Every ``--fused-input-cuts`` edit's anchor is in csrc/dense.cu once."""
    with open(os.path.join(build.CSRC_DIR, "dense.cu")) as f:
        text = f.read()
    for old, _ in chip_smoke.FUSED_INPUT_CUTS[cut]:
        assert text.count(old) == 1, (cut, old)
