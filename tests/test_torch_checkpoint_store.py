"""The port's checkpoint store (``utils/checkpoint.py``) and its fsck.

The store tests of ``tests/test_checkpoint.py`` against the port's own
payload (one ``.npz`` per named tree, read without pickles): the round
trip, the manifest and COMMIT marker, a re-save of one step, a crash at
each injection point (in process, and a real SIGKILL in a subprocess),
the verified fallback chain past a corrupt newest step, an uncommitted
dir, a newer schema and the JAX package's schema refused, retention, the
run metadata, the config fingerprint, the interrupted re-save swap, and
``python -m distributed_cluster_gpus_tpu_torch.fsck_ckpt`` on a clean and a
corrupt store.  No engine runs: small numpy and torch trees.
"""

import json
import logging
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_cluster_gpus_tpu_torch.fsck_ckpt import main as fsck_main
from distributed_cluster_gpus_tpu_torch.models.structs import SimParams
from distributed_cluster_gpus_tpu_torch.utils.checkpoint import (
    CRASH_POINTS, SCHEMA, CheckpointCorruptError, CheckpointCrashInjected,
    config_fingerprint, gc_checkpoints, latest_step, restore_checkpoint,
    restore_latest, save_checkpoint, step_dirname, steps, verify_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The warm start draws three learners' initial weights, bound by
    Python's overhead: one torch thread, so that the suite's parallel
    workers do not oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny():
    return {"a": np.arange(16, dtype=np.int64),
            "b": {"x": np.linspace(0.0, 1.0, 9, dtype=np.float32)}}


def _corrupt_payload(ckpt_dir):
    """Flip the first byte of the first manifest-listed payload file."""
    man = json.load(open(os.path.join(ckpt_dir, "manifest.json")))
    rel = sorted(man["files"])[0]
    path = os.path.join(ckpt_dir, rel)
    with open(path, "r+b") as f:
        first = f.read(1)
        f.seek(0)
        f.write(bytes([first[0] ^ 0xFF]))
    return rel


def test_round_trip_of_tensors_arrays_and_bare_leaves(tmp_path):
    """Every leaf comes back bitwise with its dtype and shape (float64,
    bool, int32, 0-d), device tensors are copied to the host, a bare leaf
    stays bare; ``device`` restores tensors, ``like`` checks the layout."""
    g = torch.Generator().manual_seed(3)
    sim = {"t": torch.tensor(123.25, dtype=torch.float64),
           "jobs": {"status": torch.randint(0, 5, (7,), generator=g,
                                            dtype=torch.int32),
                    "valid": torch.rand(7, generator=g) < 0.5},
           "energy_j": torch.rand(3, generator=g, dtype=torch.float64)}
    key = np.array([7, 4294967295], np.uint32)
    d = save_checkpoint(str(tmp_path), 3, sim=sim, key=key,
                        csv={"cluster": np.int64(10), "job": np.int64(20)})
    assert sorted(os.listdir(d)) == ["COMMIT", "csv.npz", "key.npz",
                                     "manifest.json", "sim.npz"]
    out = restore_checkpoint(str(tmp_path))
    assert out["key"].dtype == np.uint32 and out["key"].tolist() == key.tolist()
    assert int(out["csv"]["job"]) == 20
    for path, want in (("t", sim["t"]), ("energy_j", sim["energy_j"])):
        got = out["sim"][path]
        assert got.dtype == np.float64 and got.tobytes() == want.numpy().tobytes()
    assert out["sim"]["jobs"]["valid"].dtype == np.bool_
    assert np.array_equal(out["sim"]["jobs"]["status"], sim["jobs"]["status"])
    dev = restore_checkpoint(str(tmp_path), 3, device="cpu")
    assert torch.equal(dev["sim"]["jobs"]["status"], sim["jobs"]["status"])
    like = {"sim": {**sim, "t": torch.tensor(0.0)}}  # a float32 clock
    with pytest.raises(ValueError, match="leaf 't'"):
        restore_checkpoint(str(tmp_path), 3, like=like)
    with pytest.raises(ValueError, match="missing"):
        restore_checkpoint(str(tmp_path), 3, like={"csv": {"cluster": 0}})
    assert set(restore_checkpoint(str(tmp_path), 3, names=["key"])) == {"key"}


def test_payload_is_read_without_pickles(tmp_path):
    """A payload holding an object array (which ``np.load`` would unpickle)
    is refused on restore, not executed."""
    d = save_checkpoint(str(tmp_path), 1, **_tiny())
    with open(os.path.join(d, "a.npz"), "wb") as f:
        np.savez(f, **{"": np.array([{"x": 1}], dtype=object)})
    with pytest.raises(ValueError, match="pickle"):
        restore_checkpoint(str(tmp_path), 1, verify=False)


def test_latest_step_strict_name_parsing(tmp_path):
    root = str(tmp_path)
    for name in ("step_5", "step_5_tmp", "step_0000000009_tmp", "step_abc",
                 "step_00000003", "stepx_0000000004", "step_0000000003"):
        os.makedirs(os.path.join(root, name))
    assert latest_step(root) == 3
    assert steps(root) == [3]
    assert latest_step(root, verified=True) is None  # an empty dir


def test_save_commits_with_manifest_and_marker(tmp_path):
    root = str(tmp_path)
    d = save_checkpoint(root, 4, metadata={"seed": 11, "chunk": 4}, **_tiny())
    assert d == os.path.join(root, step_dirname(4))
    assert os.path.exists(os.path.join(d, "COMMIT"))
    man = verify_checkpoint(d)
    assert man["schema"] == SCHEMA and man["schema_version"] == 1
    assert man["trees"] == ["a", "b"]
    assert man["metadata"] == {"seed": 11, "chunk": 4}
    assert man["n_files"] == len(man["files"]) == 2
    assert man["total_bytes"] == sum(
        os.path.getsize(os.path.join(d, f)) for f in man["files"])
    assert [n for n in os.listdir(root) if n.endswith("_tmp")] == []
    out = restore_checkpoint(root)
    np.testing.assert_array_equal(out["a"], _tiny()["a"])


def test_resave_same_step_is_safe(tmp_path):
    root = str(tmp_path)
    save_checkpoint(root, 2, **_tiny())
    t2 = {"a": np.arange(3), "b": {"x": np.zeros(2, np.float32)}}
    save_checkpoint(root, 2, **t2)
    verify_checkpoint(os.path.join(root, step_dirname(2)))
    np.testing.assert_array_equal(restore_checkpoint(root, 2)["a"], t2["a"])
    assert steps(root) == [2]


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_crash_injection_store_stays_verified(tmp_path, monkeypatch, point):
    """After a crash at any injection point the store holds only
    checkpoints that verify, gc sweeps the debris, and resume restores the
    newest verified step."""
    root = str(tmp_path)
    save_checkpoint(root, 1, **_tiny())
    monkeypatch.setenv("DCG_CKPT_CRASH_POINT", point)
    with pytest.raises(CheckpointCrashInjected):
        save_checkpoint(root, 2, **_tiny())
    monkeypatch.delenv("DCG_CKPT_CRASH_POINT")
    if point == "committed":  # the crash came after the rename
        assert latest_step(root, verified=True) == 2
    else:
        assert steps(root) == [1]
        assert any(n.endswith("_tmp") for n in os.listdir(root))
        assert latest_step(root, verified=True) == 1
    rep = gc_checkpoints(root)
    assert not any(n.endswith("_tmp") for n in os.listdir(root))
    assert bool(rep["swept"]) == (point != "committed")
    step, out = restore_latest(root)
    assert step == (2 if point == "committed" else 1)
    np.testing.assert_array_equal(out["a"], _tiny()["a"])


def test_unknown_crash_point_is_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("DCG_CKPT_CRASH_POINT", "halfway")
    with pytest.raises(ValueError, match="unknown injection point"):
        save_checkpoint(str(tmp_path), 1, **_tiny())


_KILL_SCRIPT = """
import os, sys
import numpy as np
sys.path.insert(0, {repo!r})
from distributed_cluster_gpus_tpu_torch.utils.checkpoint import save_checkpoint
root = sys.argv[1]
trees = dict(a=np.arange(32), b=dict(x=np.ones((4, 4), np.float32)))
save_checkpoint(root, 1, **trees)
os.environ["DCG_CKPT_CRASH_POINT"] = "marker"
os.environ["DCG_CKPT_CRASH_MODE"] = "kill"
save_checkpoint(root, 2, **trees)
print("UNREACHABLE")
"""


def test_sigkill_mid_save_subprocess(tmp_path):
    """A real SIGKILL between the COMMIT marker and the rename (no Python
    unwinding) leaves the prior verified step and staging debris; gc
    cleans and resume restores step 1."""
    root = str(tmp_path / "store")
    proc = subprocess.run(
        [sys.executable, "-c", _KILL_SCRIPT.format(repo=REPO), root],
        cwd=REPO, capture_output=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()
    assert b"UNREACHABLE" not in proc.stdout
    assert steps(root) == [1] and latest_step(root, verified=True) == 1
    assert [n for n in os.listdir(root) if n.endswith("_tmp")]
    gc_checkpoints(root)
    step, out = restore_latest(root)
    assert step == 1 and not any(n.endswith("_tmp") for n in os.listdir(root))
    np.testing.assert_array_equal(out["a"], np.arange(32))


def test_restore_fallback_skips_corrupt_newest(tmp_path, caplog):
    root = str(tmp_path)
    save_checkpoint(root, 1, **_tiny())
    save_checkpoint(root, 2, a=np.arange(5), b={"x": np.ones(2, np.float32)})
    _corrupt_payload(os.path.join(root, step_dirname(2)))
    with pytest.raises(CheckpointCorruptError, match="digest mismatch"):
        verify_checkpoint(os.path.join(root, step_dirname(2)))
    with caplog.at_level(logging.WARNING, logger="dcg.checkpoint"):
        assert latest_step(root, verified=True) == 1
        step, out = restore_latest(root)
    assert step == 1
    np.testing.assert_array_equal(out["a"], _tiny()["a"])
    assert any("digest mismatch" in r.message for r in caplog.records)
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(root, 2)


def test_uncommitted_dir_rejected(tmp_path):
    root = str(tmp_path)
    d = os.path.join(root, step_dirname(7))
    os.makedirs(d)
    open(os.path.join(d, "junk"), "w").write("x")
    with pytest.raises(CheckpointCorruptError, match="uncommitted"):
        verify_checkpoint(d)
    d2 = save_checkpoint(root, 8, **_tiny())
    os.remove(os.path.join(d2, "COMMIT"))
    with pytest.raises(CheckpointCorruptError, match="no COMMIT marker"):
        verify_checkpoint(d2)
    assert latest_step(root, verified=True) is None


@pytest.mark.parametrize("edit,match", [
    ({"schema_version": 99}, "newer than this reader"),
    # the JAX package's orbax store: another schema, not interchangeable
    ({"schema": "dcg.ckpt_manifest.v1"}, "not interchangeable"),
])
def test_manifest_of_newer_or_other_schema_refused(tmp_path, edit, match):
    d = save_checkpoint(str(tmp_path), 1, **_tiny())
    man_path = os.path.join(d, "manifest.json")
    man = json.load(open(man_path))
    man.update(edit)
    json.dump(man, open(man_path, "w"))
    with pytest.raises(CheckpointCorruptError, match=match):
        verify_checkpoint(d)


def test_gc_retention_keeps_newest_verified(tmp_path):
    root = str(tmp_path)
    for s in (1, 2, 3, 4):
        save_checkpoint(root, s, **_tiny())
    os.makedirs(os.path.join(root, "step_0000000008_tmp"))
    _corrupt_payload(os.path.join(root, step_dirname(4)))
    rep = gc_checkpoints(root, keep=2)
    assert rep["swept"] == ["step_0000000008_tmp"]
    assert rep["pruned"] == [step_dirname(1)]
    assert rep["corrupt"] == [step_dirname(4)]
    assert steps(root) == [2, 3, 4]
    rep2 = gc_checkpoints(root, keep=2, prune_corrupt=True)
    assert steps(root) == [2, 3] and rep2["corrupt"] == [step_dirname(4)]


def test_metadata_records_run_identity(tmp_path):
    from distributed_cluster_gpus_tpu_torch.configs.paper import build_duo_fleet
    from distributed_cluster_gpus_tpu_torch.rl.train import _ckpt_metadata

    fleet = build_duo_fleet()
    params = SimParams(algo="chsac_af", duration=30.0, seed=9,
                       time_dtype="float64")
    meta = _ckpt_metadata(fleet, params, config_fingerprint(fleet, params), 5)
    assert meta["seed"] == 9 and meta["chunk"] == 5 and meta["algo"] == "chsac_af"
    assert meta["time_dtype"] == "float64" and meta["chaos"] is None
    assert meta["params_fingerprint"].startswith("sha256:")
    d = save_checkpoint(str(tmp_path), 5, metadata=meta, **_tiny())
    assert verify_checkpoint(d)["metadata"] == meta


def test_config_fingerprint_stable_and_sensitive():
    from distributed_cluster_gpus_tpu_torch.configs.paper import (
        build_duo_fleet, build_fleet)

    p1 = SimParams(algo="joint_nf", duration=60.0, seed=4)
    p2 = SimParams(algo="joint_nf", duration=60.0, seed=4)
    assert config_fingerprint(p1) == config_fingerprint(p2)
    assert config_fingerprint(p1) != config_fingerprint(
        SimParams(algo="joint_nf", duration=60.0, seed=5))
    assert config_fingerprint(p1) != config_fingerprint(
        SimParams(algo="joint_nf", duration=60.0, seed=4, time_dtype="float64"))
    assert config_fingerprint(build_duo_fleet(), p1) == config_fingerprint(
        build_duo_fleet(), p2)
    assert config_fingerprint(build_duo_fleet(), p1) != config_fingerprint(
        build_fleet(), p1)
    assert config_fingerprint(np.arange(4)) != config_fingerprint(
        np.arange(4, dtype=np.float32))
    assert config_fingerprint(torch.arange(4)) == config_fingerprint(np.arange(4))


def test_interrupted_resave_swap_recovers(tmp_path):
    """A crash between the re-save swap's two renames never loses the
    committed step: gc rolls the swap forward when the staging dir carries
    a full commit, back otherwise, and sweeps a stale swap."""
    t_old = {"a": np.arange(4), "b": {"x": np.zeros(2, np.float32)}}
    t_new = {"a": np.arange(9), "b": {"x": np.ones(2, np.float32)}}

    def make_interrupted_swap(root, staged_committed):
        save_checkpoint(root, 1, **t_old)
        final = os.path.join(root, step_dirname(1))
        os.rename(final, final + "_swap")
        d = save_checkpoint(root, 1, **t_new)
        os.rename(d, final + "_tmp")
        if not staged_committed:
            os.remove(os.path.join(final + "_tmp", "COMMIT"))

    r1 = str(tmp_path / "fwd")
    make_interrupted_swap(r1, staged_committed=True)
    assert steps(r1) == []
    rep = gc_checkpoints(r1)
    assert rep["recovered"] and "promoted" in rep["recovered"][0]
    np.testing.assert_array_equal(restore_checkpoint(r1, 1)["a"], t_new["a"])
    assert not any(n.endswith(("_tmp", "_swap")) for n in os.listdir(r1))

    r2 = str(tmp_path / "back")
    make_interrupted_swap(r2, staged_committed=False)
    rep = gc_checkpoints(r2)
    assert rep["recovered"] and "restored" in rep["recovered"][0]
    np.testing.assert_array_equal(restore_checkpoint(r2, 1)["a"], t_old["a"])
    assert not any(n.endswith(("_tmp", "_swap")) for n in os.listdir(r2))

    r3 = str(tmp_path / "stale")
    save_checkpoint(r3, 1, **t_old)
    os.makedirs(os.path.join(r3, step_dirname(1) + "_swap"))
    assert step_dirname(1) + "_swap" in gc_checkpoints(r3)["swept"]
    assert latest_step(r3, verified=True) == 1


def test_fsck_clean_store_passes(tmp_path, capsys):
    root = str(tmp_path)
    save_checkpoint(root, 1, **_tiny())
    save_checkpoint(root, 2, **_tiny())
    assert fsck_main([root]) == 0
    out = capsys.readouterr().out
    assert out.count("PASS:") == 2 and "checkpoint store OK" in out


def test_fsck_flags_corruption_and_debris(tmp_path, capsys):
    root = str(tmp_path)
    save_checkpoint(root, 1, **_tiny())
    save_checkpoint(root, 2, **_tiny())
    _corrupt_payload(os.path.join(root, step_dirname(2)))
    os.makedirs(os.path.join(root, "step_0000000009_tmp"))
    os.makedirs(os.path.join(root, "step_5"))
    assert fsck_main([root]) == 1
    err = capsys.readouterr().err
    assert "digest mismatch" in err
    assert "stranded staging debris" in err
    assert "lenient step-like name" in err
    # --gc sweeps the staging debris; the corruption still fails
    assert fsck_main([root, "--gc"]) == 1
    assert not os.path.isdir(os.path.join(root, "step_0000000009_tmp"))
    assert fsck_main([str(tmp_path / "none")]) == 1


def test_warm_sac_from_checkpoint_grafts_policy_only(tmp_path):
    """A policy-only warm start across critic architectures: the donor's
    encoder and actor carry over (bf16 shadows refilled), the critic, the
    temperature and the step stay fresh."""
    from distributed_cluster_gpus_tpu_torch import bridge
    from distributed_cluster_gpus_tpu_torch.ops import prng
    from distributed_cluster_gpus_tpu_torch.rl.cmdp import default_constraints
    from distributed_cluster_gpus_tpu_torch.rl.sac import SACConfig, sac_init
    from distributed_cluster_gpus_tpu_torch.rl.train import (
        warm_sac_from_checkpoint)

    small = dict(obs_dim=13, n_dc=2, n_g=4, latent=32, n_quantiles=8,
                 constraints=default_constraints())
    dcfg = SACConfig(critic_arch="heads", **small)
    donor = sac_init(dcfg, prng.key(7, "cpu"), "cpu")
    save_checkpoint(str(tmp_path), 3, sac=bridge.sac_to_numpy(dcfg, donor))
    cfg = SACConfig(critic_arch="onehot", **small)
    warm = warm_sac_from_checkpoint(cfg, str(tmp_path), prng.key(8, "cpu"),
                                    device="cpu")
    fresh = sac_init(cfg, prng.key(8, "cpu"), "cpu")
    for g in ("enc", "actor"):
        assert torch.equal(warm.flat[g], donor.flat[g])
        assert torch.equal(warm.shadow[g], donor.flat[g].to(torch.bfloat16))
    assert torch.equal(warm.flat["critic"], fresh.flat["critic"])
    assert torch.equal(warm.log_alpha, fresh.log_alpha) and warm.step == 0
