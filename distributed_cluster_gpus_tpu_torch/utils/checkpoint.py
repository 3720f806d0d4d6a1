"""Durable, verified checkpoints of a run: named trees in a crash-safe store.

Counterpart of ``distributed_cluster_gpus_tpu/utils/checkpoint.py``: the
same store layout, commit protocol, verification, fallback chain and
retention, with the port's own payload format.

* **Payload.**  Each named tree (nested dicts whose leaves are numpy
  arrays, torch tensors or scalars: ``bridge.state_to_numpy``,
  ``bridge.sac_to_numpy``, ``bridge.replay_to_numpy``, a key, a byte
  watermark) is one ``<name>.npz`` whose keys are the leaves' paths, the
  dict keys joined by ``/`` (a bare leaf is stored under the empty path).
  It is written with ``np.savez`` and read with ``allow_pickle=False``, so
  loading a store never executes a pickle.  Device tensors are copied to
  the host on save; :func:`restore_checkpoint` returns numpy leaves, or
  tensors on the caller's ``device``.  The JAX package's store and this
  one are not interchangeable (a manifest of the other schema is
  refused); both hold the same trees under the same names.
* **Atomic commit.**  A save stages into ``step_<N>_tmp``, writes a
  ``manifest.json`` (schema version, per-file sha256 digests, run
  metadata), fsyncs, drops a ``COMMIT`` marker, and only then renames the
  staging dir to ``step_<N>``, all under
  :func:`~.shutdown.defer_signals`.  A process killed at any point leaves
  either the previous store plus ``*_tmp`` debris, or the committed new
  step, never a half-written ``step_*`` dir.
* **Verification.**  :func:`verify_checkpoint` re-hashes every payload file
  against the manifest; :func:`latest_step` has a ``verified=True`` mode
  and the restore paths walk a *fallback chain*: a corrupt or uncommitted
  step is skipped with a logged reason and the next older verified step
  restores instead.
* **Retention and debris.**  :func:`gc_checkpoints` recovers interrupted
  re-save swaps, removes staging debris and (optionally) prunes committed
  steps beyond a keep-last-N budget.
* **Crash injection.**  ``DCG_CKPT_CRASH_POINT`` (one of
  :data:`CRASH_POINTS`) makes a save crash at that phase:
  ``DCG_CKPT_CRASH_MODE=raise`` (default) raises
  :class:`CheckpointCrashInjected`, ``=kill`` SIGKILLs the process.

Schema-version policy: readers accept any ``schema_version <=
SCHEMA_VERSION``; a manifest from a newer version is refused with an
upgrade message.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import re
import shutil
import signal
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

SCHEMA = "dcg.torch_ckpt_manifest.v1"
SCHEMA_VERSION = 1
MANIFEST_FILE = "manifest.json"
COMMIT_FILE = "COMMIT"
PAYLOAD_EXT = ".npz"
#: the separator of a leaf's path in a payload's keys
SEP = "/"

#: committed checkpoint directories, strictly: ``step_`` + 10 digits;
#: staging dirs (``step_<N>_tmp``) and hand-made ``step_5``-style names
#: never parse
_STEP_RE = re.compile(r"^step_(\d{10})$")

#: save phases the crash-injection hook can crash after (in commit order):
#: payload staged, manifest written, COMMIT marker written (rename still
#: pending), and step renamed into place
CRASH_POINTS = ("staged", "manifest", "marker", "committed")

_log = logging.getLogger("dcg.checkpoint")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory failed verification (uncommitted, missing
    payload files, digest mismatch, another schema).  The fallback chain
    catches this and degrades to the next older step."""


class CheckpointCrashInjected(RuntimeError):
    """Deterministic crash raised by the DCG_CKPT_CRASH_POINT hook."""


def _crash_env() -> Tuple[Optional[str], str]:
    point = os.environ.get("DCG_CKPT_CRASH_POINT") or None
    mode = os.environ.get("DCG_CKPT_CRASH_MODE", "raise")
    if point is not None and point not in CRASH_POINTS:
        raise ValueError(
            f"DCG_CKPT_CRASH_POINT={point!r}: unknown injection point; "
            f"choices: {', '.join(CRASH_POINTS)}")
    if mode not in ("raise", "kill"):
        raise ValueError(f"DCG_CKPT_CRASH_MODE={mode!r}: raise or kill")
    return point, mode


def _maybe_crash(phase: str, want: Optional[str], mode: str) -> None:
    if want != phase:
        return
    if mode == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    raise CheckpointCrashInjected(
        f"injected crash after checkpoint phase {phase!r}")


# ---------------------------------------------------------------------------
# trees <-> flat {path: host array}
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype; save the "
                            "float32 masters (the shadows are derived)")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flatten_tree(tree: Any, path: str = "") -> Dict[str, np.ndarray]:
    """A tree as {leaf path: host numpy array}; dict keys are joined by
    :data:`SEP`, a bare leaf's path is ``""``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            k = str(k)
            if not k or SEP in k:
                raise ValueError(f"tree key {k!r} at {path!r}: keys must be "
                                 f"non-empty and free of {SEP!r}")
            out.update(flatten_tree(v, f"{path}{SEP}{k}" if path else k))
        return out
    return {path: _host(tree)}


def unflatten_tree(flat: Dict[str, Any]) -> Any:
    """The inverse of :func:`flatten_tree`."""
    if set(flat) == {""}:
        return flat[""]
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _check_like(name: str, got: Dict[str, np.ndarray], like: Any) -> None:
    """Raise ValueError unless the restored tree has ``like``'s leaves:
    the same paths, shapes and dtypes."""
    want = flatten_tree(like)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint tree {name!r} does not match the live "
                         f"layout: missing {missing[:5]}, unexpected "
                         f"{extra[:5]}")
    for path, w in want.items():
        g = got[path]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise ValueError(
                f"checkpoint tree {name!r} leaf {path!r}: saved "
                f"{g.dtype}{list(g.shape)}, the live run has "
                f"{w.dtype}{list(w.shape)}")


# ---------------------------------------------------------------------------
# store layout helpers
# ---------------------------------------------------------------------------

def step_dirname(step: int) -> str:
    return f"step_{step:010d}"


def _staging_name(step: int) -> str:
    return step_dirname(step) + "_tmp"


def _is_debris(name: str) -> bool:
    """Staging debris a crash can strand in a store directory."""
    return name.endswith("_tmp") and name.startswith("step_")


def steps(path: str) -> List[int]:
    """Committed step numbers under ``path``, ascending (strict names)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return []
    out = []
    for d in os.listdir(path):
        m = _STEP_RE.match(d)
        if m and os.path.isdir(os.path.join(path, d)):
            out.append(int(m.group(1)))
    return sorted(out)


def _hash_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return "sha256:" + h.hexdigest()


def _payload_files(ckpt_dir: str) -> Iterator[str]:
    """Relative (posix) paths of every payload file under ``ckpt_dir``:
    everything except the manifest and the commit marker."""
    for root, _dirs, files in os.walk(ckpt_dir):
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(root, f), ckpt_dir)
            rel = rel.replace(os.sep, "/")
            if rel in (MANIFEST_FILE, COMMIT_FILE):
                continue
            yield rel


def _fsync_dir(path: str) -> None:
    # a directory fsync makes the rename/create durable; some filesystems
    # refuse O_RDONLY dir fds (best effort: the manifest digests still
    # catch a torn commit on the read side)
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# fingerprinting (manifest metadata)
# ---------------------------------------------------------------------------

def config_fingerprint(*objs: Any) -> str:
    """Stable content digest of static run configuration objects.

    Canonicalizes dataclasses (field order), dicts (sorted keys),
    sequences, numpy arrays and tensors (dtype + shape + bytes) and falls
    back to ``repr`` for scalars.  Stamps checkpoints with the (fleet,
    params) identity, so a resume can refuse a store another configuration
    wrote (``SimParams.time_dtype`` included: a float32 store does not
    restore into a float64 run)."""
    h = hashlib.sha256()

    def feed(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            h.update(type(x).__name__.encode())
            for f in dataclasses.fields(x):
                h.update(f.name.encode())
                feed(getattr(x, f.name))
        elif isinstance(x, dict):
            h.update(b"{")
            for k in sorted(x, key=str):
                h.update(str(k).encode())
                feed(x[k])
            h.update(b"}")
        elif isinstance(x, (list, tuple)):
            h.update(b"[")
            for v in x:
                feed(v)
            h.update(b"]")
        elif isinstance(x, np.ndarray) or torch.is_tensor(x):
            a = _host(x)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(np.ascontiguousarray(a).tobytes())
        else:
            h.update(repr(x).encode())

    for o in objs:
        feed(o)
    return "sha256:" + h.hexdigest()[:32]


# ---------------------------------------------------------------------------
# save: stage -> manifest -> marker -> rename (the atomic commit)
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, step: int, metadata: Optional[Dict] = None,
                    **trees: Any) -> str:
    """Save named trees under ``path/step_<N>`` (e.g. sac=, replay=).

    Returns the committed checkpoint directory.  Device tensors are copied
    to the host first (one copy per leaf, before the critical section).

    The write is crash-consistent: each tree stages into ``step_<N>_tmp``
    as ``<name>.npz`` (fsynced), a ``manifest.json`` (schema version,
    per-file sha256 digests, ``metadata``) and a ``COMMIT`` marker are
    written and fsynced, and the staging dir renames into place as the
    last act; a crash at any point leaves no committed-but-partial step
    (``gc_checkpoints`` sweeps the stranded staging dir).  SIGTERM/SIGINT
    delivery is deferred across the whole critical section, so an
    operator's second signal cannot land mid-commit.  A failed write
    raises."""
    from .jsonio import clean_nan
    from .shutdown import defer_signals

    crash_point, crash_mode = _crash_env()
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, step_dirname(step))
    staging = os.path.join(path, _staging_name(step))
    host_trees = {name: flatten_tree(tree) for name, tree in trees.items()}
    with defer_signals():
        if os.path.isdir(staging):
            shutil.rmtree(staging)
        os.makedirs(staging)
        for name, flat in host_trees.items():
            with open(os.path.join(staging, name + PAYLOAD_EXT), "wb") as f:
                np.savez(f, **flat)
                f.flush()
                os.fsync(f.fileno())
        _maybe_crash("staged", crash_point, crash_mode)

        files = {}
        total = 0
        for rel in _payload_files(staging):
            full = os.path.join(staging, rel)
            files[rel] = _hash_file(full)
            total += os.path.getsize(full)
        manifest = {
            "schema": SCHEMA,
            "schema_version": SCHEMA_VERSION,
            "step": int(step),
            "trees": sorted(trees),
            "n_files": len(files),
            "total_bytes": int(total),
            "files": files,
            "metadata": metadata or {},
        }
        man_path = os.path.join(staging, MANIFEST_FILE)
        with open(man_path, "w") as f:
            json.dump(clean_nan(manifest), f, indent=2, default=float)
            f.flush()
            os.fsync(f.fileno())
        _maybe_crash("manifest", crash_point, crash_mode)

        marker = os.path.join(staging, COMMIT_FILE)
        with open(marker, "w") as f:
            f.write("committed\n")
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(staging)
        _maybe_crash("marker", crash_point, crash_mode)

        if os.path.isdir(final):
            # re-save of an existing step: a journal-style swap.  The old
            # committed dir moves to `step_<N>_swap` (not a `*_tmp` debris
            # name), so a crash between the two renames strands a
            # recoverable pair that `gc_checkpoints` rolls forward (staging
            # committed: promote) or back (restore the swap)
            old = final + "_swap"
            if os.path.isdir(old):
                shutil.rmtree(old)
            os.rename(final, old)
            os.rename(staging, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(staging, final)
        _fsync_dir(path)
        _maybe_crash("committed", crash_point, crash_mode)
    return final


# ---------------------------------------------------------------------------
# verify + fallback walk
# ---------------------------------------------------------------------------

def verify_checkpoint(ckpt_dir: str, digests: bool = True) -> Dict:
    """Check one checkpoint directory; return its manifest dict.

    Raises :class:`CheckpointCorruptError` when the directory is missing,
    has no manifest (uncommitted or torn; a checkpoint of the JAX
    package's older layout too), carries a manifest of another schema or of a newer
    schema version, has no COMMIT marker, or lists payload files that are
    absent or whose digest mismatches.  ``digests=False`` skips the content
    re-hash (structure checks only)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        raise CheckpointCorruptError(f"{ckpt_dir}: not a directory")
    man_path = os.path.join(ckpt_dir, MANIFEST_FILE)
    if not os.path.exists(man_path):
        raise CheckpointCorruptError(
            f"{ckpt_dir}: no {MANIFEST_FILE}: uncommitted or torn checkpoint")
    try:
        with open(man_path) as f:
            man = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"{ckpt_dir}: unreadable manifest: {e}") from e
    if man.get("schema") != SCHEMA:
        raise CheckpointCorruptError(
            f"{ckpt_dir}: unknown manifest schema {man.get('schema')!r} "
            f"(this store reads {SCHEMA}; the JAX package's store is "
            "not interchangeable with it)")
    if int(man.get("schema_version", 0)) > SCHEMA_VERSION:
        raise CheckpointCorruptError(
            f"{ckpt_dir}: manifest schema_version "
            f"{man.get('schema_version')} is newer than this reader "
            f"({SCHEMA_VERSION}); upgrade before restoring")
    if not os.path.exists(os.path.join(ckpt_dir, COMMIT_FILE)):
        raise CheckpointCorruptError(
            f"{ckpt_dir}: manifest present but no {COMMIT_FILE} marker: "
            "uncommitted checkpoint")
    for rel, want in man.get("files", {}).items():
        full = os.path.join(ckpt_dir, rel.replace("/", os.sep))
        if not os.path.exists(full):
            raise CheckpointCorruptError(
                f"{ckpt_dir}: payload file {rel} missing")
        if digests and _hash_file(full) != want:
            raise CheckpointCorruptError(
                f"{ckpt_dir}: payload file {rel} digest mismatch "
                "(bit rot or tampering)")
    return man


def _skip(ckpt_dir: str, reason: Exception) -> None:
    _log.warning("skipping checkpoint %s: %s", ckpt_dir, reason)


def verified_manifests(path: str) -> Iterator[Tuple[int, Dict]]:
    """Yield (step, manifest) of VERIFIED checkpoints newest-first, logging
    skipped ones: an uncommitted, torn or bit-rotted checkpoint is skipped
    with a logged reason instead of ending the resume."""
    path = os.path.abspath(path)
    for step in reversed(steps(path)):
        ckpt_dir = os.path.join(path, step_dirname(step))
        try:
            man = verify_checkpoint(ckpt_dir)
        except CheckpointCorruptError as e:
            _skip(ckpt_dir, e)
            continue
        yield step, man


def fallback_steps(path: str) -> Iterator[int]:
    """Yield VERIFIED step numbers newest-first (:func:`verified_manifests`
    without the manifests)."""
    for step, _ in verified_manifests(path):
        yield step


def latest_step(path: str, verified: bool = False) -> Optional[int]:
    """Newest committed step under ``path`` (None when the store is empty).
    ``verified=True`` digest-checks each candidate and skips uncommitted or
    corrupt directories (the mode every resume uses)."""
    if verified:
        return next(iter(fallback_steps(path)), None)
    all_steps = steps(path)
    return all_steps[-1] if all_steps else None


def _restore_dir(ckpt_dir: str, like: Optional[Dict[str, Any]],
                 device=None, names=None) -> Dict[str, Any]:
    saved = sorted(f[:-len(PAYLOAD_EXT)] for f in os.listdir(ckpt_dir)
                   if f.endswith(PAYLOAD_EXT))
    if like is not None:
        names = sorted(like)
    if names is not None:
        missing = sorted(set(names) - set(saved))
        if missing:
            raise KeyError(f"{ckpt_dir}: no saved tree {missing}")
        saved = sorted(names)
    names = saved
    out = {}
    for name in names:
        with np.load(os.path.join(ckpt_dir, name + PAYLOAD_EXT),
                     allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        if like is not None:
            _check_like(name, flat, like[name])
        if device is not None:
            flat = {k: torch.from_numpy(v).to(device) for k, v in flat.items()}
        out[name] = unflatten_tree(flat)
    return out


def restore_checkpoint(path: str, step: Optional[int] = None,
                       like: Optional[Dict[str, Any]] = None,
                       verify: bool = True,
                       device=None, names=None) -> Dict[str, Any]:
    """Restore the named trees saved by :func:`save_checkpoint`.

    Leaves are numpy arrays, or tensors on ``device`` when one is given.
    ``names`` restores only those trees.  ``like`` ({name: tree} of the
    live run's trees) restores only its names and raises ValueError unless
    every leaf has the live one's path, shape and dtype.

    ``step=None`` walks the verified fallback chain newest-first and
    restores the first checkpoint that passes verification (corrupt ones
    are skipped with a logged reason).  An explicit ``step`` restores
    exactly that step, verifying it first (``verify=False`` skips the
    digest re-hash when the caller already verified)."""
    path = os.path.abspath(path)
    if step is None:
        step, out = restore_latest(path, like=like, device=device,
                                   names=names)
        return out
    ckpt_dir = os.path.join(path, step_dirname(step))
    if verify:
        verify_checkpoint(ckpt_dir)
    return _restore_dir(ckpt_dir, like, device, names)


def restore_latest(path: str, like: Optional[Dict[str, Any]] = None,
                   device=None, names=None) -> Tuple[int, Dict[str, Any]]:
    """(step, restored trees) of the newest restorable checkpoint.

    Walks the verified fallback chain; a candidate that verifies but fails
    to read back (an I/O error mid-restore) is also skipped with a logged
    reason.  Raises FileNotFoundError when nothing under ``path`` restores.
    Structural mismatches (ValueError/KeyError from a ``like`` that does
    not match the saved layout) propagate: every older step shares them."""
    for step in fallback_steps(path):
        ckpt_dir = os.path.join(path, step_dirname(step))
        try:
            return step, _restore_dir(ckpt_dir, like, device, names)
        except OSError as e:
            _skip(ckpt_dir, e)
    raise FileNotFoundError(f"no restorable checkpoints under {path}")


# ---------------------------------------------------------------------------
# retention + debris sweep
# ---------------------------------------------------------------------------

def _recover_swaps(path: str, report: Dict[str, List[str]]) -> None:
    """Roll an interrupted re-save swap forward or back (never lose it).

    A crash between ``rename(step_N, step_N_swap)`` and
    ``rename(step_N_tmp, step_N)`` leaves no committed ``step_N`` but two
    recoverable dirs: the old committed payload in ``_swap`` and the new
    one (fully marked iff the commit reached the rename) in ``_tmp``.
    Promote the staging dir when it carries a manifest and a COMMIT marker,
    otherwise restore the swap: either way a committed ``step_N`` exists
    again before the debris sweep can touch the ``_tmp``."""
    for name in sorted(os.listdir(path)):
        if not (name.endswith("_swap") and _STEP_RE.match(name[:-5])):
            continue
        swap = os.path.join(path, name)
        final = os.path.join(path, name[:-5])
        staging = final + "_tmp"
        if os.path.isdir(final):
            # the swap completed (or a fresh save superseded it): stale copy
            shutil.rmtree(swap, ignore_errors=True)
            report["swept"].append(name)
            continue
        promoted = False
        if (os.path.exists(os.path.join(staging, MANIFEST_FILE))
                and os.path.exists(os.path.join(staging, COMMIT_FILE))):
            try:
                os.rename(staging, final)
                promoted = True
            except OSError:
                pass
        if promoted:
            shutil.rmtree(swap, ignore_errors=True)
            report["recovered"].append(f"{name} -> promoted staged re-save")
        else:
            os.rename(swap, final)
            report["recovered"].append(f"{name} -> restored prior commit")
        _log.warning("gc: recovered interrupted re-save swap %s", name)


def gc_checkpoints(path: str, keep: Optional[int] = None,
                   prune_corrupt: bool = False) -> Dict[str, List[str]]:
    """Clean a checkpoint store; returns a report of what happened.

    * ``recovered``: interrupted re-save swaps rolled forward or back
      (:func:`_recover_swaps`); always first, so the debris sweep never
      removes the only copy of a committed step.
    * ``swept``: stale staging debris (``step_*_tmp``), always removed.
    * ``pruned``: with ``keep=N``, committed steps older than the N newest
      verified ones (corrupt dirs never count toward the budget).
    * ``corrupt``: dirs that failed verification while filling the keep
      budget; removed only with ``prune_corrupt=True``.
    * ``kept``: the committed steps still present afterwards.

    Without ``keep``/``prune_corrupt`` the call is a pure sweep (no
    per-step verification), cheap enough after every save.  With
    retention, candidates are verified newest-first and the walk stops
    once ``keep`` verified steps are found; everything older is pruned
    unhashed.  Single-writer stores only: a concurrent writer's live
    staging dir would be swept."""
    path = os.path.abspath(path)
    report: Dict[str, List[str]] = {"recovered": [], "swept": [],
                                    "pruned": [], "corrupt": [], "kept": []}
    if not os.path.isdir(path):
        return report
    _recover_swaps(path, report)
    for name in sorted(os.listdir(path)):
        if _is_debris(name):
            shutil.rmtree(os.path.join(path, name), ignore_errors=True)
            report["swept"].append(name)
    if keep is not None and keep > 0:
        n_verified = 0
        for step in reversed(steps(path)):
            d = os.path.join(path, step_dirname(step))
            if n_verified >= keep:
                shutil.rmtree(d, ignore_errors=True)
                report["pruned"].append(step_dirname(step))
                continue
            try:
                verify_checkpoint(d)
            except CheckpointCorruptError as e:
                report["corrupt"].append(step_dirname(step))
                _log.warning("gc: corrupt checkpoint %s: %s", d, e)
                if prune_corrupt:
                    shutil.rmtree(d, ignore_errors=True)
                continue
            n_verified += 1
        report["pruned"].reverse()  # oldest first, like the store listing
        report["corrupt"].reverse()
    elif prune_corrupt:
        for step in steps(path):
            d = os.path.join(path, step_dirname(step))
            try:
                verify_checkpoint(d)
            except CheckpointCorruptError as e:
                report["corrupt"].append(step_dirname(step))
                _log.warning("gc: corrupt checkpoint %s: %s", d, e)
                shutil.rmtree(d, ignore_errors=True)
    report["kept"] = [step_dirname(s) for s in steps(path)]
    return report
