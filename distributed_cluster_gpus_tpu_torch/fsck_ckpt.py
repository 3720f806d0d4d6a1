"""Offline verifier of the port's checkpoint stores.

    python -m distributed_cluster_gpus_tpu_torch.fsck_ckpt CKPT_DIR \\
        [CKPT_DIR2 ...] [--fast] [--gc] [--keep N]

Counterpart of the repo's ``scripts/fsck_ckpt.py`` for the port's store
(``utils/checkpoint.py``).  One PASS/FAIL line per finding; exits 0 only
when every committed checkpoint verifies and no crash debris is stranded:

* every ``step_*`` directory must carry a committed manifest whose
  per-file sha256 digests match the payload (``--fast`` skips the content
  re-hash: structure and commit checks only);
* stranded staging dirs (``step_*_tmp``) are crash debris, reported as
  FAIL (``--gc`` sweeps them through ``gc_checkpoints`` first and reports
  what it removed), as is an interrupted re-save swap (``step_*_swap``);
* step-like names the strict ``step_<10 digits>`` rule rejects
  (``step_5``) are reported: resume would never read them.

The forensic ``aborted/`` bundle and population roots wait for the modules
that write them (ROADMAP queue A items 12 and 15).
"""

from __future__ import annotations

import argparse
import os
import re
import sys

_LENIENT = re.compile(r"^step_\d+")


def fsck_store(root: str, fast: bool = False):
    """(pass lines, fail lines) for one store directory."""
    from .utils.checkpoint import (CheckpointCorruptError, _STEP_RE,
                                   _is_debris, step_dirname, steps,
                                   verify_checkpoint)

    ok, bad = [], []
    if not os.path.isdir(root):
        return ok, [f"{root}: not a directory"]
    committed = steps(root)
    for step in committed:
        d = os.path.join(root, step_dirname(step))
        try:
            man = verify_checkpoint(d, digests=not fast)
        except CheckpointCorruptError as e:
            bad.append(str(e))
            continue
        ok.append(f"{d}: step {step} verified ({man.get('n_files', 0)} files, "
                  f"{man.get('total_bytes', 0)} bytes, schema "
                  f"v{man.get('schema_version')})")
    for name in sorted(os.listdir(root)):
        full = os.path.join(root, name)
        if name.endswith("_swap") and _STEP_RE.match(name[:-5]):
            bad.append(f"{full}: interrupted re-save swap (a crash between "
                       "the swap renames; recover with --gc or "
                       "gc_checkpoints: no committed data is lost)")
        elif _is_debris(name):
            bad.append(f"{full}: stranded staging debris (crash mid-save; "
                       "sweep with --gc or gc_checkpoints)")
        elif (os.path.isdir(full) and _LENIENT.match(name)
              and not _STEP_RE.match(name)):
            bad.append(f"{full}: lenient step-like name the strict "
                       "step_<10 digits> rule rejects: not a resumable "
                       "checkpoint")
    if not committed and not bad:
        bad.append(f"{root}: no committed checkpoints")
    return ok, bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stores", nargs="+", metavar="CKPT_DIR")
    ap.add_argument("--fast", action="store_true",
                    help="skip the per-file digest re-hash")
    ap.add_argument("--gc", action="store_true",
                    help="sweep stranded staging debris (and with --keep, "
                         "prune old verified steps) before reporting")
    ap.add_argument("--keep", type=int, default=0,
                    help="with --gc: keep only the newest N verified steps")
    args = ap.parse_args(argv)
    from .utils.checkpoint import gc_checkpoints

    rc = 0
    for root in args.stores:
        if args.gc:
            rep = gc_checkpoints(root, keep=args.keep or None)
            for name in rep["recovered"]:
                print(f"gc: recovered {os.path.join(root, name)}")
            for name in rep["swept"]:
                print(f"gc: swept {os.path.join(root, name)}")
            for name in rep["pruned"]:
                print(f"gc: pruned {os.path.join(root, name)}")
        ok, bad = fsck_store(root, fast=args.fast)
        for line in ok:
            print(f"PASS: {line}")
        for line in bad:
            print(f"FAIL: {line}", file=sys.stderr)
        if bad:
            rc = 1
    if rc == 0:
        print(f"checkpoint store OK: {len(args.stores)} store(s) verified")
    return rc


if __name__ == "__main__":
    sys.exit(main())
