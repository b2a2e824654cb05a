"""Offline archive fsck: walk a hashed shard archive, verify CRCs
(counterpart of ``repro/launch/fsck.py``; the archives of both packages
share one format, so it checks either's).

``python -m repro_torch.launch.fsck <archive_root>`` runs
``data.hashed_dataset.verify_shard`` over every shard — recomputing
each file's CRC32 against the ``meta.json`` record (format v4+) —
and prints one line per shard.  Corrupt shards are reported with the
exact mismatching files and land in the in-process
``quarantined_shards`` registry; ``--quarantine`` additionally moves
the bad shard's files aside on disk (``<name>.quarantined``) so a
subsequent training run fails fast on a missing shard instead of
training on silently rotten bytes.

Exit codes: 0 = every shard verified (or archive predates checksums —
reported, nothing to check), 1 = at least one corrupt or unreadable
shard (a file missing or cut short), 2 = not an archive.  This is the
disk-side complement of the trainer's online retry/quarantine story:
run it from cron or before a long training job, the same way you would
fsck a filesystem you are about to trust.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

__all__ = ["fsck_archive", "main"]


def _shard_files(root: str, s: int) -> list:
    return sorted(glob.glob(os.path.join(root, f"hashed_{s:05d}.*")))


def _quarantine_files(root: str, s: int) -> list:
    moved = []
    for path in _shard_files(root, s):
        dst = path + ".quarantined"
        n = 1
        while os.path.exists(dst):
            dst = f"{path}.quarantined.{n}"
            n += 1
        os.rename(path, dst)
        moved.append(dst)
    return moved


def fsck_archive(root: str, *, quarantine: bool = False,
                 out=None) -> dict:
    """Verifies every shard of the archive at ``root``; returns
    ``{"shards", "verified", "unchecked", "corrupt", "quarantined"}``
    where ``corrupt`` maps shard id → the error message.  Prints to
    ``out`` (default: ``sys.stdout`` at the time of the call)."""
    out = sys.stdout if out is None else out
    from repro_torch.data.hashed_dataset import (
        ShardCorruptionError, _read_meta, verify_shard,
    )

    meta = _read_meta(root)
    n_shards = int(meta.get("shards", 0))
    report = {"shards": n_shards, "verified": 0, "unchecked": 0,
              "corrupt": {}, "quarantined": {}}
    if not meta.get("shard_checksums"):
        print(f"{root}: format v{meta.get('format_version')} archive "
              "predates per-shard checksums — nothing to verify",
              file=out)
        report["unchecked"] = n_shards
        return report
    for s in range(n_shards):
        try:
            got = verify_shard(root, s, meta)
        except ShardCorruptionError as e:
            report["corrupt"][s] = str(e)
            print(f"shard {s:5d}: CORRUPT — {e}", file=out)
            if quarantine:
                moved = _quarantine_files(root, s)
                report["quarantined"][s] = moved
                print(f"shard {s:5d}: quarantined "
                      f"{len(moved)} file(s)", file=out)
            continue
        except (OSError, ValueError) as e:
            # a missing file, or one cut short (a torn write: numpy cannot
            # parse it); the reference lets the ValueError escape
            # (ROADMAP C5)
            report["corrupt"][s] = f"unreadable: {e}"
            print(f"shard {s:5d}: UNREADABLE — {e}", file=out)
            continue
        if got is None:
            report["unchecked"] += 1
            print(f"shard {s:5d}: no recorded checksums", file=out)
        else:
            report["verified"] += 1
            print(f"shard {s:5d}: ok ({len(got)} files)", file=out)
    status = "CLEAN" if not report["corrupt"] else \
        f"{len(report['corrupt'])} CORRUPT"
    print(f"{root}: {report['verified']}/{n_shards} shards verified, "
          f"{report['unchecked']} unchecked — {status}", file=out)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.fsck",
        description="verify a hashed shard archive's recorded CRCs")
    ap.add_argument("root", help="archive directory (holds meta.json)")
    ap.add_argument("--quarantine", action="store_true",
                    help="move corrupt shards' files aside on disk")
    args = ap.parse_args(argv)
    if not os.path.exists(os.path.join(args.root, "meta.json")):
        print(f"{args.root}: not a hashed archive (no meta.json)",
              file=sys.stderr)
        return 2
    report = fsck_archive(args.root, quarantine=args.quarantine)
    return 1 if report["corrupt"] else 0


if __name__ == "__main__":
    sys.exit(main())
