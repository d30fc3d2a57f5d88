"""sheep fsck: verify artifacts (or whole trial directories) and exit
nonzero on ANY corruption (port of sheep_tpu/cli/fsck.py).

    python -m sheep_tpu_torch.cli.fsck trial-dir/   # every artifact under it
    python -m sheep_tpu_torch.cli.fsck graph.dat out.tre ckpt/sheep-ckpt.npz
    python -m sheep_tpu_torch.cli.fsck -m repair damaged.net
    python -m sheep_tpu_torch.cli.fsck -R copied.tre  # reseal a lost sidecar

``-R`` / ``--repair-sidecar`` reseals the ``.sum`` sidecar of every
artifact that structurally verifies but whose sidecar is lost or wrong
(integrity.fsck.repair_sidecar).  Artifacts that fail their structural
checks are still reported FAIL, never resealed.  Artifacts of modules
the port has not ported yet (the serve daemon's ``.wal``/``.snap``, the
distext ``.hist`` and manifest, the scrub, reseq and quarantine chains)
are reported FAIL with the queue item they wait for.

Exit codes: 0 all clean (or resealed), 1 corruption found, 2 usage error.
"""

from __future__ import annotations

import getopt
import sys

from ..integrity.errors import IntegrityError
from ..integrity.fsck import (collect_artifacts, fsck_file, fsck_paths,
                              repair_sidecar)
from ..integrity.sidecar import POLICIES, read_sidecar

USAGE = ("USAGE: fsck [-q] [-m strict|repair|trust] [-R|--repair-sidecar] "
         "path [path ...]")


def _repair_run(args: list[str], quiet: bool) -> int:
    """The --repair-sidecar pass: verify strictly; on any failure (or a
    clean artifact with no sidecar to vouch for it) attempt a structural
    reseal.  Only artifacts that refuse to parse stay FAIL."""
    resealed = failures = checked = 0
    for root in args:
        targets = collect_artifacts(root)
        if not targets:
            print(f"FAIL {root}: no artifacts found")
            failures += 1
            continue
        for path in targets:
            checked += 1
            try:
                detail = fsck_file(path, "strict")
                missing = read_sidecar(path) is None
            except (IntegrityError, OSError):
                detail, missing = None, True
            if detail is not None and not missing:
                if not quiet:
                    print(f"OK   {path}: {detail}")
                continue
            try:
                summary = repair_sidecar(path)
                resealed += 1
                print(f"SEAL {path}: {summary} (sidecar resealed)")
            except (IntegrityError, OSError) as exc:
                failures += 1
                print(f"FAIL {path}: {exc}")
    print(f"fsck: {checked} artifact(s) checked, {resealed} resealed, "
          f"{failures} bad")
    return 1 if failures else 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts, args = getopt.gnu_getopt(argv, "qm:vR", ["repair-sidecar"])
    except getopt.GetoptError as exc:
        print(f"Unknown option character '{(exc.opt or '?')[:1]}'.")
        return 2

    quiet = False
    mode = None
    reseal = False
    for o, a in opts:
        if o == "-q":
            quiet = True
        elif o == "-m":
            if a not in POLICIES:
                print(f"fsck: -m {a!r} must be one of {'/'.join(POLICIES)}")
                return 2
            mode = a
        elif o == "-v":
            quiet = False
        elif o in ("-R", "--repair-sidecar"):
            reseal = True

    if not args:
        print(USAGE)
        return 2

    import warnings
    with warnings.catch_warnings():
        # repair-mode salvage warnings become part of the report lines
        warnings.simplefilter("ignore")
        if reseal:
            return _repair_run(args, quiet)
        results, failures = fsck_paths(args, mode)
    for path, ok, detail in results:
        if ok and not quiet:
            print(f"OK   {path}: {detail}")
        elif not ok:
            print(f"FAIL {path}: {detail}")
    checked = len(results)
    print(f"fsck: {checked} artifact(s) checked, {len(failures)} bad")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
