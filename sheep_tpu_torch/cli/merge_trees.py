"""merge_trees: associative merge of .tre files (port of
sheep_tpu/cli/merge_trees.py; the reference's merge_trees.cpp:37-101).
``Loaded in: Nms`` / ``Built in: Nms`` grammar.

Integrity: inputs are verified on read (sidecar checksums +
structural hardening, io/trefile.py) and checked for merge COMPATIBILITY
before any zipping — trees of differing length, or carrying differing
input signatures in their sidecars (written by graph2tree's map phase),
come from different builds and merging them would produce a plausible-
looking but wrong tree.  Both refusals exit nonzero with a typed message.
"""

from __future__ import annotations

import getopt
import os
import sys

from ..core.facts import compute_facts
from ..core.forest import Forest, merge_forests
from ..integrity.errors import IncompatibleMerge, IntegrityError
from ..integrity.sidecar import read_sidecar
from ..io.trefile import read_tree, write_tree
from .common import PhaseClock, maybe_start_heartbeat, print_phase_ms


def check_merge_compatible(paths: list[str],
                           forests: list[Forest]) -> str | None:
    """Refuse incompatible merge inputs; returns the shared input
    signature (to stamp onto the merged output's sidecar), if any."""
    sizes = {len(f.parent) for f in forests}
    if len(sizes) > 1:
        detail = ", ".join(
            f"{os.path.basename(p)}:{len(f.parent)}"
            for p, f in zip(paths, forests))
        raise IncompatibleMerge(
            f"trees disagree on node count ({detail}) — partial trees "
            f"must share one sequence; refusing to merge")
    sigs = {}
    for p in paths:
        try:
            sc = read_sidecar(p)
        except IntegrityError:
            continue  # unreadable sidecar already warned at read time
        if sc and sc.get("sig"):
            sigs[p] = sc["sig"]
    distinct = set(sigs.values())
    if len(distinct) > 1:
        detail = ", ".join(f"{os.path.basename(p)}:{s[:12]}..."
                           for p, s in sigs.items())
        raise IncompatibleMerge(
            f"trees carry different input signatures ({detail}) — they "
            f"were built from different graphs/sequences; refusing to "
            f"merge")
    return next(iter(distinct), None)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    _hb = maybe_start_heartbeat()  # noqa: F841 — beats while we merge
    try:
        # --expect-sig: the tournament supervisor pins every merge to the
        # manifest's input signature, so a stale artifact from a different
        # build (or a speculative loser that raced a resume) can never be
        # zipped in even if its own sidecars agree with each other.
        opts, args = getopt.gnu_getopt(argv, "o:vkf", ["expect-sig="])
    except getopt.GetoptError as exc:
        o = (exc.opt or "?")[:1]
        if (exc.opt or "").startswith("expect-sig"):
            print(f"Option --{exc.opt}: {exc.msg}.")
            return 1
        if o == "o":
            print(f"Option -{o} requires a string.")
        else:
            print(f"Unknown option character '{o}'.")
        return 1

    output_filename = ""
    verbose = False
    do_faqs = False
    expect_sig = None
    for o, a in opts:
        if o == "-o":
            output_filename = a
        elif o == "-v":
            verbose = not verbose
        elif o == "-k":
            pass  # make_kids: kids are always derivable from parents here
        elif o == "-f":
            do_faqs = not do_faqs
        elif o == "--expect-sig":
            expect_sig = a

    if len(args) < 2:
        print("USAGE: merge_trees [options ...] first.tree second.tree")
        return 1

    clock = PhaseClock()
    # All positional trees merge in one associative pass (the reference
    # takes exactly two, which silently pins the scripts' REDUCTION to 2;
    # accepting k inputs makes any tournament fan-in correct).
    try:
        inputs = [Forest(*read_tree(a)) for a in args]
        sig = check_merge_compatible(args, inputs)
        if expect_sig is not None and sig is not None and sig != expect_sig:
            raise IncompatibleMerge(
                f"inputs carry signature {sig[:12]}... but the caller "
                f"expects {expect_sig[:12]}... — these trees belong to a "
                f"different build; refusing to merge")
    except IntegrityError as exc:
        print(f"merge_trees: {exc}", file=sys.stderr)
        return 1
    if verbose:
        print_phase_ms("Loaded", clock.phase_seconds())

    merged = merge_forests(*inputs)
    if output_filename:
        write_tree(output_filename, merged.parent, merged.pst_weight,
                   sig=sig)
    if verbose:
        print_phase_ms("Built", clock.phase_seconds())

    if do_faqs:
        compute_facts(merged).print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
