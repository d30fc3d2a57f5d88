"""Crash-safe incremental re-sequencing: the background job
that rebuilds sequence + tree + partition from the durable edge set when
sequence drift says the bootstrap-fixed order is now lying.

Repartition (serve/state.py) re-bins the EXISTING tree, so it can never
recover quality lost to inserts that landed outside the sequence —
pst-only vertices are invisible to the partitioner, and ECV(down) decays
monotonically under sustained insert load.  The fix is the paper's own
lever: re-run the degree order.  The serve tier already maintains the
degree histogram incrementally (two +1s per insert, parity-asserted
against a full recount), so pass 1 of the rebuild is a host counting
sort; pass 2 is the EXISTING streamed fold (ops/extmem.py) over the
``.dat`` records plus the WAL'd inserts as its tail block — the durable
edge source is exactly ``.dat + log``, so a rebuild is "the offline
build over what the state dir already persists".

**Phases, each durable before it runs** (the manifest is written
tmp+fsync+rename, the migration-manifest discipline)::

    hist   counting-sort sequence rebuild over the cut's histogram
    fold   streamed fold (extmem checkpoints at block boundaries)
    swap   pending tree artifact durable -> ticket-guarded atomic swap
           (later-started wins; queries serve stale-but-consistent)
    done   sealed snapshot under the NEW input signature; (gen, sig)
           appended to the manifest chain

kill -9 at any boundary resumes (or aborts) off the manifest: (durable
edges, cut) fully determine the rebuilt state, so a resumed rebuild is
bit-identical to an uninterrupted one.  The crash window between the
new-generation snapshot seal and the WAL swap leaves an old-sig log
beside a new-sig snapshot; ``ServeCore.open`` heals it ONLY when this
manifest sanctions the old->new transition and no log record lies past
the snapshot boundary — anything else is the torn mid-swap state
``sheep fsck`` refuses.

Replication: the swap is announced as a sequenced ``REPL RESEQ`` frame
and every later APPEND carries ``gen=``; a follower that missed the
frame trips the generation mismatch, re-handshakes, and adopts the
leader's new-generation snapshot (serve/replicate.py) — a mid-reseq
failover therefore serves either the old or the new generation, never a
half-swapped tree.  The adopting follower writes an ``adopt`` manifest
first, sanctioning its own crash windows.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np

from ..core.sequence import (degree_sequence_from_degrees,
                             host_degree_histogram)
from ..integrity.errors import IntegrityError, MalformedArtifact
from ..obs import trace as _obs
from ..runtime.snapshot import input_signature

MANIFEST_NAME = "reseq.json"
PENDING_NAME = "reseq-pending.npz"
CKPT_DIR = "reseq-ckpt"
MANIFEST_VERSION = 1
#: terminal phases; anything else is an in-flight rebuild
DONE_PHASES = ("done", "aborted")
#: completed (gen, sig) links the manifest chain retains
CHAIN_KEEP = 8


def manifest_path(state_dir: str) -> str:
    return os.path.join(state_dir, MANIFEST_NAME)


def pending_path(state_dir: str) -> str:
    return os.path.join(state_dir, PENDING_NAME)


def ckpt_dir(state_dir: str) -> str:
    return os.path.join(state_dir, CKPT_DIR)


def load_manifest(state_dir: str) -> dict | None:
    """The state dir's reseq manifest, or None when it never re-sequenced.
    An unparseable manifest raises (fsck's cue) — a torn write is
    impossible by the tmp+rename landing, so garbage means tampering or
    disk corruption, never a crash."""
    path = manifest_path(state_dir)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            man = json.load(f)
    except (OSError, ValueError) as exc:
        raise MalformedArtifact(f"{path}: unreadable reseq manifest "
                                f"({exc})")
    if not isinstance(man, dict) or "phase" not in man:
        raise MalformedArtifact(f"{path}: reseq manifest missing a phase")
    return man


def save_manifest(state_dir: str, man: dict) -> None:
    """Durable manifest landing: tmp + fsync + atomic rename (the
    migration-manifest discipline) — a crash leaves either the old
    manifest or the new one, never a tear."""
    path = manifest_path(state_dir)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(man, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(state_dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def active(state_dir: str) -> bool:
    """Is a re-sequence in flight in this state dir?  (Tenant eviction
    refuses while one is: sealing a mid-rebuild tenant out of memory
    would orphan the job.)"""
    try:
        man = load_manifest(state_dir)
    except IntegrityError:
        return True  # fsck's problem; do not evict over it
    return man is not None and man.get("phase") not in DONE_PHASES


def _sig_order(man: dict) -> list[str]:
    """Every signature the manifest vouches for, oldest first: the
    completed chain plus (once the swap phase is durable) the in-flight
    old->new link.  The in-flight link DEFINES the direction: a
    sanctioned gen ROLLBACK (the badrepl orphan adopting the surviving
    leader's older generation) re-orders new_sig after
    old_sig even when both already sit in the chain the other way
    around — so every crash window of the rollback heals through the
    same old->new gate as a forward adoption."""
    order = [c.get("sig") for c in man.get("chain", [])
             if isinstance(c, dict) and c.get("sig")]
    if man.get("phase") in ("swap", "adopt", "done"):
        old, new = man.get("old_sig"), man.get("new_sig")
        if old and old not in order:
            order.append(old)
        if new:
            if new in order:
                order.remove(new)
            order.append(new)
    return order


def sanctions_sig_change(state_dir: str, from_sig: str,
                         to_sig: str) -> bool:
    """Does the manifest sanction a WAL(from_sig) beside a
    snapshot(to_sig)?  True only for a planned sequence-generation step
    (from strictly older in the chain than to) — the gate
    ``ServeCore.open`` and ``sheep fsck`` apply before healing a sig
    mismatch instead of refusing it."""
    try:
        man = load_manifest(state_dir)
    except IntegrityError:
        return False
    if man is None:
        return False
    order = _sig_order(man)
    if from_sig in order and to_sig in order:
        return order.index(from_sig) < order.index(to_sig)
    return False


def chain_has_sig(state_dir: str, sig: str) -> bool:
    """Is ``sig`` a (possibly older) generation this state dir has ever
    served?  The replication HELLO uses it to tell a follower one
    generation behind (answer: snapshot bootstrap) from a foreign build
    input (answer: badrepl)."""
    try:
        man = load_manifest(state_dir)
    except IntegrityError:
        return False
    if man is None:
        return False
    order = _sig_order(man)
    for s in (man.get("old_sig"), man.get("new_sig")):
        if s and s not in order:
            order.append(s)
    return sig in order


def _append_chain(man: dict, gen: int, sig: str) -> None:
    chain = [c for c in man.get("chain", [])
             if isinstance(c, dict) and c.get("sig") != sig]
    chain.append({"gen": int(gen), "sig": sig})
    man["chain"] = chain[-CHAIN_KEEP:]


# -- the pending artifact ---------------------------------------------------


def _save_pending(state_dir: str, seq, parent, pst, cut: int,
                  gen: int, sig: str) -> None:
    """Land the rebuilt tree durably BEFORE the swap phase: the extmem
    checkpoints are cleared when the fold completes, so without this
    artifact a kill between fold-complete and swap would have nothing to
    resume from."""
    import zlib
    seq = np.ascontiguousarray(seq, dtype=np.uint32)
    parent = np.ascontiguousarray(parent, dtype=np.uint32)
    pst = np.ascontiguousarray(pst, dtype=np.uint32)
    crc = 0
    for arr in (seq, parent, pst):
        crc = zlib.crc32(arr.tobytes(), crc)
    path = pending_path(state_dir)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, seq=seq, parent=parent, pst=pst,
                 cut=np.int64(cut), gen=np.int64(gen), sig=np.str_(sig),
                 crc=np.int64(crc & 0xFFFFFFFF))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _load_pending(state_dir: str) -> dict:
    """Reload the pending tree; crc-verified, so a torn or tampered
    artifact raises (the resume path then refolds instead)."""
    import zlib
    path = pending_path(state_dir)
    try:
        with np.load(path) as z:
            pend = {"seq": z["seq"].copy(), "parent": z["parent"].copy(),
                    "pst": z["pst"].copy(), "cut": int(z["cut"]),
                    "gen": int(z["gen"]), "sig": str(z["sig"]),
                    "crc": int(z["crc"])}
    except Exception as exc:
        raise MalformedArtifact(f"{path}: unreadable reseq pending "
                                f"artifact ({type(exc).__name__}: {exc})")
    crc = 0
    for key in ("seq", "parent", "pst"):
        crc = zlib.crc32(np.ascontiguousarray(pend[key]).tobytes(), crc)
    if (crc & 0xFFFFFFFF) != pend["crc"]:
        raise IntegrityError(f"{path}: reseq pending artifact failed its "
                             f"crc — refusing the swap")
    return pend


def _cleanup(state_dir: str) -> None:
    try:
        os.unlink(pending_path(state_dir))
    except OSError:
        pass
    cdir = ckpt_dir(state_dir)
    if os.path.isdir(cdir):
        import shutil
        shutil.rmtree(cdir, ignore_errors=True)


# -- follower adoption sanctions --------------------------------------------


def write_adoption(state_dir: str, old_sig: str, old_gen: int,
                   new_sig: str, new_gen: int) -> None:
    """A follower about to adopt a re-sequenced leader snapshot writes
    this FIRST: it sanctions the sig change through every crash window
    of :meth:`ServeCore.reset_from_snapshot`."""
    try:
        man = load_manifest(state_dir)
    except IntegrityError:
        man = None
    if man is None:
        man = {"version": MANIFEST_VERSION, "chain": []}
    if not man.get("chain"):
        man["chain"] = [{"gen": int(old_gen), "sig": old_sig}]
    man.update(phase="adopt", old_sig=old_sig, new_sig=new_sig,
               old_gen=int(old_gen), new_gen=int(new_gen))
    save_manifest(state_dir, man)


def finish_adoption(state_dir: str, new_sig: str, new_gen: int) -> None:
    try:
        man = load_manifest(state_dir)
    except IntegrityError:
        return
    if man is None:
        return
    _append_chain(man, new_gen, new_sig)
    man["phase"] = "done"
    save_manifest(state_dir, man)


# -- the driver -------------------------------------------------------------


def _price(records: int, inserted: int, seq_drift: int) -> dict:
    from ..plan.model import plan_reseq
    from ..plan.priors import PriorStore
    return plan_reseq(records, inserted, seq_drift,
                      priors=PriorStore.from_env())


def run_reseq(core, force: bool = False, hub=None,
              events: list | None = None) -> dict:
    """One re-sequence attempt, start to finish: price it, make each
    phase durable, rebuild, swap, seal, announce.  Raises ServeKilled /
    exits at the injected ``reseq-*`` fault sites (serve/faults.py) —
    the kill-at-every-boundary sweep drives exactly this function."""
    events = events if events is not None else []
    info = core.reseq_begin()
    if info["graph_path"] is None:
        # no durable .dat: the WAL'd inserts alone cannot reproduce a
        # tree bootstrapped from -T/-s artifacts — refuse, don't destroy
        return {"skipped": 1, "reason": "no-durable-graph"}
    # the tentpole's parity gate: the incremental histogram must equal a
    # full recount before a rebuild is allowed to trust it
    if not core.degree_parity():
        raise IntegrityError(
            "incremental degree histogram diverged from the full "
            "recount — refusing to re-sequence off corrupt counters")
    plan = _price(len(core.edges_tail) if core.edges_tail is not None
                  else 0, info["cut"], info["seq_drift"])
    if not force and plan.get("decision") == "stay":
        events.append(("reseq-stay", plan.get("provenance")))
        return {"skipped": 1, "reason": "priced-stay", "plan": plan}

    state_dir = core.state_dir
    try:
        prev = load_manifest(state_dir)
    except IntegrityError:
        prev = None
    man = {"version": MANIFEST_VERSION, "phase": "hist",
           "cut": int(info["cut"]), "block": 0,
           "old_sig": info["old_sig"], "new_sig": "",
           "old_gen": int(info["seq_gen"]),
           "new_gen": int(info["seq_gen"]) + 1,
           "applied_seqno": int(info["applied_seqno"]),
           "plan": plan,
           "chain": (prev.get("chain") if prev else None)
           or [{"gen": int(info["seq_gen"]), "sig": info["old_sig"]}]}
    save_manifest(state_dir, man)
    return _drive(core, man, info["ticket"], hub=hub, events=events)


def resume_reseq(core, hub=None, events: list | None = None
                 ) -> dict | None:
    """Pick an interrupted re-sequence back up after a restart (daemon
    startup / the kill-sweep harness).  Resumes when the durable inputs
    still determine the rebuild; aborts cleanly (phase ``aborted``, old
    generation keeps serving) when they no longer do.  None = nothing
    pending."""
    events = events if events is not None else []
    state_dir = core.state_dir
    try:
        man = load_manifest(state_dir)
    except IntegrityError as exc:
        warnings.warn(f"serve: {exc}; ignoring the reseq manifest")
        return None
    if man is None or man.get("phase") in DONE_PHASES:
        return None
    if man.get("phase") == "adopt":
        # an interrupted follower adoption: either the snapshot landed
        # (we opened on the new generation) or it never did
        if core.seq_gen >= man.get("new_gen", 0):
            finish_adoption(state_dir, man.get("new_sig", ""),
                            man.get("new_gen", 0))
            return {"resumed": "adopt-finalize"}
        man["phase"] = "aborted"
        save_manifest(state_dir, man)
        return {"aborted": 1, "reason": "adoption-never-landed"}
    if core.seq_gen >= man.get("new_gen", 0):
        # the swap sealed before the crash; only the bookkeeping is left
        _append_chain(man, core.seq_gen, core.sig)
        man["phase"] = "done"
        save_manifest(state_dir, man)
        _cleanup(state_dir)
        return {"resumed": "finalize", "seq_gen": core.seq_gen}
    if (core.graph_path is None
            or man.get("cut", 0) > len(core.ins_tail)):
        man["phase"] = "aborted"
        save_manifest(state_dir, man)
        _cleanup(state_dir)
        warnings.warn("serve: aborted an unresumable re-sequence (durable "
                      "edge source changed under the manifest)")
        return {"aborted": 1, "reason": "unresumable"}
    ticket = core.reseq_begin()["ticket"]
    if man.get("phase") == "swap":
        try:
            return _swap_from_pending(core, man, ticket, hub=hub,
                                      events=events)
        except (IntegrityError, OSError) as exc:
            # pending artifact torn: fall back to refolding — (edges,
            # cut) still determine the same tree bit for bit
            events.append(("reseq-repend", str(exc)))
    return _drive(core, man, ticket, hub=hub, events=events)


def _drive(core, man: dict, ticket: int, hub=None,
           events: list | None = None) -> dict:
    """Phases hist -> fold -> swap -> done for one attempt (fresh or
    resumed: the manifest's cut pins the edge set either way)."""
    state_dir = core.state_dir
    cut = int(man["cut"])
    core._fire("reseq-hist")

    # -- hist: counting-sort sequence rebuild over the cut's histogram
    ins_t, ins_h = core.ins_slice(cut)
    if core.edges_tail is None:
        raise IntegrityError("re-sequence needs the graph edges resident "
                             "(the .dat is the durable edge source)")
    tail = np.concatenate([core.edges_tail, ins_t])
    head = np.concatenate([core.edges_head, ins_h])
    n = (int(max(tail.max(initial=0), head.max(initial=0))) + 1
         if len(tail) else 0)
    deg_at_cut = host_degree_histogram(tail, head, n)
    new_seq = degree_sequence_from_degrees(deg_at_cut)
    new_sig = input_signature(len(new_seq), new_seq)
    if man.get("new_sig") and man["new_sig"] != new_sig:
        man["phase"] = "aborted"
        save_manifest(state_dir, man)
        _cleanup(state_dir)
        raise IntegrityError(
            f"resumed re-sequence disagrees with its manifest (sig "
            f"{new_sig[:12]}... != pinned {man['new_sig'][:12]}...) — "
            f"the durable edge set changed; aborted")
    block = int(man.get("block") or 0) or core.governor.ext_fitted_block()
    man.update(phase="fold", new_sig=new_sig, block=block)
    save_manifest(state_dir, man)
    core._fire("reseq-fold")

    # -- fold: the streamed build over .dat + WAL'd inserts.  Checkpoints
    # land in the state dir; resume=True picks them up after a kill.
    # The span carries the fold's blob size so the PriorStore can
    # harvest MEASURED fold throughput for plan_reseq (the same loop
    # that teaches plan_build its rung seconds).
    graph_path = core.graph_path
    blob_bytes = (len(tail) + len(head)) * tail.itemsize \
        + len(new_seq) * new_seq.itemsize
    with _obs.span("reseq.fold", bytes=int(blob_bytes),
                   records=int(len(tail)), gen=int(man["new_gen"])):
        if graph_path and graph_path.endswith(".dat"):
            from ..ops.extmem import build_forest_extmem
            _, forest = build_forest_extmem(
                graph_path, block_edges=block, seq=new_seq,
                checkpoint_dir=ckpt_dir(state_dir), resume=True,
                governor=core.governor, events=events,
                tail_edges=(ins_t, ins_h))
        else:
            from ..core.forest import build_forest
            forest = build_forest(tail, head, new_seq,
                                  max_vid=max(n - 1, 0))
    parent, pst = forest.parent, forest.pst_weight

    # -- pending artifact durable, THEN the swap phase: the extmem
    # checkpoints are cleared on fold completion, so this artifact is
    # what a kill between here and the seal resumes from
    _save_pending(state_dir, new_seq, parent, pst, cut,
                  man["new_gen"], new_sig)
    man["phase"] = "swap"
    save_manifest(state_dir, man)
    return _swap_from_pending(core, man, ticket, hub=hub, events=events)


def _swap_from_pending(core, man: dict, ticket: int, hub=None,
                       events: list | None = None) -> dict:
    """Phase swap: partition the pending tree, swap it in under the
    ticket guard, seal the new generation durable, finish the manifest,
    announce to followers."""
    from ..core.forest import Forest
    from ..partition.tree_partition import (TreePartitionOptions,
                                            partition_forest)
    state_dir = core.state_dir
    pend = _load_pending(state_dir)
    if pend["sig"] != man.get("new_sig") or pend["gen"] != man["new_gen"]:
        raise IntegrityError(
            f"{pending_path(state_dir)}: pending artifact belongs to a "
            f"different rebuild (gen {pend['gen']}, sig "
            f"{pend['sig'][:12]}...) — refusing the swap")
    core._fire("reseq-swap")
    jparts = partition_forest(
        Forest(pend["parent"], pend["pst"]), core.num_parts,
        TreePartitionOptions(balance_factor=core.balance))
    res = core.reseq_swap(ticket, pend["cut"], pend["seq"],
                          pend["parent"], pend["pst"], jparts,
                          pend["sig"], pend["gen"])
    if res.get("stale"):
        return res  # a later-started rebuild already swapped; its
        # manifest supersedes this attempt's bookkeeping
    core._fire("reseq-seal")
    sealed = core.maybe_seal()
    _append_chain(man, pend["gen"], pend["sig"])
    man["phase"] = "done"
    save_manifest(state_dir, man)
    _cleanup(state_dir)
    if events is not None:
        events.append(("reseq-swap", pend["gen"], len(pend["seq"])))
    if hub is not None:
        try:
            hub.announce_reseq()
        except Exception as exc:  # announce is best-effort: gen= on
            # every later APPEND is the reliable resync trigger
            warnings.warn(f"serve: RESEQ announce failed ({exc})")
    res["sealed"] = 1 if sealed else 0
    return res
