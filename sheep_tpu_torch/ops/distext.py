"""Distributed out-of-core build: supervised ext legs + histogram
Allreduce + tournament forest merge (port of sheep_tpu/ops/distext.py).

The external-memory build (ops/extmem.py) streams one over-budget
``.dat`` on one host; the tournament supervisor (supervisor/) merges
independently-built forests associatively under retry/speculation/fsck.
This module is their composition, the path to graphs many times over
any single memory budget:

  shard    the whole-input ``.dat`` splits into N contiguous record
           slices (:func:`plan_shards` — the same floor arithmetic as
           partial loads, so slices are edge-disjoint and cover the
           file).  N comes from the planner (plan.plan_distext_legs over
           resources.governor.distext_leg_plan: ``SHEEP_DISTEXT_LEGS``
           pins it, else host cores / ``SHEEP_LEG_CORES`` cut to the
           aggregate budget).
  pass 1   one supervised ``hist`` leg per slice streams its range
           through its OWN block prefetcher
           (ops/extmem.range_degree_histogram) and publishes the
           per-range int64 degree histogram as a sealed, sidecar-first
           ``.hist`` artifact.  The supervisor's ``histsum`` leg is the
           Allreduce: integer adds commute, so the summed histogram —
           and the counting-sorted sequence it publishes — is
           bit-identical to the single-host pass.
  pass 2   one supervised ``distmap`` leg per slice runs the ext carry
           fold over its range (build_forest_extmem(start_edge,
           end_edge)) over the SHARED sequence, under its own
           ``SHEEP_MEM_BUDGET``, checkpointing at block boundaries with
           the slice folded into the checkpoint identity — a leg's
           checkpoint can never resume under a different shard map.
  merge    the per-leg partial forests k-way merge through the same
           tournament (``merge_trees --expect-sig``): the forest of
           edge-disjoint partial graphs over one sequence is the forest
           of the union, so the final tree is oracle-bit-identical.

The fault surface is the supervisor's: kill/EIO/ENOSPC at block
boundaries resolve inside a leg (the ext retry/checkpoint story), and at
leg boundaries (dispatch, publish, histogram merge, tournament rounds) by
retry/speculation/fsck with only dirty legs re-dispatched.

A transport priced (or pinned) to ``ship`` sends the legs to remote
worker daemons (``SHEEP_WORKER_ADDRS``, supervisor/remote.py) over the
serve tier's wire; ``local`` keeps them on this host.

Torch-free like ops/extmem (the supervisor parent must stay lean; each
leg's whole acceptance is peak RSS inside its budget).
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from ..integrity.errors import MalformedArtifact
from ..integrity.sidecar import checksummed_write, resolve_policy, verify_bytes
from ..resources.governor import (EXT_BLOCK_FLOOR, EXT_RECORD_BYTES,
                                  ResourceGovernor, distext_forced_legs)
from .extmem import dat_num_records

#: sealed per-range histogram artifact (one per pass-1 leg): the magic
#: line, five little-endian uint64 header words
#: (n, records, max_vid, start_edge, end_edge), then int64 deg[n]
HIST_MAGIC = b"sheep-hist 1\n"
_HIST_HEADER = np.dtype([("n", "<u8"), ("records", "<u8"),
                         ("max_vid", "<u8"), ("start", "<u8"),
                         ("end", "<u8")])


def write_histogram(path: str, deg: np.ndarray, records: int, max_vid: int,
                    start_edge: int, end_edge: int) -> None:
    """Seal one leg's per-range histogram, sidecar-first like every
    publish in the system.  ``deg`` is trimmed to ``max_vid + 1`` (the
    accumulator grows in pow2 steps; trailing zeros are not identity —
    two runs over the same range must produce byte-identical artifacts).
    """
    n = max_vid + 1 if records else 0
    deg = np.ascontiguousarray(deg[:n], dtype="<i8")
    head = np.zeros(1, dtype=_HIST_HEADER)
    head["n"], head["records"], head["max_vid"] = n, records, max_vid
    head["start"], head["end"] = start_edge, end_edge
    nbytes = len(HIST_MAGIC) + head.nbytes + deg.nbytes
    with checksummed_write(path, "wb", expect_bytes=nbytes,
                           extra={"range":
                                  f"{start_edge}:{end_edge}"}) as f:
        f.write(HIST_MAGIC)
        f.write(head.tobytes())
        f.write(deg.tobytes())


def read_histogram(path: str, integrity: str | None = None) -> dict:
    """Load + verify one ``.hist`` artifact: sidecar checksum, magic,
    exact length, int64 dtype, nonnegativity, and the structural
    invariants a well-formed range histogram always satisfies (every
    record adds exactly 2, the max vid really appears).  Raises
    MalformedArtifact on any corruption — this is also the ``sheep
    fsck`` checker's engine for ``.hist``."""
    mode = resolve_policy(integrity)
    with open(path, "rb") as f:
        data = f.read()
    verify_bytes(path, data, mode)
    if not data.startswith(HIST_MAGIC):
        raise MalformedArtifact(
            f"{path}: corrupt histogram — bad magic "
            f"(want {HIST_MAGIC!r})")
    off = len(HIST_MAGIC)
    if len(data) < off + _HIST_HEADER.itemsize:
        raise MalformedArtifact(
            f"{path}: corrupt histogram — {len(data)} bytes is too short "
            f"for the header")
    head = np.frombuffer(data, dtype=_HIST_HEADER, count=1, offset=off)[0]
    n = int(head["n"])
    want = off + _HIST_HEADER.itemsize + 8 * n
    if len(data) != want:
        raise MalformedArtifact(
            f"{path}: corrupt histogram — header claims n={n} "
            f"({want} bytes) but the file has {len(data)}")
    deg = np.frombuffer(data, dtype="<i8", count=n,
                        offset=off + _HIST_HEADER.itemsize)
    records = int(head["records"])
    start, end = int(head["start"]), int(head["end"])
    max_vid = int(head["max_vid"])
    problems = []
    if len(deg) and bool((deg < 0).any()):
        problems.append("negative degree count")
    if records != max(0, end - start):
        problems.append(f"records={records} != range length "
                        f"{max(0, end - start)} [{start}:{end})")
    if int(deg.sum()) != 2 * records:
        problems.append(f"degree total {int(deg.sum())} != 2 x {records} "
                        f"records (every record adds exactly 2)")
    if records and (max_vid >= n or deg[max_vid] <= 0):
        problems.append(f"max_vid {max_vid} has no degree")
    if problems:
        raise MalformedArtifact(
            f"{path}: corrupt histogram — " + "; ".join(problems))
    return {"deg": deg, "records": records, "max_vid": max_vid,
            "start": start, "end": end}


def merge_histograms(hists: list[dict],
                     expect_shards: list | None = None) -> np.ndarray:
    """The Allreduce: sum the per-range int64 histograms.  Integer adds
    commute, so the result is the whole-file histogram bit for bit (the
    counting sort over it is therefore the single-host sequence).

    ``expect_shards`` pins each histogram to its planned record slice —
    a stale artifact from a different shard map (or a reordered input
    list) is a refusal here, never a silently wrong sequence."""
    if expect_shards is not None:
        if len(hists) != len(expect_shards):
            raise MalformedArtifact(
                f"histogram merge: {len(hists)} histogram(s) for "
                f"{len(expect_shards)} planned shard(s)")
        for i, (h, (a, b)) in enumerate(zip(hists, expect_shards)):
            if (h["start"], h["end"]) != (int(a), int(b)):
                raise MalformedArtifact(
                    f"histogram merge: leg {i} covers "
                    f"[{h['start']}:{h['end']}) but the manifest's shard "
                    f"map says [{a}:{b}) — refusing a foreign shard map")
    n = max((len(h["deg"]) for h in hists), default=0)
    deg = np.zeros(n, dtype=np.int64)
    for h in hists:
        deg[: len(h["deg"])] += h["deg"]
    return deg


def plan_shards(num_records: int, legs: int) -> list[tuple[int, int]]:
    """N contiguous [start_edge, end_edge) record slices covering the
    file — the partial-load floor arithmetic (io/edges.partial_range),
    so slices are edge-disjoint, in order, and their union is exact."""
    if legs < 1:
        raise ValueError(f"legs {legs} must be >= 1")
    return [((i * num_records) // legs, ((i + 1) * num_records) // legs)
            for i in range(legs)]


def should_use_distext(path: str,
                       governor: ResourceGovernor | None = None) -> bool:
    """Should the build CLI route this graph through the distributed
    out-of-core job?  Yes when the operator forced a leg count
    (``SHEEP_DISTEXT_LEGS`` >= 2 — the env twin of ``--distext``), or
    when even the ext rung's single-leg stream cannot meet the budget:
    the fitted block has hit its floor and the floor-block stream still
    prices over the headroom, so the build must leave this process —
    every leg is a subprocess whose budget is its own, while the
    supervisor parent holds no O(n) state at all."""
    if not path.endswith(".dat"):
        return False
    if distext_forced_legs() >= 2:
        return True
    gov = governor if governor is not None else ResourceGovernor.from_env()
    head = gov.mem_headroom()
    if head is None:
        return False
    return EXT_RECORD_BYTES * EXT_BLOCK_FLOOR > head


def run_distext(graph: str, state_dir: str, config=None, runner=None,
                out_file: str | None = None, legs: int = 0):
    """Run (or resume) one distributed out-of-core build; returns the
    completed manifest.  Mirrors ``run_supervised``'s contract:
    ``state_dir`` holds the manifest, every artifact (per-range ``.hist``
    histograms, the shared sequence, per-leg partial trees, per-leg
    block checkpoints under ``ck-<key>/``), and worker logs; rerunning
    with the same dir fscks the survivors and re-dispatches only the
    dirty/missing legs.  ``legs`` pins the shard count (0 = the
    governor's planner / ``SHEEP_DISTEXT_LEGS``).

    Resume identity: the shard map persists in the manifest and a
    resumed run keeps it VERBATIM — a different forced leg count against
    an existing state dir is a refusal, not a replan (each leg's block
    checkpoint folds its record slice into its input_sig, so a foreign
    shard map could never publish anyway; the refusal is just earlier
    and clearer)."""
    from ..obs import trace as obs
    from ..resources import gc_orphan_temps
    from .. import supervisor as sup
    from ..supervisor.manifest import (load_manifest, manifest_path,
                                       plan_distext, save_manifest)
    from ..supervisor.supervise import (SupervisionFailed,
                                        TournamentSupervisor, reconcile,
                                        sweep_attempt_debris)

    config = config or sup.SupervisorConfig.from_env()
    if not graph.endswith(".dat"):
        raise SupervisionFailed(
            f"{graph}: distext shards binary .dat record streams only "
            f"(text parsing is not the beyond-RAM format)")
    os.makedirs(state_dir, exist_ok=True)
    gc_orphan_temps(state_dir)
    sweep_attempt_debris(state_dir)
    base = os.path.basename(graph)
    if base.endswith(".dat"):
        base = base[: -len(".dat")]
    prefix = os.path.join(state_dir, base)
    final = prefix + ".tre"

    gov = config.governor if config.governor is not None \
        else ResourceGovernor.from_env()
    forced = legs or distext_forced_legs()
    transport = None
    if os.path.exists(manifest_path(state_dir)):
        manifest = load_manifest(state_dir, config.integrity)
        size = os.path.getsize(graph) if os.path.exists(graph) else -1
        if manifest.graph != graph or manifest.graph_bytes != size:
            raise SupervisionFailed(
                f"{state_dir}: manifest belongs to a different build "
                f"({manifest.graph}, {manifest.graph_bytes} bytes; this "
                f"run: {graph}, {size} bytes) — refusing to resume; use "
                f"a fresh state dir")
        if manifest.shards is None:
            raise SupervisionFailed(
                f"{state_dir}: manifest is a plain tournament, not a "
                f"distext job — refusing to resume across job kinds")
        if forced and forced != len(manifest.shards):
            raise SupervisionFailed(
                f"{state_dir}: manifest shards the input across "
                f"{len(manifest.shards)} leg(s) but this run forces "
                f"{forced} — a checkpointed build never resumes under a "
                f"different shard map; use a fresh state dir")
        clean, dirty = reconcile(manifest,
                                 resolve_policy(config.integrity))
        config.events.append(("resume", clean, dirty))
    else:
        records = dat_num_records(graph)
        # the leg count routes through the planner: same
        # governor arithmetic, plus the provenance record — a forced
        # count (arg or SHEEP_DISTEXT_LEGS) is the operator's word
        from ..plan import plan_distext_legs, plan_transport
        plan = plan_distext_legs(governor=gov) if not forced else None
        n_legs = forced or plan["legs"]
        shards = plan_shards(records, n_legs)
        manifest = plan_distext(graph, prefix, final, shards,
                                config.reduction)
        transport = plan_transport(
            records, n_legs,
            len(getattr(config, "worker_addrs", None) or []))
        obs.event("distext.plan", legs=n_legs, records=records,
                  forced=bool(forced),
                  provenance=("forced" if forced
                              else plan["provenance"]),
                  block_edges=plan["block_edges"] if plan else None,
                  per_leg_peak_bytes=(plan["per_leg_peak_bytes"]
                                      if plan else None),
                  transport=transport["transport"],
                  transport_provenance=transport["provenance"],
                  workers=transport["remote_workers"])
        config.events.append(("distext-plan", n_legs, records))
    save_manifest(manifest, state_dir)
    worker_addrs = getattr(config, "worker_addrs", None) or []
    if transport is None:
        # resume path: the shard map is the manifest's, but the
        # transport decision is per-run — a resumed build prices (or
        # honors the pin) against TODAY's worker fleet
        from ..plan import plan_transport
        records = manifest.graph_bytes // EXT_RECORD_BYTES \
            if manifest.graph_bytes > 0 else 0
        transport = plan_transport(records, len(manifest.shards),
                                   len(worker_addrs))
    if worker_addrs and transport["transport"] == "ship":
        from ..supervisor.remote import RemoteRunner
        if runner is None:
            runner = sup.SubprocessRunner()
        if not getattr(runner, "remote", False):
            runner = RemoteRunner(
                worker_addrs, base=runner,
                beat_s=getattr(config, "worker_beat_s", 1.0))
    manifest = TournamentSupervisor(manifest, state_dir, config,
                                    runner).run()
    if out_file and out_file != manifest.final_tree:
        # export copy, sidecar first (the sheep_mv_artifact ordering)
        if os.path.exists(manifest.final_tree + ".sum"):
            shutil.copyfile(manifest.final_tree + ".sum",
                            out_file + ".sum")
        shutil.copyfile(manifest.final_tree, out_file)
    return manifest


def leg_checkpoint_dir(state_dir: str, key: str) -> str:
    """Where leg ``key``'s block-boundary checkpoints live (one dir per
    leg: two legs' ext folds must never share a snapshot file)."""
    return os.path.join(state_dir, f"ck-{key}")


def leg_perf_path(state_dir: str, key: str) -> str:
    """Where leg ``key``'s self-report lands (cli/distext ``--perf-out``):
    the leg's perf dict (read/fold overlap, strategies, retries) plus
    its own ``obs.metrics.proc_status`` capture (VmHWM/affinity), so a
    bench record can re-judge per-leg budgets and overlap from the
    record alone."""
    return os.path.join(state_dir, f"{key}.perf.json")


def apply_overlap_honesty(per_leg: dict, legs: int) -> bool:
    """The per-leg ``overlap_frac`` honesty rule: when the
    concurrent legs TIME-SHARE cores — the union of their affinity
    masks holds fewer cores than there are legs — a measured 0.0 is not
    "the prefetch never overlapped the fold", it is "the host could not
    have overlapped anything"; publishing the number invites a tuning
    conclusion the record cannot support.  Each affected leg row gets
    ``overlap_frac: None`` plus ``affinity_limited: True`` (the raw
    measurement survives under ``overlap_frac_raw`` so a reader can
    still see what the clock said).  Returns whether the rule fired;
    rows from hosts with enough distinct cores pass through untouched."""
    cores: set = set()
    for row in per_leg.values():
        aff = row.get("affinity_cores")
        if aff:
            cores.update(aff)
    limited = bool(per_leg) and bool(cores) and len(cores) < max(1, legs)
    if not limited:
        return False
    for row in per_leg.values():
        if "overlap_frac" in row:
            row["overlap_frac_raw"] = row["overlap_frac"]
            row["overlap_frac"] = None
        row["affinity_limited"] = True
    return True


__all__ = [
    "HIST_MAGIC",
    "apply_overlap_honesty",
    "leg_checkpoint_dir",
    "leg_perf_path",
    "merge_histograms",
    "plan_shards",
    "read_histogram",
    "run_distext",
    "should_use_distext",
    "write_histogram",
]
