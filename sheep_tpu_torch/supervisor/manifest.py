"""The durable tournament manifest: what the supervisor knows, on disk
(port of sheep_tpu/supervisor/manifest.py; the same JSON, byte for byte).

One JSON file (``<state-dir>/manifest.json``) records the whole planned
map -> merge-tournament bracket and each leg's progress, sealed with the
same ``.sum`` sidecar every other artifact carries (integrity.sidecar) and
rewritten atomically after every state change.  A supervisor that dies
mid-tournament is therefore resumable by construction: the next supervisor
loads the manifest, **fscks** every artifact the manifest claims is done,
and re-dispatches only the legs whose artifacts are missing or dirty.

The bracket mirrors the reference's scripts/horizontal-dist.sh exactly
(same slot ownership, same ``{prefix}{NN}r{S}.tre`` artifact names):
round 0 is the map phase (one partial tree per worker over the shared
sequence), round ``s+1`` merges round ``s``'s trees with slot ``i``
owning inputs ``{i, i+W', i+2W', ...}`` where ``W' = ceil(W/reduction)``.
A one-input slot is a plain rename in the shell driver; here it is a
``copy`` leg the supervisor services itself.  The LAST leg's output is
the final tree path directly — there is no separate finalize step to
crash in the middle of.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field

from ..integrity.errors import MalformedArtifact
from ..integrity.sidecar import checksummed_write, verify_file

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1

#: leg lifecycle: pending -> done.  "running" is supervisor-local (an
#: attempt in flight), never persisted — a manifest read by a NEW
#: supervisor must treat any non-done leg as pending (the old attempt is
#: dead with its supervisor).
PENDING = "pending"
DONE = "done"

#: the round number of the distext histogram legs: they run
#: BEFORE the sort round (-1), which for a distext job is the
#: supervisor-serviced histogram merge
HIST_ROUND = -2


@dataclass
class Leg:
    """One unit of dispatchable work in the tournament."""

    key: str             # "sort", "r0.00", "r2.01", ...
    kind: str            # "sort" | "map" | "merge" | "copy"
    round: int           # -1 sort, 0 map, >= 1 merge rounds
    index: int           # slot within the round
    inputs: list[str]    # artifact paths consumed (empty for sort/map)
    output: str          # artifact path produced
    state: str = PENDING
    dispatches: int = 0  # attempts launched across ALL supervisor lives


@dataclass
class Manifest:
    """The durable state of one supervised tournament."""

    graph: str
    workers: int
    reduction: int
    seq_file: str          # the shared sequence every map leg reads
    final_tree: str
    graph_bytes: int       # guards resume against a swapped input file
    version: int = MANIFEST_VERSION
    sig: str | None = None  # input signature shared by every .tre artifact
    #: the distext shard map: one [start_edge, end_edge)
    #: record slice per leg, in leg-index order — None for a plain
    #: tournament.  Durable because it IS the resume identity: a leg's
    #: checkpoint folds its slice into its input_sig, so a manifest
    #: resumed under a different shard map could never publish anyway;
    #: persisting the map makes the refusal explicit and up-front.
    shards: list | None = None
    legs: list[Leg] = field(default_factory=list)

    def leg(self, key: str) -> Leg:
        for leg in self.legs:
            if leg.key == key:
                return leg
        raise KeyError(key)

    def pending(self) -> list[Leg]:
        return [leg for leg in self.legs if leg.state != DONE]

    def done(self) -> bool:
        return not self.pending()

    def rounds(self) -> dict[int, list[Leg]]:
        out: dict[int, list[Leg]] = {}
        for leg in self.legs:
            out.setdefault(leg.round, []).append(leg)
        return out


def tournament_rounds(workers: int, reduction: int) -> list[list[list[int]]]:
    """The merge bracket as input-index lists: ``rounds[s][i]`` is the list
    of round-``s`` tree indices merged by slot ``i`` of round ``s+1`` —
    the exact slot-ownership arithmetic of scripts/horizontal-dist.sh
    (STEP_SIZE / WORKERS / REDUCTION loop)."""
    if reduction < 2:
        raise ValueError(f"reduction {reduction} must be >= 2")
    rounds = []
    step_size = workers
    w = (workers + reduction - 1) // reduction
    while step_size != 1:
        rounds.append([list(range(i, step_size, w)) for i in range(w)])
        step_size = w
        w = (w + reduction - 1) // reduction
    return rounds


def plan_tournament(graph: str, prefix: str, final_tree: str, workers: int,
                    reduction: int, seq_file: str | None = None) -> Manifest:
    """Plan the full sort -> map -> merge-tournament leg graph.

    ``prefix`` names the intermediate artifacts (``{prefix}{NN}r{S}.tre``,
    ``{prefix}.seq``) — callers point it into the supervisor state dir so
    intermediates survive a trial-dir cleanup and a rerun can resume.
    ``seq_file``: an EXISTING sequence to build over (no sort leg planned);
    None plans a sort leg producing ``{prefix}.seq``.
    """
    if workers < 1:
        raise ValueError(f"workers {workers} must be >= 1")
    legs: list[Leg] = []
    if seq_file is None:
        seq_file = f"{prefix}.seq"
        legs.append(Leg(key="sort", kind="sort", round=-1, index=0,
                        inputs=[], output=seq_file))
    legs += _bracket_legs(prefix, final_tree, workers, reduction,
                          seq_file, "map")
    return Manifest(graph=graph, workers=workers, reduction=reduction,
                    seq_file=seq_file, final_tree=final_tree,
                    graph_bytes=_graph_bytes(graph), legs=legs)


def plan_distext(graph: str, prefix: str, final_tree: str,
                 shards: list, reduction: int) -> Manifest:
    """Plan the distributed out-of-core job: one ``hist`` leg
    per record shard (pass 1: the per-range degree histogram, a sealed
    ``.hist`` artifact), the supervisor-serviced ``histsum`` merge (the
    Allreduce: integer adds commute, so the summed histogram — and the
    counting-sorted sequence it publishes — is bit-identical to the
    single-host pass), one ``distmap`` leg per shard (pass 2: the ext
    pipeline over the range under the leg's own budget), then the
    SAME merge tournament every other tree takes.

    ``shards`` is the [start_edge, end_edge) record cover, one slice per
    leg; it persists in the manifest because it is the resume identity
    (Manifest.shards)."""
    if not shards:
        raise ValueError("distext needs at least one shard")
    legs: list[Leg] = []
    for i, (a, b) in enumerate(shards):
        legs.append(Leg(key=f"h.{i:02d}", kind="hist", round=HIST_ROUND,
                        index=i, inputs=[],
                        output=f"{prefix}{i:02d}.hist"))
    seq_file = f"{prefix}.seq"
    legs.append(Leg(key="sort", kind="histsum", round=-1, index=0,
                    inputs=[leg.output for leg in legs], output=seq_file))
    legs += _bracket_legs(prefix, final_tree, len(shards), reduction,
                          seq_file, "distmap")
    return Manifest(graph=graph, workers=len(shards), reduction=reduction,
                    seq_file=seq_file, final_tree=final_tree,
                    graph_bytes=_graph_bytes(graph),
                    shards=[[int(a), int(b)] for a, b in shards],
                    legs=legs)


def _graph_bytes(graph: str) -> int:
    try:
        return os.path.getsize(graph)
    except OSError:
        return -1


def _bracket_legs(prefix: str, final_tree: str, workers: int,
                  reduction: int, seq_file: str,
                  map_kind: str) -> list[Leg]:
    """The map + merge-tournament legs shared by the plain tournament
    (``map`` legs: partial in-RAM loads) and the distext job (``distmap``
    legs: streamed record slices) — identical bracket arithmetic, so the
    merge tournament cannot fork between them."""

    def tre(idx: int, rnd: int) -> str:
        return f"{prefix}{idx:02d}r{rnd}.tre"

    legs: list[Leg] = []
    rounds = tournament_rounds(workers, reduction) if workers > 1 else []
    for i in range(workers):
        # a 1-worker "tournament" maps straight into the final tree
        out = tre(i, 0) if rounds else final_tree
        legs.append(Leg(key=f"r0.{i:02d}", kind=map_kind, round=0, index=i,
                        inputs=[seq_file], output=out))
    for s, slots in enumerate(rounds):
        last = s == len(rounds) - 1
        for i, src in enumerate(slots):
            out = final_tree if last and i == 0 else tre(i, s + 1)
            legs.append(Leg(
                key=f"r{s + 1}.{i:02d}",
                kind="merge" if len(src) > 1 else "copy",
                round=s + 1, index=i,
                inputs=[tre(j, s) for j in src], output=out))
    return legs


def manifest_path(state_dir: str) -> str:
    return os.path.join(state_dir, MANIFEST_NAME)


def save_manifest(manifest: Manifest, state_dir: str) -> str:
    """Persist atomically + sealed: a supervisor killed mid-save leaves
    the previous complete manifest (and its matching sidecar) in place."""
    path = manifest_path(state_dir)
    with checksummed_write(path, "w") as f:
        f.write(json.dumps(asdict(manifest), indent=1, sort_keys=True))
        f.write("\n")
    return path


def load_manifest(state_dir: str, integrity: str | None = None) -> Manifest:
    """Load + verify the manifest.  Raises MalformedArtifact on a corrupt
    or wrong-version file — a supervisor must never resume off a manifest
    it cannot vouch for (the caller decides whether to replan fresh)."""
    path = manifest_path(state_dir)
    verify_file(path, integrity)
    try:
        with open(path, "r") as f:
            raw = json.load(f)
        if int(raw.get("version", -1)) != MANIFEST_VERSION:
            raise ValueError(f"manifest version {raw.get('version')} "
                             f"!= supported {MANIFEST_VERSION}")
        legs = [Leg(**leg) for leg in raw.pop("legs")]
        manifest = Manifest(legs=legs, **raw)
        for leg in manifest.legs:
            if leg.state not in (PENDING, DONE):
                # "running" from a dead supervisor, or garbage: both mean
                # "not provably complete" -> pending
                leg.state = PENDING
    except (ValueError, TypeError, KeyError, json.JSONDecodeError) as exc:
        raise MalformedArtifact(
            f"{path}: corrupt manifest ({type(exc).__name__}: {exc})")
    return manifest
