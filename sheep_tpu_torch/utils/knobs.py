"""The ``SHEEP_*`` knob registry of the port (port of
sheep_tpu/utils/knobs.py).

Every knob the port reads (a quoted ``SHEEP_*`` literal in
``sheep_tpu_torch/`` or ``chip_smoke.py``, the native sources' ``getenv``
names included) is declared here once, with its value type, default,
owning subsystem and a one-line doc, each entry equal to the reference
registry's; tests/test_torch_knobs.py holds both directions (no read
missing here, no entry nothing reads).  ``python -m
sheep_tpu_torch.utils.knobs --markdown`` prints the table.

Value types: ``flag`` (0/1), ``int``, ``float``, ``str``, ``size``
(human sizes, ``512M``/``2G`` — resources.governor.parse_size), ``path``,
``plan`` (a fault-plan grammar), ``list`` (comma-separated specs).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Knob:
    name: str
    type: str
    default: str      # rendered default ("" = unset; prose is allowed)
    subsystem: str
    doc: str


_K = Knob

#: every SHEEP_* knob the port reads, grouped by subsystem
KNOBS: dict[str, Knob] = {k.name: k for k in [
    # -- plan --------------------------------------------------------------
    _K("SHEEP_PLAN_PRIORS", "path", "",
       "plan",
       "measured-prior store the planner folds into its cost model (learned "
       "from ladder.plan traces + bench records); unset = analytic model "
       "only"),
    # -- resources ---------------------------------------------------------
    _K("SHEEP_MEM_BUDGET", "size", "",
       "resources",
       "memory budget; the governor prices rungs/threads/blocks against it "
       "and refuses what cannot fit"),
    _K("SHEEP_DISK_BUDGET", "size", "",
       "resources",
       "cap on sheep-owned bytes under managed dirs; retention GC reclaims "
       "when tripped"),
    _K("SHEEP_SCRATCH_DIR", "path", "",
       "resources",
       "where the spill rung's scratch files live (fallback: checkpoint dir, "
       "then the system temp dir)"),
    _K("SHEEP_LEG_CORES", "int", "0",
       "resources",
       "CPU cores per supervised leg; caps concurrency, pins subprocess "
       "legs, and caps the native thread plan"),
    # -- runtime -----------------------------------------------------------
    _K("SHEEP_CHECKPOINT_DIR", "path", "",
       "runtime",
       "chunk-boundary checkpoint directory of the resilient build"),
    _K("SHEEP_RESUME", "flag", "0",
       "runtime",
       "resume from the checkpoint dir instead of starting fresh"),
    _K("SHEEP_MAX_RETRIES", "int", "3",
       "runtime",
       "per-dispatch (and per-leg) retry budget"),
    _K("SHEEP_BACKOFF_BASE", "float", "0.05",
       "runtime",
       "retry backoff base seconds (exponential, capped)"),
    _K("SHEEP_WATCHDOG_S", "float", "",
       "runtime",
       "per-dispatch watchdog; a dispatch stuck past this is treated as "
       "faulted"),
    _K("SHEEP_CHECKPOINT_EVERY", "str", "1",
       "runtime",
       "checkpoint cadence in boundaries; 'auto' tunes it from measured "
       "snapshot cost"),
    _K("SHEEP_PROMOTE_AFTER", "int", "16",
       "runtime",
       "healthy dispatches before a rung promotes back to the pipelined fast "
       "path (0 = never)"),
    _K("SHEEP_EDGES_PATH", "path", "",
       "runtime",
       "the whole-input .dat file; arms the ext rung for library/script "
       "builds"),
    _K("SHEEP_FAULT_INJECT", "plan", "",
       "runtime",
       "deterministic runtime fault plan kind@site:nth (chunk loops, "
       "boundaries)"),
    # -- integrity ---------------------------------------------------------
    _K("SHEEP_INTEGRITY", "str", "strict",
       "integrity",
       "artifact read policy: strict / repair / trust"),
    _K("SHEEP_SELFCHECK", "flag", "0",
       "integrity",
       "structural forest self-check after the parallel build"),
    _K("SHEEP_VALIDATE_LOOP", "flag", "0",
       "integrity",
       "exact per-vertex root-path validator (slow oracle) instead of the "
       "vectorized check"),
    # -- mesh --------------------------------------------------------------
    _K("SHEEP_WORKERS", "int", "devices",
       "mesh",
       "worker count of the fused SPMD build (default: visible devices)"),
    _K("SHEEP_MESH_KERNEL", "str", "chunked",
       "mesh", "mesh build kernel: chunked or fused"),
    _K("SHEEP_MESH_GATHER_TAIL", "flag", "1",
       "mesh", "gather the mesh tail for the replicated finish"),
    _K("SHEEP_MESH_GATHER_FACTOR", "float", "2.0",
       "mesh", "live-links factor below which the mesh tail gathers"),
    _K("SHEEP_MESH_TAIL_SHARD", "flag", "1",
       "mesh", "shard the gathered tail by hi-quantile windows before "
       "the replicated finish"),
    _K("SHEEP_MESH_TAIL_SHARD_ROUNDS", "int", "5",
       "mesh", "max sharded tail rounds before falling back replicated"),
    _K("SHEEP_PIPELINE_CHUNKS", "flag", "1",
       "mesh",
       "pipelined (async) chunk dispatch in the chunk loops"),
    _K("SHEEP_PLATEAU_ADAPT", "flag", "1",
       "mesh",
       "plateau-adaptive chunk scheduler (j=1 late tiers + host straggler "
       "assist)"),
    _K("SHEEP_PLATEAU_FORCE", "flag", "0",
       "mesh",
       "force the plateau assist from round one (A/B arm)"),
    _K("SHEEP_PLATEAU_ASSIST_CAP", "int", "131072",
       "mesh",
       "max stragglers the host assist walks per round"),
    _K("SHEEP_VREMAP", "flag", "1",
       "mesh",
       "live-vertex remap compaction between chunk rounds"),
    # -- stream ------------------------------------------------------------
    _K("SHEEP_STREAM_HANDOFF", "flag", "1",
       "stream",
       "streaming windowed handoff for the hybrid tail"),
    _K("SHEEP_HANDOFF_WINDOWS", "int", "cpu 1 / accel 4",
       "stream",
       "hi-quantile window count W of the streamed handoff"),
    _K("SHEEP_HANDOFF_FACTOR", "int", "8",
       "stream",
       "live-links factor gating the handoff to the native tail"),
    _K("SHEEP_STREAM_DEVICE_WINDOWS", "flag", "0",
       "stream",
       "force the accelerator window-queue transfer path (tests/A-B on cpu)"),
    _K("SHEEP_STREAM_HOST_SEQ", "flag", "cpu 1",
       "stream",
       "host-native counting-sort degree sequence for the streaming hybrid"),
    _K("SHEEP_PACK_HANDOFF", "flag", "0",
       "stream",
       "pack (h<<32|lo) handoff records across serial+stream fetches"),
    _K("SHEEP_OVERLAP_SLICE", "int", "262144",
       "stream",
       "links per async fetch slice of the overlap path"),
    # -- extmem ------------------------------------------------------------
    _K("SHEEP_EXT_BLOCK", "size", "524288 records",
       "extmem",
       "ext rung block size in edge records; pinning it is part of the "
       "checkpoint resume identity"),
    _K("SHEEP_EXT_STRATEGY", "str", "priced",
       "extmem",
       "per-block fold strategy: edges / links (unset = the governor's "
       "priced pick)"),
    _K("SHEEP_DISTEXT_LEGS", "int", "0",
       "extmem",
       "pin the distributed out-of-core leg count (0 = the planner picks)"),
    # -- native ------------------------------------------------------------
    _K("SHEEP_NATIVE_BLOCKED", "flag", "1",
       "native",
       "cache-blocked quantile-bucketed native kernels"),
    _K("SHEEP_NATIVE_THREADS", "int", "planned",
       "native",
       "native kernel thread count T (the planner resolves it from effective "
       "cores; a pin is the operator's word)"),
    _K("SHEEP_NATIVE_OVERSUB", "flag", "0",
       "native",
       "let a forced T exceed granted cores (time-sharing opt-in; read by "
       "the C++ runtime)"),
    _K("SHEEP_NATIVE_THREAD_FLOOR", "size", "262144",
       "native",
       "problem size below which threading disengages (0 engages always; "
       "read by the C++ runtime)"),
    _K("SHEEP_NATIVE_TIME", "flag", "0",
       "native",
       "stderr phase timers inside the native kernels (dev observability; "
       "read by the C++ runtime)"),
    # -- supervisor --------------------------------------------------------
    _K("SHEEP_DEADLINE_S", "float", "30",
       "supervisor",
       "heartbeat wall-clock deadline; a worker silent past this is dead"),
    _K("SHEEP_STALE_POLLS", "int", "0",
       "supervisor",
       "declare a silent worker dead after this many consecutive beat-free "
       "supervisor polls instead of wall clock alone (deterministic under "
       "whole-process stalls; 0 = off)"),
    _K("SHEEP_HEARTBEAT_S", "float", "1",
       "supervisor",
       "worker heartbeat interval"),
    _K("SHEEP_HEARTBEAT_FILE", "path", "",
       "supervisor",
       "where a worker beats (set per attempt by the supervisor's runner)"),
    _K("SHEEP_SPECULATE_S", "float", "",
       "supervisor",
       "age at which a still-beating straggler gets a speculative twin "
       "(unset = off)"),
    _K("SHEEP_FAULT_PLAN", "plan", "",
       "supervisor",
       "deterministic tournament chaos kind@round:leg "
       "(kill/corrupt/hang/stop)"),
    # -- remote build workers (read for the transport decision; the
    # -- dispatch arm waits for the serving tier) -------------------------
    _K("SHEEP_WORKER_ADDRS", "list", "",
       "worker",
       "remote build workers host:port the distext supervisor may ship "
       "legs to (unset = local legs only)"),
    _K("SHEEP_WORKER_BEAT_S", "float", "1",
       "worker",
       "wire heartbeat interval for remote legs (BEAT frames; feeds the "
       "same staleness machinery as local .hb mtimes)"),
    _K("SHEEP_WORKER_SPECULATE_S", "float", "",
       "worker",
       "silent-wire age (since the last BEAT) at which a remote leg gets a "
       "speculative twin; first finisher wins (unset = generic "
       "SHEEP_SPECULATE_S only)"),
    _K("SHEEP_WORKER_TRANSPORT", "str", "",
       "worker",
       "pin the per-leg transport decision: ship / local (unset = the "
       "planner prices network-ship vs local-disk)"),
    # -- io ----------------------------------------------------------------
    _K("SHEEP_IO_FAULT_PLAN", "plan", "",
       "io",
       "deterministic I/O fault plan kind@site:nth over the write/read sites"),
    # -- obs ---------------------------------------------------------------
    _K("SHEEP_TRACE", "path", "",
       "obs",
       "flight-recorder JSONL path; unset = tracing off (no-op singletons)"),
    _K("SHEEP_TRACE_MAX_MB", "float", "0",
       "obs",
       "rotate the active trace to numbered .NNNN.trace segments past this "
       "size (0 = never)"),
    _K("SHEEP_TRACE_SAMPLE", "str", "1",
       "obs", "span sampling rate 1/N for per-request spans"),
    # -- serve daemon ------------------------------------------------------
    _K("SHEEP_SERVE_DEADLINE_S", "float", "",
       "serve", "default per-request deadline"),
    _K("SHEEP_SERVE_MAX_INFLIGHT", "int", "64",
       "serve", "admission cap; overload shed past it (inserts first)"),
    _K("SHEEP_SERVE_SNAP_EVERY", "int", "256",
       "serve", "snapshot seal cadence in applied inserts"),
    _K("SHEEP_SERVE_DRIFT", "float", "0.5",
       "serve", "cut-insert drift fraction triggering background "
       "repartition"),
    _K("SHEEP_SERVE_DRIFT_MIN", "int", "64",
       "serve", "minimum cut inserts before drift can trigger"),
    _K("SHEEP_SERVE_GROUP_COMMIT_MAX", "int", "256",
       "serve", "max records one shared group-commit fsync may cover; "
       "a full window seals immediately"),
    _K("SHEEP_SERVE_GROUP_COMMIT_DELAY_S", "float", "0.002",
       "serve", "max extra wait for companions before the group fsync "
       "(a lone insert never waits)"),
    _K("SHEEP_SERVE_FAULT_PLAN", "plan", "",
       "serve", "serve-layer fault plan kind@site:nth "
       "(kill/hang/slow at req/query/insert/gc-append/gc-unsynced/"
       "wal/apply and the reseq-hist/fold/swap/seal phase "
       "boundaries)"),
    _K("SHEEP_SERVE_TENANTS", "list", "",
       "serve", "tenant specs name=dir[:graph[:k]] behind one daemon"),
    _K("SHEEP_SERVE_MAX_RESIDENT", "int", "0",
       "serve", "max resident tenants; coldest evicts to sealed "
       "snapshot (0 = unlimited)"),
    # -- replication / failover --------------------------------------------
    _K("SHEEP_SERVE_ROLE", "str", "leader",
       "replicate", "process role: leader / follower"),
    _K("SHEEP_SERVE_PEERS", "list", "",
       "replicate", "peer specs (host:port or state dirs) for "
       "replication + failover polling"),
    _K("SHEEP_SERVE_NODE_ID", "str", "",
       "replicate", "stable node identity for elections and lag "
       "reporting"),
    _K("SHEEP_SERVE_REPL_ACKS", "int", "1",
       "replicate", "follower acks an insert OK requires beyond the "
       "leader fsync"),
    _K("SHEEP_SERVE_REPL_HB_S", "float", "1",
       "replicate", "replication stream heartbeat interval"),
    _K("SHEEP_SERVE_FAILOVER_S", "float", "5",
       "replicate", "silent-stream age at which followers elect"),
    _K("SHEEP_SERVE_MAX_LAG", "int", "0",
       "replicate", "bounded-staleness refusal for follower reads "
       "(0 = serve any lag)"),
    _K("SHEEP_SERVE_NETFAULT_PLAN", "plan", "",
       "replicate", "network fault plan drop/partition/slow/dup at "
       "the replication sites (repl/hb), the worker-wire sites "
       "(wleg/wbeat/wart), the migration sites (msnap/mdelta/mcut), "
       "and the re-sequence swap announcement (reseq)"),
    # -- router ------------------------------------------------------------
    _K("SHEEP_ROUTE_CLUSTERS", "list", "",
       "route", "cluster member lists the router hashes tenants "
       "across"),
    _K("SHEEP_ROUTE_VNODES", "int", "64",
       "route", "virtual nodes per cluster on the consistent-hash "
       "ring"),
    _K("SHEEP_ROUTE_RID", "str", "adaptive",
       "route", "rid stamping: always / never / adaptive (writes "
       "always; reads when recording)"),
    # -- live migration + rebalancer ---------------------------------------
    _K("SHEEP_MIGRATE_TIMEOUT_S", "float", "120",
       "migrate", "per-migration wall budget; past it the driver "
       "aborts cleanly back to the source (or finishes the remap if "
       "the cutover already landed)"),
    _K("SHEEP_MIGRATE_LAG_CUT", "int", "8",
       "migrate", "delta lag in records at or under which the driver "
       "enters the epoch-fenced cutover"),
    _K("SHEEP_MIGRATE_POLL_S", "float", "0.05",
       "migrate", "driver poll cadence while the delta lag drains"),
    _K("SHEEP_MIGRATE_RETRIES", "int", "8",
       "migrate", "wire-leg retry budget per migration RPC (each "
       "retry is a counted re-dispatch; exhausting it aborts)"),
    _K("SHEEP_REBALANCE", "flag", "0",
       "migrate", "router self-rebalancer: watch the fleet scrape and "
       "live-migrate the busiest tenant off a sustained-hot cluster"),
    _K("SHEEP_REBALANCE_INTERVAL_S", "float", "5",
       "migrate", "seconds between rebalancer fleet-scrape verdicts"),
    _K("SHEEP_REBALANCE_COOLDOWN_S", "float", "30",
       "migrate", "quiet period after a migration lands before the "
       "next is considered (anti-flap)"),
    _K("SHEEP_REBALANCE_HYSTERESIS", "float", "1.5",
       "migrate", "hot cluster must out-qps the coolest by this "
       "factor before a move is considered"),
    _K("SHEEP_REBALANCE_MIN_QPS", "float", "5",
       "migrate", "below this hot-cluster qps the fleet is quiet and "
       "every verdict holds"),
    _K("SHEEP_REBALANCE_PIN", "str", "",
       "migrate", "pin the rebalancer's pricing verdict: go / stay "
       "(unset = plan_migration prices the move)"),
    # -- re-sequencing -----------------------------------------------------
    _K("SHEEP_RESEQ", "flag", "1",
       "reseq", "background crash-safe re-sequence when the "
       "sequence-drift detector fires (0 = repartition-only drift "
       "handling)"),
    _K("SHEEP_RESEQ_DRIFT", "float", "0.25",
       "reseq", "fraction of post-cut inserts that are out-of-sequence "
       "(or degree-rank-moved) before a re-sequence triggers"),
    _K("SHEEP_RESEQ_DRIFT_MIN", "int", "256",
       "reseq", "minimum post-cut inserts before sequence drift can "
       "trigger"),
    _K("SHEEP_RESEQ_RANK", "int", "8",
       "reseq", "degree-rank displacement (in histogram buckets) past "
       "which an insert counts as sequence drift"),
    _K("SHEEP_RESEQ_PIN", "str", "",
       "reseq", "pin the re-sequence pricing verdict: go / stay "
       "(unset = plan_reseq prices the rebuild)"),
    _K("SHEEP_RESEQ_HORIZON_S", "float", "60",
       "reseq", "priced rebuild cost above this horizon stays (drift "
       "keeps accruing until forced or cheaper)"),
    # -- anti-entropy / scrubbing ------------------------------------------
    _K("SHEEP_SCRUB_VERIFY_N", "int", "256",
       "scrub", "VERIFY-frame cadence in applied records: the leader "
       "stamps a state-crc checkpoint into the replication stream "
       "every N records (0 = off); divergence is detected within one "
       "cadence"),
    _K("SHEEP_SCRUB_INTERVAL_S", "float", "0",
       "scrub", "background artifact-scrub period per daemon (0 = "
       "off; the SCRUB verb still runs one inline)"),
    _K("SHEEP_SCRUB_PACE_S", "float", "0",
       "scrub", "sleep between artifacts inside one scrub pass so the "
       "re-read never starves foreground I/O"),
    _K("SHEEP_SCRUB_PIN", "str", "",
       "scrub", "pin the background scrub pricing verdict: go / stay "
       "(unset = plan_scrub prices the pass)"),
    _K("SHEEP_SCRUB_HORIZON_S", "float", "30",
       "scrub", "priced re-verification cost above this horizon stays "
       "(the interval re-offers the pass later)"),
    _K("SHEEP_SCRUB_ALLOW_CORRUPT", "flag", "0",
       "scrub", "enable the CORRUPT verb (bench/test divergence "
       "injector that flips one live byte); production daemons refuse "
       "it unset"),
    # -- dist --------------------------------------------------------------
    _K("SHEEP_COORDINATOR", "str", "",
       "dist",
       "jax.distributed coordinator address"),
    _K("SHEEP_NUM_PROCESSES", "int", "",
       "dist", "process count of the multi-process mesh"),
    _K("SHEEP_PROCESS_ID", "int", "",
       "dist", "this process's index in the multi-process mesh"),
    _K("SHEEP_CONNECT_TIMEOUT", "float", "60",
       "dist", "coordinator connect timeout seconds"),
    # -- partition ---------------------------------------------------------
    _K("SHEEP_DDUP_GRAPH", "flag", "0",
       "partition",
       "deduplicate parallel edges like the reference's ddup tooling"),
    _K("SHEEP_EVAL_STREAM", "flag", "auto",
       "partition",
       "streamed (bounded-memory) partition evaluator; unset = auto by size"),
    _K("SHEEP_EVAL_STREAM_THRESHOLD", "int", "33554432",
       "partition",
       "edge count above which the evaluator streams"),
]}


def knob(name: str) -> Knob:
    return KNOBS[name]


def missing_from_registry(names) -> list[str]:
    """Knob names read somewhere but not declared here."""
    return sorted(set(names) - set(KNOBS))


def markdown_table() -> str:
    """The knob table, grouped by subsystem."""
    lines = ["| knob | type | default | subsystem | what it does |",
             "|---|---|---|---|---|"]
    for k in KNOBS.values():
        default = k.default if k.default != "" else "unset"
        lines.append(f"| `{k.name}` | {k.type} | {default} | "
                     f"{k.subsystem} | {k.doc} |")
    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> int:
    import sys
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--markdown":
        sys.stdout.write(markdown_table())
        return 0
    print("USAGE: python -m sheep_tpu_torch.utils.knobs --markdown")
    return 2


if __name__ == "__main__":
    import sys
    sys.exit(main())
