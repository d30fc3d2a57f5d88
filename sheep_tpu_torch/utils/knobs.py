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
    _K("SHEEP_OVERLAP_HANDOFF", "flag", "0",
       "stream",
       "legacy speculative-snapshot overlap arm (round 4/5 A/B)"),
    _K("SHEEP_OVERLAP_SLICE", "int", "262144",
       "stream",
       "links per async fetch slice of the overlap path"),
    _K("SHEEP_OVERLAP_MIN_MB", "int", "4",
       "stream",
       "minimum fetch size worth overlapping"),
    _K("SHEEP_OVERLAP_SPEC_FACTOR", "int", "8",
       "stream",
       "speculative-snapshot size factor of the legacy overlap arm"),
    # -- extmem ------------------------------------------------------------
    _K("SHEEP_EXT_BLOCK", "size", "524288 records",
       "extmem",
       "ext rung block size in edge records; pinning it is part of the "
       "checkpoint resume identity"),
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
    _K("SHEEP_HEARTBEAT_S", "float", "1",
       "supervisor",
       "worker heartbeat interval"),
    _K("SHEEP_HEARTBEAT_FILE", "path", "",
       "supervisor",
       "where a worker beats (set per attempt by the supervisor's runner)"),
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
    # -- dist --------------------------------------------------------------
    _K("SHEEP_COORDINATOR", "str", "",
       "dist",
       "jax.distributed coordinator address"),
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
