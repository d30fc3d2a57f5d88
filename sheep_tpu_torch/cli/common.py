"""Shared CLI plumbing (port of sheep_tpu/cli/common.py): phase timers
with the reference's stdout grammar, graph stats, the tree print, the
fault-tolerance options and the supervised worker's heartbeat.

The reference prints phase lines like ``Loaded graph in: 1.234000
seconds`` (graph2tree.cpp, %f formatting) and scripts parse them, so the
grammar is API.  Millisecond truncation matches
std::chrono::duration_cast<milliseconds>.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..runtime.config import RuntimeConfig
from ..supervisor.heartbeat import maybe_start_from_env


def maybe_start_heartbeat():
    """Start the worker heartbeat when a supervisor launched this process
    with SHEEP_HEARTBEAT_FILE in the environment (supervisor/heartbeat.py).
    Returns the writer (kept alive for the process lifetime) or None."""
    return maybe_start_from_env()


def maybe_init_distributed(device) -> int:
    """Join a multi-process job when the launcher asks for it: the
    reference's ``mpiexec`` across nodes (README:88-89,
    data/slurm-uk2007) is SHEEP_COORDINATOR=host:port plus
    SHEEP_NUM_PROCESSES / SHEEP_PROCESS_ID per process, joined through
    ``parallel.init_distributed`` (NCCL for a build on CUDA, gloo on the
    CPU).  Returns this process's rank (0 when not distributed) for
    leader gating, the reference's rank-0 logic (graph2tree.cpp:158-159).
    torch loads only when a coordinator is set."""
    coord = os.environ.get("SHEEP_COORDINATOR")
    if not coord:
        return 0
    from ..parallel.mesh import init_distributed
    num = os.environ.get("SHEEP_NUM_PROCESSES")
    pid = os.environ.get("SHEEP_PROCESS_ID")
    init_distributed(coordinator_address=coord,
                     num_processes=int(num) if num else None,
                     process_id=int(pid) if pid else None, device=device)
    import torch.distributed as dist
    return dist.get_rank()


def runtime_config_from_opts(opts):
    """Fold --checkpoint-dir DIR, --resume and --max-retries N, with their
    environment fallbacks (SHEEP_CHECKPOINT_DIR / SHEEP_RESUME /
    SHEEP_MAX_RETRIES), into a runtime.RuntimeConfig; None when no
    checkpoint dir is configured.  --resume / --max-retries without a
    checkpoint dir are a configuration error."""
    ckpt_dir = os.environ.get("SHEEP_CHECKPOINT_DIR") or None
    resume = os.environ.get("SHEEP_RESUME", "") == "1"
    max_retries = None
    for o, a in opts:
        if o == "--checkpoint-dir":
            ckpt_dir = a
        elif o == "--resume":
            resume = True
        elif o == "--max-retries":
            max_retries = int(a)
    if ckpt_dir is None:
        if resume or max_retries is not None:
            raise SystemExit(
                "--resume/--max-retries need --checkpoint-dir (or "
                "SHEEP_CHECKPOINT_DIR) to name the checkpoint location")
        return None
    overrides = {"checkpoint_dir": ckpt_dir, "resume": resume}
    if max_retries is not None:
        overrides["max_retries"] = max_retries
    return RuntimeConfig.from_env(**overrides)


class PhaseClock:
    """Elapsed-time phases with duration_cast<milliseconds> truncation."""

    def __init__(self):
        self.start = time.perf_counter()
        self.last = 0.0  # total at the previous phase boundary, in ms

    def _total_ms(self) -> int:
        return int((time.perf_counter() - self.start) * 1000)

    def phase_seconds(self) -> float:
        """Seconds since the previous phase boundary."""
        total = self._total_ms()
        out = (total - self.last) / 1000.0
        self.last = total
        return out

    def total_seconds(self) -> float:
        return self._total_ms() / 1000.0


def print_phase(label: str, seconds: float) -> None:
    print(f"{label} in: {seconds:f} seconds", flush=True)


def print_phase_ms(label: str, seconds: float) -> None:
    """merge_trees/degree_sequence style: ``Loaded in: 12ms``."""
    print(f"{label} in: {int(seconds * 1000)}ms", flush=True)


def graph_stats(edges) -> tuple[int, int]:
    """(nodes, edges) as the reference reports them: nodes = vertices with
    nonzero degree, edges = file records."""
    deg = edges.degrees()
    return int((deg > 0).sum()), edges.num_edges


def print_tree(seq: np.ndarray, parent: np.ndarray, pst: np.ndarray) -> None:
    """``graph2tree -t`` / JTree::print grammar (width:w pre:pre pst:pst
    -> [parent])."""
    for jnid in range(len(seq)):
        width = 1 + int(pst[jnid])
        print("%4d:%-8d%6d:w%6d:pre%6d:pst        ->[%4d]"
              % (jnid, int(seq[jnid]), width, 0, int(pst[jnid]),
                 int(np.uint32(parent[jnid]))))
