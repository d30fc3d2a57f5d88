"""The serve store (port of sheep_tpu/serve, its single-node part): the
tree and partition kept resident in a state dir, incremental edge
inserts folded in by the batch build's union-find transform through a
group-committed write-ahead log, so nothing acknowledged is lost, and
the crash-safe re-sequence job.  All of it is host code: it loads no
torch.

  wal.py        checksummed, fsync'd, epoch-stamped write-ahead log
  state.py      ServeCore: snapshot format, recovery (snapshot+replay),
                the incremental insert transform, queries, drift-
                triggered repartition, group commit, seqlock'd reads
  reseq.py      the crash-safe re-sequence job (``run_reseq``,
                ``resume_reseq``) and its manifest chain
  admission.py  slot + memory-pressure shedding (inserts shed first,
                read-only under pressure)
  protocol.py   the wire grammar + reference client
  faults.py     SHEEP_SERVE_FAULT_PLAN (kill/hang/slow @ request sites)
  netfaults.py  SHEEP_SERVE_NETFAULT_PLAN (drop/partition/slow/dup @
                replication frame sites; the grammar only)

This file exports the ported modules only.  The daemon, replication,
the cluster, the tenants and the router wait for ROADMAP.md §1
(``sheep_tpu_torch.QUEUE``); nothing here imports them, because any
``from . import`` inside ``state.py`` runs this file.  State dirs are
fsck-able (``python -m sheep_tpu_torch.cli.fsck state-dir/`` checks
``.wal``, ``.snap`` and ``reseq.json``).
"""

from .admission import AdmissionController, Overloaded, ReadOnly
from .faults import (SERVE_FAULT_PLAN_ENV, ServeKilled,
                     parse_serve_fault_plan)
from .netfaults import NETFAULT_PLAN_ENV, parse_netfault_plan
from .protocol import ServeClient, ServeError, connect_retry
from .reseq import resume_reseq, run_reseq
from .state import ReplicationGap, ServeCore, ecv_down, insert_link
from .wal import WalAppender, create_wal, read_wal, repair_wal

__all__ = [
    "AdmissionController",
    "NETFAULT_PLAN_ENV",
    "Overloaded",
    "ReadOnly",
    "ReplicationGap",
    "SERVE_FAULT_PLAN_ENV",
    "ServeClient",
    "ServeCore",
    "ServeError",
    "ServeKilled",
    "WalAppender",
    "connect_retry",
    "create_wal",
    "ecv_down",
    "insert_link",
    "parse_netfault_plan",
    "parse_serve_fault_plan",
    "read_wal",
    "repair_wal",
    "resume_reseq",
    "run_reseq",
]
