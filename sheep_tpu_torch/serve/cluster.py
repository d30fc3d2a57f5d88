"""Cluster membership and epoch-fenced failover for the serve daemon.

A replicated serve cluster is deliberately coordination-service-free: the
static peer set (``SHEEP_SERVE_PEERS``) plus the wire ``STATS`` verb is
the whole membership protocol.  Every node can ask every other node
"what role, what epoch, how far applied?", and from those answers each
transition is a deterministic rule:

  discovery   the current leader is whichever reachable peer reports
              ``role=leader`` with the HIGHEST epoch.  Followers point
              their replication stream at it; there is no registry to
              keep consistent.
  election    when the stream has been silent past the failover
              deadline AND no reachable peer is a live leader, the
              designated successor is the reachable candidate with the
              highest ``(applied_seqno, node_id)`` — the replica that
              lost the least, tie-broken totally.  Only that node
              promotes; everyone else waits for it to show up as
              leader.  Promotion = bump the epoch past every epoch seen
              and seal the boundary durably (ServeCore.advance_epoch)
              BEFORE accepting a single write.
  fencing     epochs only ever move forward.  A fenced ex-leader
              returning from a partition learns of the later epoch on
              its next peer poll (or from a follower's REPL FENCED) and
              demotes instead of accepting writes; its divergent
              unacknowledged tail is rolled back by snapshot re-sync
              when it rejoins as a follower.

Quorum votes (closing the symmetric-partition hole of plain epoch fencing): a
candidate that wins the deterministic rule must ALSO collect ``REPL
VOTE`` grants from a majority of its reachable peers before promoting.
Each node grants at most one candidate per epoch and only while its own
replication stream is stale (daemon.grant_vote), so two candidates that
share ANY voter can never both promote into the same epoch — a
symmetric partition now produces at most one leader per epoch instead
of two leaders in one.  A candidate whose whole peer set is unreachable
(the 2-node cluster after its leader dies) needs zero votes: that is
the availability the unvoted design chose, and the epoch fence still
resolves any cross-epoch split deterministically on heal.  Writes need
``repl_acks`` follower acknowledgements to be acked at all, so no
acknowledged insert is ever lost to a split either way.

Peer specs: ``host:port``, or a serve state-dir path (its ``serve.addr``
file is read fresh on every poll — ephemeral ports move across
restarts), or a path to an addr file itself.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

ROLE_ENV = "SHEEP_SERVE_ROLE"
PEERS_ENV = "SHEEP_SERVE_PEERS"
NODE_ID_ENV = "SHEEP_SERVE_NODE_ID"
REPL_ACKS_ENV = "SHEEP_SERVE_REPL_ACKS"
FAILOVER_ENV = "SHEEP_SERVE_FAILOVER_S"
MAX_LAG_ENV = "SHEEP_SERVE_MAX_LAG"

ROLES = ("leader", "follower")

ADDR_FILE = "serve.addr"


@dataclass
class ClusterConfig:
    """One node's view of the cluster (all overridable per test)."""

    node_id: str = ""
    role: str = "leader"          # standalone daemons are trivially leader
    peers: list = field(default_factory=list)
    #: follower acks required before an insert is acknowledged (0 =
    #: async replication — acked inserts can die with the leader)
    repl_acks: int = 1
    #: replication-stream heartbeat cadence (leader PING when idle)
    hb_s: float = 1.0
    #: stream silence (follower) / peer-poll cadence (leader) past which
    #: failover/fence checks run
    failover_s: float = 5.0
    #: bounded staleness: a follower whose lag exceeds this many records
    #: refuses reads typed (``ERR stale``); None = serve any staleness
    max_lag: int | None = None
    poll_timeout_s: float = 2.0

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"serve role {self.role!r} must be one of "
                             f"{'/'.join(ROLES)}")

    @classmethod
    def from_env(cls, **overrides) -> "ClusterConfig":
        kw: dict = {}
        if os.environ.get(ROLE_ENV):
            kw["role"] = os.environ[ROLE_ENV].strip().lower()
        if os.environ.get(PEERS_ENV):
            kw["peers"] = [p.strip() for p in
                           os.environ[PEERS_ENV].split(",") if p.strip()]
        if os.environ.get(NODE_ID_ENV):
            kw["node_id"] = os.environ[NODE_ID_ENV].strip()
        if os.environ.get(REPL_ACKS_ENV):
            kw["repl_acks"] = int(os.environ[REPL_ACKS_ENV])
        if os.environ.get(FAILOVER_ENV):
            kw["failover_s"] = float(os.environ[FAILOVER_ENV])
        if os.environ.get(MAX_LAG_ENV):
            kw["max_lag"] = int(os.environ[MAX_LAG_ENV])
        from .replicate import REPL_HB_ENV
        if os.environ.get(REPL_HB_ENV):
            kw["hb_s"] = float(os.environ[REPL_HB_ENV])
        kw.update(overrides)
        return cls(**kw)

    @property
    def clustered(self) -> bool:
        return bool(self.peers)


def resolve_peer(spec: str) -> tuple[str, int] | None:
    """Peer spec -> (host, port), or None while unresolvable (a state
    dir whose daemon has not published its address yet)."""
    spec = spec.strip()
    path = None
    if os.path.isdir(spec):
        path = os.path.join(spec, ADDR_FILE)
    elif os.sep in spec or os.path.isfile(spec):
        path = spec
    if path is not None:
        try:
            host, port = open(path).read().split()
            return host, int(port)
        except (OSError, ValueError):
            return None
    host, _, port = spec.rpartition(":")
    try:
        return (host or "127.0.0.1"), int(port)
    except ValueError:
        return None


def poll_peer(spec: str, timeout_s: float = 2.0) -> dict | None:
    """One peer's ``STATS`` as a dict, or None when unreachable.  The
    whole membership protocol is this call."""
    from .protocol import ServeClient
    addr = resolve_peer(spec)
    if addr is None:
        return None
    try:
        with ServeClient(addr[0], addr[1], timeout_s=timeout_s) as c:
            st = c.kv("STATS")
            st["_addr"] = f"{addr[0]}:{addr[1]}"
            return st
    except Exception:
        return None


def find_leader(peers, timeout_s: float = 2.0,
                min_epoch: int = -1) -> tuple[str, dict] | None:
    """The reachable peer reporting ``role=leader`` with the highest
    epoch (>= ``min_epoch``), as ``(addr, stats)`` — replication
    discovery and the fence check share this."""
    best = None
    for spec in peers:
        st = poll_peer(spec, timeout_s)
        if st is None or st.get("role") != "leader":
            continue
        epoch = int(st.get("epoch", 0))
        if epoch < min_epoch:
            continue
        if best is None or epoch > int(best[1].get("epoch", 0)):
            best = (st["_addr"], st)
    return best


def request_vote(spec: str, epoch: int, candidate: str, seqno: int,
                 timeout_s: float = 2.0) -> bool:
    """Ask one peer to grant ``candidate`` its vote for ``epoch``.
    Returns True only on an explicit ``grant=1`` — unreachable peers
    and refusals count identically (no grant)."""
    from .protocol import ServeClient, parse_kv_args
    addr = resolve_peer(spec)
    if addr is None:
        return False
    try:
        with ServeClient(addr[0], addr[1], timeout_s=timeout_s) as c:
            resp = c.request(f"REPL VOTE epoch={epoch} "
                             f"candidate={candidate} seqno={seqno}")
            toks = resp.split()
            if not toks or toks[0] != "OK":
                return False
            return parse_kv_args(toks[1:]).get("grant") == "1"
    except Exception:
        return False


def choose_successor(candidates: list[tuple[int, str]]) -> str:
    """The deterministic election rule: highest ``(applied_seqno,
    node_id)`` wins.  ``candidates`` must include the caller; every
    node evaluating the same candidate set picks the same winner."""
    if not candidates:
        raise ValueError("no candidates")
    return max(candidates)[1]


class FailoverWatcher:
    """One daemon's transition engine, polled on a timer thread.

    follower   while the replication stream is fresh: do nothing.  Once
               it has been silent past ``failover_s``: poll the peers;
               if a live leader exists, re-point (discovery handles it);
               otherwise run the election rule over the reachable
               candidates and promote iff self wins.
    leader     every ``failover_s``: poll the peers for a leader with a
               LATER epoch; seeing one means this node's term is over —
               demote (the fence check).  The hub's REPL FENCED callback
               triggers the same demotion without waiting for the poll.
    """

    def __init__(self, daemon, config: ClusterConfig):
        self.daemon = daemon
        self.config = config
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.elections = 0
        self.votes_denied = 0

    def start(self) -> "FailoverWatcher":
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"serve-watch:{self.config.node_id}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        poll = max(0.05, self.config.failover_s / 4)
        while not self._stop.wait(poll):
            try:
                if self.daemon.role == "leader":
                    self._check_fence()
                else:
                    self._check_failover()
            except Exception as exc:  # a watcher crash must not be silent
                self.daemon.config.events.append(
                    ("watcher_error", f"{type(exc).__name__}: {exc}"))

    def _check_fence(self) -> None:
        other = find_leader(self.config.peers,
                            self.config.poll_timeout_s,
                            min_epoch=self.daemon.core.epoch + 1)
        if other is not None:
            self.daemon.demote(other[0], int(other[1].get("epoch", 0)))

    def _check_failover(self) -> None:
        # a quarantined node never stands for election: its
        # applied state is KNOWN divergent, so a high applied_seqno is
        # a lie — promoting it would serve the divergence fleet-wide
        if getattr(self.daemon.core, "quarantined", False):
            return
        rep = self.daemon.replicator
        age = rep.stream_age_s() if rep is not None else None
        if age is None:
            # never streamed: count from daemon start, not forever
            age = time.monotonic() - self.daemon.started_at
        if age <= self.config.failover_s:
            return
        stats = [(spec, poll_peer(spec, self.config.poll_timeout_s))
                 for spec in self.config.peers]
        alive = [(spec, st) for spec, st in stats if st is not None]
        top_epoch = self.daemon.core.epoch
        for _, st in alive:
            top_epoch = max(top_epoch, int(st.get("epoch", 0)))
            if st.get("role") == "leader":
                return  # a leader lives; discovery will (re)point at it
        # peers advertising `diverged` in STATS are excluded the same
        # way — every node filters identically, so the deterministic
        # rule still picks one winner from the same candidate set
        candidates = [(int(st.get("applied_seqno", 0)),
                       str(st.get("node", st.get("_addr", ""))))
                      for _, st in alive
                      if not int(st.get("diverged", 0))]
        candidates.append((self.daemon.core.applied_seqno,
                           self.config.node_id))
        self.elections += 1
        if choose_successor(candidates) != self.config.node_id:
            return
        # the quorum vote (module docstring): a majority of the
        # REACHABLE peers must grant this epoch before promotion — an
        # empty reachable set needs no votes (the 2-node availability
        # choice), a shared voter forbids same-epoch dual leaders
        reachable = [spec for spec, st in stats if st is not None]
        need = len(reachable) // 2 + 1 if reachable else 0
        grants = 0
        for spec in reachable:
            if request_vote(spec, top_epoch + 1, self.config.node_id,
                            self.daemon.core.applied_seqno,
                            self.config.poll_timeout_s):
                grants += 1
            if grants >= need:
                break
        if grants < need:
            self.votes_denied += 1
            self.daemon.config.events.append(
                ("election_denied", top_epoch + 1, grants, need))
            return
        self.daemon.promote(top_epoch + 1)
