"""Replication (port of sheep_tpu/serve/replicate.py and cluster.py)
against the reference's.

Every test of tests/test_replicate.py runs twice in one directory: as
the reference wrote it, then rebound to the port (tests/torch_twin.py).
The reference's assertions hold on the port, and the state dirs both
runs leave (``.wal`` and ``.snap`` bytes, sidecars) are equal.  Mixed
clusters (a port leader with a reference follower and the other way
round) show the wire is the reference's."""

import pytest

import test_replicate as R
from torch_twin import (assert_same, cases, clear_fault_plans, dir_bytes,
                        run_twin)

STATE = (".wal", ".snap", ".sum")


@pytest.fixture(autouse=True)
def _clean_fault_plans():
    clear_fault_plans()
    yield
    clear_fault_plans()


@pytest.mark.parametrize("name,params", [c[1:] for c in cases(R)],
                         ids=[c[0] for c in cases(R)])
def test_replicate_twin(tmp_path, monkeypatch, name, params):
    out = run_twin(getattr(R, name), tmp_path, monkeypatch,
                   lambda work, side: dir_bytes(work, suffixes=STATE),
                   params=params, before=clear_fault_plans)
    assert_same(out)


def _pkg(side):
    import importlib
    name = {"ref": "sheep_tpu", "port": "sheep_tpu_torch"}[side]
    return importlib.import_module(f"{name}.serve")


def _mixed_cluster(tmp_path, lead_side, fol_side):
    """A leader of ``lead_side``'s package and a wire-bootstrapped
    follower of ``fol_side``'s: a seeded insert stream, the leader
    killed abruptly and the follower promoted, the ex-leader restarted
    (its own package) and fenced into a follower, more inserts.
    Returns both nodes' state-dir bytes and state_crc()s."""
    import numpy as np
    from sheep_tpu.io.edges import write_dat
    from sheep_tpu.utils.synth import rmat_edges

    L, F = _pkg(lead_side), _pkg(fol_side)
    tail, head = rmat_edges(7, 4 << 7, seed=5)
    g = str(tmp_path / "lead.dat")
    write_dat(g, tail, head)
    lsd, fsd = str(tmp_path / "lead"), str(tmp_path / "f0")
    lcore = L.ServeCore.bootstrap(lsd, graph_path=g, num_parts=3)

    def cluster(P, node, role, peer):
        return P.ClusterConfig(node_id=node, role=role, peers=[peer],
                               hb_s=0.05, failover_s=0.6,
                               poll_timeout_s=1.0)

    lead = L.ServeDaemon(lcore, L.ServeConfig(),
                         cluster=cluster(L, "L", "leader", fsd)).start()
    daemons = [lead]
    try:
        F.bootstrap_state_dir(fsd, *lead.address)
        fcore = F.ServeCore.open(fsd)
        fol = F.ServeDaemon(fcore, F.ServeConfig(),
                            cluster=cluster(F, "F0", "follower",
                                            lsd)).start()
        daemons.append(fol)
        R._wait_until(lambda: lead.hub.follower_count() == 1,
                      what="follower attached")
        rng = np.random.default_rng(11)
        stream = rng.integers(0, 140, size=(24, 2)).tolist()
        with L.ServeClient(*lead.address, timeout_s=30) as c:
            for u, v in stream[:12]:
                c.insert([(u, v)])
        assert fcore.applied_seqno == 12
        assert fcore.state_crc() == lcore.state_crc()
        R._abrupt_kill(lead)
        R._wait_until(lambda: fol.role == "leader", what="promotion")
        assert fcore.epoch == 1 and fcore.applied_seqno == 12
        lcore.close()
        excore = L.ServeCore.open(lsd)
        ex = L.ServeDaemon(excore, L.ServeConfig(),
                           cluster=cluster(L, "L", "leader", fsd)).start()
        daemons.append(ex)
        assert ex.role == "follower"
        R._wait_until(lambda: fol.hub.follower_count() == 1,
                      what="ex-leader attached as follower")
        with F.ServeClient(*fol.address, timeout_s=30) as c:
            for u, v in stream[12:]:
                c.insert([(u, v)])
        R._wait_until(lambda: excore.applied_seqno == len(stream),
                      what="ex-leader caught up")
        assert excore.epoch == fcore.epoch == 1
        crcs = (fcore.state_crc(), excore.state_crc())
    finally:
        for d in reversed(daemons[1:]):
            d.shutdown()
    return {"crc": crcs,
            "lead": dir_bytes(lsd, suffixes=STATE),
            "f0": dir_bytes(fsd, suffixes=STATE)}


@pytest.mark.parametrize("lead,fol", [("port", "ref"), ("ref", "port")])
def test_mixed_cluster_equals_reference_cluster(tmp_path, lead, fol):
    """A mixed cluster (one package leads, the other follows, then the
    roles swap through a forced failover) ends where a reference-only
    cluster ends: equal state_crc() on both nodes, and each node's
    ``.wal`` and ``.snap`` bytes equal to the reference cluster's."""
    import shutil
    got = {}
    for key, sides in (("ref", ("ref", "ref")), ("mixed", (lead, fol))):
        work = tmp_path / "work"
        work.mkdir()
        got[key] = _mixed_cluster(work, *sides)
        shutil.rmtree(work)
    assert got["mixed"]["crc"][0] == got["mixed"]["crc"][1]
    assert got["mixed"]["crc"] == got["ref"]["crc"]
    for node in ("lead", "f0"):
        assert got["mixed"][node].keys() == got["ref"][node].keys(), node
        for name in got["ref"][node]:
            assert got["mixed"][node][name] == got["ref"][node][name], \
                (node, name)


def test_frame_codec_bytes_equal_reference():
    """Every replication frame the port encodes is the reference's line,
    byte for byte, for seeded payloads (an extra token a parser ignores
    would still interoperate, so the mixed clusters alone cannot show
    it), and each parses to the same frame."""
    import numpy as np
    R_, P_ = (_pkg(s).replicate for s in ("ref", "port"))
    rng = np.random.default_rng(31)
    lines = {"ref": [], "port": []}
    for i in range(64):
        payload = rng.integers(0, 256, int(rng.integers(0, 200)),
                               dtype=np.uint8).tobytes()
        epoch, seqno = int(rng.integers(0, 5)), int(rng.integers(1, 1 << 40))
        sig = "%064x" % int(rng.integers(0, 1 << 62))
        rid = None if i % 3 else f"{i:04x}"
        gen = None if i % 4 else int(rng.integers(0, 3))
        for side, m in (("ref", R_), ("port", P_)):
            kw = {k: v for k, v in (("rid", rid), ("gen", gen))
                  if v is not None}
            lines[side] += [
                m.encode_append(epoch, seqno, payload, **kw),
                m.encode_ping(epoch, seqno),
                m.encode_verify(epoch, seqno, m.payload_crc(payload)),
                m.encode_reseq(epoch, seqno, i, sig),
                m.encode_hello(f"n{i}", epoch, seqno, sig,
                               tenant=None if i % 2 else f"t{i}",
                               mig=bool(i % 5 == 0), verify=bool(i % 2)),
                m.encode_ack(seqno), m.encode_nack(seqno),
                m.encode_fenced(epoch)]
    assert lines["port"] == lines["ref"]
    for line in lines["ref"]:
        a, b = R_.parse_frame(line), P_.parse_frame(line)
        assert (a.kind, a.kv, a.payload) == (b.kind, b.kv, b.payload)


def test_slow_snapshot_resync_waits_for_the_leader(tmp_path, monkeypatch):
    """A deliberate difference (ROADMAP.md §3): a follower past the
    leader's stream window re-syncs from a snapshot the leader seals
    before it answers.  When that takes longer than the stream's
    heartbeat-sized timeout (3 x hb, at least 1 s), the reference's
    follower times the answer out and asks again forever, each ask
    sealing another snapshot; the port's waits for it (up to
    ``replicate.HANDSHAKE_S``) and catches up, equal to the leader."""
    import shutil
    import time
    import numpy as np
    from sheep_tpu.io.edges import write_dat
    from sheep_tpu.utils.synth import rmat_edges
    got = {}
    for side in ("ref", "port"):
        P = _pkg(side)
        monkeypatch.setattr(P.state, "REPL_TAIL_KEEP", 2)
        work = tmp_path / side
        work.mkdir()
        tail, head = rmat_edges(7, 4 << 7, seed=5)
        g = str(work / "g.dat")
        write_dat(g, tail, head)
        lsd, fsd = str(work / "lead"), str(work / "fol")
        lcore = P.ServeCore.bootstrap(lsd, graph_path=g, num_parts=3)
        shutil.copytree(lsd, fsd)
        for i in range(10):
            lcore.insert(np.array([[i, i + 3]], np.uint32))
        sealed = lcore.snapshot_bytes

        def slow_seal():
            time.sleep(1.5)
            return sealed()

        lcore.snapshot_bytes = slow_seal
        cfg = dict(hb_s=0.05, failover_s=30.0, poll_timeout_s=1.0)
        lead = P.ServeDaemon(lcore, P.ServeConfig(), cluster=P.ClusterConfig(
            node_id="L", role="leader", peers=[fsd], **cfg)).start()
        fcore = P.ServeCore.open(fsd)
        fol = P.ServeDaemon(fcore, P.ServeConfig(), cluster=P.ClusterConfig(
            node_id="F", role="follower", peers=[lsd], **cfg)).start()
        try:
            deadline = time.monotonic() + 6.0
            while time.monotonic() < deadline and fcore.applied_seqno < 10:
                time.sleep(0.05)
            got[side] = (fcore.applied_seqno,
                         fcore.state_crc() == lcore.state_crc(),
                         sum(1 for e in fol.replicator.events
                             if e[0] == "repl_error"))
        finally:
            fol.shutdown()
            lead.shutdown()
    assert got["port"][:2] == (10, True), got
    assert got["ref"][0] < 10 and got["ref"][2] >= 2, got
