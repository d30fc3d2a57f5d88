"""The serve daemon (port of sheep_tpu/serve/daemon.py and
cli/serve.py) against the reference's.

The daemon tests of tests/test_serve.py (the ``daemon`` fixture's round
trip, deadline timeout, slow-client shedding; read-only refusal, drift
repartition, the hep-th insert-then-query parity, ``serve`` killed -9
as a process and recovered) and two of tests/test_fleetobs.py (the rid
forwarded to the follower's fsync, the STATS windows and scrape gauges)
each run twice in one directory: as the reference wrote them, then
rebound to the port (tests/torch_twin.py).  The reference's assertions
hold on the port, and the state dirs both runs leave hold equal
``.wal`` and ``.snap`` bytes.  A scripted session sends the same
requests to a daemon of each package and compares every response line,
clock fields masked, the ``MIG`` verb's every op among them."""

import contextlib
import importlib
import os
import re
import sys

import pytest

import test_fleetobs as FO
import test_serve as SV
from torch_twin import (assert_same, clear_fault_plans, cross_recovered,
                        dir_bytes, port_twin, run_twin)

PKGS = {"ref": "sheep_tpu", "port": "sheep_tpu_torch"}
STATE = (".wal", ".snap", ".sum")
DAEMON_TESTS = ("test_daemon_query_insert_roundtrip",
                "test_daemon_deadline_timeout_typed",
                "test_daemon_slow_client_sheds",
                "test_daemon_readonly_refuses_inserts",
                "test_daemon_drift_triggers_background_repartition",
                "test_hepth_insert_then_query_parity",
                "test_serve_cli_kill9_recovery")
FLEETOBS_TESTS = ("test_append_frame_forwards_rid_to_follower_fsync",
                  "test_stats_window_keys_and_scrape_gauges")


def mod(side: str, name: str):
    return importlib.import_module(f"{PKGS[side]}.{name}")


@pytest.fixture(autouse=True)
def _clean_state():
    clear_fault_plans()
    saved = {k: os.environ.pop(k, None)
             for k in ("SHEEP_TRACE", "SHEEP_TRACE_MAX_MB")}
    for side in PKGS:
        tr = mod(side, "obs.trace")
        tr.close_recorder()
        tr.sample_every()
    yield
    clear_fault_plans()
    for side in PKGS:
        mod(side, "obs.trace").close_recorder()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    for side in PKGS:
        mod(side, "obs.trace").sample_every()


def _spawn_port_serve(sd, *args, env_extra=None):
    """The reference test's ``_spawn_serve`` for the port's CLI."""
    import subprocess
    env = dict(os.environ)
    env["PYTHONPATH"] = SV.REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.Popen(
        [sys.executable, "-m", "sheep_tpu_torch.cli.serve", "-d", sd,
         *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=SV.REPO)


def daemon_fixture(side, work, mp):
    """The reference's ``daemon`` fixture, for ``side``'s package."""
    @contextlib.contextmanager
    def provide():
        tiny = SV._tiny_state if side == "ref" else port_twin(SV._tiny_state)
        core, sd, tail, head = tiny(work, name="srv", seed=5)
        serve = mod(side, "serve")
        d = serve.ServeDaemon(core, serve.ServeConfig(
            deadline_s=10.0, max_inflight=2, hang_cap_s=0.6)).start()
        try:
            yield {"daemon": (d, core, tail, head)}
        finally:
            d.shutdown()
    return provide()


#: the insert count of this test depends on when its background
#: repartition lands, so each side's state dir is held to what both
#: packages' stores recover from it
TIMED = ("test_daemon_drift_triggers_background_repartition",)


@pytest.mark.parametrize("name", DAEMON_TESTS)
def test_serve_daemon_twin(tmp_path, monkeypatch, name):
    timed = name in TIMED
    out = run_twin(getattr(SV, name), tmp_path, monkeypatch,
                   cross_recovered if timed else
                   lambda work, side: dir_bytes(work, suffixes=STATE),
                   fixtures=daemon_fixture, before=clear_fault_plans,
                   overrides={"_spawn_serve": _spawn_port_serve})
    assert out["ref"], "the test left no state dir"
    if timed:
        for side in out:
            for d, (ref_crc, port_crc) in out[side].items():
                assert ref_crc == port_crc, (side, d)
    else:
        assert_same(out)


@pytest.mark.parametrize("name", FLEETOBS_TESTS)
def test_fleetobs_twin(tmp_path, monkeypatch, name):
    out = run_twin(getattr(FO, name), tmp_path, monkeypatch,
                   lambda work, side: dir_bytes(work, suffixes=STATE),
                   before=clear_fault_plans)
    assert out["ref"], "the test left no state dir"
    assert_same(out)


#: response fields that hold clocks, ports or pids
CLOCK = re.compile(r"^(?:.*_ms|.*_s|node|leader|pid)$")


def masked(line: str, addr: str) -> str:
    line = line.replace(addr, "ADDR")
    toks = []
    for tok in line.split():
        k, eq, _ = tok.partition("=")
        toks.append(f"{k}=*" if eq and CLOCK.match(k) else tok)
    return " ".join(toks)


#: one session's requests
SESSION = [
    "PING", "PART 0 1 2 3 1000000", "PARENT 0 1 2 99999",
    "INSERT 2 9 3 7", "INSERT 1 1", "INSERT 140 150 5 6",
    "PART 140 150 0", "SUBTREE 0", "SUBTREE 999999", "ECV", "CRC",
    "STATS", "REPARTITION", "PART 0 1 2 3", "PART", "NOPE 1",
    "DEADLINE=0 PART 1", "TENANT", "TENANT nosuch", "EVICT",
    "INSERT 4 8", "STATS", "CRC", "MIG", "MIG BOGUS t",
]
#: the migration verb's every op on one daemon (no router): the source
#: side's fence and its lifting, a target side whose source is
#: unreachable, the cutover's refusals, and the malformed forms
MIG = ["MIG STAT default", "MIG STAT nosuch",
       "MIG ADOPT t host=127.0.0.1 port=1", "MIG ADOPT t",
       "MIG ADOPT t host=127.0.0.1 port=x", "MIG STAT t",
       "MIG SEAL default", "MIG SEAL default dest=c1", "INSERT 1 2",
       "PART 0 1", "MIG STAT default", "MIG SEAL default dest=c1",
       "MIG UNSEAL default", "MIG UNSEAL default", "INSERT 1 2",
       "MIG CUT default", "MIG CUT default epoch=1 expect=0",
       "MIG CUT t epoch=x expect=0", "MIG DROP t", "MIG DROP t",
       "MIG DROP nosuch", "MIG UNSEAL nosuch", "MIG STAT default",
       "MIG", "MIG X t", "PING"]


def _session(side, work, lines):
    """``lines`` sent on one connection to a fresh daemon of ``side``'s
    package in ``work`` (emptied first: snapshots record the graph's
    absolute path); the masked responses and the state dir's bytes."""
    import shutil
    from sheep_tpu.io.edges import write_dat
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    from sheep_tpu.utils.synth import rmat_edges
    serve = mod(side, "serve")
    tail, head = rmat_edges(7, 4 << 7, seed=5)
    g = str(work / "g.dat")
    write_dat(g, tail, head)
    core = serve.ServeCore.bootstrap(str(work / "sd"), graph_path=g,
                                     num_parts=3)
    d = serve.ServeDaemon(core, serve.ServeConfig()).start()
    try:
        h, p = d.address
        with serve.ServeClient(h, p, timeout_s=30) as c:
            resp = [masked(c.request(line), f"{h}:{p}") for line in lines]
    finally:
        d.shutdown()
    return resp, dir_bytes(work / "sd", suffixes=STATE)


def test_session_responses_equal_reference(tmp_path):
    """Every response line of one session, clock fields masked, and the
    state dir it leaves, equal the reference daemon's."""
    got = {side: _session(side, tmp_path / "w", SESSION + MIG)
           for side in PKGS}
    assert got["port"][0] == got["ref"][0]
    assert got["port"][1] == got["ref"][1]


def test_mig_ops_answer_as_the_reference(tmp_path):
    """Every ``MIG`` op (ADOPT, SEAL, UNSEAL, CUT, DROP, STAT; well
    formed, malformed, on unknown tenants) answers as the reference
    daemon answers, in ASCII, on a connection that stays usable, and the
    state dir each leaves (the fence's marker and the adopted tenant's
    registry among it) holds the same bytes."""
    got = {}
    for side in PKGS:
        resp, state = _session(side, tmp_path / "w", MIG)
        names = sorted(n for n in os.listdir(tmp_path / "w" / "sd")
                       if not n.startswith(("serve.status", "serve.hb",
                                            "serve.addr")))
        got[side] = (resp, state, names)
    assert got["port"] == got["ref"]
    resp = got["port"][0]
    assert all(line.isascii() for line in resp)
    assert resp[-1] == "OK pong"
    assert any(line.startswith("ERR moved") for line in resp)
    assert sum(line.startswith("ERR badreq") for line in resp) >= 5


def test_daemon_drive_runs_a_cluster_end_to_end(tmp_path):
    """``scripts/daemon_drive.py`` (chip_smoke's ``daemon`` phase) at a
    small size: a leader and two wire-bootstrapped followers as
    processes, a second tenant evicted and restored, a load with the
    leader killed at its 16th insert and a follower elected, the killed
    node back as a fenced follower, SCRUB, a CORRUPTed follower
    quarantined and healed, fsck of every state dir: every check holds
    and no process loads torch."""
    import json
    import subprocess
    from sheep_tpu_torch.io import write_dat
    from sheep_tpu_torch.serve import ServeCore
    from sheep_tpu_torch.utils.synth import rmat_edges
    for name, log_n, seed in (("sd", 10, 0), ("cut", 9, 1)):
        tail, head = rmat_edges(log_n, 8 << log_n, seed=seed)
        write_dat(str(tmp_path / f"{name}.dat"), tail, head)
        ServeCore.bootstrap(str(tmp_path / name),
                            graph_path=str(tmp_path / f"{name}.dat"),
                            num_parts=2).close()
    env = dict(os.environ)
    env["PYTHONPATH"] = SV.REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "sheep_tpu_torch.scripts.daemon_drive", "run",
         str(tmp_path / "work"), "--state", str(tmp_path / "sd"),
         "--tenant-dir", str(tmp_path / "cut"), "--tenant-log-n", "9",
         "--log-n", "10", "--inserts", "1024", "--batch", "16",
         "--kill-at", "16", "--query", "64", "--verify-n", "32"],
        capture_output=True, text=True, env=env, cwd=SV.REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("daemon_record "))
    rec = json.loads(line.split(" ", 1)[1])
    assert all(rec["checks"].values()), rec["checks"]
    assert rec["load"]["acked_by_killed_leader"] <= 15
    assert rec["elected"] in ("F1", "F2")
