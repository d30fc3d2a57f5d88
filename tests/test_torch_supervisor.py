"""The port's tournament supervisor (sheep_tpu_torch.supervisor and
``cli.supervise``) against the reference's, on the same seeded inputs.

Each case runs a scenario through both packages, each in a directory of
its own with the same relative state dir, and holds what they leave
equal: the final tree's bytes, the manifest JSON and its sidecar, every
per-leg dispatch count, the event record, stdout less its times, the
status report and the exceptions, by type and message.  These are the
twins of tests/test_supervisor.py: the fault-free run equals the oracle,
a kill, corrupt or hang at every leg and a supervisor killed after every
leg give the reference's tree and dispatch counts, and a resume
re-dispatches only the dirty legs.  Legs run in process on threads
(``InlineRunner``); the production runner is held to start the port's
own tools, ``python -m sheep_tpu_torch.cli.<tool>``, none of which loads
torch.  The reference's ``test_dist_partition_supervised_golden`` drives
its ``scripts/`` shell driver and has no twin here.
"""

import contextlib
import importlib
import io
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from sheep_tpu.core.forest import build_forest
from sheep_tpu.core.sequence import degree_sequence
from sheep_tpu.io.edges import write_net
from sheep_tpu.utils.synth import rmat_edges

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"ref": "sheep_tpu", "port": "sheep_tpu_torch"}
WORKERS = 4
SORT_ROUND = -1


def mod(side: str, name: str):
    return importlib.import_module(f"{PKGS[side]}.{name}")


@pytest.fixture(scope="module")
def small_graph(tmp_path_factory):
    d = tmp_path_factory.mktemp("supervised")
    tail, head = rmat_edges(7, 4 << 7, seed=11)
    graph = str(d / "g.net")
    write_net(graph, tail, head)
    seq = degree_sequence(tail, head)
    return graph, build_forest(tail, head, seq)


def both(tmp_path, monkeypatch, fn):
    """``fn(side)`` in ``tmp_path/<side>`` for each package; returns
    (reference's result, port's result).  The legs' paths are relative,
    so the threads of attempts a killed supervisor abandoned are joined
    before the working directory moves to the other side."""
    out = {}
    for side in PKGS:
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        before = set(threading.enumerate())
        out[side] = fn(side)
        join_new_threads(before)
    monkeypatch.chdir(tmp_path)
    return out["ref"], out["port"]


def join_new_threads(before: set, timeout_s: float = 60.0) -> None:
    """Wait for every thread started since ``before`` to end, including
    ones still starting (a leg's heartbeat writer) when first seen."""
    deadline = time.monotonic() + timeout_s
    while True:
        new = [t for t in threading.enumerate()
               if t not in before and t is not threading.current_thread()]
        if not new:
            return
        assert time.monotonic() < deadline, new
        for t in new:
            try:
                t.join(timeout=0.1)
            except RuntimeError:  # not started yet
                time.sleep(0.01)


def masked(out: str) -> list:
    """stdout lines, times masked, sorted (legs print from threads)."""
    return sorted(re.sub(r" in:? [0-9.]+( seconds|ms)?", " in T", ln)
                  for ln in out.splitlines())


def config(side: str, **overrides):
    kw = dict(workers=WORKERS, deadline_s=10.0, poll_s=0.01,
              backoff_base_s=0.0, heartbeat_s=0.05)
    kw.update(overrides)
    return mod(side, "supervisor").SupervisorConfig(**kw)


def supervised(side: str, graph: str, state_dir: str = "s", runner=None,
               **overrides) -> dict:
    """One supervised run in the cwd: what it left, as comparable data;
    an exception is recorded by type and message."""
    sup = mod(side, "supervisor")
    cfg = config(side, **overrides)
    buf = io.StringIO()
    rec: dict = {}
    try:
        with contextlib.redirect_stdout(buf):
            m = sup.run_supervised(graph, state_dir, cfg,
                                   runner=runner or sup.InlineRunner(0.05))
        rec["tree"] = open(m.final_tree, "rb").read()
        rec["dispatches"] = {leg.key: leg.dispatches for leg in m.legs}
    except (sup.SupervisionFailed, sup.SupervisorKilled) as exc:
        rec["raised"] = (type(exc).__name__, str(exc))
    rec["stdout"] = masked(buf.getvalue())
    rec["events"] = sorted(map(repr, cfg.events))
    for name in ("manifest.json", "manifest.json.sum"):
        path = os.path.join(state_dir, name)
        rec[name] = open(path, "rb").read() if os.path.exists(path) \
            else None
    return rec


def all_legs():
    """(round, index) of every leg of the WORKERS-wide tournament."""
    from sheep_tpu_torch.supervisor import tournament_rounds
    legs = [(SORT_ROUND, 0)] + [(0, i) for i in range(WORKERS)]
    for s, slots in enumerate(tournament_rounds(WORKERS, 2)):
        legs += [(s + 1, i) for i in range(len(slots))]
    return legs


def spec(kind: str, rnd: int, leg: int) -> str:
    return f"{kind}@{'sort' if rnd == SORT_ROUND else rnd}:{leg}"


def flip(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


# ---------------------------------------------------------------------------
# units: heartbeat, manifest, chaos grammar
# ---------------------------------------------------------------------------


def test_heartbeat_staleness_equals_reference(tmp_path):
    hb = str(tmp_path / "w.hb")
    t0 = time.time()
    cases = [(hb, t0, 10, t0 + 5), (hb, t0, 10, t0 + 11)]

    def verdicts(side):
        is_stale = mod(side, "supervisor.heartbeat").is_stale
        return [is_stale(p, launched_at=a, deadline_s=d, now=n)
                for p, a, d, n in cases]

    before = {side: verdicts(side) for side in PKGS}
    assert before["port"] == before["ref"] == [False, True]
    mod("port", "supervisor.heartbeat").beat(hb)
    m = os.path.getmtime(hb)
    cases = [(hb, t0, 10, None), (hb, t0, 10, m + 11)]
    assert verdicts("port") == verdicts("ref") == [False, True]


def test_poll_count_staleness_equals_reference(tmp_path):
    """``stale_after_polls``: declared dead after exactly N beat-free
    polls, whatever the wall clock says; a beat resets the count."""
    def polls(side):
        sup_mod = mod(side, "supervisor.supervise")
        hb_mod = mod(side, "supervisor.heartbeat")
        Leg = mod(side, "supervisor.manifest").Leg
        sup = sup_mod.TournamentSupervisor.__new__(
            sup_mod.TournamentSupervisor)
        sup.config = sup_mod.SupervisorConfig(stale_after_polls=3,
                                              deadline_s=0.0)
        hb = str(tmp_path / f"{side}.hb")
        hb_mod.beat(hb)
        leg = Leg(key="x", kind="map", round=0, index=0, inputs=[],
                  output=str(tmp_path / "x.tre"))
        att = sup_mod._Attempt(leg=leg, number=1, tmp="t", hb=hb,
                               handle=None, started=0.0)
        seen = [sup._attempt_stale(att, now=k * 1e9) for k in range(1, 6)]
        att2 = sup_mod._Attempt(leg=leg, number=2, tmp="t", hb=hb,
                                handle=None, started=0.0)
        seen += [sup._attempt_stale(att2, now=0.0) for _ in range(2)]
        time.sleep(0.01)
        hb_mod.beat(hb)
        seen += [sup._attempt_stale(att2, now=0.0), att2.quiet_polls]
        return seen

    assert polls("port") == polls("ref") == \
        [False, False, False, True, True, False, False, False, 0]


@pytest.mark.parametrize("workers,reduction", [
    (1, 2), (2, 2), (3, 2), (4, 2), (4, 4), (5, 3), (8, 2), (13, 4)])
def test_bracket_and_plan_equal_reference(tmp_path, workers, reduction):
    """The bracket arithmetic, the planned legs and the saved manifest's
    bytes (with and without a given sequence) equal the reference's."""
    from dataclasses import asdict
    got = {}
    for side in PKGS:
        man = mod(side, "supervisor.manifest")
        plans = [man.plan_tournament("g.net", "st/g", "st/g.tre", workers,
                                     reduction, seq_file=seq)
                 for seq in (None, "given.seq")]
        d = tmp_path / side
        d.mkdir()
        man.save_manifest(plans[0], str(d))
        got[side] = (man.tournament_rounds(workers, reduction),
                     [asdict(p) for p in plans],
                     open(d / "manifest.json", "rb").read(),
                     open(d / "manifest.json.sum", "rb").read())
    assert got["port"] == got["ref"]
    with pytest.raises(ValueError):
        mod("port", "supervisor.manifest").tournament_rounds(4, 1)


def test_manifest_roundtrip_and_corruption_equal_reference(tmp_path):
    got = {}
    for side in PKGS:
        man = mod(side, "supervisor.manifest")
        d = tmp_path / side
        d.mkdir()
        m = man.plan_tournament("g.net", str(d / "g"), str(d / "g.tre"), 4, 2)
        m.leg("r0.01").state = "done"
        m.leg("r0.02").state = "running"
        m.sig = "abc123"
        man.save_manifest(m, str(d))
        back = man.load_manifest(str(d))
        states = [(leg.key, leg.state) for leg in back.legs]
        flip(str(d / "manifest.json"), 10)
        try:
            man.load_manifest(str(d))
            err = None
        except Exception as exc:  # the type is what is compared
            err = type(exc).__name__
        got[side] = (back.sig, states, err)
    assert got["port"] == got["ref"]
    assert got["port"][2] == "ChecksumMismatch"
    assert dict(got["port"][1])["r0.02"] == "pending"


@pytest.mark.parametrize("plan", [
    "kill@0:2,corrupt@1:0,hang@2:0,stop@sort:0", " kill@0:1 , ,stop@-2:1",
    "nuke@0:0", "kill@0", "kill@x:1", ""])
def test_fault_plan_grammar_equals_reference(plan):
    def parse(side):
        chaos = mod(side, "supervisor.chaos")
        try:
            p = chaos.parse_fault_plan(plan)
        except ValueError as exc:
            return ("ValueError", str(exc))
        faults = [(f.kind, f.round, f.leg) for f in p.faults]
        fired = [p.take_dispatch(0, 2), p.take_dispatch(0, 2),
                 p.take_stop(0, 2), p.take_stop(SORT_ROUND, 0),
                 p.take_stop(SORT_ROUND, 0)]
        return faults, fired, [(f.kind, f.round, f.leg) for f in p.faults]

    assert parse("port") == parse("ref")


def test_fault_plan_from_env_equals_reference(monkeypatch):
    for value in ("", "kill@0:1", "hang@sort:0,stop@1:0"):
        monkeypatch.setenv("SHEEP_FAULT_PLAN", value)
        got = []
        for side in PKGS:
            p = mod(side, "supervisor.chaos").plan_from_env()
            got.append(None if p is None else
                       [(f.kind, f.round, f.leg) for f in p.faults])
        assert got[0] == got[1], value


def test_config_from_env_equals_reference(monkeypatch):
    """SupervisorConfig.from_env reads the same knobs into the same
    fields (the worker addresses through the port's copy of the
    reference's parser)."""
    env = {"SHEEP_WORKERS": "5", "REDUCTION": "3", "SHEEP_DEADLINE_S": "7",
           "SHEEP_STALE_POLLS": "4", "SHEEP_HEARTBEAT_S": "0.5",
           "SHEEP_MAX_RETRIES": "2", "SHEEP_BACKOFF_BASE": "0.1",
           "SHEEP_LEG_CORES": "2", "SHEEP_SPECULATE_S": "3",
           "SHEEP_WORKER_ADDRS": "a:1, b.c:22,,[::1]:3",
           "SHEEP_WORKER_BEAT_S": "2", "SHEEP_WORKER_SPECULATE_S": "9",
           "SHEEP_FAULT_PLAN": "kill@0:1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    fields = ("workers", "reduction", "deadline_s", "stale_after_polls",
              "heartbeat_s", "max_retries", "backoff_base_s", "leg_cores",
              "speculate_after_s", "worker_addrs", "worker_beat_s",
              "worker_speculate_s", "max_dispatches")
    got = []
    for side in PKGS:
        cfg = mod(side, "supervisor").SupervisorConfig.from_env(cores=3)
        got.append([getattr(cfg, f) for f in fields] + [cfg.cores])
    assert got[1] == got[0]
    monkeypatch.setenv("SHEEP_WORKER_ADDRS", "nohost")
    for side in PKGS:
        with pytest.raises(ValueError, match="want host:port"):
            mod(side, "supervisor").SupervisorConfig.from_env()


# ---------------------------------------------------------------------------
# supervised runs: fault-free, given sequence, export, edge widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "given_seq", "out_file",
                                  "one_worker", "odd_width_corrupt_copy",
                                  "reduction_3"])
def test_supervised_run_equals_reference(tmp_path, monkeypatch,
                                         small_graph, case):
    """The same tree (the oracle's), manifest bytes, dispatch counts,
    events and stdout as the reference, for each bracket shape."""
    graph, want = small_graph
    kw: dict = {}
    if case == "given_seq":
        from sheep_tpu.io.seqfile import write_sequence
        from sheep_tpu.io.edges import read_net
        el = read_net(graph)
        write_sequence(degree_sequence(el.tail, el.head),
                       str(tmp_path / "given.seq"))
        kw["seq_file"] = str(tmp_path / "given.seq")

    def run(side):
        sup = mod(side, "supervisor")
        if case in ("plain", "given_seq"):
            seq_file = kw.get("seq_file")
            cfg = config(side)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                m = sup.run_supervised(graph, "s", cfg,
                                       runner=sup.InlineRunner(0.05),
                                       seq_file=seq_file)
            return {"tree": open(m.final_tree, "rb").read(),
                    "kinds": [leg.kind for leg in m.legs],
                    "dispatches": [leg.dispatches for leg in m.legs],
                    "manifest": open("s/manifest.json", "rb").read(),
                    "stdout": masked(buf.getvalue()),
                    "events": sorted(map(repr, cfg.events))}
        if case == "out_file":
            sup.run_supervised(graph, "s", config(side, grammar=False),
                               runner=sup.InlineRunner(0.05),
                               out_file="exported.tre")
            return {n: open(n, "rb").read()
                    for n in ("exported.tre", "exported.tre.sum")}
        if case == "one_worker":
            return supervised(side, graph, workers=1)
        if case == "reduction_3":
            return supervised(side, graph, workers=5, reduction=3)
        return supervised(side, graph, workers=3,
                          chaos=sup.parse_fault_plan("corrupt@1:1"))

    ref, port = both(tmp_path, monkeypatch, run)
    assert port == ref
    from sheep_tpu_torch.io.trefile import read_tree
    tree = port.get("tree", port.get("exported.tre"))
    path = tmp_path / "t.tre"
    path.write_bytes(tree)
    parent, pst = read_tree(str(path), integrity="trust")
    np.testing.assert_array_equal(parent, want.parent)
    np.testing.assert_array_equal(pst, want.pst_weight)
    if case == "plain":
        assert set(port["dispatches"]) == {1}
        assert any(ln.startswith("Mapped in") for ln in port["stdout"])
        assert any(ln.startswith("Reduced in") for ln in port["stdout"])
    if case == "given_seq":
        assert "sort" not in port["kinds"]
    if case == "one_worker":
        assert list(port["dispatches"]) == ["sort", "r0.00"]
    if case == "odd_width_corrupt_copy":
        assert port["dispatches"]["r1.01"] == 2


# ---------------------------------------------------------------------------
# THE acceptance property: kill/corrupt/hang at every leg, supervisor death
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["kill", "corrupt", "hang"])
def test_fault_at_every_leg_equals_reference(tmp_path, monkeypatch,
                                             small_graph, kind):
    """A fault at each leg in turn: the port gives the fault-free tree,
    re-dispatches only the faulted leg, and records the reference's
    events."""
    graph, _ = small_graph

    def sweep(side):
        chaos = mod(side, "supervisor.chaos")
        out = {"base": supervised(side, graph, "base")}
        for rnd, leg in all_legs():
            out[(rnd, leg)] = supervised(
                side, graph, f"{kind}-{rnd}-{leg}",
                chaos=chaos.parse_fault_plan(spec(kind, rnd, leg)),
                stale_after_polls=25 if kind == "hang" else 0)
        return out

    ref, port = both(tmp_path, monkeypatch, sweep)
    base = port["base"]["tree"]
    for at in all_legs():
        assert port[at]["tree"] == base, at
        for key, n in port[at]["dispatches"].items():
            faulted = key == ("sort" if at[0] == SORT_ROUND
                              else f"r{at[0]}.{at[1]:02d}")
            assert n == (2 if faulted else 1), (at, key)
    assert port == ref


def test_supervisor_killed_at_every_leg_equals_reference(
        tmp_path, monkeypatch, small_graph):
    """The supervisor dies after each leg publishes; a new one resumes
    off the fsck'd manifest and re-dispatches exactly the legs that were
    not done — the reference's counts, events and tree.  One attempt at
    a time (``cores=1``), so what had published when the supervisor died
    does not depend on the scheduler."""
    graph, _ = small_graph

    def sweep(side):
        chaos = mod(side, "supervisor.chaos")
        man = mod(side, "supervisor.manifest")
        out = {"base": supervised(side, graph, "base")}
        for rnd, leg in all_legs():
            sd = f"stop-{rnd}-{leg}"
            died = supervised(side, graph, sd, cores=1,
                              chaos=chaos.parse_fault_plan(
                                  spec("stop", rnd, leg)))
            pre = {m.key: (m.state, m.dispatches)
                   for m in man.load_manifest(sd).legs}
            out[(rnd, leg)] = (died, pre, supervised(side, graph, sd,
                                                     cores=1))
        return out

    ref, port = both(tmp_path, monkeypatch, sweep)
    for at in all_legs():
        died, pre, again = port[at]
        assert died["raised"][0] == "SupervisorKilled"
        assert again["tree"] == port["base"]["tree"], at
        redone = {k for k, n in again["dispatches"].items()
                  if n > pre[k][1]}
        assert redone == {k for k, (st, _) in pre.items() if st != "done"}
    assert port == ref


@pytest.mark.parametrize("stop,victim", [("stop@0:2", "r0.00"),
                                         ("stop@1:0", "r0.00")])
def test_resume_over_a_corrupt_survivor_equals_reference(
        tmp_path, monkeypatch, small_graph, stop, victim):
    """A corrupt survivor still needed is re-dispatched (stop@0:2); one
    whose consumers all finished is not (stop@1:0).  One attempt at a
    time, so the state at the supervisor's death is the scheduler's
    no matter the load."""
    graph, _ = small_graph

    def run(side):
        chaos = mod(side, "supervisor.chaos")
        man = mod(side, "supervisor.manifest")
        died = supervised(side, graph, cores=1,
                          chaos=chaos.parse_fault_plan(stop))
        mm = man.load_manifest("s")
        flip(mm.leg(victim).output, 6)
        pre = {leg.key: leg.dispatches for leg in mm.legs}
        return died, pre, supervised(side, graph, cores=1)

    ref, port = both(tmp_path, monkeypatch, run)
    assert port == ref
    _, pre, again = port
    redone = {k for k, n in again["dispatches"].items() if n > pre[k]}
    assert (victim in redone) == (stop == "stop@0:2")


def test_refusals_equal_reference(tmp_path, monkeypatch, small_graph):
    """A foreign state dir and a spent retry budget fail as the
    reference's do (SupervisionFailed, the same message), and the
    manifest stays for a later resume."""
    graph, _ = small_graph
    other = str(tmp_path / "other.net")
    t2, h2 = rmat_edges(6, 4 << 6, seed=99)
    write_net(other, t2, h2)

    def run(side):
        chaos = mod(side, "supervisor.chaos")
        supervised(side, graph)
        foreign = supervised(side, other)
        # one attempt at a time: what else ran before the budget was
        # spent does not depend on the scheduler
        spent = supervised(side, graph, "b", max_retries=1, cores=1,
                           chaos=chaos.parse_fault_plan("kill@0:1,kill@0:1"))
        return foreign, spent, os.path.exists("b/manifest.json")

    ref, port = both(tmp_path, monkeypatch, run)
    assert port == ref
    assert "refusing to resume" in port[0]["raised"][1]
    assert "budget" in port[1]["raised"][1] and port[2]


def test_speculation_first_finisher_wins_equals_reference(
        tmp_path, monkeypatch, small_graph):
    """A straggler that still beats gets a speculative twin; the twin
    publishes and the straggler's late artifact is discarded."""
    graph, want = small_graph

    def run(side):
        sup = mod(side, "supervisor")
        sup_mod = mod(side, "supervisor.supervise")

        class StragglerRunner(sup.InlineRunner):
            def start(self, argv, hb_path, log_path):
                if "1/4" in argv and any(a.endswith(".a1") for a in argv):
                    def target():
                        with sup.HeartbeatWriter(hb_path, 0.02):
                            time.sleep(1.2)
                        return 1
                    return sup_mod._ThreadHandle(target)
                return super().start(argv, hb_path, log_path)

        rec = supervised(side, graph, runner=StragglerRunner(0.05),
                         speculate_after_s=0.15)
        # a healthy leg that a loaded host slows past 0.15 s gets a twin
        # too: compare what the straggler decides
        return (rec["tree"], rec["dispatches"]["r0.00"],
                repr(("speculate", "r0.00", 2)) in rec["events"],
                repr(("discard", "r0.00", "lost-race")) in rec["events"])

    ref, port = both(tmp_path, monkeypatch, run)
    assert port == ref
    assert port[1:] == (2, True, True)


# ---------------------------------------------------------------------------
# status, the CLI, the production runner
# ---------------------------------------------------------------------------


def _status_masked(rec: dict) -> dict:
    rec = json.loads(json.dumps(rec))
    rec["disk"]["free_bytes"] = None
    rec["mem"]["rss_bytes"] = rec["mem"]["headroom_bytes"] = None
    for leg in rec["legs"]:
        leg["heartbeat_age_s"] = leg["heartbeat_age_s"] is None
    return rec


def test_status_equals_reference(tmp_path, monkeypatch, small_graph):
    """``--status`` and ``--status --json`` of a finished and of a
    killed run: the same report less the live RSS and free space, and
    the same exit codes (2 for --json without --status, 1 without a
    manifest)."""
    graph, _ = small_graph

    def run(side):
        status = mod(side, "supervisor.status")
        cli = mod(side, "cli.supervise")
        chaos = mod(side, "supervisor.chaos")
        supervised(side, graph)
        supervised(side, graph, "k",
                   chaos=chaos.parse_fault_plan("stop@sort:0"))
        out = {}
        for sd in ("s", "k"):
            text = status.render_status(sd)
            out[sd] = (_status_masked(status.status_json(sd)),
                       [ln for ln in text.splitlines()
                        if not ln.startswith(("disk:", "mem:"))])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rcs = [cli.main(["--status", "--json", "-d", "s"]),
                   cli.main(["--status", "-d", "k"]),
                   cli.main(["--json", graph]),
                   cli.main(["--status", "-d", "nowhere"]),
                   cli.main(["--status"]),
                   cli.main(["-q", graph])]
        parsed = json.loads(buf.getvalue().split("\n}\n")[0] + "\n}")
        return out, rcs, _status_masked(parsed)

    ref, port = both(tmp_path, monkeypatch, run)
    assert port == ref
    assert port[1] == [0, 0, 2, 1, 2, 2]
    assert port[2]["done"] and port[2]["legs_done"] == 8
    assert any("resume: rerun" in ln for ln in port[0]["k"][1])


def test_status_of_a_serve_dir_names_the_queue_item(tmp_path, capsys,
                                                    monkeypatch):
    """The twin of tests/test_replicate.py's
    ``test_supervise_status_on_serve_dir``: ``supervise --status`` and
    ``--status --json`` on a live leader's, a live follower's and a dead
    leader's serve state dir print what the reference prints, clock
    fields (ages, latencies, uptimes, pids, ports) masked."""
    import test_replicate as R
    from torch_twin import _empty, clear_fault_plans, port_twin

    def report(side, sd):
        cli = mod(side, "cli.supervise")
        out = []
        for argv in (["--status", "-d", sd],
                     ["--status", "--json", "-d", sd]):
            rc = cli.main(argv)
            out.append((rc, capsys.readouterr().out))
        return out

    def scenario(side, work):
        spawn = R._spawn_cluster if side == "ref" \
            else port_twin(R._spawn_cluster)
        kill = R._abrupt_kill if side == "ref" else port_twin(R._abrupt_kill)
        lead, (fol,), _ = spawn(work, hb_s=0.05, failover_s=30.0)
        try:
            client = mod(side, "serve.protocol").ServeClient
            with client(*lead.address) as c:
                c.insert([(3, 8)])
            addrs = [f"{h}:{p}" for h, p in (lead.address, fol.address)]
            rec = {"lead": report(side, lead.core.state_dir),
                   "fol": report(side, fol.core.state_dir)}
            lead._write_status(force=True)
            kill(lead)
            rec["dead"] = report(side, lead.core.state_dir)
        finally:
            fol.shutdown()
        return masked_status(rec, addrs)

    out = {}
    for side in PKGS:  # one path for both: the reports name the dir
        clear_fault_plans()
        work = tmp_path / "work"
        _empty(work)
        out[side] = scenario(side, work)
    assert out["port"] == out["ref"]
    lead_json = json.loads(out["port"]["lead"][1][1])
    assert lead_json["alive"] and lead_json["role"] == "leader"
    assert lead_json["applied_seqno"] == 1 and lead_json["followers"] == 1
    dead_json = json.loads(out["port"]["dead"][1][1])
    assert not dead_json["alive"] and dead_json["applied_seqno"] == 1
    assert out["port"]["dead"][0][0] == 0


#: report fields that hold clocks, ports or pids
_CLOCK_KEY = re.compile(r"(_ms|_s|^node|^leader|^addr|^pid|^t|"
                        r"^uptime.*)$")


def masked_status(rec: dict, addrs: list) -> dict:
    """The status reports with the addresses and clock fields masked."""
    def mask_json(v):
        if isinstance(v, dict):
            return {k: ("*" if _CLOCK_KEY.search(k) else mask_json(x))
                    for k, x in v.items()}
        if isinstance(v, list):
            return [mask_json(x) for x in v]
        return v

    def mask_text(t: str) -> str:
        for i, a in enumerate(addrs):
            t = t.replace(a, f"ADDR{i}")
        t = re.sub(r"heartbeat \S+", "heartbeat *", t)
        return re.sub(r"^((?:\w+_)?(?:node|leader|addr|uptime_s)): .*$",
                      r"\1: *", t, flags=re.M)

    out = {}
    for node, ((rc_t, text), (rc_j, js)) in rec.items():
        for i, a in enumerate(addrs):
            js = js.replace(a, f"ADDR{i}")
        out[node] = ((rc_t, mask_text(text)),
                     (rc_j, json.dumps(mask_json(json.loads(js)),
                                       sort_keys=True)))
    return out


def _cli_env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    for k in [k for k in env if k.startswith("SHEEP_")]:
        del env[k]
    env.update(extra or {})
    return env


@pytest.mark.parametrize("argv,env", [
    (["-w", "2", "-d", "state", "-o", "g.tre"], {}),
    (["-w", "3", "-r", "3", "-v", "-d", "state"],
     {"SHEEP_FAULT_PLAN": "corrupt@0:1"}),
])
def test_supervise_cli_equals_reference(tmp_path, small_graph, argv, env):
    """``python -m <package>.cli.supervise`` as a process: the same exit
    code, stdout (times masked), tree, manifest and worker logs."""
    graph, want = small_graph
    got = {}
    for side, pkg in PKGS.items():
        d = tmp_path / side
        d.mkdir()
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli.supervise", graph, *argv],
            capture_output=True, text=True, timeout=300, env=_cli_env(env),
            cwd=str(d))
        files = {}
        for root, _, names in os.walk(d):
            for name in names:
                if not name.endswith(".log"):
                    p = os.path.join(root, name)
                    files[os.path.relpath(p, d)] = open(p, "rb").read()
        logs = sorted(os.listdir(d / "state" / "logs"))
        got[side] = (proc.returncode, masked(proc.stdout), files, logs)
    assert got["port"] == got["ref"]
    assert got["port"][0] == 0


MARK = "torch-loaded:"
#: runs ``python -m <module> args...`` and reports torch at exit
WRAPPER = ("import runpy, sys\n"
           "mod = sys.argv.pop(1)\n"
           "sys.argv[0] = mod\n"
           "try:\n"
           "    runpy.run_module(mod, run_name='__main__', alter_sys=True)\n"
           "finally:\n"
           f"    sys.stderr.write('\\n{MARK} %s\\n' % ('torch' in "
           "sys.modules))\n")


def watch_legs(monkeypatch) -> list:
    """Record each leg process the runner starts, and run its module
    through WRAPPER, which reports torch into the leg's log."""
    started = []
    real = subprocess.Popen

    def popen(cmd, *a, **kw):
        started.append(list(cmd))
        if cmd[1] == "-m":
            cmd = [cmd[0], "-c", WRAPPER] + list(cmd[2:])
        return real(cmd, *a, **kw)

    monkeypatch.setattr(subprocess, "Popen", popen)
    return started


def test_subprocess_runner_starts_the_ports_tools_without_torch(
        tmp_path, monkeypatch, small_graph):
    """Every leg the production runner starts is ``python -m
    sheep_tpu_torch.cli.<tool>`` (never the reference's), with the
    heartbeat in its environment; none loads torch; the tree is the
    oracle's."""
    from sheep_tpu_torch.io.trefile import read_tree
    from sheep_tpu_torch.supervisor import SubprocessRunner, run_supervised
    from sheep_tpu_torch.supervisor.supervise import CLI_PACKAGE
    graph, want = small_graph
    started = watch_legs(monkeypatch)
    monkeypatch.chdir(tmp_path)
    m = run_supervised(graph, "s", config("port", workers=2, grammar=False),
                       runner=SubprocessRunner(interval_s=0.05))
    assert CLI_PACKAGE == "sheep_tpu_torch.cli"
    tools = sorted(cmd[2] for cmd in started)
    assert tools == ["sheep_tpu_torch.cli.degree_sequence",
                     "sheep_tpu_torch.cli.graph2tree",
                     "sheep_tpu_torch.cli.graph2tree",
                     "sheep_tpu_torch.cli.merge_trees"]
    assert all(cmd[0] == sys.executable and cmd[1] == "-m"
               for cmd in started)
    logs = [open(os.path.join("s", "logs", n)).read()
            for n in sorted(os.listdir(os.path.join("s", "logs")))]
    assert len(logs) == 4
    for log in logs:
        assert re.findall(rf"^{MARK} (\w+)$", log, re.M) == ["False"], log
    parent, pst = read_tree(m.final_tree)
    np.testing.assert_array_equal(parent, want.parent)
    np.testing.assert_array_equal(pst, want.pst_weight)


def test_inline_runner_imports_the_ports_tools(monkeypatch):
    """The in-process runner resolves each leg's tool in the port."""
    from sheep_tpu_torch.supervisor import InlineRunner
    seen = []
    real = importlib.import_module
    monkeypatch.setattr(importlib, "import_module",
                        lambda name, *a: seen.append(name) or real(name, *a))
    handle = InlineRunner(0.05).start(["fsck", "-q", "/nonexistent"],
                                      os.devnull, os.devnull)
    deadline = time.time() + 30
    while handle.poll() is None and time.time() < deadline:
        time.sleep(0.01)
    assert handle.poll() == 1
    assert seen[0] == "sheep_tpu_torch.cli.fsck"
