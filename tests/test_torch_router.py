"""The router (port of sheep_tpu/serve/router.py, cli/route.py and
cli/top.py) against the reference's.

Every test of tests/test_router.py (the ring, the cluster grammar,
placement, read spreading, failover retries, the vote rule) and the
three router tests of tests/test_fleetobs.py (the fleet scrape, ``top
--json``, a routed insert's rid through a leader and a follower process)
run twice in one directory: as the reference wrote them, then rebound to
the port (tests/torch_twin.py).  The reference's assertions hold on the
port, and the state dirs both runs leave hold equal ``.wal`` and
``.snap`` bytes.  The ring places the same tenants on the same clusters
as the reference's, and a mixed fleet (a port router in front of
reference daemons and the other way round) answers as a one-package
fleet does.  ``route`` and ``top --json`` run as processes of each
package on the same fleet and print the same lines, addresses and
clocks masked (``test_route_and_top_processes_equal_reference``)."""

import importlib
import json
import os
import subprocess
import sys
import types

import pytest

import test_fleetobs as FO
import test_router as RT
from test_torch_cli import ref_env
from torch_twin import (assert_same, cases, clear_fault_plans, dir_bytes,
                        port_name, run_twin)

PKGS = {"ref": "sheep_tpu", "port": "sheep_tpu_torch"}
STATE = (".wal", ".snap", ".sum")
FLEETOBS_TESTS = ("test_fleet_scrape_labels_and_derived_gauges",
                  "test_top_json_one_shot",
                  "test_rid_round_trip_over_real_sockets_multiprocess")


@pytest.fixture(autouse=True)
def _clean_state():
    """Both packages' fault plans cleared and trace recorders closed
    around each test (tests/test_fleetobs.py's autouse fixture, for both
    packages)."""
    clear_fault_plans()
    saved = {k: os.environ.pop(k, None)
             for k in ("SHEEP_TRACE", "SHEEP_TRACE_MAX_MB")}
    for pkg in PKGS.values():
        tr = importlib.import_module(f"{pkg}.obs.trace")
        tr.close_recorder()
        tr.sample_every()
    yield
    clear_fault_plans()
    for pkg in PKGS.values():
        importlib.import_module(f"{pkg}.obs.trace").close_recorder()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    for pkg in PKGS.values():
        importlib.import_module(f"{pkg}.obs.trace").sample_every()


def state_bytes(work, side):
    return dir_bytes(work, suffixes=STATE)


@pytest.mark.parametrize("name,params", [c[1:] for c in cases(RT)],
                         ids=[c[0] for c in cases(RT)])
def test_router_twin(tmp_path, monkeypatch, name, params):
    assert_same(run_twin(getattr(RT, name), tmp_path, monkeypatch,
                         state_bytes, params=params,
                         before=clear_fault_plans))


def _port_argv(argv):
    """A command line with every ``-m sheep_tpu.<tool>`` module made
    the port's."""
    return [port_name(a) if isinstance(a, str) and a.startswith(
        "sheep_tpu.") else a for a in argv]


#: the ``subprocess`` a port twin sees: the processes it starts run the
#: port's tools (the reference's bodies name their modules in strings)
PORT_SUBPROCESS = types.SimpleNamespace(
    **{k: getattr(subprocess, k) for k in dir(subprocess)
       if not k.startswith("_")})
#: the modules the port twins started, by ``-m``
STARTED = []


def _port_popen(argv, *a, **kw):
    argv = _port_argv(argv)
    STARTED.extend(argv[i + 1] for i, w in enumerate(argv[:-1])
                   if w == "-m")
    return subprocess.Popen(argv, *a, **kw)


PORT_SUBPROCESS.Popen = _port_popen


def _trace_state(work, side):
    """The state dirs' bytes, and the names of the trace files the run
    left (their spans hold clocks)."""
    out = state_bytes(work, side)
    tdir = work / "tr"
    if tdir.is_dir():
        out["traces"] = sorted(p.name for p in tdir.iterdir()
                               if p.suffix == ".trace")
    return out


@pytest.mark.parametrize("name", FLEETOBS_TESTS)
def test_fleetobs_router_twin(tmp_path, monkeypatch, name, capsys):
    def body_kw(side, work, mp):
        import contextlib
        return contextlib.nullcontext({"capsys": capsys})
    out = run_twin(getattr(FO, name), tmp_path, monkeypatch, _trace_state,
                   fixtures=body_kw, before=clear_fault_plans,
                   overrides={"subprocess": PORT_SUBPROCESS})
    assert_same(out)
    if "multiprocess" in name:
        assert STARTED and set(STARTED) == {"sheep_tpu_torch.cli.serve"}


def test_ring_places_tenants_as_the_reference():
    """The port's ring answers every lookup as the reference's, for
    several cluster sets and vnode counts, and ``parse_clusters`` parses
    every spec (and refuses every bad one) alike."""
    got = {}
    for side, pkg in PKGS.items():
        router = importlib.import_module(f"{pkg}.serve.router")
        rec = []
        for ids in (["c0", "c1"], ["a", "b", "c", "d"], ["x"]):
            for vnodes in (1, 16, 64):
                ring = router.HashRing(ids, vnodes=vnodes)
                rec.append([ring.lookup(f"t{i}") for i in range(300)])
        for spec in ("d1/,d2/;x@h:1,h:2", "a", "a@h:1;b@h:2,h:3", "",
                     ";;", "x@", "a@p;a@q"):
            try:
                rec.append(router.parse_clusters(spec))
            except ValueError as exc:
                rec.append(("ValueError", str(exc)))
        got[side] = rec
    assert got["port"] == got["ref"]


def _mixed(tmp_path, router_side, daemon_side):
    """Two single-node clusters of ``daemon_side``'s package with four
    tenants, behind a router of ``router_side``'s: each tenant's insert
    and reads through the router, ``ROUTER`` counters; returns the
    answers and the state dirs' bytes."""
    from sheep_tpu.io.edges import write_dat
    from sheep_tpu.utils.synth import rmat_edges
    tmp_path.mkdir()
    D = importlib.import_module(f"{PKGS[daemon_side]}.serve")
    R = importlib.import_module(f"{PKGS[router_side]}.serve.router")
    tail, head = rmat_edges(7, 4 << 7, seed=5)
    g = str(tmp_path / "g.dat")
    write_dat(g, tail, head)
    ring = R.HashRing(["c0", "c1"])
    tenants = ["t0", "t1", "t2", "t3"]
    daemons = {}
    for cid in ("c0", "c1"):
        core = D.ServeCore.bootstrap(str(tmp_path / f"{cid}-dflt"),
                                     graph_path=g, num_parts=3)
        specs = [D.TenantSpec(t, str(tmp_path / f"{cid}-{t}"), g, 3)
                 for t in tenants if ring.lookup(t) == cid]
        daemons[cid] = D.ServeDaemon(
            core, D.ServeConfig(),
            tenants=D.TenantManager(core, specs)).start()
    router = R.Router({cid: [d.core.state_dir]
                       for cid, d in daemons.items()}).start()
    answers = []
    try:
        with D.ServeClient(*router.address) as c:
            for t in tenants:
                answers.append(c.tenant(t))
                answers.append(c.insert([(1, 4), (2, 9)]))
                answers.append(c.part(list(range(30))))
                answers.append(c.kv("CRC")["crc"])
            rs = c.kv("ROUTER")
            answers.append({k: rs[k] for k in ("writes", "clusters")})
    finally:
        router.shutdown()
        for d in daemons.values():
            d.shutdown()
    return answers, dir_bytes(tmp_path, suffixes=STATE)


@pytest.mark.parametrize("router_side,daemon_side",
                         [("port", "ref"), ("ref", "port")])
def test_mixed_router_and_daemons(tmp_path, router_side, daemon_side):
    """A router of one package in front of the other package's daemons
    answers and leaves state dirs as a reference-only fleet does: the
    wire between them is the reference's."""
    want = _mixed(tmp_path / "ref", "ref", "ref")
    got = _mixed(tmp_path / "mixed", router_side, daemon_side)
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    for key in want[1]:
        if key.endswith(".snap") or key.endswith(".sum"):
            continue  # a snapshot records its graph's absolute path
        assert got[1][key] == want[1][key], key


#: top --json values that hold clocks, sizes of clocks or memory
_TOP_CLOCKS = ("vmrss_mb", "window_p99_ms", "scrape_s", "scrape_bytes",
               "uptime_s")


def _masked_top(view, addrs: dict):
    """``top --json``'s view with each member's address named by its
    cluster and the clock-bound values masked."""
    def mask(v, key=None):
        if key in _TOP_CLOCKS:
            return "*"
        if isinstance(v, dict):
            return {addrs.get(k, k): mask(x, k) for k, x in v.items()}
        if isinstance(v, list):
            return sorted(mask(x) for x in v)
        return addrs.get(v, v) if isinstance(v, str) else v
    return mask(view)


def _route_and_top(work, side):
    """Two single-node clusters (``side``'s daemons in process) with
    four tenants on their ring clusters, ``python -m <pkg>.cli.route``
    in front of them, a routed insert and read per tenant, then
    ``python -m <pkg>.cli.top --json -i 0 -d <router dir>``, twice (the
    second after the first scrape's requests), and the router stopped
    with SIGTERM: each tool's exit code and masked stdout."""
    import importlib
    import signal
    import time
    from sheep_tpu.io.edges import write_dat
    from sheep_tpu.utils.synth import rmat_edges
    pkg = {"ref": "sheep_tpu", "port": "sheep_tpu_torch"}[side]
    S = importlib.import_module(f"{pkg}.serve")
    work.mkdir()
    tail, head = rmat_edges(6, 4 << 6, seed=11)
    g = str(work / "g.dat")
    write_dat(g, tail, head)
    tenants = [f"web{i}" for i in range(4)]
    ring = S.HashRing(["c0", "c1"])
    daemons = {}
    try:
        for cid in ("c0", "c1"):
            core = S.ServeCore.bootstrap(str(work / cid), graph_path=g,
                                         num_parts=3)
            specs = [S.TenantSpec(t, str(work / f"{cid}-{t}"), g, 3)
                     for t in tenants if ring.lookup(t) == cid]
            daemons[cid] = S.ServeDaemon(
                core, S.ServeConfig(),
                tenants=S.TenantManager(core, specs)).start()
        addrs = {"{}:{}".format(*d.address): f"<{cid}>"
                 for cid, d in daemons.items()}
        rdir = str(work / "router")
        env = ref_env({})
        route = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.cli.route", "-d", rdir,
             "--cluster", f"c0@{work / 'c0'}",
             "--cluster", f"c1@{work / 'c1'}"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=str(work))
        try:
            deadline = time.monotonic() + 120
            addr_file = os.path.join(rdir, "router.addr")
            while not os.path.exists(addr_file):
                assert time.monotonic() < deadline, route.stderr.read()
                time.sleep(0.05)
            time.sleep(0.1)
            host, port = open(addr_file).read().split()
            addrs[f"{host}:{port}"] = "<router>"
            answers = []
            with S.ServeClient(host, int(port), timeout_s=30) as c:
                for t in tenants:
                    answers.append(c.tenant(t))
                    answers.append(c.insert([(1, 4), (2, 9)]))
                    answers.append(c.part(list(range(16))))
            tops = []
            for _ in range(2):
                top = subprocess.run(
                    [sys.executable, "-m", f"{pkg}.cli.top", "--json",
                     "-i", "0", "-d", rdir], capture_output=True,
                    text=True, env=env, cwd=str(work), timeout=120)
                view = json.loads(top.stdout) if top.returncode == 0 \
                    else top.stdout
                tops.append((top.returncode, _masked_top(view, addrs)))
        finally:
            route.send_signal(signal.SIGTERM)
            out, err = route.communicate(timeout=60)
        lines = [ln.replace(f"{host}:{port}", "<router>")
                 for ln in out.splitlines()]
        return {"route": (route.returncode, lines), "answers": answers,
                "top": tops}
    finally:
        for d in daemons.values():
            d.shutdown()


def test_route_and_top_processes_equal_reference(tmp_path):
    """``route`` and ``top --json`` as processes of each package, on the
    same fleet and requests: the same exit codes, the router's stdout,
    the routed answers and ``top``'s view (tenants on their ring
    clusters, resident, requests, seqnos; the fleet gauges), with
    addresses and clocks masked."""
    got = {side: _route_and_top(tmp_path / side, side)
           for side in ("ref", "port")}
    assert got["port"] == got["ref"]
    rc, view = got["port"]["top"][-1]
    assert rc == 0 and set(view["tenants"]) >= {"web0", "web3"}
    assert got["port"]["route"][0] == 0


def test_fleet_drive_moves_a_hot_tenant_end_to_end(tmp_path):
    """``scripts/fleet_drive.py`` (chip_smoke's ``fleet`` phase) at a
    small size: two ``cli.serve`` clusters and a ``cli.route`` process
    with the rebalancer on, a hot tenant moved by the rebalancer's own
    verdict under insert and read traffic, every acknowledged insert
    applied once at its tenant's final owner, the source answering
    ``ERR moved``, the crc at the cut equal to the source's sealed one,
    ``top --json`` showing the move, fsck of every state dir: every check
    holds."""
    from sheep_tpu_torch.io import write_dat
    from sheep_tpu_torch.serve import ServeCore
    from sheep_tpu_torch.utils.synth import rmat_edges
    for name, log_n, seed in (("sd", 12, 0), ("cut", 10, 1)):
        tail, head = rmat_edges(log_n, 8 << log_n, seed=seed)
        write_dat(str(tmp_path / f"{name}.dat"), tail, head)
        ServeCore.bootstrap(str(tmp_path / name),
                            graph_path=str(tmp_path / f"{name}.dat"),
                            num_parts=2).close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "sheep_tpu_torch.scripts.fleet_drive", "run",
         str(tmp_path / "work"), "--hot", str(tmp_path / "sd"),
         "--cut", str(tmp_path / "cut"), "--deadline-s", "120"],
        capture_output=True, text=True, env=env, cwd=repo, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("fleet_record "))
    rec = json.loads(line.split(" ", 1)[1])
    assert all(rec["checks"].values()), rec["checks"]
    assert rec["verdicts"]["migrate"] == 1
    assert rec["applied"]["hot"] > rec["crc"]["sealed_seqno"]
