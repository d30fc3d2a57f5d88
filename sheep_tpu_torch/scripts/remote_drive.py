"""Drive the distributed out-of-core build with its legs shipped to two
remote worker daemons, as a user would run it, and check what it
writes.  Host code: no process it starts loads torch.

    python -m sheep_tpu_torch.scripts.remote_drive run WORK --graph E.dat \\
        --want D.tre [--oracle D_ram.tre] [--budget 192M] [--legs 2]

The steps (any failed check raises, so the exit code is 1):

1. two workers ``python -m sheep_tpu_torch.cli.worker -d WORK/w<i>``,
   each with a state dir of its own and no memory budget: a worker
   holds the whole slice it is shipped in memory while its leg folds,
   so under the job's budget its fold would price its blocks against
   that RSS down to the floor;
2. ``python -m sheep_tpu_torch.cli.graph2tree E.dat --distext -o
   WORK/S.tre`` with ``SHEEP_WORKER_ADDRS`` naming both workers,
   ``SHEEP_WORKER_TRANSPORT=ship``, ``SHEEP_MEM_BUDGET=budget`` and
   ``SHEEP_DISTEXT_LEGS=legs``: the tree equals ``--want`` (and
   ``--oracle``) byte for byte, every leg is dispatched once and the
   hist and map legs went over the wire;
3. the first worker restarted under ``SHEEP_SERVE_NETFAULT_PLAN=
   partition@wart:0`` (its first artifact return torn mid-payload) and
   the job run again: exactly that leg is re-dispatched and the tree is
   the same;
4. ``python -m sheep_tpu_torch.cli.supervise --status -d`` on the job's
   state dir lists the remote legs with their worker.

Prints one ``remote_record {...}`` line: the checks, each job's wall and
dispatch counts, the bytes each worker was shipped (its METRICS scrape),
the re-dispatched leg and the status report's worker column.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

DEADLINE_S = 120.0


def _same(a: str, b: str) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


class Worker:
    """One ``cli.worker`` process and its state dir."""

    def __init__(self, name: str, work: str):
        self.name = name
        self.state_dir = os.path.join(work, name)
        self.log = os.path.join(work, f"{name}.log")
        self.proc: subprocess.Popen | None = None
        self.addr: tuple | None = None

    def start(self, env: dict) -> "Worker":
        from ..serve.worker import read_worker_addr
        addr = os.path.join(self.state_dir, "worker.addr")
        if os.path.exists(addr):
            os.unlink(addr)
        full = dict(os.environ)
        full.update(env)
        with open(self.log, "a") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "sheep_tpu_torch.cli.worker", "-d",
                 self.state_dir], stdout=log, stderr=subprocess.STDOUT,
                env=full)
        deadline = time.monotonic() + DEADLINE_S
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise AssertionError(f"remote_drive: worker {self.name} "
                                     f"exited {self.proc.returncode}")
            try:
                self.addr = read_worker_addr(self.state_dir)
                return self
            except (OSError, ValueError):
                pass
            time.sleep(0.05)
        raise TimeoutError(f"remote_drive: worker {self.name} never wrote "
                           f"its address")

    def shipped_bytes(self) -> float:
        from ..obs.metrics import parse_prometheus
        from ..serve.protocol import ServeClient
        with ServeClient(*self.addr, timeout_s=30.0) as c:
            body = c.metrics()
        return sum(v for n, _, v in parse_prometheus(body)
                   if n == "sheep_worker_bytes_shipped")

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def _job(a, out: str, workers: list) -> dict:
    """One ``graph2tree --distext`` job shipped to ``workers``."""
    env = dict(os.environ,
               SHEEP_WORKER_ADDRS=",".join(f"{h}:{p}" for h, p in
                                           (w.addr for w in workers)),
               SHEEP_WORKER_TRANSPORT="ship", SHEEP_MEM_BUDGET=a.budget,
               SHEEP_DISTEXT_LEGS=str(a.legs))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sheep_tpu_torch.cli.graph2tree", a.graph,
         "--distext", "-o", out], capture_output=True, text=True, env=env,
        timeout=1200)
    wall = time.perf_counter() - t0
    state = out + ".distext"
    if proc.returncode != 0:
        raise AssertionError(f"remote_drive: graph2tree --distext exited "
                             f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-2000:]}")
    with open(os.path.join(state, "manifest.json")) as f:
        legs = json.load(f)["legs"]
    wires = {}
    for name in sorted(os.listdir(state)):
        if name.startswith("wire-"):
            with open(os.path.join(state, name)) as f:
                wires[name[len("wire-"):-len(".json")]] = json.load(f)
    return {"wall_s": wall, "state": state,
            "dispatches": {leg["key"]: leg["dispatches"] for leg in legs},
            "wire": wires}


def run_main(a) -> int:
    """Steps 1-4 (the module docstring); prints the ``remote_record``."""
    work = os.path.abspath(a.work)
    os.makedirs(work, exist_ok=True)
    checks, rec = {}, {"budget": a.budget, "legs": a.legs}
    env = {"SHEEP_MEM_BUDGET": "", "SHEEP_SERVE_NETFAULT_PLAN": ""}
    workers = [Worker("w1", work), Worker("w2", work)]
    try:
        for w in workers:
            w.start(env)
        tree = os.path.join(work, "S.tre")
        job = _job(a, tree, workers)
        rec["shipped"] = {k: v for k, v in job.items() if k != "state"}
        rec["shipped"]["bytes_shipped"] = {w.name: w.shipped_bytes()
                                           for w in workers}
        checks["tree_equals_local"] = _same(tree, a.want)
        if a.oracle:
            checks["tree_equals_oracle"] = _same(tree, a.oracle)
        checks["each_leg_once"] = set(job["dispatches"].values()) == {1}
        checks["hist_and_map_legs_shipped"] = len(job["wire"]) == 2 * a.legs
        checks["every_worker_used"] = all(
            os.path.isdir(w.state_dir) and any(
                n.endswith(".slice.dat") for n in os.listdir(w.state_dir))
            for w in workers)

        # the first worker's first artifact return torn mid-payload
        workers[0].stop()
        workers[0].start(dict(env,
                              SHEEP_SERVE_NETFAULT_PLAN="partition@wart:0"))
        torn = os.path.join(work, "T.tre")
        job = _job(a, torn, workers)
        rec["torn"] = {k: v for k, v in job.items() if k != "state"}
        again = [k for k, v in job["dispatches"].items() if v == 2]
        rec["torn"]["redispatched"] = again
        checks["torn_return_redispatched_once"] = (
            len(again) == 1 and sorted(job["dispatches"].values())
            == [1] * (len(job["dispatches"]) - 1) + [2])
        checks["torn_tree_equal"] = _same(torn, a.want)

        status = subprocess.run(
            [sys.executable, "-m", "sheep_tpu_torch.cli.supervise",
             "--status", "-d", job["state"]], capture_output=True,
            text=True, timeout=120)
        rows = [ln for ln in status.stdout.splitlines()
                if any(f"{h}:{p}" in ln for h, p in (w.addr for w in workers))]
        rec["status_rows"] = rows
        checks["status_shows_remote_legs"] = (
            status.returncode == 0 and "WORKER" in status.stdout
            and len(rows) == 2 * a.legs)
    except BaseException:
        for w in workers:
            try:
                sys.stderr.write(f"--- {w.name} log ---\n"
                                 f"{open(w.log).read()[-3000:]}\n")
            except OSError:
                pass
        raise
    finally:
        for w in workers:
            w.stop()
    rec["checks"] = checks
    print("remote_record " + json.dumps(rec), flush=True)
    if not all(checks.values()):
        raise AssertionError(f"remote_drive: checks failed: {checks}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="remote_drive")
    ap.add_argument("mode", choices=("run",))
    ap.add_argument("work")
    ap.add_argument("--graph", required=True)
    ap.add_argument("--want", required=True)
    ap.add_argument("--oracle")
    ap.add_argument("--budget", default="192M")
    ap.add_argument("--legs", type=int, default=2)
    a = ap.parse_args(argv)
    return run_main(a)


if __name__ == "__main__":
    sys.exit(main())
