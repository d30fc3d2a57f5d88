"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric found by name; an added file found the same way;
names, units and sizes inside the contract's limits."""

from __future__ import annotations

import json
import re
import shutil
import time

import pytest
import torch

from conftest import REPO, tiny_spec
from harness import session
from harness.spec import TRAFFIC_KEYS, Spec

SPEC = Spec.load(REPO)
BENCHMARK = SPEC.bench
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "portbench/run.py"]
    assert BENCHMARK["paths"] == ["portbench"]
    assert len(json.dumps(BENCHMARK)) <= 64 * 1024


def test_run_seconds_fits_the_full_check():
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell, 1200 s
    spare, inside 43200 s."""
    rs = BENCHMARK["run_seconds"]
    assert 1 <= rs <= 51 and isinstance(rs, int)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", SPEC.cell_names())
def test_every_cell_is_found(cell):
    c = SPEC.cell(cell)
    assert c.config["graph"]["generator"] == "graph500_kronecker"
    kind = SPEC.entry(c.traffic["entry"])
    assert callable(kind.make) and callable(kind.expected)
    assert set(kind.LIMITS.values()) == {0}, "exact builds: limits 0"
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert callable(SPEC.reader(m["name"]))


def test_cells_in_order_on_one_chip():
    assert SPEC.cell_names() == ["lj.build", "orkut.build", "lj.stream"]
    assert all(w["chips"] == 1 for w in BENCHMARK["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_config_is_used_and_its_own_file():
    used = {w["config"] for w in BENCHMARK["workloads"]}
    files = [c["file"] for c in BENCHMARK["configs"]]
    assert {c["name"] for c in BENCHMARK["configs"]} == used
    assert len(set(files)) == len(files)
    for c in BENCHMARK["configs"]:
        assert c["file"].startswith("portbench/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert SPEC.config(c["name"])["name"] == c["name"]


def test_names_units_and_lines():
    things = BENCHMARK["configs"] + BENCHMARK["workloads"] \
        + BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]
    names = [t["name"] for t in things]
    assert all(NAME.match(n) for n in names), names
    for w in BENCHMARK["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"])
    for c in BENCHMARK["configs"]:
        assert LINE.match(c["source"]) and c["source"].startswith("https://")
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("workloads", "end_to_end", "per_layer"):
        group_names = [t["name"] for t in BENCHMARK[group]]
        assert len(set(group_names)) == len(group_names)
    for word in BENCHMARK["command"]:
        assert LINE.match(word)


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert set(e2e) == {"records_per_s", "peak_device_gib", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    cells = set(SPEC.cell_names())
    for m in BENCHMARK["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline_pct"):
            assert m["unit"] == "%"


SEQ_GIVEN = """
from harness import reference
from harness.graph import Graph

PARAMS = ()
LIMITS = {"parent_diff": 0, "pst_diff": 0}


class SeqGiven:
    def __init__(self, graph, traffic, device):
        self.graph, self.device = graph, device
        self.seq = reference.expected(graph.tail, graph.head, graph.vid_slots,
                                      device)["seq"]

    def build(self, perf=None):
        from sheep_tpu_torch.ops.build import build_graph_hybrid

        _, forest = build_graph_hybrid(self.graph.tail, self.graph.head,
                                       seq=self.seq, perf=perf,
                                       device=self.device)
        return {"parent": forest.parent, "pst": forest.pst_weight}


def make(graph, traffic, device):
    return SeqGiven(graph, traffic, device)


def expected(graph, traffic, device):
    return reference.expected(graph.tail, graph.head, graph.vid_slots, device)
"""


def _added(tmp_path):
    """The tiny benchmark plus, as new files and entries only, an entry
    (the hybrid with a given sequence), a traffic mix that drives it, a
    metric reader and a cell."""
    spec = tiny_spec(tmp_path)
    bench_dir = tmp_path / "added"
    shutil.copytree(spec.bench_dir, bench_dir, symlinks=False)
    (bench_dir / "entries" / "seq_given.py").write_text(SEQ_GIVEN)
    (bench_dir / "traffic" / "seq_given.json").write_text(json.dumps(
        {"name": "seq_given", "entry": "seq_given", "why": "added"}))
    (bench_dir / "metrics" / "rounds.py").write_text(
        "def read(run):\n    return run.perf_mean('rounds')\n")
    bench = json.loads(json.dumps(spec.bench))
    bench["workloads"].append({"name": "lj.seq_given", "config": "lj-s23",
                               "traffic": "seq_given", "chips": 1,
                               "why": "added"})
    bench["per_layer"].append({"name": "rounds", "unit": "rounds",
                               "better": "lower", "source": "program_counter",
                               "layer": "reduce loop",
                               "moves": "records_per_s",
                               "workloads": ["lj.seq_given"]})
    return Spec(bench, REPO, str(bench_dir))


def test_an_added_cell_mix_entry_and_metric_are_found(tmp_path):
    """A later PR adds files and entries only: an entry, a traffic file
    that names it, a metric reader and a cell are found by name."""
    spec = _added(tmp_path)
    cell = spec.cell("lj.seq_given")
    assert cell.traffic["name"] == "seq_given"
    assert spec.entry(cell.traffic["entry"]).LIMITS == {"parent_diff": 0,
                                                       "pst_diff": 0}
    assert [m["name"] for m in cell.per_layer] == ["rounds"]
    assert spec.reader("rounds").__module__.endswith("rounds")
    assert "rounds" not in [m["name"] for m in spec.cell("lj.build").per_layer]


@pytest.mark.parametrize("trace", [False, True])
def test_an_added_entry_runs_and_is_checked(tmp_path, trace):
    """The added cell runs through the harness on the CPU, its entry's
    answers compared by its own reference and limits."""
    spec = _added(tmp_path)
    result, _ = session.run_cell(spec, "lj.seq_given", 2**31 + 5, 0.2, trace,
                                 torch.device("cpu"), time.perf_counter())
    assert result["correct"] is True
    assert set(result["check"]) == {"parent_diff", "pst_diff",
                                    "builds_failed"}
    if trace:
        assert result["metrics"]["rounds"]["unit"] == "rounds"


@pytest.mark.parametrize("key", ["callers", "env", "loop"])
def test_a_traffic_key_that_nothing_reads_is_refused(tmp_path, key):
    """A mix may not say more than the harness and its entry read: a
    file asking for four callers would run one."""
    spec = tiny_spec(tmp_path)
    path = tmp_path / "portbench" / "traffic" / "build.json"
    traffic = json.loads(path.read_text())
    traffic[key] = 4
    path.write_text(json.dumps(traffic))
    with pytest.raises(ValueError, match=key):
        spec.cell("lj.build")


def test_every_traffic_key_is_read():
    for w in BENCHMARK["workloads"]:
        traffic = SPEC.traffic(w["traffic"])
        assert set(traffic) <= TRAFFIC_KEYS \
            | set(SPEC.entry(traffic["entry"]).PARAMS)


def test_unknown_cell_refused():
    with pytest.raises(KeyError):
        SPEC.cell("no.such.cell")
