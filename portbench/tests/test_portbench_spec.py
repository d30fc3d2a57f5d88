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
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
#: cells of an accepted benchmark: later PRs append cells, and take
#: none of these away
ACCEPTED = ("lj.build", "orkut.build", "lj.stream", "orkut.stream")


def top_level_keys(spec):
    bench = spec.bench
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert len(json.dumps(bench)) <= 64 * 1024


def run_seconds_fits_the_full_check(spec):
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell, 1200 s
    spare, inside 43200 s: the check of the most cells later PRs may
    bring."""
    rs = spec.bench["run_seconds"]
    assert 1 <= rs <= 51 and isinstance(rs, int)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def cells_and_chips(spec):
    """Rules that hold for any list of cells the contract allows; none
    names the whole list or its length."""
    cells = spec.bench["workloads"]
    assert 1 <= len(cells) <= 24, f"{len(cells)} cells"
    assert all(w["chips"] in (1, 4) for w in cells), \
        "chips other than 1 or 4"
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4), \
        f"{four} cells ask for 4 chips of {len(cells)}"
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs), "a (config, traffic) pair twice"
    missing = sorted(set(ACCEPTED) - set(spec.cell_names()))
    assert not missing, f"accepted cells taken away: {missing}"
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}


def configs_used_and_own_files(spec):
    configs = spec.bench["configs"]
    used = {w["config"] for w in spec.bench["workloads"]}
    files = [c["file"] for c in configs]
    assert 1 <= len(configs) <= 24
    assert {c["name"] for c in configs} == used
    assert len(set(files)) == len(files)
    for c in configs:
        assert c["file"].startswith("portbench/") and ".." not in c["file"]
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert spec.config(c["name"])["name"] == c["name"]


def names_units_and_lines(spec):
    bench = spec.bench
    things = bench["configs"] + bench["workloads"] \
        + bench["end_to_end"] + bench["per_layer"]
    names = [t["name"] for t in things]
    assert all(NAME.match(n) for n in names), names
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"])
    for c in bench["configs"]:
        assert LINE.match(c["source"]) and c["source"].startswith("https://")
        assert LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [t["name"] for t in bench[group]]
        assert len(set(group_names)) == len(group_names)
    for word in bench["command"]:
        assert LINE.match(word)


def every_cell_is_found(spec):
    """Each cell's configuration, mix, entry and readers are found by
    name; each reports set-up, another end-to-end metric and at least
    one per-layer metric."""
    for name in spec.cell_names():
        c = spec.cell(name)
        assert c.config["graph"]["generator"] == "graph500_kronecker"
        kind = spec.entry(c.traffic["entry"])
        assert callable(kind.make) and callable(kind.expected)
        assert set(kind.LIMITS.values()) == {0}, "exact builds: limits 0"
        names = [m["name"] for m in c.end_to_end]
        assert "setup_s" in names and len(names) >= 2, name
        assert c.per_layer, f"{name} reports no per-layer metric"
        for m in c.end_to_end + c.per_layer:
            assert callable(spec.reader(m["name"]))


def metric_entries(spec):
    """Bounds and sources as the contract has them; each per-layer metric
    lists cells that report the end-to-end metric it moves."""
    e2e = {m["name"]: m for m in spec.bench["end_to_end"]}
    per_layer = spec.bench["per_layer"]
    assert set(e2e) == {"records_per_s", "peak_device_gib", "setup_s"}
    assert 1 <= len(per_layer) <= 128
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = set(spec.cell_names())
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert set(m.get("workloads", cells)) <= cells
    for m in per_layer:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in [x["name"] for x in
                                  spec.metrics("end_to_end", cell)]
        if m["name"].endswith("_roofline_pct"):
            assert m["unit"] == "%"


def every_traffic_key_is_read(spec):
    for w in spec.bench["workloads"]:
        traffic = spec.traffic(w["traffic"])
        assert set(traffic) <= TRAFFIC_KEYS \
            | set(spec.entry(traffic["entry"]).PARAMS)


def check_contract(spec):
    """Every rule this repository holds ``BENCHMARK.json`` and its files
    to.  It has to hold for the repository's benchmark, and for the same
    benchmark with a later PR's new files and appended entries."""
    for rule in (top_level_keys, run_seconds_fits_the_full_check,
                 cells_and_chips, configs_used_and_own_files,
                 names_units_and_lines, every_cell_is_found,
                 metric_entries, every_traffic_key_is_read):
        rule(spec)


def test_the_repository_s_benchmark_keeps_the_contract():
    check_contract(SPEC)


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
    """The tiny benchmark plus what a later PR brings, as new files and
    appended entries only: an entry (the hybrid with a given sequence)
    and a traffic mix that drives it; a configuration copied from
    ``lj-s23`` with 2^25 vid slots and its ``configs`` entry; two cells;
    a metric reader that lists both; and the second cell's name appended
    to ``loop_s``'s ``workloads``."""
    tiny = tiny_spec(tmp_path / "tiny")
    root = tmp_path / "added"
    shutil.copytree(tmp_path / "tiny", root, symlinks=False)
    bench_dir = root / "portbench"
    (bench_dir / "entries" / "seq_given.py").write_text(SEQ_GIVEN)
    (bench_dir / "traffic" / "seq_given.json").write_text(json.dumps(
        {"name": "seq_given", "entry": "seq_given", "why": "added"}))
    (bench_dir / "metrics" / "rounds.py").write_text(
        "def read(run):\n    return run.perf_mean('rounds')\n")
    cfg = json.loads((bench_dir / "configs" / "lj-s23.json").read_text())
    cfg["name"] = "g500-s25"
    cfg["graph"]["log_vid_slots"] = 25
    (bench_dir / "configs" / "g500-s25.json").write_text(json.dumps(cfg))
    bench = json.loads(json.dumps(tiny.bench))
    bench["configs"].append({"name": "g500-s25",
                             "source": "https://graph500.org/?page_id=12",
                             "file": "portbench/configs/g500-s25.json",
                             "reduced": [], "why": "added"})
    bench["workloads"] += [
        {"name": "lj.seq_given", "config": "lj-s23", "traffic": "seq_given",
         "chips": 1, "why": "added"},
        {"name": "s25.seq_given", "config": "g500-s25",
         "traffic": "seq_given", "chips": 1, "why": "added"}]
    bench["per_layer"].append({"name": "rounds", "unit": "rounds",
                               "better": "lower", "source": "program_counter",
                               "layer": "reduce loop",
                               "moves": "records_per_s",
                               "workloads": ["lj.seq_given",
                                             "s25.seq_given"]})
    for m in bench["per_layer"]:
        if m["name"] == "loop_s":
            m["workloads"].append("s25.seq_given")
    return Spec(bench, str(root), str(bench_dir))


def test_an_added_config_and_cell_keep_the_contract(tmp_path):
    """The rules that hold the repository's benchmark hold it with a
    later PR's files and entries added, so no rule can pin the cells."""
    check_contract(_added(tmp_path))


def test_an_added_cell_mix_entry_and_metric_are_found(tmp_path):
    """A later PR adds files and entries only: an entry, a traffic file
    that names it, a configuration, a metric reader and cells are found
    by name."""
    spec = _added(tmp_path)
    cell = spec.cell("lj.seq_given")
    assert cell.traffic["name"] == "seq_given"
    assert spec.entry(cell.traffic["entry"]).LIMITS == {"parent_diff": 0,
                                                       "pst_diff": 0}
    assert [m["name"] for m in cell.per_layer] == ["rounds"]
    assert spec.reader("rounds").__module__.endswith("rounds")
    assert "rounds" not in [m["name"] for m in spec.cell("lj.build").per_layer]
    s25 = spec.cell("s25.seq_given")
    assert s25.config["graph"]["log_vid_slots"] == 25
    assert [m["name"] for m in s25.per_layer] == ["loop_s", "rounds"]


def _cells_with(change):
    bench = json.loads(json.dumps(SPEC.bench))
    change(bench["workloads"])
    return Spec(bench, REPO)


def _many(cells):
    cells += [dict(cells[0], name=f"x{i}", traffic=f"t{i}")
              for i in range(25 - len(cells))]


def _over_a_quarter_on_four(cells):
    for w in cells[:max(1, len(cells) // 4) + 1]:
        w["chips"] = 4


def _chips_2(cells):
    cells[0]["chips"] = 2


def _pair_twice(cells):
    cells.append(dict(cells[0], name="lj.build2"))


def _accepted_gone(cells):
    cells[:] = [w for w in cells if w["name"] != "orkut.stream"]


@pytest.mark.parametrize("change, says", [
    (_many, "25 cells"), (_over_a_quarter_on_four, "cells ask for 4 chips"),
    (_chips_2, "chips other than 1 or 4"), (_pair_twice, "pair twice"),
    (_accepted_gone, "accepted cells taken away")])
def test_cells_outside_the_rules_are_refused(change, says):
    with pytest.raises(AssertionError, match=says):
        cells_and_chips(_cells_with(change))


def _a_quarter_on_four(cells):
    cells += [dict(cells[0], name=f"y{i}", traffic=f"u{i}")
              for i in range(8 - len(cells))]
    for w in cells[:len(cells) // 4]:
        w["chips"] = 4


@pytest.mark.parametrize("change", [lambda cells: cells[0].update(chips=4),
                                    _a_quarter_on_four])
def test_a_quarter_of_the_cells_may_take_four_chips(change):
    """One cell on four chips always, and a quarter of eight or more."""
    cells_and_chips(_cells_with(change))


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


def test_unknown_cell_refused():
    with pytest.raises(KeyError):
        SPEC.cell("no.such.cell")
