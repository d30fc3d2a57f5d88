"""``BENCHMARK.json`` and the files it names, found by name.

- a cell is an entry of ``workloads``;
- a configuration is the JSON file its ``configs`` entry names;
- a traffic mix is ``portbench/traffic/<traffic>.json``;
- the timed entry a mix drives is ``portbench/entries/<entry>.py``, by
  the mix's ``entry`` key: ``make(graph, traffic, device)`` gives an
  object whose ``build(perf)`` is one timed build, ``expected(graph,
  traffic, device)`` the reference's answer, ``LIMITS`` each number
  compared with its limit, ``PARAMS`` the mix's keys the entry reads;
- a metric is read by ``portbench/metrics/<name>.py``, whose ``read(run)``
  returns a number, or None where the run has nothing to read.

A later cell, mix, entry or metric is a new file and a new entry:
nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
#: the keys of a traffic file that the harness itself reads (a mix is
#: one caller in a closed loop; ``why`` and ``reduced`` are for readers)
TRAFFIC_KEYS = {"name", "entry", "why", "reduced"}


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


class Spec:
    """The benchmark as ``BENCHMARK.json`` states it.  ``root`` is the
    directory its relative paths start from (the checkout)."""

    def __init__(self, bench: dict, root: str = REPO,
                 bench_dir: str = BENCH_DIR):
        self.bench = bench
        self.root = root
        self.bench_dir = bench_dir
        self._modules = {}

    @classmethod
    def load(cls, root: str = REPO) -> "Spec":
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            return cls(json.load(fh), root)

    def cell_names(self) -> list:
        return [w["name"] for w in self.bench["workloads"]]

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as fh:
                    return json.load(fh)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        """The mix, refused where it has a key that neither the harness
        nor its entry reads: the file has to describe the traffic that
        runs."""
        path = os.path.join(self.bench_dir, "traffic", f"{name}.json")
        with open(path) as fh:
            traffic = json.load(fh)
        unread = set(traffic) - TRAFFIC_KEYS \
            - set(self.entry(traffic["entry"]).PARAMS)
        if unread:
            raise ValueError(f"traffic {name!r} has keys that nothing "
                             f"reads: {sorted(unread)}")
        return traffic

    def entry(self, name: str):
        """The module ``entries/<name>.py``."""
        return self._module("entries", name)

    def metrics(self, kind: str, cell: str) -> list:
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell``
        reports: those that list it, and those that list no cells."""
        return [m for m in self.bench[kind]
                if cell in m.get("workloads", [cell])]

    def cell(self, name: str) -> Cell:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return Cell(name, w, self.config(w["config"]),
                            self.traffic(w["traffic"]),
                            self.metrics("end_to_end", name),
                            self.metrics("per_layer", name))
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{self.cell_names()}")

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        return self._module("metrics", metric).read

    def _module(self, folder: str, name: str):
        if (folder, name) in self._modules:
            return self._modules[folder, name]
        path = os.path.join(self.bench_dir, folder, f"{name}.py")
        mod_name = f"portbench_{folder}_" + name.replace(".", "_").replace(
            "-", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or not os.path.exists(path):
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        self._modules[folder, name] = mod
        return mod
