"""The port's graph2tree device routes on a mesh of more than one worker
against the reference's (a split of tests/test_torch_cli.py that keeps
each file on one worker short): the reference on that many CPU devices,
the port on that many CPU workers (``parallel.mesh.mesh_devices``
patched), each case run as tests/test_torch_cli.py runs its cases
(``_run_steps``): the same stdout less its timing lines, exit codes and
file bytes, the map route's per-worker partial trees included.
"""

import pytest

from test_torch_cli import G, SEQ, T, _run_steps


#: the device routes on a mesh of more than one worker: id -> (CPU
#: devices of the reference, CPU workers of the port, steps)
MESH_CASES = {
    "mesh_of_two": (2, [G("-i", "-r", "-f", "-c", "-o", "t.tre",
                          env={"SHEEP_WORKERS": "2"})]),
    "map_mesh_of_two": (2, [G("-i", "-s", "i.seq", "-o", "P", "-f", "-c",
                              env={"SHEEP_WORKERS": "2"})]),
    "mesh_of_three": (3, [G("-i", "-r", "-f", "-o", "t.tre")]),
    "workers_capped_by_devices": (2, [G("-i", "-r", "-f", "-o", "t.tre",
                                        env={"SHEEP_WORKERS": "8"})]),
    "map_more_workers_than_devices": (
        2, [G("-i", "-s", "i.seq", "-o", "P", "-f",
              env={"SHEEP_WORKERS": "3"})]),
    "mesh_given_seq": (2, [SEQ, G("-r", "-s", "s.seq", "-o", "t.tre",
                                  "-f")]),
    "mesh_loop_kernel": (2, [G("-i", "-r", "-f", "-o", "t.tre",
                               env={"SHEEP_MESH_KERNEL": "loop"})]),
    "mesh_partition_write": (2, [G("-i", "-r", "-p", "2", "-o", "part")]),
    "mesh_checkpoint": (2, [G("-i", "-r", "--checkpoint-dir", "ck", "-o",
                              "t.tre", "-f")]),
    "mesh_merge_partials": (3, [G("-i", "-s", "i.seq", "-o", "i"),
                                T("merge_trees", "i00r0.tre", "i01r0.tre",
                                  "i02r0.tre", "-o", "i.tre", "-f")]),
}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_route_equals_reference(tmp_path, monkeypatch, case):
    """A mesh of more than one worker (the reference on that many CPU
    devices, the port on that many CPU workers): the same stdout, exit
    codes and file bytes, the map route's per-worker partial trees
    included."""
    devices, steps = MESH_CASES[case]
    got = _run_steps(tmp_path, steps, monkeypatch=monkeypatch,
                     devices=devices)
    if case.startswith("map_mesh"):
        assert sorted(k for k in got if k.endswith("r0.tre")) == \
            ["P00r0.tre", "P01r0.tre"]
