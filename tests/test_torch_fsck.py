"""The port's fsck (integrity/fsck.py, cli/fsck.py) against the
reference's: a clean trial directory, each artifact class fuzzed under
each policy, ``--repair-sidecar``, and the artifacts of unported modules,
which are reported as failures naming their ROADMAP.md queue item."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

from sheep_tpu.cli import fsck as ref_cli
from sheep_tpu.integrity import fsck as ref_fsck
from sheep_tpu_torch import QUEUE
from sheep_tpu_torch.cli import fsck as port_cli
from sheep_tpu_torch.integrity import fsck as port_fsck

#: artifact classes the port checks itself
CLASSES = ("t.tre", "s.seq", "b.seq", "g.dat", "g.net",
           "ck/sheep-ckpt.npz", "run.trace")


def _trial_dir(root) -> str:
    """One artifact of each class, written by the port's writers."""
    from sheep_tpu_torch.core import build_forest, degree_sequence
    from sheep_tpu_torch.io import (write_dat, write_net, write_sequence,
                                    write_tree)
    from sheep_tpu_torch.obs.trace import TraceRecorder
    from sheep_tpu_torch.runtime.snapshot import (Checkpointer, Snapshot,
                                                  input_signature)

    d = str(root)
    rng = np.random.default_rng(11)
    tail = rng.integers(0, 200, 600).astype(np.uint32)
    head = rng.integers(0, 200, 600).astype(np.uint32)
    seq = degree_sequence(tail, head)
    forest = build_forest(tail, head, seq)
    write_dat(os.path.join(d, "g.dat"), tail, head)
    write_net(os.path.join(d, "g.net"), tail, head)
    write_sequence(seq, os.path.join(d, "s.seq"))
    write_sequence(seq, os.path.join(d, "b.seq"), binary=True)
    write_tree(os.path.join(d, "t.tre"), forest.parent, forest.pst_weight,
               sig=input_signature(len(seq), seq))
    n = len(seq)
    lo = np.arange(0, n - 1, dtype=np.int32)
    snap = Snapshot(n=n, seq=seq, pst=forest.pst_weight, lo=lo, hi=lo + 1,
                    rounds=3, boundary=1, rung="single",
                    input_sig=input_signature(n, seq, tail, head))
    Checkpointer(os.path.join(d, "ck")).save(snap)
    rec = TraceRecorder(os.path.join(d, "run.trace"))
    with rec.span("build", {"n": n}):
        rec.event("checkpoint", {"boundary": 1})
    rec.close()
    return d


def _results(module, paths, mode):
    results, failures = module.fsck_paths(paths, mode)
    return results, len(failures)


def test_clean_dir_equals_reference(tmp_path):
    d = _trial_dir(tmp_path)
    got = _results(port_fsck, [d], None)
    want = _results(ref_fsck, [d], None)
    assert got == want
    assert got[1] == 0 and len(got[0]) == len(CLASSES)


def _fuzz(path: str, kind: str) -> None:
    data = bytearray(open(path, "rb").read())
    if kind == "flip":
        data[len(data) // 2] ^= 0x5A
    elif kind == "truncate":
        data = data[: len(data) - 5]
    elif kind == "append":
        data += b"\x07garbage"
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("mode", ["strict", "repair", "trust"])
@pytest.mark.parametrize("kind", ["flip", "truncate", "append"])
@pytest.mark.parametrize("name", CLASSES)
def test_fuzzed_artifact_equals_reference(tmp_path, name, kind, mode):
    d = _trial_dir(tmp_path)
    _fuzz(os.path.join(d, name), kind)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _results(port_fsck, [d], mode)
        want = _results(ref_fsck, [d], mode)
    assert got == want
    if mode == "strict":
        assert got[1] >= 1, "strict fsck passed a fuzzed artifact"


def _run_cli(module, argv, cwd):
    out = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            rc = module.main(argv)
    finally:
        os.chdir(old)
    return rc, out.getvalue()


@pytest.mark.parametrize("argv", [["."], ["-q", "."], ["-m", "repair", "."],
                                  ["-R", "."], ["-R", "-q", "t.tre"],
                                  ["-m", "bogus", "."], []])
def test_cli_equals_reference(tmp_path, argv):
    """The tool's report and exit code, on a directory whose tree lost its
    sidecar and whose .net is corrupt (a reseal must refuse it)."""
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        _trial_dir(d)
        os.remove(d / "t.tre.sum")
        _fuzz(str(d / "g.net"), "append")
    want = _run_cli(ref_cli, list(argv), str(tmp_path / "ref"))
    got = _run_cli(port_cli, list(argv), str(tmp_path / "port"))
    assert got == want
    if argv and argv[0] == "-R":
        assert os.path.exists(tmp_path / "port" / "t.tre.sum")


UNPORTED = {
    "serve.wal": "serve", "snap-000000000001.snap": "serve",
    "leg0.hist": "distext", "manifest.json": "supervisor",
    "reseq.json": "serve", "scrub.json": "serve",
    "quarantine.json": "serve", "old.tre.quarantined": "serve",
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_artifact_is_a_failure(tmp_path, name):
    """An artifact only an unported module can check fails, naming the
    queue item it waits for; the port's own artifacts beside it pass."""
    d = _trial_dir(tmp_path)
    with open(os.path.join(d, name), "wb") as f:
        f.write(b"{}")
    results, failures = port_fsck.fsck_paths([d])
    assert [r[0] for r in failures] == [os.path.join(d, name)]
    assert QUEUE[UNPORTED[name]] in failures[0][2]
    assert "ROADMAP.md" in failures[0][2]
    rc, out = _run_cli(port_cli, [d], d)
    assert rc == 1
    assert f"FAIL {os.path.join(d, name)}:" in out
    rc, out = _run_cli(port_cli, ["-R", os.path.join(d, name)], d)
    if name.endswith((".wal", ".snap", ".hist")):
        assert rc == 1 and "FAIL" in out  # never resealed


def test_repair_sidecar_reseals_a_copied_tree(tmp_path):
    """A tree copied beside another artifact's sidecar fails; the reseal
    verifies it structurally, writes its own sidecar (without the old
    sig), and fsck then passes, as in the reference."""
    d = _trial_dir(tmp_path)
    for name in ("port.tre", "ref.tre"):
        shutil.copyfile(os.path.join(d, "t.tre"), os.path.join(d, name))
        shutil.copyfile(os.path.join(d, "s.seq.sum"),
                        os.path.join(d, name + ".sum"))
    port, ref = os.path.join(d, "port.tre"), os.path.join(d, "ref.tre")
    assert len(port_fsck.fsck_paths([port])[1]) == 1
    assert port_fsck.repair_sidecar(port) == ref_fsck.repair_sidecar(ref)
    assert port_fsck.fsck_paths([port])[1] == []
    assert open(port + ".sum").read() == open(ref + ".sum").read()
