"""The port's fsck (integrity/fsck.py, cli/fsck.py) against the
reference's: a clean trial directory, each artifact class fuzzed under
each policy, a distext state dir (its ``.hist`` histograms and its
manifest's shard-map chain) clean and fuzzed, a serve state dir (its
``.wal``, ``.snap`` and ``reseq.json`` chain) clean and fuzzed,
``--repair-sidecar``, and a scrubbed and quarantined serve state dir
(its ``scrub.json`` chain, quarantine marker and ``*.quarantined``
artifacts) clean and torn."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest

from sheep_tpu.cli import fsck as ref_cli
from sheep_tpu.integrity import fsck as ref_fsck
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


#: the serve daemon's anti-entropy chains: the hash-chained scrub
#: history, the dir quarantine marker and a quarantined artifact, each
#: with how to tear it
SCRUBBED = {
    "scrub.json": "tamper", "quarantine.json": "garble",
    "old.tre.quarantined": "flip",
}


def _scrubbed_dir(root) -> str:
    """A scrubbed and quarantined serve state dir made by the port: a
    store with inserts, two scrub passes on the scrub chain, the dir
    quarantine marker, and a rotted tree artifact the scrubber moved to
    ``old.tre.quarantined``."""
    from sheep_tpu_torch.core import build_forest, degree_sequence
    from sheep_tpu_torch.io import write_tree
    from sheep_tpu_torch.serve import scrub
    sd = _serve_dir(root)
    rng = np.random.default_rng(19)
    tail = rng.integers(0, 90, 300).astype(np.uint32)
    head = rng.integers(0, 90, 300).astype(np.uint32)
    seq = degree_sequence(tail, head)
    forest = build_forest(tail, head, seq)
    tre = os.path.join(sd, "old.tre")
    write_tree(tre, forest.parent, forest.pst_weight)
    scrub.run_scrub(sd)
    _fuzz(tre, "flip")
    scrub.run_scrub(sd)
    assert os.path.exists(tre + ".quarantined")
    scrub.enter_quarantine(sd, "state_crc mismatch at a VERIFY frame",
                           seqno=3)
    return sd


def _torn(sd: str, name: str) -> None:
    path = os.path.join(sd, name)
    how = SCRUBBED[name]
    if how == "tamper":  # a run record edited: the chain breaks
        import json
        with open(path) as f:
            runs = json.load(f)
        runs[0]["checked"] += 1
        with open(path, "w") as f:
            json.dump(runs, f)
    elif how == "garble":  # an unreadable marker still reads quarantined
        with open(path, "wb") as f:
            f.write(b"{not json")
    else:
        _fuzz(path, "flip")


@pytest.mark.parametrize("name", sorted(SCRUBBED))
def test_unported_artifact_is_a_failure(tmp_path, name):
    """A scrubbed and quarantined serve state dir, clean and with this
    chain torn: the port's fsck lines (library under every policy, and
    the tool) equal the reference's, each run on its own copy at one
    path (repair mode reclaims quarantined artifacts whose bytes now
    verify)."""
    (tmp_path / "t").mkdir()
    template = _scrubbed_dir(tmp_path / "t")
    import warnings
    for torn in (False, True):
        got = {}
        for side, (lib, cli) in (("ref", (ref_fsck, ref_cli)),
                                 ("port", (port_fsck, port_cli))):
            rec = []
            for mode in ("strict", "repair", "trust"):
                sd = str(tmp_path / "sd")
                shutil.rmtree(sd, ignore_errors=True)
                shutil.copytree(template, sd)
                if torn:
                    _torn(sd, name)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    rec.append(_results(lib, [sd], mode))
                shutil.rmtree(sd)
                shutil.copytree(template, sd)
                if torn:
                    _torn(sd, name)
                rec.append(_run_cli(cli, ["-m", mode, sd], sd))
                rec.append(_dir_bytes(sd))
            got[side] = rec
        assert got["port"] == got["ref"], (name, torn)
        strict = got["port"][0]
        lines = [r for r in strict[0] if os.path.basename(r[0]) == name]
        assert lines, (name, strict)
        if not torn:
            assert strict[1] == 0, strict
        elif name == "scrub.json":
            assert strict[1] >= 1 and "scrub" in str(strict), strict


#: a serve state dir's artifacts: the group-committed WAL, the snapshot
#: the re-sequence sealed, and its generation chain
SERVE = ("serve.wal", "snap-000000000001.snap", "reseq.json")


def _dir_bytes(d: str) -> dict:
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, f))}


def _serve_dir(root) -> str:
    """A re-sequenced serve state dir with one insert past its newest
    snapshot, made by the port's store."""
    from sheep_tpu_torch.io import write_dat
    from sheep_tpu_torch.serve import ServeCore, run_reseq
    rng = np.random.default_rng(17)
    tail = rng.integers(0, 120, 500).astype(np.uint32)
    head = rng.integers(0, 120, 500).astype(np.uint32)
    graph = os.path.join(str(root), "g.dat")
    write_dat(graph, tail, head)
    sd = os.path.join(str(root), "sd")
    core = ServeCore.bootstrap(sd, graph_path=graph, num_parts=2)
    core.insert(np.array([[130, 3]], np.uint32))
    assert run_reseq(core, force=True)["seq_gen"] == 1
    core.insert(np.array([[131, 4], [5, 6]], np.uint32))
    core.close()
    return sd


def test_serve_dir_equals_reference(tmp_path):
    """A real serve state dir, clean: every ``.wal``, ``.snap`` and
    ``reseq.json`` line is the reference's, through the library and the
    tool, and passes."""
    sd = _serve_dir(tmp_path)
    got = _results(port_fsck, [sd], None)
    assert got == _results(ref_fsck, [sd], None)
    assert got[1] == 0
    checked = {os.path.basename(r[0]) for r in got[0]}
    assert set(SERVE) <= checked
    for argv in ([sd], ["-q", sd], [os.path.join(sd, "serve.wal")],
                 ["-m", "repair", sd]):
        assert _run_cli(port_cli, argv, sd) == _run_cli(ref_cli, argv, sd)
    for name in ("serve.wal", "snap-000000000001.snap"):
        assert _reseal(tmp_path, sd, name, "port") \
            == _reseal(tmp_path, sd, name, "ref")


def _reseal(root, sd, name, side):
    """``fsck -R`` (write the missing sidecar) on one artifact of a copy
    of ``sd`` made for this side alone: the exit code, the report with
    the copy's path masked, and the copy's bytes after."""
    d = os.path.join(str(root), f"R-{side}-{name}")
    shutil.copytree(sd, d)
    m = port_cli if side == "port" else ref_cli
    rc, out = _run_cli(m, ["-R", os.path.join(d, name)], d)
    return rc, out.replace(d, "<sd>"), _dir_bytes(d)


@pytest.mark.parametrize("mode", ["strict", "repair", "trust"])
@pytest.mark.parametrize("name", SERVE)
def test_fuzzed_serve_artifact_equals_reference(tmp_path, name, mode):
    """The serve store's artifacts (the cases that were unported until the
    store was ported): one byte fuzzed in each, the port's lines (library
    and tool) equal the reference's under every policy, strict fails, and
    ``-R`` reports and writes as the reference does."""
    sd = _serve_dir(tmp_path)
    _fuzz(os.path.join(sd, name), "flip")
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _results(port_fsck, [sd], mode)
        want = _results(ref_fsck, [sd], mode)
        cli = [_run_cli(m, ["-m", mode, sd], sd) for m in (port_cli,
                                                          ref_cli)]
    assert got == want
    assert cli[0] == cli[1]
    if mode == "strict":
        assert got[1] >= 1, "strict fsck passed a fuzzed artifact"
        assert cli[0][0] == 1
        # -R on the fuzzed artifact: the same report and bytes after
        reseal = [_reseal(tmp_path, sd, name, side)
                  for side in ("port", "ref")]
        assert reseal[0] == reseal[1]
        if name.endswith((".wal", ".snap")):
            # never resealed
            assert reseal[0][0] == 1 and "FAIL" in reseal[0][1]


#: a distext state dir's artifacts that only its modules can check
DISTEXT = ("g00.hist", "g01.hist", "manifest.json")


def _distext_dir(root) -> str:
    """A finished two-leg distext job's state dir, made by the port."""
    from sheep_tpu_torch.io import write_dat
    from sheep_tpu_torch.ops.distext import run_distext
    from sheep_tpu_torch.supervisor import InlineRunner, SupervisorConfig
    rng = np.random.default_rng(13)
    tail = rng.integers(0, 300, 900).astype(np.uint32)
    head = rng.integers(0, 300, 900).astype(np.uint32)
    graph = os.path.join(str(root), "g.dat")
    write_dat(graph, tail, head)
    st = os.path.join(str(root), "st")
    run_distext(graph, st, SupervisorConfig(poll_s=0.01, grammar=False),
                runner=InlineRunner(0.05), legs=2)
    return st


def test_distext_dir_equals_reference(tmp_path):
    """The reference's lines for every artifact of a distext state dir,
    the ``.hist`` histograms and the manifest chain included, through
    the library and the tool."""
    st = _distext_dir(tmp_path)
    got = _results(port_fsck, [st], None)
    assert got == _results(ref_fsck, [st], None)
    assert got[1] == 0
    assert [r[0] for r in got[0]][-1] == os.path.join(st, "manifest.json")
    assert "shard-map-ok" in got[0][-1][2]
    for argv in ([st], ["-q", st], [os.path.join(st, "g00.hist")]):
        assert _run_cli(port_cli, argv, st) == _run_cli(ref_cli, argv, st)


@pytest.mark.parametrize("mode", ["strict", "repair", "trust"])
@pytest.mark.parametrize("kind", ["flip", "truncate", "append"])
@pytest.mark.parametrize("name", DISTEXT)
def test_fuzzed_distext_artifact_equals_reference(tmp_path, name, kind,
                                                  mode):
    st = _distext_dir(tmp_path)
    _fuzz(os.path.join(st, name), kind)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = _results(port_fsck, [st], mode)
        want = _results(ref_fsck, [st], mode)
    assert got == want
    if mode == "strict":
        assert got[1] >= 1, "strict fsck passed a fuzzed artifact"


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
