"""The port's edge readers honour the integrity policy as the reference's
do: the same seeded files, corrupted the same way, through both
packages' readers under each policy give equal arrays (and warn alike)
or raise the same exception type.

Files: clean (sealed by the writer), a flipped byte under its sidecar, a
``.dat`` with a torn trailing record (no sidecar), a ``.net`` with a bad
token (no sidecar), and a sidecar whose recorded size is wrong.  The
policy comes from ``SHEEP_INTEGRITY`` (unset: the default, strict), the
only way the reference's ``iter_dat_blocks`` takes one.
"""

import os
import warnings

import numpy as np
import pytest

from sheep_tpu.io import edges as ref_edges
from sheep_tpu_torch.integrity.sidecar import sidecar_path, write_sidecar
from sheep_tpu_torch.io import edges as port_edges

E = 40
#: reader -> (file suffix, call taking (module, path))
READERS = {
    "read_dat": (".dat", lambda m, p: [m.read_dat(p)]),
    "load_edges_dat": (".dat", lambda m, p: [m.load_edges(p)]),
    "iter_dat_blocks": (".dat", lambda m, p: list(m.iter_dat_blocks(p, 7))),
    "read_net": (".net", lambda m, p: [m.read_net(p)]),
    "load_edges_net": (".net", lambda m, p: [m.load_edges(p)]),
    "iter_net_blocks": (".net",
                        lambda m, p: list(m.iter_net_blocks(p, 64))),
}
CORRUPTIONS = {
    ".dat": ("clean", "flip", "torn", "size"),
    ".net": ("clean", "flip", "bad_token", "size"),
}
MODES = (None, "strict", "repair", "trust")
CASES = [(reader, corruption, mode)
         for reader, (suffix, _) in READERS.items()
         for corruption in CORRUPTIONS[suffix] for mode in MODES]


def _make_file(tmp_path, suffix: str, corruption: str) -> str:
    rng = np.random.default_rng(7)
    tail = rng.integers(0, 300, E).astype(np.uint32)
    head = rng.integers(0, 300, E).astype(np.uint32)
    path = str(tmp_path / f"g{suffix}")
    port_edges.write_edges(path, tail, head)
    data = bytearray(open(path, "rb").read())
    if corruption == "flip":
        # byte 5 is inside the first record's head (.dat) or a digit of
        # the first line (.net): the file still parses, only the sum knows
        data[5] = (data[5] ^ 0xFF) if suffix == ".dat" else \
            (ord("1") if data[5] != ord("1") else ord("2"))
    elif corruption == "torn":
        data += b"\x01\x02\x03"
    elif corruption == "bad_token":
        lines = bytes(data).split(b"\n")
        lines[3] = b"12 x7"
        data = bytearray(b"\n".join(lines))
    if corruption in ("flip", "torn", "bad_token"):
        with open(path, "wb") as f:
            f.write(bytes(data))
    if corruption in ("torn", "bad_token"):
        os.remove(sidecar_path(path))
    if corruption == "size":
        write_sidecar(path, crc=0, size=len(data) + 12)
    return path


def _outcome(module, call, path):
    """(exception type name or None, the records read, warned?)"""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            got = call(module, path)
        except Exception as exc:  # the type is what is compared
            return type(exc).__name__, None, bool(caught)
    arrays = []
    for item in got:
        t, h = (item.tail, item.head) if hasattr(item, "tail") else item
        arrays.append((np.asarray(t).copy(), np.asarray(h).copy()))
    return None, arrays, bool(caught)


@pytest.mark.parametrize("reader,corruption,mode", CASES,
                         ids=[f"{r}-{c}-{m or 'default'}"
                              for r, c, m in CASES])
def test_port_reader_equals_reference(tmp_path, monkeypatch, reader,
                                      corruption, mode):
    if mode is None:
        monkeypatch.delenv("SHEEP_INTEGRITY", raising=False)
    else:
        monkeypatch.setenv("SHEEP_INTEGRITY", mode)
    monkeypatch.delenv("SHEEP_DDUP_GRAPH", raising=False)
    suffix, call = READERS[reader]
    path = _make_file(tmp_path, suffix, corruption)
    want = _outcome(ref_edges, call, path)
    got = _outcome(port_edges, call, path)
    assert got[0] == want[0], (got[0], want[0])
    assert got[2] == want[2], "one package warned and the other did not"
    if want[1] is None:
        return
    assert len(got[1]) == len(want[1])
    for (t, h), (rt, rh) in zip(got[1], want[1]):
        assert t.dtype == rt.dtype and h.dtype == rh.dtype
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(h, rh)


def test_flipped_byte_and_torn_record_pin_the_fault(tmp_path, monkeypatch):
    """The fault as it stood: a flipped byte under a sidecar loaded as
    wrong vids, and a torn record loaded in silence.  Strict (the default)
    refuses both; repair drops the torn tail."""
    from sheep_tpu_torch.integrity import ChecksumMismatch, MalformedArtifact

    monkeypatch.delenv("SHEEP_INTEGRITY", raising=False)
    path = str(tmp_path / "x.dat")
    port_edges.write_dat(path, np.arange(4, dtype=np.uint32),
                         np.arange(1, 5, dtype=np.uint32))
    data = bytearray(open(path, "rb").read())
    data[5] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ChecksumMismatch):
        port_edges.load_edges(path)
    port_edges.write_dat(path, np.arange(4, dtype=np.uint32),
                         np.arange(1, 5, dtype=np.uint32))
    with open(path, "ab") as f:
        f.write(b"\x00\x00\x00")
    with pytest.raises(MalformedArtifact):
        port_edges.load_edges(path, integrity="strict")
    with pytest.warns(UserWarning):
        el = port_edges.load_edges(path, integrity="repair")
    np.testing.assert_array_equal(el.tail, np.arange(4))
