"""The benchmark's own tests (``portbench/tests``), one case a file.

Each file runs in a pytest process of its own, from the repository's
root, as its README runs them: the harness's tests import the harness
as ``harness`` through their own ``conftest.py``, which this suite's
directory cannot share.  A file must pass within its limit; its tests
that need a card skip here."""

import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "portbench", "tests", "test_*.py")))
LIMIT_S = 300


@pytest.mark.parametrize("path", FILES)
def test_portbench_file_passes(path):
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", path], cwd=REPO, capture_output=True,
        text=True, timeout=LIMIT_S)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-2000:]


def test_every_benchmark_test_file_is_a_case():
    assert len(FILES) >= 8 and all(
        os.path.basename(p).startswith("test_portbench_") for p in FILES)
