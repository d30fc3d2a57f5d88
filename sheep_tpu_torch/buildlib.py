"""Build-at-first-use for the port's native sources (``csrc/``).

Each library compiles into ``sheep_tpu_torch/_build/`` from the checkout's
own sources: to a process-unique temporary name first, then published
with ``os.replace``, so concurrent processes (pytest-xdist workers, a CLI
racing a test) never load a half-written file.  A library older than its
source is rebuilt.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

#: compiler output of the builds this process ran, by library name
BUILD_LOGS: dict[str, str] = {}


def build_shared(source: str, lib_name: str, command) -> str:
    """Path of ``_build/<lib_name>``, compiled from ``csrc/<source>`` when
    missing or stale.  ``command(src, out)`` returns the compiler argv."""
    src = os.path.join(CSRC_DIR, source)
    out = os.path.join(BUILD_DIR, lib_name)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    argv = command(src, tmp)
    try:
        proc = subprocess.run(argv, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"cannot run {argv[0]} to build {source}: {exc}")
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise RuntimeError(
            f"build of {source} failed (rc={proc.returncode}): "
            f"{' '.join(argv)}\n{proc.stdout}{proc.stderr}")
    BUILD_LOGS[lib_name] = proc.stdout + proc.stderr
    os.replace(tmp, out)
    return out


def nvcc_command(src: str, out: str) -> list:
    """The argv that builds one ``csrc/*.cu`` into a shared library with a
    plain C interface for sm_90a (ptxas reports registers and spills);
    nvcc from PATH, else /usr/local/cuda/bin."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(f"nvcc not found: {os.path.basename(src)} "
                           f"cannot be built")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", out, src]
