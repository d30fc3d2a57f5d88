"""Run a reference test's body against the port (sheep_tpu_torch) and
hold what both runs leave behind equal.

``port_twin(fn)`` rebinds a test function of a reference test module
(and every helper function and class of that module it reaches) to the
port: each global
that is a module, class or function of ``sheep_tpu`` becomes the port's
object of the same name, and an ``import sheep_tpu...`` statement run
inside the body imports ``sheep_tpu_torch...`` instead.  The reference's
own assertions then run on the port.

``run_twin`` runs the reference body and its port twin one after the
other in the same directory (``tmp_path/work``, emptied in between, so
absolute paths recorded in snapshots and messages are the same) and
returns what each run left there, as ``observe`` reads it; the caller
asserts the two equal.

``cases(module)`` lists a reference module's tests with their
``parametrize`` marks expanded, for one parametrised twin per module.
"""

from __future__ import annotations

import builtins
import contextlib
import functools
import importlib
import inspect
import itertools
import os
import shutil
import types

REF, PORT = "sheep_tpu", "sheep_tpu_torch"


def port_name(name: str) -> str:
    """``sheep_tpu[.x]`` -> ``sheep_tpu_torch[.x]``; other names as
    they are."""
    if name == REF or name.startswith(REF + "."):
        return PORT + name[len(REF):]
    return name


def _is_ref(name) -> bool:
    return isinstance(name, str) and (name == REF
                                      or name.startswith(REF + "."))


class Missing:
    """A reference name the port does not have: fails on any use."""

    def __init__(self, what: str):
        self.what = what

    def __getattr__(self, item):
        raise AttributeError(f"the port has no {self.what}")

    def __call__(self, *a, **kw):
        raise AttributeError(f"the port has no {self.what}")


def to_port(value):
    """The port's counterpart of a reference module, class or function;
    any other value as it is."""
    if isinstance(value, types.ModuleType):
        if _is_ref(value.__name__):
            return importlib.import_module(port_name(value.__name__))
        return value
    mod = getattr(value, "__module__", None)
    if _is_ref(mod) and isinstance(value, (type, types.FunctionType,
                                           types.BuiltinFunctionType)):
        try:
            obj = importlib.import_module(port_name(mod))
            for part in value.__qualname__.split("."):
                obj = getattr(obj, part)
            return obj
        except (ImportError, AttributeError):
            return Missing(f"{mod}.{value.__qualname__}")
    return value


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0:
        name = port_name(name)
    return builtins.__import__(name, globals, locals, fromlist, level)


_BUILTINS = dict(vars(builtins))
_BUILTINS["__import__"] = _port_import


def port_globals(module: types.ModuleType, overrides: dict | None = None):
    """A copy of a reference test module's globals with every reference
    object swapped for the port's, the module's own functions rebound to
    the copy, and imports redirected to the port."""
    g = {}
    for key, value in vars(module).items():
        g[key] = to_port(value)
    g["__builtins__"] = _BUILTINS
    for key, value in list(g.items()):
        if getattr(value, "__module__", None) != module.__name__:
            continue
        if isinstance(value, types.FunctionType):
            g[key] = _rebind(value, g)
        elif isinstance(value, type):
            g[key] = _rebind_class(value, g)
    g.update(overrides or {})
    return g


def _rebind_class(cls, g: dict):
    """A copy of a class the test module defines (a fixture-like helper
    holding daemons and clients) whose methods run in ``g``."""
    ns = {}
    for key, value in vars(cls).items():
        if key in ("__dict__", "__weakref__"):
            continue
        if isinstance(value, types.FunctionType):
            value = _rebind(value, g)
        elif isinstance(value, (staticmethod, classmethod)):
            value = type(value)(_rebind(value.__func__, g))
        elif isinstance(value, property):
            value = property(*(f and _rebind(f, g) for f in
                               (value.fget, value.fset, value.fdel)))
        ns[key] = value
    bases = tuple(to_port(b) for b in cls.__bases__)
    return type(cls)(cls.__name__, bases, ns)


def _rebind(fn, g: dict):
    new = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                             fn.__closure__)
    new.__kwdefaults__ = fn.__kwdefaults__
    functools.update_wrapper(new, fn)
    del new.__wrapped__
    return new


def port_twin(fn, overrides: dict | None = None):
    """``fn`` (a function of a reference test module) run on the port."""
    module = inspect.getmodule(fn)
    return port_globals(module, overrides)[fn.__name__]


def cases(module, skip=()):
    """[(pytest id, test name, params)] for every ``test_*`` of
    ``module`` but ``skip``, each ``parametrize`` mark expanded."""
    out = []
    for name in sorted(vars(module)):
        fn = getattr(module, name)
        if not name.startswith("test_") or not callable(fn) \
                or name in skip:
            continue
        grids = []
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            names, values = mark.args[0], mark.args[1]
            if isinstance(names, str):
                names = [n.strip() for n in names.split(",")]
            rows = [v if len(names) > 1 else (v,) for v in values]
            grids.append([dict(zip(names, row)) for row in rows])
        for combo in itertools.product(*grids) if grids else [()]:
            params = {}
            for part in combo:
                params.update(part)
            pid = name + (f"[{'-'.join(str(v) for v in params.values())}]"
                          if params else "")
            out.append((pid, name, params))
    return out


def _empty(work, tries: int = 50) -> None:
    """Remove and recreate ``work``; a thread the last run left behind
    (a background seal finishing) may still be renaming files in it."""
    import time
    for _ in range(tries):
        try:
            shutil.rmtree(work)
            break
        except FileNotFoundError:
            if not work.exists():
                break
            time.sleep(0.1)
    work.mkdir()


def run_twin(fn, tmp_path, monkeypatch, observe, fixtures=None,
             params=None, overrides=None, before=None):
    """Run the reference ``fn`` and its port twin in ``tmp_path/work``;
    return {"ref": observe(work, side), "port": ...}, each read after
    the test and its fixtures ended.

    ``fixtures(side, work, mp)`` is a context manager that yields the
    keyword arguments the test takes besides ``tmp_path`` and
    ``monkeypatch`` (supplied here) and tears them down on exit;
    ``before(side)`` runs ahead of each side (clearing fault plans)."""
    sig = inspect.signature(fn)
    out = {}
    for side in ("ref", "port"):
        work = tmp_path / "work"
        _empty(work)
        body = fn if side == "ref" else port_twin(fn, overrides)
        if before is not None:
            before(side)
        cwd = os.getcwd()
        try:
            with monkeypatch.context() as mp:
                with (fixtures(side, work, mp) if fixtures
                      else contextlib.nullcontext({})) as kw:
                    kw = dict(kw)
                    kw.update(params or {})
                    kw["tmp_path"] = work
                    kw["monkeypatch"] = mp
                    body(**{k: v for k, v in kw.items()
                            if k in sig.parameters})
        finally:
            os.chdir(cwd)
        out[side] = observe(work, side)
    return out


#: files whose bytes hold clocks, ports or pids
VOLATILE = ("serve.addr", "serve.hb", "serve.status.json", "worker.addr")


def dir_bytes(root, skip=VOLATILE, suffixes=None) -> dict:
    """{relative path: bytes} of every file under ``root`` but the
    ``skip`` names (and, with ``suffixes``, only those endings)."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            if name in skip or name.endswith((".trace", ".trace.sum",
                                              ".log", ".hb")):
                continue
            if suffixes is not None and not name.endswith(suffixes):
                continue
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def clear_fault_plans(side=None) -> None:
    """Clear every fault plan of both packages (I/O, serve, network,
    runtime): each package keeps its own module state."""
    for pkg in (REF, PORT):
        for mod in ("io.faultfs", "serve.faults", "serve.netfaults",
                    "runtime"):
            importlib.import_module(f"{pkg}.{mod}").clear_plan()


def assert_same(out: dict) -> None:
    """The two sides' observations are equal, file by file."""
    ref, port = out["ref"], out["port"]
    assert sorted(ref) == sorted(port)
    for key in ref:
        assert ref[key] == port[key], key


def _copy_settled(src, dst, tries: int = 50) -> None:
    """copytree, retried while a thread the run left behind is still
    renaming files in ``src``."""
    import time
    for _ in range(tries):
        try:
            shutil.copytree(src, dst)
            return
        except (shutil.Error, FileNotFoundError):
            shutil.rmtree(dst, ignore_errors=True)
            time.sleep(0.1)
    shutil.copytree(src, dst)


def cross_recovered(work, side) -> dict:
    """For a run whose record order depends on its threads: each state
    dir under ``work`` (one holding a ``serve.wal``) opened by both
    packages' stores, each on a copy of its own; {dir: (the reference
    store's state_crc(), the port store's)}.  The two must agree."""
    import tempfile
    out = {}
    for dirpath, _, names in os.walk(work):
        if "serve.wal" not in names:
            continue
        crcs = []
        for pkg in (REF, PORT):
            store = importlib.import_module(f"{pkg}.serve.state").ServeCore
            with tempfile.TemporaryDirectory() as tmp:
                copy = os.path.join(tmp, "sd")
                _copy_settled(dirpath, copy)
                core = store.open(copy)
                crcs.append(core.state_crc())
                core.close()
        out[os.path.relpath(dirpath, work)] = tuple(crcs)
    return out
