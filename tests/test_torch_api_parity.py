"""The port's public surface and MCA parameters against the JAX package's.

One case per module of ``parsec_tpu/`` (the four TPU-only files aside):

* the port has a module at the same path;
* every public name the reference module defines (``def``, ``class`` or a
  top-level assignment) or lists in its ``__all__`` exists in the port
  module — names it only imports are not part of its surface;
* every parameter of every public function, class constructor and public
  method exists in the port with the same default.  A default that is an
  object of the package's own classes (``engine_verify.SEED_DAGS``) is
  compared field by field.

One more case compares the ``(framework, name, default)`` of every
``mca_param.register`` call in the two trees, read from the sources.

The port's names follow the rename map below (``use_tpu`` is
``use_cuda``, ``use_pallas`` is ``use_kernels``, a ``tpu`` or ``TPU`` word
is ``cuda`` or ``CUDA``, a ``pallas`` word is ``kernel``; ``interpret=`` is
gone).  Every
other difference the port may have is an entry of :data:`ACCEPTED`, each
citing the ROADMAP.md C divergence that justifies it.  A difference the
table does not list fails with the module, the name and both values, and
so does a table entry whose difference is gone.  Nothing here runs a
task: the modules are imported, not driven.
"""

import ast
import enum
import importlib
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "parsec_tpu", "parsec_tpu_torch"

#: reference files with no port file at their path (ROADMAP.md A: their
#: counterparts are device/cuda.py, dsl/cuda_graph.py, ops/kernels.py with
#: csrc/, and none)
TPU_ONLY = {"device/tpu.py", "dsl/xla_lower.py", "ops/pallas_kernels.py",
            "parallel/_compat.py"}

#: the rename map (ROADMAP C, "The device keywords are the port's own")
_WHOLE = {"use_pallas": "use_kernels"}
_WORDS = {"tpu": "cuda", "TPU": "CUDA", "pallas": "kernel"}
_DROPPED = {"interpret"}

_NO_SERIAL = "ROADMAP C: a CUDA graph does not serialize"
_NO_FALLBACK = "ROADMAP C: parsec_tpu_torch.native has no fallback"
_ARRAY = "ROADMAP C: array's use_tpu=None is use_cuda=True"
_DEVICE = "ROADMAP C: the device_tpu_* parameters"
_MEASURED = "ROADMAP A/C: a default set by measurement on the H100"

#: every difference the port may have from the reference, and why.  Keys:
#: ("name", module, name), ("default", module, qualname, parameter),
#: ("mca_renamed", reference param, port param), ("mca_missing", param),
#: ("mca_default", param); MCA params as ``framework_name``
ACCEPTED = {
    ("name", "compile_cache", "DiskStore"): _NO_SERIAL,
    ("name", "compile_cache", "ExecutableCache"): _NO_SERIAL,
    ("name", "compile_cache", "default_store"): _NO_SERIAL,
    ("name", "native", "REQUIRED_SYMBOLS"): _NO_FALLBACK,
    ("name", "native", "available"): _NO_FALLBACK,
    ("name", "native", "build_error"): _NO_FALLBACK,
    ("name", "native", "missing_symbols"): _NO_FALLBACK,
    ("default", "array.expr", "DistArray.compute", "use_tpu"): _ARRAY,
    ("default", "array.expr", "DistArray.norm", "use_tpu"): _ARRAY,
    ("default", "array.expr", "DistArray.sum", "use_tpu"): _ARRAY,
    ("default", "array.lower", "lower", "use_tpu"): _ARRAY,
    ("default", "ops.stencil", "stencil_ptg", "use_tpu"):
        "ROADMAP C.11: stencil_ptg() adds a card chore by default",
    ("mca_renamed", "device_tpu_hbm_budget_mb", "device_cuda_mem_budget_mb"): _DEVICE,
    ("mca_renamed", "device_tpu_wave_batch", "device_cuda_wave_batch"): _DEVICE,
    ("mca_renamed", "device_tpu_eager_complete", "device_cuda_eager_complete"): _DEVICE,
    ("mca_renamed", "device_tpu_device_index", "device_cuda_torch_device"): _DEVICE,
    ("mca_default", "device_tpu_device_index"):
        _DEVICE + " (the card is cuda:<rank % count> unless named)",
    ("mca_default", "device_tpu_wave_batch"): _MEASURED,
    ("mca_default", "runtime_stage_depth"): _MEASURED,
    ("mca_default", "runtime_wb_window_mb"): _MEASURED,
    ("mca_missing", "device_tpu_exec_streams"):
        _DEVICE + " (one compute stream and one in-flight queue)",
    ("mca_missing", "device_tpu_native_zone"):
        _DEVICE + " (the zone is always used)",
    ("mca_missing", "runtime_compile_bcast"): _NO_SERIAL,
    ("mca_missing", "runtime_compile_cache_min_share_s"): _NO_SERIAL,
}


def _rename(name):
    if name in _WHOLE:
        return _WHOLE[name]
    return "_".join(_WORDS.get(w, w) for w in name.split("_"))


def _modules():
    out = []
    for dirpath, dirs, files in os.walk(os.path.join(REPO, REF)):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for fn in files:
            rel = os.path.relpath(os.path.join(dirpath, fn), os.path.join(REPO, REF))
            if fn.endswith(".py") and rel not in TPU_ONLY:
                out.append(rel)
    return sorted(out)


def _dotted(rel):
    """``data/collection.py`` -> ``data.collection``; a package's
    ``__init__.py`` -> the package (the root: ``""``)."""
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _surface(rel):
    """Public names the reference module defines, plus its ``__all__``."""
    tree = ast.parse(open(os.path.join(REPO, REF, rel), encoding="utf-8").read())
    defined, listed = set(), set()

    def walk(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                defined.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        defined.add(t.id)
                        if t.id == "__all__":
                            listed.update(ast.literal_eval(node.value))
            elif isinstance(node, (ast.If, ast.Try)):
                walk(node.body)
                walk(node.orelse)
                for h in getattr(node, "handlers", ()):
                    walk(h.body)
                walk(getattr(node, "finalbody", ()))

    walk(tree.body)
    return {n for n in defined if not n.startswith("_")}, listed


def _members(obj):
    """name -> function for a function (``""``) or a class's constructor
    and public methods defined in its body (properties: None)."""
    if not inspect.isclass(obj):
        return {"": obj}
    out = {}
    for name, v in vars(obj).items():
        if name.startswith("_") and name not in ("__init__", "__new__"):
            continue
        f = v.__func__ if isinstance(v, (staticmethod, classmethod)) else v
        if inspect.isfunction(f):
            out[name] = f
        elif isinstance(v, property):
            out[name] = None
    return out


def _fields(obj):
    if hasattr(obj, "__dict__"):
        return vars(obj)
    return {s: getattr(obj, s) for s in getattr(type(obj), "__slots__", ())
            if hasattr(obj, s)}


def _same(a, b):
    """Defaults equal across the packages: plain values by type and value,
    containers item by item, enums by name, functions and classes by
    name, objects of either package's own classes field by field."""
    if isinstance(a, enum.Enum) or isinstance(b, enum.Enum):
        return type(a).__name__ == type(b).__name__ and \
            getattr(a, "name", a) == getattr(b, "name", b)
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and \
            all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and \
            all(_same(a[k], b[k]) for k in a)
    if inspect.isfunction(a) or inspect.isclass(a) or inspect.isbuiltin(a):
        return getattr(a, "__qualname__", None) == getattr(b, "__qualname__", None)
    mod = type(a).__module__ or ""
    if mod == REF or mod.startswith(REF + "."):
        return type(a).__name__ == type(b).__name__ and _same(_fields(a), _fields(b))
    if isinstance(a, np.dtype):
        return a == b
    try:
        return type(a) is type(b) and bool(a == b)
    except Exception:
        return False


def _diffs(rel):
    """The differences of the port module from the reference module at
    ``rel``: key -> "reference value / port value"."""
    dotted = _dotted(rel)
    rname = REF + ("." + dotted if dotted else "")
    pname = PORT + ("." + dotted if dotted else "")
    ref = importlib.import_module(rname)
    try:
        port = importlib.import_module(pname)
    except ImportError as e:
        return {("module", dotted): f"{rname} / {e!r}"}
    out = {}
    defined, listed = _surface(rel)
    for name in sorted(defined | listed):
        robj = getattr(ref, name, None)
        if name not in listed and inspect.ismodule(robj):
            continue  # an import fallback (``jax = None``), not surface
        if not hasattr(port, _rename(name)):
            out[("name", dotted, name)] = f"{rname}.{name} / missing from {pname}"
            continue
        if not (inspect.isclass(robj) or inspect.isfunction(robj)) or \
                robj.__module__ != rname:
            continue
        pobj = getattr(port, _rename(name))
        pmembers = _members(pobj)
        for mname, rfn in _members(robj).items():
            qual = f"{name}.{mname}" if mname else name
            pfn = pmembers.get(_rename(mname)) if mname else pobj
            if mname and pfn is None and not hasattr(pobj, _rename(mname)):
                out[("name", dotted, qual)] = f"{rname}.{qual} / missing from {pname}"
                continue
            if rfn is None:
                continue  # a property: its existence is its surface
            if pfn is None:
                pfn = getattr(pobj, _rename(mname))
            rsig = inspect.signature(rfn)
            try:
                psig = inspect.signature(pfn)
            except (TypeError, ValueError) as e:
                out[("signature", dotted, qual)] = f"{rsig} / {e!r}"
                continue
            for p in rsig.parameters.values():
                if p.name in _DROPPED:
                    continue
                pp = psig.parameters.get(_rename(p.name))
                if pp is None:
                    out[("param", dotted, qual, p.name)] = \
                        f"{rname}.{qual}({p.name}=...) / missing from {pname}"
                elif not _same(p.default, pp.default):
                    out[("default", dotted, qual, p.name)] = \
                        f"{qual}({p.name}={p.default!r}) / ({pp.name}={pp.default!r})"
    return out


def _check(found, keys_of_case):
    """``found`` must be exactly the table's entries for this case."""
    accepted = {k for k in ACCEPTED if keys_of_case(k)}
    unlisted = {k: v for k, v in found.items() if k not in accepted}
    stale = sorted(accepted - set(found))
    assert not unlisted, "differences ROADMAP C does not list (reference / port):\n" + \
        "\n".join(f"  {k}: {v}" for k, v in sorted(unlisted.items()))
    assert not stale, f"table entries whose difference is gone: {stale}"


@pytest.mark.parametrize("rel", _modules())
def test_public_surface_matches_the_reference(rel):
    dotted = _dotted(rel)
    _check(_diffs(rel), lambda k: k[0] in ("name", "default") and k[1] == dotted)


def _registrations(pkg):
    """``framework_name`` -> default of every ``register("<fw>", "<name>",
    default)`` call in the package's sources (defaults as literals, else
    as their source text); a call whose framework or name is not a string
    literal (the component selection's) is the same code in both."""
    out = {}
    for dirpath, dirs, files in os.walk(os.path.join(REPO, pkg)):
        dirs[:] = sorted(d for d in dirs if d not in ("_build", "__pycache__"))
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, fn), encoding="utf-8").read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if (f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)) \
                        != "register" or len(node.args) < 2:
                    continue
                fw, name = node.args[:2]
                if not all(isinstance(a, ast.Constant) and isinstance(a.value, str)
                           for a in (fw, name)):
                    continue
                d = node.args[2] if len(node.args) > 2 else next(
                    (k.value for k in node.keywords if k.arg == "default"), None)
                try:
                    value = ast.literal_eval(d) if d is not None else None
                except ValueError:
                    value = ast.unparse(d)
                out.setdefault(f"{fw.value}_{name.value}", value)
    return out


def test_mca_parameters_match_the_reference():
    ref, port = _registrations(REF), _registrations(PORT)
    assert len(ref) > 50 and "runtime_native_drain" in port
    renamed = {k[1]: k[2] for k in ACCEPTED if k[0] == "mca_renamed"}
    found, matched = {}, set()
    for name, default in sorted(ref.items()):
        counterpart = name if name in port else renamed.get(name)
        if counterpart in port:
            matched.add(counterpart)
            if counterpart != name:
                found[("mca_renamed", name, counterpart)] = f"{name} / {counterpart}"
            if not _same(default, port[counterpart]):
                found[("mca_default", name)] = \
                    f"{name}={default!r} / {counterpart}={port[counterpart]!r}"
        else:
            found[("mca_missing", name)] = f"{name}={default!r} / missing"
    for name in sorted(set(port) - matched):
        found[("mca_port_only", name)] = f"missing / {name}={port[name]!r}"
    _check(found, lambda k: k[0].startswith("mca_"))


def test_accepted_entries_cite_roadmap_c():
    assert all(why.startswith("ROADMAP ") for why in ACCEPTED.values())


# -- ROADMAP C.12: the names the port lacked ---------------------------------

def _subprocess_attr(pkg, module, attr):
    """Whether ``module`` has ``attr`` right after its own import, in a
    fresh interpreter (no other module imported a submodule first)."""
    code = (f"import importlib; m = importlib.import_module({pkg + '.' + module!r}); "
            f"print(hasattr(m, {attr!r}))")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1] == "True"


@pytest.mark.parametrize("pkg", [REF, PORT])
def test_data_package_imports_checkpoint(pkg):
    """``<pkg>.data.checkpoint`` without a prior ``import`` of the
    submodule (ROADMAP C.12)."""
    assert _subprocess_attr(pkg, "data", "checkpoint")


@pytest.mark.parametrize("pkg", [REF, PORT])
def test_c12_names_on_both_packages(pkg):
    """``data.RepoEntry``, ``LocalCollection.materialized_keys()``,
    ``device.select_best_device`` and ``Task(...).repo_entry`` (ROADMAP
    C.12) on both packages, with the same results."""
    data = importlib.import_module(pkg + ".data")
    device = importlib.import_module(pkg + ".device")
    core = importlib.import_module(pkg + ".core")
    assert data.RepoEntry is importlib.import_module(pkg + ".data.datarepo").RepoEntry
    assert "RepoEntry" in data.__all__ and "checkpoint" in data.__all__
    dc = data.LocalCollection("M", shape=(2,))
    dc.data_of(3)
    dc.data_of(1)
    assert dc.materialized_keys() == dc.keys() == [3, 1]
    assert device.select_best_device is \
        importlib.import_module(pkg + ".device.device").select_best_device
    assert "select_best_device" in device.__all__
    tc = core.TaskClass("t")
    tp = core.Taskpool("p")
    assert core.Task(tp, tc).repo_entry is None
