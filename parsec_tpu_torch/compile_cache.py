"""Program cache: captured CUDA graphs kept in-process and found again by a
content fingerprint, and the fingerprint recipe itself.

The port of :mod:`parsec_tpu.compile_cache`.  The reference caches XLA
executables in three layers: an in-process LRU, a content-addressed disk
store of ``jax.export`` blobs and a cross-rank broadcast of those blobs.
Here a program is a captured ``torch.cuda.CUDAGraph`` with the static
tensors it reads and writes.  A CUDA graph cannot be serialized, so there
is no blob and no disk store of programs: every program stays
process-local, as the reference's unexportable programs do (its
``stats["local_only"]``, counted here for every program stored).  What
persists across processes is the autotuner's winners
(:mod:`..tuning`, under :func:`cache_root`) and the content-addressed
kernel libraries in ``parsec_tpu_torch/_build/`` (``tools cache``).

* :func:`code_fingerprint` — a stable content hash of a callable (its
  bytecode, names, defaults and closure values, through
  ``functools.partial``), memoized per body by :func:`body_fingerprint`
  in a weak-keyed map: a reused ``id()`` once served a wrong program;
* :func:`fingerprint` — the content address of one program: its key,
  the argument signature (:func:`argsig`), the torch and CUDA runtime
  versions, the device's name and capability, and :data:`CACHE_FORMAT`;
* :class:`ProgramCache` — an LRU of programs keyed by fingerprint
  (``runtime_compile_cache_mem_entries``, default 512), with the
  reference's counters.  :func:`default_cache` is the process's cache
  (``GraphExecutor`` keys its whole-DAG capture there), and every
  :class:`~.core.context.Context` carries one (``context.compile_cache``,
  :func:`for_context`).  A program's card memory (a captured graph's
  private pool) lives outside every zone budget: the CUDA device module's
  out-of-memory relief drops the programs no live user holds
  (:meth:`ProgramCache.clear_memory`).

Not ported: the disk store of programs (nothing serializes) and the
cross-rank broadcast of serialized programs (ROADMAP A.8b part 2):
``ProgramCache(nranks>1)`` raises, and each rank of a multi-rank context
keeps a rank-local cache.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import os
import re
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .utils import mca_param

#: bump when the fingerprint recipe changes: an old fingerprint simply
#: stops matching
CACHE_FORMAT = 1

_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


# ---------------------------------------------------------------------------
# fingerprinting
# ---------------------------------------------------------------------------

def _scrub(s: str) -> str:
    """Drop memory addresses from reprs: ``<fn at 0x7f..>`` must
    fingerprint identically across processes."""
    return _ADDR_RE.sub("0xX", s)


def _code_parts(code, out: List[str], depth: int = 0) -> None:
    if depth > 6:  # pathological nesting: stop, stay stable
        return
    out.append(code.co_name)
    out.append(hashlib.sha1(code.co_code).hexdigest())
    out.append(repr(code.co_names))
    out.append(repr(code.co_varnames[:code.co_argcount]))
    for const in code.co_consts:
        if hasattr(const, "co_code"):
            _code_parts(const, out, depth + 1)
        else:
            out.append(_scrub(repr(const)))


def _value_part(v, out: List[str], depth: int = 0) -> None:
    """Stable description of a closure or default value.  An array or a
    tensor is hashed in full, a tensor on a card after a copy to the host:
    slow for a large one, but two programs that differ only in a baked
    constant must never share a fingerprint."""
    if depth > 4:
        out.append(f"<deep:{type(v).__name__}>")
    elif callable(v) and hasattr(v, "__code__"):
        _callable_parts(v, out)
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        a = v.detach().cpu().contiguous().numpy() if isinstance(v, torch.Tensor) \
            else np.ascontiguousarray(v)
        out.append(f"nd:{a.shape}:{a.dtype}:{hashlib.sha1(a.tobytes()).hexdigest()}")
    elif isinstance(v, (tuple, list)):
        out.append(f"{type(v).__name__}[")
        for x in v:
            _value_part(x, out, depth + 1)
        out.append("]")
    elif isinstance(v, dict):
        out.append("{")
        for k in sorted(v, key=repr):
            out.append(_scrub(repr(k)))
            _value_part(v[k], out, depth + 1)
        out.append("}")
    elif isinstance(v, (int, float, bool, str, bytes, complex, type(None))):
        out.append(repr(v))
    else:
        out.append(_scrub(repr(v)))


def _callable_parts(fn: Callable, out: List[str]) -> None:
    fn = getattr(fn, "__wrapped__", fn)
    if isinstance(fn, functools.partial):
        out.append("partial")
        _value_part(fn.args, out)
        _value_part(fn.keywords, out)
        _callable_parts(fn.func, out)
        return
    code = getattr(fn, "__code__", None)
    if code is None:
        out.append(_scrub(repr(fn)))
        return
    out.append(getattr(fn, "__qualname__", ""))
    _code_parts(code, out)
    for d in (getattr(fn, "__defaults__", None) or ()):
        _value_part(d, out)
    for cell in (getattr(fn, "__closure__", None) or ()):
        try:
            _value_part(cell.cell_contents, out)
        except ValueError:  # empty cell
            out.append("<empty-cell>")


def code_fingerprint(fn: Callable) -> str:
    """Stable content hash of a callable: bytecode (through nested code
    objects), names, defaults and closure values, through
    ``functools.partial`` too.  Changing a body's code or a baked
    parameter changes it; re-importing the same source does not."""
    out: List[str] = []
    _callable_parts(fn, out)
    return hashlib.sha256("|".join(out).encode()).hexdigest()[:24]


#: body -> its code fingerprint.  Weak keys: an ``id()`` key outlives its
#: body, and a new body may reuse the id (a reused id once served a wrong
#: result)
_body_fp_memo: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_body_fp_lock = threading.Lock()


def body_fingerprint(body: Callable) -> str:
    """:func:`code_fingerprint` of ``body``, computed once a body (a body
    that cannot be weakly referenced is fingerprinted every time)."""
    try:
        with _body_fp_lock:
            fp = _body_fp_memo.get(body)
    except TypeError:  # not weak-referenceable
        return code_fingerprint(body)
    if fp is None:
        fp = code_fingerprint(body)
        with _body_fp_lock:
            _body_fp_memo[body] = fp
    return fp


def value_fingerprint(v) -> str:
    """Stable description of one value (a body's parameter): a number or
    string by its repr, a tensor or array by its full content."""
    out: List[str] = []
    _value_part(v, out)
    return "|".join(out)


def _argsig_one(a) -> Tuple:
    if a is None:
        return ("none",)
    shape = getattr(a, "shape", None)
    dtype = getattr(a, "dtype", None)
    if shape is not None and dtype is not None:
        return ("a", tuple(shape), str(dtype))
    if isinstance(a, (tuple, list)):
        return ("t", tuple(_argsig_one(x) for x in a))
    return ("s", type(a).__name__)


def argsig(args) -> Tuple:
    """Light signature of a program's arguments: shapes and dtypes of the
    tensors and arrays, types of the scalars (attribute access only)."""
    return tuple(_argsig_one(a) for a in args)


def _versions() -> str:
    return f"{torch.__version__}/{torch.version.cuda}"


def _platform(device=None) -> str:
    """The device part of a fingerprint: the torch device type, and for a
    card its name and compute capability.  ``device`` None: the current
    card, or ``cpu`` without one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    major, minor = torch.cuda.get_device_capability(dev)
    return f"cuda|{torch.cuda.get_device_name(dev)}|sm_{major}{minor}"


def fingerprint(key: Any, sig: Tuple, *, donate: Tuple = (),
                backend: Optional[str] = None) -> str:
    """The content address of one program: its key (body fingerprints and
    structural parts), the argument signature, donation, the device
    (``backend``, default :func:`_platform`), the torch and CUDA runtime
    versions and :data:`CACHE_FORMAT`."""
    parts = (CACHE_FORMAT, _versions(),
             backend if backend is not None else _platform(),
             tuple(donate), _scrub(repr(key)), sig)
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:40]


def cache_root() -> Optional[str]:
    """Resolved cache directory, or None when disabled.
    ``PARSEC_TPU_COMPILE_CACHE``: unset -> ``~/.cache/parsec_tpu_torch``
    (never the JAX package's root: neither reads the other's winners);
    ``0``/empty -> disabled; anything else -> that directory."""
    v = os.environ.get("PARSEC_TPU_COMPILE_CACHE")
    if v is None:
        return os.path.join(os.path.expanduser("~"), ".cache", "parsec_tpu_torch")
    v = v.strip()
    if v in ("", "0"):
        return None
    return os.path.expanduser(v)


# ---------------------------------------------------------------------------
# the cache proper
# ---------------------------------------------------------------------------

class Program:
    """One cached program: the card bytes it keeps (``nbytes``: a captured
    graph's pool and static tensors), the ``lock`` its users take around a
    run (a graph's static tensors take one call at a time), and the live
    users holding it (:meth:`hold`), whose programs
    :meth:`ProgramCache.clear_memory` can spare."""

    def __init__(self, nbytes: int = 0):
        self.nbytes = int(nbytes)
        self.lock = threading.Lock()
        self._holders: "weakref.WeakSet" = weakref.WeakSet()

    def hold(self, user) -> None:
        self._holders.add(user)

    @property
    def held(self) -> bool:
        return len(self._holders) > 0


class ProgramCache:
    """The port's ``ExecutableCache``: an LRU of :class:`Program` s keyed
    by :func:`fingerprint`, in this process only.

    :meth:`get` returns the program stored under a fingerprint (counted in
    ``stats["hits_mem"]``) or None (``stats["misses"]``); :meth:`put`
    stores a program its caller built (``stats["captures"]``, and
    ``stats["local_only"]``: every program stays in this process, a CUDA
    graph does not serialize).  Beyond ``mem_entries`` programs the least
    recently used goes; a user holding it keeps it working."""

    def __init__(self, *, rank: int = 0, nranks: int = 1,
                 mem_entries: Optional[int] = None):
        if nranks > 1:
            raise NotImplementedError(
                "a multi-rank program cache shares programs over the comm "
                "engine, which is not ported yet (ROADMAP A.8b part 2)")
        self.rank = rank
        self.nranks = nranks
        self.stats: collections.Counter = collections.Counter()
        if mem_entries is None:
            mem_entries = int(mca_param.register(
                "runtime", "compile_cache_mem_entries", 512,
                help="in-process LRU capacity of the program cache (captured "
                     "CUDA graphs)"))
        self.mem_entries = max(1, int(mem_entries))
        self._lru: "collections.OrderedDict[str, Program]" = collections.OrderedDict()
        self._lock = threading.Lock()

    @property
    def hits(self) -> int:
        return self.stats["hits_mem"]

    @property
    def pool_bytes(self) -> int:
        """Card bytes the cached programs keep."""
        with self._lock:
            return sum(p.nbytes for p in self._lru.values())

    def __len__(self) -> int:
        return len(self._lru)

    def snapshot(self) -> Dict[str, int]:
        s = dict(self.stats)
        s["hits"] = self.hits
        s["entries"] = len(self)
        s["pool_bytes"] = self.pool_bytes
        return s

    def get(self, fp: str) -> Optional[Program]:
        with self._lock:
            prog = self._lru.get(fp)
            if prog is None:
                self.stats["misses"] += 1
                return None
            self._lru.move_to_end(fp)
            self.stats["hits_mem"] += 1
            return prog

    def put(self, fp: str, prog: Program) -> None:
        with self._lock:
            self._lru[fp] = prog
            self._lru.move_to_end(fp)
            self.stats["captures"] += 1
            self.stats["local_only"] += 1
            while len(self._lru) > self.mem_entries:
                self._lru.popitem(last=False)

    def clear_memory(self, *, keep_held: bool = False) -> int:
        """Drop the cached programs (``keep_held``: only those no live user
        holds) and return how many went.  A program's card memory returns
        to the caching allocator once no user holds it either."""
        with self._lock:
            gone = [fp for fp, p in self._lru.items() if not (keep_held and p.held)]
            for fp in gone:
                del self._lru[fp]
        return len(gone)


# ---------------------------------------------------------------------------
# the process's instance (contextless users: GraphExecutor, tools)
# ---------------------------------------------------------------------------

_default_cache: Optional[ProgramCache] = None
_default_lock = threading.Lock()


def default_cache() -> ProgramCache:
    global _default_cache
    with _default_lock:
        if _default_cache is None:
            _default_cache = ProgramCache()
        return _default_cache


def for_context(context) -> ProgramCache:
    """A context's own program cache.  A rank of a multi-rank context
    gets a rank-local one: its programs are never shared with the other
    ranks (the cross-rank program broadcast is ROADMAP A.8b part 2)."""
    return ProgramCache(rank=getattr(context, "rank", 0))
