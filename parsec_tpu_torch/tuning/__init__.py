"""nb / block / wave autotuner: search tile sizes per (op, N, dtype, card)
by timed short runs, persist the winners, and let the ops' ``"auto"``
values read them.

The port of :mod:`parsec_tpu.tuning`.  One JSON document per tuning key
under ``<cache_root>/autotune/`` (:func:`..compile_cache.cache_root`:
``PARSEC_TPU_COMPILE_CACHE`` governs the root; with the cache off the
winners live in this process's memory).  A document records every
candidate's measured seconds, the winner and what was tuned; a corrupt
file reads as absent.  The device part of a key is the card's name
(``torch.cuda.get_device_name``), or ``cpu`` for the torch CPU device: an
H100's winners never serve another card.

Readers: ``q_block``/``kv_block="auto"`` in :mod:`..ops.attention` (op
``attention``), ``nb="auto"`` in the segmented drivers (ops
``dpotrf_seg``, ``getrf_seg``, ``geqrf_seg``) and fusion's horizon (op
``fusion``, param ``max_tasks``).

The runners take the card unless called with ``device="cpu"``; each timed
run ends with ``torch.cuda.synchronize``, so it times the work and not
its enqueue.  Unlike the reference's, a runner builds its matrix where it
runs, from a seeded ``torch.Generator`` (seed 7): a host ``M @ M.T`` at
the sizes tuned on the card takes seconds to minutes.  The segmented
runners time the driver's in-place run on a device-resident copy, the
host-to-device copy left out.

CLI: ``python -m parsec_tpu_torch.profiling.tools autotune --op dpotrf
--n 8192 --nb 256,512,1024`` (``tools autotune --help``).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..utils import debug

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _device_kind(device=None) -> str:
    """The device part of a tuning key: the card's name for a CUDA device,
    ``cpu`` for the torch CPU device.  ``device``: a torch device or its
    name, or a device module (its ``tdev``); None, or an object naming no
    torch device, is the device the port runs on: the current card, or
    the CPU without one."""
    tdev = device if isinstance(device, (str, torch.device)) else getattr(device, "tdev", None)
    if tdev is None:
        tdev = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(tdev)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _dtype_name(dtype) -> str:
    """``float32`` for the numpy dtype, its name or ``torch.float32``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(getattr(dtype, "name", dtype))


def tune_key(op: str, n: int, dtype, device_kind: str,
             param: str = "nb") -> str:
    raw = f"{op}_n{n}_{_dtype_name(dtype)}_{device_kind}_{param}"
    return _SAFE.sub("-", raw)


class TuningStore:
    """One JSON document per tuning key; atomic writes, corrupt files
    read as absent."""

    def __init__(self, directory: str):
        self.dir = directory
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.json")

    def load(self, key: str) -> Optional[Dict[str, Any]]:
        try:
            with open(self._path(key)) as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or "best" not in doc:
                raise ValueError("not a tuning document")
            return doc
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:  # JSONDecodeError is a ValueError
            debug.warning("tuning entry %s unreadable (%s); ignoring", key, e)
            return None

    def save(self, key: str, doc: Dict[str, Any]) -> bool:
        with self._lock:
            try:
                os.makedirs(self.dir, exist_ok=True)
                tmp = f"{self._path(key)}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=1, sort_keys=True)
                os.replace(tmp, self._path(key))
                return True
            except OSError as e:
                debug.warning("tuning write of %s failed: %s", key, e)
                return False

    def entries(self) -> List[Dict[str, Any]]:
        out = []
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            return out
        for nme in names:
            if nme.endswith(".json"):
                doc = self.load(nme[:-5])
                if doc is not None:
                    out.append(dict(doc, key=nme[:-5]))
        return out

    def purge(self) -> int:
        n = 0
        try:
            for nme in os.listdir(self.dir):
                if nme.endswith(".json"):
                    os.unlink(os.path.join(self.dir, nme))
                    n += 1
        except OSError:
            pass
        return n


_store_lock = threading.Lock()
_stores: Dict[str, TuningStore] = {}
#: the store when the cache root is off: winners still apply within the
#: process
_memory_docs: Dict[str, Dict[str, Any]] = {}


class _MemoryStore(TuningStore):
    def __init__(self):
        self.dir = "<memory>"
        self._lock = threading.Lock()

    def load(self, key):
        return _memory_docs.get(key)

    def save(self, key, doc):
        _memory_docs[key] = doc
        return True

    def entries(self):
        return [dict(d, key=k) for k, d in sorted(_memory_docs.items())]

    def purge(self):
        n = len(_memory_docs)
        _memory_docs.clear()
        return n


def default_store() -> TuningStore:
    from ..compile_cache import cache_root

    root = cache_root()
    with _store_lock:
        if root is None:
            st = _stores.get("<memory>")
            if st is None:
                st = _stores["<memory>"] = _MemoryStore()
            return st
        st = _stores.get(root)
        if st is None:
            st = _stores[root] = TuningStore(os.path.join(root, "autotune"))
        return st


# ---------------------------------------------------------------------------
# lookup (the "auto" resolution path)
# ---------------------------------------------------------------------------

def resolve_nb(op: str, n: int, dtype="float32", *, device=None,
               default: Optional[int] = None,
               divides: Optional[int] = None,
               param: str = "nb",
               store: Optional[TuningStore] = None) -> Optional[int]:
    """Tuned value for (op, n, dtype, card), or ``default``.  ``divides=N``
    rejects a winner that does not divide N (the segmented drivers need
    it): the default then stands.  ``param`` selects another tuning axis
    (the attention graphs read ``q_block``/``kv_block`` under op
    ``attention``)."""
    st = store if store is not None else default_store()
    doc = st.load(tune_key(op, n, dtype, _device_kind(device), param))
    if doc is None:
        return default
    best = doc.get("best")
    if not isinstance(best, int) or best <= 0:
        return default
    if divides is not None and divides % best:
        debug.verbose(1, "tuning", "tuned nb=%d for %s does not divide N=%d; "
                      "using default %r", best, op, divides, default)
        return default
    return best


def auto_nb(nb, op: str, n: int, dtype="float32", *, device=None,
            default: int = 512, divides: Optional[int] = None):
    """The ``nb="auto"`` entry point of the ops: an explicit value passes
    through, "auto" resolves against the tuning store, else ``default``
    halved until it divides ``divides``."""
    if nb != "auto":
        return nb
    d = default
    if divides is not None:
        while d > 1 and divides % d:
            d //= 2
    return resolve_nb(op, n, dtype, device=device, default=d, divides=divides)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def autotune(op: str, n: int, dtype, *, param: str = "nb",
             candidates: Sequence[int],
             runner: Callable[[int], float],
             reps: int = 2, device=None,
             store: Optional[TuningStore] = None,
             meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Timed search: ``runner(value)`` runs one short workload and returns
    seconds; the best median over ``reps`` wins and is persisted.  Each
    candidate gets one untimed warm-up run first (its kernels built and
    loaded, its libraries' handles made).  A raising candidate is recorded
    under ``failures`` and skipped; if every one fails, this raises."""
    timings: Dict[str, float] = {}
    failures: Dict[str, str] = {}
    for cand in candidates:
        samples = []
        try:
            runner(cand)  # the warm-up, untimed
            for _ in range(max(1, reps)):
                samples.append(float(runner(cand)))
        except Exception as e:
            failures[str(cand)] = f"{type(e).__name__}: {e}"[:160]
            debug.warning("autotune %s=%s failed: %s", param, cand, e)
            continue
        samples.sort()
        timings[str(cand)] = samples[len(samples) // 2]
    if not timings:
        raise RuntimeError(f"autotune of {op} {param}: every candidate failed ({failures})")
    best = int(min(timings, key=timings.get))
    kind = _device_kind(device)
    doc = {
        "op": op, "n": int(n), "dtype": _dtype_name(dtype),
        "device_kind": kind, "param": param,
        "best": best, "timings_s": timings, "failures": failures,
        "reps": int(reps), "created": time.time(),
        "meta": dict(meta or ()),
    }
    st = store if store is not None else default_store()
    st.save(tune_key(op, n, dtype, kind, param), doc)
    return doc


def _default_nb_candidates(n: int) -> List[int]:
    cands = [nb for nb in (64, 128, 256, 512, 1024) if nb <= max(64, n)]
    return [nb for nb in cands if n % nb == 0] or cands[:1]


def _default_block_candidates(s: int) -> List[int]:
    return [b for b in (64, 128, 256, 512) if b <= s] or [s]


# -- the workloads -----------------------------------------------------------

def _runner_device(device) -> torch.device:
    """The card, unless ``device`` asks for the CPU (or another card)."""
    from ..dsl.cuda_graph import resolve_device

    return resolve_device(device, "autotune")


def _context(dev: torch.device, nb_cores: int):
    from ..core.context import Context

    return Context(nb_cores=nb_cores, cuda_device=str(dev))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, _dtype_name(dtype))


def _matrix(n: int, dtype, dev: torch.device, spd: bool) -> torch.Tensor:
    """An (n, n) matrix from ``torch.Generator`` seed 7 on ``dev``: standard
    normal, or ``M @ M.T + n I`` (SPD, its eigenvalues in [n, 5n])."""
    gen = torch.Generator(device=dev).manual_seed(7)
    m = torch.randn((n, n), generator=gen, device=dev, dtype=torch.float32)
    if spd:
        m = m @ m.T
        m.diagonal().add_(n)
    return m.to(_torch_dtype(dtype))


def dpotrf_runner(n: int, dtype="float32", *, nb_cores: int = 4,
                  use_device: bool = True, device=None) -> Callable[[int], float]:
    """The dpotrf search workload: one dynamic-runtime factorization a
    call (a fresh taskpool each time: dispatch is part of the cost tuned),
    its tiles staged from the host as the path stages them; the matrix is
    made once."""
    from ..datadist import TiledMatrix
    from ..ops.cholesky import cholesky_ptg

    dev = _runner_device(device)
    dt = np.dtype(_dtype_name(dtype))
    spd = _matrix(n, dtype, dev, True).cpu().numpy()
    ctx = _context(dev, nb_cores)

    def run(nb: int) -> float:
        if n % nb:
            raise ValueError(f"nb={nb} does not divide N={n}")
        A = TiledMatrix(n, n, nb, nb, name="A", dtype=dt).from_array(spd)
        tp = cholesky_ptg(use_cuda=use_device, use_cpu=not use_device).taskpool(NT=A.mt, A=A)
        t0 = time.perf_counter()
        ctx.add_taskpool(tp)
        if not tp.wait(timeout=600):
            raise RuntimeError(f"dpotrf candidate did not quiesce ({tp.fail_reason})")
        _sync(dev)
        return time.perf_counter() - t0

    run.close = ctx.fini  # type: ignore[attr-defined]
    run.device = dev  # type: ignore[attr-defined]
    return run


#: the built-in segmented workloads, under the op names the drivers'
#: ``nb="auto"`` looks up: a winner tuned here is what the next
#: ``Segmented*(ctx, n)`` reads
_SEG_DRIVERS = {
    "dpotrf_seg": ("segmented_chol", "SegmentedCholesky"),
    "getrf_seg": ("segmented_lu", "SegmentedLU"),
    "geqrf_seg": ("segmented_qr", "SegmentedQR"),
}


def segmented_runner(op: str, n: int, dtype="float32", *, nb_cores: int = 4,
                     device=None) -> Callable[[int], float]:
    """The search workload of a segmented driver op (``dpotrf_seg`` /
    ``getrf_seg`` / ``geqrf_seg``): each call builds the driver with an
    explicit nb and times one factorization through the runtime, in place
    on a device copy of the matrix made once (the copy before the clock)."""
    import importlib

    mod_name, cls_name = _SEG_DRIVERS[op]
    cls = getattr(importlib.import_module(f"..ops.{mod_name}", __package__), cls_name)
    dev = _runner_device(device)
    M = _matrix(n, dtype, dev, op == "dpotrf_seg")
    work = torch.empty_like(M)
    ctx = _context(dev, nb_cores)

    def run(nb: int) -> float:
        if n % nb:
            raise ValueError(f"nb={nb} does not divide N={n}")
        drv = cls(ctx, n, nb=nb)
        work.copy_(M)
        _sync(dev)
        t0 = time.perf_counter()
        drv.run(work)
        _sync(dev)
        return time.perf_counter() - t0

    run.close = ctx.fini  # type: ignore[attr-defined]
    run.device = dev  # type: ignore[attr-defined]
    return run


def autotune_nb(op: str, n: int, dtype="float32", *,
                candidates: Optional[Iterable[int]] = None,
                reps: int = 2, runner: Optional[Callable] = None,
                store: Optional[TuningStore] = None, device=None) -> Dict[str, Any]:
    """Search nb for ``op`` (built-in workloads: ``dpotrf`` and the
    segmented drivers of :data:`_SEG_DRIVERS`; other ops pass
    ``runner``)."""
    cands = list(candidates) if candidates else _default_nb_candidates(n)
    close = None
    if runner is None:
        if op == "dpotrf":
            runner = dpotrf_runner(n, dtype, device=device)
        elif op in _SEG_DRIVERS:
            runner = segmented_runner(op, n, dtype, device=device)
        else:
            raise ValueError(
                f"no built-in workload for op {op!r} (built-ins: dpotrf, "
                f"{', '.join(sorted(_SEG_DRIVERS))}); pass runner=")
        close = runner.close
        device = runner.device
    try:
        return autotune(op, n, dtype, param="nb", candidates=cands, runner=runner,
                        reps=reps, device=device, store=store)
    finally:
        if close is not None:
            close()


def attention_runner(s: int, *, d: int = 64, heads: int = 2, batch: int = 1,
                     dtype="float32", causal: bool = True, nb_cores: int = 4,
                     param: str = "q_block", other_block: Optional[int] = None,
                     use_device: bool = True, device=None) -> Callable[[int], float]:
    """The attention block-size search workload: each call runs one
    blockwise flash-attention taskpool (:mod:`..ops.attention`) through
    the dynamic runtime with the candidate bound to ``param``
    (``q_block`` or ``kv_block``); the other block stays at
    ``other_block`` (default ``min(128, s)``).  q, k and v are made once,
    on the card, and kept on the host, where the planes start."""
    from ..ops.attention import run_flash_attention

    if param not in ("q_block", "kv_block"):
        raise ValueError(f"attention tunes q_block/kv_block, not {param!r}")
    dev = _runner_device(device)
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((batch, s, heads, d), generator=gen, device=dev,
                           dtype=torch.float32).to(_torch_dtype(dtype)).cpu()
               for _ in range(3))
    other = other_block if other_block is not None else min(128, s)
    ctx = _context(dev, nb_cores)

    def run(block: int) -> float:
        if block <= 0 or block > s:
            raise ValueError(f"{param}={block} outside (0, {s}]")
        kw = {param: block, ("kv_block" if param == "q_block" else "q_block"): other}
        t0 = time.perf_counter()
        # the output comes back as a host tensor: the card is done
        run_flash_attention(ctx, q, k, v, causal=causal, use_cuda=use_device,
                            use_cpu=not use_device, **kw)
        return time.perf_counter() - t0

    run.close = ctx.fini  # type: ignore[attr-defined]
    run.device = dev  # type: ignore[attr-defined]
    return run


def autotune_attention(s: int, *, d: int = 64, heads: int = 2, batch: int = 1,
                       dtype="float32", causal: bool = True,
                       candidates: Optional[Iterable[int]] = None, reps: int = 2,
                       store: Optional[TuningStore] = None,
                       device=None) -> Dict[str, Dict[str, Any]]:
    """Search ``q_block`` and ``kv_block`` at sequence length ``s``: two
    sweeps in turn, each winner persisted under op ``attention`` with its
    own ``param`` (the keys ``"auto"`` reads in :mod:`..ops.attention`).
    The kv sweep runs against the q winner, so the persisted pair was
    timed together.  Returns ``{param: doc}``."""
    cands = list(candidates) if candidates else _default_block_candidates(s)
    docs: Dict[str, Dict[str, Any]] = {}
    for param in ("q_block", "kv_block"):
        other = docs["q_block"]["best"] if "q_block" in docs else None
        runner = attention_runner(s, d=d, heads=heads, batch=batch, dtype=dtype,
                                  causal=causal, param=param, other_block=other,
                                  device=device)
        try:
            docs[param] = autotune("attention", s, dtype, param=param, candidates=cands,
                                   runner=runner, reps=reps, device=runner.device,
                                   store=store,
                                   meta={"d": d, "heads": heads, "batch": batch,
                                         "causal": causal})
        finally:
            runner.close()
    return docs


def autotune_wave(n: int = 1024, nb: int = 64, dtype="float32", *,
                  candidates: Sequence[int] = (0, 2, 4, 8), reps: int = 2,
                  store: Optional[TuningStore] = None, device=None) -> Dict[str, Any]:
    """Search the device wave-batch minimum (``device_cuda_wave_batch``) on
    a dynamic dpotrf: each candidate runs in a fresh context (the device
    module reads the parameter at attach).  The winner persists under
    param ``wave``; a caller applies it by setting the MCA parameter.  A
    caller's explicit setting is restored afterwards."""
    from ..datadist import TiledMatrix
    from ..ops.cholesky import cholesky_ptg
    from ..utils import mca_param

    dev = _runner_device(device)
    dt = np.dtype(_dtype_name(dtype))
    spd = _matrix(n, dtype, dev, True).cpu().numpy()

    def run(wave: int) -> float:
        mca_param.set_param("device", "cuda_wave_batch", int(wave))
        ctx = _context(dev, 4)
        try:
            A = TiledMatrix(n, n, nb, nb, name="A", dtype=dt).from_array(spd)
            tp = cholesky_ptg(use_cuda=True, use_cpu=False).taskpool(NT=A.mt, A=A)
            t0 = time.perf_counter()
            ctx.add_taskpool(tp)
            if not tp.wait(timeout=600):
                raise RuntimeError(f"wave candidate did not quiesce ({tp.fail_reason})")
            _sync(dev)
            return time.perf_counter() - t0
        finally:
            ctx.fini()

    # a caller's explicit API setting survives the sweep (unsetting alone
    # would put them back on the default)
    restore = None
    try:
        if mca_param.source("device", "cuda_wave_batch") == "api":
            restore = mca_param.get("device", "cuda_wave_batch")
    except KeyError:
        pass
    try:
        return autotune("dpotrf", n, dt, param="wave", candidates=list(candidates),
                        runner=run, reps=reps, device=dev, store=store, meta={"nb": nb})
    finally:
        if restore is not None:
            mca_param.set_param("device", "cuda_wave_batch", restore)
        else:
            mca_param.unset("device", "cuda_wave_batch")
