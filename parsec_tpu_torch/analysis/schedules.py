"""Deterministic schedule explorer — seeded interleaving fuzzing.

The port of :mod:`parsec_tpu.analysis.schedules`.  One passing run only
proves ONE schedule of the concurrent runtime correct.  This harness
re-runs a workload under *seeded perturbations* of the runtime ordering
degrees of freedom the protocol is supposed to tolerate:

* **ready-queue pop order** — the ``rnd`` scheduler with MCA
  ``sched_rnd_seed`` (PCT-style priority fuzzing: any ready task may run
  next; the native pump seeds its pop order from the same parameter);
* **completion timing** — a seeded jitter subscriber on ``EXEC_END``
  delays completions by random sub-millisecond amounts, shifting every
  release/writeback race window;
* **frame delivery** (``nranks > 1``) — an :class:`ExplorerFabric` wraps
  the inproc inboxes so frames deliver out of order and may be deferred
  for a few progress cycles (bounded, so liveness is preserved and
  termination detection still sees the truth: a deferred frame *is* a
  frame in flight).

Every exploration must (a) quiesce on every rank, (b) produce bit-identical results
(``snapshot``), and (c) pass a clean hb-check (:mod:`.hb`).  A failing
seed replays deterministically::

    PARSEC_MCA_sched_rnd_seed=<seed>  # the scheduler half
    explore(build, seeds=[<seed>])    # the whole perturbation

Usage::

    def build(rank, ctx):
        A = TwoDimBlockCyclic(..., myrank=rank)
        A.from_array(SPD)
        return cholesky_ptg(use_kernels=True).taskpool(NT=A.mt, A=A), A

    res = explore(build, seeds=range(4))   # two ranks, the default;
    assert res.identical and not res.race_findings()   # nranks=1: one Context
"""

from __future__ import annotations

import queue
import random
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .findings import Finding, errors_of
from .hb import HBRecorder

__all__ = ["ExplorerFabric", "ExplorationError", "ExplorationResult",
           "explore", "tile_digest"]


class _PerturbedInbox:
    """Drop-in for the fabric's ``SimpleQueue`` inboxes: frames come out
    in a seeded-random order, each optionally deferred for up to
    ``max_delay`` pop attempts.  Bounded deferral keeps liveness: every
    empty-handed pop spends deferral budget, so a frame can stall only a
    finite number of progress cycles."""

    def __init__(self, rng: random.Random, delay_prob: float,
                 max_delay: int):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._rng = rng
        self._delay_prob = delay_prob
        self._max_delay = max_delay
        self._buf: List[List[Any]] = []  # [frame, defers_left]
        self._mu = threading.Lock()

    def put(self, item) -> None:
        self._q.put(item)

    def get_nowait(self):
        with self._mu:
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                defers = self._rng.randint(0, self._max_delay) \
                    if self._rng.random() < self._delay_prob else 0
                self._buf.append([item, defers])
            if not self._buf:
                raise queue.Empty
            eligible = [i for i, (_f, d) in enumerate(self._buf) if d == 0]
            if not eligible:
                for e in self._buf:  # spend budget: guaranteed progress
                    e[1] -= 1
                raise queue.Empty
            idx = self._rng.choice(eligible)
            return self._buf.pop(idx)[0]

    def qsize(self) -> int:
        with self._mu:
            return len(self._buf) + self._q.qsize()

    def pending(self) -> int:
        """Frames held by the perturbation — still logically in flight."""
        return self.qsize()

    def peek_pending(self) -> List[Any]:
        """Snapshot of every in-flight frame (delivery order NOT implied).
        Inspection hook for protocol pins — e.g. "termination detection
        never declares quiescence while an application frame is in
        flight" (tests/runtime/test_termdet_explorer.py)."""
        with self._mu:
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                self._buf.append([item, 0])
            return [f for f, _d in self._buf]


class ExplorerFabric:
    """An :class:`~parsec_tpu_torch.comm.inproc.InprocFabric` whose
    inboxes reorder and defer deliveries under a per-rank seeded RNG."""

    def __new__(cls, nranks: int, seed: int = 0, *, delay_prob: float = 0.3,
                max_delay: int = 3):
        from ..comm.inproc import InprocFabric

        fab = InprocFabric(nranks)
        fab.inboxes = [
            _PerturbedInbox(random.Random((seed << 8) ^ r), delay_prob,
                            max_delay)
            for r in range(nranks)
        ]
        fab.explorer_seed = seed
        return fab


class ExplorationError(AssertionError):
    """A seed diverged, raced, or failed to quiesce.  The message names
    the seed; replay it alone (``seeds=[seed]``) to debug."""


class ExplorationResult:
    """Per-seed outcomes of one :func:`explore` run."""

    def __init__(self, nranks: int):
        self.nranks = nranks
        self.seeds: List[int] = []
        self.digests: Dict[int, Any] = {}
        self.findings: Dict[int, List[Finding]] = {}
        self.wall_s: Dict[int, float] = {}
        #: seed -> run-failure description (rank errors / failed
        #: quiescence) when assert_clean=False let the sweep continue
        self.errors: Dict[int, str] = {}

    @property
    def identical(self) -> bool:
        vals = [self.digests[s] for s in self.seeds
                if s not in self.errors]
        return all(_digest_equal(vals[0], v) for v in vals[1:]) if vals \
            else True

    def divergent_seeds(self) -> List[int]:
        if not self.seeds:
            return []
        ref = self.digests[self.seeds[0]]
        return [s for s in self.seeds[1:]
                if not _digest_equal(ref, self.digests[s])]

    def race_findings(self) -> List[Finding]:
        return [f for fs in self.findings.values() for f in errors_of(fs)]

    def summary(self) -> str:
        races = len(self.race_findings())
        failed = f", {len(self.errors)} failed seed(s)" if self.errors \
            else ""
        return (f"{len(self.seeds)} seed(s) x {self.nranks} rank(s): "
                f"{'identical' if self.identical else 'DIVERGENT'} "
                f"results, {races} race finding(s){failed}")


def _digest_equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.shape == b.shape and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            _digest_equal(v, b[k]) for k, v in a.items())
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            _digest_equal(x, y) for x, y in zip(a, b))
    return a == b


def _payload_digest(payload) -> Tuple:
    """(shape, dtype name, raw bytes) of a host array or a torch tensor.
    A tensor on the card is copied to the host first (on the current
    stream, after the kernels that wrote it); its dtype name is the
    numpy spelling (``float32``), so a host and a device copy of equal
    values digest equal.  bfloat16, which numpy lacks, is hashed by its
    raw bits."""
    import torch

    if isinstance(payload, torch.Tensor):
        t = payload.detach().cpu().contiguous()
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""),
                t.reshape(-1).view(torch.uint8).numpy().tobytes())
    arr = np.asarray(payload)
    return (arr.shape, str(arr.dtype), arr.tobytes())


def tile_digest(coll) -> Dict[Any, Tuple]:
    """Bit-exact digest of a collection's LOCAL tiles: key ->
    (shape, dtype, raw bytes) of the newest copy — on the card that is a
    CUDA tensor, copied to the host here, never the stale host copy.
    The default currency of cross-seed identity checks."""
    out: Dict[Any, Tuple] = {}
    keys = coll.local_tiles() if hasattr(coll, "local_tiles") else None
    if keys is None:
        return {"repr": repr(coll)}
    for key in keys:
        k = key if isinstance(key, tuple) else (key,)
        c = coll.data_of(*k).newest_copy()
        if c is None or c.payload is None:
            out[k] = None
            continue
        out[k] = _payload_digest(c.payload)
    return out


def _install_jitter(seed: int, max_jitter_s: float):
    """Seeded completion-timing jitter: an EXEC_END subscriber sleeping a
    random sub-ms delay, shifting every completion/release window."""
    from ..profiling import pins

    rng = random.Random(seed ^ 0x5EED)
    mu = threading.Lock()

    def cb(es, task):
        with mu:
            d = rng.random() * max_jitter_s
        if d > 0:
            time.sleep(d)

    pins.subscribe(pins.EXEC_END, cb)
    return lambda: pins.unsubscribe(pins.EXEC_END, cb)


def explore(
    build: Callable[[int, Any], Tuple[Any, Any]],
    *,
    nranks: int = 2,
    seeds: Iterable[int] = range(8),
    nb_cores: int = 2,
    timeout: float = 120,
    snapshot: Optional[Callable[[List[Any]], Any]] = None,
    hbcheck: bool = True,
    assert_clean: bool = True,
    delay_prob: float = 0.3,
    max_delay: int = 3,
    max_jitter_s: float = 5e-4,
    on_seed_done: Optional[Callable[[int], None]] = None,
) -> ExplorationResult:
    """Run ``build`` (``build(rank, ctx) -> (taskpool, user)``; a LIST of
    taskpools runs them co-resident on the context — the multi-tenant
    serving shape) once per seed under that seed's perturbations, on a
    ``Context(nb_cores, scheduler="rnd")`` made for the seed (its devices
    as any Context's: the card, or the torch CPU device under
    ``device_cuda_torch_device=cpu``), one context a rank (two by
    default, as in the reference) over an :class:`ExplorerFabric` when
    ``nranks > 1``, whose
    ``delay_prob``/``max_delay`` perturb frame delivery.

    ``snapshot(users) -> digest`` defines cross-seed identity (default:
    :func:`tile_digest` of every user object).  With ``assert_clean``
    (default) the first divergence, race finding, or failed quiescence
    raises :class:`ExplorationError` naming the seed; otherwise the
    :class:`ExplorationResult` carries everything for the caller to
    judge."""
    from .. import Context
    from ..utils import mca_param

    if snapshot is None:
        snapshot = lambda users: [tile_digest(u) for u in users]  # noqa: E731

    result = ExplorationResult(nranks)
    for seed in seeds:
        seed = int(seed)
        rec = HBRecorder(stacks=False).install() if hbcheck else None
        uninstall_jitter = _install_jitter(seed, max_jitter_s) \
            if max_jitter_s > 0 else None
        mca_param.params.set("sched", "rnd_seed", seed)
        t0 = time.perf_counter()
        try:
            if nranks == 1:
                ctxs = [Context(nb_cores=nb_cores, scheduler="rnd")]
            else:
                fabric = ExplorerFabric(nranks, seed, delay_prob=delay_prob,
                                        max_delay=max_delay)
                ces = fabric.endpoints()
                ctxs = [Context(nb_cores=nb_cores, scheduler="rnd", rank=r,
                                nranks=nranks, comm=ces[r])
                        for r in range(nranks)]
            users: List[Any] = [None] * nranks
            oks: List[Any] = [False] * nranks
            errs: List[Tuple[int, BaseException]] = []

            def worker(r):
                try:
                    # build may return ONE taskpool or a list of
                    # co-resident pools (the multi-tenant serving shape:
                    # several heterogeneous DAGs on one context at once)
                    tps, users[r] = build(r, ctxs[r])
                    if isinstance(tps, (list, tuple)):
                        for tp in tps:
                            ctxs[r].add_taskpool(tp)
                        # ONE shared deadline for the whole co-resident
                        # set (they execute concurrently), and every
                        # pool is waited even after a failure so
                        # teardown never races a still-live pool
                        deadline = time.monotonic() + timeout
                        ok = True
                        for tp in tps:
                            rem = max(0.01,
                                      deadline - time.monotonic())
                            ok = tp.wait(timeout=rem) and ok
                        oks[r] = ok
                    else:
                        ctxs[r].add_taskpool(tps)
                        oks[r] = tps.wait(timeout=timeout)
                except BaseException as e:
                    errs.append((r, e))

            threads = [threading.Thread(target=worker, args=(r,),
                                        name=f"explorer-s{seed}-r{r}")
                       for r in range(nranks)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=timeout + 30)
            try:
                run_error = None
                if errs:
                    run_error = (f"schedule explorer seed {seed}: rank "
                                 f"errors {errs} (replay: "
                                 f"PARSEC_MCA_sched_rnd_seed={seed}, "
                                 f"seeds=[{seed}])")
                elif not all(oks):
                    run_error = (f"schedule explorer seed {seed}: ranks "
                                 f"failed to quiesce {oks} "
                                 f"(replay: seeds=[{seed}])")
                if run_error is not None and assert_clean:
                    raise ExplorationError(run_error)
                digest = None if run_error is not None else snapshot(users)
            finally:
                for c in ctxs:
                    c.fini()
        finally:
            mca_param.params.unset("sched", "rnd_seed")
            if uninstall_jitter is not None:
                uninstall_jitter()
            if rec is not None:
                rec.uninstall()

        result.seeds.append(seed)
        result.digests[seed] = digest
        if run_error is not None:
            result.errors[seed] = run_error
        result.wall_s[seed] = time.perf_counter() - t0
        result.findings[seed] = rec.analyze() if rec is not None else []
        if assert_clean:
            races = errors_of(result.findings[seed])
            if races:
                raise ExplorationError(
                    f"schedule explorer seed {seed}: hb-check reported "
                    f"{len(races)} race finding(s): "
                    + "; ".join(str(f) for f in races[:3])
                    + f" (replay: seeds=[{seed}])")
            ref_seed = result.seeds[0]
            if not _digest_equal(result.digests[ref_seed], digest):
                raise ExplorationError(
                    f"schedule explorer seed {seed}: results DIVERGE "
                    f"from seed {ref_seed} — the protocol is "
                    f"schedule-dependent (replay: seeds=[{ref_seed}, "
                    f"{seed}])")
        if on_seed_done is not None:
            on_seed_done(seed)
    return result
