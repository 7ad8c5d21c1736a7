"""Shared multi-rank run harness over the in-process fabric.

The port of :mod:`parsec_tpu.multirank`.  One rank = one full
:class:`~parsec_tpu_torch.core.context.Context` (its own scheduler,
workers and device modules) talking to its peers only through the comm
engine — the "multi-node is multi-process on one node" testing shape of
the reference (mpiexec on one host), one level further down.  The
distributed segmented Cholesky, the multi-rank tests and the card's
smoke run share this one implementation, perf-row bookkeeping included:
wall clock, executed tasks, activation counts, the wire summary and,
optionally, the per-rank comm/compute overlap of
:func:`parsec_tpu_torch.profiling.overlap.measure_overlap`.

Every rank's contexts bind the card unless the caller asks for the CPU
(``devices=["cpu"]``, or ``cuda_device="cpu"`` for the CUDA module on the
torch CPU device); on a one-card host every rank binds ``cuda:0``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["run_multirank_perf"]


def run_multirank_perf(
    nranks: int,
    build: Callable[[int, Any], Tuple[Any, Any]],
    *,
    nb_cores: int = 2,
    timeout: float = 600,
    fabric=None,
    overlap: bool = False,
    flops: Optional[float] = None,
    trace_dir: Optional[str] = None,
    devices: Optional[Sequence[str]] = None,
    cuda_device: Optional[str] = None,
) -> Tuple[List[Any], Dict]:
    """Run one taskpool per rank to quiescence and return perf stats.

    ``build(rank, ctx) -> (taskpool, user)`` constructs each rank's
    taskpool (and any per-rank object the caller needs back — a data
    collection, usually).  Returns ``(users, stats)`` where ``stats``
    carries ``wall_s`` / ``rank_wall_s`` (each rank's seconds from the
    common start to its pool's quiescence) / ``executed_tasks`` /
    ``tasks_per_s`` / ``activations`` / ``bytes_d2d`` and the wire
    summary (``wire``, ``eager_hit_rate``, ``wire_bytes``), plus
    ``gflops`` when ``flops`` is given (flops / wall: the aggregate
    figure).

    With ``overlap=True`` (or any ``trace_dir``) every rank records its
    OWN binary trace, after a clock-alignment handshake at pool start
    (``stats["clock_offsets_ns"]`` and ``stats["handshake_rtt_ns"]`` a
    rank; rank 0 is the reference), and ``stats`` carries the PER-RANK
    comm/compute overlap (``overlap_fraction`` = mean across ranks,
    ``overlap_min``, ``overlap_per_rank``, plus the unioned
    ``overlap_union``).  With ``trace_dir`` the per-rank ``rank<r>.pbt``
    dumps and ONE merged Chrome trace (one track per rank;
    ``stats["merged_trace"]``) are written there.

    ``devices`` / ``cuda_device`` go to every rank's ``Context``.  Raises
    on any rank error or failed quiescence — after every context is
    finalized, so a failure cannot leak worker threads.  The returned
    ``users`` objects stay readable after fini (tiles outlive contexts)."""
    from . import Context
    from .comm import InprocFabric

    stats: Dict = {}
    traces = None
    if overlap or trace_dir is not None:
        from .profiling.binary import RankTraceSet
        from .profiling.overlap import measure_overlap

        traces = RankTraceSet(nranks)
        scope = measure_overlap(stats, trace_dir=trace_dir, traces=traces)
    else:
        scope = contextlib.nullcontext()

    ctx_kw: Dict[str, Any] = {}
    if devices is not None:
        ctx_kw["devices"] = list(devices)
    if cuda_device is not None:
        ctx_kw["cuda_device"] = cuda_device
    with scope:
        fabric = fabric or InprocFabric(nranks)
        ces = fabric.endpoints()
        ctxs: List[Any] = []
        try:
            for r in range(nranks):
                ctxs.append(Context(nb_cores=nb_cores, rank=r, nranks=nranks,
                                    comm=ces[r], **ctx_kw))
        except BaseException:
            for c in ctxs:
                c.fini()
            raise
        users: List[Any] = [None] * nranks
        oks: List[Any] = [False] * nranks
        done_s: List[Optional[float]] = [None] * nranks
        offsets: List[Optional[int]] = [None] * nranks
        errs: List[Tuple[int, BaseException]] = []
        t0 = time.perf_counter()

        def worker(r):
            try:
                if traces is not None and nranks > 1:
                    # pool-start clock alignment: each rank's trace
                    # records its monotonic offset to rank 0 so the
                    # offline merge lands every rank on one timeline
                    from .profiling.merge import clock_handshake

                    offsets[r] = clock_handshake(ces[r])
                    traces.set_clock_offset(r, offsets[r])
                tp, users[r] = build(r, ctxs[r])
                ctxs[r].add_taskpool(tp)
                oks[r] = tp.wait(timeout=timeout)
                done_s[r] = time.perf_counter() - t0
            except BaseException as e:  # surfaced after join
                errs.append((r, e))

        threads = [threading.Thread(target=worker, args=(r,),
                                    name=f"multirank-r{r}")
                   for r in range(nranks)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout + 30)
        stats["wall_s"] = time.perf_counter() - t0
        stats["rank_wall_s"] = done_s

        try:
            if errs:
                raise RuntimeError(f"rank errors: {errs}")
            if not all(oks):
                raise RuntimeError(f"ranks failed to quiesce: {oks}")
            if traces is not None and nranks > 1:
                from .profiling.merge import last_handshake

                shakes = [last_handshake(r) for r in range(nranks)]
                stats["clock_offsets_ns"] = [
                    0 if r == 0 else offsets[r] for r in range(nranks)]
                stats["handshake_rtt_ns"] = [
                    None if s is None else s["rtt_ns"] for s in shakes]
            execd = sum(d.stats["executed_tasks"]
                        for c in ctxs for d in c.devices)
            stats["executed_tasks"] = execd
            stats["tasks_per_s"] = round(
                execd / max(stats["wall_s"], 1e-9), 1)
            stats["activations"] = sum(
                c.comm.remote_dep.stats["activations_sent"] for c in ctxs)
            stats["bytes_d2d"] = sum(
                d.stats.get("bytes_d2d", 0)
                for c in ctxs for d in c.devices)
            if flops is not None:
                stats["gflops"] = round(
                    flops / max(stats["wall_s"], 1e-9) / 1e9, 3)
            stats["activations_per_s"] = round(
                stats["activations"] / max(stats["wall_s"], 1e-9), 1)
            # wire-protocol summary (eager/rendezvous regime split): how
            # the dependency payloads actually travelled, next to the
            # tasks/s they enabled
            eager = rdv = 0
            wire_bytes = 0
            proto: Dict[str, Any] = {}
            for c in ctxs:
                rd = getattr(c.comm, "remote_dep", None)
                if rd is None or not hasattr(rd, "protocol_stats"):
                    continue
                ps = rd.protocol_stats()
                for k, v in ps.items():
                    if k != "eager_hit_rate":
                        proto[k] = proto.get(k, 0) + v
                eager += ps["eager_sent"]
                rdv += ps["rdv_sent"]
                wire_bytes += int(c.comm.stats.get("am_bytes", 0))
                if not getattr(c.comm, "pull_bytes_in_frames", False):
                    # table-served pulls (inproc) bypass AM frames; on
                    # frame-served engines get_bytes is already inside
                    # am_bytes — adding it would double-count
                    wire_bytes += int(c.comm.stats.get("get_bytes", 0))
            if proto:
                proto["eager_hit_rate"] = round(
                    eager / (eager + rdv), 4) if (eager + rdv) else 1.0
                stats["wire"] = proto
                stats["eager_hit_rate"] = proto["eager_hit_rate"]
                stats["wire_bytes"] = wire_bytes
        finally:
            for c in ctxs:
                c.fini()
    return users, stats
