"""Comm/compute overlap measurement as a reusable scope — PER RANK.

The port of :mod:`parsec_tpu.profiling.overlap`: the scope records one
binary trace per rank (:class:`~parsec_tpu_torch.profiling.binary.
RankTraceSet`) and computes each rank's fraction of comm events that
land inside its own exec spans, never the union over the mesh (which
reads near 1 whenever any rank computes).  At one rank no comm event
fires: the scope reports ``n_comm_events == 0`` and an overlap of 0, and
still yields the rank's busy time, its dump and (with ``trace_dir``) a
merged trace.

On the card a rank's ``exec`` span is the host's submit of the task
(its staging, launch and epilog enqueue; ``CudaDevice.fires_exec_pins``),
not the kernel's run on the device: the fraction is host comm against
host submit, not wire against kernel.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Dict, Iterator, List, Optional


@contextlib.contextmanager
def measure_overlap(stats: Dict, *, nranks: int = 1,
                    trace_dir: Optional[str] = None,
                    traces=None) -> Iterator[Dict]:
    """Context manager: record per-rank task/comm traces for everything
    run inside the scope; on exit merge into ``stats``:

    * ``overlap_fraction`` — MEAN across ranks of each rank's fraction
      of comm events landing inside its own exec-busy union (ranks with
      no comm events don't participate);
    * ``overlap_min`` / ``overlap_per_rank`` — the straggler view: one
      stalled rank shows up here even when the mean looks healthy;
    * ``overlap_union`` — the legacy all-ranks-unioned figure;
    * ``n_comm_events`` / ``busy_us`` — totals (union busy time);
    * with ``trace_dir``: per-rank ``rank<r>.pbt`` dumps plus ONE merged
      Chrome trace (``stats["merged_trace"]``, one track per rank,
      ``stats["trace_ranks"]`` tracks).

    Pass a pre-built installed-or-not :class:`RankTraceSet` via
    ``traces`` to keep its dumps, or to coordinate them with a clock
    handshake (:func:`parsec_tpu_torch.multirank.run_multirank_perf`
    does).  Raises when the native engine cannot be built (there is no
    fallback)."""
    from .binary import RankTraceSet, to_chrome_events
    from .tools import comm_overlap_fraction

    ts = traces if traces is not None else RankTraceSet(nranks)
    ts.install()
    try:
        yield stats
    finally:
        ts.uninstall()
        own_dir = None
        if trace_dir is None:
            own_dir = tempfile.mkdtemp(prefix="parsec_tpu_trace_")
        directory = trace_dir or own_dir
        try:
            paths = ts.dump(directory)
            per_rank_events: List[List[dict]] = [
                to_chrome_events(p) for p in paths]
            fractions: List[float] = []
            per_rank: List[Optional[float]] = []
            n_comm_total = 0
            for evs in per_rank_events:
                frac, n_comm, _busy = comm_overlap_fraction(evs)
                n_comm_total += n_comm
                per_rank.append(round(frac, 4) if n_comm else None)
                if n_comm:
                    fractions.append(frac)
            all_events = [e for evs in per_rank_events for e in evs]
            union_frac, _n, busy_us = comm_overlap_fraction(all_events)
            stats["overlap_per_rank"] = per_rank
            stats["overlap_fraction"] = round(
                sum(fractions) / len(fractions), 4) if fractions else 0.0
            stats["overlap_min"] = round(min(fractions), 4) \
                if fractions else 0.0
            stats["overlap_union"] = round(union_frac, 4)
            stats["n_comm_events"] = n_comm_total
            stats["busy_us"] = busy_us
            if trace_dir is not None:
                from .merge import merge_traces

                merged_path = os.path.join(trace_dir, "merged.trace.json")
                doc = merge_traces(paths, out=merged_path)
                stats["merged_trace"] = merged_path
                stats["trace_ranks"] = len(doc["metadata"]["ranks"])
        finally:
            # release the native tracer buffers: repeated measurement
            # scopes must not accumulate per-rank native buffers for the
            # life of the process
            ts.close()
            if own_dir is not None:
                import shutil

                shutil.rmtree(own_dir, ignore_errors=True)
