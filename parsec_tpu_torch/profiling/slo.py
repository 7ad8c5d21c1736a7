"""Straggler comparison: the slice of :mod:`parsec_tpu.profiling.slo` the
offline critical-path report needs.

:func:`mesh_stragglers` is the one comparison the reference's live SLO
plane and ``profiling.critpath`` share, and :func:`straggler_params` its
MCA-tuned thresholds (``runtime_straggler_factor``,
``runtime_straggler_min_samples``).  The live plane itself (``SloPlane``,
the latency histograms, ``PARSEC_TPU_SLO``) is ROADMAP A.9b part 2.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from ..utils import mca_param

__all__ = ["mesh_stragglers", "straggler_params"]


def mesh_stragglers(by_class: Dict[str, Dict[Any, Tuple[int, float]]],
                    factor: float, min_samples: int
                    ) -> List[Tuple[str, Any, float, float, float]]:
    """THE straggler comparison, shared by the reference's live plane
    (``SloPlane.stragglers``, heartbeat-gossiped digests) and the
    offline one (``profiling.critpath``, trace-derived means) so the
    two reports cannot drift: per class, per-rank mean exec times
    (``{cls: {rank: (count, mean)}}``, any consistent time unit) are
    compared against the mesh median of per-rank means.  Pairs need
    ``min_samples`` observations, a class needs >= 2 reporting ranks (a
    median of one is a tautology).  Returns sorted
    ``(cls, rank, mean, median, ratio)`` tuples for ratios past
    ``factor``."""
    out: List[Tuple[str, Any, float, float, float]] = []
    for cls, per_rank in sorted(by_class.items()):
        means = sorted(m for (n, m) in per_rank.values()
                       if n >= min_samples)
        if len(means) < 2:
            continue
        med = means[len(means) // 2]
        if med <= 0:
            continue
        for rank, (n, mean) in sorted(per_rank.items(),
                                      key=lambda kv: str(kv[0])):
            if n >= min_samples and mean / med > factor:
                out.append((cls, rank, mean, med, mean / med))
    return out


def straggler_params() -> Tuple[float, int]:
    """The MCA-tuned (factor, min_samples) thresholds — one source for
    the live OBS010 plane and the offline critpath report."""
    factor = float(mca_param.register(
        "runtime", "straggler_factor", 3.0,
        help="a rank running a task class this many times slower "
             "than the mesh median of per-rank means is flagged as "
             "a straggler (OBS010)"))
    min_samples = int(mca_param.register(
        "runtime", "straggler_min_samples", 5,
        help="per-(class, rank) exec samples required before the "
             "straggler comparison considers the pair"))
    return factor, min_samples
