"""Tile-grid → tile-grid redistribution.

The port of :mod:`parsec_tpu.datadist.redistribute`.  Reference:
``parsec/data_dist/matrix/redistribute/`` — a PTG copying an m×n window
from source matrix S (any tiling/distribution, offset (ia, ja)) into
target matrix T (any tiling/distribution, offset (ib, jb)), with a
same-geometry fast path (``redistribute_reshuffle.jdf``) and a DTD variant
(``redistribute_dtd.c``).  This taskpool version reshards *tiled
collections*.

Two data paths, selectable with ``algo=`` (MCA
``runtime_redistribute_algo``: ``auto`` | ``dtd`` | ``coll``):

* **dtd** — each target tile is one task reading every overlapping
  source tile; remote tiles ship whole over the shadow-task protocol.
  Pure dataflow (overlaps surrounding taskpools), but an all-pairs
  resharding moves every source tile once per consuming target tile and
  buffers without a bound.
* **coll** — the intersection regions are grouped per (source, target)
  rank pair and moved in memory-bounded collective rounds
  (:class:`~parsec_tpu_torch.comm.coll.RedistOp`, in the style of
  "Memory-efficient array redistribution through portable collective
  communication"): regions are staged into budget-capped batches, walked
  in linear-shift order, pulled in pipelined chunks, and scattered
  straight into the target tiles — peak extra memory per rank stays
  under ``runtime_redistribute_mem_budget`` and each byte crosses the
  wire exactly once.  ``auto`` picks this path on multi-rank meshes.

Both paths produce bit-identical targets (pure copies).  The bodies are
host bodies over the target tiles; every region copy is a torch copy, so
a bfloat16 tile (a torch CPU tensor) moves like any other.  On the
collective path a source tile is read where its newest copy lives: one
on the card is read there (behind its ready event), region by region,
never from an older host copy.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.data import ready_event, torch_dtype
from ..dsl.dtd import AFFINITY, CTL, DTDTaskpool, IN, INOUT
from ..utils import debug, mca_param
from .matrix import TiledMatrix

#: default peak-extra-memory budget for the collective path (bytes)
MEM_BUDGET_DEFAULT = 16 << 20


def _overlap_1d(lo: int, hi: int, b: int):
    """Tiles of size b intersecting global index range [lo, hi)."""
    first = lo // b
    last = (hi - 1) // b
    return range(first, last + 1)


def _t(x) -> torch.Tensor:
    """A torch view of a tile payload (an ndarray is aliased, not copied)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def resolve_redistribute_algo(algo: Optional[str], context) -> str:
    """THE shared resolver of the redistribution data path — every entry
    point (the module-level :func:`redistribute`, the array layer's
    ``DistArray.redistribute``) must come through here so the algo string
    is parsed in exactly one place.

    Precedence: a caller's explicit ``dtd``/``coll`` wins; an
    *explicitly configured* MCA value (api/env/file source) wins over a
    caller's literal ``"auto"`` (a caller passing ``algo="auto"`` must
    not shadow an exported ``PARSEC_MCA_runtime_redistribute_algo=dtd``);
    ``auto`` finally resolves to ``coll`` on multi-rank meshes with a comm
    engine and ``dtd`` otherwise."""
    mca_val = str(mca_param.register(
        "runtime", "redistribute_algo", "auto",
        choices=["auto", "dtd", "coll"],
        help="redistribution data path: dtd (all-pairs shadow-task "
             "copies) | coll (memory-bounded collective rounds) | auto "
             "(coll on multi-rank meshes)"))
    if algo is None:
        algo = mca_val
    elif algo == "auto" and mca_param.params.source(
            "runtime", "redistribute_algo") != "default":
        algo = mca_val  # explicit MCA beats a caller's literal "auto"
    if algo not in ("auto", "dtd", "coll"):
        raise ValueError(
            f"unknown redistribute algo {algo!r} (expected auto|dtd|coll)")
    if algo == "auto":
        algo = "coll" if (context is not None and context.nranks > 1
                          and context.comm is not None) else "dtd"
    return algo


def redistribute(
    context,
    S: TiledMatrix,
    T: TiledMatrix,
    *,
    m: Optional[int] = None,
    n: Optional[int] = None,
    ia: int = 0,
    ja: int = 0,
    ib: int = 0,
    jb: int = 0,
    algo: Optional[str] = None,
    mem_budget: Optional[int] = None,
) -> DTDTaskpool:
    """Copy ``S[ia:ia+m, ja:ja+n]`` into ``T[ib:ib+m, jb:jb+n]`` as a
    taskpool (reference ``parsec_redistribute``). Defaults copy the full
    common window. Returns the taskpool; ``wait()`` it (or compose it).
    ``algo``/``mem_budget`` override the MCA parameters (see module
    docstring); the taskpool's ``user`` dict reports the path taken and,
    for the collective path, the measured ``peak_extra_bytes``."""
    m = m if m is not None else min(S.m - ia, T.m - ib)
    n = n if n is not None else min(S.n - ja, T.n - jb)
    if m <= 0 or n <= 0:
        raise ValueError("empty redistribution window")
    if ia + m > S.m or ja + n > S.n or ib + m > T.m or jb + n > T.n:
        raise ValueError("window exceeds matrix bounds")

    from .ops import _check_context_ranks

    _check_context_ranks(context, S, "redistribute")
    _check_context_ranks(context, T, "redistribute")

    algo = resolve_redistribute_algo(algo, context)
    if algo == "coll":
        return _redistribute_coll(context, S, T, m=m, n=n, ia=ia, ja=ja,
                                  ib=ib, jb=jb, mem_budget=mem_budget)
    return _redistribute_dtd(context, S, T, m=m, n=n, ia=ia, ja=ja,
                             ib=ib, jb=jb)


def _copy_tile(src, dst):
    _t(dst).copy_(_t(src))


def _redistribute_dtd(context, S, T, *, m, n, ia, ja, ib, jb):
    """The all-pairs DTD path: every rank inserts the identical task
    stream (DTD sequential semantics); AFFINITY on the target tile
    places each task on T's owner and the shadow-task protocol ships
    remote source tiles (reference: redistribute_dtd.c over mpiexec)."""
    tp = DTDTaskpool(context, name=f"redist_{S.name}_to_{T.name}")

    # fast path: identical tiling and aligned offsets → plain tile-wise
    # copies, skipping all intersection arithmetic (reference
    # redistribute_reshuffle.jdf same-geometry specialization)
    same_geometry = (
        S.mb == T.mb and S.nb == T.nb
        and ia % S.mb == 0 and ja % S.nb == 0
        and ib % T.mb == 0 and jb % T.nb == 0
        and m % S.mb == 0 and n % S.nb == 0
    )
    tp.user = {"algo": "dtd", "fast_path": same_geometry}
    if same_geometry:
        di, dj = ia // S.mb, ja // S.nb
        oi, oj = ib // T.mb, jb // T.nb
        for r in range(m // S.mb):
            for c in range(n // S.nb):
                tp.insert_task(
                    _copy_tile,
                    (S.data_of(di + r, dj + c), IN),
                    (T.data_of(oi + r, oj + c), INOUT | AFFINITY),
                    name="reshuffle")
        return tp

    for ti in _overlap_1d(ib, ib + m, T.mb):
        for tj in _overlap_1d(jb, jb + n, T.nb):
            # target-tile region clipped to the window, in global T coords
            th, tw = T.tile_shape(ti, tj)
            r0 = max(ti * T.mb, ib)
            r1 = min(ti * T.mb + th, ib + m)
            c0 = max(tj * T.nb, jb)
            c1 = min(tj * T.nb + tw, jb + n)
            if r0 >= r1 or c0 >= c1:
                continue
            # corresponding S global coords
            sr0, sr1 = r0 - ib + ia, r1 - ib + ia
            sc0, sc1 = c0 - jb + ja, c1 - jb + ja
            src_tiles = [
                (si, sj)
                for si in _overlap_1d(sr0, sr1, S.mb)
                for sj in _overlap_1d(sc0, sc1, S.nb)
            ]

            def body(*tiles, ti=ti, tj=tj, r0=r0, r1=r1, c0=c0, c1=c1,
                     sr0=sr0, sc0=sc0, src_tiles=tuple(src_tiles)):
                dst = _t(tiles[-1])
                for (si, sj), src in zip(src_tiles, tiles[:-1]):
                    src = _t(src)
                    # intersection of this source tile with the S window
                    a0 = max(si * S.mb, sr0)
                    a1 = min(si * S.mb + src.shape[0], sr0 + (r1 - r0))
                    b0 = max(sj * S.nb, sc0)
                    b1 = min(sj * S.nb + src.shape[1], sc0 + (c1 - c0))
                    if a0 >= a1 or b0 >= b1:
                        continue
                    dst[a0 - sr0 + (r0 - ti * T.mb):a1 - sr0 + (r0 - ti * T.mb),
                        b0 - sc0 + (c0 - tj * T.nb):b1 - sc0 + (c0 - tj * T.nb)].copy_(
                        src[a0 - si * S.mb:a1 - si * S.mb, b0 - sj * S.nb:b1 - sj * S.nb])

            args = [(S.data_of(*st), IN) for st in src_tiles]
            args.append((T.data_of(ti, tj), INOUT | AFFINITY))
            tp.insert_task(body, *args, name="redist")
    return tp


# ---------------------------------------------------------------------------
# the collective path
# ---------------------------------------------------------------------------

def _regions(S: TiledMatrix, T: TiledMatrix, m: int, n: int,
             ia: int, ja: int, ib: int, jb: int):
    """Every (source tile ∩ target tile) rectangle of the window, as
    ``(src_key, dst_key, src_rows, src_cols, dst_rows, dst_cols)`` with
    slices in TILE-LOCAL coordinates.  This is the same intersection
    arithmetic the DTD bodies evaluate lazily, enumerated eagerly so the
    collective path can group regions by rank pair."""
    for ti in _overlap_1d(ib, ib + m, T.mb):
        for tj in _overlap_1d(jb, jb + n, T.nb):
            th, tw = T.tile_shape(ti, tj)
            r0 = max(ti * T.mb, ib)
            r1 = min(ti * T.mb + th, ib + m)
            c0 = max(tj * T.nb, jb)
            c1 = min(tj * T.nb + tw, jb + n)
            if r0 >= r1 or c0 >= c1:
                continue
            sr0, sr1 = r0 - ib + ia, r1 - ib + ia
            sc0, sc1 = c0 - jb + ja, c1 - jb + ja
            for si in _overlap_1d(sr0, sr1, S.mb):
                for sj in _overlap_1d(sc0, sc1, S.nb):
                    sh, sw = S.tile_shape(si, sj)
                    a0 = max(si * S.mb, sr0)
                    a1 = min(si * S.mb + sh, sr1)
                    b0 = max(sj * S.nb, sc0)
                    b1 = min(sj * S.nb + sw, sc1)
                    if a0 >= a1 or b0 >= b1:
                        continue
                    # the same global rectangle, in each tile's frame
                    dr0 = a0 - ia + ib - ti * T.mb
                    dc0 = b0 - ja + jb - tj * T.nb
                    yield ((si, sj), (ti, tj),
                           (a0 - si * S.mb, a1 - si * S.mb),
                           (b0 - sj * S.nb, b1 - sj * S.nb),
                           (dr0, dr0 + (a1 - a0)),
                           (dc0, dc0 + (b1 - b0)))


def _tile_array(M: TiledMatrix, key) -> torch.Tensor:
    """The newest copy of one of ``M``'s tiles, where it lives, clipped to
    the tile's shape: a CUDA copy is read on the card behind its ready
    event (the reference's ``np.asarray`` would fail on it, and an older
    host copy would be stale); a host copy is aliased."""
    c = M.data_of(*key).newest_copy()
    if c is None:
        raise RuntimeError(f"tile {key} of {M.name} has no copy")
    arr = c.payload
    if isinstance(arr, torch.Tensor) and arr.is_cuda:
        ev = ready_event(arr)
        if ev is not None:
            torch.cuda.current_stream(arr.device).wait_event(ev)
    h, w = M.tile_shape(*key)
    return _t(arr)[:h, :w]


def _redistribute_coll(context, S, T, *, m, n, ia, ja, ib, jb,
                       mem_budget=None):
    """One task per PARTICIPATING rank, inserted by every rank (DTD
    sequential semantics).  Rank r's task declares r's source tiles of
    the window as control dependencies (CTL: ordered after their
    producers, no body argument) and r's target tiles as INOUT flows
    (AFFINITY places the task on r; later readers order after it) — so
    the collective path composes with surrounding taskpools through the
    ordinary last-writer/epoch machinery, exactly like the DTD path.
    The body runs the memory-bounded collective rounds for rank r's
    share (send side: regions of locally-owned S tiles bound for remote
    T tiles; receive side: remote regions scattered straight into the
    INOUT tile buffers; rank-local regions copy directly).  It pumps
    the comm engine while it waits, so a 1-worker rank cannot wedge."""
    budget = int(mem_budget if mem_budget is not None else mca_param.register(
        "runtime", "redistribute_mem_budget", MEM_BUDGET_DEFAULT,
        help="peak extra bytes per rank (staging + landing buffers) the "
             "collective redistribution path may hold at once"))
    if budget <= 0:
        raise ValueError(
            f"redistribute mem budget must be positive, got {budget}")
    tp = DTDTaskpool(context, name=f"redist_{S.name}_to_{T.name}")
    tp.user = {"algo": "coll", "budget": budget}
    nranks = 1 if context is None else context.nranks
    ce = context.comm if context is not None else None

    # the collective id, drawn from the endpoint's per-key sequence at
    # INSERT time: the SPMD insert stream is identical on every rank, so
    # equal calls draw equal numbers — and REPEATED redistributions of
    # the same window draw DISTINCT cids (a reused cid races the
    # endpoint's finished-cid ledger: a fast peer's advert for round
    # N+1 arriving before this rank binds would be dropped as a late
    # straggler of round N and the collective would hang)
    if nranks > 1 and ce is not None:
        seq = ce.coll.sequence(("redist", tp.name))
    else:
        seq = 0
    cid = ("redist", tp.name, seq, m, n, ia, ja, ib, jb)

    # enumerate the window once and group regions per rank — ownership
    # is global distribution arithmetic, so every rank builds the
    # identical plan (and the identical insert stream below)
    plan: Dict[int, dict] = {}

    def _rank_plan(r):
        return plan.setdefault(r, {"s": {}, "t": {}, "local": [],
                                   "send": [], "expect": set()})

    for reg in _regions(S, T, m, n, ia, ja, ib, jb):
        sk, dk = reg[0], reg[1]
        src_rank = S.rank_of(*sk) if nranks > 1 else 0
        dst_rank = T.rank_of(*dk) if nranks > 1 else 0
        _rank_plan(src_rank)["s"][sk] = True
        _rank_plan(dst_rank)["t"][dk] = True
        if src_rank == dst_rank:
            _rank_plan(src_rank)["local"].append(reg)
        else:
            _rank_plan(src_rank)["send"].append((dst_rank, reg))
            _rank_plan(dst_rank)["expect"].add(src_rank)

    tdt = torch_dtype(T.default_dtype)
    isz = torch.empty(0, dtype=tdt).element_size()

    for r in sorted(plan):
        rp = plan[r]
        t_keys = tuple(rp["t"])
        args: List = [(S.data_of(*k), CTL) for k in rp["s"]]
        args += [(T.data_of(*k),
                  (INOUT | AFFINITY) if i == 0 else INOUT)
                 for i, k in enumerate(t_keys)]

        def body(*arrs, _rp=rp, _t_keys=t_keys):
            # CTL args contribute no body argument, so ``arrs`` are
            # exactly this rank's INOUT target-tile buffers, in order
            dst_of = dict(zip(_t_keys, arrs))

            def _dst(dk):
                h, w = T.tile_shape(*dk)
                return _t(dst_of[dk])[:h, :w]

            for (sk, dk, sr, sc, dr, dc) in _rp["local"]:
                _dst(dk)[dr[0]:dr[1], dc[0]:dc[1]].copy_(
                    _tile_array(S, sk)[sr[0]:sr[1], sc[0]:sc[1]])

            sends: Dict[int, List] = {}
            for dst_rank, (sk, dk, sr, sc, dr, dc) in _rp["send"]:
                shape = (sr[1] - sr[0], sc[1] - sc[0])
                nbytes = shape[0] * shape[1] * isz

                def fill(view, _sk=sk, _sr=sr, _sc=sc, _shape=shape):
                    torch.from_numpy(view).view(tdt).reshape(_shape).copy_(
                        _tile_array(S, _sk)[_sr[0]:_sr[1], _sc[0]:_sc[1]])

                meta = (tuple(dk), tuple(dr), tuple(dc))
                sends.setdefault(dst_rank, []).append(
                    (meta, nbytes, fill))

            def deliver(meta, view):
                dk, dr_, dc_ = meta
                shape = (dr_[1] - dr_[0], dc_[1] - dc_[0])
                _dst(tuple(dk))[dr_[0]:dr_[1], dc_[0]:dc_[1]].copy_(
                    torch.from_numpy(view).view(tdt).reshape(shape))

            if nranks > 1 and (sends or _rp["expect"]):
                op = ce.coll.redistribute(
                    cid, sends=sends, expect_from=sorted(_rp["expect"]),
                    deliver=deliver, budget=budget)
                if not op.wait(timeout=600):
                    raise RuntimeError(
                        f"collective redistribution timed out: "
                        f"{op.state()}")
                tp.user.update(op.result())
                if op.result()["peak_extra_bytes"] > budget:
                    debug.warning(
                        "redistribute %s: peak extra memory %dB exceeded "
                        "the %dB budget (an oversized single region "
                        "forces this; raise "
                        "runtime_redistribute_mem_budget)",
                        tp.name, op.result()["peak_extra_bytes"], budget)
            else:
                tp.user.setdefault("peak_extra_bytes", 0)

        tp.insert_task(body, *args, name="redist_coll")
    return tp
