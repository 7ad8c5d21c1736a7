"""CollectiveTask — collectives as task-graph nodes.

The port of :mod:`parsec_tpu.dsl.collective`.  A collective embedded in a
DTD graph is N ordinary tasks (one per group rank, placed by AFFINITY on a
rank-local tile) whose bodies meet inside the comm engine's collective
endpoint (:mod:`parsec_tpu_torch.comm.coll`).  Because every rank runs the
same SPMD insert stream, the per-taskpool collective sequence number is
identical everywhere — the ranks' bodies rendezvous on a deterministic
collective id with no extra coordination.

The payoff of the task form over calling ``ce.coll_allreduce`` by hand:

* **normal dependencies** — each rank's node orders after the local
  producers of its tile (last-writer/reader inference) and before its
  local consumers, so a collective sits in the DAG like any task; remote
  readers of another rank's tile still see the post-collective version
  through the ordinary shadow-task epoch protocol (the insert bumps the
  tile like any writer);
* **termdet safety** — the pool cannot quiesce under an in-flight
  collective, because the node only retires when the collective
  completes; the collective's control messages are themselves counted by
  the four-counter protocol on both sides;
* **priority isolation** — collective traffic rides below dependency
  activations (MCA ``runtime_coll_priority``), so a bulk allreduce
  never starves the critical path of the surrounding graph.

The body is a host body, as in the reference: a tile whose newest copy
lives on the CUDA module is staged home before it runs (a bfloat16 tile
arrives as a torch CPU tensor), and later device consumers stage the
reduced tile back in.

Usage (identical on every rank — SPMD)::

    tp = DTDTaskpool(ctx)
    tp.insert_task(produce, (tiles[ctx.rank], INOUT | AFFINITY))  # per rank
    CollectiveTask.allreduce(tp, tiles)        # one node per rank
    tp.insert_task(consume, (tiles[ctx.rank], IN | AFFINITY))

``tiles`` maps each group rank to a tile OWNED by that rank (a
collection-backed ``Data`` whose ``rank_of`` is the rank) with identical
shape/dtype across the group.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import debug
from .dtd import AFFINITY, DTDTaskpool, INOUT

__all__ = ["CollectiveTask"]

#: default wall-clock bound for one embedded collective (a wedged peer
#: otherwise blocks the node forever; the watchdog names the op first)
WAIT_TIMEOUT_DEFAULT = 600.0


def _tile_of(tiles, rank: int):
    if callable(tiles):
        return tiles(rank)
    return tiles[rank]  # a dict, or a sequence indexed by rank


def _store(arr, res, name: str) -> None:
    """Write a collective's result into the staged tile ``arr`` in place:
    an ndarray, or a torch CPU tensor (bfloat16)."""
    if isinstance(arr, torch.Tensor):
        res = torch.as_tensor(res).reshape(arr.shape)
        if res.dtype != arr.dtype:
            debug.warning("%s: result dtype %s cast to tile dtype %s",
                          name, res.dtype, arr.dtype)
        arr.copy_(res)
        return
    res = np.asarray(res).reshape(arr.shape)
    if res.dtype != arr.dtype:
        debug.warning("%s: result dtype %s cast to tile dtype %s",
                      name, res.dtype, arr.dtype)
    arr[...] = res


class CollectiveTask:
    """Inserters that add one collective node per group rank to a DTD
    taskpool.  Each call returns the tasks it inserted (``None`` entries
    are the shadow insertions of remote ranks' nodes, like any remote
    task)."""

    @staticmethod
    def _insert(tp: DTDTaskpool, kind: str, tiles, *, group=None,
                op: str = "sum", root: int = 0,
                algo: Optional[str] = None,
                timeout: float = WAIT_TIMEOUT_DEFAULT,
                name: Optional[str] = None):
        if tp.context is None:
            raise RuntimeError(
                "CollectiveTask needs a context-attached taskpool")
        ctx = tp.context
        group = list(group) if group is not None \
            else list(range(ctx.nranks))
        # SPMD-deterministic collective id: every rank draws the same
        # number at the same insert.  The counter lives on the ENDPOINT
        # (CollManager.sequence), not the taskpool — two same-named
        # pools (DTDTaskpool's default name is shared) must not collide
        # on ("ctask", name, 1, kind)
        if ctx.comm is not None:
            seq = ctx.comm.coll.sequence(("ctask", tp.name))
        else:  # single rank: cid uniqueness is process-local anyway
            seq = getattr(tp, "_coll_seq", 0) + 1
            tp._coll_seq = seq
        cid = ("ctask", tp.name, seq, kind)
        name = name or f"coll_{kind}"
        tasks = []
        for r in group:
            tile = _tile_of(tiles, r)

            def body(arr, _r=r, _cid=cid, _kind=kind):
                ce = ctx.comm
                if ce is None:
                    if len(group) > 1:
                        raise RuntimeError(
                            f"{name}: multi-rank collective without a "
                            "comm engine")
                    return  # single rank: allreduce of one == identity
                mgr = ce.coll
                if _kind == "allreduce":
                    h = mgr.allreduce(arr, group=group, op=op, algo=algo,
                                      cid=_cid)
                elif _kind == "bcast":
                    h = mgr.bcast(arr, root=root, group=group, cid=_cid)
                else:  # pragma: no cover - guarded by the wrappers
                    raise ValueError(_kind)
                if not h.wait(timeout=timeout):
                    raise RuntimeError(
                        f"{name} timed out after {timeout:g}s: "
                        f"{h.state()}")
                _store(arr, h.result(), name)

            tasks.append(tp.insert_task(
                body, (tile, INOUT | AFFINITY), name=name))
        return tasks

    @staticmethod
    def allreduce(tp: DTDTaskpool, tiles, *, group=None, op: str = "sum",
                  algo: Optional[str] = None,
                  timeout: float = WAIT_TIMEOUT_DEFAULT,
                  name: Optional[str] = None):
        """Insert an allreduce node per group rank: after the nodes
        retire, every rank's tile holds the elementwise ``op`` reduction
        of all contributions."""
        return CollectiveTask._insert(tp, "allreduce", tiles, group=group,
                                      op=op, algo=algo, timeout=timeout,
                                      name=name)

    @staticmethod
    def bcast(tp: DTDTaskpool, tiles, *, root: int = 0, group=None,
              timeout: float = WAIT_TIMEOUT_DEFAULT,
              name: Optional[str] = None):
        """Insert a broadcast node per group rank: after the nodes
        retire, every rank's tile holds the root rank's tile content."""
        return CollectiveTask._insert(tp, "bcast", tiles, group=group,
                                      root=root, timeout=timeout,
                                      name=name)
