"""Checkpoint / resume for tiled collections.

The port of :mod:`parsec_tpu.data.checkpoint`.  The reference runtime has
no checkpoint/restart (its only drain primitive is DTD's
``parsec_dtd_data_flush_all``); this module persists the state a restarted
run needs: after a taskpool quiesces, every rank's local tiles hold the
authoritative state — save them, and a later job restores them and
continues.

* The checkpoint unit is a set of collections at a quiescent point
  (``tp.wait()``, ``dtd.flush_all()``).
* Each rank writes its own shard (``<path>.rank<r>.npz``); tiles are keyed
  globally, so shards restore under another rank layout.
* A tile whose newest version lives on the CUDA module is staged to the
  host first, through its ``Data`` versions and the device copy's ready
  event (:func:`~parsec_tpu_torch.dsl.ptg.stage_to_cpu`), never read from
  the host copy as it stands — that copy may be a version behind.

Format: one numpy ``.npz`` per rank, whose entry names are JSON objects
``{"c": <collection name>, "k": [<key...>]}``, plus a JSON manifest — the
JAX package's format, so a shard written by either package restores in
the other.  numpy has no bfloat16: a bfloat16 tile (a torch CPU tensor on
the host) cannot be saved.

Replicated collections (every rank holds every tile; ``rank_of`` does not
partition): pass ``owned_only=False`` plus an explicit ``rank=`` to BOTH
``save`` (shard naming) and ``restore`` (each rank reads its own shard —
reading all shards would let an arbitrary replica win).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np


def _tile_items(dc, owned_only: bool = True) -> Iterable[Tuple[Any, np.ndarray]]:
    """(key, host array) for local tiles holding data; ``owned_only``
    filters to tiles this rank owns (False: every materialized tile —
    the replicated-collection mode)."""
    from ..dsl.ptg import stage_to_cpu

    if not owned_only:
        # replicated mode: only MATERIALIZED tiles — enumerating the
        # global tile space would lazily fabricate init/zero payloads for
        # tiles this rank never touched and persist them as real state
        if hasattr(dc, "materialized_keys"):
            keys = dc.materialized_keys()
        elif hasattr(dc, "tiles"):
            keys = dc.tiles()
        else:
            raise TypeError(f"cannot enumerate materialized tiles of {dc!r}")
    elif hasattr(dc, "local_tiles"):  # tiled matrices
        keys = dc.local_tiles()
    elif hasattr(dc, "keys"):
        keys = [k for k in dc.keys()
                if dc.rank_of(*(k if isinstance(k, tuple) else (k,))) == dc.myrank]
    else:
        raise TypeError(f"cannot enumerate tiles of {dc!r}")
    for k in keys:
        key = k if isinstance(k, tuple) else (k,)
        d = dc.data_of(*key)
        if d.newest_copy() is None:
            continue
        host = stage_to_cpu(d)
        if not isinstance(host, np.ndarray):
            raise TypeError(
                f"checkpoint: tile {dc.name}{key} is {host.dtype}, which "
                "numpy (and so the .npz format) cannot hold")
        yield key, host


def _entry(name: str, key: Tuple) -> str:
    # JSON object encoding: round-trips any collection name (even with
    # separator characters) and normalizes numpy scalar keys, whose repr
    # (numpy>=2: ``np.int64(0)``) would not literal_eval back
    norm = [int(x) if isinstance(x, (int, np.integer))
            else float(x) if isinstance(x, (float, np.floating))
            else x for x in key]
    return json.dumps({"c": name, "k": norm})


def _parse_entry(s: str) -> Tuple[str, Tuple]:
    d = json.loads(s)
    return d["c"], tuple(d["k"])


def save(path: str, *collections, rank: Optional[int] = None,
         owned_only: bool = True,
         meta: Optional[Dict[str, Any]] = None) -> str:
    """Persist every local tile of ``collections``; returns the shard
    path. Call at a quiescent point on every rank (same ``path``).

    The shard rank comes from the first *distributed* collection (a
    replicated LocalCollection reports myrank=0 on every rank and must
    not decide the shard name); pass ``rank=`` explicitly when saving
    only replicated collections from multiple ranks."""
    if rank is not None:
        r = rank
    else:
        r = 0
        for dc in collections:
            if getattr(dc, "nodes", 1) > 1:
                r = getattr(dc, "myrank", 0)
                break
    names = [dc.name for dc in collections]
    if len(set(names)) != len(names):
        # entries are keyed by collection name: a duplicate would silently
        # clobber one collection's tiles with the other's
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate collection names in checkpoint: {dupes}")
    arrays: Dict[str, np.ndarray] = {}
    for dc in collections:
        for key, arr in _tile_items(dc, owned_only=owned_only):
            arrays[_entry(dc.name, key)] = arr
    shard = f"{path}.rank{r}.npz"
    os.makedirs(os.path.dirname(os.path.abspath(shard)), exist_ok=True)
    np.savez_compressed(shard, **arrays)
    manifest = {
        "rank": r,
        "collections": names,
        "tiles": len(arrays),
        "meta": meta or {},
    }
    with open(f"{shard}.json", "w") as f:
        json.dump(manifest, f)
    return shard


def shards_of(path: str) -> List[str]:
    d = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    out = []
    for fn in sorted(os.listdir(d)):
        if fn.startswith(base + ".rank") and fn.endswith(".npz"):
            out.append(os.path.join(d, fn))
    return out


def restore(path: str, *collections, all_shards: bool = True,
            owned_only: bool = True, rank: Optional[int] = None) -> int:
    """Load tiles back into matching collections (by name + key).

    Reads every rank shard by default — each rank keeps only the tiles it
    owns under the CURRENT distribution, so restoring under a different
    rank layout (elastic restart) works.  Returns tiles restored locally.

    Replicated mode (``owned_only=False``): every shard holds the same
    keys, so reading all of them would let an arbitrary shard win — pass
    ``rank=`` to read exactly that rank's shard (or point ``path`` at one
    shard with ``all_shards=False``)."""
    by_name = {dc.name: dc for dc in collections}
    restored = 0
    if not owned_only and all_shards:
        if rank is None:
            raise ValueError(
                "restore(owned_only=False) needs rank= (or a single shard "
                "via all_shards=False): with every shard holding the same "
                "replicated keys, reading all would pick one arbitrarily")
        paths = [f"{path}.rank{rank}.npz"]
    else:
        paths = shards_of(path) if all_shards else [path]
    if not paths:
        raise FileNotFoundError(f"no checkpoint shards match {path}.rank*.npz")
    for shard in paths:
        with np.load(shard) as z:
            for entry in z.files:
                name, key = _parse_entry(entry)
                dc = by_name.get(name)
                if dc is None:
                    continue
                if owned_only and dc.rank_of(*key) != dc.myrank:
                    continue
                arr = z[entry]
                d = dc.data_of(*key)
                c = d.get_copy(0)
                if c is None or c.payload is None:
                    d.attach_copy(0, arr.copy())
                else:
                    np.copyto(c.payload, arr)
                d.version_bump(0)
                restored += 1
    return restored


def manifest(path: str) -> List[Dict[str, Any]]:
    """All rank manifests of a checkpoint (inspection helper)."""
    out = []
    for shard in shards_of(path):
        try:
            with open(shard + ".json") as f:
                out.append(json.load(f))
        except OSError:
            out.append({"rank": None, "shard": shard, "error": "no manifest"})
    return out
