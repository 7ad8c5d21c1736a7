"""Data collections: user-defined distributed containers.

Reference: ``parsec/data_distribution.c`` +
``include/parsec/data_distribution.h`` — the vtable every distributed
container implements: ``rank_of(key)`` (owner-computes placement),
``vpid_of``, ``data_of(key)`` (lazy local tile materialization),
``data_key`` (canonical key). Examples of hand-written collections:
``examples/Ex04_ChainData.jdf:50-100``.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np

from .data import Data, data_create


class DataCollection:
    """Base distributed-container vtable."""

    _dc_ids = itertools.count()

    def __init__(self, name: str = "dc", *, nodes: int = 1, myrank: int = 0):
        self.name = name
        self.dc_id = next(self._dc_ids)
        self.nodes = nodes
        self.myrank = myrank
        self.default_dtype = np.float64

    # -- vtable -----------------------------------------------------------
    def data_key(self, *key) -> Any:
        """Canonicalize a possibly multi-dim key."""
        return key if len(key) != 1 else key[0]

    def rank_of(self, *key) -> int:
        return 0

    def vpid_of(self, *key) -> int:
        return 0

    def data_of(self, *key) -> Data:
        raise NotImplementedError

    def is_local(self, *key) -> bool:
        return self.rank_of(*key) == self.myrank

    # registration with devices (reference memory_register hooks)
    def register_with(self, context) -> None:
        for dev in getattr(context, "devices", []):
            dev.memory_register(self)


class LocalCollection(DataCollection):
    """Single-rank collection over lazily-created numpy tiles; also the
    building block several tests use (reference ``tests/tests_data.c``)."""

    def __init__(
        self,
        name: str = "local",
        *,
        shape=(1,),
        dtype=np.float64,
        init: Optional[Callable[[Any], np.ndarray]] = None,
        nodes: int = 1,
        myrank: int = 0,
    ):
        super().__init__(name, nodes=nodes, myrank=myrank)
        self.tile_shape = tuple(shape)
        self.default_dtype = np.dtype(dtype)
        self._init = init
        self._store: Dict[Any, Data] = {}
        self._lock = threading.Lock()

    def data_of(self, *key) -> Data:
        k = self.data_key(*key)
        with self._lock:
            d = self._store.get(k)
            if d is None:
                if self._init is not None:
                    payload = np.asarray(self._init(k))
                else:
                    payload = np.zeros(self.tile_shape, self.default_dtype)
                d = data_create(k, self, payload=payload)
                self._store[k] = d
            return d

    def keys(self):
        with self._lock:
            return list(self._store)

    def materialized_keys(self):
        """Keys whose Data exists right now (no lazy creation): the
        checkpoint's replicated-mode enumeration."""
        return self.keys()
