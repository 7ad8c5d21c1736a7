"""Data layer: versioned per-device copies, collections, data repos,
arenas (:mod:`.arena`), datatypes (:mod:`.datatype`) and checkpoints
(:mod:`.checkpoint`).

The reshape layer of :mod:`parsec_tpu.data` is not ported yet (ROADMAP
A.8).
"""

from .data import Coherency, Data, DataCopy, data_create, host_array
from .collection import DataCollection, LocalCollection
from .datarepo import DataRepo
from .arena import Arena, ArenaRecycleError, ByteBudget, BytePool
from .datatype import (Contiguous, Datatype, Vector, type_create_contiguous,
                       type_create_vector, type_of_array)

__all__ = [
    "Coherency",
    "Data",
    "DataCopy",
    "data_create",
    "host_array",
    "DataCollection",
    "LocalCollection",
    "DataRepo",
    "Arena",
    "ArenaRecycleError",
    "ByteBudget",
    "BytePool",
    "Contiguous",
    "Datatype",
    "Vector",
    "type_create_contiguous",
    "type_create_vector",
    "type_of_array",
]
