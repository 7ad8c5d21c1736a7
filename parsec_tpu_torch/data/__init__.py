"""Data layer: versioned per-device copies, collections, data repos,
arenas (:mod:`.arena`), datatypes (:mod:`.datatype`), checkpoints
(:mod:`.checkpoint`) and the reshape engine (:mod:`.reshape`).
"""

from .data import Coherency, Data, DataCopy, data_create, host_array
from .collection import DataCollection, LocalCollection
from .datarepo import DataRepo
from .arena import Arena, ArenaRecycleError, ByteBudget, BytePool
from .reshape import (DataCopyFuture, ReshapeSpec, get_copy_reshape,
                      materialize)
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
    "DataCopyFuture",
    "Datatype",
    "ReshapeSpec",
    "get_copy_reshape",
    "materialize",
    "Vector",
    "type_create_contiguous",
    "type_create_vector",
    "type_of_array",
]
