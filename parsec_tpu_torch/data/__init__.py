"""Data layer: versioned per-device copies, collections, data repos.

Arenas, datatypes, checkpointing and reshape of :mod:`parsec_tpu.data`
are not ported yet (reshape: ROADMAP A.8; the rest: A.9a).
"""

from .data import Coherency, Data, DataCopy, data_create, host_array
from .collection import DataCollection, LocalCollection
from .datarepo import DataRepo

__all__ = [
    "Coherency",
    "Data",
    "DataCopy",
    "data_create",
    "host_array",
    "DataCollection",
    "LocalCollection",
    "DataRepo",
]
