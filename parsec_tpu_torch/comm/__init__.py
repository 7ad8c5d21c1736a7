"""Communication layer (reference L3): CE vtable, the in-process fabric,
the TCP backend (:mod:`.tcp`, one rank a process) and its launcher
(:func:`.launch.launch`, ``python -m parsec_tpu_torch.comm.launch -n 4
app.py``), the remote-dep protocol, the four-counter termination detector
and the runtime collectives (:mod:`.coll`).
"""

from .engine import (
    CommEngine,
    MAX_AM_TAGS,
    TAG_ACTIVATE,
    TAG_CTL,
    TAG_DTD,
    TAG_GET,
    TAG_PUT,
    TAG_TERMDET,
)
from .coll import CollError, CollManager, CollOp, RedistOp
from .inproc import InprocComm, InprocFabric
from .remote_dep import RemoteDepManager, fail_pool_for_context
from .termdet_fourcounter import TermDetFourCounter
from . import tcp
from .tcp import TCPComm, endpoint_from_env
from .launch import launch


__all__ = [
    "CollError",
    "CollManager",
    "CollOp",
    "CommEngine",
    "RedistOp",
    "InprocComm",
    "InprocFabric",
    "RemoteDepManager",
    "TCPComm",
    "TermDetFourCounter",
    "endpoint_from_env",
    "launch",
    "tcp",
    "fail_pool_for_context",
    "TAG_ACTIVATE",
    "TAG_GET",
    "TAG_PUT",
    "TAG_TERMDET",
    "TAG_CTL",
    "TAG_DTD",
    "MAX_AM_TAGS",
]
