"""Communication layer (reference L3): CE vtable, the in-process fabric,
the remote-dep protocol, the four-counter termination detector and the
runtime collectives (:mod:`.coll`).

What is not ported yet raises ``NotImplementedError`` naming ROADMAP A.8b
part 2 when it is reached: the TCP backend (``TCPComm``,
``endpoint_from_env``) and the multi-process launcher (``launch``).
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

#: names of the reference's comm package that wait for ROADMAP A.8b part 2
_A8B = {
    "TCPComm": "the TCP backend (comm.tcp)",
    "endpoint_from_env": "the TCP backend (comm.tcp)",
    "tcp": "the TCP backend (comm.tcp)",
    "launch": "the multi-process launcher (comm.launch)",
}


def __getattr__(name: str):
    what = _A8B.get(name)
    if what is not None:
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP A.8b part 2)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CollError",
    "CollManager",
    "CollOp",
    "CommEngine",
    "RedistOp",
    "InprocComm",
    "InprocFabric",
    "RemoteDepManager",
    "TermDetFourCounter",
    "fail_pool_for_context",
    "TAG_ACTIVATE",
    "TAG_GET",
    "TAG_PUT",
    "TAG_TERMDET",
    "TAG_CTL",
    "TAG_DTD",
    "MAX_AM_TAGS",
]
