"""Communication layer (reference L3): CE vtable, the in-process fabric,
the remote-dep protocol and the four-counter termination detector.

What is not ported yet raises ``NotImplementedError`` naming ROADMAP A.8b
when it is reached: the collectives (``CollManager``, ``CollOp``,
``RedistOp``, ``CollError``), the TCP backend (``TCPComm``,
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
from .inproc import InprocComm, InprocFabric
from .remote_dep import RemoteDepManager, fail_pool_for_context
from .termdet_fourcounter import TermDetFourCounter

#: names of the reference's comm package that wait for ROADMAP A.8b
_A8B = {
    "CollError": "collectives (comm.coll)",
    "CollManager": "collectives (comm.coll)",
    "CollOp": "collectives (comm.coll)",
    "RedistOp": "redistribution (comm.coll)",
    "TCPComm": "the TCP backend (comm.tcp)",
    "endpoint_from_env": "the TCP backend (comm.tcp)",
    "coll": "collectives (comm.coll)",
    "tcp": "the TCP backend (comm.tcp)",
    "launch": "the multi-process launcher (comm.launch)",
}


def __getattr__(name: str):
    what = _A8B.get(name)
    if what is not None:
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP A.8b)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CommEngine",
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
