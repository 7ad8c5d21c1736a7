"""Registry of every in-repo PTG definition, with lint-sized globals.

The port of :mod:`parsec_tpu.analysis.registry`, with the same names.
``tools lint --all`` and the tests sweep this registry, so a dependency
regression in any shipped graph (ops builders or the ``examples/jdf``
programs) fails fast — the CI analogue of the reference compiling every
bundled ``.jdf`` as part of its build.

Each entry is a thunk returning ``(PTG, constants)``: construction is
lazy and the problem sizes are tiny — the verifier's checks are
size-generic, so NT=4-class instances exercise every guard branch
without enumerating production spaces.  The ``examples/jdf`` files are
read as data.  The entries whose graphs need a layer the port has not
yet (the ring-attention and distributed graphs, ROADMAP A.8) keep their
names and raise ``NotImplementedError`` naming that item when built.  The
array front end's canonical programs lint as generated, the 2-rank
``array.dist`` with its forwarding readers included (lowering a grid
needs no second rank).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_JDF_DIR = os.path.join(_REPO_ROOT, "examples", "jdf")


def _local(name: str, shape=(8, 8)):
    from ..data.collection import LocalCollection

    return LocalCollection(name, shape=shape)


def _tiled(nt: int = 4, nb: int = 2):
    from ..datadist.matrix import TiledMatrix

    return TiledMatrix(nt * nb, nt * nb, nb, nb)


def _ops_cholesky(**kw):
    def build():
        from ..ops.cholesky import cholesky_ptg

        return cholesky_ptg(use_cuda=False, **kw), \
            {"NT": 4, "A": _tiled(4)}
    return build


def _ops_cholesky_dynamic():
    """The dpotrf with device chores only, as the dynamic and pump paths
    run it."""
    from ..ops.cholesky import cholesky_ptg

    return cholesky_ptg(use_cuda=True, use_cpu=False), \
        {"NT": 4, "A": _tiled(4)}


def _ops_lu():
    from ..ops.lu import lu_ptg

    return lu_ptg(use_cuda=False), {"NT": 4, "A": _tiled(4)}


def _ops_qr():
    from ..ops.qr import qr_ptg

    return qr_ptg(use_cuda=False), {"NT": 4, "A": _tiled(4)}


def _ops_stencil():
    from ..ops.stencil import StencilBuffers, stencil_ptg

    bufs = StencilBuffers(np.zeros((4, 4)), 2, 2)
    return stencil_ptg(use_cuda=False, use_cpu=True), \
        {"T": 3, "MT": 2, "NT": 2, "A": bufs}


def _ops_segmented_chol():
    from ..ops.segmented_chol import n_segments, segmented_cholesky_ptg

    return segmented_cholesky_ptg(8, 4, tail=4), \
        {"NT": n_segments(8, 4, tail=4), "A": _local("A")}


def _ops_segmented_lu():
    from ..ops.segmented_chol import n_segments
    from ..ops.segmented_lu import segmented_lu_ptg

    return segmented_lu_ptg(8, 4, tail=4), \
        {"NT": n_segments(8, 4, tail=4), "A": _local("A")}


def _ops_segmented_qr():
    from ..ops.segmented_chol import n_segments
    from ..ops.segmented_qr import segmented_qr_ptg

    return segmented_qr_ptg(8, 4, tail=4), \
        {"NT": n_segments(8, 4, tail=4), "A": _local("A"),
         "R": _local("R")}


def _attn_planes(D: int = 4):
    from ..ops.attention import NEG_BIG, PlaneCollection

    inits = {
        "CM": lambda g, j: np.full((4, 1), NEG_BIG, np.float32),
        "CL": lambda g, j: np.zeros((4, 1), np.float32),
    }
    return {
        name: PlaneCollection(
            name, inits.get(name, lambda g, j: np.zeros((4, D), np.float32)))
        for name in ("Q", "K", "V", "O", "CA", "CM", "CL")
    }


def _ops_attention_flash():
    from ..ops.attention import flash_attention_ptg

    return flash_attention_ptg(causal=True, q_block=4, kv_block=4), \
        {"G": 2, "NQ": 3, "NK": 3, "QB": 4, "KVB": 4, "QOFF": 0,
         "SQ": 12, **_attn_planes()}


def _waiting(what: str, item: str):
    def build():
        raise NotImplementedError(
            f"registry graph {what} needs a layer that is not ported yet "
            f"(ROADMAP {item})")
    return build


def _array(which: str):
    """Array-front-end canonical programs: the lint sweep covers the
    GENERATED graphs (parsec_tpu_torch.array.lower), including the 2-rank
    variant whose forwarding readers only exist on distributed grids."""
    def build():
        from ..array import canonical_program

        prog = canonical_program(which)
        return prog.ptg, prog.constants
    return build


def _jdf(stem: str, consts: Callable[[], Dict]):
    def build():
        from ..dsl.jdf import compile_jdf_file

        jdf = compile_jdf_file(os.path.join(_JDF_DIR, f"{stem}.jdf"))
        merged = dict(jdf.ptg.constants)
        merged.update(consts())
        return jdf.ptg, merged
    return build


GRAPHS: Dict[str, Callable[[], Tuple]] = {
    "ops.cholesky": _ops_cholesky(),
    "ops.cholesky_trtri": _ops_cholesky(use_trtri=True),
    "ops.cholesky_dynamic": _ops_cholesky_dynamic,
    "ops.lu": _ops_lu,
    "ops.qr": _ops_qr,
    "ops.stencil": _ops_stencil,
    "ops.segmented_chol": _ops_segmented_chol,
    "ops.segmented_lu": _ops_segmented_lu,
    "ops.segmented_qr": _ops_segmented_qr,
    "ops.segmented_chol_dist": _waiting("ops.segmented_chol_dist", "A.8"),
    "ops.attention_flash": _ops_attention_flash,
    "ops.attention_ring": _waiting("ops.attention_ring", "A.8"),
    "ops.attention_ring_bcast": _waiting("ops.attention_ring_bcast", "A.8"),
    "array.mixed": _array("mixed"),
    "array.chain": _array("chain"),
    "array.dist": _array("dist"),
}

if os.path.isdir(_JDF_DIR):  # source checkout: lint the example JDFs too
    GRAPHS.update({
        "jdf.chaindata": _jdf("chaindata",
                              lambda: {"NB": 4, "mydata": _local("mydata")}),
        "jdf.cholesky": _jdf("cholesky",
                             lambda: {"NT": 4, "A": _tiled(4)}),
        "jdf.lu": _jdf("lu", lambda: {"NT": 4, "A": _tiled(4)}),
        "jdf.merge_sort": _jdf(
            "merge_sort",
            lambda: {"NT": 4, "H": 2, "dataA": _local("dataA"),
                     "result": _local("result")}),
        "jdf.stencil_1d": _jdf(
            "stencil_1d",
            lambda: {"NT": 3, "ITER": 3, "descA": _local("descA")}),
    })


def names():
    return sorted(GRAPHS)


def build(name: str):
    """Construct the named in-repo graph: ``(PTG, constants)``."""
    try:
        thunk = GRAPHS[name]
    except KeyError:
        raise KeyError(
            f"unknown registry graph {name!r} (known: {names()})") from None
    return thunk()
