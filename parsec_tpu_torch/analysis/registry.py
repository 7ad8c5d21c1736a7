"""Registry of every in-repo PTG definition, with lint-sized globals.

The port of :mod:`parsec_tpu.analysis.registry`, with the same names.
``tools lint --all`` and the tests sweep this registry, so a dependency
regression in any shipped graph (ops builders or the ``.jdf`` programs
of :mod:`parsec_tpu_torch.examples`) fails fast — the CI analogue of the
reference compiling every bundled ``.jdf`` as part of its build.

Each entry is a thunk returning ``(PTG, constants)``: construction is
lazy and the problem sizes are tiny — the verifier's checks are
size-generic, so NT=4-class instances exercise every guard branch
without enumerating production spaces.  The ``.jdf`` files ship with the
package and are read as data.  The
array front end's canonical programs lint as generated, the 2-rank
``array.dist`` with its forwarding readers included (lowering a grid
needs no second rank).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import numpy as np

_JDF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "jdf")


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


def _attn_planes(G: int, N: int, D: int = 4, carries: bool = True):
    """Q, K, V and O planes of 4-row blocks, and with ``carries`` the ring
    graphs' carry collections ``CA``/``CM``/``CL``."""
    from ..ops.attention import NEG_BIG, PlaneCollection

    keys = [(g, j) for g in range(G) for j in range(N)]
    inits = {
        "CM": lambda g, j: np.full((4, 1), NEG_BIG, np.float32),
        "CL": lambda g, j: np.zeros((4, 1), np.float32),
    }
    names = ("Q", "K", "V", "O") + (("CA", "CM", "CL") if carries else ())
    return {
        name: PlaneCollection(
            name, inits.get(name, lambda g, j: np.zeros((4, D), np.float32)),
            keys=keys)
        for name in names
    }


def _ops_attention_flash():
    from ..ops.attention import _carry_tile_types, flash_attention_ptg

    # the flash graph's carries are task-made: tile types, no collections
    return flash_attention_ptg(causal=True, q_block=4, kv_block=4), \
        {"G": 2, "NQ": 3, "NK": 3, "QB": 4, "KVB": 4, "QOFF": 0,
         "SQ": 12, **_attn_planes(2, 3, carries=False), **_carry_tile_types(4, [4] * 3)}


def _ops_attention_ring(variant: str):
    def build():
        from ..ops.attention import ring_attention_ptg

        return ring_attention_ptg(causal=(variant == "ring"), q_block=4,
                                  kv_block=4, variant=variant), \
            {"G": 2, "R": 3, **_attn_planes(2, 3)}
    return build


def _ops_segmented_chol_dist():
    from ..ops.segmented_chol_dist import dist_segmented_cholesky_ptg

    return dist_segmented_cholesky_ptg(8, 4), \
        {"NT": 2, "C": _local("C"), "TILE_SHAPE": (8, 4)}


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
    "ops.segmented_chol_dist": _ops_segmented_chol_dist,
    "ops.attention_flash": _ops_attention_flash,
    "ops.attention_ring": _ops_attention_ring("ring"),
    "ops.attention_ring_bcast": _ops_attention_ring("bcast"),
    "array.mixed": _array("mixed"),
    "array.chain": _array("chain"),
    "array.dist": _array("dist"),
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
}


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
