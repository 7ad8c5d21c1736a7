"""Declarative ABI contract for the native engine (``native/src/*.cpp``).

The port's copy of :mod:`parsec_tpu.native.abi`.  ONE table — :data:`SPEC`
— declares every C entry point of the engine library: name, return and
argument types (portable tokens), and the threading contract.  The rest
derives from it:

* :func:`bind` generates the ctypes ``restype``/``argtypes`` bindings
  (:mod:`parsec_tpu_torch.native` calls it at load);
* :func:`required_symbols` is the list the load check keys on: a library
  missing one of them is refused with a readable error;
* :func:`parse_source_prototypes` reads the ``extern "C"`` prototypes the
  sources really define, so a test can hold the spec to them.

A ctypes boundary has no compiler to check it, so this module plays the
header's role.  The engine-verify lint over it (``abi_findings``,
ENG001–ENG006, and the ``PARSEC_TPU_ABI_CHECK`` switch) reports through
the analysis findings layer and is not ported yet (ROADMAP A.9).
"""

from __future__ import annotations

import ctypes
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
SRC_DIR = os.path.join(_REPO, "native", "src")
SOURCES = ["zone.cpp", "graph.cpp", "trace.cpp"]

# ---------------------------------------------------------------------------
# type tokens
# ---------------------------------------------------------------------------

#: Python body trampoline: ``void body(task_id, user_tag, ctx)``
BODY_FN = ctypes.CFUNCTYPE(None, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_void_p)
#: async-capable body: returns 0 = completed synchronously, nonzero =
#: ASYNC (completion arrives later via ``pz_task_done``)
ASYNC_BODY_FN = ctypes.CFUNCTYPE(
    ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p)

#: token -> (ctypes type or None, canonical C spelling).  The C spelling
#: is what the source-prototype reader normalizes to.
TOKENS: Dict[str, Tuple[Any, str]] = {
    "void": (None, "void"),
    "voidp": (ctypes.c_void_p, "void*"),
    "int": (ctypes.c_int, "int"),
    "i32": (ctypes.c_int32, "int32_t"),
    "i64": (ctypes.c_int64, "int64_t"),
    "sizet": (ctypes.c_size_t, "size_t"),
    "charp": (ctypes.c_char_p, "const char*"),
    "i32p": (ctypes.POINTER(ctypes.c_int32), "int32_t*"),
    "i32cp": (ctypes.POINTER(ctypes.c_int32), "const int32_t*"),
    "i64p": (ctypes.POINTER(ctypes.c_int64), "int64_t*"),
    "i64cp": (ctypes.POINTER(ctypes.c_int64), "const int64_t*"),
    "body_fn": (BODY_FN, "BodyFn"),
    "async_body_fn": (ASYNC_BODY_FN, "AsyncBodyFn"),
}

# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------

#: threading contracts:
#:   owner  — only the handle's owning thread (construction/teardown),
#:   caller — any single thread at a time (the Python side's job),
#:   any    — safe from arbitrary threads concurrently (the engine locks)
OWNER, CALLER, ANY = "owner", "caller", "any"


def _e(ret: str, args: Sequence[str], threads: str = CALLER,
       note: str = "") -> Dict[str, Any]:
    for t in (ret, *args):
        if t not in TOKENS:
            raise KeyError(f"unknown ABI type token {t!r}")
    return {"ret": ret, "args": list(args), "threads": threads,
            "note": note}


#: symbol -> declared signature + contract, grouped like the sources.
#: The whole library is bound, the entry points this port does not call
#: yet included: the load check refuses a library that lacks any of them.
SPEC: Dict[str, Dict[str, Any]] = {
    # -- zone allocator (zone.cpp) ------------------------------------
    "pz_zone_new": _e("voidp", ["sizet"], OWNER,
                      "returns NULL on OOM; caller owns, frees via "
                      "pz_zone_destroy"),
    "pz_zone_destroy": _e("void", ["voidp"], OWNER),
    "pz_zone_alloc": _e("i64", ["voidp", "sizet", "sizet"], CALLER,
                        "-1 = fragmented/full"),
    "pz_zone_release": _e("int", ["voidp", "i64"], CALLER,
                          "nonzero = unknown offset"),
    "pz_zone_used": _e("sizet", ["voidp"], CALLER),
    "pz_zone_capacity": _e("sizet", ["voidp"], CALLER),
    "pz_zone_largest_free": _e("i64", ["voidp"], CALLER),
    "pz_zone_num_live": _e("i64", ["voidp"], CALLER),
    # -- graph engine (graph.cpp) -------------------------------------
    "pz_graph_new": _e("voidp", [], OWNER,
                       "caller owns, frees via pz_graph_destroy"),
    "pz_graph_destroy": _e("void", ["voidp"], OWNER,
                           "must not race any other entry point"),
    "pz_graph_add_task": _e("i64", ["voidp", "i32", "i64"]),
    "pz_graph_add_dep": _e("int", ["voidp", "i64", "i64"],
                           note="-1 bad id, 0 pred already ran, 1 edge"),
    "pz_graph_task_commit": _e("void", ["voidp", "i64"]),
    "pz_graph_reset": _e("int", ["voidp"],
                         note="nonzero = tasks still outstanding"),
    "pz_graph_set_policy": _e("void", ["voidp", "i32"]),
    "pz_graph_steals": _e("i64", ["voidp"], ANY),
    "pz_graph_steals_remote": _e("i64", ["voidp"], ANY),
    "pz_graph_set_vpmap": _e("void", ["voidp", "i32cp", "i64"], CALLER,
                             "array copied before return"),
    "pz_graph_seal": _e("void", ["voidp"]),
    "pz_graph_run": _e("i64", ["voidp", "body_fn", "voidp", "i32"], CALLER,
                       "blocks until quiescence; -1 = no quiesce"),
    "pz_graph_run_async": _e("i64", ["voidp", "async_body_fn", "voidp",
                                     "i32"], CALLER,
                             "blocks until every ASYNC completion lands"),
    "pz_task_done": _e("int", ["voidp", "i64"], ANY,
                       "0 ok, -1 bad id, -2 already completed (atomic "
                       "double-complete guard)"),
    "pz_graph_fail": _e("void", ["voidp"], ANY),
    "pz_graph_run_noop": _e("i64", ["voidp", "i32"]),
    "pz_graph_executed": _e("i64", ["voidp"], ANY),
    "pz_graph_double_completes": _e("i64", ["voidp"], ANY),
    "pz_graph_order": _e("i64", ["voidp", "i64p", "i64"], CALLER,
                         "caller-allocated out buffer; -1 = cycle"),
    # -- zero-interpreter lifecycle (pump mode, graph.cpp) ------------
    "pz_graph_sched_config": _e("void", ["voidp", "i32", "i32", "i64"],
                                CALLER, "before tasks commit"),
    "pz_graph_task_tenant": _e("void", ["voidp", "i64", "i32"]),
    "pz_graph_tenant_weight": _e("void", ["voidp", "i32", "i32"]),
    "pz_graph_pop_batch": _e("i64", ["voidp", "i64p", "i64"], ANY,
                             "caller-allocated out buffer"),
    "pz_graph_done_batch": _e("i64", ["voidp", "i64cp", "i64"], ANY,
                              "returns #accepted; double completions "
                              "refused per task"),
    "pz_graph_quiesced": _e("i32", ["voidp"], ANY),
    "pz_graph_sched_pending": _e("i64", ["voidp"], ANY),
    "pz_graph_events_enable": _e("void", ["voidp", "i32"]),
    "pz_graph_events_drain": _e("i64", ["voidp", "i32p", "i64p", "i64p",
                                        "i64"], ANY,
                                "three caller-allocated parallel arrays"),
    # -- standalone ready queue (graph.cpp SchedQ) --------------------
    "pz_rq_new": _e("voidp", ["i32", "i32", "i64"], OWNER),
    "pz_rq_destroy": _e("void", ["voidp"], OWNER),
    "pz_rq_tenant_weight": _e("void", ["voidp", "i32", "i32"]),
    "pz_rq_push": _e("void", ["voidp", "i64", "i64", "i32", "i64"]),
    "pz_rq_pop": _e("i64", ["voidp"], note="-1 = empty"),
    "pz_rq_count": _e("i64", ["voidp"]),
    "pz_rq_clear": _e("void", ["voidp"]),
    # -- binary tracer (trace.cpp) ------------------------------------
    "pt_tracer_new": _e("voidp", [], OWNER),
    "pt_tracer_destroy": _e("void", ["voidp"], OWNER),
    "pt_stream_new": _e("voidp", ["voidp"], ANY,
                        "one stream per thread; logged to only by its "
                        "owning thread"),
    "pt_stream_id": _e("i32", ["voidp"], ANY),
    "pt_log": _e("void", ["voidp", "voidp", "i32", "i32", "i64", "i64"],
                 ANY, "stream-owning thread only; dump may run "
                      "concurrently"),
    "pt_total_events": _e("i64", ["voidp"], ANY),
    "pt_dump": _e("i64", ["voidp", "charp"], ANY,
                  "sees a consistent committed prefix of each stream"),
}


def required_symbols() -> List[str]:
    """Every C entry point the bindings require (derived from the spec)."""
    return list(SPEC)


def bind(lib: ctypes.CDLL) -> None:
    """Generate the ctypes bindings from :data:`SPEC` (restype +
    argtypes for every declared entry point)."""
    for name, ent in SPEC.items():
        fn = getattr(lib, name)
        fn.restype = TOKENS[ent["ret"]][0]
        fn.argtypes = [TOKENS[t][0] for t in ent["args"]]


def spec_signature(name: str) -> Tuple[str, List[str]]:
    """``(return type, [argument types])`` of one spec entry, in the
    canonical C spelling :func:`parse_source_prototypes` produces."""
    ent = SPEC[name]
    return (TOKENS[ent["ret"]][1], [TOKENS[t][1] for t in ent["args"]])


# ---------------------------------------------------------------------------
# source-prototype reader
# ---------------------------------------------------------------------------

_PROTO_RE = re.compile(
    r"^[ \t]*((?:[A-Za-z_][A-Za-z0-9_]*[ \t*]+)+?)"   # return type
    r"(p[zt]_[a-z0-9_]+)[ \t]*"                        # exported name
    r"\(([^)]*)\)[ \t]*\{",                            # args, open brace
    re.MULTILINE)


def _norm_ctype(s: str) -> str:
    """Canonical C type spelling: single spaces, star glued to the type
    (``const int64_t *`` -> ``const int64_t*``)."""
    s = " ".join(s.split())
    s = re.sub(r"\s*\*\s*", "*", s)
    return s.strip()


def _parse_param(p: str) -> str:
    """Type of one declared parameter (drop the identifier)."""
    p = p.strip()
    if p in ("", "void"):
        return ""
    # the identifier is the trailing word (the sources never declare
    # function-pointer parameters inline — typedef names only)
    p = re.sub(r"\b[A-Za-z_][A-Za-z0-9_]*\s*$", "", p)
    return _norm_ctype(p)


def parse_source_prototypes(
        src_dir: Optional[str] = None) -> Dict[str, Tuple[str, List[str]]]:
    """``extern "C"`` prototypes actually defined in the engine sources:
    name -> (return type, [arg types]), canonically spelled."""
    out: Dict[str, Tuple[str, List[str]]] = {}
    d = src_dir or SRC_DIR
    for src in SOURCES:
        path = os.path.join(d, src)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            body = f.read()
        for m in _PROTO_RE.finditer(body):
            ret, name, args = m.group(1), m.group(2), m.group(3)
            # rejoin multi-line argument lists before splitting
            args = " ".join(args.split())
            params = [_parse_param(p) for p in args.split(",")] \
                if args.strip() else []
            params = [p for p in params if p]
            out[name] = (_norm_ctype(ret), params)
    return out
