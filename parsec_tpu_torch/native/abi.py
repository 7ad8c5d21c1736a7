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
  sources really define, so a test can hold the spec to them;
* :func:`abi_findings` is the engine-verify lint over all three — the
  spec, the sources' prototypes and the symbols the built library
  exports (:func:`elf_exported_functions`), plus the trace record layout
  (:func:`parse_source_record_layout`) — reporting ENG001–ENG006
  findings (``tools engine-verify``, ``PARSEC_TPU_ABI_CHECK``).

A ctypes boundary has no compiler to check it, so this module plays the
header's role.
"""

from __future__ import annotations

import ctypes
import os
import re
import struct as _struct
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


#: the trace record wire layout (trace.cpp ``struct Record``).  Field
#: order, widths and total size are an on-disk contract: drift corrupts
#: every trace silently.
TRACE_RECORD: List[Tuple[str, str]] = [
    ("stream_id", "i32"), ("keyword_id", "i32"), ("phase", "i32"),
    ("reserved", "i32"), ("ts_ns", "i64"), ("event_id", "i64"),
    ("info", "i64"),
]
TRACE_RECORD_SIZE = 40


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


def parse_source_record_layout(
        src_dir: Optional[str] = None) -> Optional[List[Tuple[str, str]]]:
    """The trace.cpp ``struct Record`` field list as (name, token), or
    None when the struct cannot be located."""
    path = os.path.join(src_dir or SRC_DIR, "trace.cpp")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        body = f.read()
    m = re.search(r"struct\s+Record\s*\{([^}]*)\}", body)
    if m is None:
        return None
    tok_of = {"int32_t": "i32", "int64_t": "i64"}
    fields: List[Tuple[str, str]] = []
    for fm in re.finditer(r"(int32_t|int64_t)\s+([A-Za-z_][A-Za-z0-9_]*)\s*;",
                          m.group(1)):
        fields.append((fm.group(2), tok_of[fm.group(1)]))
    return fields or None


# ---------------------------------------------------------------------------
# ELF dynamic-symbol reader (which pz_*/pt_* the .so really exports)
# ---------------------------------------------------------------------------

def elf_exported_functions(path: str) -> List[str]:
    """Globally-defined function symbols of an ELF64 shared object,
    read with a pure-Python ``.dynsym`` walk (no nm dependency).
    Raises ValueError on a non-ELF64-LE file."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"\x7fELF":
        raise ValueError(f"{path}: not an ELF file")
    if data[4] != 2 or data[5] != 1:
        raise ValueError(f"{path}: not a little-endian ELF64 object")
    e_shoff, = _struct.unpack_from("<Q", data, 0x28)
    e_shentsize, e_shnum = _struct.unpack_from("<HH", data, 0x3A)
    dynsym = None
    sections = []
    for i in range(e_shnum):
        off = e_shoff + i * e_shentsize
        (sh_name, sh_type, sh_flags, sh_addr, sh_offset, sh_size,
         sh_link, sh_info, sh_align, sh_entsize) = _struct.unpack_from(
            "<IIQQQQIIQQ", data, off)
        sections.append((sh_type, sh_offset, sh_size, sh_link, sh_entsize))
        if sh_type == 11:  # SHT_DYNSYM
            dynsym = sections[-1]
    if dynsym is None:
        raise ValueError(f"{path}: no .dynsym section")
    _, sym_off, sym_size, strtab_idx, sym_ent = dynsym
    sym_ent = sym_ent or 24
    _, str_off, str_size, _, _ = sections[strtab_idx]
    strings = data[str_off:str_off + str_size]
    out: List[str] = []
    for off in range(sym_off, sym_off + sym_size, sym_ent):
        st_name, st_info, _st_other, st_shndx = _struct.unpack_from(
            "<IBBH", data, off)
        if st_shndx == 0:          # SHN_UNDEF: imported, not exported
            continue
        if (st_info & 0xF) != 2:   # STT_FUNC
            continue
        if (st_info >> 4) not in (1, 2):  # GLOBAL | WEAK
            continue
        end = strings.index(b"\0", st_name)
        out.append(strings[st_name:end].decode())
    return out


# ---------------------------------------------------------------------------
# the lint
# ---------------------------------------------------------------------------

def abi_findings(lib_path: Optional[str] = None,
                 src_dir: Optional[str] = None) -> List[Any]:
    """Cross-check the declared ABI against reality.  Three legs:

    * spec vs the engine sources' prototypes — ENG003 signature drift,
      ENG004 spec entry with no source definition, ENG002 source export
      the spec does not declare;
    * spec vs the built ``.so`` (when ``lib_path`` names one) — ENG001
      declared symbol missing from the library, ENG002 undeclared
      export, ENG005 library older than its sources (stale build);
    * trace record layout vs trace.cpp, and the ``.pbt`` reader's record
      dtype (:data:`parsec_tpu_torch.profiling.binary._RECORD_DTYPE`) vs
      the spec — ENG006.
    """
    from ..analysis.findings import Finding

    out: List[Any] = []
    protos = parse_source_prototypes(src_dir)
    for name in SPEC:
        if name not in protos:
            out.append(Finding(
                "ENG004", f"ABI spec declares {name} but the engine "
                          "sources define no such extern \"C\" symbol",
                task=name))
            continue
        want_ret, want_args = spec_signature(name)
        got_ret, got_args = protos[name]
        if (want_ret, want_args) != (got_ret, got_args):
            out.append(Finding(
                "ENG003",
                f"signature drift for {name}: spec declares "
                f"{want_ret}({', '.join(want_args)}) but the source "
                f"defines {got_ret}({', '.join(got_args)})",
                task=name))
    for name in protos:
        if name not in SPEC:
            out.append(Finding(
                "ENG002", f"the engine sources export {name} with no ABI "
                          "spec entry (undeclared entry point: ctypes "
                          "callers would bind it blind)",
                task=name))
    if lib_path and os.path.exists(lib_path):
        try:
            exported = set(elf_exported_functions(lib_path))
        except (ValueError, OSError, IndexError) as e:
            out.append(Finding(
                "ENG001", f"cannot read exported symbols of {lib_path}: "
                          f"{e}"))
        else:
            for name in SPEC:
                if name not in exported:
                    out.append(Finding(
                        "ENG001",
                        f"{name} is declared in the ABI spec but not "
                        f"exported by {os.path.basename(lib_path)} "
                        "(stale build, or the definition was dropped)",
                        task=name))
            for name in sorted(exported):
                if name.startswith(("pz_", "pt_")) and name not in SPEC:
                    out.append(Finding(
                        "ENG002",
                        f"{os.path.basename(lib_path)} exports {name} "
                        "with no ABI spec entry (undeclared export)",
                        task=name))
        try:
            srcs = [os.path.join(src_dir or SRC_DIR, s) for s in SOURCES]
            newest = max(os.path.getmtime(p) for p in srcs
                         if os.path.exists(p))
            if os.path.getmtime(lib_path) < newest:
                out.append(Finding(
                    "ENG005",
                    f"{os.path.basename(lib_path)} is older than the "
                    "engine sources (stale build: delete it, or touch the "
                    "sources, to force a rebuild)"))
        except (OSError, ValueError):
            pass
    out.extend(_record_layout_findings(src_dir))
    return out


def _record_layout_findings(src_dir: Optional[str] = None,
                            record_dtype=None) -> List[Any]:
    """ENG006: the spec's trace record against its own size, against
    trace.cpp's ``struct Record`` and against the ``.pbt`` reader's
    record dtype (``record_dtype``, default the reader's own)."""
    from ..analysis.findings import Finding

    out: List[Any] = []
    width = {"i32": 4, "i64": 8}
    if sum(width[t] for _, t in TRACE_RECORD) != TRACE_RECORD_SIZE:
        out.append(Finding(
            "ENG006", "ABI spec trace-record fields do not sum to "
                      f"TRACE_RECORD_SIZE={TRACE_RECORD_SIZE}"))
    src = parse_source_record_layout(src_dir)
    if src is not None and src != TRACE_RECORD:
        out.append(Finding(
            "ENG006",
            f"trace record layout drift: spec declares {TRACE_RECORD} "
            f"but trace.cpp defines {src} (every .pbt reader depends on "
            "this byte layout)"))
    if record_dtype is None:
        from ..profiling.binary import _RECORD_DTYPE as record_dtype
    py = [(n, "i32" if record_dtype[n].itemsize == 4 else "i64")
          for n in record_dtype.names]
    # the reader's field names are its own (shorter) vocabulary; the
    # contract is positional: field count, per-field width, total size
    if ([t for _, t in py] != [t for _, t in TRACE_RECORD]
            or record_dtype.itemsize != TRACE_RECORD_SIZE):
        out.append(Finding(
            "ENG006",
            f"trace record layout drift: profiling.binary reads "
            f"{record_dtype.itemsize}B records {py} but the ABI spec "
            f"declares {TRACE_RECORD_SIZE}B {TRACE_RECORD}"))
    return out
