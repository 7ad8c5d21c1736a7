"""Lowering: an array-expression DAG → ONE lint-clean PTG taskpool.

The port of :mod:`parsec_tpu.array.lower`: the generated classes,
parameter ranges, flows and dep strings are the reference's letter for
letter (the synthesis is pure host string work).  This is the
graph-synthesis layer of the array front-end: every node of
the reachable expression graph becomes one or more generated task
classes (named ``arr_*`` — the critpath ``per_label`` rollup groups them
under ``array``), and every cross-op producer→consumer edge becomes an
ordinary **flow dependency** — intermediate results travel as flow data
through per-class repos, never materialized into a collection and
reloaded between ops.  The generated graphs satisfy JDF reciprocity
(``PTG.verify`` clean), run through the native pump (``run_native``)
and the whole-DAG CUDA graph (``GraphExecutor``, whose program cache keys
on the module-level bodies' content fingerprints), and are eligible for
supertask fusion (elementwise chains are exactly the PTG060 fusible-chain
shape).

Synthesis protocol (the two sides of JDF reciprocity, discovered one at
a time):

* a producer node exposes ``ref(i, j, rel)`` — guarded dependency
  targets for its output tile ``(i, j)`` (``rel`` is the consumer's
  static knowledge of the index relation: ``eq``/``gt``/``any``; a
  triangular producer uses it to drop impossible branches, with the
  node's zero collection as the structural-zero fallback);
* a consumer registers one ``mirror`` function per read role, mapping a
  producer tile ``(i, j)`` to the consumer instances that read it; the
  producer appends the returned edges to its final-writer classes
  (``PTGTaskClass.add_dep``), composing its own writer guard.

Collections referenced by memory must be owner-local: a read of a
source tile that is not placement-aligned with the reading task's
affinity routes through a generated forwarding **reader** class at the
owner (the ``attn_kvsrc`` idiom) whose ranged output deps become the
runtime's activation broadcast tree.  Single-rank programs and
replicated sources skip the readers entirely.

In-place discipline: the Cholesky classes reuse the in-place
:mod:`parsec_tpu_torch.ops.tiles` bodies, so their entry tiles must be
private — a leaf source, a materialized node, a multiply-consumed
producer, or a producer whose output tiles have internal readers gets a
lower-triangular private-copy class (``arr_cp*``) in front; a
single-consumer elementwise/matmul/transpose producer feeds the
factorization directly (its deposited tiles are written exactly once
and read by nobody else, so the factorization may scribble on them).

Writable flows source from the node's OWN result-collection tile (exact
per-tile shapes, ragged tails included): CPU bodies mutate in place —
which is what the native executor requires — device bodies stay
functional, and the final write-back aliases its home tile into a no-op
(on the card the flow's device copy IS the home tile's, resident until
eviction or detach writes it home).

A p x q grid lowers (its readers included), verifies, and runs SPMD
(``taskpool(ctx)``/``run(ctx)`` on each rank of a multi-rank context);
``run_native`` of a multi-rank program raises ``NotImplementedError``
naming ROADMAP A.8b part 2 (the distributed native executor).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.lifecycle import AccessMode
from ..dsl.ptg import PTG, PTGTaskClass
from ..ops import tiles
from . import kernels
from .expr import DistArray, Node

IN = AccessMode.IN
INOUT = AccessMode.INOUT

__all__ = ["lower", "ArrayProgram", "canonical_program", "counters"]


# ---------------------------------------------------------------------------
# stats (PARSEC::ARRAY::* SDE gauges read these; OPERATIONS.md)
# ---------------------------------------------------------------------------

_stats_lock = threading.Lock()
_stats = {"programs_lowered": 0, "classes_generated": 0,
          "taskpools_built": 0}


def counters() -> Dict[str, int]:
    """Monotonic process-wide synthesis counters (``programs_lowered``,
    ``classes_generated``, ``taskpools_built``) — exported as the
    ``PARSEC::ARRAY::*`` SDE gauges."""
    with _stats_lock:
        return dict(_stats)


def _count(key: str, n: int = 1) -> None:
    with _stats_lock:
        _stats[key] += n


# ---------------------------------------------------------------------------
# dep-string assembly
# ---------------------------------------------------------------------------

def _g(*parts: Optional[str]) -> Optional[str]:
    ps = [p for p in parts if p]
    return " && ".join(ps) if ps else None


def _in(guard: Optional[str], target: str) -> str:
    return f"<- ({guard}) ? {target}" if guard else f"<- {target}"


def _out(guard: Optional[str], target: str) -> str:
    return f"-> ({guard}) ? {target}" if guard else f"-> {target}"


def _chain_in(refs: List[Tuple[Optional[str], str]], else_target: str,
              guard: str, neg: str) -> List[str]:
    """Input deps for a chain-entry flow: under ``guard`` the value comes
    from the (possibly guarded) source refs, otherwise from
    ``else_target`` (the chain predecessor)."""
    if len(refs) == 1 and refs[0][0] is None:
        return [f"<- ({guard}) ? {refs[0][1]} : {else_target}"]
    deps = [_in(_g(guard, g), t) for (g, t) in refs]
    deps.append(f"<- ({neg}) ? {else_target}")
    return deps


# mirror functions map a producer tile (i, j) to consumer edges:
# fn(i_expr, j_expr, rel) -> [(guard, "FLOW class(args)")]
MirrorFn = Callable[[str, str, str], List[Tuple[Optional[str], str]]]


class _Source:
    """Resolved read source: dependency targets + mirror registration."""

    def ref(self, i: str, j: str, rel: str = "any"
            ) -> List[Tuple[Optional[str], str]]:
        raise NotImplementedError

    def mirror(self, fn: MirrorFn) -> None:
        raise NotImplementedError


class _MemSource(_Source):
    """Owner-local collection reference — no reciprocity needed."""

    def __init__(self, cname: str):
        self.cname = cname

    def ref(self, i, j, rel="any"):
        return [(None, f"{self.cname}({i}, {j})")]

    def mirror(self, fn):
        pass


class _Reader(_Source):
    """Forwarding task at the owner of a source tile: reads the tile as
    an owner-local memory reference and fans it out to the (possibly
    remote) consumers — the ranged output deps ride the activation
    broadcast tree (the ``attn_kvsrc`` idiom)."""

    def __init__(self, lw: "_Lowerer", cname: str, node: Node, idx: int,
                 region: str):
        self.cls_name = f"arr_ld{'l' if region == 'lower' else 'f'}{idx}"
        pc = lw.ptg.task_class(
            self.cls_name, i=f"0 .. {node.mt - 1}",
            j=("0 .. i" if region == "lower" else f"0 .. {node.nt - 1}"))
        pc.affinity(f"{cname}(i, j)")
        pc.priority("1000")  # ship source tiles before compute starts
        pc.flow("X", IN, f"<- {cname}(i, j)")
        pc.body(cpu=kernels.forward_cpu)
        self.pc = pc

    def ref(self, i, j, rel="any"):
        return [(None, f"X {self.cls_name}({i}, {j})")]

    def mirror(self, fn):
        for (g, t) in fn("i", "j", "any"):
            self.pc.add_dep("X", _out(g, t))


# ---------------------------------------------------------------------------
# per-node lowerings
# ---------------------------------------------------------------------------

class _LowBase(_Source):
    #: True when every externally-visible output tile is a private
    #: datum (the node's own result tile, written once) with no
    #: *internal* readers after the final write — a sole consumer may
    #: mutate it in place (the Cholesky entry optimization)
    private_output = False

    def __init__(self, lw: "_Lowerer", node: Node, idx: int):
        self.lw = lw
        self.node = node
        self.idx = idx
        #: (task class, flow, i_expr, j_expr, rel, guard) per final writer
        self.final_writers: List[Tuple] = []
        self.build()

    def build(self) -> None:
        raise NotImplementedError

    def mirror(self, fn: MirrorFn) -> None:
        for (pc, flow, ie, je, rel, guard) in self.final_writers:
            for (g, t) in fn(ie, je, rel):
                pc.add_dep(flow, _out(_g(guard, g), t))

    def result_coll(self):
        return self.lw.constants[f"D{self.idx}"]

    # -- shared helpers ---------------------------------------------------
    @property
    def D(self) -> str:
        return f"D{self.idx}"

    def make_result_coll(self) -> None:
        n = self.node
        self.lw.constants[self.D] = n.dist.build(
            n.shape[0], n.shape[1], n.mb, n.nb, dtype=n.dtype,
            name=self.D, myrank=self.lw.myrank)

    def in_flow(self, pc: PTGTaskClass, name: str,
                refs: List[Tuple[Optional[str], str]]) -> None:
        pc.flow(name, IN, *[_in(g, t) for (g, t) in refs])


class _LowLeaf(_LowBase):
    """A collection-backed source (leaf or previously computed node)."""

    def build(self):
        self.cname = f"A{self.idx}"
        self.lw.constants[self.cname] = self.node.coll
        self._readers: Dict[str, _Reader] = {}

    def result_coll(self):
        return self.node.coll

    def resolve(self, region: str, aligned: bool) -> _Source:
        if (self.lw.nranks == 1 or aligned
                or getattr(self.node.coll, "replicated", False)):
            return _MemSource(self.cname)
        r = self._readers.get(region)
        if r is None:
            r = self._readers[region] = _Reader(
                self.lw, self.cname, self.node, self.idx, region)
        return r

    def ref(self, i, j, rel="any"):  # pragma: no cover - via resolve()
        return [(None, f"{self.cname}({i}, {j})")]


class _LowEw(_LowBase):
    """Elementwise add/sub/mul/scale, same-tiling redistribute (copy)."""

    private_output = True

    BODIES = {
        "add": (kernels.add_cpu, kernels.add_cuda),
        "sub": (kernels.sub_cpu, kernels.sub_cuda),
        "mul": (kernels.mul_cpu, kernels.mul_cuda),
        "scale": (kernels.scale_cpu, kernels.scale_cuda),
        "redist": (kernels.copy_cpu, kernels.copy_cuda),
    }
    NAMES = {"add": "ew", "sub": "ew", "mul": "ew", "scale": "sc",
             "redist": "rd"}

    def build(self):
        lw, node, idx = self.lw, self.node, self.idx
        self.make_result_coll()
        name = f"arr_{self.NAMES[node.kind]}{idx}"
        self.cls_name = name
        pc = lw.ptg.task_class(name, i=f"0 .. {node.mt - 1}",
                               j=f"0 .. {node.nt - 1}")
        pc.affinity(f"{self.D}(i, j)")
        srcs = []
        flows = ["A", "B"][: len(node.inputs)]
        for fname, inp in zip(flows, node.inputs):
            aligned = (inp.dist.same_placement(node.dist)
                       and (inp.mb, inp.nb) == (node.mb, node.nb))
            s = lw.source(inp, aligned=aligned)
            self.in_flow(pc, fname, s.ref("i", "j", "any"))
            srcs.append((fname, s))
        # the writable flow sources from the node's OWN result tile
        # (exact per-tile shape, in-place CPU bodies, native-exec safe);
        # the write-back aliases its home and is a no-op commit
        pc.flow("O", INOUT, f"<- {self.D}(i, j)", f"-> {self.D}(i, j)")
        if node.kind == "scale":
            pc.define("alpha", repr(float(node.alpha)))
        cpu, cuda = self.BODIES[node.kind]
        pc.body(**lw.bodies(cpu, cuda))
        for fname, s in srcs:
            s.mirror(lambda p, q, rel, _f=fname:
                     [(None, f"{_f} {name}({p}, {q})")])
        self.final_writers = [(pc, "O", "i", "j", "any", None)]

    def ref(self, i, j, rel="any"):
        return [(None, f"O {self.cls_name}({i}, {j})")]


class _LowTranspose(_LowBase):
    private_output = True

    def build(self):
        lw, node, idx = self.lw, self.node, self.idx
        self.make_result_coll()
        name = f"arr_tr{idx}"
        self.cls_name = name
        pc = lw.ptg.task_class(name, i=f"0 .. {node.mt - 1}",
                               j=f"0 .. {node.nt - 1}")
        pc.affinity(f"{self.D}(i, j)")
        s = lw.source(node.inputs[0])
        self.in_flow(pc, "A", s.ref("j", "i", "any"))
        pc.flow("O", INOUT, f"<- {self.D}(i, j)", f"-> {self.D}(i, j)")
        pc.body(**lw.bodies(kernels.transpose_cpu, kernels.transpose_cuda))
        s.mirror(lambda p, q, rel: [(None, f"A {name}({q}, {p})")])
        self.final_writers = [(pc, "O", "i", "j", "any", None)]

    def ref(self, i, j, rel="any"):
        return [(None, f"O {self.cls_name}({i}, {j})")]


class _LowMatmul(_LowBase):
    private_output = True

    def build(self):
        lw, node, idx = self.lw, self.node, self.idx
        a, b = node.inputs
        kt, mt, nt = a.nt, node.mt, node.nt
        self.kt = kt
        self.make_result_coll()
        sa, sb = lw.source(a), lw.source(b)
        mi = lw.ptg.task_class(f"arr_mi{idx}", i=f"0 .. {mt - 1}",
                               j=f"0 .. {nt - 1}")
        mi.affinity(f"{self.D}(i, j)")
        mi.priority(f"{kt} * 10")
        self.in_flow(mi, "a", sa.ref("i", "0", "any"))
        self.in_flow(mi, "b", sb.ref("0", "j", "any"))
        outs = ([f"-> c arr_mm{idx}(1, i, j)"] if kt > 1
                else [f"-> {self.D}(i, j)"])
        mi.flow("c", INOUT, f"<- {self.D}(i, j)", *outs)
        mi.body(**lw.bodies(kernels.mm_init_cpu, kernels.mm_init_cuda))
        if kt > 1:
            mm = lw.ptg.task_class(f"arr_mm{idx}", k=f"1 .. {kt - 1}",
                                   i=f"0 .. {mt - 1}", j=f"0 .. {nt - 1}")
            mm.affinity(f"{self.D}(i, j)")
            mm.priority(f"({kt} - k) * 10")
            self.in_flow(mm, "a", sa.ref("i", "k", "any"))
            self.in_flow(mm, "b", sb.ref("k", "j", "any"))
            couts = [f"-> (k < {kt - 1}) ? c arr_mm{idx}(k+1, i, j)",
                     f"-> (k == {kt - 1}) ? {self.D}(i, j)"]
            mm.flow("c", INOUT,
                    f"<- (k == 1) ? c arr_mi{idx}(i, j) "
                    f": c arr_mm{idx}(k-1, i, j)",
                    *couts)
            mm.body(**lw.bodies(tiles.gemm_cpu, tiles.gemm_cuda))
            self.final_writers = [(mm, "c", "i", "j", "any",
                                   f"k == {kt - 1}")]
        else:
            self.final_writers = [(mi, "c", "i", "j", "any", None)]

        def fn_a(p, q, rel):
            out = [(f"{q} == 0", f"a arr_mi{idx}({p}, 0 .. {nt - 1})")]
            if kt > 1:
                out.append((f"{q} > 0",
                            f"a arr_mm{idx}({q}, {p}, 0 .. {nt - 1})"))
            return out

        def fn_b(p, q, rel):
            out = [(f"{p} == 0", f"b arr_mi{idx}(0 .. {mt - 1}, {q})")]
            if kt > 1:
                out.append((f"{p} > 0",
                            f"b arr_mm{idx}({p}, 0 .. {mt - 1}, {q})"))
            return out

        sa.mirror(fn_a)
        sb.mirror(fn_b)

    def ref(self, i, j, rel="any"):
        if self.kt > 1:
            return [(None, f"c arr_mm{self.idx}({self.kt - 1}, {i}, {j})")]
        return [(None, f"c arr_mi{self.idx}({i}, {j})")]


class _LowCholesky(_LowBase):
    """Right-looking tiled Cholesky (the ``cholesky_ptg`` structure with
    synthesized entry edges): in-place ``ops.tiles`` bodies over private
    entry tiles; the result is LOWER-triangular — unconsumed upper tiles
    of the result collection stay zero, which is the value."""

    def build(self):
        lw, node, idx = self.lw, self.node, self.idx
        NT = node.mt
        D = self.D
        self.make_result_coll()
        src_node = node.inputs[0]
        src_low = lw.low[id(src_node)]
        need_cp = (src_node.is_source
                   or id(src_node) in lw.materialize
                   or lw.read_edges[id(src_node)] > 1
                   or not src_low.private_output)
        po, ts, sy, gm = (f"arr_po{idx}", f"arr_ts{idx}", f"arr_sy{idx}",
                          f"arr_gm{idx}")

        def entry_fn(p, q, rel):
            po_t = f"T {po}(0)"
            sy_t = f"A {sy}(0, {p})"
            ts_t = f"C {ts}(0, {p})"
            gm_t = f"A {gm}(0, {p}, {q})"
            if rel == "eq":
                return [(f"{p} == 0", po_t), (f"{p} > 0", sy_t)]
            if rel == "gt":
                return [(f"{q} == 0", ts_t), (f"{q} > 0", gm_t)]
            return [(f"{p} == {q} && {p} == 0", po_t),
                    (f"{p} == {q} && {p} > 0", sy_t),
                    (f"{p} > {q} && {q} == 0", ts_t),
                    (f"{p} > {q} && {q} > 0", gm_t)]

        aligned = (src_node.dist.same_placement(node.dist)
                   and (src_node.mb, src_node.nb) == (node.mb, node.nb))
        if need_cp:
            s = lw.source(src_node, region="lower", aligned=aligned)
            cp = lw.ptg.task_class(f"arr_cp{idx}", i=f"0 .. {NT - 1}",
                                   j="0 .. i")
            cp.affinity(f"{D}(i, j)")
            cp.priority("500")
            self.in_flow(cp, "A", s.ref("i", "j", "any"))
            # the private working set IS the result collection's lower
            # triangle: the factorization mutates it in place and the
            # final write-backs alias into no-ops
            cp.flow("O", INOUT, f"<- {D}(i, j)")
            cp.body(**lw.bodies(kernels.copy_cpu, kernels.copy_cuda))
            s.mirror(lambda p, q, rel:
                     [(f"{p} >= {q}", f"A arr_cp{idx}({p}, {q})")])
            for (g, t) in entry_fn("i", "j", "any"):
                cp.add_dep("O", _out(g, t))

            def entry(ie, je, rel):
                return [(None, f"O arr_cp{idx}({ie}, {je})")]
        else:
            s = lw.source(src_node, region="lower", aligned=aligned)
            s.mirror(entry_fn)
            entry = s.ref

        c_po = lw.ptg.task_class(po, k=f"0 .. {NT - 1}")
        c_po.affinity(f"{D}(k, k)")
        c_po.priority(f"({NT} - k) * 1000")
        c_po.flow("T", INOUT,
                  *_chain_in(entry("k", "k", "eq"), f"A {sy}(k-1, k)",
                             "k == 0", "k > 0"),
                  f"-> T {ts}(k, k+1 .. {NT - 1})",
                  f"-> {D}(k, k)")
        c_po.body(**lw.bodies(tiles.potrf_cpu, tiles.potrf_cuda))

        c_ts = lw.ptg.task_class(ts, k=f"0 .. {NT - 2}",
                                 m=f"k+1 .. {NT - 1}")
        c_ts.affinity(f"{D}(m, k)")
        c_ts.priority(f"({NT} - m) * 100")
        c_ts.flow("T", IN, f"<- T {po}(k)")
        c_ts.flow("C", INOUT,
                  *_chain_in(entry("m", "k", "gt"), f"A {gm}(k-1, m, k)",
                             "k == 0", "k > 0"),
                  f"-> B {sy}(k, m)",
                  f"-> B1 {gm}(k, m, k+1 .. m-1)",
                  f"-> B2 {gm}(k, m+1 .. {NT - 1}, m)",
                  f"-> {D}(m, k)")
        c_ts.body(**lw.bodies(tiles.trsm_cpu, tiles.trsm_cuda))

        c_sy = lw.ptg.task_class(sy, k=f"0 .. {NT - 2}",
                                 m=f"k+1 .. {NT - 1}")
        c_sy.affinity(f"{D}(m, m)")
        c_sy.priority(f"({NT} - m) * 100 + 10")
        c_sy.flow("A", INOUT,
                  *_chain_in(entry("m", "m", "eq"), f"A {sy}(k-1, m)",
                             "k == 0", "k > 0"),
                  f"-> (k == m-1) ? T {po}(m) : A {sy}(k+1, m)")
        c_sy.flow("B", IN, f"<- C {ts}(k, m)")
        c_sy.body(**lw.bodies(tiles.syrk_cpu, tiles.syrk_cuda))

        c_gm = lw.ptg.task_class(gm, k=f"0 .. {NT - 3}",
                                 m=f"k+2 .. {NT - 1}", n=f"k+1 .. m-1")
        c_gm.affinity(f"{D}(m, n)")
        c_gm.priority(f"({NT} - m) * 10")
        c_gm.flow("A", INOUT,
                  *_chain_in(entry("m", "n", "gt"), f"A {gm}(k-1, m, n)",
                             "k == 0", "k > 0"),
                  f"-> (k == n-1) ? C {ts}(n, m) : A {gm}(k+1, m, n)")
        c_gm.flow("B1", IN, f"<- C {ts}(k, m)")
        c_gm.flow("B2", IN, f"<- C {ts}(k, n)")
        c_gm.body(**lw.bodies(tiles.gemm_update_cpu,
                              tiles.gemm_update_cuda))

        self.final_writers = [(c_po, "T", "k", "k", "eq", None),
                              (c_ts, "C", "m", "k", "gt", None)]

    def ref(self, i, j, rel="any"):
        po_t = f"T arr_po{self.idx}({i})"
        ts_t = f"C arr_ts{self.idx}({j}, {i})"
        if rel == "eq":
            return [(None, po_t)]
        if rel == "gt":
            return [(None, ts_t)]
        # structural zeros above the diagonal: the result collection's
        # unwritten tiles ARE the upper triangle
        return [(f"{i} == {j}", po_t), (f"{i} > {j}", ts_t),
                (None, f"{self.D}({i}, {j})")]


class _LowSolve(_LowBase):
    """Blocked forward substitution ``x = L^{-1} b``: per-row
    accumulation chains (``arr_su``) ending in the diagonal solve
    (``arr_sv``); ``arr_sb`` privately copies each rhs tile into its
    chain (the chain mutates in place)."""

    def build(self):
        lw, node, idx = self.lw, self.node, self.idx
        L, b = node.inputs
        NT, NC = L.mt, node.nt
        D = self.D
        self.make_result_coll()
        # L reads (sv at (i,i), su at (i,j)) come from tasks whose
        # affinity is D(i, c): owner-local iff the shared placement
        # depends only on the tile ROW (q == 1 grids) — a q > 1 grid
        # hashes L's column index differently from the rhs column
        aligned_L = (L.dist.same_placement(node.dist)
                     and getattr(L.dist, "q", 0) == 1
                     and L.mb == node.mb)
        sL = lw.source(L, region="lower", aligned=aligned_L)
        b_aligned = (b.dist.same_placement(node.dist)
                     and (b.mb, b.nb) == (node.mb, node.nb))
        sB = lw.source(b, aligned=b_aligned)
        sv, su, sb = f"arr_sv{idx}", f"arr_su{idx}", f"arr_sb{idx}"

        c_sv = lw.ptg.task_class(sv, i=f"0 .. {NT - 1}",
                                 c=f"0 .. {NC - 1}")
        c_sv.affinity(f"{D}(i, c)")
        c_sv.priority(f"({NT} - i) * 100")
        self.in_flow(c_sv, "D", sL.ref("i", "i", "eq"))
        c_sv.flow("R", IN,
                  *_chain_in(sB.ref("i", "c", "any"),
                             f"R {su}(i-1, i, c)", "i == 0", "i > 0"))
        c_sv.flow("X", INOUT, f"<- {D}(i, c)",
                  f"-> X {su}(i, i+1 .. {NT - 1}, c)",
                  f"-> {D}(i, c)")
        c_sv.body(**lw.bodies(tiles.trsv_fwd_cpu, tiles.trsv_fwd_cuda))

        # sb/su are created even at NT == 1 (empty parameter spaces,
        # exactly like the cholesky classes): the runtime's release
        # path resolves every referenced class NAME before discovering
        # a range is empty, so a dep naming a never-created class is a
        # KeyError, not a no-op
        # per-row accumulation scratch: the su chains mutate these
        # tiles (NOT the result tiles — sv writes those; two writers
        # of one tile would be a WAW hazard)
        S = f"S{idx}"
        lw.constants[S] = node.dist.build(
            node.shape[0], node.shape[1], node.mb, node.nb,
            dtype=node.dtype, name=S, myrank=lw.myrank)
        c_sb = lw.ptg.task_class(sb, i=f"1 .. {NT - 1}",
                                 c=f"0 .. {NC - 1}")
        c_sb.affinity(f"{D}(i, c)")
        c_sb.priority("500")
        self.in_flow(c_sb, "A", sB.ref("i", "c", "any"))
        c_sb.flow("O", INOUT, f"<- {S}(i, c)", f"-> R {su}(0, i, c)")
        c_sb.body(**lw.bodies(kernels.copy_cpu, kernels.copy_cuda))

        c_su = lw.ptg.task_class(su, j=f"0 .. {NT - 2}",
                                 i=f"j+1 .. {NT - 1}",
                                 c=f"0 .. {NC - 1}")
        c_su.affinity(f"{D}(i, c)")
        c_su.priority(f"({NT} - i) * 10")
        self.in_flow(c_su, "L", sL.ref("i", "j", "gt"))
        c_su.flow("X", IN, f"<- X {sv}(j, c)")
        c_su.flow("R", INOUT,
                  f"<- (j == 0) ? O {sb}(i, c) : R {su}(j-1, i, c)",
                  f"-> (j == i-1) ? R {sv}(i, c) "
                  f": R {su}(j+1, i, c)")
        c_su.body(**lw.bodies(tiles.gemm_sub_cpu, tiles.gemm_sub_cuda))

        def fn_L(p, q, rel):
            sv_t = f"D {sv}({p}, 0 .. {NC - 1})"
            su_t = f"L {su}({q}, {p}, 0 .. {NC - 1})"
            if rel == "eq":
                return [(None, sv_t)]
            if rel == "gt":
                return [(None, su_t)]
            return [(f"{p} == {q}", sv_t), (f"{p} > {q}", su_t)]

        def fn_b(p, q, rel):
            return [(f"{p} == 0", f"R {sv}(0, {q})"),
                    (f"{p} > 0", f"A {sb}({p}, {q})")]

        sL.mirror(fn_L)
        sB.mirror(fn_b)
        self.final_writers = [(c_sv, "X", "i", "c", "any", None)]

    def ref(self, i, j, rel="any"):
        return [(None, f"X arr_sv{self.idx}({i}, {j})")]


class _LowReduce(_LowBase):
    """Per-tile partial reductions into the aligned (1, 1)-tiled partials
    collection; the per-rank fold and the cross-rank CollManager
    allreduce happen in ``DistArray._reduce`` after quiescence."""

    def build(self):
        lw, node, idx = self.lw, self.node, self.idx
        src = node.inputs[0]
        P = node.dist.partials(src.mt, src.nt, name=f"P{idx}",
                               myrank=lw.myrank)
        lw.constants[f"P{idx}"] = P
        node.coll = P  # the reduce's "result" is its partials grid
        name = f"arr_ps{idx}"
        pc = lw.ptg.task_class(name, i=f"0 .. {src.mt - 1}",
                               j=f"0 .. {src.nt - 1}")
        pc.affinity(f"P{idx}(i, j)")
        # partials are placement-aligned with the input's tiles by
        # construction (Distribution.partials)
        s = lw.source(src, aligned=True)
        self.in_flow(pc, "A", s.ref("i", "j", "any"))
        pc.flow("S", INOUT, f"<- P{idx}(i, j)", f"-> P{idx}(i, j)")
        # host-side f64 accumulators: always a CPU body (terminal op)
        pc.body(cpu=(kernels.psum_cpu if node.reduce_op == "sum"
                     else kernels.psumsq_cpu))
        s.mirror(lambda p, q, rel: [(None, f"A {name}({p}, {q})")])

    def result_coll(self):
        return self.lw.constants[f"P{self.idx}"]

    def ref(self, i, j, rel="any"):  # pragma: no cover - terminal node
        raise ValueError("a reduction has no tile output to consume")


_KIND_LOWER = {
    "add": _LowEw, "sub": _LowEw, "mul": _LowEw, "scale": _LowEw,
    "redist": _LowEw, "transpose": _LowTranspose, "matmul": _LowMatmul,
    "cholesky": _LowCholesky, "solve": _LowSolve, "reduce": _LowReduce,
}


# ---------------------------------------------------------------------------
# the lowerer + program handle
# ---------------------------------------------------------------------------

class _Lowerer:
    def __init__(self, outputs: Sequence[Node], name: str,
                 use_cpu: bool, use_cuda: bool):
        self.use_cpu, self.use_cuda = use_cpu, use_cuda
        if not (use_cpu or use_cuda):
            raise ValueError("array lowering needs use_cpu or use_cuda")
        # reachable nodes, deterministic postorder (SPMD ranks build the
        # same expression, hence the same class names)
        order: List[Node] = []
        seen: set = set()

        def visit(n: Node) -> None:
            if id(n) in seen:
                return
            seen.add(id(n))
            if not n.is_source:
                for i in n.inputs:
                    visit(i)
            order.append(n)

        for o in outputs:
            visit(o)
        self.order = order
        self.materialize = {id(n) for n in outputs}
        self.read_edges: Dict[int, int] = {}
        for n in order:
            if n.is_source:
                continue
            for i in n.inputs:
                self.read_edges[id(i)] = self.read_edges.get(id(i), 0) + 1
        myranks = {n.myrank for n in order}
        if len(myranks) > 1:
            raise ValueError(
                f"array program mixes arrays built for ranks "
                f"{sorted(myranks)}")
        self.myrank = myranks.pop() if myranks else 0
        grids = {n.dist.nodes for n in order if not n.dist.replicated}
        grids.discard(1)
        if len(grids) > 1:
            raise ValueError(
                f"array program mixes rank grids of sizes "
                f"{sorted(grids)} — redistribute first")
        self.nranks = grids.pop() if grids else 1
        self.ptg = PTG(name)
        self.constants: Dict[str, Any] = {}
        self.low: Dict[int, _LowBase] = {}
        for i, n in enumerate(order):
            cls = _LowLeaf if n.is_source else _KIND_LOWER[n.kind]
            self.low[id(n)] = cls(self, n, i)
        _count("programs_lowered")
        _count("classes_generated", len(self.ptg.classes))

    def bodies(self, cpu: Callable, cuda: Callable) -> Dict:
        kw: Dict[str, Callable] = {}
        if self.use_cpu:
            kw["cpu"] = cpu
        if self.use_cuda:
            kw["cuda"] = cuda
        return kw

    def source(self, node: Node, *, region: str = "full",
               aligned: bool = False) -> _Source:
        low = self.low[id(node)]
        if isinstance(low, _LowLeaf):
            return low.resolve(region, aligned)
        return low


class ArrayProgram:
    """A lowered array program: ONE :class:`~parsec_tpu_torch.dsl.ptg.PTG`
    plus its constants.  ``taskpool()`` instantiates (submit it through
    :mod:`parsec_tpu_torch.serve`, a context, the native engine or a
    :class:`~parsec_tpu_torch.dsl.GraphExecutor`);
    ``finalize()`` marks the requested outputs collection-backed once
    the pool has quiesced (``run``/``run_native`` do both)."""

    def __init__(self, lowerer: _Lowerer, outputs: List[Node]):
        self._lw = lowerer
        self.outputs = outputs

    @property
    def ptg(self) -> PTG:
        return self._lw.ptg

    @property
    def constants(self) -> Dict[str, Any]:
        return dict(self._lw.constants)

    @property
    def nranks(self) -> int:
        return self._lw.nranks

    def taskpool(self, context=None, **overrides):
        """Instantiate the program's taskpool.  Pass the ``context`` it
        will attach to on a MULTI-RANK mesh: remote activations are routed
        by POOL NAME, so two same-named pools live back-to-back on a
        rank-skewed mesh can cross-talk.  With a context, the name is
        suffixed with the mesh endpoint's SPMD-consistent sequence number
        (every rank draws the same value for the same program in the same
        order), making each program's pool name unique per mesh."""
        _count("taskpools_built")
        merged = dict(self._lw.constants)
        merged.update(overrides)
        tp = self.ptg.taskpool(**merged)
        ce = getattr(context, "comm", None)
        if (context is not None and getattr(context, "nranks", 1) > 1
                and ce is not None):
            tp.name = f"{tp.name}@{ce.coll.sequence(('array', tp.name))}"
        return tp

    def verify(self, **kw):
        """Lint the generated graph (``PTG.verify`` under the program's
        own constants); returns the findings list (empty = clean)."""
        return self.ptg.verify(self._lw.constants, **kw)

    def run(self, context, *, timeout: Optional[float] = 600):
        nr = getattr(context, "nranks", 1)
        if self.nranks not in (1, nr):
            raise ValueError(
                f"array program is distributed over {self.nranks} ranks "
                f"but the context has {nr}")
        tp = self.taskpool(context)
        context.add_taskpool(tp)
        if not tp.wait(timeout=timeout):
            raise RuntimeError(
                f"array program {self.ptg.name!r} did not quiesce")
        self.finalize()
        return tp

    def run_native(self, *, nthreads: int = 4, native_device: bool = False,
                   device=None):
        """Execute on the native engine: CPU bodies by default,
        ``native_device=True`` every task through the CUDA device module
        driven by the native pump (:meth:`PTGTaskpool.run_native`)."""
        if self.nranks != 1:
            raise NotImplementedError(
                f"run_native() of array program {self.ptg.name!r}: its grid "
                f"spans {self.nranks} ranks, and the distributed native "
                "executor (native_dist) is not ported yet (ROADMAP A.8b part 2)")
        tp = self.taskpool()
        tp.run_native(nthreads=nthreads, native_device=native_device,
                      device=device)
        self.finalize()
        return tp

    def finalize(self) -> None:
        for n in self.outputs:
            if n.coll is None:
                n.coll = self._lw.low[id(n)].result_coll()


def lower(outputs: Sequence, *, name: Optional[str] = None,
          use_cpu: bool = True, use_cuda: bool = True) -> ArrayProgram:
    """Lower the expression graph reachable from ``outputs``
    (:class:`DistArray` handles or raw :class:`Node`\\ s) into one
    program.  Each output is materialized into its result collection;
    intermediates stay pure flow data.  ``use_cpu``/``use_cuda`` pick the
    body incarnations the classes carry (the reductions' partials are
    host-only)."""
    nodes = [o._node if isinstance(o, DistArray) else o for o in outputs]
    if not nodes:
        raise ValueError("lower() needs at least one output array")
    todo = [n for n in nodes if not n.is_source]
    lw = _Lowerer(todo if todo else nodes, name or "array_prog",
                  use_cpu, use_cuda)
    return ArrayProgram(lw, todo)


# ---------------------------------------------------------------------------
# canonical programs (lint registry, `tools lint array:` target)
# ---------------------------------------------------------------------------

def canonical_program(which: str = "mixed") -> ArrayProgram:
    """Small deterministic array programs for the lint sweep:

    * ``mixed`` — the acceptance shape ``C = cholesky(A @ A.T + B);
      x = C.solve(b)`` at 12x12 / nb=4, single rank;
    * ``chain`` — a fusible elementwise chain (the PTG060 case);
    * ``dist`` — the mixed program over a 2-rank 1-D grid, so the
      generated forwarding readers are linted too.
    """
    from .dist import Block1D
    from .expr import from_numpy

    n, nb = 12, 4
    base = np.arange(n * n, dtype=np.float64).reshape(n, n) / (n * n)
    spd_boost = np.eye(n) * (2.0 * n)
    if which in ("mixed", "dist"):
        dist = Block1D(2) if which == "dist" else None
        A = from_numpy(base + np.eye(n), nb, dist=dist, name="A")
        B = from_numpy(spd_boost, nb, dist=dist, name="B")
        b = from_numpy(np.ones((n, 2)), nb, 2, dist=dist, name="b")
        C = (A @ A.T + B).cholesky()
        x = C.solve(b)
        return lower([x, C], name=f"array_{which}", use_cuda=False)
    if which == "chain":
        A = from_numpy(base, nb, name="A")
        B = from_numpy(base.T.copy(), nb, name="B")
        out = ((A + B) * 0.5 - B).scale(2.0)
        return lower([out], name="array_chain", use_cuda=False)
    raise KeyError(
        f"unknown canonical array program {which!r} "
        "(known: mixed, chain, dist)")
