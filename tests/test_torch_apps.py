"""The application programs of ``tests/apps/`` on both packages: the
parallel merge sort (the port's own ``examples/jdf/merge_sort.jdf`` beside
the JAX package's), the Haar tree (DTD tasks inserting tasks), the
generalized binary-tree reduction (computed dependency guards, NEW tiles)
and the comm apps (ping-pong, bandwidth through rendezvous and eager,
all-to-all, a DTD merge sort).

Each program takes the same seeded inputs through the JAX package and
through the port (host-only port contexts, ``devices=["cpu"]``: these
programs carry numpy bodies only) and the two results must be EQUAL:
integer sorts, reduction values, tree nodes, transfer counts and bytes.
``tests/test_torch_stencil.py`` holds the stencil app.
"""

import math
import os
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu import data as ref_data  # noqa: E402
from parsec_tpu import dsl as ref_dsl  # noqa: E402
from parsec_tpu.dsl import dtd as ref_dtd  # noqa: E402
from parsec_tpu.dsl import ptg as ref_ptg  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca  # noqa: E402
from parsec_tpu_torch import data as port_data  # noqa: E402
from parsec_tpu_torch import dsl as port_dsl  # noqa: E402
from parsec_tpu_torch.dsl import dtd as port_dtd  # noqa: E402
from parsec_tpu_torch.dsl import ptg as port_ptg  # noqa: E402
from parsec_tpu_torch.utils import mca_param as port_mca  # noqa: E402
from tests.test_torch_multirank import PORT as PORT_MR  # noqa: E402
from tests.test_torch_multirank import REF as REF_MR  # noqa: E402
from tests.test_torch_multirank import run_ranks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = dict(name="ref", Context=parsec_tpu.Context, data=ref_data, dsl=ref_dsl,
           dtd=ref_dtd, ptg=ref_ptg, mca=ref_mca, ctx_kw={}, mr=REF_MR,
           jdf=os.path.join(ROOT, "examples", "jdf"))
PORT = dict(name="port", Context=parsec_tpu_torch.Context, data=port_data, dsl=port_dsl,
            dtd=port_dtd, ptg=port_ptg, mca=port_mca, ctx_kw={"devices": ["cpu"]},
            mr=PORT_MR, jdf=os.path.join(ROOT, "parsec_tpu_torch", "examples", "jdf"))


def _ctx(P, nb_cores=4):
    return P["Context"](nb_cores=nb_cores, **P["ctx_kw"])


def _both(run, *args):
    """``run(P, *args)`` on the JAX package and on the port."""
    return run(REF, *args), run(PORT, *args)


# ---------------------------------------------------------------------------
# merge sort (tests/apps/test_merge_sort.py)
# ---------------------------------------------------------------------------

def _merge_sort(P, nt, chunk, nranks):
    jdf = P["dsl"].compile_jdf_file(os.path.join(P["jdf"], "merge_sort.jdf"))
    results = {}

    def setup(nodes, myrank):
        rng = np.random.default_rng(0)
        chunks = {i: rng.integers(0, 1000, chunk).astype(np.int64) for i in range(nt)}
        LC = P["data"].LocalCollection
        dataA = LC("dataA", shape=(chunk,), nodes=nodes, myrank=myrank,
                   init=lambda k: chunks[k].copy())
        result = LC("result", shape=(nt * chunk,), nodes=nodes, myrank=myrank,
                    init=lambda k: np.zeros(nt * chunk, np.int64))
        expected = np.sort(np.concatenate([chunks[i] for i in range(nt)]))
        return dataA, result, expected

    H = int(math.log2(nt))
    if nranks == 1:
        dataA, result, expected = setup(1, 0)
        with _ctx(P) as ctx:
            tp = jdf.new(dataA=dataA, result=result, NT=nt, H=H)
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=60)
        results[0] = result
    else:
        def build(rank, ctx):
            dataA, result, expected = setup(nranks, rank)
            dataA.rank_of = lambda *key: (key[0] if key else 0) % nranks
            result.rank_of = lambda *key: 0
            results[rank] = result
            return jdf.new(dataA=dataA, result=result, NT=nt, H=H)

        run_ranks(P["mr"], nranks, build)
        expected = setup(1, 0)[2]
    got = np.asarray(results[0].data_of(0).newest_copy().payload)
    np.testing.assert_array_equal(got, expected)
    return got


@pytest.mark.parametrize("nt,chunk,nranks", [(8, 16, 1), (8, 8, 2)],
                         ids=["single_rank", "two_ranks"])
def test_merge_sort_jdf_equals_the_jax_package(nt, chunk, nranks):
    """SORT leaves and the MERGE tree of each package's merge_sort.jdf
    give the same sorted integers, one rank and two (the merge tree
    pulling remote runs through the comm engine)."""
    ref, port = _both(_merge_sort, nt, chunk, nranks)
    assert port.dtype == ref.dtype and np.array_equal(port, ref)


# ---------------------------------------------------------------------------
# Haar tree (tests/apps/test_haar_tree.py)
# ---------------------------------------------------------------------------

LMIN, LMAX = 3, 10


def _f(x):
    return math.sin(3.0 * x) + math.exp(-200.0 * (x - 0.35) ** 2)


def _avg(l, n):
    a, b = n / (1 << l), (n + 1) / (1 << l)
    return (_f(a) + 2.0 * _f((a + b) / 2) + _f(b)) / 4.0


def _haar(P, thresh):
    """The adaptive Haar projection: node tasks insert their children.
    Returns {(l, n): (s, d)} and the number of node tasks run."""
    tree = P["data"].LocalCollection("tree", shape=(2,), dtype=np.float64)
    count = [0]
    lock = threading.Lock()
    with _ctx(P) as ctx:
        tp = P["dtd"].DTDTaskpool(ctx, "haar_project")

        def node_task(tile, l, n):
            s = _avg(l, n)
            d = (_avg(l + 1, 2 * n) - _avg(l + 1, 2 * n + 1)) / 2.0
            tile[0], tile[1] = s, d
            with lock:
                count[0] += 1
            if l < LMIN or (abs(d) > thresh and l < LMAX):
                insert(l + 1, 2 * n)
                insert(l + 1, 2 * n + 1)

        def insert(l, n):
            tp.insert_task(node_task, (tree.data_of(l, n), P["dtd"].OUT), l, n,
                           name=f"node({l},{n})")

        insert(0, 0)
        assert tp.wait(timeout=60)
        tp.close()
    nodes = {key: tuple(float(x) for x in tree.data_of(*key).newest_copy().payload)
             for key in tree.keys()}
    return nodes, count[0]


@pytest.mark.parametrize("thresh", [1e-2, 1e-3, 1e-4])
def test_haar_tree_equals_the_jax_package(thresh):
    """The same tree discovered at run time by both packages: the same
    nodes with the same coefficients, one task a node; its leaves
    partition [0, 1) and their depth varies (the criterion pruned)."""
    (ref_nodes, ref_n), (nodes, n) = _both(_haar, thresh)
    assert nodes == ref_nodes and n == ref_n == len(nodes)
    leaves = [(l, i) for (l, i) in nodes if (l + 1, 2 * i) not in nodes]
    assert sum(1.0 / (1 << l) for l, _ in leaves) == pytest.approx(1.0, abs=1e-12)
    assert len({l for l, _ in leaves}) > 1


# ---------------------------------------------------------------------------
# generalized binary-tree reduction (tests/apps/test_generalized_reduction.py)
# ---------------------------------------------------------------------------

def _bit_subtrees(N):
    out, off = [], 0
    for b in range(N.bit_length()):
        if N >> b & 1:
            out.append((off, b))
            off += 1 << b
    return out


def _reduction(P, N, W, ran=None):
    """The BT-reduction PTG over N seeded integer tiles; returns the sum
    tile (and counts bodies by class into ``ran``)."""
    ptg_mod = P["ptg"]
    ptg = ptg_mod.PTG("bt_reduction")
    red = ptg.task_class("red", t="1 .. T", l="1 .. LOGSZ(t)",
                         i="0 .. 2**(LOGSZ(t)-l) - 1")
    red.affinity("TVAL(OFF(t) + (2**l) * i)")
    red.flow("A", ptg_mod.INOUT,
             "<- (l == 1) ? TVAL(OFF(t) + 2*i) : A red(t, l-1, 2*i)",
             "-> (l < LOGSZ(t) and i % 2 == 0) ? A red(t, l+1, i//2)",
             "-> (l < LOGSZ(t) and i % 2 == 1) ? B red(t, l+1, i//2)",
             "-> (l == LOGSZ(t)) ? R lineage(t)")
    red.flow("B", ptg_mod.IN,
             "<- (l == 1) ? TVAL(OFF(t) + 2*i + 1) : A red(t, l-1, 2*i+1)")
    lineage = ptg.task_class("lineage", t="1 .. T")
    lineage.affinity("RES(0)")
    lineage.flow("R", ptg_mod.IN,
                 "<- (LOGSZ(t) > 0) ? A red(t, LOGSZ(t), 0)",
                 "<- (LOGSZ(t) == 0) ? TVAL(OFF(t))")
    lineage.flow("S", ptg_mod.INOUT,
                 "<- (t == 1) ? NEW : S lineage(t-1)",
                 "-> (t < T) ? S lineage(t+1)",
                 "-> (t == T) ? RES(0)")
    ran = [] if ran is None else ran
    lock = threading.Lock()

    def counted(name, fn):
        def body(*a, **kw):
            with lock:
                ran.append(name)
            return fn(*a, **kw)
        return body

    red.body(cpu=counted("red", lambda A, B, **_: A.__iadd__(B)))
    lineage.body(cpu=counted("lineage", lambda S, R, **_: S.__iadd__(R)))

    vals = np.random.default_rng(N).integers(0, 100, size=(N, W)).astype(np.float64)
    LC = P["data"].LocalCollection
    tv = LC("TVAL", shape=(W,), init=lambda k: vals[k].copy())
    res = LC("RES", shape=(W,), init=lambda k: np.zeros(W))
    subtrees = _bit_subtrees(N)
    with _ctx(P) as ctx:
        tp = ptg.taskpool(N=N, T=len(subtrees), OFF=lambda t: subtrees[t - 1][0],
                          LOGSZ=lambda t: subtrees[t - 1][1], TILE_SHAPE=(W,),
                          TILE_DTYPE=np.float64, TVAL=tv, RES=res)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30)
    out = np.array(res.data_of(0).newest_copy().payload)
    np.testing.assert_array_equal(out, vals.sum(axis=0))
    return out, sorted(ran)


@pytest.mark.parametrize("N", [1, 2, 3, 7, 12, 21])
def test_bt_reduction_equals_the_jax_package(N):
    """The sum of N integer tiles (power-of-two and ragged N) and the
    bodies run, class by class, equal on both packages."""
    (ref, ref_ran), (port, ran) = _both(_reduction, N, 4)
    assert np.array_equal(port, ref) and ran == ref_ran


def test_bt_reduction_task_count_on_both_packages():
    """N=21 (10101b): subtrees of 16+4+1 leaves, 15+3+0 red tasks and 3
    lineage tasks on each package."""
    for P in (REF, PORT):
        _, ran = _reduction(P, 21, 2)
        assert ran.count("red") == 18 and ran.count("lineage") == 3, P["name"]


# ---------------------------------------------------------------------------
# comm apps (tests/apps/test_comm_apps.py)
# ---------------------------------------------------------------------------

def _pingpong(P, trips):
    """T round trips of a 64-element tile between 2 ranks (rtt.jdf
    shape): the last hop's tile and the activations."""
    nranks, out = 2, {}

    def build(rank, ctx):
        dc = P["data"].LocalCollection("D", shape=(64,), nodes=nranks, myrank=rank,
                                       init=lambda k: np.zeros(64))
        dc.rank_of = lambda *key: dc.data_key(*key) % nranks
        out[rank] = dc
        ptg = P["ptg"].PTG("rtt")
        hop = ptg.task_class("hop", t="0 .. T-1")
        hop.affinity("D(t)")
        hop.flow("X", P["ptg"].INOUT,
                 "<- (t == 0) ? D(0) : X hop(t-1)",
                 "-> (t < T-1) ? X hop(t+1) : D(t)")
        hop.body(cpu=lambda X, t: X.__iadd__(1.0))
        return ptg.taskpool(T=trips, D=dc)

    ctxs = run_ranks(P["mr"], nranks, build)
    last = (trips - 1) % nranks
    tile = np.array(out[last].data_of(trips - 1).newest_copy().payload)
    np.testing.assert_array_equal(tile, np.full(64, float(trips)))
    return tile, [c.comm.remote_dep.stats["activations_sent"] for c in ctxs]


def test_pingpong_equals_the_jax_package():
    ref, port = _both(_pingpong, 20)
    assert np.array_equal(port[0], ref[0]) and port[1] == ref[1] == [10, 9]


_BW_KEYS = (("remote_dep", "activations_sent"), ("remote_dep", "rdv_advertised"),
            ("remote_dep", "rdv_pulls"), ("remote_dep", "eager_sent"),
            ("ce", "get_bytes"), ("ce", "am_bytes"))


def _bandwidth(P, F, L, eager_limit):
    """F transfers of L bytes from rank 0 to rank 1 (bandwidth.jdf): each
    rank's protocol counters."""
    nranks = 2

    def build(rank, ctx):
        dc = P["data"].LocalCollection("D", shape=(L // 8,), nodes=nranks, myrank=rank,
                                       init=lambda k: np.zeros(L // 8))
        dc.rank_of = lambda *key: dc.data_key(*key) % nranks
        ptg = P["ptg"].PTG("bw")
        snd = ptg.task_class("snd", f="0 .. F-1")
        snd.affinity("D(0)")
        snd.flow("X", P["ptg"].INOUT, "<- D(2*f)", "-> X rcv(f)")
        snd.body(cpu=lambda X, f: None)
        rcv = ptg.task_class("rcv", f="0 .. F-1")
        rcv.affinity("D(1)")
        rcv.flow("X", P["ptg"].IN, "<- X snd(f)")
        rcv.body(cpu=lambda X, f: None)
        return ptg.taskpool(F=F, D=dc)

    if eager_limit is not None:
        P["mca"].set_param("runtime", "comm_eager_limit", eager_limit)
    try:
        ctxs = run_ranks(P["mr"], nranks, build)
    finally:
        if eager_limit is not None:
            P["mca"].unset("runtime", "comm_eager_limit")
    return [{f"{where}.{key}": (c.comm.remote_dep.stats if where == "remote_dep"
                                else c.comm.stats).get(key, 0)
             for where, key in _BW_KEYS} for c in ctxs]


@pytest.mark.parametrize("eager_limit", [None, 1 << 16], ids=["rendezvous", "eager"])
def test_bandwidth_counts_equal_the_jax_package(eager_limit):
    """32 KiB tiles above the default 8 KiB eager limit travel the chunked
    rendezvous path (F pulls, F*L bytes at the puller); with the limit
    raised over the tile, inline with the activation (F*L bytes at the
    sender).  Both packages count the same transfers and bytes."""
    F, L = 10, 32768
    ref, port = _both(_bandwidth, F, L, eager_limit)
    assert port == ref
    if eager_limit is None:
        assert port[1]["remote_dep.rdv_pulls"] == F and port[1]["ce.get_bytes"] == F * L
    else:
        assert port[0]["remote_dep.eager_sent"] == F and port[0]["ce.am_bytes"] == F * L
        assert port[1]["ce.get_bytes"] == 0


def _all2all(P, nranks):
    """Every rank's tile reaches every rank (all2all.jdf): what each sink
    saw."""
    got = {r: {} for r in range(nranks)}
    locks = {r: threading.Lock() for r in range(nranks)}

    def build(rank, ctx):
        dc = P["data"].LocalCollection(
            "D", shape=(4,), nodes=nranks, myrank=rank,
            init=lambda k: np.full(4, float(k[0] if isinstance(k, tuple) else k)))
        dc.rank_of = lambda *key: dc.data_key(*key) % nranks
        ptg = P["ptg"].PTG("a2a")
        src = ptg.task_class("src", i="0 .. NR-1")
        src.affinity("D(i)")
        src.flow("X", P["ptg"].INOUT, "<- D(i)", "-> X snk(i, 0 .. NR-1)")
        src.body(cpu=lambda X, i: X.__iadd__(100.0))
        snk = ptg.task_class("snk", i="0 .. NR-1", j="0 .. NR-1")
        snk.affinity("D(j)")
        snk.flow("X", P["ptg"].IN, "<- X src(i)")

        def snk_body(X, i, j):
            with locks[rank]:
                got[rank][(i, j)] = float(X[0])

        snk.body(cpu=snk_body)
        return ptg.taskpool(NR=nranks, D=dc)

    run_ranks(P["mr"], nranks, build)
    return got


def test_all2all_equals_the_jax_package():
    ref, port = _both(_all2all, 4)
    assert port == ref
    for r in range(4):
        assert port[r] == {(i, r): 100.0 + i for i in range(4)}


def _merge_sort_dtd(P):
    """A DTD merge sort over 8 chunk tiles with a pairwise merge tree."""
    raw = np.random.default_rng(0).standard_normal(8 * 64)
    tiles = [P["data"].data_create(i, payload=raw[i * 64:(i + 1) * 64].copy())
             for i in range(8)]

    def merge_runs(*bufs):
        whole = np.concatenate(bufs)
        whole.sort(kind="mergesort")
        off = 0
        for b in bufs:
            b[:] = whole[off:off + b.shape[0]]
            off += b.shape[0]

    INOUT = P["dtd"].INOUT
    with _ctx(P) as ctx:
        tp = P["dtd"].DTDTaskpool(ctx)
        for t in tiles:
            tp.insert_task(merge_runs, (t, INOUT), name="sort_leaf")
        stride = 1
        while stride < 8:
            for i in range(0, 8, 2 * stride):
                tp.insert_task(merge_runs, *[(t, INOUT) for t in tiles[i:i + 2 * stride]],
                               name="merge")
            stride *= 2
        assert tp.wait(timeout=60)
        tp.close()
    out = np.concatenate([np.asarray(t.newest_copy().payload) for t in tiles])
    np.testing.assert_array_equal(out, np.sort(raw))
    return out


def test_merge_sort_dtd_equals_the_jax_package():
    ref, port = _both(_merge_sort_dtd)
    assert np.array_equal(port, ref)
