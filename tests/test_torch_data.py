"""The port's arenas, datatypes and checkpoints (parsec_tpu_torch.data
.arena, .datatype, .checkpoint) against the JAX package's.

* arenas: every case of the reference's ``tests/class/test_arena_guard.py``
  — the double-release guard, the free list that never aliases, the
  recycle cycle, a finalizer racing an explicit release — with equal
  ``stats()`` in both packages, plus the pressure gauges and the PINS
  sites;
* datatypes: every case of ``tests/class/test_datatype.py`` on the same
  seeded buffers, views and packed bytes ``np.array_equal`` in both
  packages (the comm engine's pack/unpack slots wait for the distributed
  layer, ROADMAP A.8: a pack/unpack round trip through the datatype
  stands in);
* checkpoints: the single-rank cases of ``tests/runtime/test_checkpoint.py``
  (the round trip, resume across contexts, a two-rank layout's shards
  restored at one rank, numpy-scalar keys and odd names, the shard rank,
  the replicated mode, duplicate names), a shard written by either
  package restored by the other (``np.array_equal``), and a save whose
  tiles' newest versions live on the CUDA module (bound to the torch CPU
  device): the device's version is saved, never the stale host copy.
"""

import gc
import weakref

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.data import arena as ref_arena  # noqa: E402
from parsec_tpu.data import checkpoint as ref_ck  # noqa: E402
from parsec_tpu.data import datatype as ref_dt  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLocalCollection  # noqa: E402
from parsec_tpu.datadist import TwoDimBlockCyclic as RefBC  # noqa: E402
from parsec_tpu.dsl import compile_jdf as ref_compile_jdf  # noqa: E402
from parsec_tpu.profiling import pins as ref_pins  # noqa: E402
from parsec_tpu_torch.data import arena, checkpoint as ck, datatype as dt  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix, TwoDimBlockCyclic  # noqa: E402
from parsec_tpu_torch.dsl import compile_jdf  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg  # noqa: E402
from parsec_tpu_torch.profiling import pins  # noqa: E402

ARENAS = (ref_arena, arena)


# ---------------------------------------------------------------------------
# tests/class/test_arena_guard.py
# ---------------------------------------------------------------------------

def test_double_release_raises_readable_error():
    stats = []
    for m in ARENAS:
        ar = m.Arena((8,), np.float64, name="guarded")
        c = ar.allocate()
        ar.release(c)
        with pytest.raises(m.ArenaRecycleError, match="guarded.*recycled twice"):
            ar.release(c)
        # the free list holds the buffer exactly ONCE
        stats.append(ar.stats())
    assert stats[0] == stats[1]
    assert stats[1]["cached"] == 1 and stats[1]["used"] == 0


def test_free_list_never_aliases_after_refused_double_release():
    for m in ARENAS:
        ar = m.Arena((4,), np.float64, name="alias")
        c = ar.allocate()
        ar.release(c)
        with pytest.raises(m.ArenaRecycleError):
            ar.release(c)
        c1, c2 = ar.allocate(), ar.allocate()
        c1.payload[:] = 1.0
        c2.payload[:] = 2.0
        assert c1.payload[0] == 1.0 and c2.payload[0] == 2.0


def test_normal_recycle_cycle_unaffected():
    stats = []
    for m in ARENAS:
        ar = m.Arena((4,), np.float64, name="cycle")
        for _ in range(5):
            ar.release(ar.allocate())
        stats.append(ar.stats())
    assert stats[0] == stats[1]
    assert stats[1]["used"] == 0 and stats[1]["created"] == 1


def test_finalizer_racing_explicit_release_is_refused():
    """A weakref finalizer releases the slot when the last consumer dies;
    if the slot was also released explicitly, the finalizer's release is
    refused loudly instead of corrupting the free list."""
    stats = []
    for m in ARENAS:
        pool = m.BytePool("rx")
        slot = pool.allocate(1024)
        holder = slot.payload[:100]
        fin = weakref.finalize(holder, slot.arena.release, slot)
        slot.arena.release(slot)  # the explicit release wins the race
        with pytest.raises(m.ArenaRecycleError):
            fin()
        del holder
        gc.collect()
        [ar] = pool.arenas()
        stats.append((ar.stats(), pool.stats(), slot.payload is None))
    assert stats[0] == stats[1]
    assert stats[1][0]["cached"] == 1 and stats[1][0]["used"] == 0


def test_max_used_and_pressure_gauges():
    """``arena_max_used`` caps the outstanding buffers (None: retry
    later), and the process-wide gauges count this arena's bytes."""
    out = []
    for m in ARENAS:
        ar = m.Arena((16,), np.float32, name="capped")
        ar.max_used = 2
        a, b = ar.allocate(), ar.allocate()
        assert ar.allocate() is None
        ar.release(a)
        g = m.global_stats()
        assert ar in m.all_arenas() and g["bytes_in_use"] >= 64
        out.append((ar.stats(), a.data.shape, str(a.data.dtype)))
        ar.release(b)
    assert out[0] == out[1]
    assert out[1][0]["used_hw"] == 2 and out[1][0]["bytes_hw"] == 128


def test_byte_budget_meters_peak():
    for m in ARENAS:
        b = m.ByteBudget(100)
        b.acquire(60)
        b.acquire(30)
        b.release(60)
        b.acquire(10)
        assert (b.limit, b.now, b.peak) == (100, 40, 90)


def test_arena_pins_sites():
    """ARENA_ALLOC and ARENA_RECYCLE fire with the same payload shape in
    both packages."""
    seen = []
    for m, p in ((ref_arena, ref_pins), (arena, pins)):
        got = []

        def cb(site):
            return lambda es, payload: got.append((site, payload["arena"]))

        subs = [(s, cb(s)) for s in (p.ARENA_ALLOC, p.ARENA_RECYCLE)]
        for s, f in subs:
            p.subscribe(s, f)
        try:
            ar = m.Arena((2,), name="traced")
            ar.release(ar.allocate())
        finally:
            for s, f in subs:
                p.unsubscribe(s, f)
        seen.append(got)
    assert seen[0] == seen[1] == [("arena_alloc", "traced"),
                                  ("arena_recycle", "traced")]


# ---------------------------------------------------------------------------
# tests/class/test_datatype.py
# ---------------------------------------------------------------------------

DATATYPES = (ref_dt, dt)


def test_contiguous_roundtrip_zero_copy():
    for m in DATATYPES:
        buf = np.arange(20, dtype=np.float64)
        d = m.type_create_contiguous(8)
        v = d.view(buf, offset=4)
        assert v.base is not None  # a view, not a copy
        np.testing.assert_array_equal(v, np.arange(4, 12))
        packed = d.pack(buf, offset=4)
        assert packed.base is not None  # zero-copy for contiguous
        assert (d.size, d.extent, d.count) == (64, 64, 8)
        assert repr(d) == "Contiguous(8, float64)"


def test_vector_describes_lapack_tile():
    """A tile inside a padded matrix: blocks = columns, stride = lda."""
    res = []
    for m in DATATYPES:
        lda, rows, cols = 10, 4, 6
        big = np.random.default_rng(0).standard_normal(lda * 8).astype(np.float32)
        d = m.type_create_vector(blocks=cols, blocklen=rows, stride=lda,
                                 base=np.float32)
        assert d.size == cols * rows * 4
        assert d.extent == ((cols - 1) * lda + rows) * 4
        tile = d.view(big, offset=2)
        assert tile.shape == (cols, rows)
        packed = d.pack(big, offset=2)
        out = np.zeros_like(big)
        d.unpack(packed, out, offset=2)
        np.testing.assert_array_equal(d.view(out, 2), tile)
        assert out[0] == 0 and out[2 + rows] == 0  # padding untouched
        res.append((tile.copy(), packed, out))
    for a, b in zip(*res):
        assert np.array_equal(a, b)


def test_vector_view_is_writable_window():
    for m in DATATYPES:
        buf = np.zeros(12, dtype=np.int64)
        m.Vector(3, 2, 4, np.int64).view(buf)[:, :] = 7
        assert buf.tolist() == [7, 7, 0, 0, 7, 7, 0, 0, 7, 7, 0, 0]


def test_overlapping_vector_rejected():
    for m in DATATYPES:
        with pytest.raises(ValueError, match="overlap"):
            m.Vector(blocks=2, blocklen=5, stride=3)


def test_type_of_array_padded_rows():
    for m in DATATYPES:
        a = np.zeros((6, 8), dtype=np.float32)
        d = m.type_of_array(a[:, :5])
        assert isinstance(d, m.Vector)
        assert (d.blocks, d.blocklen, d.stride) == (6, 5, 8)
        d.view(a.reshape(-1))[:, :] = 3.0
        assert (a[:, :5] == 3.0).all() and (a[:, 5:] == 0.0).all()
        with pytest.raises(ValueError, match="1-D/2-D"):
            m.type_of_array(np.zeros((2, 2, 2)))


def test_pack_unpack_wire_roundtrip():
    """The comm engine's pack/unpack slots (the reference's case) wait
    for the distributed layer; the wire bytes a datatype packs are the
    reference's, and unpack lands them back."""
    wires = []
    for m in DATATYPES:
        buf = np.random.default_rng(1).standard_normal(40)
        d = m.Vector(4, 3, 10, np.float64)
        wire = d.pack(buf, offset=5)
        out = np.zeros(40)
        d.unpack(wire, out, offset=5)
        np.testing.assert_array_equal(d.view(out, 5), d.view(buf, 5))
        wires.append(wire)
    assert np.array_equal(*wires)


def test_2d_buffer_accepted_when_contiguous():
    for m in DATATYPES:
        mat = np.arange(24, dtype=np.float64).reshape(4, 6)
        np.testing.assert_array_equal(
            m.Contiguous(6, np.float64).view(mat, offset=6), mat[1])


def test_undersized_buffer_rejected():
    for m in DATATYPES:
        with pytest.raises(ValueError, match="too small"):
            m.Vector(blocks=4, blocklen=4, stride=10).view(np.zeros(8))
        with pytest.raises(ValueError, match="too small"):
            m.Contiguous(8).pack(np.zeros(4))
        with pytest.raises(ValueError, match="too small"):
            m.Contiguous(4).view(np.zeros(8), offset=6)


# ---------------------------------------------------------------------------
# tests/runtime/test_checkpoint.py (single-rank cases)
# ---------------------------------------------------------------------------

CHAIN = """
mydata  [ type = "collection" ]
NB      [ type = int ]

Task(k)

k = 0 .. NB

: mydata( 0 )

RW  A <- (k == 0)  ? mydata( 0 ) : A Task( k-1 )
      -> (k == NB) ? mydata( 0 ) : A Task( k+1 )

BODY
{
    A += 1.0
}
END
"""

REF = dict(ck=ref_ck, LC=RefLocalCollection, BC=RefBC, jdf=ref_compile_jdf,
           Context=lambda: parsec_tpu.Context(nb_cores=2, devices=["cpu"]))
PORT = dict(ck=ck, LC=LocalCollection, BC=TwoDimBlockCyclic, jdf=compile_jdf,
            Context=lambda: parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]))


def _tiles(dc, keys):
    return [np.array(dc.data_of(*k).newest_copy().payload) for k in keys]


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_roundtrip(tmp_path, P):
    dc = P["LC"]("D", shape=(4,), init=lambda k: np.zeros(4))
    for k in range(3):
        dc.data_of(k).newest_copy().payload[:] = k + 1.0
    A = P["BC"](8, 8, 4, 4, name="A")
    for (i, j) in A.local_tiles():
        A.data_of(i, j).newest_copy().payload[:] = 10 * i + j
    path = str(tmp_path / "ck")
    P["ck"].save(path, dc, A, meta={"step": 7})
    for k in range(3):
        dc.data_of(k).newest_copy().payload[:] = 0.0
    for (i, j) in A.local_tiles():
        A.data_of(i, j).newest_copy().payload[:] = -1.0
    assert P["ck"].restore(path, dc, A) == 3 + 4
    for k in range(3):
        np.testing.assert_array_equal(dc.data_of(k).newest_copy().payload, k + 1.0)
    for (i, j) in A.local_tiles():
        np.testing.assert_array_equal(A.data_of(i, j).newest_copy().payload,
                                      10 * i + j)
    m = P["ck"].manifest(path)
    assert m[0]["meta"] == {"step": 7} and m[0]["tiles"] == 7


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_resume_across_contexts(tmp_path, P):
    """Half the work, a checkpoint, everything rebuilt from disk in a NEW
    context, the second half: the result equals one full run."""
    jdf = P["jdf"](CHAIN, "chain")
    path = str(tmp_path / "mid")
    dc1 = P["LC"]("mydata", shape=(1,), init=lambda k: np.zeros(1))
    with P["Context"]() as ctx:
        tp = jdf.new(mydata=dc1, NB=9)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30)
        P["ck"].save(path, dc1, meta={"completed": 10})
    dc2 = P["LC"]("mydata", shape=(1,), init=lambda k: np.zeros(1))
    assert P["ck"].restore(path, dc2) == 1
    with P["Context"]() as ctx:
        tp = jdf.new(mydata=dc2, NB=9)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30)
    np.testing.assert_array_equal(dc2.data_of(0).newest_copy().payload, 20.0)


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_two_rank_shards_restore_at_one_rank(tmp_path, P):
    """Shards written by a 2-rank layout (each rank's tiles as that rank
    owns them) restore into a single-rank collection: tiles are keyed
    globally."""
    M, MB = 16, 4
    path = str(tmp_path / "elastic")
    for r in range(2):
        A = P["BC"](M, M, MB, MB, p=2, q=1, myrank=r, name="A")
        for (i, j) in A.local_tiles():
            A.data_of(i, j).newest_copy().payload[:] = 100 * i + j
        P["ck"].save(path, A, rank=r)
    assert len(P["ck"].shards_of(path)) == 2
    B = P["BC"](M, M, MB, MB, name="A")
    assert P["ck"].restore(path, B) == 16
    for (i, j) in B.local_tiles():
        np.testing.assert_array_equal(B.data_of(i, j).newest_copy().payload,
                                      100 * i + j)


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_restore_missing(tmp_path, P):
    dc = P["LC"]("D", shape=(1,), init=lambda k: np.zeros(1))
    with pytest.raises(FileNotFoundError):
        P["ck"].restore(str(tmp_path / "nope"), dc)


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_numpy_scalar_keys_and_odd_names(tmp_path, P):
    dc = P["LC"]("we|ird", shape=(2,), init=lambda k: np.zeros(2))
    for k in np.arange(3):  # np.int64 keys
        dc.data_of(k).newest_copy().payload[:] = float(k) + 0.5
    path = str(tmp_path / "npk")
    P["ck"].save(path, dc)
    dc2 = P["LC"]("we|ird", shape=(2,), init=lambda k: np.zeros(2))
    assert P["ck"].restore(path, dc2) == 3
    for k in range(3):
        np.testing.assert_array_equal(dc2.data_of(k).newest_copy().payload, k + 0.5)


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_shard_rank_from_distributed_collection(tmp_path, P):
    """A replicated collection listed first must not decide the shard
    rank (every rank would write rank0 and clobber)."""
    path = str(tmp_path / "mix")
    for r in range(2):
        rep = P["LC"]("rep", shape=(1,), init=lambda k: np.full(1, 7.0))
        rep.data_of(0)
        A = P["BC"](8, 8, 4, 4, p=2, q=1, myrank=r, name="A")
        for (i, j) in A.local_tiles():
            A.data_of(i, j).newest_copy().payload[:] = 10 * i + j
        P["ck"].save(path, rep, A)
    assert len(P["ck"].shards_of(path)) == 2
    B = P["BC"](8, 8, 4, 4, name="A")
    assert P["ck"].restore(path, B) >= 4
    for (i, j) in B.local_tiles():
        np.testing.assert_array_equal(B.data_of(i, j).newest_copy().payload,
                                      10 * i + j)


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_replicated_collection_mode(tmp_path, P):
    path = str(tmp_path / "rep")
    for r in range(2):
        rep = P["LC"]("rep", shape=(2,), nodes=2, myrank=r,
                      init=lambda k: np.zeros(2))
        rep.data_of(0).newest_copy().payload[:] = 5.0 + r
        P["ck"].save(path, rep, rank=r, owned_only=False)
    rep2 = P["LC"]("rep", shape=(2,), nodes=2, myrank=1,
                   init=lambda k: np.zeros(2))
    assert P["ck"].restore(path, rep2, owned_only=False, rank=1) == 1
    np.testing.assert_array_equal(rep2.data_of(0).newest_copy().payload, 6.0)
    with pytest.raises(ValueError, match="needs rank="):
        P["ck"].restore(path, rep2, owned_only=False)


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_duplicate_collection_names_rejected(tmp_path, P):
    a = P["LC"]("A", shape=(1,), init=lambda k: np.zeros(1))
    b = P["LC"]("A", shape=(1,), init=lambda k: np.zeros(1))
    a.data_of(0), b.data_of(0)
    with pytest.raises(ValueError, match="duplicate collection names"):
        P["ck"].save(str(tmp_path / "dup"), a, b)


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref_to_port", "port_to_ref"])
def test_shard_crosses_packages(tmp_path, writer, reader):
    """A shard written by one package restores in the other, tile for
    tile, and the manifests agree."""
    rng = np.random.default_rng(5)
    M = rng.standard_normal((12, 12))
    A = writer["BC"](12, 12, 4, 4, name="A")
    for (i, j) in A.local_tiles():
        A.data_of(i, j).newest_copy().payload[:] = M[4 * i:4 * i + 4, 4 * j:4 * j + 4]
    dc = writer["LC"]("D", shape=(3,), init=lambda k: np.full(3, float(k)))
    for k in range(2):
        dc.data_of(k)
    path = str(tmp_path / "x")
    writer["ck"].save(path, A, dc, meta={"by": "writer"})
    B = reader["BC"](12, 12, 4, 4, name="A")
    dc2 = reader["LC"]("D", shape=(3,), init=lambda k: np.zeros(3))
    assert reader["ck"].restore(path, B, dc2) == 9 + 2
    assert np.array_equal(B.to_array(), M)
    for k in range(2):
        assert np.array_equal(dc2.data_of(k).newest_copy().payload, np.full(3, float(k)))
    assert reader["ck"].manifest(path) == writer["ck"].manifest(path)


def test_save_stages_device_newest_tiles(tmp_path):
    """A dpotrf's tiles are newest on the CUDA module (bound to the torch
    CPU device) before the context detaches: the checkpoint holds the
    device's versions — the factor — not the host copies, which still
    hold the input; restored into a fresh collection in a new context
    they equal the factor the detach writes home."""
    rng = np.random.default_rng(0)
    m = rng.standard_normal((64, 64)).astype(np.float32)
    S = m @ m.T + 64 * np.eye(64, dtype=np.float32)
    A = TiledMatrix(64, 64, 16, 16, name="A", dtype=np.float32).from_array(S)
    path = str(tmp_path / "factor")
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
        tp = cholesky_ptg(use_kernels=True).taskpool(NT=A.mt, A=A)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
        stale = [k for k in A.local_tiles()
                 if A.data_of(*k).newest_copy().device_index != 0]
        assert stale, "the factor's tiles must be device-newest here"
        host_before = {k: np.array(A.data_of(*k).get_copy(0).payload) for k in stale}
        assert ck.save(path, A).endswith(".rank0.npz")
    factor = A.to_array()
    assert any(not np.array_equal(host_before[k], factor[16 * k[0]:16 * k[0] + 16,
                                                          16 * k[1]:16 * k[1] + 16])
               for k in stale)
    B = TiledMatrix(64, 64, 16, 16, name="A", dtype=np.float32)
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu"):
        assert ck.restore(path, B) == len(list(A.local_tiles()))
    assert np.array_equal(B.to_array(), factor)
    L = np.tril(factor).astype(np.float64)
    assert np.abs(L @ L.T - S).max() / np.abs(S).max() < 1e-5


def test_bf16_tile_refused(tmp_path):
    d = LocalCollection("H", shape=(2,))
    d.data_of(0).get_copy(0).payload = torch.ones(2, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        ck.save(str(tmp_path / "bf"), d)
