"""The port's program cache (parsec_tpu_torch.compile_cache) against the JAX
package's executable cache.

* the mirrors of ``tests/class/test_compile_cache.py``: fingerprints miss
  on a shape, dtype, device or program change, track code and closures,
  survive exotic closures; distinct shapes are built separately; the
  in-process hit counters; ``tools cache ls/stats/purge/verify``;
* what the port adds: the LRU bound and ``clear_memory`` (all, or only
  the programs no live user holds) on a cache driven with a stand-in
  builder; ``cache_root`` under the three values of
  ``PARSEC_TPU_COMPILE_CACHE``; a multi-rank cache that keeps every
  program rank-local (``local_only``: a CUDA graph does not serialize);
* parity: ``code_fingerprint`` gives the same digest in both packages for
  plain functions with int, str, tuple and ndarray closures;
* ``GraphExecutor.program_digest`` (the key of a whole-DAG capture) on
  the torch CPU device: equal for two same-shaped dpotrf pools, different
  for another ``NT``, another ``batch_levels`` or another baked constant.
"""

import gc
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from parsec_tpu import compile_cache as ref_cc  # noqa: E402
from parsec_tpu_torch import Context, compile_cache as cc  # noqa: E402
from parsec_tpu_torch import tuning  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.dsl.cuda_graph import GraphExecutor  # noqa: E402
from parsec_tpu_torch.native import LIB_NAME  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg, kernels  # noqa: E402
from parsec_tpu_torch.profiling.tools import main as tools_main  # noqa: E402


def _body(x):
    for i in range(4):
        x = torch.sin(x @ x.T) + i
    return x


# -- fingerprinting ---------------------------------------------------------------

def test_fingerprint_misses_on_shape_dtype_backend_change():
    sig32 = cc.argsig((torch.zeros((8, 8), dtype=torch.float32),))
    sig64 = cc.argsig((torch.zeros((8, 8), dtype=torch.float64),))
    sig_shape = cc.argsig((torch.zeros((16, 8), dtype=torch.float32),))
    key = ("body", "deadbeef")
    base = cc.fingerprint(key, sig32)
    assert cc.fingerprint(key, sig32) == base  # deterministic
    assert cc.fingerprint(key, sig64) != base  # dtype
    assert cc.fingerprint(key, sig_shape) != base  # shape
    assert cc.fingerprint(key, sig32, backend="cuda|NVIDIA H100 80GB HBM3|sm_90") != base
    assert cc.fingerprint(key, sig32, donate=(0,)) != base  # donation
    assert cc.fingerprint(("body", "cafe"), sig32) != base  # program
    # numpy arrays, scalars and nesting sign alike
    assert cc.argsig((np.zeros((8, 8), np.float32), 3, None, (1.5,))) == \
        (("a", (8, 8), "float32"), ("s", "int"), ("none",), ("t", (("s", "float"),)))


def test_platform_names_the_device():
    assert cc._platform("cpu") == "cpu"
    if not torch.cuda.is_available():
        assert cc._platform() == "cpu"
    else:
        name = torch.cuda.get_device_name()
        assert cc._platform().startswith(f"cuda|{name}|sm_")


def test_code_fingerprint_tracks_code_and_closures():
    def mk(k):
        def f(x):
            return x * k
        return f

    assert cc.code_fingerprint(mk(2)) == cc.code_fingerprint(mk(2))
    assert cc.code_fingerprint(mk(2)) != cc.code_fingerprint(mk(3))

    def g(x):
        return x + 1

    def h(x):
        return x + 2

    assert cc.code_fingerprint(g) != cc.code_fingerprint(h)


def test_code_fingerprint_survives_exotic_closures():
    # ufunc dispatchers, modules, arrays, tensors: anything a body closes
    # over must fingerprint, never raise
    arr = np.arange(8.0)
    ten = torch.arange(8.0)

    def f(x):
        return np.sin(arr) + x + ten + os.sep

    fp = cc.code_fingerprint(f)
    assert isinstance(fp, str) and fp
    # a tensor is hashed by its content
    ten2 = torch.arange(8.0) + 1

    def f2(x):
        return x + ten2

    def f3(x):
        return x + ten

    assert cc.code_fingerprint(f2) != cc.code_fingerprint(f3)


def _closing(value):
    def body(x):
        return x, value
    return body


_PLAIN = {
    "int": 7,
    "str": "lower",
    "tuple": (1, "a", (2.5, None)),
    "ndarray": np.arange(12, dtype=np.float32).reshape(3, 4),
    "ndarray_int": np.array([[1, 2], [3, 4]], dtype=np.int64),
    "mixed": (np.ones(3), 3, "s"),
}


@pytest.mark.parametrize("name", sorted(_PLAIN))
def test_code_fingerprint_matches_reference(name):
    """Plain functions closing over ints, strings, tuples and arrays
    fingerprint identically in both packages (the recipe is copied)."""
    body = _closing(_PLAIN[name])
    assert cc.code_fingerprint(body) == ref_cc.code_fingerprint(body)
    assert cc.code_fingerprint(_body) == ref_cc.code_fingerprint(_body)


def test_body_fingerprints_are_memoized_by_weak_key():
    body = _closing(3)
    fp = cc.body_fingerprint(body)
    assert fp == cc.code_fingerprint(body)
    assert body in cc._body_fp_memo
    n = len(cc._body_fp_memo)
    del body
    gc.collect()
    assert len(cc._body_fp_memo) == n - 1  # no id() outlives its body


# -- the cache in one process ---------------------------------------------------------

class _Builder:
    """A stand-in for a capture: counts its builds, returns a program."""

    def __init__(self):
        self.built = 0

    def __call__(self, nbytes=100):
        self.built += 1
        return cc.Program(nbytes)


def _lookup(cache, build, x, key=("body", "t")):
    fp = cc.fingerprint(key, cc.argsig((x,)))
    prog = cache.get(fp)
    if prog is None:
        prog = build()
        cache.put(fp, prog)
    return prog


def test_in_process_hit_and_counters():
    cache, build = cc.ProgramCache(mem_entries=8), _Builder()
    x = torch.ones((8, 8))
    p1 = _lookup(cache, build, x)
    assert cache.stats["misses"] == 1 and cache.stats["captures"] == 1
    assert cache.stats["local_only"] == 1  # nothing serializes
    p2 = _lookup(cache, build, x)
    assert p2 is p1 and build.built == 1
    assert cache.stats["hits_mem"] == cache.hits == 1
    snap = cache.snapshot()
    assert (snap["hits"], snap["misses"], snap["entries"], snap["pool_bytes"]) == (1, 1, 1, 100)


def test_distinct_shapes_build_separately():
    cache, build = cc.ProgramCache(mem_entries=8), _Builder()
    _lookup(cache, build, torch.ones((8, 8)))
    _lookup(cache, build, torch.ones((16, 16)))
    _lookup(cache, build, torch.ones((8, 8), dtype=torch.float64))
    assert cache.stats["misses"] == 3 and build.built == 3 and len(cache) == 3


def test_lru_bound_drops_the_least_recently_used():
    cache, build = cc.ProgramCache(mem_entries=2), _Builder()
    a, b, c = (torch.ones((n, n)) for n in (2, 3, 4))
    pa = _lookup(cache, build, a)
    _lookup(cache, build, b)
    assert _lookup(cache, build, a) is pa  # a is now the most recent
    _lookup(cache, build, c)  # evicts b
    assert len(cache) == 2
    assert _lookup(cache, build, a) is pa
    before = build.built
    _lookup(cache, build, b)
    assert build.built == before + 1


def test_clear_memory_spares_held_programs_when_asked():
    cache, build = cc.ProgramCache(mem_entries=8), _Builder()

    class User:
        pass

    held, free = _lookup(cache, build, torch.ones(2)), _lookup(cache, build, torch.ones(3))
    user = User()
    held.hold(user)
    assert held.held and not free.held
    assert cache.pool_bytes == 200
    assert cache.clear_memory(keep_held=True) == 1
    assert len(cache) == 1 and cache.pool_bytes == 100
    del user
    gc.collect()
    assert not held.held
    assert cache.clear_memory(keep_held=True) == 1 and len(cache) == 0
    _lookup(cache, build, torch.ones(2))
    assert cache.clear_memory() == 1


def test_mem_entries_param_and_the_process_cache():
    from parsec_tpu_torch import mca_param

    assert cc.ProgramCache().mem_entries == 512
    mca_param.set_param("runtime", "compile_cache_mem_entries", 3)
    try:
        assert cc.ProgramCache().mem_entries == 3
    finally:
        mca_param.unset("runtime", "compile_cache_mem_entries")
    assert cc.default_cache() is cc.default_cache()


def test_multi_rank_cache_raises_naming_a8():
    """A multi-rank cache constructs, as the reference's does, and keeps
    its programs rank-local: a put counts ``local_only`` and nothing
    crosses the engine it was given."""
    ce = object()
    mesh = cc.ProgramCache(rank=1, nranks=2, ce=ce)
    assert (mesh.rank, mesh.nranks, mesh.ce) == (1, 2, ce)
    mesh.put("fp", cc.Program())
    assert mesh.get("fp") is not None
    assert mesh.snapshot()["local_only"] == mesh.snapshot()["captures"] == 1
    ctx = Context(nb_cores=1, cuda_device="cpu")
    try:
        assert isinstance(ctx.compile_cache, cc.ProgramCache)
        assert ctx.compile_cache is not cc.default_cache()
    finally:
        ctx.fini()


def test_mesh_caches_capture_once_a_rank():
    """A 4-rank mesh of caches (``ProgramCache(rank=, nranks=4, ce=)`` on
    the in-process fabric, as ``for_context`` builds them for a multi-rank
    context): every rank looks the same program up under the same
    fingerprint, captures it ONCE, and the results are equal; nothing
    crosses the fabric.  This diverges from the reference's
    ``tests/runtime/test_compile_bcast.py``, where one rank compiles and
    broadcasts the serialized program to the other ranks (one compile a
    mesh): a captured CUDA graph does not serialize, so each rank of the
    port captures its own (four captures a mesh) and ``stats["local_only"]``
    counts each."""
    from parsec_tpu_torch.comm import InprocFabric

    n = 4
    ces = InprocFabric(n).endpoints()
    caches = [cc.ProgramCache(rank=r, nranks=n, ce=ces[r]) for r in range(n)]
    x = torch.arange(64.0).reshape(8, 8) / 64
    fps, outs = [], []
    for cache in caches:
        build = _Builder()
        fps.append(cc.fingerprint(("body", cc.code_fingerprint(_body)), cc.argsig((x,)),
                                  backend="cpu"))
        prog = cache.get(fps[-1])
        assert prog is None
        outs.append(_body(x))
        cache.put(fps[-1], build())
        assert cache.get(fps[-1]) is not None
        assert (cache.stats["misses"], cache.stats["captures"], cache.stats["local_only"],
                cache.stats["hits_mem"]) == (1, 1, 1, 1)
    assert len(set(fps)) == 1
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert sum(c.stats["captures"] for c in caches) == n
    assert all(ce.stats["frames_sent"] == 0 for ce in ces)
    for r, ce in enumerate(ces):
        ctx = Context(nb_cores=1, cuda_device="cpu", rank=r, nranks=n, comm=ce)
        try:
            assert (ctx.compile_cache.rank, ctx.compile_cache.nranks,
                    ctx.compile_cache.ce) == (r, n, ce)
        finally:
            ctx.fini()


@pytest.mark.parametrize("value", [None, "0", "", "  ", "DIR"])
def test_cache_root_under_the_switch(monkeypatch, tmp_path, value):
    if value is None:
        monkeypatch.delenv("PARSEC_TPU_COMPILE_CACHE", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path))
        want = os.path.join(str(tmp_path), ".cache", "parsec_tpu_torch")
        # never the JAX package's root: neither reads the other's winners
        assert ref_cc.cache_root() != want
    elif value == "DIR":
        monkeypatch.setenv("PARSEC_TPU_COMPILE_CACHE", str(tmp_path / "c"))
        want = str(tmp_path / "c")
    else:
        monkeypatch.setenv("PARSEC_TPU_COMPILE_CACHE", value)
        want = None
    assert cc.cache_root() == want
    st = tuning.default_store()
    assert st.dir == ("<memory>" if want is None else os.path.join(want, "autotune"))


# -- tools cache ------------------------------------------------------------------

def _fake_build_dir(d):
    """A kernel library under the current tag and one under a stale tag,
    and an engine library newer than its sources (ELF magic only)."""
    d.mkdir()
    current = d / f"{kernels.LIBRARY_PREFIX}{kernels.library_tag()}.so"
    stale = d / f"{kernels.LIBRARY_PREFIX}0000000000000000.so"
    engine = d / LIB_NAME
    for p in (current, stale, engine):
        p.write_bytes(b"\x7fELF" + b"\0" * 60)
    (d / "notes.txt").write_text("not an artifact")
    return current, stale, engine


def test_tools_cache_cli(tmp_path, capsys):
    root, bdir = tmp_path / "root", tmp_path / "build"
    current, stale, engine = _fake_build_dir(bdir)
    st = tuning.TuningStore(str(root / "autotune"))
    st.save(tuning.tune_key("dpotrf", 64, "float32", "cpu", "nb"),
            {"best": 16, "timings_s": {"16": 0.1}})
    args = ["--dir", str(root), "--build-dir", str(bdir)]

    assert tools_main(["cache", "ls", *args]) == 0
    out = capsys.readouterr().out
    assert "3 entries in" in out and "1 tuning entry in" in out
    assert "current" in out and "stale" in out and "notes.txt" not in out
    assert tools_main(["cache", "stats", *args]) == 0
    out = capsys.readouterr().out
    assert "libraries:      3 (1 stale, 0 corrupt)" in out
    assert "tuning entries: 1" in out
    assert tools_main(["cache", "verify", *args]) == 0
    assert "4 ok, 0 corrupt" in capsys.readouterr().out
    # corrupt a library and a tuning document: verify flags, --delete removes
    stale.write_bytes(b"junk")
    (root / "autotune" / "bad.json").write_text("{ not json")
    assert tools_main(["cache", "verify", *args]) == 1
    out = capsys.readouterr().out
    assert "3 ok, 2 corrupt" in out and f"CORRUPT {stale}" in out
    assert tools_main(["cache", "verify", *args, "--delete"]) == 1
    assert tools_main(["cache", "verify", *args]) == 0
    assert not stale.exists() and current.exists()
    # purge --stale keeps the current libraries; purge --tuning drops all
    stale.write_bytes(b"\x7fELF")
    assert tools_main(["cache", "purge", *args, "--stale"]) == 0
    assert not stale.exists() and current.exists() and engine.exists()
    capsys.readouterr()
    assert tools_main(["cache", "purge", *args, "--tuning"]) == 0
    out = capsys.readouterr().out
    assert "purged 2 libraries" in out and "purged 1 tuning entry" in out
    assert not current.exists() and st.entries() == []


# -- GraphExecutor's program key ------------------------------------------------------

def _dpotrf_pool(n=128, nb=32, seed=0, use_kernels=True):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(np.float32)
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(
        m @ m.T + n * np.eye(n, dtype=np.float32))
    return cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=use_kernels).taskpool(
        NT=A.mt, A=A)


def test_same_shaped_pools_share_a_program_digest():
    """Two dpotrf pools of one shape (other data, other PTG definitions)
    key the same program; another NT, another body or batch_levels does
    not.  The CPU device runs eagerly: nothing is cached there."""
    a = GraphExecutor(_dpotrf_pool(seed=0), device="cpu")
    b = GraphExecutor(_dpotrf_pool(seed=1), device="cpu")
    assert a.program_digest == b.program_digest
    assert a._fingerprint([torch.ones(1)]) == b._fingerprint([torch.ones(1)])
    assert GraphExecutor(_dpotrf_pool(n=160), device="cpu").program_digest != a.program_digest
    assert GraphExecutor(_dpotrf_pool(use_kernels=False),
                         device="cpu").program_digest != a.program_digest
    batched = GraphExecutor(_dpotrf_pool(), device="cpu", batch_levels=True)
    assert batched.program_digest != a.program_digest
    assert not a.capture and a.cache is cc.default_cache()
    # on the CPU the plan runs eagerly: nothing went into the cache
    before = cc.default_cache().snapshot()
    feeds = {k: a.taskpool.constants[k[0]].data_of(*k[1]).newest_copy().payload
             for k in a.input_keys}
    out = a.apply(feeds)
    assert cc.default_cache().snapshot() == before and not a.cache_hit
    assert all(torch.isfinite(t).all() for t in out.values())


def test_program_digest_hashes_a_param_by_its_content():
    """A step's params enter the digest by value: a tensor param by its
    full content, not its (truncated) repr."""
    from parsec_tpu_torch.data import LocalCollection
    from parsec_tpu_torch.dsl import PTG
    from parsec_tpu_torch.core.lifecycle import AccessMode

    def pool(table):
        ptg = PTG("p")
        t = ptg.task_class("t", k="0 .. 0")
        t.affinity("D(0)")
        t.flow("X", AccessMode.INOUT, "<- D(0)", "-> D(0)")
        t.use_globals("W")
        t.body(cuda=lambda X, W, **_: X + W[0])
        dc = LocalCollection("D", shape=(4,), init=lambda k: np.zeros(4, np.float32))
        return ptg.taskpool(D=dc, W=table)

    big = np.zeros(5000, np.float32)
    other = big.copy()
    other[2500] = 1.0  # differs where a repr elides
    assert repr(big) == repr(other)
    d1 = GraphExecutor(pool(big), device="cpu").program_digest
    d2 = GraphExecutor(pool(other), device="cpu").program_digest
    assert d1 != d2
    assert GraphExecutor(pool(big.copy()), device="cpu").program_digest == d1
