"""The port's runtime (parsec_tpu_torch) against the JAX package's.

Host-body dpotrf runs the same numpy arithmetic in the same dataflow order
in both packages, so the factors must be bit-identical.  The rest pins the
port's own runtime contracts: failure discipline, the features this slice
leaves out raising instead of being ignored, and import hygiene.
"""

import ast
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu_torch.core.lifecycle import AccessMode  # noqa: E402
from parsec_tpu_torch.datadist import from_numpy_tiles  # noqa: E402
from parsec_tpu_torch.dsl.ptg import PTG  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg, dpotrf_task_count  # noqa: E402

PKG = pathlib.Path(parsec_tpu_torch.__file__).resolve().parent


def _spd(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(dtype)
    return m @ m.T + n * np.eye(n, dtype=dtype)


def _run_ref(A, **kw):
    consts = kw.pop("consts", {})
    tp = ref_cholesky_ptg(use_tpu=False, use_cpu=True, **kw).taskpool(
        NT=A.mt, A=A, **consts)
    with parsec_tpu.Context(nb_cores=2, devices=["cpu"]) as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
    return tp


def _run_port(A, **kw):
    consts = kw.pop("consts", {})
    tp = cholesky_ptg(use_cuda=False, use_cpu=True, **kw).taskpool(
        NT=A.mt, A=A, **consts)
    with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
        assert [d.mca_name for d in ctx.devices] == ["cpu"]
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
        executed = ctx.devices[0].stats["executed_tasks"]
    return tp, executed


@pytest.mark.parametrize("trtri", [False, True])
def test_host_dpotrf_bit_identical_to_reference(trtri):
    n, nb = 96, 32
    S = _spd(n)
    kw = dict(use_trtri=trtri)
    if trtri:
        kw["consts"] = dict(TILE_SHAPE=(nb, nb), TILE_DTYPE=np.float64)
    ref_A = RefTiledMatrix(n, n, nb, nb, name="A", dtype=S.dtype).from_array(S)
    # the port's matrix is built from the reference's numpy tile payloads:
    # the state carried across
    A = from_numpy_tiles(_payloads(ref_A), nb, nb)
    ref_tp = _run_ref(ref_A, **dict(kw))
    tp, executed = _run_port(A, **dict(kw))
    np.testing.assert_array_equal(A.to_array(), ref_A.to_array())
    nt = A.mt
    assert tp.nb_retired == ref_tp.nb_retired == executed == \
        dpotrf_task_count(nt, use_trtri=trtri)


def test_run_cholesky_host_only():
    from parsec_tpu_torch.ops import run_cholesky

    n, nb = 96, 32
    S = _spd(n, seed=2)
    A = from_numpy_tiles(_payloads(RefTiledMatrix(n, n, nb, nb).from_array(S)), nb, nb)
    with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
        run_cholesky(ctx, A, use_cuda=False, use_trtri=True)
    np.testing.assert_allclose(np.tril(A.to_array()), np.linalg.cholesky(S),
                               rtol=1e-10, atol=1e-10)


def _payloads(ref_A):
    return {k: ref_A.data_of(*k).newest_copy().payload for k in ref_A.tiles()}


def test_from_numpy_tiles_round_trip_and_copies():
    S = _spd(80, seed=1)
    tiles = _payloads(RefTiledMatrix(80, 80, 32, 32).from_array(S))  # ragged edge of 16
    A = from_numpy_tiles(tiles, 32, 32)
    assert (A.m, A.n, A.mt, A.nt) == (80, 80, 3, 3)
    np.testing.assert_array_equal(A.to_array(), S)
    A.data_of(0, 0).newest_copy().payload[0, 0] = -1.0
    assert tiles[(0, 0)][0, 0] == S[0, 0]  # the runtime owns private copies
    with pytest.raises(ValueError, match="shape"):
        from_numpy_tiles({(0, 0): np.zeros((32, 32)), (1, 0): np.zeros((5, 31))}, 32, 32)


def _chain(pkg, pkg_ptg, collection, n=8):
    ptg = pkg_ptg("chain")
    s = ptg.task_class("s", k=f"0 .. {n - 1}")
    s.affinity("D(0)")
    s.flow("X", pkg.AccessMode.INOUT,
           "<- (k == 0) ? D(0) : X s(k-1)",
           f"-> (k < {n - 1}) ? X s(k+1) : D(0)")

    def body(X, k):
        X *= 2.0
        X += k

    s.body(cpu=body)
    return ptg.taskpool(D=collection)


def test_ptg_chain_matches_reference():
    from parsec_tpu.data import LocalCollection as RefLocal
    from parsec_tpu.dsl.ptg import PTG as RefPTG
    from parsec_tpu_torch.data import LocalCollection

    init = lambda k: np.ones(4)  # noqa: E731
    out = []
    for pkg, ptg_cls, coll in ((parsec_tpu, RefPTG, RefLocal),
                               (parsec_tpu_torch, PTG, LocalCollection)):
        dc = coll("D", shape=(4,), init=init)
        tp = _chain(pkg, ptg_cls, dc)
        with pkg.Context(nb_cores=3, devices=["cpu"]) as ctx:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=30)
        out.append((dc.data_of(0).newest_copy().payload.copy(), tp.nb_retired))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1] == 8


def test_raising_body_fails_the_pool():
    from parsec_tpu_torch.data import LocalCollection

    ptg = PTG("boom")
    s = ptg.task_class("s", k="0 .. 3")
    s.flow("X", AccessMode.INOUT, "<- (k == 0) ? D(0) : X s(k-1)",
           "-> (k < 3) ? X s(k+1) : D(0)")

    def body(X, k):
        if k == 2:
            raise ValueError("boom")

    s.body(cpu=body)
    tp = ptg.taskpool(D=LocalCollection("D", shape=(2,)))
    with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30) is False
        assert tp.failed and "boom" in tp.fail_reason
        assert ctx.test()  # the pool left the active set


@pytest.mark.parametrize("feature", ["verify", "reshape", "comm", "env"])
def test_unported_features_raise(feature, monkeypatch):
    from parsec_tpu_torch.data import LocalCollection

    if feature in ("comm", "env"):
        if feature == "env":
            monkeypatch.setenv("PARSEC_TPU_WATCHDOG", "1")
            kw = {}
        else:
            kw = dict(nranks=2, rank=0)
        with pytest.raises(NotImplementedError,
                           match="ROADMAP A.9" if feature == "env" else "ROADMAP A.8"):
            parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"], **kw)
        return
    ptg = PTG("p")
    s = ptg.task_class("s", k="0 .. 1")
    dep = "<- D(0) [type=F32]" if feature == "reshape" else "<- D(0)"
    s.flow("X", AccessMode.IN, dep)
    s.body(cpu=lambda X, k: None)
    if feature == "verify":
        with pytest.raises(NotImplementedError, match="ROADMAP A.9"):
            ptg.verify()
        return
    tp = ptg.taskpool(D=LocalCollection("D", shape=(2,)), F32=np.float32)
    with parsec_tpu_torch.Context(nb_cores=1, devices=["cpu"]) as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=30) is False  # the raising prepare_input fails it
    assert "reshape" in tp.fail_reason and "A.8" in tp.fail_reason


# ml_dtypes: the card's machine lacks it (bfloat16 host tiles are torch
# tensors instead)
_FORBIDDEN = {"jax", "jaxlib", "parsec_tpu", "ml_dtypes"}


def test_port_imports_neither_jax_nor_the_jax_package():
    offenders = []
    # _build/ is gitignored build output, not package source; chip_smoke.py
    # drives the port on the card and is held to the same rule
    sources = [p for p in sorted(PKG.rglob("*.py"))
               if "_build" not in p.relative_to(PKG).parts]
    sources.append(PKG.parent / "chip_smoke.py")
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in _FORBIDDEN:
                    offenders.append(f"{path.relative_to(PKG.parent)}:{node.lineno} {name}")
    assert not offenders, offenders
    assert len(sources) > 20  # the walk saw the package
