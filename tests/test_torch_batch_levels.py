"""Level-batched whole-DAG replay (``GraphExecutor(batch_levels=True)``)
and the batch axis of the B1, B2, B3 and B5 kernel wrappers, against the
JAX package's ``GraphExecutor(batch_levels=True)``.

The port runs on the torch CPU device (``device="cpu"``: the plan runs
eagerly, each group of a level as one ``torch.func.vmap`` of its body, the
kernel wrappers' custom ops taking their batched plain versions); the
reference runs on JAX's CPU backend, its Pallas kernels in interpret mode
where ``use_pallas`` asks for them.  Each result is held to the reference
test's tolerance (``tests/dsl/test_xla_lower.py:152-192``,
``tests/collections/test_qr.py:56-64``).  The batched launches themselves
run only on a card: ``chip_smoke.py`` holds each bit for bit to its
members launched one by one.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from parsec_tpu.data import LocalCollection as RefLocalCollection  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.dsl.ptg import PTG as RefPTG  # noqa: E402
from parsec_tpu.dsl.xla_lower import GraphExecutor as RefGraphExecutor  # noqa: E402
from parsec_tpu.ops import attention as ref_attention  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu.ops import qr as ref_qr  # noqa: E402
from parsec_tpu.ops import stencil as ref_stencil  # noqa: E402
from parsec_tpu_torch import AccessMode  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.dsl import PTG, GraphExecutor  # noqa: E402
from parsec_tpu_torch.ops import attention, cholesky_ptg, kernels, lu, qr, stencil  # noqa: E402

IN, INOUT = AccessMode.IN, AccessMode.INOUT


def _spd(n, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(dtype)
    return m @ m.T + n * np.eye(n, dtype=dtype)


def _cholesky(n, nb, dtype, seed, port_kw, ref_kw, **ex_kw):
    """(port L, reference L, S): dpotrf through both executors with
    ``batch_levels=True`` (the port's ``ex_kw`` may turn it off)."""
    S = _spd(n, dtype, seed)
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=dtype).from_array(S)
    ex = GraphExecutor(cholesky_ptg(use_cpu=False, **port_kw).taskpool(NT=A.mt, A=A),
                       device="cpu", **{"batch_levels": True, **ex_kw})
    ex(block=True)
    rA = RefTiledMatrix(n, n, nb, nb, name="A", dtype=dtype).from_array(S)
    RefGraphExecutor(ref_cholesky_ptg(use_tpu=True, use_cpu=False, **ref_kw).taskpool(
        NT=rA.mt, A=rA), batch_levels=True)(block=True)
    return np.tril(A.to_array()), np.tril(rA.to_array()), S, ex


# -- mirrors of tests/dsl/test_xla_lower.py:152-192 ------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
def test_batched_levels_cholesky_matches(use_kernels):
    """NT=5 (non-trivial levels, uniform tiles): L L^T = S at the reference
    test's 2e-3, within it of the JAX executor's batched factor and of the
    port's own unbatched replay; the B1 groups ran as one call each."""
    kernels.reset_counts()
    L, rL, S, ex = _cholesky(160, 32, np.float32, 7, dict(use_kernels=use_kernels),
                             dict(use_pallas=use_kernels))
    np.testing.assert_allclose(L @ L.T, S, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(L, rL, rtol=2e-3, atol=2e-3)
    assert ex.batch_fallbacks == 0
    groups = ex.group_counts()
    if use_kernels:
        # one wrapper call a group: the batched groups and the singletons
        want = sum(groups[c]["batched"] + groups[c]["per_task"] for c in ("syrk", "gemm"))
        assert kernels.matmul_update.calls == want < 20
    L1, _rL, _S, _ex = _cholesky(160, 32, np.float32, 7, dict(use_kernels=use_kernels),
                                 dict(use_pallas=use_kernels), batch_levels=False)
    np.testing.assert_allclose(L, L1, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_batched_levels_stencil_matches(use_kernels):
    """32 x 32 in 4 x 4 tiles, 4 steps: the reference test's 1e-5 against
    the dense model and the JAX executor; the B3 groups (the plain body's
    elementwise ops likewise) bit for bit the unbatched replay's."""
    grid = np.random.default_rng(8).standard_normal((32, 32)).astype(np.float32)
    outs = []
    for batch in (True, False):
        A = stencil.StencilBuffers(grid, 4, 4)
        tp = stencil.stencil_ptg(use_cpu=False, use_kernels=use_kernels).taskpool(
            T=4, MT=4, NT=4, A=A)
        ex = GraphExecutor(tp, device="cpu", batch_levels=batch)
        ex(block=True)
        outs.append(A.to_array(0))
        if batch:
            assert ex.batch_fallbacks == 0
    want = ref_stencil.reference_stencil(grid, 4)
    np.testing.assert_allclose(outs[0], want, rtol=1e-5, atol=1e-5)
    rA = ref_stencil.StencilBuffers(grid, 4, 4)
    RefGraphExecutor(ref_stencil.stencil_ptg(use_tpu=True, use_cpu=False).taskpool(
        T=4, MT=4, NT=4, A=rA), batch_levels=True)(block=True)
    np.testing.assert_allclose(outs[0], rA.to_array(0), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_batched_levels_ragged_tiles_fall_back():
    """112 = 3 x 32 + 16: ragged edge tiles split the groups by shape and
    the float64 factor stays at the reference test's 1e-8."""
    L, rL, S, ex = _cholesky(112, 32, np.float64, 9, {}, {})
    np.testing.assert_allclose(L @ L.T, S, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(L, rL, rtol=1e-8, atol=1e-8)
    # a level's full and edge tiles are different groups: none is ragged
    assert ex.batch_fallbacks == 0
    for groups in ex._groups:
        for g in groups:
            assert len({step.tid[0] for step in g.steps}) == 1


# -- mirror of tests/collections/test_qr.py:56-64 --------------------------------

def _check_r(A, R, rtol):
    """tests/collections/test_qr.py's check: R upper triangular, A^T A =
    R^T R, R equal to numpy's up to the signs of its rows."""
    np.testing.assert_allclose(np.tril(R, -1), 0, atol=1e-10 * max(1, np.abs(R).max()))
    np.testing.assert_allclose(R.T @ R, A.T @ A, rtol=rtol, atol=rtol * np.abs(A.T @ A).max())
    R_np = np.linalg.qr(A, mode="r")
    s_ours, s_np = np.sign(np.diag(R)), np.sign(np.diag(R_np))
    np.testing.assert_allclose(s_ours[:, None] * R, s_np[:, None] * R_np,
                               rtol=rtol, atol=rtol * np.abs(R_np).max())


@pytest.mark.parametrize("use_kernels", [False, True])
def test_qr_graph_batched_levels(use_kernels):
    """Tiled QR, NT=5, level-batched: R at the reference test's 5e-3 and
    within it of the JAX executor's (tsqrt groups are batched library
    QRs, unmqr/tsmqr B2 groups with ``use_kernels``)."""
    n, nb = 160, 32
    A0 = np.random.default_rng(8).standard_normal((n, n)).astype(np.float32)
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(A0)
    ex = GraphExecutor(qr.qr_ptg(use_cpu=False, use_kernels=use_kernels).taskpool(
        NT=A.mt, A=A, **qr.qr_constants(A)), device="cpu", batch_levels=True)
    ex(block=True)
    R = A.to_array()
    _check_r(A0, R, rtol=5e-3)
    rA = RefTiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(A0)
    RefGraphExecutor(ref_qr.qr_ptg(use_tpu=True, use_cpu=False).taskpool(
        NT=rA.mt, A=rA, TILE_SHAPE=(nb, nb), TILE_DTYPE=np.float32,
        QSHAPE2=(np.float32, (2 * nb, 2 * nb))), batch_levels=True)(block=True)
    rR = rA.to_array()
    s, rs = np.sign(np.diag(R)), np.sign(np.diag(rR))
    np.testing.assert_allclose(s[:, None] * R, rs[:, None] * rR, rtol=5e-3,
                               atol=5e-3 * np.abs(rR).max())
    assert ex.batch_fallbacks == 0
    groups = ex.group_counts()
    assert groups["tsmqr"]["batched"] > 0 and groups["tsqrt"]["batched"] > 0


# -- differing params: the chain and its parallel form ---------------------------

def _chain(ptg_cls, coll_cls, lib):
    dc = coll_cls("D", shape=(4,), init=lambda k: np.zeros(4))
    ptg = ptg_cls("chain")
    s = ptg.task_class("s", k="0 .. 7")
    s.affinity("D(0)")
    s.flow("X", INOUT,
           "<- (k == 0) ? D(0) : X s(k-1)",
           "-> (k < 7) ? X s(k+1) : D(0)")
    s.body(**{lib: lambda X, k: X + k})
    return ptg.taskpool(D=dc)


def _fan(ptg_cls, coll_cls, lib, body=None):
    """Eight independent tasks, s(k) adds k to D(k): one level, one group,
    its param k differing member to member."""
    dc = coll_cls("D", shape=(4,), init=lambda k: np.full(4, float(k[0])))
    ptg = ptg_cls("fan")
    s = ptg.task_class("s", k="0 .. 7")
    s.affinity("D(k)")
    s.flow("X", INOUT, "<- D(k)", "-> D(k)")
    s.body(**{lib: body or (lambda X, k: X + k)})
    return ptg.taskpool(D=dc)


@pytest.mark.parametrize("dag", ["chain", "fan"])
def test_differing_param_k_matches_reference(dag):
    """The chain (eight singleton levels) and its parallel form (one group
    of eight, k stacked on the device and vmapped): equal to the JAX
    executor's."""
    make = {"chain": _chain, "fan": _fan}[dag]
    feeds = {("D", (0,)): np.ones(4)} if dag == "chain" else {
        ("D", (k,)): np.full(4, float(k)) for k in range(8)}
    ex = GraphExecutor(make(PTG, LocalCollection, "cuda"), device="cpu", batch_levels=True)
    out = ex.apply({key: torch.from_numpy(v) for key, v in feeds.items()})
    ref = RefGraphExecutor(make(RefPTG, RefLocalCollection, "tpu"),
                           batch_levels=True).apply(
        {key: jax.numpy.asarray(v) for key, v in feeds.items()})
    assert set(out) == set(ref)
    for key in out:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]))
    counts = ex.group_counts()["s"]
    assert counts == ({"batched": 0, "members": 0, "per_task": 8} if dag == "chain"
                      else {"batched": 1, "members": 8, "per_task": 0})
    if dag == "fan":
        np.testing.assert_allclose(out[("D", (5,))].numpy(), 10.0)


# -- the causal prefill ------------------------------------------------------------

def test_batched_levels_causal_prefill_matches_reference():
    """Causal prefill, 4 heads x 4 query blocks: every (head, q block) step
    at one key block is one B5 call over the members' own q offsets; the
    output within 2e-5 of the JAX executor's and of the unbatched replay."""
    rng = np.random.default_rng(9)
    qkv = [rng.standard_normal((1, 64, 4, 8)).astype(np.float32) for _ in range(3)]
    outs = []
    for batch in (True, False):
        tp, assemble = attention.build_flash_attention(*qkv, causal=True, q_block=16,
                                                       kv_block=16, use_cpu=False)
        kernels.reset_counts()
        ex = GraphExecutor(tp, device="cpu", batch_levels=batch)
        ex(block=True)
        outs.append(assemble().numpy())
        if batch:
            groups = ex.group_counts()["attn_step"]
            assert kernels.flash_attention_block.calls == groups["batched"] + \
                groups["per_task"] == 4
            assert ex.batch_fallbacks == 0
    rtp, rassemble = ref_attention.build_flash_attention(*qkv, causal=True, q_block=16,
                                                         kv_block=16, use_cpu=False)
    RefGraphExecutor(rtp, batch_levels=True)(block=True)
    np.testing.assert_allclose(outs[0], np.asarray(rassemble()), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-5, atol=2e-5)


# -- the level plan ----------------------------------------------------------------

def _plan_cases():
    S = _spd(160, np.float32, 7)
    grid = np.random.default_rng(1).standard_normal((36, 36))
    rng = np.random.default_rng(9)
    qkv = [rng.standard_normal((1, 64, 2, 8)).astype(np.float32) for _ in range(3)]
    return {
        "dpotrf": (lambda: cholesky_ptg(use_cpu=False).taskpool(
            NT=5, A=TiledMatrix(160, 160, 32, 32, name="A", dtype=np.float32).from_array(S)),
                   lambda: ref_cholesky_ptg(use_cpu=False).taskpool(
            NT=5, A=RefTiledMatrix(160, 160, 32, 32, name="A",
                                   dtype=np.float32).from_array(S))),
        "stencil": (lambda: stencil.stencil_ptg(use_cpu=False).taskpool(
            T=3, MT=3, NT=3, A=stencil.StencilBuffers(grid, 3, 3)),
                    lambda: ref_stencil.stencil_ptg(use_tpu=True, use_cpu=False).taskpool(
            T=3, MT=3, NT=3, A=ref_stencil.StencilBuffers(grid, 3, 3))),
        "prefill": (lambda: attention.build_flash_attention(
            *qkv, causal=True, q_block=16, kv_block=8, use_cpu=False)[0],
                    lambda: ref_attention.build_flash_attention(
            *qkv, causal=True, q_block=16, kv_block=8, use_cpu=False)[0]),
    }


@pytest.mark.parametrize("case", ["dpotrf", "stencil", "prefill"])
def test_level_plan_equals_reference(case):
    """Each level holds the reference's ``_level_plan`` tasks (longest path
    from a source), in the same order."""
    mine, ref = _plan_cases()[case]
    ex = GraphExecutor(mine(), device="cpu", batch_levels=True)
    rex = RefGraphExecutor(ref(), batch_levels=True, jit=False)
    got = [[step.tid for step in level] for level in ex._level_plan]
    want = [[step.tid for step in level] for level in rex._level_plan]
    assert got == want
    assert sum(map(len, got)) == len(ex._plan)


# -- the vmap rules of the kernel wrappers -------------------------------------------
# each batched call is held against its members called one by one and
# stacked: on the CPU a batched matmul need not round as the member's does
# (float32: rtol and atol 1e-5; bfloat16 operands with f32 accumulation the
# same); B3's batched plain version is elementwise and exact

_N = 5


def _rand(seed, *shape, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


@pytest.mark.parametrize("mode", ["f32", "bf16", "split"])
@pytest.mark.parametrize("transpose_b", [True, False])
@pytest.mark.parametrize("shared", ["none", "C", "B"])
def test_vmap_matmul_update_rule(mode, transpose_b, shared):
    """B1 under vmap: one call for the members, stride-0 shared operands."""
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    m, n, k = 12, 10, 8
    C = _rand(1, _N, m, n)
    A = _rand(2, _N, m, k, dtype=dt)
    B = _rand(3, _N, *((n, k) if transpose_b else (k, n)), dtype=dt)
    in_dims = (None if shared == "C" else 0, 0, None if shared == "B" else 0)
    args = tuple(t[0] if d is None else t for t, d in zip((C, A, B), in_dims))
    kw = dict(alpha=-0.5, transpose_b=transpose_b, split_f32=mode == "split")
    kernels.reset_counts()
    out = torch.func.vmap(lambda c, a, b: kernels.matmul_update(c, a, b, **kw),
                          in_dims=in_dims)(*args)
    assert kernels.matmul_update.calls == 1
    want = torch.stack([kernels.matmul_update(*(t if d is None else t[i]
                                                for t, d in zip(args, in_dims)), **kw)
                        for i in range(_N)])
    assert out.shape == (_N, m, n)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transpose_b", [True, False])
def test_vmap_matmul_rule_with_a_shared_operand(dtype, transpose_b):
    """B2 under vmap: A stacked (the trsm-as-product tiles), B shared (the
    level's one inverse) with batch stride 0."""
    A = _rand(4, _N, 9, 6, dtype=dtype)
    B = _rand(5, *((7, 6) if transpose_b else (6, 7)), dtype=dtype)
    kernels.reset_counts()
    out = torch.func.vmap(lambda a: kernels.matmul(a, B, transpose_b=transpose_b))(A)
    assert kernels.matmul.calls == 1 and out.dtype == dtype
    want = torch.stack([kernels.matmul(A[i], B, transpose_b=transpose_b) for i in range(_N)])
    torch.testing.assert_close(out.float(), want.float(), rtol=1e-5, atol=1e-5)


def test_vmap_stencil_rule_strided_halos_and_shared_zeros():
    """B3 under vmap as the stencil body calls it: halo rows and columns
    strided views of stacked neighbour tiles, absent halos unbatched
    zeros made inside the body; exactly the members' steps."""
    h, w = 6, 10
    old, nbr = _rand(6, _N, h, w), _rand(7, _N, h, w)

    def body(OLD, NBR):
        zeros = lambda shape: torch.zeros(shape, dtype=OLD.dtype)  # noqa: E731
        return kernels.stencil_5pt(OLD, NBR[-1:, :], zeros((1, w)), NBR[:, -1:],
                                   zeros((h, 1)))

    kernels.reset_counts()
    out = torch.func.vmap(body)(old, nbr)
    assert kernels.stencil_5pt.calls == 1
    want = torch.stack([body(old[i], nbr[i]) for i in range(_N)])
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vmap_attention_rule_member_offsets_and_a_masked_member(dtype):
    """B5 under vmap: k and v shared, each member's q offset a stacked
    tensor (member 0 fully masked: its carry comes back exactly), k
    offset a Python int."""
    sq, sk, d = 4, 8, 16
    q = _rand(8, _N, sq, d, dtype=dtype)
    k, v = _rand(9, sk, d, dtype=dtype), _rand(10, sk, d, dtype=dtype)
    acc, m, l = _rand(11, _N, sq, d), _rand(12, _N, sq, 1), _rand(13, _N, sq, 1).abs()

    def step(Q, ACC, M, L, i):
        return kernels.flash_attention_block(Q, k, v, ACC, M, L, 2 + i * 4, 8,
                                             causal=True, scale=0.3)

    kernels.reset_counts()
    out = torch.func.vmap(step)(q, acc, m, l, torch.arange(_N))
    assert kernels.flash_attention_block.calls == 1
    want = [step(q[i], acc[i], m[i], l[i], i) for i in range(_N)]
    for got, members in zip(out, zip(*want)):
        torch.testing.assert_close(got, torch.stack(members), rtol=1e-5, atol=1e-5)
    # rows 2..5 all before key 8: member 0 keeps its carry bit for bit
    for got, carry in zip(out, (acc, m, l)):
        assert torch.equal(got[0], carry[0])


def test_wrappers_enter_their_ops_only_under_vmap(monkeypatch):
    """Per-task calls never reach the custom ops (no op dispatch on the
    dynamic, pump, wave and fusion paths); a vmapped call does."""
    entered = []
    for name in ("_matmul_update_op", "_matmul_op", "_stencil_5pt_op", "_flash_op"):
        op = getattr(kernels, name)
        monkeypatch.setattr(kernels, name,
                            lambda *a, _op=op, _n=name: entered.append(_n) or _op(*a))
    C, A = _rand(1, 4, 4), _rand(2, 4, 4)
    kernels.matmul_update(C, A, A)
    kernels.matmul(A, A)
    assert entered == []
    torch.func.vmap(lambda a: kernels.matmul(a, A))(_rand(3, 2, 4, 4))
    assert entered == ["_matmul_op"]


def test_batched_launch_counts_round_trip_through_a_capture_delta():
    """A batched launch counts once under its ``_b`` mode and its members
    apart; :func:`launch_counts` carries both, so a capture's take-back and
    a replay's add move them as the card ran them."""
    kernels.reset_counts()
    kernels._count_mode(kernels.matmul_update, "f32_b", 7)
    delta = kernels.launch_counts()
    assert delta[("matmul_update", "members")] == 7
    assert delta[("matmul_update", "f32_b")] == delta[("matmul_update", "total")] == 1
    kernels.add_launches(delta, -1)
    assert kernels.matmul_update.launches == kernels.matmul_update.members == 0
    kernels.add_launches(delta, 3)
    assert (kernels.matmul_update.launches, kernels.matmul_update.members) == (3, 21)
    assert kernels.matmul_update.launches_by_mode["f32_b"] == 3
    kernels.reset_counts()
    assert kernels.matmul_update.members == 0


# -- fallback, propagation and the warm-up's decisions ---------------------------------

def test_body_branching_on_a_differing_param_falls_back_per_task():
    """``if k > 3`` on the stacked k cannot be vmapped: the group runs per
    task, counts one fallback, and gives the unbatched executor's output."""
    def body(X, k):
        return X + (2 * k if k > 3 else k)

    outs = []
    for batch in (True, False):
        ex = GraphExecutor(_fan(PTG, LocalCollection, "cuda", body), device="cpu",
                           batch_levels=batch)
        outs.append(ex.apply({("D", (k,)): torch.full((4,), float(k)) for k in range(8)}))
    assert ex.batch_fallbacks == 0
    ex_b = GraphExecutor(_fan(PTG, LocalCollection, "cuda", body), device="cpu",
                         batch_levels=True)
    out = ex_b.apply({("D", (k,)): torch.full((4,), float(k)) for k in range(8)})
    assert ex_b.batch_fallbacks == 1
    assert ex_b.group_counts()["s"] == {"batched": 0, "members": 0, "per_task": 8}
    for key in outs[1]:
        assert torch.equal(outs[0][key], outs[1][key]) and torch.equal(out[key], outs[1][key])
    np.testing.assert_allclose(out[("D", (5,))].numpy(), 15.0)


def test_runtime_error_in_a_body_propagates_and_is_not_counted():
    """A body's own RuntimeError (as a failed kernel launch raises) is no
    sign of an unvmappable body: it propagates, nothing falls back."""
    def body(X, k):
        raise RuntimeError("kernel launch failed: cudaError 700")

    ex = GraphExecutor(_fan(PTG, LocalCollection, "cuda", body), device="cpu",
                       batch_levels=True)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        ex.apply({("D", (k,)): torch.zeros(4) for k in range(8)})
    assert ex.batch_fallbacks == 0


def test_later_runs_repeat_the_first_runs_group_decisions():
    """The warm-up decides; the capture (every later run) repeats: a group
    that fell back is not tried under vmap again, a batched one is not
    re-bucketed, and the fallback is counted once."""
    calls = {"batched": 0, "total": 0}

    def body(X, k):
        calls["total"] += 1
        calls["batched"] += kernels._vmapping()
        return X + (2 * k if k > 3 else k)

    ex = GraphExecutor(_fan(PTG, LocalCollection, "cuda", body), device="cpu",
                       batch_levels=True)
    feeds = {("D", (k,)): torch.full((4,), float(k)) for k in range(8)}
    first = ex.apply(feeds)
    assert calls == {"batched": 1, "total": 9}  # the refused vmap, then 8 tasks
    groups = ex._groups
    second = ex.apply(feeds)
    assert calls == {"batched": 1, "total": 17}
    assert ex._groups is groups and ex.batch_fallbacks == 1
    for key in first:
        assert torch.equal(first[key], second[key])


def test_donating_bodies_join_no_group():
    """A body marked ``_donate_args`` (in place on the card) runs per task,
    as it joins no wave and no region."""
    def body(X, k):
        return X + k

    body._donate_args = (0,)
    ex = GraphExecutor(_fan(PTG, LocalCollection, "cuda", body), device="cpu",
                       batch_levels=True)
    out = ex.apply({("D", (k,)): torch.zeros(4) for k in range(8)})
    assert ex.group_counts()["s"] == {"batched": 0, "members": 0, "per_task": 8}
    np.testing.assert_allclose(out[("D", (3,))].numpy(), 3.0)


def test_member_stacks_reuse_the_previous_levels_output():
    """A group whose members are, in order, one earlier group's outputs
    takes that stack as it is: only the stencil's first step and the halo
    flows are copied."""
    grid = np.random.default_rng(3).standard_normal((16, 16)).astype(np.float32)
    tp = stencil.stencil_ptg(use_cpu=False, use_kernels=True).taskpool(
        T=3, MT=2, NT=2, A=stencil.StencilBuffers(grid, 2, 2))
    ex = GraphExecutor(tp, device="cpu", batch_levels=True)
    ex(block=True)
    # 2 x 2 tiles: every tile is a corner, each its own group; nothing stacks
    assert ex.stack_bytes == 0
    outs = []
    for batch in (True, False):
        A = stencil.StencilBuffers(grid, 4, 1)
        tp = stencil.stencil_ptg(use_cpu=False, use_kernels=True).taskpool(T=3, MT=4, NT=1, A=A)
        ex = GraphExecutor(tp, device="cpu", batch_levels=batch)
        ex(block=True)
        outs.append(A.to_array(1))
        if batch:
            stacked = ex.stack_bytes
    # 4 x 1 tiles: the two middle tiles are one group a step, four array
    # flows (OLD, UP, DOWN, NEW) of two 4 x 16 float32 tiles; a step whose
    # members come in the order of the step before takes their stack
    no_reuse = 3 * 4 * 2 * (4 * 16 * 4)
    assert no_reuse - stacked in range(2 * 4 * 16 * 4, no_reuse, 2 * 4 * 16 * 4)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_program_digest_keys_the_batch_levels_flag():
    """The reference keys its program by ``batch_levels``
    (``xla_lower.py:295``); the port's digest does too."""
    tp = _fan(PTG, LocalCollection, "cuda")
    assert GraphExecutor(tp, device="cpu").program_digest != \
        GraphExecutor(tp, device="cpu", batch_levels=True).program_digest


def _largest_groups(ex):
    """Per class, the most members of one batched group."""
    out = {}
    for groups in ex._groups:
        for g in groups:
            if g.kind == "batch":
                cls = g.steps[0].tid[0]
                out[cls] = max(out.get(cls, 0), len(g.steps))
    return out


def test_chip_smoke_batch_sizes_are_the_paths_largest_groups():
    """``chip_smoke.py`` times each batched kernel at the largest group a
    path makes: at its tile counts (dpotrf and tiled LU/QR 16 x 16 tiles,
    the stencil 8 x 8, the prefill 32 heads x 8 query blocks) the plans'
    largest groups are 105 dpotrf gemms, 15 trsms, 225 LU gemms, 65 QR
    tsmqrs, 36 stencil steps and 256 prefill steps.  Tiles are cut to 2 x
    2 here: grouping depends on the tile counts only."""
    nt, nb = 16, 2
    n = nt * nb
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(_spd(n, np.float32, 1))
    ex = GraphExecutor(cholesky_ptg(use_cpu=False, use_kernels=True, use_trtri=True).taskpool(
        NT=nt, A=A), device="cpu", batch_levels=True)
    ex()
    assert {c: _largest_groups(ex)[c] for c in ("gemm", "syrk", "trsm")} == \
        {"gemm": 105, "syrk": 15, "trsm": 15}
    D = (np.random.default_rng(2).standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(D)
    ex = GraphExecutor(lu.lu_ptg(use_cpu=False, use_kernels=True).taskpool(NT=nt, A=A),
                       device="cpu", batch_levels=True)
    ex()
    assert _largest_groups(ex)["gemm"] == 225
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(D)
    ex = GraphExecutor(qr.qr_ptg(use_cpu=False, use_kernels=True).taskpool(
        NT=nt, A=A, **qr.qr_constants(A)), device="cpu", batch_levels=True)
    ex()
    assert {c: _largest_groups(ex)[c] for c in ("tsmqr", "unmqr")} == {"tsmqr": 65, "unmqr": 15}
    grid = np.random.default_rng(3).standard_normal((16, 16)).astype(np.float32)
    ex = GraphExecutor(stencil.stencil_ptg(use_cpu=False, use_kernels=True).taskpool(
        T=2, MT=8, NT=8, A=stencil.StencilBuffers(grid, 8, 8)), device="cpu",
        batch_levels=True)
    ex()
    assert _largest_groups(ex)["stencil"] == 36
    qkv = [np.random.default_rng(4 + i).standard_normal((1, 16, 32, 2)).astype(np.float32)
           for i in range(3)]
    ex = GraphExecutor(attention.build_flash_attention(
        *qkv, causal=True, q_block=2, kv_block=2, use_cpu=False)[0], device="cpu",
        batch_levels=True)
    ex()
    assert _largest_groups(ex)["attn_step"] == 256
    assert ex.group_counts()["attn_step"] == {"batched": 8, "members": 1152, "per_task": 0}
