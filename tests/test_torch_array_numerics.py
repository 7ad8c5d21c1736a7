"""Numerics of the port's array front end (parsec_tpu_torch.array) against
the JAX package's (parsec_tpu.array) and numpy oracles: the one-rank
cases of the reference's ``tests/array/test_numerics.py``.

Both packages get the same numpy inputs from a seed.  Host-body runs
(``use_cuda=False`` / ``use_tpu=False``) are the same numpy in the same
order, so the port's results are bit-identical to the JAX package's.  The
port's device bodies run on the CUDA module bound to the torch CPU device
(``Context(cuda_device="cpu")``) and are held against the JAX package's
device bodies on JAX's CPU backend at the reference test's tolerances:
1e-10 in float64, 2e-3 in float32, rtol 0.1 / atol 0.5 for bfloat16.  The
reference's 2- and 4-rank cases are one test here, which asserts that
``run_native`` of a multi-rank program raises the reference's
``ValueError`` in both packages (the native engine runs single-rank
array programs).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu import array as ref_pa  # noqa: E402
from parsec_tpu_torch import array as pa  # noqa: E402

TOL = {np.float64: 1e-10, np.float32: 2e-3}


def _spd(n, rng, dtype=np.float64):
    G = rng.standard_normal((n, n)).astype(dtype)
    return G, (G @ G.T + n * np.eye(n, dtype=dtype)).astype(dtype)


def _port_ctx(device):
    if device:
        return parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu")
    return parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"])


def _body_kw(P, device):
    accel = "use_cuda" if P is pa else "use_tpu"
    return {"use_cpu": not device, accel: device}


def _run(P, build, device=False):
    """Build the arrays through package ``P`` and compute them in one
    program on that package's context; returns the outputs' arrays and,
    for the port, the CUDA module's executed-task count."""
    outs = build(P)
    ctx = _port_ctx(device) if P is pa else parsec_tpu.Context(nb_cores=2)
    with ctx:
        outs[0].compute(ctx, others=outs[1:], **_body_kw(P, device))
        executed = sum(d.stats.get("executed_tasks", 0) for d in ctx.devices
                       if d.mca_name == "cuda")
    return [o.to_numpy() for o in outs], executed


def _mixed(G, H, rhs, nb):
    def build(P):
        A = P.from_numpy(G, nb)
        B = P.from_numpy(H, nb)
        b = P.from_numpy(rhs, nb, 2)
        C = (A @ A.T + B).cholesky()
        return [C.solve(b), C]
    return build


def _mixed_inputs(n, dtype):
    rng = np.random.default_rng(7)
    G, _ = _spd(n, rng, dtype)
    H = (np.eye(n) * n).astype(dtype)
    rhs = rng.standard_normal((n, 2)).astype(dtype)
    return G, H, rhs


@pytest.mark.parametrize("n,nb", [(16, 4), (20, 8)])  # (20, 8): ragged tail
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_mixed_program_host_bodies_bit_identical(n, nb, dtype):
    """``C = cholesky(A @ A.T + B); x = solve(C, b)`` as ONE taskpool on
    the host bodies: bit for bit the JAX package's, and the numpy
    factorization within the reference's tolerance."""
    G, H, rhs = _mixed_inputs(n, dtype)
    before = pa.counters()
    (x, C), _ = _run(pa, _mixed(G, H, rhs, nb))
    after = pa.counters()
    assert after["programs_lowered"] == before["programs_lowered"] + 1
    assert after["taskpools_built"] == before["taskpools_built"] + 1
    (x_ref, C_ref), _ = _run(ref_pa, _mixed(G, H, rhs, nb))
    assert x.dtype == x_ref.dtype == dtype
    assert C.tobytes() == C_ref.tobytes() and x.tobytes() == x_ref.tobytes()
    L = np.linalg.cholesky((G @ G.T + H).astype(np.float64))
    assert np.allclose(np.tril(C), L, atol=TOL[dtype])
    assert np.count_nonzero(np.triu(C, 1)) == 0
    assert np.allclose(x, np.linalg.solve(L, rhs), atol=TOL[dtype])


@pytest.mark.parametrize("n,nb", [(16, 4), (20, 8)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_mixed_program_device_bodies_match_reference(n, nb, dtype):
    """The same program with every task on the CUDA module (torch CPU
    device) against the JAX package's device bodies."""
    G, H, rhs = _mixed_inputs(n, dtype)
    (x, C), executed = _run(pa, _mixed(G, H, rhs, nb), device=True)
    (x_ref, C_ref), _ = _run(ref_pa, _mixed(G, H, rhs, nb), device=True)
    nt = -(-n // nb)
    # tr + mi + mm + ew (nt^2 each, mm (nt-1) nt^2), po + ts + sy + gm,
    # sv + sb + su over two rhs columns (one column tile)
    chol = nt + 2 * nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
    solve = nt + (nt - 1) + nt * (nt - 1) // 2
    assert executed == 3 * nt * nt + (nt - 1) * nt * nt + chol + solve
    assert x.dtype == dtype
    tol = TOL[dtype]
    assert np.abs(C - C_ref).max() < tol and np.abs(x - x_ref).max() < tol
    assert np.count_nonzero(np.triu(C, 1)) == 0
    L = np.linalg.cholesky((G @ G.T + H).astype(np.float64))
    assert np.allclose(np.tril(C), L, atol=tol)


def _chain(G, H):
    def build(P):
        A = P.from_numpy(G, 8, 4)
        B = P.from_numpy(H, 8, 4)
        return [((A + B) * 0.25 - B).T]
    return build


@pytest.mark.parametrize("device", [False, True])
def test_elementwise_transpose_scale_chain(device):
    rng = np.random.default_rng(11)
    G = rng.standard_normal((18, 10))  # ragged in both dims under (8, 4)
    H = rng.standard_normal((18, 10))
    (out,), _ = _run(pa, _chain(G, H), device)
    (ref,), _ = _run(ref_pa, _chain(G, H), device)
    assert out.shape == (10, 18)
    if device:
        assert np.abs(out - ref).max() < 1e-10
    else:
        assert out.tobytes() == ref.tobytes()
    assert np.allclose(out, ((G + H) * 0.25 - H).T, atol=1e-12)


@pytest.mark.parametrize("device", [False, True])
def test_hadamard_and_rectangular_matmul(device):
    rng = np.random.default_rng(13)
    G = rng.standard_normal((12, 20))
    H = rng.standard_normal((20, 8))
    W = rng.standard_normal((12, 8))

    def build(P):
        A = P.from_numpy(G, 4, 8)
        B = P.from_numpy(H, 8, 4)
        return [(A @ B) * P.from_numpy(W, 4, 4)]

    (out,), _ = _run(pa, build, device)
    (ref,), _ = _run(ref_pa, build, device)
    if device:
        assert np.abs(out - ref).max() < 1e-10
    else:
        assert out.tobytes() == ref.tobytes()
    assert np.allclose(out, (G @ H) * W, atol=1e-12)


def test_single_tile_program():
    """NT == 1: every class family exists with an empty parameter space
    (the release path resolves class NAMES before ranges)."""
    rng = np.random.default_rng(5)
    G = rng.standard_normal((4, 4))
    spd = G @ G.T + 4 * np.eye(4)
    rhs = rng.standard_normal((4, 1))
    A = pa.from_numpy(spd, 4)
    b = pa.from_numpy(rhs, 4, 1)
    C = A.cholesky()
    x = C.solve(b)
    prog = pa.lower([x, C], use_cuda=False)
    assert prog.verify() == []
    with _port_ctx(False) as ctx:
        prog.run(ctx, timeout=60)
    L = np.linalg.cholesky(spd)
    assert np.allclose(C.to_numpy(), np.tril(L), atol=1e-10)
    assert np.allclose(x.to_numpy(), np.linalg.solve(L, rhs), atol=1e-10)


@pytest.mark.parametrize("device", [False, True])
def test_sum_and_norm_ride_reductions(device):
    """Host partials: the JAX package's values bit for bit.  With device
    bodies, ``A * A`` is computed on the CUDA module and its tiles, newest
    there, are staged home for the host-only partials."""
    rng = np.random.default_rng(17)
    G = rng.standard_normal((20, 12))
    vals = {}
    for P in (pa, ref_pa):
        A = P.from_numpy(G, 8, 4)
        kw = _body_kw(P, device)
        ctx = _port_ctx(device) if P is pa else parsec_tpu.Context(nb_cores=2)
        with ctx:
            vals[P] = ((A * A).sum(ctx, **kw), A.norm(ctx, **kw))
    s, nrm = vals[pa]
    assert abs(s - (G * G).sum()) < 1e-9
    assert abs(nrm - np.linalg.norm(G)) < 1e-9
    if device:
        assert abs(s - vals[ref_pa][0]) < 1e-9 and abs(nrm - vals[ref_pa][1]) < 1e-9
    else:
        assert vals[pa] == vals[ref_pa]


def test_bf16_device_bodies():
    """bfloat16 tiles (torch CPU tensors on the host) through the device
    bodies: within the reference test's bounds of the JAX package's
    bfloat16 run (ml_dtypes there) and of the f32 oracle."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    bf16 = np.dtype(ml_dtypes.bfloat16)
    rng = np.random.default_rng(19)
    G = rng.standard_normal((32, 32)).astype(np.float32)
    H = rng.standard_normal((32, 32)).astype(np.float32)

    def build(dtype):
        def b(P):
            A = P.from_numpy(G, 8, dtype=dtype)
            B = P.from_numpy(H, 8, dtype=dtype)
            return [(A @ B) + (A + B)]
        return b

    (out,), executed = _run(pa, build(torch.bfloat16), device=True)
    assert out.dtype == np.float32 and executed == 4 * 4 * 4 + 4 * 4 + 4 * 4
    (ref,), _ = _run(ref_pa, build(bf16), device=True)
    ref = np.asarray(ref, np.float32)
    assert np.allclose(out, ref, rtol=0.1, atol=0.5)
    g, h = (torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (G, H))
    assert np.allclose(out, g @ h + (g + h), rtol=0.1, atol=0.5)


def test_compute_is_idempotent_and_reusable():
    rng = np.random.default_rng(23)
    G = rng.standard_normal((16, 16))
    A = pa.from_numpy(G, 4)
    M = A @ A.T
    with _port_ctx(False) as ctx:
        M.compute(ctx, use_cuda=False)
        assert M.computed
        built = pa.counters()["taskpools_built"]
        M.compute(ctx, use_cuda=False)  # no-op: already materialized
        assert pa.counters()["taskpools_built"] == built
        out = (M + M).compute(ctx, use_cuda=False)
    assert np.allclose(out.to_numpy(), 2 * (G @ G.T), atol=1e-12)
    with pytest.raises(RuntimeError, match="lazy"):
        (M + M).to_numpy()


@pytest.mark.parametrize("nranks,q", [(2, 1), (4, 2)])
def test_multi_rank_programs_raise_naming_a8(nranks, q):
    """The reference's 2- and 4-rank programs lower (ranks are only
    arithmetic) and, since ROADMAP A.8a, run on a multi-rank context
    (test_torch_array_multirank.py).  ``run_native`` of a multi-rank
    program raises the reference's ``ValueError`` before any runtime
    work, in both packages; a one-rank context refuses a multi-rank
    program, its reduction included (the cross-rank ``sum`` is
    ``tests/test_torch_redistribute.py``'s)."""
    rng = np.random.default_rng(29)
    n, nb = 32, 8
    G, _ = _spd(n, rng)
    dist = pa.BlockCyclic(nranks // q, q)
    A = pa.from_numpy(G, nb, dist=dist, myrank=0)
    B = pa.from_numpy(np.eye(n) * n, nb, dist=dist, myrank=0)
    b = pa.from_numpy(rng.standard_normal((n, 2)), nb, 2, dist=dist, myrank=0)
    C = (A @ A.T + B).cholesky()
    x = C.solve(b)
    prog = pa.lower([x, C], use_cuda=False)
    assert prog.nranks == nranks and prog.verify() == []
    ref_dist = ref_pa.BlockCyclic(nranks // q, q)
    rA = ref_pa.from_numpy(G, nb, dist=ref_dist, myrank=0)
    rB = ref_pa.from_numpy(np.eye(n) * n, nb, dist=ref_dist, myrank=0)
    rb = ref_pa.from_numpy(np.zeros((n, 2)), nb, 2, dist=ref_dist, myrank=0)
    ref_C = (rA @ rA.T + rB).cholesky()
    ref_x = ref_C.solve(rb)
    built = pa.counters()["taskpools_built"]
    msg = "run_native executes single-rank programs"
    ref_prog = ref_pa.lower([ref_x, ref_C], use_tpu=False)
    with pytest.raises(ValueError, match=msg):
        ref_prog.run_native()
    with _port_ctx(False) as ctx:
        with pytest.raises(ValueError, match=msg):
            prog.run_native()
        for call in (lambda: prog.run(ctx),
                     lambda: x.compute(ctx, use_cuda=False),
                     lambda: A.sum(ctx, use_cuda=False)):
            with pytest.raises(ValueError, match=f"over {nranks} ranks"):
                call()
        assert ctx._active_taskpools == 0
    assert pa.counters()["taskpools_built"] == built
    assert not x.computed and not C.computed
