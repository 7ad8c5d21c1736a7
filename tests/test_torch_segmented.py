"""Panel, whole-program and segmented factorizations: the port's
:mod:`parsec_tpu_torch.ops.panel_chol`, ``segmented_chol``,
``segmented_lu`` and ``segmented_qr`` against the JAX package's.

Each test feeds the same numpy-seeded input to the reference (its Context
and TPU device module on JAX's CPU backend, as
``tests/runtime/test_panel_chol.py``, ``test_segmented_chol.py`` and
``test_segmented_qrlu.py`` run it) and to the port (``Context`` with its
CUDA device module bound to the torch CPU device), and holds both to the
reference test's tolerance, the port also against the reference's
factors.  ``SegmentedLU(fused_update=True)`` runs the reference's Pallas
``split_f32`` kernel in interpret mode and the port's B1 wrapper's plain
version.

Not mirrored: the XLA compile-count tests
(``test_compile_is_o_panels_not_o_tasks``, ``test_compile_scaling_law``,
``test_static_values_rejects_interleaved_args``) — eager torch compiles
nothing, and a torch body gets its values as Python ints.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.ops import panel_chol as ref_panel  # noqa: E402
from parsec_tpu.ops import segmented_chol as ref_segchol  # noqa: E402
from parsec_tpu.ops.segmented_lu import SegmentedLU as RefSegmentedLU  # noqa: E402
from parsec_tpu.ops.segmented_qr import SegmentedQR as RefSegmentedQR  # noqa: E402
from parsec_tpu_torch import mca_param  # noqa: E402
from parsec_tpu_torch.core.lifecycle import AccessMode  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.dsl import PTG, fusion  # noqa: E402
from parsec_tpu_torch.ops import (  # noqa: E402
    PanelCholesky,
    SegmentedCholesky,
    SegmentedLU,
    SegmentedQR,
    WholeCholesky,
    kernels,
    segmented_cholesky_ptg,
)
from parsec_tpu_torch.ops import segmented_chol  # noqa: E402

INOUT = AccessMode.INOUT


def _spd(n, dtype=np.float32, seed=7):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)).astype(dtype)
    return (M @ M.T + n * np.eye(n, dtype=dtype)).astype(dtype)


def _spd_panel(n, seed):
    """tests/runtime/test_panel_chol.py's input."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    return m @ m.T + n * np.eye(n)


def _dd(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)


def _rel(a, b):
    return np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def ref_ctx():
    c = parsec_tpu.Context(nb_cores=2)
    yield c
    c.fini()


@pytest.fixture(scope="module")
def ctx():
    c = parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu")
    yield c
    c.fini()


# -- panel_chol: PanelCholesky / WholeCholesky (test_panel_chol.py) ----------

@pytest.mark.parametrize("n,nb,bucket,strip", [(256, 32, 4, 0), (384, 32, 3, 0),
                                               (512, 64, 8, 0), (256, 32, 4, 64)])
def test_bucketed_panel_f64_exact(n, nb, bucket, strip):
    """f64 panel steps match numpy's factor to machine precision (bucketed
    trailing sizes, whole-R and strip-mined), and the reference's."""
    spd = _spd_panel(n, n if not strip else 1)
    ref = np.linalg.cholesky(spd)
    L = PanelCholesky(n, nb, bucket=bucket, strip=strip, device="cpu")(spd)
    L_ref = ref_panel.PanelCholesky(n, nb, bucket=bucket, strip=strip)(spd)
    assert L.dtype == np.float64
    assert _rel(L, ref) < 1e-12 and _rel(L_ref, ref) < 1e-12
    assert _rel(L, L_ref) < 1e-12


@pytest.mark.parametrize("n,nb,strip", [(256, 32, 64), (512, 64, 128), (256, 64, 64)])
def test_whole_program_f64_exact(n, nb, strip):
    spd = _spd_panel(n, n + 1)
    ref = np.linalg.cholesky(spd)
    L = WholeCholesky(n, nb, strip=strip, device="cpu")(spd)
    L_ref = ref_panel.WholeCholesky(n, nb, strip=strip)(spd)
    assert _rel(L, ref) < 1e-12 and _rel(L_ref, ref) < 1e-12
    assert _rel(L, L_ref) < 1e-12


@pytest.mark.parametrize("bf16,bar", [(False, 2e-3), (True, 2e-2), ("storage", 5e-2)])
def test_whole_program_f32_and_bf16(bf16, bar):
    """f32 at the 2e-3 bar, bf16 operands at 2e-2 (the reference test's
    bars); bf16 storage at the segmented storage test's 5e-2."""
    n, nb, strip = (512, 64, 128) if bf16 is False else (256, 64, 64)
    spd = _spd_panel(n, 3 if bf16 is False else 5).astype(np.float32)
    ref = np.linalg.cholesky(spd.astype(np.float64))
    L = WholeCholesky(n, nb, bf16=bf16, strip=strip, device="cpu")(spd)
    L_ref = ref_panel.WholeCholesky(n, nb, bf16=bf16, strip=strip)(spd)
    assert L.dtype == np.float32
    assert _rel(L, ref) < bar and _rel(L_ref, ref) < bar
    assert _rel(L, L_ref.astype(np.float64)) < bar


def test_whole_program_runs_in_place():
    """``run`` factors the device tensor in place; ``__call__`` never writes
    into the caller's array."""
    spd = _spd_panel(128, 4)
    A = torch.tensor(spd)
    out = WholeCholesky(128, 32, strip=64, device="cpu").run(A)
    assert out.data_ptr() == A.data_ptr()
    before = spd.copy()
    WholeCholesky(128, 32, strip=64, device="cpu")(spd)
    np.testing.assert_array_equal(spd, before)


def test_input_validation():
    with pytest.raises(ValueError):
        WholeCholesky(100, 32, device="cpu")
    with pytest.raises(ValueError):
        WholeCholesky(256, 32, strip=48, device="cpu")
    with pytest.raises(ValueError):
        PanelCholesky(100, 32, device="cpu")
    with pytest.raises(ValueError, match="storage"):
        PanelCholesky(256, 32, bf16="storage", device="cpu")


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WholeCholesky(256, 64)


# -- segmented Cholesky (test_segmented_chol.py) -------------------------------

@pytest.mark.parametrize("tail", [0, 128])
@pytest.mark.parametrize("specialize", ["static", "generic"])
def test_segmented_matches_numpy(ctx, ref_ctx, tail, specialize):
    """Both packages at the reference's 1e-4 bar, tail fused or not (the
    tail shrinks the task count), each specialization."""
    n, nb = 256, 64
    SPD = _spd(n)
    ref = np.linalg.cholesky(SPD.astype(np.float64))
    sc = SegmentedCholesky(ctx, n, nb, strip=128, tail=tail, specialize=specialize)
    assert sc.nt_tasks == (n // nb - 1 if tail else n // nb)
    L = sc(SPD)
    L_ref = ref_segchol.SegmentedCholesky(ref_ctx, n, nb, strip=128, tail=tail,
                                          specialize=specialize)(SPD)
    assert _rel(L, ref) < 1e-4 and _rel(L_ref, ref) < 1e-4
    assert _rel(L, L_ref.astype(np.float64)) < 1e-4


def test_segmented_store_bf16_matches_numpy(ctx, ref_ctx):
    """bf16 storage: the matrix lives in bf16, panel math in f32;
    bf16-class numerics (the reference's 5e-2 bar)."""
    n, nb = 256, 64
    SPD = _spd(n)
    ref = np.linalg.cholesky(SPD.astype(np.float64))
    sc = SegmentedCholesky(ctx, n, nb, strip=128, tail=0, bf16="storage")
    L = sc(SPD)
    L_ref = ref_segchol.SegmentedCholesky(ref_ctx, n, nb, strip=128, tail=0,
                                          bf16="storage")(SPD)
    assert L.dtype == np.float32
    assert _rel(L, ref) < 5e-2 and _rel(L_ref, ref) < 5e-2


def test_matrix_stays_resident_in_place(ctx):
    """The INOUT whole-matrix flow keeps ONE device tensor from the first
    step to the last (the body updates it in place), nothing moves between
    host and device, and the residency slot is released after the run."""
    n, nb = 256, 64
    sc = SegmentedCholesky(ctx, n, nb, strip=128, tail=0)
    dev = sc.device
    before = {k: dev.stats[k] for k in ("bytes_in", "bytes_out", "h2d_copies",
                                        "d2h_copies")}
    A = torch.tensor(_spd(n))
    out = sc.run(A)
    assert out.data_ptr() == A.data_ptr()
    assert {k: dev.stats[k] for k in before} == before
    assert not dev._lru_dirty and not dev._lru_clean
    ref = np.linalg.cholesky(_spd(n).astype(np.float64))
    assert _rel(np.tril(out.numpy()), ref) < 1e-4


def test_caller_array_is_never_written(ctx):
    """``__call__`` copies into a fresh device tensor: on the torch CPU
    device ``torch.from_numpy`` would alias the caller's matrix and the
    in-place steps would factor it."""
    SPD = _spd(128)
    before = SPD.copy()
    SegmentedCholesky(ctx, 128, 32, strip=64, tail=0)(SPD)
    np.testing.assert_array_equal(SPD, before)


@pytest.mark.parametrize("n,nb,strip", [(384, 64, 256), (512, 64, 192), (256, 64, 64)])
def test_chunk_walk_equals_reference(n, nb, strip):
    """``_chunked``'s three-phase walk visits the reference's chunks, in
    order, for every panel: exact coverage of [(k+1)nb, n) when strip does
    not divide n."""
    for k in range(n // nb):
        got = segmented_chol._chunked(k, n, nb, strip,
                                      lambda o, s, c: c + [(o, s)], [])
        # the reference walks with traced offsets: record them in a carry
        zeros = jax.numpy.zeros(n // nb, dtype=jax.numpy.int32)
        i, offs, sizes = ref_segchol._chunked(
            k, n, nb, strip,
            lambda o, s, c: (c[0] + 1, c[1].at[c[0]].set(o), c[2].at[c[0]].set(s)),
            (0, zeros, zeros))
        want = [(int(o), int(s)) for o, s in zip(offs[:int(i)], sizes[:int(i)])]
        assert got == want
        covered = sorted(x for o, s in got for x in range(o, o + s))
        assert covered == list(range((k + 1) * nb, n))


def test_auto_nb_is_the_empty_store_rule(tmp_path, monkeypatch):
    """On an empty tuning store nb="auto" is 512 halved until it divides N
    in both packages, and explicit values pass."""
    from parsec_tpu import tuning as ref_tuning
    from parsec_tpu_torch import tuning

    monkeypatch.setenv("PARSEC_TPU_COMPILE_CACHE", str(tmp_path))
    for n in (512, 768, 1000, 4096, 96):
        assert tuning.auto_nb("auto", "dpotrf_seg", n, default=512, divides=n) \
            == ref_tuning.auto_nb("auto", "dpotrf_seg", n, default=512, divides=n)
    assert tuning.auto_nb(64, "dpotrf_seg", 512) == 64


def test_builder_validation():
    with pytest.raises(ValueError):
        segmented_cholesky_ptg(100, 32)
    with pytest.raises(ValueError):
        segmented_cholesky_ptg(256, 64, strip=96)
    with pytest.raises(ValueError, match="specialize"):
        segmented_cholesky_ptg(256, 64, specialize="traced")


# -- segmented LU and QR (test_segmented_qrlu.py) ------------------------------

def test_segmented_qr_matches_numpy(ctx, ref_ctx):
    n, nb = 256, 64
    A = np.random.default_rng(3).standard_normal((n, n)).astype(np.float32)
    for run in (SegmentedQR(ctx, n, nb, strip=128), RefSegmentedQR(ref_ctx, n, nb, strip=128)):
        Q, R = run(A)
        # orthogonality of one-shot BCGS is kappa-amplified: the
        # reference's 2e-3 bar
        assert np.max(np.abs(Q @ R - A)) / np.max(np.abs(A)) < 1e-4
        assert np.max(np.abs(Q.T @ Q - np.eye(n))) < 2e-3
        Rn = np.linalg.qr(A.astype(np.float64), mode="r")
        assert np.allclose(np.abs(R), np.abs(Rn), atol=1e-2 * np.abs(Rn).max())


@pytest.mark.parametrize("specialize", ["static", "generic"])
@pytest.mark.parametrize("tail", [0, 128])
def test_segmented_lu_matches_numpy(ctx, ref_ctx, specialize, tail):
    n, nb = 256, 64
    A = _dd(n, 4)
    sl = SegmentedLU(ctx, n, nb, strip=128, tail=tail, specialize=specialize)
    assert sl.nt_tasks == (n // nb - 1 if tail else n // nb)
    L, U = sl(A)
    L_ref, U_ref = RefSegmentedLU(ref_ctx, n, nb, strip=128, tail=tail,
                                  specialize=specialize)(A)
    for l_, u_ in ((L, U), (L_ref, U_ref)):
        assert np.max(np.abs(l_ @ u_ - A)) / np.max(np.abs(A)) < 1e-5
        assert np.allclose(np.diag(l_), 1.0)
    assert _rel(U, U_ref) < 1e-5


def test_segmented_qr_two_flow_residency(ctx):
    """Both matrix flows (Q in place of A, and R) stay device tensors: no
    host staging, the input updated in place, both slots released."""
    n, nb = 256, 64
    A = np.random.default_rng(6).standard_normal((n, n)).astype(np.float32)
    sq = SegmentedQR(ctx, n, nb, strip=128)
    before = (sq.device.stats["bytes_in"], sq.device.stats["bytes_out"])
    A_dev = torch.tensor(A)
    Q, R = sq.run(A_dev)
    assert Q.data_ptr() == A_dev.data_ptr()
    assert (sq.device.stats["bytes_in"], sq.device.stats["bytes_out"]) == before
    assert not sq.device._lru_dirty and not sq.device._lru_clean
    assert np.max(np.abs(Q.numpy() @ np.triu(R.numpy()) - A)) / np.abs(A).max() < 1e-4


def test_generic_partial_strip_coverage(ctx, ref_ctx):
    """The generic bodies' chunk grid covers the partial last strip when
    strip does not divide n (1.5 strips), in both packages."""
    n, nb, strip = 384, 64, 256
    rng = np.random.default_rng(5)
    A = rng.standard_normal((n, n)).astype(np.float32)
    SPD = A @ A.T + n * np.eye(n, dtype=np.float32)
    Add = (rng.standard_normal((n, n)) + n * np.eye(n)).astype(np.float32)
    for sc, sq, sl in (
            (SegmentedCholesky(ctx, n, nb, strip=strip, tail=0, specialize="generic"),
             SegmentedQR(ctx, n, nb, strip=strip), SegmentedLU(ctx, n, nb, strip=strip, tail=0)),
            (ref_segchol.SegmentedCholesky(ref_ctx, n, nb, strip=strip, tail=0,
                                           specialize="generic"),
             RefSegmentedQR(ref_ctx, n, nb, strip=strip),
             RefSegmentedLU(ref_ctx, n, nb, strip=strip, tail=0))):
        L = sc(SPD)
        assert np.abs(L - np.linalg.cholesky(SPD)).max() / n < 1e-3
        Q, R = sq(A)
        assert np.abs(Q @ R - A).max() / np.abs(A).max() < 1e-3
        Lu, U = sl(Add)
        assert np.abs(Lu @ U - Add).max() / np.abs(Add).max() < 1e-3


@pytest.mark.parametrize("specialize", ["generic", "static"])
@pytest.mark.parametrize("bf16,bar", [(False, 1e-3), (True, 1e-2), ("storage", 1e-2)])
def test_lu_bf16_modes(ctx, ref_ctx, specialize, bf16, bar):
    """bf16 operand and bf16-storage trailing updates at the bf16-class
    1e-2 bar (f32 keeps 1e-3), both specializations, both packages."""
    n, nb = 512, 64
    Add = _dd(n, 11)
    for run in (SegmentedLU(ctx, n, nb, tail=128, specialize=specialize, bf16=bf16),
                RefSegmentedLU(ref_ctx, n, nb, tail=128, specialize=specialize, bf16=bf16)):
        L, U = run(Add)
        err = np.abs(L.astype(np.float64) @ U.astype(np.float64) - Add).max() \
            / np.abs(Add).max()
        assert err < bar, (run, err)


def test_lu_panel_pivoting(ctx, ref_ctx):
    """pivot="panel": true partial pivoting over the full trailing column.
    On a matrix whose best pivots live outside the diagonal block, every
    |L| multiplier stays <= 1, A[V] = L U, and rows move across blocks —
    in both packages, with the same permutation."""
    n, nb = 256, 64
    A = np.random.default_rng(2).standard_normal((n, n)).astype(np.float32)
    A[:nb, :nb] *= 1e-6  # adversarial for block-local pivoting
    out = SegmentedLU(ctx, n, nb, tail=64, specialize="static", pivot="panel")(A)
    ref = RefSegmentedLU(ref_ctx, n, nb, tail=64, specialize="static", pivot="panel")(A)
    for L, U, V in (out, ref):
        assert np.abs(L @ U - A[V]).max() / np.abs(A).max() < 2e-3
        assert np.abs(np.tril(L, -1)).max() <= 1.0 + 1e-6
        assert (V != np.arange(n)).any()
    np.testing.assert_array_equal(out[2], ref[2])
    with pytest.raises(ValueError, match="static"):
        SegmentedLU(ctx, n, nb, pivot="panel")
    with pytest.raises(NotImplementedError):
        SegmentedLU(ctx, n, nb, specialize="static", pivot="panel", bf16="storage")


def test_qr_fused_tail_and_task_count(ctx):
    n, nb = 256, 64
    A = np.random.default_rng(7).standard_normal((n, n)).astype(np.float32)
    sq = SegmentedQR(ctx, n, nb, strip=128, tail=128)
    assert sq.nt_tasks == n // nb - 1  # the last two panels fused
    Q, R = sq(A)
    assert np.max(np.abs(Q @ R - A)) / np.max(np.abs(A)) < 1e-4
    assert np.max(np.abs(Q.T @ Q - np.eye(n))) < 2e-3
    assert SegmentedQR(ctx, n, nb, strip=128, tail=0).nt_tasks == n // nb
    Qs, Rs = SegmentedQR(ctx, n, nb, strip=128, tail=128, specialize="static")(A)
    assert np.max(np.abs(Qs @ Rs - A)) / np.max(np.abs(A)) < 1e-4


def test_qr_bf16_modes_rejected(ctx):
    """The chol/LU bf16 levers are rejected for QR with the reference's
    measured rationale, on both specializations."""
    for mode in (True, "storage"):
        for spec in ("generic", "static"):
            with pytest.raises(ValueError, match="rejected"):
                SegmentedQR(ctx, 256, 64, bf16=mode, specialize=spec)


@pytest.mark.parametrize("specialize", ["generic", "static"])
def test_lu_fused_f32_update(ctx, ref_ctx, specialize):
    """``fused_update=True``: the trailing update through B1 ``split_f32``
    (the port's wrapper, its plain version here; the reference's Pallas
    kernel in interpret mode) at the f32 1e-3 bar, one B1 call a trailing
    strip (static) or chunk (generic)."""
    n, nb = 256, 64
    Add = _dd(n, 12)
    kernels.reset_counts()
    L, U = SegmentedLU(ctx, n, nb, strip=128, tail=128, specialize=specialize,
                       fused_update=True)(Add)
    calls = kernels.matmul_update.calls
    L_ref, U_ref = RefSegmentedLU(ref_ctx, n, nb, strip=128, tail=128,
                                  specialize=specialize, fused_update=True)(Add)
    for l_, u_ in ((L, U), (L_ref, U_ref)):
        rec = np.abs(l_.astype(np.float64) @ u_.astype(np.float64) - Add).max() \
            / np.abs(Add).max()
        assert rec < 1e-3
    assert _rel(U, U_ref) < 1e-3
    if specialize == "static":
        # one call a trailing strip of each step: ceil((n - k0 - nb) / strip)
        assert calls == sum(-(-(n - k0) // 128) for k0 in range(nb, n, nb))
    else:
        assert calls > 0
    with pytest.raises(ValueError, match="f32-path"):
        SegmentedLU(ctx, n, nb, bf16="storage", fused_update=True)


def test_split_update_copies_a_strided_strip_back():
    """The fused update hands the kernel contiguous copies of a strided
    strip and the U-row slice and writes the result back into the view:
    the rest of the matrix is untouched."""
    from parsec_tpu_torch.ops.segmented_lu import split_update

    rng = np.random.default_rng(1)
    M = torch.tensor(rng.standard_normal((64, 96)).astype(np.float32))
    A = torch.tensor(rng.standard_normal((48, 16)).astype(np.float32))
    Ur = torch.tensor(rng.standard_normal((16, 80)).astype(np.float32))
    before = M.clone()
    split_update(M[16:, 32:64], A, Ur[:, 8:40])
    want = kernels.matmul_update_plain(before[16:, 32:64].contiguous(), A,
                                       Ur[:, 8:40].contiguous(), alpha=-1.0,
                                       transpose_b=False, split_f32=True)
    assert torch.equal(M[16:, 32:64], want)
    mask = torch.ones_like(M, dtype=torch.bool)
    mask[16:, 32:64] = False
    assert torch.equal(M[mask], before[mask])


def test_precision_names_are_validated():
    from parsec_tpu_torch.ops.segmented_lu import check_precision

    assert check_precision(None) == "high"
    assert check_precision("HIGHEST") == "highest"
    assert check_precision("Precision.DEFAULT") == "default"
    with pytest.raises(ValueError, match="precision"):
        check_precision("tf32")


# -- donating bodies on the device module ---------------------------------------

@pytest.fixture
def port_param():
    touched = []

    def set_(framework, name, value):
        mca_param.set_param(framework, name, value)
        touched.append((framework, name))

    yield set_
    for framework, name in touched:
        mca_param.unset(framework, name)


def _donating_pool(body, K=4, n=8):
    """K independent tasks, each updating its own tile in place."""
    D = LocalCollection("D", shape=(n, n), init=lambda k: np.full((n, n), float(k)))
    ptg = PTG("donate")
    t = ptg.task_class("t", i="0 .. K-1")
    t.affinity("D(i)")
    t.flow("X", INOUT, "<- D(i)", "-> D(i)")
    body._donate_args = (0,)
    t.body(cuda=body)
    return ptg, ptg.taskpool(K=K, D=D), D


def test_donating_body_is_never_run_twice_after_out_of_memory():
    """An out-of-memory error inside an in-place body fails the task: it
    may have written part of its input, so neither the device module's
    out-of-memory relief nor the submit retry calls it again."""
    calls = []

    def body(X, **_):
        calls.append(1)
        X += 1.0  # a partial in-place update, then the error
        raise torch.OutOfMemoryError("out of memory (test)")

    _ptg, tp, D = _donating_pool(body, K=1)
    with parsec_tpu_torch.Context(nb_cores=1, cuda_device="cpu") as c:
        dev = next(d for d in c.devices if d.mca_name == "cuda")
        c.add_taskpool(tp)
        ok = tp.wait(timeout=30)
        reliefs = dev.stats.get("oom_reliefs", 0)
    assert not ok and "out of memory" in str(tp.fail_reason)
    assert len(calls) == 1 and reliefs == 0


def test_donating_body_staging_is_relieved_and_the_call_made_once(monkeypatch):
    """An out-of-memory error while STAGING an in-place body's inputs is
    relieved and the staging run again; the body itself runs once."""
    from parsec_tpu_torch.device import cuda as cuda_mod

    calls = []

    def body(X, **_):
        calls.append(1)
        X += 1.0
        return X

    orig = cuda_mod.CudaDevice._stage_task_args
    failed = []

    def flaky(self, task, b):
        if not failed:
            failed.append(1)
            raise torch.OutOfMemoryError("out of memory (test)")
        return orig(self, task, b)

    monkeypatch.setattr(cuda_mod.CudaDevice, "_stage_task_args", flaky)
    _ptg, tp, D = _donating_pool(body, K=1)
    with parsec_tpu_torch.Context(nb_cores=1, cuda_device="cpu") as c:
        dev = next(d for d in c.devices if d.mca_name == "cuda")
        c.add_taskpool(tp)
        assert tp.wait(timeout=30), tp.fail_reason
        reliefs = dev.stats["oom_reliefs"]
    assert len(calls) == 1 and reliefs == 1
    np.testing.assert_array_equal(np.asarray(D.data_of(0).newest_copy().payload), 1.0)


def test_donating_body_joins_no_wave_and_no_fused_region(port_param):
    """With wave batching and fusion on, same-signature donating tasks run
    one by one: no wave, no fused region; the segmented classes are not
    fusible."""
    port_param("device", "cuda_wave_batch", 2)
    port_param("runtime", "fusion", "auto")

    def body(X, **_):
        X += 1.0
        return X

    ptg, tp, D = _donating_pool(body, K=4)
    assert not fusion.class_fusible(ptg.classes["t"])
    assert not fusion.class_fusible(segmented_cholesky_ptg(256, 64).classes["panel"])
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as c:
        dev = next(d for d in c.devices if d.mca_name == "cuda")
        c.add_taskpool(tp)
        assert tp.wait(timeout=30), tp.fail_reason
        stats = dict(dev.stats)
    assert stats["wave_tasks"] == 0 and stats.get("fused_submits", 0) == 0, stats
    assert stats["executed_tasks"] == 4
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(D.data_of(i).newest_copy().payload), i + 1.0)


def test_donation_mark_reaches_the_device_body():
    """The PTG's device-body wrapper forwards ``_donate_args`` (the
    reference's forward, ``parsec_tpu/dsl/ptg.py:1528-1530``)."""
    from parsec_tpu_torch.dsl.ptg import _wrap_device_body

    pc = segmented_cholesky_ptg(256, 64).classes["panel"]
    wrapped = _wrap_device_body(pc, pc.bodies["cuda"])
    assert wrapped._donate_args == (0,)
    from parsec_tpu_torch.ops import cholesky_ptg

    gemm = cholesky_ptg().classes["gemm"]
    assert not hasattr(_wrap_device_body(gemm, gemm.bodies["cuda"]), "_donate_args")
