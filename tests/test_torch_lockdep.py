"""The port's lock-order checker (parsec_tpu_torch.analysis.lockdep)
against the JAX package's.

Each case of the reference's ``tests/analysis/test_lockdep.py`` runs the
same lock pattern under both packages' checkers, which must report the
same codes.  Beyond those: ``PARSEC_TPU_LOCKDEP`` on the port's
``Context`` (findings in ``ctx.lock_findings`` at ``fini``) over a dpotrf
on the CUDA module bound to the torch CPU device, and over the pump at
stage depth 2 (the transfer lane's and the committer's locks).
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from parsec_tpu.analysis import lockdep as ref_lockdep  # noqa: E402
from parsec_tpu_torch import Context, mca_param  # noqa: E402
from parsec_tpu_torch.analysis import lockdep  # noqa: E402
from parsec_tpu_torch.analysis.lockdep import LockOrderChecker  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg  # noqa: E402

_REAL_LOCK, _REAL_RLOCK = threading.Lock, threading.RLock


def _inversion():
    a = threading.Lock()
    b = threading.RLock()
    with a:
        with b:
            pass
    with b:
        with a:
            pass


def _consistent():
    a = threading.Lock()
    b = threading.Lock()
    for _ in range(5):
        with a:
            with b:
                pass


def _sharded():
    shards = [threading.Lock() for _ in range(4)]  # ONE allocation site
    with shards[0]:
        with shards[1]:
            pass
    with shards[1]:
        with shards[0]:
            pass


def _reentrant():
    r = threading.RLock()
    b = threading.Lock()
    with r:
        with r:          # reentrant: no new ordering context
            with b:
                pass
    with b:
        pass             # b alone: no edge back to r


def _cross_thread():
    a = threading.Lock()
    b = threading.Lock()

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    for fn in (t1, t2):
        th = threading.Thread(target=fn)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()


def _condition_wait():
    """A Condition over a tracked RLock: wait/notify across threads keeps
    the held stacks balanced (no phantom order)."""
    cv = threading.Condition()
    other = threading.Lock()
    box = []

    def waiter():
        with cv:
            while not box:
                cv.wait(timeout=5)
        with other:
            pass

    th = threading.Thread(target=waiter)
    th.start()
    with cv:
        box.append(1)
        cv.notify_all()
    th.join(timeout=10)
    assert not th.is_alive()
    with other:
        pass


CASES = {
    "inconsistent_order": (_inversion, ["RT010"]),
    "consistent_order": (_consistent, []),
    "same_allocation_site_is_one_class": (_sharded, []),
    "rlock_reentrancy": (_reentrant, []),
    "cross_thread_inversion": (_cross_thread, ["RT010"]),
    "condition_wait": (_condition_wait, []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lock_pattern_matches_the_reference(case):
    fn, want = CASES[case]
    out = []
    for Checker in (LockOrderChecker, ref_lockdep.LockOrderChecker):
        with Checker() as chk:
            fn()
        assert threading.Lock is _REAL_LOCK and threading.RLock is _REAL_RLOCK
        fs = chk.findings()
        if want:  # both acquisition orders are named with their chains
            assert "->" in fs[0].message and "observed earlier" in fs[0].message
        out.append([(f.code, f.severity) for f in fs])
    assert [c for c, _ in out[0]] == want
    assert out[0] == out[1]


def test_uninstall_restores_threading_factories():
    chk = LockOrderChecker().install()
    assert threading.Lock is not _REAL_LOCK
    chk.uninstall()
    assert threading.Lock is _REAL_LOCK and threading.RLock is _REAL_RLOCK


def _spd(n):
    M = np.random.default_rng(2).standard_normal((n, n))
    return (M @ M.T + n * np.eye(n)).astype(np.float32)


@pytest.fixture
def lockdep_env(monkeypatch):
    """``PARSEC_TPU_LOCKDEP=1`` for one test; the process-wide checker it
    installs is removed after."""
    monkeypatch.setenv("PARSEC_TPU_LOCKDEP", "1")
    yield
    lockdep.uninstall()
    assert threading.Lock is _REAL_LOCK


@pytest.fixture
def cpu_device():
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    yield
    mca_param.unset("device", "cuda_torch_device")


def test_runtime_under_lockdep_stays_deadlock_consistent(lockdep_env):
    """A dpotrf through the B1 chores on the CUDA module, every runtime
    lock made after the Context's start tracked: no RT010."""
    A = TiledMatrix(32, 32, 8, 8, dtype=np.float32).from_array(_spd(32))
    with Context(nb_cores=2, cuda_device="cpu") as ctx:
        tp = cholesky_ptg(use_kernels=True).taskpool(NT=A.mt, A=A)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
    assert ctx.lock_findings == []
    assert lockdep.checker().n_locks > 0


def test_pump_depth2_under_lockdep(lockdep_env, cpu_device, monkeypatch):
    """The pump at stage depth 2 (transfer lane and write-back committer
    threads) with its locks tracked: no RT010."""
    from parsec_tpu_torch.dsl import native_exec

    mca_param.set_param("runtime", "stage_depth", 2)
    monkeypatch.setattr(native_exec, "_STAGE_SPLIT_BYTES", 1)
    try:
        chk = lockdep.install()
        A = TiledMatrix(64, 64, 16, 16, dtype=np.float32).from_array(_spd(64))
        tp = cholesky_ptg(use_cuda=True, use_cpu=False,
                          use_kernels=True).taskpool(NT=A.mt, A=A)
        ex = native_exec.NativeExecutor(tp, native_device=True)
        try:
            ex.run()
        finally:
            ex.close()
    finally:
        mca_param.unset("runtime", "stage_depth")
    assert ex._pump and ex.stats["prefetched_batches"] > 0
    assert chk.findings() == [] and chk.n_locks > 0
