"""The port's distributed native executor
(``parsec_tpu_torch.dsl.native_dist.NativeDistExecutor``) against the JAX
package's: the four cases of ``tests/dsl/test_native_dist.py``.

Every rank's local partition of a dpotrf runs on the native engine (host
bodies), its cross-rank dependencies over the in-process fabric.  Each
case runs both packages' executors on the same seeded matrix, one thread
a rank: the factors are equal tile for tile (the host bodies do the same
numpy arithmetic in the same order), within 1e-10 of numpy's, each rank
ran the same local tasks and the ranks sent the same activations.  The
TCP form of the same executor runs on the card in ``chip_smoke.py``.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from parsec_tpu.comm import InprocFabric as RefFabric  # noqa: E402
from parsec_tpu.datadist import TwoDimBlockCyclic as RefBC  # noqa: E402
from parsec_tpu.dsl.native_dist import NativeDistExecutor as RefNDE  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu_torch.comm import InprocFabric  # noqa: E402
from parsec_tpu_torch.datadist import TwoDimBlockCyclic  # noqa: E402
from parsec_tpu_torch.dsl.native_dist import NativeDistExecutor  # noqa: E402
from parsec_tpu_torch.ops import cholesky_ptg  # noqa: E402

REF = dict(Fabric=RefFabric, BC=RefBC, NDE=RefNDE,
           chol=lambda: ref_cholesky_ptg(use_tpu=False, use_cpu=True))
PORT = dict(Fabric=InprocFabric, BC=TwoDimBlockCyclic, NDE=NativeDistExecutor,
            chol=lambda: cholesky_ptg(use_cuda=False, use_cpu=True))


def _spd(N, seed):
    M = np.random.default_rng(seed).standard_normal((N, N))
    return M @ M.T + N * np.eye(N)


def _spawn(nranks, fn, timeout=90):
    errors = []

    def wrapped(r):
        try:
            fn(r)
        except Exception as e:  # surfaced below
            errors.append((r, repr(e)))

    ts = [threading.Thread(target=wrapped, args=(r,)) for r in range(nranks)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert all(not t.is_alive() for t in ts), "distributed run hung"
    assert not errors, errors


def _assemble(mats, N, nb):
    out = np.zeros((N, N))
    for A in mats.values():
        for (i, j) in A.local_tiles():
            out[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = A.data_of(i, j).newest_copy().payload
    return out


class _Mesh:
    """One package's ranks: executors, matrices and engines."""

    def __init__(self, P, nranks, p, q, N, nb):
        self.P, self.nranks, self.p, self.q, self.N, self.nb = P, nranks, p, q, N, nb
        self.ces = P["Fabric"](nranks).endpoints()
        self.exes, self.mats, self.counts = {}, {}, {}

    def pool(self, r, SPD):
        A = self.P["BC"](self.N, self.N, self.nb, self.nb, p=self.p, q=self.q,
                         myrank=r, name="A")
        A.from_array(SPD)
        self.mats[r] = A
        return self.P["chol"]().taskpool(NT=A.mt, A=A)

    def run(self, SPD, rebind=False):
        def rank(r):
            tp = self.pool(r, SPD)
            ex = self.exes[r].rebind(tp) if rebind else self.P["NDE"](tp, self.ces[r])
            self.exes[r] = ex
            self.counts[r] = ex.run(nthreads=2)

        _spawn(self.nranks, rank)
        return _assemble(self.mats, self.N, self.nb)

    def acts(self, key="activations_sent"):
        return [int(ce.remote_dep.stats[key]) for ce in self.ces]


def _check_pair(port, ref, SPD, out, ref_out):
    np.testing.assert_array_equal(out, ref_out)
    L = np.linalg.cholesky(SPD)
    assert np.abs(np.tril(out) - L).max() / np.abs(L).max() < 1e-10
    assert port.counts == ref.counts
    assert port.acts() == ref.acts()
    assert port.acts("activations_recv") == ref.acts("activations_recv")


def _run_both(nranks, p, q, N, nb, seed=17):
    SPD = _spd(N, seed)
    port, ref = (_Mesh(P, nranks, p, q, N, nb) for P in (PORT, REF))
    out, ref_out = port.run(SPD), ref.run(SPD)
    _check_pair(port, ref, SPD, out, ref_out)
    return port


def test_native_dist_cholesky_4ranks():
    """4 ranks on a 2x2 grid: every rank ran its exact local partition,
    activations crossed and were all received (one per task and
    destination rank)."""
    N, nb = 128, 16
    port = _run_both(4, 2, 2, N, nb)
    nt = N // nb
    assert sum(port.counts.values()) == nt * (nt + 1) * (nt + 2) // 6
    assert all(port.counts[r] > 0 for r in range(4))
    acts = sum(port.acts())
    assert acts > 0 and acts == sum(port.acts("activations_recv"))


def test_native_dist_single_rank_degenerates():
    """One rank: no phantoms, no sends — the plain executor's run."""
    port = _run_both(1, 1, 1, 64, 16)
    assert port.acts() == [0]
    assert port.exes[0]._n_phantoms == 0


def test_native_dist_uneven_grid():
    """A 1x3 grid: write-backs cross ranks in both directions."""
    _run_both(3, 1, 3, 96, 16)


def test_native_dist_rebind_reuse():
    """The same executors (graph, bodies, phantom plan) run a second
    same-shaped pool over fresh tiles through ``rebind`` — no capture —
    and both rounds equal the reference's executors' rounds; the wire
    names the second round ``name@@1``."""
    N, nb, nranks = 256, 32, 2
    port, ref = (_Mesh(P, nranks, 1, nranks, N, nb) for P in (PORT, REF))
    for rnd, seed in enumerate((1, 2)):
        SPD = _spd(N, seed)
        out, ref_out = port.run(SPD, rebind=rnd > 0), ref.run(SPD, rebind=rnd > 0)
        _check_pair(port, ref, SPD, out, ref_out)
    assert all(ex.name.endswith("@@1") for ex in port.exes.values())


# -- the single-rank executor's graph= and its refusal of remote sources -----

def _one_rank_pool(P, N=64, nb=16, seed=5):
    A = P["BC"](N, N, nb, nb, p=1, q=1, myrank=0, name="A")
    A.from_array(_spd(N, seed))
    return A, P["chol"]().taskpool(NT=A.mt, A=A)


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_native_executor_takes_a_captured_graph(P):
    """``NativeExecutor(tp, graph=tp.capture())`` runs the given graph and
    gives the factor of an executor that captures its own."""
    import importlib

    pkg = "parsec_tpu" if P is REF else "parsec_tpu_torch"
    NativeExecutor = importlib.import_module(f"{pkg}.dsl.native_exec").NativeExecutor
    out = []
    for with_graph in (False, True):
        A, tp = _one_rank_pool(P)
        g = tp.capture() if with_graph else None
        ex = NativeExecutor(tp, graph=g)
        if with_graph:
            assert ex.graph is g
        assert ex.run(nthreads=2) == len(ex.graph.nodes) == 20
        if hasattr(ex, "close"):  # the reference's executor has none
            ex.close()
        out.append(_assemble({0: A}, 64, 16))
    np.testing.assert_array_equal(out[0], out[1])


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_rank_filtered_capture_needs_the_distributed_executor(P):
    """A rank's filtered capture handed to the single-rank executor: the
    first body reading a flow from another rank raises the reference's
    message, which names ``NativeDistExecutor``."""
    import importlib

    pkg = "parsec_tpu" if P is REF else "parsec_tpu_torch"
    NativeExecutor = importlib.import_module(f"{pkg}.dsl.native_exec").NativeExecutor
    graph_mod = importlib.import_module(f"{pkg}.dsl.graph")
    N, nb = 64, 16
    A = P["BC"](N, N, nb, nb, p=1, q=2, myrank=1, name="A")
    A.from_array(_spd(N, 5))
    tp = P["chol"]().taskpool(NT=A.mt, A=A)
    ex = NativeExecutor(tp, graph=graph_mod.capture(tp, ranks=[1]))
    remote = next(sk for tid, node in ex.graph.nodes.items()
                  for f in node.flow_sources
                  for sk in [graph_mod.source_tile(ex.graph, tid, f)] if sk[0] == "remote")
    with pytest.raises(RuntimeError, match="use NativeDistExecutor for rank-filtered captures"):
        ex._payload(remote)
