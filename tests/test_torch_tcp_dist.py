"""The port's distributed TCP scenarios (the second half of
``tests/runtime/test_tcp.py``'s): the distributed dpotrf at 2 ranks, the
segmented Cholesky, the datatype ping-pong in both wire regimes, the
broadcast topologies at 8 ranks and the runtime collectives at 4.

Each test launches the port's driver (``tests/test_torch_tcp.py`` run as
a script, through ``parsec_tpu_torch.comm.launch``).  The dpotrf, the
broadcasts and the collectives also launch the JAX package's own
per-rank driver (``tests/runtime/tcp_driver.py``, through
``parsec_tpu.comm.launch``) with the same environment, and each rank's
counters must equal the reference's; the dpotrf's factor, assembled from
the port ranks' local tiles, agrees with the reference package's
one-rank factor of the same seeded matrix within the reference test's
``rtol=1e-6, atol=1e-8``, and its activation count is the reference's
pinned 28.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from parsec_tpu.comm.launch import launch as ref_launch  # noqa: E402
from test_torch_tcp import THREADS_ENV, run_scenario  # noqa: E402

REF_DRIVER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "runtime", "tcp_driver.py")


def run_both(name, nranks, timeout=120, extra_env=None, port_env=None):
    """The scenario through the port's driver (``port_env`` added to its
    environment), then the reference's; returns both ranks' JSON lines."""
    port = run_scenario(name, nranks, timeout=timeout,
                        extra_env={**(extra_env or {}), **(port_env or {})})
    res = ref_launch(nranks, [REF_DRIVER, name], timeout=timeout,
                     env={"JAX_PLATFORMS": "cpu", **THREADS_ENV, **(extra_env or {})})
    ref = [json.loads(r.stdout.strip().splitlines()[-1]) for r in res]
    assert all(o["ok"] for o in ref)
    return port, ref


@pytest.mark.parametrize("topo,root_sends", [("star", 7), ("chain", 1), ("binomial", 3)])
def test_tcp_broadcast_topologies(topo, root_sends):
    """``test_bcast.py``'s pins over 8 real processes a package: async GET
    pulls and tree forwarding from inside GET callbacks, every counter of
    every rank equal to the reference's."""
    env = {"PARSEC_MCA_runtime_bcast_topo": topo,
           "PARSEC_MCA_runtime_comm_short_limit": "1024"}
    out, ref = run_both("bcast", 8, timeout=180, extra_env=env)
    by_rank = {o["rank"]: o for o in out}
    assert sum(o["sent"] for o in out) == 7
    assert by_rank[0]["sent"] == by_rank[0]["get_adv"] == root_sends
    assert all(by_rank[r]["recv"] == 1 for r in range(1, 8))
    assert all(o["mem_left"] == 0 for o in out)
    fwd = sum(o["fwd"] for o in out)
    assert (fwd == 0) if topo == "star" else (fwd > 0)
    assert out == ref


def test_tcp_collectives_4ranks():
    """Allreduce (segmented ring), reduce-scatter, allgather and bcast
    over real sockets: the same op, byte and segment counts a rank as the
    reference's."""
    out, ref = run_both("coll", 4, timeout=180)
    assert all(o["ops"] == 4 and o["segs"] > 0 for o in out)
    assert out == ref


def test_tcp_dist_dpotrf_2ranks(tmp_path):
    """Distributed dpotrf over 2 real processes on a 1x2 grid at N=256,
    nb=32: 28 activations in all, the reference's pin (one a task and
    remote destination rank), the same task and activation counts a rank
    as the reference's driver, and the assembled factor within
    ``rtol=1e-6, atol=1e-8`` of the reference package's one-rank
    factor."""
    import parsec_tpu
    from parsec_tpu.datadist import TiledMatrix
    from parsec_tpu.ops import cholesky_ptg

    N, nb = 256, 32
    env = {"PERF_N": str(N), "PERF_NB": str(nb), "PERF_P": "1"}
    out, ref = run_both("dist_dpotrf", 2, timeout=180, extra_env=env,
                        port_env={"OUT_DIR": str(tmp_path)})
    assert sum(o["acts"] for o in out) == 28
    assert [(o["rank"], o["acts"], o["ntasks"]) for o in out] == \
        [(o["rank"], o["acts"], o["ntasks"]) for o in ref]
    rng = np.random.default_rng(3)  # the drivers' matrix
    M = rng.standard_normal((N, N))
    SPD = M @ M.T + N * np.eye(N)
    factor = np.zeros((N, N))
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            for key in z.files:
                i, j = map(int, key.split("_"))
                factor[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] = z[key]
    ctx = parsec_tpu.Context(nb_cores=2)
    try:
        A = TiledMatrix(N, N, nb, nb, name="A")
        A.from_array(SPD)
        tp = cholesky_ptg(use_tpu=False, use_cpu=True).taskpool(NT=A.mt, A=A)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=120)
        want = A.to_array()
    finally:
        ctx.fini()
    np.testing.assert_allclose(np.tril(factor), np.tril(want), rtol=1e-6, atol=1e-8)


def test_tcp_dist_segchol_2ranks():
    out = run_scenario("dist_segchol", 2, timeout=180,
                       extra_env={"SEG_N": "256", "SEG_NB": "32"})
    assert all(o["err"] < 1e-3 for o in out), out
    assert sum(o["acts"] for o in out) > 0


@pytest.mark.parametrize("nb,kinds", [(48, ["rdv"]), (16, ["eager"])])
def test_tcp_dtt_pingpong_mixed_layouts(nb, kinds):
    out = run_scenario("dtt_pingpong", 2, extra_env={"DTT_NB": str(nb)})
    NT, tile = 6, nb * nb * 8
    assert all(o["pld_bytes"] == 2 * (NT - 1) * tile for o in out), out
    assert all(o["pld_kinds"] == kinds for o in out), out
