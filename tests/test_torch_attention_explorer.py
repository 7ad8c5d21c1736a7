"""The schedule explorer and supertask fusion over the port's ring-attention
PTG, the counterparts of ``tests/analysis/test_attention_explorer.py``,
``tests/analysis/test_fusion_explorer.py``'s ring case and
``tests/dsl/test_fusion.py``'s ``test_ring_rotation_never_fuses_interior``.

Under seeded perturbation of pop order, completion timing and frame
delivery every seed must quiesce, give bit-identical output blocks and
pass a clean hb-check; the unperturbed run matches the dense oracle, and
on host chores its digests are the reference explorer's.  With fusion on,
a fused ring's digests equal per-task dispatch's, and no rotation step is
ever a region interior.  The CUDA chores run on the CUDA module bound to
the torch CPU device.  Every explorer run has its own time limit; the
wide sweep stays ``slow``, as in the reference.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from parsec_tpu.analysis import schedules as ref_schedules  # noqa: E402
from parsec_tpu.dsl import fusion as ref_fusion  # noqa: E402
from parsec_tpu.ops import attention as ref_attention  # noqa: E402
from parsec_tpu.parallel import attention_reference as jax_reference  # noqa: E402
from parsec_tpu_torch import mca_param  # noqa: E402
from parsec_tpu_torch.analysis.schedules import explore  # noqa: E402
from parsec_tpu_torch.dsl import fusion as F  # noqa: E402
from parsec_tpu_torch.multirank import run_multirank_perf  # noqa: E402
from parsec_tpu_torch.ops.attention import ring_attention_builder  # noqa: E402

RUN_LIMIT = 240


def _within(fn, limit=RUN_LIMIT):
    """Run ``fn`` on a daemon thread; fail the test if it does not return
    within ``limit`` seconds."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised on the test thread
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit)
    assert not t.is_alive(), f"run did not finish within {limit} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.fixture
def cpu_device():
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    yield
    mca_param.unset("device", "cuda_torch_device")


def _qkv(s=32, h=2, d=8, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, s, h, d)).astype(np.float32) for _ in range(3)]


def _sweep(nranks, seeds, variant="ring", causal=True, chores="host"):
    q, k, v = _qkv()
    kw = dict(use_cuda=False, use_cpu=True) if chores == "host" else \
        dict(use_cuda=True, use_cpu=False)
    build, assemble = ring_attention_builder(nranks, q, k, v, causal=causal,
                                             variant=variant, **kw)
    res = _within(lambda: explore(build, nranks=nranks, seeds=seeds, timeout=120))
    assert res.identical and not res.race_findings(), res.summary()
    # the perturbed schedules are not just self-consistent — they are
    # RIGHT: one unperturbed run against the oracle
    users, _ = _within(lambda: run_multirank_perf(nranks, build, timeout=120))
    out = assemble(users)
    ref = np.asarray(jax_reference(*(jnp.asarray(a) for a in (q, k, v)), causal=causal))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    if chores == "host":
        rbuild, _ = ref_attention.ring_attention_builder(
            nranks, q, k, v, causal=causal, variant=variant, use_tpu=False, use_cpu=True)
        theirs = _within(lambda: ref_schedules.explore(rbuild, nranks=nranks,
                                                       seeds=[0], timeout=120))
        assert res.digests[0] == theirs.digests[0]
    return res


def test_ring_attention_schedule_sweep_2ranks(cpu_device):
    _sweep(2, seeds=range(4))


def test_ring_attention_bcast_schedule_sweep_2ranks(cpu_device):
    _sweep(2, seeds=range(2), variant="bcast", causal=False)


def test_ring_attention_schedule_sweep_cuda_chores(cpu_device):
    _sweep(2, seeds=range(2), chores="cuda")


@pytest.mark.slow
def test_ring_attention_schedule_sweep_wide(cpu_device):
    _sweep(2, seeds=range(25))
    _sweep(4, seeds=range(10))
    _sweep(4, seeds=range(10), variant="bcast", causal=False)


def test_explorer_ring_attention_2ranks_fused(cpu_device):
    """Fusion on: every seed identical and raceless, and the digests equal
    the per-task dispatch's."""
    q, k, v = _qkv()
    build, _ = ring_attention_builder(2, q, k, v, causal=True, use_cuda=True,
                                      use_cpu=False)
    mca_param.set_param("runtime", "fusion", "auto")
    try:
        res = _within(lambda: explore(build, nranks=2, seeds=range(4), timeout=180))
    finally:
        mca_param.unset("runtime", "fusion")
    assert res.identical and not res.race_findings(), res.summary()
    base = _within(lambda: explore(build, nranks=2, seeds=[0], timeout=180))
    assert res.digests[0] == base.digests[0], \
        "fused ring-attention digests differ from per-task dispatch"


def _view(regions):
    return [(r.kind, [tuple(m) for m in r.members]) for r in regions]


@pytest.mark.parametrize("nranks", [2, 4])
def test_ring_rotation_never_fuses_interior(nranks):
    """A step that forwards K/V to another rank has remote successors: it
    is never a region interior (burying the rotation would deadlock the
    cross-rank cycle); only the tail (last step -> attn_out) fuses.  The
    regions are the reference's."""
    q = np.random.default_rng(3).standard_normal((1, 8, 1, 4)).astype(np.float32)
    build, _ = ring_attention_builder(nranks, q, q, q, causal=True, use_cpu=False)
    tp, _ = build(0, None)
    regions = F.partition(tp.capture(ranks=[0]), tp.ptg.classes, mode="auto",
                          max_tasks=16)
    assert regions, "the tail must fuse"
    for r in regions:
        assert r.kind == "chain"  # waves are off on rank-filtered captures
        for m in r.members[:-1]:
            assert not (m[0] == "attn_rstep" and m[1][2] < nranks - 1), \
                f"rotation step {m} fused as interior"
    rbuild, _ = ref_attention.ring_attention_builder(nranks, q, q, q, causal=True,
                                                     use_cpu=False)
    rtp, _ = rbuild(0, None)
    want = ref_fusion.partition(rtp.capture(ranks=[0]), rtp.ptg.classes, mode="auto",
                                max_tasks=16)
    assert _view(regions) == _view(want)
