"""The port's supertask fusion (parsec_tpu_torch.dsl.fusion and its hooks in
dsl/ptg.py, dsl/native_exec.py and device/cuda.py) against the JAX
package's.

* the partitioner: the port's regions equal ``parsec_tpu.dsl.fusion.
  partition``'s on the same captured graphs — dpotrf (n=128 and 160,
  nb=32, with and without trtri), flash attention (S=128 and 256 in
  32-blocks, causal and not) and the stencil (32^2 in 4x4 tiles, 4 steps)
  — region kinds and member lists, in modes auto, chains and waves, at
  horizons 4 and 16; the plans' slots and ``_scan_segments`` equal too;
* the mirrors of ``tests/dsl/test_fusion.py`` (all but the
  cross-process fused-program cache pin: no fused region is captured, so
  no program is cached);
* the partition cache (A.4d): a same-shaped pool of one PTG definition
  takes the cached regions without a capture or a partition, bit-identical;
  another NT partitions again; the cached regions are the reference's;
* execution: fused and unfused runs ``torch.equal`` on the dynamic path
  and through the pump (the CUDA device module bound to the torch CPU
  device, the kernel wrappers on their plain versions) at stage depths 1
  and 2 and under four seeded pop orders; the fused port within the
  reference's bounds of the reference's fused run; logical task counts
  exact (``nb_retired``, ``run()``); fewer native nodes than tasks; no
  per-task interpreter entry under the pump; a fused body never in a
  wave; a partitioner failure raises.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.data.collection import LocalCollection as RefLocalCollection  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.dsl import fusion as ref_fusion  # noqa: E402
from parsec_tpu.dsl.ptg import PTG as RefPTG  # noqa: E402
from parsec_tpu.ops import attention as ref_attention  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu.ops import stencil as ref_stencil  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca_param  # noqa: E402
from parsec_tpu_torch import AccessMode, mca_param  # noqa: E402
from parsec_tpu_torch.data import LocalCollection, host_array  # noqa: E402
from parsec_tpu_torch.datadist import TiledMatrix  # noqa: E402
from parsec_tpu_torch.dsl import PTG  # noqa: E402
from parsec_tpu_torch.dsl import fusion as F  # noqa: E402
from parsec_tpu_torch.dsl import native_exec  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import NativeExecutor  # noqa: E402
from parsec_tpu_torch.ops import attention, cholesky_ptg, dpotrf_task_count, stencil  # noqa: E402

IN, INOUT = AccessMode.IN, AccessMode.INOUT
SEEDS = (0, 1, 7, 42)  # the reference's four schedule-explorer seeds
# tests/test_torch_cholesky.py's bounds against the reference (factor
# difference relative to its largest entry; |LL^T - S|, from
# tests/dsl/test_xla_lower.py:95-96) and tests/runtime/test_attention_graph.py's
# f32 attention bound (allclose atol = rtol)
TOL_FACTOR, TOL_DPOTRF, TOL_ATTN = 1e-4, 2e-3, 2e-5


@pytest.fixture
def port_param():
    """Set port MCA params for one test; unset them after."""
    touched = []

    def set_(framework, name, value):
        mca_param.set_param(framework, name, value)
        touched.append((framework, name))

    yield set_
    for framework, name in touched:
        mca_param.unset(framework, name)


@pytest.fixture
def cpu_device(port_param):
    """Bind the pump's CUDA device module to the torch CPU device."""
    port_param("device", "cuda_torch_device", "cpu")


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(np.float32)
    return m @ m.T + n * np.eye(n, dtype=np.float32)


# -- the workloads, built in both packages ------------------------------------

def _dpotrf_pools(n, trtri=False, nb=32):
    S = _spd(n, seed=3)
    A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(S)
    mine = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True,
                        use_trtri=trtri).taskpool(NT=A.mt, A=A)
    rA = RefTiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(S)
    theirs = ref_cholesky_ptg(use_tpu=True, use_cpu=False, use_pallas=True,
                              use_trtri=trtri).taskpool(NT=rA.mt, A=rA)
    return mine, theirs


def _qkv(s):
    rng = np.random.default_rng(2)
    return [rng.standard_normal((1, s, 2, 8)).astype(np.float32) for _ in range(3)]


def _attention_pools(s, causal):
    kw = dict(causal=causal, q_block=32, kv_block=32)
    mine, _ = attention.build_flash_attention(*_qkv(s), use_cpu=False, **kw)
    theirs, _ = ref_attention.build_flash_attention(*_qkv(s), use_cpu=False, **kw)
    return mine, theirs


_GRID = np.random.default_rng(1).standard_normal((32, 32))
_ST = dict(T=4, MT=4, NT=4)


def _stencil_pools():
    mine = stencil.stencil_ptg(use_kernels=True, use_cpu=False).taskpool(
        A=stencil.StencilBuffers(_GRID, 4, 4), **_ST)
    theirs = ref_stencil.stencil_ptg(use_pallas=True, use_cpu=False).taskpool(
        A=ref_stencil.StencilBuffers(_GRID, 4, 4), **_ST)
    return mine, theirs


_CASES = {
    "dpotrf128": lambda: _dpotrf_pools(128),
    "dpotrf160": lambda: _dpotrf_pools(160),
    "dpotrf160_trtri": lambda: _dpotrf_pools(160, trtri=True),
    "attn128_causal": lambda: _attention_pools(128, True),
    "attn128": lambda: _attention_pools(128, False),
    "attn256_causal": lambda: _attention_pools(256, True),
    "attn256": lambda: _attention_pools(256, False),
    "stencil": _stencil_pools,
}
_graphs = {}


#: the reference's flash graph reads its carries' initials from these
#: collections; the port's carries are task-made tiles of each chain's
#: first step (ROADMAP C, "The flash graph's carries")
_CARRIES = {"CA": "ACC", "CM": "M", "CL": "L"}


def _as_port(key):
    """The reference's slot key in the port's terms: a carry collection's
    tile ``(g, i)`` is ``attn_step(g, i, 0)``'s task-made tile."""
    if key is None or key[0] != "data" or key[1] not in _CARRIES:
        return key
    return ("new", ("attn_step", tuple(key[2]) + (0,)), _CARRIES[key[1]])


def _captured(case):
    """(port pool, port graph, reference pool, reference graph), captured
    once per case."""
    if case not in _graphs:
        mine, theirs = _CASES[case]()
        _graphs[case] = (mine, mine.capture(ranks=[0]), theirs, theirs.capture(ranks=[0]))
    return _graphs[case]


def _view(regions):
    return [(r.index, r.kind, list(r.members)) for r in regions]


# -- partition parity -----------------------------------------------------------

@pytest.mark.parametrize("horizon", [4, 16])
@pytest.mark.parametrize("mode", ["auto", "chains", "waves"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_partition_matches_reference(case, mode, horizon):
    mine, g, theirs, rg = _captured(case)
    got = F.partition(g, mine.ptg.classes, mode=mode, max_tasks=horizon)
    want = ref_fusion.partition(rg, theirs.ptg.classes, mode=mode, max_tasks=horizon)
    assert _view(got) == _view(want)
    assert all(2 <= len(r.members) <= horizon for r in got)
    if case == "stencil" and mode != "chains":
        assert got, "the stencil's levels must fuse into waves"


@pytest.mark.parametrize("scan", ["auto", "on"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_plans_and_scan_segments_match_reference(case, scan):
    """Every plan's slot structure and its scan segment (the uniform
    leading run the reference rolls into ``lax.scan`` and the port runs as
    a member loop) equal the reference's."""
    mine, g, theirs, rg = _captured(case)
    regions = F.partition(g, mine.ptg.classes, mode="auto", max_tasks=16)
    ref_regions = ref_fusion.partition(rg, theirs.ptg.classes, mode="auto", max_tasks=16)
    assert len(regions) == len(ref_regions)
    looped = 0
    for r, rr in zip(regions, ref_regions):
        p = F.FusedPlan(mine, g, r, scan=scan)
        rp = ref_fusion.FusedPlan(theirs, rg, rr, scan=scan)
        assert p._scan_segments == rp._scan_segments
        looped += p._scan_segments is not None
        # the port's flash graph writes O without reading it: its O slots
        # are write-only where the reference's read and write; its carries
        # are task-made where the reference's come from collections
        want_modes = [m & ~int(AccessMode.IN) if key[:2] == ("data", "O") else m
                      for key, m in zip(rp.slot_keys, rp.slot_modes)]
        want_keys = [_as_port(key) for key in rp.slot_keys]
        assert (p.slot_keys, p.slot_modes, p.out_slots, p.slot_writer) == \
            (want_keys, want_modes, rp.out_slots, rp.slot_writer)
        assert p.member_flow_slots == [{f: _as_port(key) for f, key in slots.items()}
                                       for slots in rp.member_flow_slots]
        assert p.priority == rp.priority and p.name == rp.name
        assert p.body_fn._fused_n == rp.body_fn._fused_n == len(r.members)
    if case.startswith("attn"):
        assert looped, "the attention carry chains must loop"


# -- the mirrors of tests/dsl/test_fusion.py -------------------------------------

def test_partition_dpotrf_chains_and_waves():
    mine, g, _, _ = _captured("dpotrf128")
    regions = F.partition(g, mine.ptg.classes, mode="auto", max_tasks=16)
    assert regions, "dpotrf must produce fused regions"
    assert {r.kind for r in regions} == {"chain", "wave"}
    seen = set()
    for r in regions:
        assert 2 <= len(r.members) <= 16
        assert not (set(r.members) & seen), "regions must not overlap"
        seen |= set(r.members)
        if r.kind == "chain":
            # every interior member has exactly one distinct successor and
            # no remote forwards: the convexity / deadlock proof
            for m in r.members[:-1]:
                node = g.nodes[m]
                assert len({s for (_f, s, _sf) in node.out_edges}) == 1
                assert node.remote_out == 0
    # the syrk column chains end in their potrf
    assert any(r.members[-1][0] == "potrf" for r in regions if r.kind == "chain")


def test_partition_modes_and_horizon():
    mine, g, _, _ = _captured("dpotrf128")
    classes = mine.ptg.classes
    assert F.partition(g, classes, mode="off", max_tasks=16) == []
    chains = F.partition(g, classes, mode="chains", max_tasks=16)
    assert chains and all(r.kind == "chain" for r in chains)
    waves = F.partition(g, classes, mode="waves", max_tasks=16)
    assert waves and all(r.kind == "wave" for r in waves)
    capped = F.partition(g, classes, mode="auto", max_tasks=2)
    assert capped and all(len(r.members) == 2 for r in capped)
    with pytest.raises(ValueError, match="fusion mode"):
        F.partition(g, classes, mode="bogus", max_tasks=16)


def _ring_pool(ptg_cls, coll_cls, body_kw, R=4):
    """A ring rotation in the shape of ring attention: step(r, s) on rank
    r carries ACC along s and forwards its KV block to rank r-1 for
    s < R-1; out(r) takes the last carry."""
    class Ranked(coll_cls):
        def rank_of(self, *key):
            return int(key[0]) % self.nodes

    def body(**_):
        return None

    ptg = ptg_cls("ring")
    st = ptg.task_class("step", r="0 .. R-1", s="0 .. R-1")
    st.affinity("D(r, s)")
    st.flow("KV", IN, "<- (s == 0) ? D(r, s) : KV step((r+1) % R, s-1)",
            "-> (s < R-1) ? KV step((r-1+R) % R, s+1)")
    st.flow("ACC", INOUT, "<- (s == 0) ? C(r) : ACC step(r, s-1)",
            "-> (s < R-1) ? ACC step(r, s+1) : ACC out(r)")
    st.body(**{body_kw: body})
    out = ptg.task_class("out", r="0 .. R-1")
    out.affinity("O(r)")
    out.flow("ACC", IN, "<- ACC step(r, R-1)")
    out.flow("O", INOUT, "<- O(r)", "-> O(r)")
    out.body(**{body_kw: body})
    return ptg.taskpool(R=R, **{n: Ranked(n, nodes=R) for n in ("D", "C", "O")})


def test_ring_rotation_never_fuses_interior():
    """A step that forwards its KV block to another rank has remote
    successors: it is never a region interior (burying the rotation would
    serialize or deadlock the cross-rank cycle), and waves stay off on a
    rank-filtered capture.  The same regions as the reference's."""
    R = 4
    tp = _ring_pool(PTG, LocalCollection, "cuda", R)
    g = tp.capture(ranks=[0])
    regions = F.partition(g, tp.ptg.classes, mode="auto", max_tasks=16)
    assert regions, "the tail (last step -> out) must fuse"
    for r in regions:
        assert r.kind == "chain"
        for m in r.members[:-1]:
            assert not (m[0] == "step" and m[1][1] < R - 1), \
                f"rotation step {m} fused as interior"
    rtp = _ring_pool(RefPTG, RefLocalCollection, "tpu", R)
    want = ref_fusion.partition(rtp.capture(ranks=[0]), rtp.ptg.classes,
                                mode="auto", max_tasks=16)
    assert _view(regions) == _view(want)


def _wbchain_pool(ptg_cls, coll_cls, body_kw):
    def body(T, **kw):
        return T + 1.0

    ptg = ptg_cls("wbchain")
    a = ptg.task_class("a", k="0 .. 0")
    a.flow("T", INOUT, "<- D(0)", "-> T b(0)", "-> D(0)")
    a.body(**{body_kw: body})
    b = ptg.task_class("b", k="0 .. 0")
    b.flow("T", INOUT, "<- T a(0)", "-> D(0)")
    b.body(**{body_kw: body})
    D = coll_cls("D")
    D.data_of(0).get_copy(0).payload = np.zeros((2, 2))
    return ptg.taskpool(D=D)


def test_writeback_superseded_chain_truncates():
    """An interior member whose write-back tile is rewritten by a LATER
    member must not fuse ahead of it: the fused body commits only final
    values, so such a region would change observable state."""
    tp = _wbchain_pool(PTG, LocalCollection, "cuda")
    g = tp.capture(ranks=[0])
    members = [("a", (0,)), ("b", (0,))]
    assert F._writeback_safe(g, tp.ptg.classes, members) == 1
    assert F.partition(g, tp.ptg.classes, mode="chains", max_tasks=8) == [], \
        "a's write-back is superseded by b: the pair must not fuse"
    rtp = _wbchain_pool(RefPTG, RefLocalCollection, "tpu")
    assert ref_fusion._writeback_safe(rtp.capture(ranks=[0]), rtp.ptg.classes,
                                      members) == 1


@pytest.mark.parametrize("case", ["dpotrf128", "attn128_causal", "stencil"])
def test_plan_slots_and_digest_stability(case):
    mine, g, _, _ = _captured(case)
    regions = F.partition(g, mine.ptg.classes, mode="auto", max_tasks=16)
    plans = [F.FusedPlan(mine, g, r) for r in regions]
    for p in plans:
        assert p.slot_keys and p.out_slots
        assert all(m & int(AccessMode.INOUT) for m in p.slot_modes)
        assert p.body_fn._fused_n == len(p.region.members)
        assert p.body_fn._graph_key == ("fused", p.digest)
        assert p._pool() is mine and not any(
            v is mine for v in vars(p).values()), "a plan must not keep its pool alive"
    # the same workload captured again: the same digests (the identity a
    # program cache keys on)
    again, _ = _CASES[case]()
    g2 = again.capture(ranks=[0])
    d2 = [F.FusedPlan(again, g2, r).digest
          for r in F.partition(g2, again.ptg.classes, mode="auto", max_tasks=16)]
    assert [p.digest for p in plans] == d2
    assert len(set(d2)) == len(d2), "distinct regions share a digest"


def test_fusion_table_routes_members_and_fires_once(port_param):
    """The dynamic runtime's table: members map to their region, each
    member's counter runs with its EXTERNAL goal, and a region's supertask
    comes back exactly once, on its last readiness event."""
    import types

    tp = _RUN["kernels"]()
    port_param("runtime", "fusion", "auto")
    ctx = types.SimpleNamespace(rank=0, devices=[types.SimpleNamespace(device_type="cuda")])
    table = F.build_fusion_table(tp, ctx)
    assert table is not None and table.live
    g = tp.capture()
    for lr in table.live:
        members = lr.region.members
        assert all(table.is_member(*m) for m in members)
        assert table.same_region(members[0], members[-1])
        for m in members:
            intra = sum(1 for p in members for (_f, s, _sf) in g.nodes[p].out_edges if s == m)
            assert table.ext_goal(*m) == g.nodes[m].in_edges - intra
        events = lr.waiting
        fired = [table.route_ready(*members[0]) for _ in range(events)]
        assert all(handled for handled, _ in fired)
        assert [t for _, t in fired if t is not None] == [lr.supertask]
        assert lr.supertask.fused_n == len(members)
    assert table.route_ready("potrf", (99,)) == (False, None)
    assert not table.is_member("potrf", (99,))
    # nothing on a device type the context lacks: no table
    assert F.build_fusion_table(_RUN["kernels"](), types.SimpleNamespace(
        rank=0, devices=[types.SimpleNamespace(device_type="cpu")])) is None


# -- execution: the dynamic path and the pump ------------------------------------

_RUN = {
    "kernels": lambda: _dpotrf_pools(128)[0],
    "kernels_trtri": lambda: _dpotrf_pools(160, trtri=True)[0],
    "attention": lambda: _attention_pools(128, True)[0],
    "stencil": lambda: _stencil_pools()[0],
}
_TASKS = {"kernels": dpotrf_task_count(4), "kernels_trtri": dpotrf_task_count(5, use_trtri=True),
          "attention": attention.attention_task_count(1, 128, 128, 2, 32, 32, causal=True),
          "stencil": 4 * 4 * 4}


def _result(path, tp):
    consts = tp.constants
    if path == "stencil":
        return consts["A"].to_array(_ST["T"] % 2)
    if path == "attention":
        return np.stack([np.asarray(host_array(consts["O"].data_of(g, i).newest_copy().payload))
                         for g in range(2) for i in range(4)])
    return np.tril(consts["A"].to_array())


def _run(path, regime, fusion, **ex_kw):
    """One run of ``path`` on the CUDA device module bound to the torch CPU
    device, fusion ``fusion``: through ``Context`` (``regime`` "dynamic",
    the MCA param) or the pump (``fusion=``).  Returns (result, logical
    tasks reported, the pool's nb_retired, device stats, executor stats
    or None, executor or None)."""
    tp = _RUN[path]()
    if regime == "pump":
        ex = NativeExecutor(tp, native_device=True, fusion=fusion, **ex_kw)
        try:
            ran = ex.run()
            stats = dict(ex.stats)
        finally:
            ex.close()
        return _result(path, tp), ran, tp.nb_retired, dict(ex.device.stats), stats, ex
    mca_param.set_param("runtime", "fusion", fusion)
    try:
        with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=120), tp.fail_reason
            dev_stats = dict(ctx.devices[1].stats)
    finally:
        mca_param.unset("runtime", "fusion")
    return _result(path, tp), tp.nb_retired, tp.nb_retired, dev_stats, None, None


_base = {}


def _baseline(path):
    """The unfused dynamic path at stage depth 1: what every run equals."""
    if path not in _base:
        out, ran, retired, dev, _, _ = _run(path, "dynamic", "off")
        assert ran == retired == _TASKS[path] and dev["fused_submits"] == 0
        _base[path] = out
    return _base[path]


def _fused_gates(path, ran, retired, dev):
    n = _TASKS[path]
    assert ran == retired == n, "the logical task count must be exact"
    assert dev["fused_submits"] > 0
    assert dev["fused_tasks"] > dev["fused_submits"]
    # every dispatch is a region or a lone task: dispatches < tasks
    assert dev["executed_tasks"] == n - dev["fused_tasks"] + dev["fused_submits"] < n


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("path", sorted(_RUN))
def test_dynamic_fused_equals_unfused(path, depth, cpu_device, port_param):
    """runtime_fusion=auto fuses on the dynamic PTG path (it was ignored
    there before) and changes no bit, at stage depth 1 and 2."""
    port_param("runtime", "stage_depth", depth)
    out, ran, retired, dev, _, _ = _run(path, "dynamic", "auto")
    np.testing.assert_array_equal(out, _baseline(path))
    _fused_gates(path, ran, retired, dev)
    assert dev["wb_sync_fallbacks"] == 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("path", sorted(_RUN))
def test_pump_fused_equals_unfused(path, depth, seed, cpu_device, port_param):
    """Through the pump, one native node a region: bit-identical to the
    unfused dynamic path under four seeded pop orders at stage depth 1 and
    2, ``run()`` and ``nb_retired`` the logical count, fewer native nodes
    than tasks, and no per-task interpreter entry."""
    port_param("sched", "rnd_seed", seed)
    port_param("runtime", "stage_depth", depth)
    out, ran, retired, dev, stats, ex = _run(path, "pump", "auto")
    np.testing.assert_array_equal(out, _baseline(path))
    _fused_gates(path, ran, retired, dev)
    assert len(ex._bodies) == stats["pumped_tasks"] < _TASKS[path]
    assert len(ex._bodies) == _TASKS[path] - dev["fused_tasks"] + dev["fused_submits"]
    assert stats["completion_callbacks"] == stats["trampoline_entries"] == 0


_ref_cache = {}


def _reference_fused(path):
    """The JAX package's dynamic run with runtime_fusion=auto."""
    if path not in _ref_cache:
        ref_mca_param.params.set("runtime", "fusion", "auto")
        try:
            if path == "attention":
                with parsec_tpu.Context(nb_cores=2) as ctx:
                    out = ref_attention.run_flash_attention(
                        ctx, *_qkv(128), causal=True, q_block=32, kv_block=32,
                        use_cpu=False)
                _ref_cache[path] = (np.asarray(out), None)
            else:
                if path == "stencil":
                    rA = ref_stencil.StencilBuffers(_GRID, 4, 4)
                    tp = ref_stencil.stencil_ptg(use_tpu=True, use_cpu=False).taskpool(
                        A=rA, **_ST)
                else:
                    tp = _dpotrf_pools(128)[1]
                with parsec_tpu.Context(nb_cores=2) as ctx:
                    ctx.add_taskpool(tp)
                    assert tp.wait(timeout=300)
                    assert tp._fusion is not None
                    fused = sum(d.stats.get("fused_submits", 0) for d in ctx.devices)
                assert fused > 0
                _ref_cache[path] = (_result(path, tp), tp.nb_retired)
        finally:
            ref_mca_param.params.unset("runtime", "fusion")
    return _ref_cache[path]


@pytest.mark.parametrize("path", ["kernels", "attention", "stencil"])
def test_fused_port_matches_reference_fused_run(path, cpu_device):
    """The port's fused dynamic run against the reference's fused dynamic
    run (its jitted region programs on JAX's CPU backend), within the
    reference's bounds."""
    out, ran, _, dev, _, _ = _run(path, "dynamic", "auto")
    assert dev["fused_submits"] > 0
    want, ref_ran = _reference_fused(path)
    if path == "attention":
        # the O planes (g = h, i) back into the [B, S, H, D] layout
        mine = np.concatenate([out[g * 4:(g + 1) * 4].reshape(128, 8)[None, :, None, :]
                               for g in range(2)], axis=2)
        np.testing.assert_allclose(mine, want, rtol=TOL_ATTN, atol=TOL_ATTN)
        return
    assert ran == ref_ran == _TASKS[path]
    if path == "stencil":
        np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)
        return
    assert np.abs(out - want).max() / np.abs(want).max() < TOL_FACTOR
    S = _spd(128, seed=3)
    assert np.abs(out @ out.T - S).max() / np.abs(S).max() < TOL_DPOTRF


def test_native_fused_dpotrf_bit_identical(cpu_device):
    off, ran_off, _, _, _, ex_off = _run("kernels", "pump", "off")
    on, ran_on, retired, _, stats, ex = _run("kernels", "pump", "auto")
    # run() reports LOGICAL tasks, however many native nodes
    assert ran_off == ran_on == retired == 20
    assert ex._regions and not ex_off._regions, "native fusion did not partition"
    assert len(ex._bodies) < 20 == len(ex_off._bodies), "regions must collapse nodes"
    assert stats["completion_callbacks"] == stats["trampoline_entries"] == 0
    np.testing.assert_array_equal(off, on)


def test_native_fused_flash_attention(cpu_device, port_param):
    q, k, v = _qkv(128)
    kw = dict(causal=True, q_block=32, kv_block=32)
    off = attention.run_flash_attention_native(q, k, v, **kw)
    port_param("runtime", "fusion", "auto")
    on = attention.run_flash_attention_native(q, k, v, **kw)
    assert torch.equal(off, on)
    # the argument overrides the param either way
    assert torch.equal(attention.run_flash_attention_native(q, k, v, fusion="off", **kw), on)


def test_dynamic_flash_attention_fused_bit_identical(cpu_device, port_param):
    q, k, v = _qkv(128)
    kw = dict(causal=True, q_block=32, kv_block=32, use_cpu=False)
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
        off = attention.run_flash_attention(ctx, q, k, v, **kw)
    port_param("runtime", "fusion", "auto")
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
        on = attention.run_flash_attention(ctx, q, k, v, **kw)
        assert ctx.devices[1].stats["fused_submits"] > 0
    assert torch.equal(off, on)


def test_scan_lowering_engages_and_matches(cpu_device, port_param):
    """Uniform non-causal chains have a scan segment (what the reference
    rolls into ``lax.scan``), and ``runtime_fusion_scan`` off, auto and on
    give equal outputs on the dynamic path and through the pump: the port
    runs every member through one loop whatever the segment."""
    q = _qkv(256)[0][:, :, :1]
    tp, _ = attention.build_flash_attention(q, q, q, causal=False, q_block=32,
                                            kv_block=32, use_cpu=False)
    g = tp.capture(ranks=[0])
    regions = F.partition(g, tp.ptg.classes, mode="chains", max_tasks=16)
    assert regions
    assert any(F.FusedPlan(tp, g, r, scan="auto")._scan_segments is not None
               for r in regions), "uniform non-causal chains should loop"

    def run(scan_mode, regime):
        port_param("runtime", "fusion_scan", scan_mode)
        kw = dict(causal=False, q_block=32, kv_block=32)
        if regime == "pump":
            return attention.run_flash_attention_native(q, q, q, fusion="chains", **kw)
        port_param("runtime", "fusion", "chains")
        try:
            with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
                return attention.run_flash_attention(ctx, q, q, q, use_cpu=False, **kw)
        finally:
            mca_param.unset("runtime", "fusion")

    want = run("off", "dynamic")
    for regime in ("dynamic", "pump"):
        for scan_mode in ("auto", "on"):
            assert torch.equal(run(scan_mode, regime), want)


# -- the device module ---------------------------------------------------------

def test_fused_body_never_joins_a_wave(cpu_device, port_param):
    """A fused supertask is already one coarse dispatch: with wave batching
    on, its signature is None and every stencil task runs in a region,
    none in a wave — and the grid is the unfused one's."""
    port_param("device", "cuda_wave_batch", 2)
    out, ran, _, dev, _, ex = _run("stencil", "pump", "auto")
    np.testing.assert_array_equal(out, _baseline("stencil"))
    assert dev["fused_tasks"] == ran == 64 and dev["wave_tasks"] == 0
    supertask = ex._bodies[0]
    assert supertask.fused_n > 1
    assert ex.device._wave_signature(supertask) is None
    # an unfused run of the same DAG does ride waves
    _, _, _, dev, _, _ = _run("stencil", "pump", "off")
    assert dev["wave_tasks"] > 0


def test_lane_prestages_a_supertasks_slots(cpu_device, port_param, monkeypatch):
    """Stage depth 2: the pump's transfer lane prestages a popped batch of
    supertasks like any batch (four stencil regions a level at horizon 4,
    every wide ready batch re-sliced onto the lane).  The pump waits for
    the lane to finish each job before the batch's submit stops it, so
    that the lane stages in every run: otherwise whether it reaches a job
    before the pump does is a race between two threads."""
    from parsec_tpu_torch.device import staging

    stop_after_chunk = staging._StageJob.wait

    def wait_for_the_lane(job):
        job.done.wait(timeout=60)
        stop_after_chunk(job)

    monkeypatch.setattr(staging._StageJob, "wait", wait_for_the_lane)
    port_param("runtime", "stage_split_kb", 0)
    port_param("runtime", "stage_depth", 2)
    port_param("runtime", "fusion_max_tasks", 4)
    out, _, _, dev, stats, ex = _run("stencil", "pump", "auto")
    np.testing.assert_array_equal(out, _baseline("stencil"))
    assert len(ex._regions) == 16 and dev["fused_submits"] == 16
    assert stats["prefetched_batches"] > 0 and dev["prefetched_tiles"] > 0


def test_horizon_param_caps_regions(cpu_device, port_param):
    assert F.fusion_max_tasks() == F.DEFAULT_HORIZON == 16
    port_param("runtime", "fusion_max_tasks", 3)
    assert F.fusion_max_tasks() == 3
    _, _, _, dev, _, ex = _run("kernels", "pump", "auto")
    assert ex._regions and max(len(r.members) for r in ex._regions) == 3


_AUTO_BUDGET = 4 << 30  # the automatic budget on the torch CPU device


def test_pump_sets_aside_a_fused_region(cpu_device, port_param):
    """The pump hands its device module one region's room once the regions
    are known — twice the largest region's output bytes (a region's
    interior values and fresh outputs live outside the zone) — which an
    automatic budget gives up at its 85%; a smaller request changes
    nothing, unfused runs set nothing aside and an explicit budget
    stands."""
    def budget_after(fusion):
        ex = NativeExecutor(_RUN["stencil"](), native_device=True, fusion=fusion)
        try:
            return ex.device.mem_budget, ex
        finally:
            ex.close()

    budget, ex = budget_after("auto")
    room = F.region_room(ex._plans)
    # each region writes 8x8 float64 tiles of the grid
    tile = 8 * 8 * np.dtype(np.float64).itemsize
    assert room == 2 * tile * max(len(p.out_slots) for p in ex._plans) > 0
    assert budget == _AUTO_BUDGET - int(room * 0.85)
    ex.device.set_aside(room // 2)
    assert ex.device.mem_budget == budget
    assert budget_after("off")[0] == _AUTO_BUDGET
    port_param("device", "cuda_mem_budget_mb", 64)
    assert budget_after("auto")[0] == 64 << 20


def test_dynamic_fusion_sets_aside_a_fused_region(cpu_device, port_param):
    """The dynamic runtime sets the same room aside at attach, on the
    context's device module."""
    port_param("runtime", "fusion", "auto")
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
        dev = ctx.devices[1]
        assert dev.mem_budget == _AUTO_BUDGET
        tp = _RUN["kernels"]()
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=120), tp.fail_reason
        room = tp._fusion.room
        assert room == F.region_room([lr.plan for lr in tp._fusion.live]) > 0
        assert dev.mem_budget == _AUTO_BUDGET - int(room * 0.85)


# -- failures are loud -----------------------------------------------------------

def test_partitioner_failure_raises(cpu_device, port_param, monkeypatch):
    """A failed partition never falls back to per-task dispatch: the
    partitioner, the dynamic attach and the pump's executor all raise."""
    monkeypatch.setattr(F, "_contracted_has_cycle", lambda g, regions: True)
    mine, g, _, _ = _captured("dpotrf128")
    with pytest.raises(RuntimeError, match="cycle"):
        F.partition(g, mine.ptg.classes, mode="auto", max_tasks=16)
    with pytest.raises(RuntimeError, match="cycle"):
        NativeExecutor(_RUN["kernels"](), native_device=True, fusion="auto")
    port_param("runtime", "fusion", "auto")
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
        tp = _RUN["kernels"]()
        with pytest.raises(RuntimeError, match="cycle"):
            ctx.add_taskpool(tp)
        assert tp.failed and not tp.wait(timeout=5)
        # the context stays usable: an unfused pool runs to its end
        port_param("runtime", "fusion", "off")
        again = _RUN["kernels"]()
        ctx.add_taskpool(again)
        assert again.wait(timeout=60) and again.nb_retired == 20


def test_unknown_fusion_mode_raises(cpu_device):
    with pytest.raises(ValueError, match="fusion mode"):
        NativeExecutor(_RUN["kernels"](), native_device=True, fusion="everything")


def test_failing_fused_body_fails_the_run(cpu_device, monkeypatch):
    """A fused body that raises fails the pump run loudly; its members are
    never run one by one instead."""
    orig = F.FusedPlan._build_program

    def broken(self):
        orig(self)

        def body(*arrays):
            raise RuntimeError("fused boom")

        return body

    monkeypatch.setattr(F.FusedPlan, "_build_program", broken)
    tp = _RUN["stencil"]()
    ex = NativeExecutor(tp, native_device=True, fusion="auto")
    try:
        with pytest.raises(RuntimeError, match="native device run failed.*fused boom"):
            ex.run()
        assert ex.device.stats["fused_submits"] == 0
    finally:
        ex.close()


# -- the partition cache (A.4d) ------------------------------------------------------

def _pools_of(ptg, shapes):
    """Pools of one PTG definition, one per (n, nb), on the same SPD data
    as ``_dpotrf_pools``."""
    pools = []
    for n, nb in shapes:
        A = TiledMatrix(n, n, nb, nb, name="A", dtype=np.float32).from_array(_spd(n, seed=3))
        pools.append(ptg.taskpool(NT=A.mt, A=A))
    return pools


def _stats_delta(before):
    return tuple(F.stats[k] - before[k] for k in ("captures", "partitions", "hits"))


def test_same_shaped_pool_reuses_the_cached_partition(cpu_device, port_param, monkeypatch):
    """A second pool of one PTG definition, with the same scalar constants
    and placement, takes the cached regions, plans and goals: no second
    capture and no second partition (both would raise here), and its
    factor is bit-identical to the first pool's and to fusion off's.  A
    pool with another NT partitions again."""
    ptg = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True)
    first, second = _pools_of(ptg, [(128, 32), (128, 32)])
    base = _baseline("kernels")
    port_param("runtime", "fusion", "auto")
    before = dict(F.stats)
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
        ctx.add_taskpool(first)
        assert first.wait(timeout=60), first.fail_reason
        assert _stats_delta(before) == (1, 1, 0)
        regions = [lr.region for lr in first._fusion.live]

        def boom(*a, **k):
            raise AssertionError("a cached pool must not capture or partition")

        monkeypatch.setattr(F, "partition", boom)
        monkeypatch.setattr(type(second), "capture", boom)
        ctx.add_taskpool(second)
        assert second.wait(timeout=60), second.fail_reason
        assert _stats_delta(before) == (1, 1, 1)
        assert [lr.region for lr in second._fusion.live] == regions
        assert second._fusion is not first._fusion and second._fusion.tp is second
        dev = ctx.devices[1].stats
        assert dev["fused_submits"] == 2 * len(regions)
        monkeypatch.undo()
        (third,) = _pools_of(ptg, [(160, 32)])
        ctx.add_taskpool(third)
        assert third.wait(timeout=60), third.fail_reason
        assert _stats_delta(before) == (2, 2, 1)
        assert len(third._fusion.live) != len(regions)
    np.testing.assert_array_equal(_result("kernels", first), base)
    np.testing.assert_array_equal(_result("kernels", second), base)


def test_cached_regions_equal_the_reference_partition(port_param):
    """The cached regions are the reference's ``partition`` of the same
    pool; a same-scalars pool of other tiles takes them and sizes its own
    set-aside (four times the bytes at twice the tile)."""
    import types

    ptg = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True)
    small, big = _pools_of(ptg, [(128, 32), (256, 64)])
    port_param("runtime", "fusion", "auto")
    ctx = types.SimpleNamespace(rank=0, devices=[types.SimpleNamespace(device_type="cuda")])
    before = dict(F.stats)
    table = F.build_fusion_table(small, ctx)
    (cached,) = F._fusion_cache[ptg].values()
    _, _, theirs, rg = _captured("dpotrf128")
    want = ref_fusion.partition(rg, theirs.ptg.classes, mode="auto", max_tasks=16)
    assert _view(cached.regions) == _view(want)
    assert [lr.region for lr in table.live] == cached.regions
    assert cached.scalars == (("NT", 4),) and cached.placement == F._placement_of(small)
    again = F.build_fusion_table(big, ctx)
    assert _stats_delta(before) == (1, 1, 1)
    assert [lr.region for lr in again.live] == cached.regions
    assert again.room == 4 * table.room > 0
