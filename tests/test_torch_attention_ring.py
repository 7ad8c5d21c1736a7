"""The port's distributed ring attention as a PTG (ops/attention.py:
``ring_attention_ptg``, ``ring_attention_builder``,
``run_ring_attention_graph``) against the JAX package's, the counterpart
of ``tests/runtime/test_attention_ring.py``.

On host chores both packages run the numpy block update in the same order
on the same seeded input, so the port's output is ``np.array_equal`` to
the reference's at 1, 2 and 4 in-process ranks, both variants, the
balanced split and bfloat16 included.  The CUDA chores run on the CUDA
module bound to the torch CPU device (the B5 wrapper's plain version)
and are held to the dense oracle, as is the SPMD ring: the reference's
bitwise pin between the graph and the SPMD loop fails in the reference
itself (ROADMAP C), and the card holds that pin instead (chip_smoke.py's
``parallel`` phase).  Then the observability contract: the rotation shows
as comm events, the per-rank overlap is positive, the payloads ride the
wire, and critpath rolls the graph up under ``attention``.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from parsec_tpu.ops import attention as ref_attention  # noqa: E402
from parsec_tpu.parallel import attention_reference as jax_reference  # noqa: E402
from parsec_tpu_torch import ops, parallel  # noqa: E402
from parsec_tpu_torch.ops import attention  # noqa: E402
from parsec_tpu_torch.ops.attention import run_ring_attention_graph  # noqa: E402

B, S, H, D = 1, 64, 2, 16
HOST = dict(use_cuda=False, devices=["cpu"])
DEVICE = dict(use_cpu=False, cuda_device="cpu")


def qkv(seed=0, shape=(B, S, H, D)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def dense(q, k, v, causal):
    return np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal))


def reference(nranks, q, k, v, **kw):
    out, stats = ref_attention.run_ring_attention_graph(nranks, q, k, v, use_tpu=False,
                                                        **kw)
    return out, stats


@pytest.mark.parametrize("nranks", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_graph_host_chores_equal_the_reference(nranks, causal):
    q, k, v = qkv(1)
    out, stats = run_ring_attention_graph(nranks, q, k, v, causal=causal, **HOST)
    theirs, ref_stats = reference(nranks, q, k, v, causal=causal)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, S, H, D)
    np.testing.assert_array_equal(out.numpy(), theirs)
    np.testing.assert_allclose(out.numpy(), dense(q, k, v, causal), rtol=2e-5, atol=2e-5)
    # G * R * (R steps + 1 normalize) tasks across the mesh
    assert stats["executed_tasks"] == ref_stats["executed_tasks"] == \
        B * H * nranks * (nranks + 1)


@pytest.mark.parametrize("nranks", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_graph_cuda_chores_match_dense(nranks, causal):
    """Every step through the B5 wrapper (the CUDA module on the torch CPU
    device), within the oracle's tolerance."""
    q, k, v = qkv(2)
    out, stats = run_ring_attention_graph(nranks, q, k, v, causal=causal, **DEVICE)
    np.testing.assert_allclose(out.numpy(), dense(q, k, v, causal), rtol=2e-5, atol=2e-5)
    assert stats["executed_tasks"] == B * H * nranks * (nranks + 1)
    assert stats["activations"] > 0


def test_ring_graph_balanced_split_non_dividing():
    """S that neither divides by R nor survives a ceil split (S=9, R=4
    would ceil to 3 blocks): balanced splits give blocks 3,2,2,2 and the
    offsets stay exact."""
    q, k, v = qkv(7, shape=(1, 9, 2, 8))
    for causal in (False, True):
        out, _ = run_ring_attention_graph(4, q, k, v, causal=causal, **HOST)
        theirs, _ = reference(4, q, k, v, causal=causal)
        np.testing.assert_array_equal(out.numpy(), theirs)
        np.testing.assert_allclose(out.numpy(), dense(q, k, v, causal), rtol=2e-5, atol=2e-5)
        out, _ = run_ring_attention_graph(4, q, k, v, causal=causal, **DEVICE)
        np.testing.assert_allclose(out.numpy(), dense(q, k, v, causal), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="at least one"):
        run_ring_attention_graph(12, q, k, v, **HOST)


@pytest.mark.parametrize("chores", ["host", "cuda"])
def test_ring_graph_bcast_variant(chores):
    q, k, v = qkv(2)
    kw = HOST if chores == "host" else DEVICE
    out, stats = run_ring_attention_graph(2, q, k, v, causal=False, variant="bcast", **kw)
    np.testing.assert_allclose(out.numpy(), dense(q, k, v, False), rtol=2e-5, atol=2e-5)
    # G * R kvsrc forwards + G * R * R steps + G * R normalizes
    assert stats["executed_tasks"] == B * H * 2 * (2 + 2)
    if chores == "host":
        theirs, _ = reference(2, q, k, v, causal=False, variant="bcast")
        np.testing.assert_array_equal(out.numpy(), theirs)
    with pytest.raises(ValueError, match="unknown ring-attention variant"):
        run_ring_attention_graph(2, q, k, v, variant="nope", **kw)


def test_ring_graph_bf16_host_chores_equal_the_reference():
    """bfloat16 q/k/v as torch tensors: the carries in float32, the output
    rounded to bfloat16 as the reference rounds it."""
    import ml_dtypes

    arrays = [torch.from_numpy(a).to(torch.bfloat16) for a in qkv(8)]
    out, _ = run_ring_attention_graph(2, *arrays, causal=True, **HOST)
    assert out.dtype == torch.bfloat16
    theirs, _ = reference(2, *(a.float().numpy().astype(ml_dtypes.bfloat16) for a in arrays),
                          causal=True)
    np.testing.assert_array_equal(out.float().numpy(), theirs.astype(np.float32))


def test_ring_graph_and_spmd_loop_both_match_dense():
    """The task graph and the SPMD ring (both with the B5 wrapper) against
    the oracle; on the card chip_smoke.py holds them bit-identical."""
    q, k, v = qkv(3)
    mesh = parallel.make_mesh((2, 1), axes=("sp", "unused"), devices=["cpu"] * 2)
    for causal in (False, True):
        ref_out = dense(q, k, v, causal)
        spmd = parallel.ring_attention(*(torch.from_numpy(a) for a in (q, k, v)), mesh,
                                       axis="sp", causal=causal, use_kernels=True)
        out, _ = run_ring_attention_graph(2, q, k, v, causal=causal, **DEVICE)
        np.testing.assert_allclose(spmd.numpy(), ref_out, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out.numpy(), ref_out, rtol=2e-5, atol=2e-5)


def test_ring_entry_points_are_exported_and_build_like_the_reference():
    assert ops.run_ring_attention_graph is run_ring_attention_graph
    assert ops.ring_attention_builder is attention.ring_attention_builder
    assert ops.ring_attention_ptg is attention.ring_attention_ptg
    for variant in ("ring", "bcast"):
        ptg = attention.ring_attention_ptg(variant=variant, use_cpu=False)
        theirs = ref_attention.ring_attention_ptg(variant=variant, use_cpu=False)
        assert sorted(ptg.classes) == sorted(theirs.classes)
        assert ptg.name == theirs.name == f"ring_attn_{variant}"
    build, _ = attention.ring_attention_builder(2, *qkv(1), use_cpu=False)
    tp, oc = build(1, None)
    assert sorted(oc.local_tiles()) == [(g, 1) for g in range(B * H)]
    assert oc.rank_of(0, 0) == 0 and oc.rank_of(1, 1) == 1
    with pytest.raises(ValueError, match="equal q/k/v shapes"):
        attention.ring_attention_builder(2, *qkv(1)[:2], np.zeros((1, 32, 2, 16)))


def test_ring_graph_rotation_overlaps_compute():
    """The K/V rotation is visible as comm events in the per-rank traces,
    the per-rank overlap metric sees the transfer under compute, and the
    payloads rode the wire protocol."""
    q, k, v = qkv(5, shape=(1, 256, 4, 32))
    out, stats = run_ring_attention_graph(2, q, k, v, causal=True, trace_pins=True,
                                          **DEVICE)
    np.testing.assert_allclose(out.numpy(), dense(q, k, v, True), rtol=2e-5, atol=2e-5)
    assert stats["n_comm_events"] > 0, "rotation left no comm spans"
    assert stats["overlap_fraction"] > 0.0, "K/V rotation never overlapped compute"
    assert len(stats["overlap_per_rank"]) == 2
    wire = stats["wire"]
    assert wire["eager_sent"] + wire["rdv_sent"] > 0
    assert stats["wire_bytes"] > 0


def test_ring_graph_critpath_attention_label(tmp_path):
    """critpath rolls the graph's task classes up under the ``attention``
    workload label (the ``attn_`` prefix)."""
    from parsec_tpu_torch.profiling import critpath

    q, k, v = qkv(6)
    for variant, causal in (("ring", True), ("bcast", False)):
        td = tmp_path / variant
        _out, stats = run_ring_attention_graph(2, q, k, v, causal=causal, variant=variant,
                                               trace_pins=True, trace_dir=str(td), **DEVICE)
        with open(stats["merged_trace"]) as f:
            events = json.load(f)["traceEvents"]
        rep = critpath.analyze(events)
        assert rep["n_tasks"] > 0
        assert "attention" in rep["per_label"], rep["per_class"]
        lab = rep["per_label"]["attention"]
        assert lab["count"] > 0 and lab["compute_us"] > 0
        assert "attention" in critpath.render(rep)
        assert all(critpath.label_of(c) == "attention"
                   for c in rep["per_class"] if c != "?")
    assert {critpath.label_of(c) for c in ("attn_rstep", "attn_bstep", "attn_kvsrc")} == \
        {"attention"}
