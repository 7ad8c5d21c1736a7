"""The flash graph's planes as :func:`parsec_tpu_torch.ops.build_flash_attention`
builds them: Q, K and V tiles are views of the caller's tensors, the output
planes are write-only and never staged in, and the answers are those of the
same graph built from copied planes.

The CPU cases run the native pump on the CUDA device module bound to the
torch CPU device, and the dynamic runtime with host bodies; the ``cuda``
case runs the pump on the card and skips without one.  The file imports
neither JAX nor the JAX package, so it runs on a card's machine, where the
repo's ``conftest.py`` is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_attention_planes.py
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parsec_tpu_torch  # noqa: E402
from parsec_tpu_torch import AccessMode, mca_param  # noqa: E402
from parsec_tpu_torch.data.data import host_array  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import NativeExecutor  # noqa: E402
from parsec_tpu_torch.ops import attention  # noqa: E402
from parsec_tpu_torch.parallel import attention_reference  # noqa: E402

#: name -> (batch, Sq, Sk, heads, head dim, q block, kv block, causal, dtype,
#: q as a transposed view of a [B, H, S, D] buffer); the tolerances against
#: the dense reference are tests/test_torch_attention.py's
CASES = {
    "causal_f32": (1, 48, 48, 2, 16, 16, 16, True, torch.float32, False),
    "full_bf16": (1, 48, 48, 2, 16, 16, 16, False, torch.bfloat16, False),
    "ragged_causal_bf16": (2, 50, 50, 2, 16, 16, 12, True, torch.bfloat16, False),
    "decode_f32": (1, 8, 52, 2, 16, 8, 16, True, torch.float32, False),
    "transposed_q_f32": (1, 40, 40, 3, 8, 16, 16, True, torch.float32, True),
}
TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


def _inputs(case, seed=0):
    """(q, k, v, full q) of ``case``: q is the tail of the full q (decode)."""
    b, sq, sk, h, d, _qb, _kvb, _causal, dtype, transposed = CASES[case]
    gen = torch.Generator().manual_seed(seed)
    if transposed:
        x = torch.randn((b, h, sk, d), generator=gen).to(dtype)
        q_full = x.transpose(1, 2)
        assert not q_full.is_contiguous()
    else:
        q_full = torch.randn((b, sk, h, d), generator=gen).to(dtype)
    k, v = torch.randn((2, b, sk, h, d), generator=gen).to(dtype)
    return q_full[:, sk - sq:], k, v, q_full


def _kw(case):
    _b, _sq, _sk, _h, _d, qb, kvb, causal, _dtype, _t = CASES[case]
    return dict(causal=causal, q_block=qb, kv_block=kvb)


def _cloned_pool(q, k, v, *, causal, q_block, kv_block, use_cuda=True, use_cpu=False):
    """The same graph built from copied planes: each Q/K/V tile a contiguous
    clone of the caller's slice and each O tile zeros, with its own
    ``assemble``."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qs = attention.block_splits(Sq, q_block)
    ks = attention.block_splits(Sk, kv_block)
    G = B * H

    def plane(arr, splits):
        def init(g, j):
            b, h = divmod(g, H)
            o, n = splits[j]
            return arr[b, o:o + n, h, :].clone(memory_format=torch.contiguous_format)
        return init

    def carry(fill, width):
        return lambda g, i: np.full((qs[i][1], width), fill, np.float32)

    keys_q = [(g, i) for g in range(G) for i in range(len(qs))]
    keys_k = [(g, s) for g in range(G) for s in range(len(ks))]
    colls = {
        "Q": (plane(q, qs), keys_q), "K": (plane(k, ks), keys_k),
        "V": (plane(v, ks), keys_k),
        "O": (lambda g, i: torch.zeros((qs[i][1], D), dtype=q.dtype), keys_q),
        "CA": (carry(0.0, D), keys_q), "CM": (carry(attention.NEG_BIG, 1), keys_q),
        "CL": (carry(0.0, 1), keys_q),
    }
    colls = {n: attention.PlaneCollection(n, init, keys=keys)
             for n, (init, keys) in colls.items()}
    tp = attention.flash_attention_ptg(
        causal=causal, scale=1.0 / math.sqrt(D), q_block=q_block, kv_block=kv_block,
        q_offset=Sk - Sq, use_cuda=use_cuda, use_cpu=use_cpu,
    ).taskpool(G=G, NQ=len(qs), NK=len(ks), QB=q_block, KVB=kv_block, QOFF=Sk - Sq,
               SQ=Sq, **colls)

    def assemble():
        out = torch.zeros((B, Sq, H, D), dtype=q.dtype)
        for g in range(G):
            b, h = divmod(g, H)
            for i, (o, n) in enumerate(qs):
                c = colls["O"].data_of(g, i).newest_copy()
                out[b, o:o + n, h, :] = torch.as_tensor(host_array(c.payload))
        return out

    return tp, assemble


def _native(tp, assemble):
    ex = NativeExecutor(tp, native_device=True)
    ex.run()
    ex.close()
    return assemble(), ex.device.stats


def _check_reference(out, q_full, k, v, causal):
    """``out`` against the dense reference of the full sequence's tail rows."""
    ref = attention_reference(q_full.float(), k.float(), v.float(), causal=causal)
    ref = ref[:, ref.shape[1] - out.shape[1]:]
    tol = TOL[out.dtype]
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=tol, atol=tol)


def _plane_counts(q, k, q_block, kv_block):
    """(G, query blocks' sizes, number of kv blocks)."""
    B, Sq, H, D = q.shape
    qs = [n for _o, n in attention.block_splits(Sq, q_block)]
    return B * H, qs, len(attention.block_splits(k.shape[1], kv_block))


@pytest.fixture
def cpu_device():
    """The pump's CUDA module on the torch CPU device; the param unset
    after."""
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    yield
    mca_param.unset("device", "cuda_torch_device")


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_pump_planes_alias_the_caller_and_o_is_write_only(case, cpu_device):
    """Through the native pump: every Q/K/V tile shares the caller's
    storage; the collections count 3 planes' views, copies only of the
    carries and blank O tiles; the device module gives each O a write-only
    placeholder and stages only Q, K, V and the carries; the answer is the
    clone-built graph's, bit for bit, and the dense reference's."""
    q, k, v, q_full = _inputs(case)
    kw = _kw(case)
    tp, assemble = attention.build_flash_attention(q, k, v, use_cpu=False, **kw)
    G, qs, nk = _plane_counts(q, k, kw["q_block"], kw["kv_block"])
    D = q.shape[-1]
    colls = {n: tp.constants[n] for n in ("Q", "K", "V", "O", "CA", "CM", "CL")}
    for name, src in (("Q", q), ("K", k), ("V", v)):
        for key in colls[name].tiles():
            tile = colls[name].data_of(*key).get_copy(0).payload
            assert tile.untyped_storage().data_ptr() == src.untyped_storage().data_ptr()
    out, dev = _native(tp, assemble)

    assert sum(colls[n].stats["view_tiles"] for n in "QKV") == G * (len(qs) + 2 * nk)
    carry_bytes = G * sum(n * (D + 2) * 4 for n in qs)
    assert sum(colls[n].stats["copied_bytes"] for n in ("CA", "CM", "CL")) == carry_bytes
    assert all(colls[n].stats["copied_tiles"] == 0 for n in "QKVO")
    assert colls["O"].stats["blank_tiles"] == G * len(qs)
    assert dev["wo_placeholders"] == G * len(qs)
    qkv_bytes = (q.numel() + k.numel() + v.numel()) * q.element_size()
    assert dev["bytes_in"] == qkv_bytes + carry_bytes

    want, want_dev = _native(*_cloned_pool(q, k, v, **kw))
    assert torch.equal(out, want)
    assert want_dev["bytes_in"] == dev["bytes_in"]
    _check_reference(out, q_full, k, v, kw["causal"])


@pytest.fixture(scope="module")
def host_ctx():
    c = parsec_tpu_torch.Context(nb_cores=3, devices=["cpu"])
    yield c
    c.fini()


@pytest.mark.parametrize("case", ["causal_f32", "ragged_causal_bf16", "decode_f32",
                                  "transposed_q_f32"])
def test_dynamic_host_bodies_equal_the_clone_built_graph(case, host_ctx):
    """The dynamic runtime with host bodies reads the view planes and
    overwrites the blank O tiles whole: the clone-built graph's answer, bit
    for bit, and the dense reference's."""
    q, k, v, q_full = _inputs(case, seed=1)
    kw = _kw(case)
    out = attention.run_flash_attention(host_ctx, q, k, v, use_cuda=False, **kw)
    tp, assemble = _cloned_pool(q, k, v, use_cuda=False, use_cpu=True, **kw)
    host_ctx.add_taskpool(tp)
    assert tp.wait(timeout=120)
    assert torch.equal(out, assemble())
    _check_reference(out, q_full, k, v, kw["causal"])


def _flow_mode(ptg, cls, flow):
    return next(f.mode for f in ptg.classes[cls].flows if f.name == flow)


@pytest.mark.parametrize("graph", ["flash", "ring", "bcast"])
def test_out_flow_is_write_only_in_the_flash_graph_alone(graph):
    """``attn_out.O`` is write-only in the flash graph; the ring graphs'
    planes travel between ranks and keep a read-write O."""
    if graph == "flash":
        ptg, want = attention.flash_attention_ptg(causal=True), AccessMode.OUT
    else:
        ptg, want = attention.ring_attention_ptg(variant=graph), AccessMode.INOUT
    assert _flow_mode(ptg, "attn_out", "O") == want


@pytest.mark.cuda
def test_card_prefill_equals_the_clone_built_graph():
    """The S=8192, 1024-block bfloat16 causal prefill through the pump on
    the card: bit for bit the clone-built graph's answer, with one
    write-only placeholder per output tile and only Q, K, V and the
    carries staged in."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: B5 has no CPU form")
    B, S, H, D, blk = 1, 8192, 2, 128, 1024
    gen = torch.Generator().manual_seed(7)
    q, k, v = torch.randn((3, B, S, H, D), generator=gen).to(torch.bfloat16)
    kw = dict(causal=True, q_block=blk, kv_block=blk)
    tp, assemble = attention.build_flash_attention(q, k, v, use_cpu=False, **kw)
    out, dev = _native(tp, assemble)
    want, want_dev = _native(*_cloned_pool(q, k, v, **kw))
    assert torch.equal(out, want)
    G, nq = B * H, S // blk
    assert dev["wo_placeholders"] == want_dev["wo_placeholders"] == G * nq
    assert sum(tp.constants[n].stats["view_tiles"] for n in "QKV") == 3 * G * nq
    assert dev["bytes_in"] == want_dev["bytes_in"] == 3 * q.nbytes + G * S * (D + 2) * 4
