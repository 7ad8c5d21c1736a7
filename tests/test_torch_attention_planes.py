"""The flash graph's planes as :func:`parsec_tpu_torch.ops.build_flash_attention`
builds them: Q, K and V tiles are views of the caller's tensors, the output
planes are write-only and never staged in, and the answers are those of the
same graph built from copied planes.  The online-softmax carries of the
flash and latent-attention graphs are task-made tiles: made on the device,
started by each chain's first step, never staged in nor written back.

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
from parsec_tpu_torch.dsl.cuda_graph import GraphExecutor  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import NativeExecutor  # noqa: E402
from parsec_tpu_torch.ops import attention, build_mla_attention, kernels  # noqa: E402
from parsec_tpu_torch.parallel import attention_reference  # noqa: E402
from parsec_tpu_torch.reference.mla import mla_attention, softmax_scale  # noqa: E402

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

    keys_q = [(g, i) for g in range(G) for i in range(len(qs))]
    keys_k = [(g, s) for g in range(G) for s in range(len(ks))]
    colls = {
        "Q": (plane(q, qs), keys_q), "K": (plane(k, ks), keys_k),
        "V": (plane(v, ks), keys_k),
        "O": (lambda g, i: torch.zeros((qs[i][1], D), dtype=q.dtype), keys_q),
    }
    colls = {n: attention.PlaneCollection(n, init, keys=keys)
             for n, (init, keys) in colls.items()}
    tp = attention.flash_attention_ptg(
        causal=causal, scale=1.0 / math.sqrt(D), q_block=q_block, kv_block=kv_block,
        q_offset=Sk - Sq, use_cuda=use_cuda, use_cpu=use_cpu,
    ).taskpool(G=G, NQ=len(qs), NK=len(ks), QB=q_block, KVB=kv_block, QOFF=Sk - Sq,
               SQ=Sq, ACCTILE=lambda g, i, s: (np.float32, (qs[i][1], D)),
               ROWTILE=lambda g, i, s: (np.float32, (qs[i][1], 1)), **colls)

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


def _chain(q, k, v, *, causal, q_block, kv_block, device="cpu"):
    """The flash chain run here, without a graph: per (batch, head) plane
    and query block, B5 step by step over the key blocks up to the causal
    horizon on carries made here (zeros, ``NEG_BIG``, zeros), then ``acc /
    l`` in q's dtype; on ``device``, the output on the host."""
    B, Sq, H, D = q.shape
    q_off = k.shape[1] - Sq
    out = torch.empty_like(q)
    for b in range(B):
        for h in range(H):
            for o, n in attention.block_splits(Sq, q_block):
                acc = torch.zeros((n, D), device=device)
                m = torch.full((n, 1), attention.NEG_BIG, device=device)
                l = torch.zeros((n, 1), device=device)
                qb = q[b, o:o + n, h].contiguous().to(device)
                for ko, kn in attention.block_splits(k.shape[1], kv_block):
                    if causal and ko > q_off + o + n - 1:
                        break  # past the block's horizon: the graph has no step
                    kb, vb = (t[b, ko:ko + kn, h].contiguous().to(device) for t in (k, v))
                    acc, m, l = kernels.flash_attention_block(
                        qb, kb, vb, acc, m, l, q_off + o, ko, causal=causal,
                        scale=1.0 / math.sqrt(D))
                out[b, o:o + n, h] = (acc / l).to(q.dtype).cpu()
    return out


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
    storage; the collections count 3 planes' views and blank O tiles and
    copy nothing; the device module gives each O a write-only placeholder,
    makes the carries on the device and stages only Q, K and V; the answer
    is the clone-built graph's, bit for bit, and the dense reference's."""
    q, k, v, q_full = _inputs(case)
    kw = _kw(case)
    tp, assemble = attention.build_flash_attention(q, k, v, use_cpu=False, **kw)
    G, qs, nk = _plane_counts(q, k, kw["q_block"], kw["kv_block"])
    D = q.shape[-1]
    colls = {n: tp.constants[n] for n in ("Q", "K", "V", "O")}
    assert not {"CA", "CM", "CL"} & set(tp.constants)
    for name, src in (("Q", q), ("K", k), ("V", v)):
        for key in colls[name].tiles():
            tile = colls[name].data_of(*key).get_copy(0).payload
            assert tile.untyped_storage().data_ptr() == src.untyped_storage().data_ptr()
    out, dev = _native(tp, assemble)

    assert sum(colls[n].stats["view_tiles"] for n in "QKV") == G * (len(qs) + 2 * nk)
    assert all(colls[n].stats["copied_tiles"] == colls[n].stats["copied_bytes"] == 0
               for n in "QKVO")
    assert colls["O"].stats["blank_tiles"] == G * len(qs)
    assert dev["wo_placeholders"] == G * len(qs)
    qkv_bytes = (q.numel() + k.numel() + v.numel()) * q.element_size()
    assert dev["bytes_in"] == qkv_bytes
    assert dev["bytes_out"] == G * sum(qs) * D * q.element_size()
    assert dev["scratch_tiles"] == 3 * G * len(qs)
    assert dev["scratch_bytes"] == G * sum(n * (D + 2) * 4 for n in qs)
    assert dev["scratch_h2d_bytes"] == 0

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


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_pump_equals_the_chain_run_step_by_step(case, cpu_device):
    """Through the pump, with carries made on the device and started by
    each chain's first step: bit for bit B5 called step by step on carries
    made here."""
    q, k, v, _q_full = _inputs(case, seed=2)
    kw = _kw(case)
    out, _dev = _native(*attention.build_flash_attention(q, k, v, use_cpu=False, **kw))
    assert torch.equal(out, _chain(q, k, v, **kw))


# -- the task-made carries of the flash and latent-attention graphs ---------------

MLA = dict(DN=128, R=64, DV=128, L=512)
MLA_SCALE = softmax_scale(MLA["DN"], MLA["R"], {"factor": 40, "mscale_all_dim": 0.707})


def _mla_inputs(B=1, S=80, H=2, seed=0):
    """q, c_kv, k_pe and kv_b_proj at DeepSeek-V2's widths, bfloat16."""
    g = torch.Generator().manual_seed(seed)
    dn, r, dv, lat = MLA["DN"], MLA["R"], MLA["DV"], MLA["L"]
    q = torch.randn(B, S, H, dn + r, generator=g)
    c = torch.randn(B, S, lat, generator=g)
    pe = torch.randn(B, S, r, generator=g)
    w = torch.randn(H * (dn + dv), lat, generator=g) / math.sqrt(lat)
    return [t.bfloat16() for t in (q, c, pe, w)]


def _graph(graph, inputs, **kw):
    """``(taskpool, assemble)`` of the flash (q, k, v) or the latent
    (q, c_kv, k_pe, w) graph, causal, in 16-row query blocks."""
    if graph == "mla":
        return build_mla_attention(*inputs, scale=MLA_SCALE, causal=True, q_block=16,
                                   kv_block=24, **kw)
    return attention.build_flash_attention(*inputs, causal=True, q_block=16,
                                           kv_block=12, **kw)


def _run(path, graph, inputs, ctx=None):
    """The graph's output through ``path``: ``native_pump`` (the CUDA
    module on the torch CPU device), ``graph_replay`` (the whole-DAG
    executor on the CPU, called twice, the output of each call),
    ``dynamic_host`` (host chores on ``ctx``)."""
    if path == "native_pump":
        return [_native(*_graph(graph, inputs, use_cpu=False))[0]]
    if path == "graph_replay":
        tp, assemble = _graph(graph, inputs, use_cpu=False)
        ex = GraphExecutor(tp, device="cpu")
        outs = []
        for _ in range(2):
            ex(block=True)
            outs.append(assemble())
        return outs
    tp, assemble = _graph(graph, inputs, use_cuda=False)
    ctx.add_taskpool(tp)
    assert tp.wait(timeout=120)
    return [assemble()]


@pytest.mark.parametrize("graph", ["flash", "mla"])
def test_carries_never_cross_the_link(graph, cpu_device):
    """Through the pump: what is staged in is exactly the inputs' bytes,
    what is written back exactly O's; every chain's three carries are
    made on the device (``scratch_tiles``) and none is staged in."""
    if graph == "mla":
        inputs = _mla_inputs(S=72)
        B, S, H, _ = inputs[0].shape
        dv, nk = MLA["DV"], -(-S // 24)
        made_before = 2 * B * H * nk  # kv_up's K and V tiles
    else:
        inputs = list(_inputs("ragged_causal_bf16")[:3])
        B, S, H, dv = inputs[0].shape
        made_before = 0
    nq = -(-S // 16)
    out, dev = _native(*_graph(graph, inputs, use_cpu=False))
    assert dev["bytes_in"] == sum(t.nbytes for t in inputs)
    assert dev["bytes_out"] == out.nbytes == B * S * H * dv * 2
    assert dev["scratch_tiles"] - made_before == 3 * B * H * nq
    assert dev["scratch_h2d_bytes"] == 0


@pytest.mark.parametrize("graph", ["flash", "flash_noncausal", "mla", "ring", "bcast"])
def test_carry_flows_take_new_at_the_first_step(graph):
    """``attn_step``'s carries are ``<- NEW`` at ``s == 0`` in the flash and
    latent graphs, typed by the taskpool's ``ACCTILE``/``ROWTILE`` (a
    ragged last query block's are shorter), and passed along the chain
    after; the ring graphs keep their ``CA``/``CM``/``CL`` collections."""
    if graph in ("ring", "bcast"):
        ptg = attention.ring_attention_ptg(variant=graph)
        step = ptg.classes["attn_rstep" if graph == "ring" else "attn_bstep"]
        for flow, coll in (("ACC", "CA"), ("M", "CM"), ("L", "CL")):
            srcs = [d.src for f in step.flows if f.name == flow for d in f.deps_in]
            assert len(srcs) == 1 and f"? {coll}(g, r)" in srcs[0]
        return
    if graph == "mla":
        inputs, dv = _mla_inputs(S=72), MLA["DV"]
        tp, _ = _graph(graph, inputs)
    else:
        inputs = list(_inputs("ragged_causal_bf16")[:3])
        dv = inputs[0].shape[-1]
        tp, _ = attention.build_flash_attention(*inputs, causal=graph == "flash",
                                                q_block=16, kv_block=12)
    assert not {"CA", "CM", "CL"} & set(tp.constants)
    nodes = tp.capture().nodes
    last = -(-inputs[0].shape[1] // 16) - 1
    rows = inputs[0].shape[1] - 16 * last
    for tid, node in nodes.items():
        if tid[0] != "attn_step":
            continue
        g, i, s = tid[1]
        for flow in ("ACC", "M", "L"):
            src = node.flow_sources[flow]
            if s == 0:
                assert src == ("new",), (tid, flow, src)
            else:
                assert src[:2] == ("task", ("attn_step", (g, i, s - 1))), (tid, flow, src)
    for i, n in ((0, 16), (last, rows)):
        assert tp.new_tile_spec("attn_step", "ACC", (0, i, 0)) == ((n, dv), np.float32)
        for flow in ("M", "L"):
            assert tp.new_tile_spec("attn_step", flow, (0, i, 0)) == ((n, 1), np.float32)


def _very_negative(graph):
    """Inputs whose logits are all below -200 in the first 24 query rows
    of every head (the running max must start at ``NEG_BIG``: from 0,
    ``exp`` would take every probability of those rows to 0), and the
    dense answer."""
    if graph == "mla":
        q, c, pe, w = _mla_inputs(S=64, seed=5)
        pe[..., 0] = 20.0
        q[:, :24, :, MLA["DN"]] = -120.0
        k_rows = [torch.cat((c[0].float() @ w[h * 256:h * 256 + 128].float().T,
                             pe[0].float()), 1) for h in range(q.shape[2])]
        logits = [q[0, :24, h].float() @ k_rows[h].T * MLA_SCALE for h in range(q.shape[2])]
        return [q, c, pe, w], mla_attention(q, c, pe, w, MLA_SCALE, True), logits
    q, k, v, _ = _inputs("causal_f32", seed=5)
    q, k = q.clone(), k.clone()
    k[..., 0] = 20.0
    q[:, :24, :, 0] = -60.0
    logits = [q[0, :24, h] @ k[0, :, h].T / math.sqrt(q.shape[-1]) for h in range(q.shape[2])]
    return [q, k, v], attention_reference(q, k, v, causal=True), logits


@pytest.mark.parametrize("path", ["native_pump", "graph_replay", "dynamic_host"])
@pytest.mark.parametrize("graph", ["flash", "mla"])
def test_very_negative_logits_match_the_dense_answer(graph, path, cpu_device, host_ctx):
    inputs, ref, logits = _very_negative(graph)
    assert all(bool((lg < -200).all()) for lg in logits)
    for out in _run(path, graph, inputs, host_ctx):
        assert bool(torch.isfinite(out).all())
        err = ((out.float() - ref.float()).abs().amax(-1) / ref.float().abs().amax(-1)).max()
        assert float(err) <= (0.02 if graph == "mla" else 2e-5)


@pytest.mark.parametrize("path", ["native_pump", "graph_replay", "dynamic_host"])
@pytest.mark.parametrize("graph", ["flash", "mla"])
def test_run_twice_gives_equal_outputs(graph, path, cpu_device, host_ctx):
    """A graph run again — replayed by one whole-DAG executor, or built
    again and run — starts its carries again: equal outputs."""
    inputs = _mla_inputs(S=56, seed=3) if graph == "mla" else \
        list(_inputs("ragged_causal_bf16", seed=3)[:3])
    outs = _run(path, graph, inputs, host_ctx)
    if path != "graph_replay":
        outs += _run(path, graph, inputs, host_ctx)
    assert len(outs) == 2 and torch.equal(outs[0], outs[1])


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
    the card: bit for bit the same chain run here step by step (B5 on
    carries made here), with one write-only placeholder per output tile,
    the carries made on the card and only Q, K and V staged in."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: B5 has no CPU form")
    B, S, H, D, blk = 1, 8192, 2, 128, 1024
    gen = torch.Generator().manual_seed(7)
    q, k, v = torch.randn((3, B, S, H, D), generator=gen).to(torch.bfloat16)
    kw = dict(causal=True, q_block=blk, kv_block=blk)
    tp, assemble = attention.build_flash_attention(q, k, v, use_cpu=False, **kw)
    out, dev = _native(tp, assemble)
    assert torch.equal(out, _chain(q, k, v, device="cuda", **kw))
    G, nq = B * H, S // blk
    assert dev["wo_placeholders"] == G * nq
    assert sum(tp.constants[n].stats["view_tiles"] for n in "QKV") == 3 * G * nq
    assert dev["bytes_in"] == 3 * q.nbytes
    assert dev["scratch_tiles"] == 3 * G * nq and dev["scratch_h2d_bytes"] == 0
