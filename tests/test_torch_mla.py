"""Latent attention (MLA) on the port: ``parsec_tpu_torch.ops.mla`` and its
pieces, at DeepSeek-V2's widths (q/k 192 = 128 + 64 rotary, v 128, latent
512) with a small sequence and few heads, on the CPU.

* the graph through the native pump (the CUDA module bound to the torch
  CPU device), the native engine's CPU regime and the dynamic runtime's
  host chores, against the plain reference
  ``parsec_tpu_torch/reference/mla.py``, causal and not, blocks that divide
  the sequence and blocks that do not;
* the task count against the captured graph;
* the task-made K and V tiles and carries: homes on the device only, none
  staged in (``scratch_h2d_bytes`` 0) and none written back or left on the
  device after ``close()``;
* B5's plain update at 192 / 128 and the wrapper's refusal of unequal
  widths it has no kernel for; the ``<- NEW`` users that were there
  before (default host zeros, the CPU regime, the host bodies) unchanged;
* the reference loads neither JAX nor the port.

The ``cuda`` case compares the card's 192 / 128 bf16 kernel with the plain
update and skips without a card.  The file imports neither JAX nor the JAX
package.
"""

import ast
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parsec_tpu_torch  # noqa: E402
from parsec_tpu_torch import mca_param  # noqa: E402
from parsec_tpu_torch.core.lifecycle import AccessMode  # noqa: E402
from parsec_tpu_torch.data.data import ScratchData  # noqa: E402
from parsec_tpu_torch.dsl import PTG  # noqa: E402
from parsec_tpu_torch.dsl.native_exec import NativeExecutor  # noqa: E402
from parsec_tpu_torch.ops import (build_mla_attention, kernels,  # noqa: E402
                                  mla_attention_task_count)
from parsec_tpu_torch.reference.mla import mla_attention, softmax_scale  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "parsec_tpu_torch", "reference", "mla.py")
DN, R, DV, L = 128, 64, 128, 512
SCALE = softmax_scale(DN, R, {"factor": 40, "mscale_all_dim": 0.707})
#: the graph's output against the float32 reference: the worst row's max
#: |O - O_ref| over its max |O_ref|.  The program rounds the expanded K and
#: V tiles and the output to bfloat16, each a relative 2**-9 (0.2%) at
#: most, and the logits' error from K's rounding moves every probability
#: by about as much: at these sizes, over two seeds, it reads 0.72-0.92%.
#: 0.02 is over twice the largest of those; the same comparison of the
#: reference with its inputs in FP8 E4M3 (the step below bfloat16) reads
#: 0.146 (:func:`test_the_tolerance_fails_fp8_operands`)
TOL = 0.02


def _inputs(B=2, S=200, H=2, seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, DN + R, generator=g)
    c = torch.randn(B, S, L, generator=g)
    pe = torch.randn(B, S, R, generator=g)
    w = torch.randn(H * (DN + DV), L, generator=g) / math.sqrt(L)
    return tuple(t.to(dtype) for t in (q, c, pe, w))


def _err(out, ref):
    return float(((out.float() - ref).abs().amax(-1) / ref.abs().amax(-1)).max())


@pytest.fixture
def cpu_device():
    """The pump's CUDA module on the torch CPU device; the param unset
    after."""
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    yield
    mca_param.unset("device", "cuda_torch_device")


def _native(inputs, causal, q_block, kv_block):
    tp, assemble = build_mla_attention(*inputs, scale=SCALE, causal=causal, q_block=q_block,
                                       kv_block=kv_block, use_cpu=False)
    ex = NativeExecutor(tp, native_device=True)
    ran = ex.run()
    ex.close()
    return assemble(), ran, ex


CASES = {"divides": (256, 64, 64), "ragged": (200, 64, 64), "uneven_blocks": (200, 64, 48)}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_graph_matches_the_reference(case, causal, cpu_device):
    S, qb, kvb = CASES[case]
    inputs = _inputs(S=S)
    out, ran, ex = _native(inputs, causal, qb, kvb)
    assert ex._pump
    assert out.shape == (2, S, 2, DV) and out.dtype == torch.bfloat16
    assert ran == mla_attention_task_count(2, S, 2, qb, kvb, causal=causal)
    assert _err(out, mla_attention(*inputs, SCALE, causal)) <= TOL


@pytest.mark.parametrize("runtime", ["native_cpu_regime", "host_chores"])
def test_host_bodies_match_the_reference(runtime):
    inputs = _inputs(S=200)
    tp, assemble = build_mla_attention(*inputs, scale=SCALE, causal=True, q_block=64,
                                       kv_block=48, use_cuda=False)
    if runtime == "native_cpu_regime":
        assert tp.run_native(nthreads=2) == mla_attention_task_count(2, 200, 2, 64, 48,
                                                                     causal=True)
    else:
        with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=120)
    assert _err(assemble(), mla_attention(*inputs, SCALE, True)) <= TOL


@pytest.mark.parametrize("shape", [(1, 256, 2, 64, 64), (2, 200, 3, 64, 48),
                                   (1, 100, 1, 32, 64), (1, 64, 2, 64, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_task_count_is_the_captured_graphs(shape, causal):
    B, S, H, qb, kvb = shape
    tp, _ = build_mla_attention(*_inputs(B=B, S=S, H=H), scale=SCALE, causal=causal,
                                q_block=qb, kv_block=kvb)
    nodes = tp.capture().nodes
    assert len(nodes) == mla_attention_task_count(B, S, H, qb, kvb, causal=causal)
    nk = -(-S // kvb)
    assert sum(1 for t in nodes if t[0] == "kv_up") == B * H * nk


def test_task_made_tiles_stay_on_the_device(cpu_device):
    """K and V homes, and every chain's carries, made on the device at
    their first touch: no host copy ever, no stage-in, not written back,
    dropped at close."""
    B, S, H, qb, kvb = 2, 200, 2, 64, 64
    inputs = _inputs(B=B, S=S, H=H)
    out, _ran, ex = _native(inputs, True, qb, kvb)
    st = ex.device.stats
    nk, nq = -(-S // kvb), -(-S // qb)
    made = 2 * B * H * nk + 3 * B * H * nq  # kv_up's K and V, the carries
    assert st["scratch_tiles"] == made
    assert st["scratch_bytes"] == B * H * S * (DN + R + DV) * 2 + B * H * S * (DV + 2) * 4
    assert st["scratch_h2d_bytes"] == 0
    scratch = list(ex._new_data.values())
    assert len(scratch) == made
    assert all(isinstance(d, ScratchData) and not d.copies for d in scratch)
    assert sorted({str(d.dtype) for d in scratch}) == ["float32", "torch.bfloat16"]
    # what crossed the link: q, the latent and rotary planes and the
    # weights once each; back: O alone
    assert st["bytes_in"] == (B * S * H * (DN + R) + B * S * (L + R) + H * (DN + DV) * L) * 2
    assert st["bytes_out"] == B * S * H * DV * 2


@pytest.mark.parametrize("transpose_b", [True, False])
def test_b2_writes_into_a_given_tile(transpose_b):
    """``kernels.matmul(..., out=)``, as ``kv_up`` writes V into its home:
    the product lands in ``out``, which is returned; a tile of another
    shape, dtype or layout is refused."""
    A = torch.randn(24, 16).bfloat16()
    Bm = torch.randn(8, 16).bfloat16()
    Bm = Bm if transpose_b else Bm.mT.contiguous()
    out = torch.empty(24, 8, dtype=torch.bfloat16)
    got = kernels.matmul(A, Bm, transpose_b=transpose_b, out=out)
    assert got is out
    assert torch.equal(out, kernels.matmul(A, Bm, transpose_b=transpose_b))
    for bad in (torch.empty(24, 9, dtype=torch.bfloat16), torch.empty(24, 8),
                torch.empty(8, 24, dtype=torch.bfloat16).mT):
        with pytest.raises(ValueError, match="out must be"):
            kernels.matmul(A, Bm, transpose_b=transpose_b, out=bad)


def test_staging_shares_the_latent_across_heads(cpu_device):
    """Each latent, rotary and weight tile is staged once a job while it
    stays resident, whatever number of heads reads it."""
    counts = []
    for H in (1, 4):
        _out, _ran, ex = _native(_inputs(B=1, S=128, H=H), True, 64, 64)
        counts.append(ex.device.stats["h2d_copies"])
    # 4 heads: 3 more heads' q tiles (2 q blocks) and weight slices, the
    # same 2 latent and 2 rotary tiles; the carries are made on the device
    assert counts[1] - counts[0] == 3 * (2 + 1)


def test_plain_update_at_192_128_matches_softmax():
    g = torch.Generator().manual_seed(3)
    q, k = torch.randn(37, 192, generator=g), torch.randn(53, 192, generator=g)
    v = torch.randn(53, 128, generator=g)
    acc, m, l = torch.zeros(37, 128), torch.full((37, 1), -1e30), torch.zeros(37, 1)
    a, m1, l1 = kernels.flash_attention_block_plain(q, k, v, acc, m, l, 20, 0, causal=True,
                                                    scale=SCALE, compute_dtype=torch.float64)
    assert a.shape == (37, 128) and m1.shape == l1.shape == (37, 1)
    logits = (q.double() @ k.double().T) * SCALE
    logits.masked_fill_(torch.arange(37)[:, None] + 20 < torch.arange(53)[None, :],
                        float("-inf"))
    want = torch.softmax(logits, -1) @ v.double()
    assert float((a / l1 - want).abs().max()) < 1e-12
    # and the wrapper's CPU path, on the widths the card's kernel takes
    b = kernels.flash_attention_block(q.bfloat16(), k.bfloat16(), v.bfloat16(), acc, m, l,
                                      20, 0, causal=True, scale=SCALE)
    assert b[0].shape == (37, 128)


@pytest.mark.parametrize("dtype,dqk,dv,mode", [
    (torch.bfloat16, 192, 128, "bf16"), (torch.bfloat16, 100, 64, "bf16"),
    (torch.float32, 192, 128, None), (torch.bfloat16, 256, 128, None),
    (torch.bfloat16, 192, 160, None), (torch.float32, 384, 384, "f32_wide")])
def test_attention_mode_of_unequal_widths(dtype, dqk, dv, mode):
    if mode is None:
        with pytest.raises(ValueError, match="unequal widths"):
            kernels._attention_mode(dtype, dtype, dtype, dqk, dv)
        q, k = torch.zeros(4, dqk, dtype=dtype), torch.zeros(4, dqk, dtype=dtype)
        v, acc = torch.zeros(4, dv, dtype=dtype), torch.zeros(4, dv)
        with pytest.raises(ValueError, match="unequal widths"):
            kernels.flash_attention_block(q, k, v, acc, torch.zeros(4, 1), torch.zeros(4, 1),
                                          0, 0)
    else:
        assert kernels._attention_mode(dtype, dtype, dtype, dqk, dv) == mode


def test_shapes_and_dtypes_are_checked():
    q, c, pe, w = _inputs(S=64)
    with pytest.raises(ValueError, match="do not agree"):
        build_mla_attention(q, c[:, :32], pe, w, scale=SCALE)
    with pytest.raises(ValueError, match="do not agree"):
        build_mla_attention(q, c, pe, w[:-1], scale=SCALE)
    with pytest.raises(TypeError, match="one dtype"):
        build_mla_attention(q, c.float(), pe, w, scale=SCALE)


# -- the <- NEW users that were there before -----------------------------------

def _new_chain(dtype_const=None, mode=AccessMode.OUT, host_x=False):
    """x(k) makes a NEW tile (``mode`` OUT: written whole; INOUT: k + 1
    added to its zeros), y(k) adds 1 to it and writes the result home into
    A(k).  ``host_x``: x has a CPU body alone."""
    from parsec_tpu_torch.datadist import TiledMatrix

    reads = bool(mode & AccessMode.IN)

    def x_cpu(T, k, **_):
        T[:] = (T if reads else 0.0) + k + 1.0

    def x_cuda(T, k, **_):
        return T + (k + 1.0) if reads else torch.full_like(T, k + 1.0)

    def y_cpu(T, D, **_):
        D[:] = T + 1.0

    def y_cuda(T, D, **_):
        return T + 1.0

    ptg = PTG("new_chain")
    x = ptg.task_class("x", k="0 .. NT-1")
    x.affinity("A(k, 0)")
    new = "<- NEW" + (" [type=TT]" if dtype_const else "")
    x.flow("T", mode, new, "-> T y(k)")
    x.body(**({"cpu": x_cpu} if host_x else {"cpu": x_cpu, "cuda": x_cuda}))
    y = ptg.task_class("y", k="0 .. NT-1")
    y.affinity("A(k, 0)")
    y.flow("T", AccessMode.IN, "<- T x(k)")
    y.flow("D", AccessMode.OUT, "<- A(k, 0)", "-> A(k, 0)")
    y.body(cpu=y_cpu, cuda=y_cuda)
    A = TiledMatrix(12, 4, 4, 4, name="A", dtype=np.float64).from_array(np.zeros((12, 4)))
    consts = dict(NT=3, A=A, TILE_SHAPE=(4, 4))
    if dtype_const:
        consts["TT"] = dtype_const
    return ptg.taskpool(**consts), A


@pytest.mark.parametrize("runtime,mode", [
    ("host_chores", AccessMode.OUT), ("native_cpu_regime", AccessMode.OUT),
    ("native_device", AccessMode.OUT), ("native_device", AccessMode.INOUT),
    ("native_device_host_producer", AccessMode.OUT)])
def test_new_tiles_of_other_graphs_unchanged(runtime, mode, cpu_device):
    """A NEW tile reads as zeros wherever it is first touched: on the host,
    on the device by a reader (device zeros, no stage-in), by a host body
    in a device DAG (host zeros, then staged for the device reader)."""
    tp, A = _new_chain(mode=mode, host_x=runtime.endswith("host_producer"))
    if runtime == "host_chores":
        with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=60)
        made = list(tp._new_tiles.values())
        assert made and all(isinstance(d.get_copy(0).payload, np.ndarray) for d in made)
    elif runtime == "native_cpu_regime":
        assert tp.run_native(nthreads=2) == 6
    else:
        ex = NativeExecutor(tp, native_device=True)
        assert ex.run() == 6
        ex.close()
        host_made = runtime.endswith("host_producer")
        assert ex.device.stats["scratch_tiles"] == (0 if host_made else 3)
        assert ex.device.stats["scratch_h2d_bytes"] == (3 * 16 * 8 if host_made else 0)
    want = np.repeat(np.arange(2.0, 5.0), 4)[:, None] * np.ones((1, 4))
    np.testing.assert_array_equal(A.to_array(), want)


def test_new_tile_spec_takes_bfloat16_and_a_function_of_the_producer():
    import torch as t

    tp, _A = _new_chain(dtype_const=lambda k: (t.bfloat16, (k + 1, 4)))
    assert tp.new_tile_spec("x", "T", (2,)) == ((3, 4), t.bfloat16)
    with pytest.raises(ValueError, match="producer's parameters"):
        tp.new_tile_spec("x", "T")
    tp2, _ = _new_chain(dtype_const=t.bfloat16)
    assert tp2.new_tile_spec("x", "T") == ((4, 4), t.bfloat16)


# -- the reference ----------------------------------------------------------------

def test_the_tolerance_fails_fp8_operands():
    """The comparison with :data:`TOL` fails a program whose inputs were
    FP8 E4M3 (the step below bfloat16): the reference computed so."""
    q, c, pe, w = _inputs(B=1, S=128, H=2, dtype=torch.float32)
    f8 = lambda x: x.to(torch.float8_e4m3fn).float()  # noqa: E731
    ref = mla_attention(q, c, pe, w, SCALE)
    got = mla_attention(f8(q), f8(c), f8(pe), f8(w), SCALE)
    assert _err(got, ref) > 2 * TOL


def test_reference_matches_a_loop_over_heads():
    q, c, pe, w = _inputs(B=1, S=40, H=2, dtype=torch.float64)
    got = mla_attention(q, c, pe, w, SCALE, causal=True)
    for h in range(2):
        wh = w[h * (DN + DV):(h + 1) * (DN + DV)]
        k = torch.cat((c[0] @ wh[:DN].T, pe[0]), 1)
        v = c[0] @ wh[DN:].T
        lg = q[0, :, h] @ k.T * SCALE
        lg = lg.masked_fill(torch.ones(40, 40, dtype=torch.bool).triu(1), float("-inf"))
        want = torch.softmax(lg.double(), -1) @ v
        assert float((got[0, :, h].double() - want).abs().max()) < 1e-5


def test_softmax_scale_folds_yarn_mscale():
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert SCALE == pytest.approx(mscale ** 2 / math.sqrt(192))
    assert softmax_scale(128, 64) == pytest.approx(192 ** -0.5)


def test_reference_imports_torch_alone_and_nothing_imports_it():
    tree = ast.parse(open(REFERENCE, encoding="utf-8").read())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append("." * node.level + (node.module or ""))
    assert set(mods) <= {"torch", "math", "__future__"}, mods
    pkg = os.path.join(ROOT, "parsec_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for fn in files:
            path = os.path.join(dirpath, fn)
            if fn.endswith(".py") and os.path.dirname(path) != os.path.dirname(REFERENCE):
                assert "reference.mla" not in open(path, encoding="utf-8").read(), path


def test_reference_loads_neither_jax_nor_the_port():
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('mla_ref', {REFERENCE!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "import torch\n"
        "q = torch.randn(1, 8, 1, 192); c = torch.randn(1, 8, 512); pe = torch.randn(1, 8, 64)\n"
        "w = torch.randn(256, 512)\n"
        "out = mod.mla_attention(q, c, pe, w, 0.1)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'parsec_tpu', 'parsec_tpu_torch'))\n"
        "print(json.dumps({'shape': list(out.shape), 'bad': bad}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"shape": [1, 8, 1, 128],
                                                                "bad": []}


# -- the card --------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: B5's 192 / 128 kernel has no CPU form")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,q_off,k_off,causal", [
    (512, 512, 0, 0, True), (512, 512, 0, 0, False), (100, 300, 250, 40, True),
    (37, 129, 0, 0, False), (64, 64, 0, 512, True)])
def test_card_192_128_kernel_matches_the_plain_update(sq, sk, q_off, k_off, causal, card):
    g = torch.Generator(device=card).manual_seed(11)
    q = torch.randn(sq, 192, generator=g, device=card).bfloat16()
    k = torch.randn(sk, 192, generator=g, device=card).bfloat16()
    v = torch.randn(sk, 128, generator=g, device=card).bfloat16()
    acc = torch.randn(sq, 128, generator=g, device=card)
    m = torch.randn(sq, 1, generator=g, device=card)
    l = torch.rand(sq, 1, generator=g, device=card) + 1
    got = kernels.flash_attention_block(q, k, v, acc, m, l, q_off, k_off, causal=causal,
                                        scale=SCALE)
    want = kernels.flash_attention_block_plain(q, k, v, acc, m, l, q_off, k_off, causal=causal,
                                               scale=SCALE, compute_dtype=torch.float64)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a.double() - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))
    if causal and q_off + sq - 1 < k_off:  # fully masked: the carry comes back exact
        assert all(torch.equal(a, b) for a, b in zip(got, (acc, m, l)))
