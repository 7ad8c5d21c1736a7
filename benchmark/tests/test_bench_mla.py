"""The latent-attention (MLA) cell, ``prefill_deepseek-v2-lite.s65536-b8192``,
and the dpotrf cell at a 1024 tile: their pieces on the CPU at a small
size (the program's device module bound to the torch CPU device), and on
the card (marked ``cuda``) at the cell's own size.

A sound MLA run comes out correct; the FP8 control and a run with the
timed path broken underneath (K without its rotary part; the softmax
scale without YaRN's ``mscale**2``) come out above the cell's limit.  The
two new readers read nothing in an empty run, the reference matches an
independent einsum, the work counts match hand counts, and a run loads
no JAX."""

import json
import math
import subprocess
import sys
import time

import pytest
import torch

from benchmark.calibrate import readings
from benchmark.harness import cell as harness
from benchmark.harness import trace as tr
from benchmark.harness.cell import run_cell
from benchmark.harness.spec import ROOT, load_cell
from benchmark.reference.mla import mla_attention, softmax_scale
from benchmark.roofline import mla, work

MLA = "prefill_deepseek-v2-lite.s65536-b8192"
NB1024 = "dpotrf_f32.n32768-nb1024"
SMALL = dict(batch=1, seq=384, q_block=64, kv_block=64, warm_seq=128, warm_jobs=1,
             sample_jobs=2)
SEED = 2 ** 31 + 91  # wider than 32 signed bits, as a run's seed may be
SEEDS = [2 ** 31 + 911, 2 ** 31 + 912, 2 ** 31 + 913]
YARN = {"factor": 40, "mscale_all_dim": 0.707}


def _run(capsys, seconds=0.5, traffic=SMALL, name=MLA):
    cell = load_cell(name, traffic=traffic)
    rc = run_cell(cell, SEED, seconds, False, device="cpu", t_start=time.perf_counter())
    out = capsys.readouterr()
    assert rc == 0, out.err
    result = json.loads(out.out.strip().splitlines()[-1])
    assert f"bench: check {cell.entry.CHECKS[0]}" in out.err.strip().splitlines()[-1]
    return result


def test_a_sound_mla_run_is_correct(capsys):
    result = _run(capsys, seconds=10.0, traffic=dict(SMALL, seq=128))
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"gflops", "setup_s"}


def test_an_nb1024_run_is_correct(capsys):
    result = _run(capsys, traffic=dict(n=256, nb=64, warm_n=128, warm_jobs=1, sample_jobs=1),
                  name=NB1024)
    assert result["correct"] is True


@pytest.fixture
def fresh_graphs(monkeypatch):
    """Patched bodies take effect only in graphs built after the patch:
    start from an empty definition memo."""
    from parsec_tpu_torch.ops import attention

    monkeypatch.setattr(attention, "_PTG_MEMO", __import__("collections").OrderedDict())


@pytest.mark.parametrize("fault", ["K without its rotary part",
                                   "the scale without mscale squared"])
def test_mla_fault_is_not_correct(fault, capsys, monkeypatch, fresh_graphs):
    import parsec_tpu_torch.ops as ops
    from parsec_tpu_torch.ops import mla as mla_ops

    if fault.startswith("K"):
        real = mla_ops._make_kv_up_cuda

        def make(d_nope):
            body = real(d_nope)

            def kv_up(CB, PB, WB, K, V, **kw):
                k, v = body(CB, PB, WB, K, V, **kw)
                k[:, d_nope:] = 0
                return k, v
            return kv_up
        monkeypatch.setattr(mla_ops, "_make_kv_up_cuda", make)
    else:
        real_build = ops.build_mla_attention
        mscale = 0.1 * 0.707 * math.log(40) + 1

        def build(*a, scale, **kw):
            return real_build(*a, scale=scale / mscale ** 2, **kw)
        monkeypatch.setattr(ops, "build_mla_attention", build)
    result = _run(capsys)
    assert result["correct"] is False
    assert result["checks"]["out_err"]["value"] > result["checks"]["out_err"]["limit"]


def test_fp8_control_reads_above_the_limit_on_the_cpu():
    cell = load_cell(MLA, traffic=SMALL)
    limit = cell.limits["out_err"]["limit"]
    assert cell.limits["out_err"]["control"] == "fp8"
    for row in readings(cell, SEEDS[:2], ("fp8",), set(SEEDS), "cpu"):
        assert row["program"]["out_err"] <= limit < row["fp8"]["out_err"], row
        assert row["fp8"]["out_err"] >= 3 * row["program"]["out_err"], row


@pytest.mark.cuda
def test_mla_control_is_not_correct_on_the_card(card):
    cell = load_cell(MLA)
    limit = cell.limits["out_err"]["limit"]
    for row in readings(cell, SEEDS, ["fp8"], set(SEEDS), card):
        assert row["program"]["out_err"] <= limit < row["fp8"]["out_err"], row


def test_the_new_readers_read_nothing_in_an_empty_run():
    cell = load_cell(MLA)
    readers = {m.name: m.reader for m in cell.per_layer}
    assert {"mla_attn_roofline", "h2d_mb_per_job"} <= set(readers)
    for name in ("mla_attn_roofline", "h2d_mb_per_job"):
        assert readers[name].read(harness.Run()) is None
    # a traced window without B5 in it: the roofline reads nothing
    run = harness.Run(jobs=[{"attn_flops": 1.0, "attn_bytes": 1.0, "bytes_in": 5}],
                      precision="bf16", peaks=work.peaks())
    run.trace = tr.Summary(jobs=1, kernel_s=1.0, device_ops=[("mm_kernel", 1.0)])
    assert readers["mla_attn_roofline"].read(run) is None
    assert readers["h2d_mb_per_job"].read(run) == pytest.approx(5e-6)
    # and the old cells do not report them
    assert not {"mla_attn_roofline", "h2d_mb_per_job"} & {
        m.name for m in load_cell("prefill_ouro-2.6b.s65536-b8192").per_layer}


def test_mla_attn_roofline_reads_b5s_time_alone():
    p = work.peaks()
    flops = 989e12 * 0.5  # half a second of the bf16 peak
    run = harness.Run(jobs=[{"attn_flops": flops, "attn_bytes": 0.0}] * 2, precision="bf16",
                      peaks=p)
    run.trace = tr.Summary(jobs=2, kernel_s=30.0, device_ops=[
        ("void (anonymous namespace)::flash_block_kernel<__nv_bfloat16, 192, 128, false>", 10.0),
        ("void (anonymous namespace)::mm_kernel<2, true>", 20.0)])
    reader = {m.name: m.reader for m in load_cell(MLA).per_layer}["mla_attn_roofline"]
    assert reader.read(run) == pytest.approx(100.0 * 1.0 / 10.0)


def test_mla_work_counts_by_hand():
    pairs = work.causal_pairs_prefill(65536)
    assert pairs == 2147516416
    attn = mla.attention_flops(1, 16, 192, 128, pairs)
    assert attn == 2 * 320 * 16 * pairs == pytest.approx(2.199e13, rel=1e-3)
    assert mla.expansion_flops(1, 65536, 16, 512, 128, 128) == 2 * 65536 * 512 * 16 * 256
    # q, c, k_pe and the weight read once, the output written once
    assert mla.job_bytes(1, 2, 3, 5, 7, 2, 3, 4, 2) == (2 * 3 * 5 + 2 * 9 + 3 * 7 * 7
                                                        + 2 * 3 * 4) * 2
    assert mla.attention_bytes(1, 2, 3, 5, 4, 2) == 2 * 3 * (10 + 8) * 2


def _einsum_mla(q, c, pe, w, scale):
    B, S, H, dqk = q.shape
    dn = dqk - pe.shape[-1]
    w = w.reshape(H, -1, w.shape[-1])
    k = torch.cat((torch.einsum("bsl,hdl->bshd", c, w[:, :dn]),
                   pe[:, :, None].expand(B, S, H, pe.shape[-1])), -1)
    v = torch.einsum("bsl,hdl->bshd", c, w[:, dn:])
    lg = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    lg = lg.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(lg, -1), v)


def test_mla_reference_matches_an_einsum():
    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 37, 3, 24, generator=g)
    c, pe = torch.randn(2, 37, 16, generator=g), torch.randn(2, 37, 8, generator=g)
    w = torch.randn(3 * 28, 16, generator=g) / 4
    scale = softmax_scale(16, 8, YARN)
    want = _einsum_mla(*(t.double() for t in (q, c, pe, w)), scale)
    got = mla_attention(q, c, pe, w, scale, "float64", rows=10)
    assert got.dtype == torch.float64 and got.shape == (2, 37, 3, 12)
    assert float((got - want).abs().max()) < 1e-12
    f8 = mla_attention(q, c, pe, w, scale, "fp8", rows=16)
    err = float((f8.double() - want).abs().max())
    assert 1e-3 < err < 1.0, "the FP8 control rounds, and only by FP8's step"


def test_softmax_scale_is_the_published_layers():
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert softmax_scale(128, 64, YARN) == pytest.approx(mscale ** 2 / math.sqrt(192))
    assert softmax_scale(128, 64, YARN) == pytest.approx(0.114721, abs=1e-6)


SCRIPT = r"""
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark.harness.cell import forbidden_modules, run_cell, set_cache_env
from benchmark.harness.spec import load_cell
set_cache_env()
cell = load_cell({name!r}, traffic={traffic!r})
rc = run_cell(cell, 5, 0.3, True, device="cpu", t_start=time.perf_counter())
print(json.dumps({{"rc": rc, "forbidden": forbidden_modules(),
                   "program": "parsec_tpu_torch" in sys.modules}}))
"""


def test_an_mla_run_loads_no_jax():
    code = SCRIPT.format(root=str(ROOT), name=MLA,
                         traffic=dict(SMALL, seq=256, warm_seq=128, sample_jobs=1))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"rc": 0, "forbidden": [], "program": True}
