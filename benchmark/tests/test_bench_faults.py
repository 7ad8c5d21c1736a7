"""The harness drives a whole run on the CPU at a small size (the program's
device module bound to the torch CPU device, the kernels' plain versions),
skipping only its look for a card.  A sound run comes out correct; a run
with the timed path broken underneath comes out not correct, once for each
fault each cell can have."""

import collections
import json
import time

import pytest
import torch

from benchmark.harness.cell import run_cell
from benchmark.harness.spec import load_cell

DPOTRF = "dpotrf_f32.n32768-nb2048"
PREFILL = "prefill_ouro-2.6b.s65536-b8192"
SMALL = {
    DPOTRF: dict(n=384, nb=64, warm_n=192, warm_jobs=1, sample_jobs=2),
    PREFILL: dict(batch=1, seq=384, q_block=64, kv_block=64, warm_seq=128, warm_jobs=1,
                  sample_jobs=2),
}
SEED = 2 ** 31 + 77  # wider than 32 signed bits, as the driver's seeds are


def _run(name, capsys, seconds=0.5):
    cell = load_cell(name, traffic=SMALL[name])
    rc = run_cell(cell, SEED, seconds, False, device="cpu", t_start=time.perf_counter())
    out = capsys.readouterr()
    assert rc == 0, out.err
    result = json.loads(out.out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert f"bench: check {cell.entry.CHECKS[0]}" in out.err.strip().splitlines()[-1]
    return result


@pytest.fixture
def fresh_graphs(monkeypatch):
    """Patched attention bodies take effect only in graphs built after the
    patch: start from an empty definition memo."""
    from parsec_tpu_torch.ops import attention

    monkeypatch.setattr(attention, "_PTG_MEMO", collections.OrderedDict())
    return attention


@pytest.mark.parametrize("name", [DPOTRF, PREFILL])
def test_a_sound_run_is_correct(name, capsys):
    result = _run(name, capsys, seconds=3.0)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"gflops", "setup_s"}


def _unchanged_update(A, B1, B2, **_):
    return A.clone()


def _altered_potrf(T, **kw):
    from parsec_tpu_torch.ops import tiles

    L = tiles.torch.linalg.cholesky_ex(T)[0].contiguous()
    if kw.get("k") == 1:
        L[-1, 0] += 1e-3 * L.abs().max()
    return L


@pytest.mark.parametrize("fault", ["update returns its tile unchanged",
                                   "a factor tile altered where it is produced"])
def test_dpotrf_fault_is_not_correct(fault, capsys, monkeypatch):
    from parsec_tpu_torch.ops import tiles

    if fault.startswith("update"):
        monkeypatch.setattr(tiles, "gemm_update_kernel", _unchanged_update)
    else:
        monkeypatch.setattr(tiles, "potrf_cuda", _altered_potrf)
    result = _run(DPOTRF, capsys)
    assert result["correct"] is False
    assert result["checks"]["residual"]["value"] > result["checks"]["residual"]["limit"]


@pytest.mark.parametrize("fault", ["step returns its state unchanged",
                                   "half of the heads left out",
                                   "an output altered where it is produced"])
def test_prefill_fault_is_not_correct(fault, capsys, monkeypatch, fresh_graphs):
    from parsec_tpu_torch.ops import kernels

    attention = fresh_graphs
    real_step, real_out = kernels.flash_attention_block, attention._attn_out_cuda
    if fault.startswith("step"):
        def step(q, k, v, acc, m, l, q_off, k_off, **kw):
            if k_off > 0:
                return acc.clone(), m.clone(), l.clone()
            return real_step(q, k, v, acc, m, l, q_off, k_off, **kw)
        step.__dict__.update(real_step.__dict__)  # the launch counters
        monkeypatch.setattr(kernels, "flash_attention_block", step)
    elif fault.startswith("half"):
        def out(ACC, M, L, O, g, **kw):
            o = real_out(ACC, M, L, O, **kw)
            return torch.zeros_like(o) if g % 2 else o
        monkeypatch.setattr(attention, "_attn_out_cuda", out)
    else:
        def out(ACC, M, L, O, g, i, **kw):
            o = real_out(ACC, M, L, O, **kw)
            if g == 1 and i == 2:
                o[3, 5] += 0.1 * o.abs().max()
            return o
        monkeypatch.setattr(attention, "_attn_out_cuda", out)
    result = _run(PREFILL, capsys)
    assert result["correct"] is False
    assert result["checks"]["out_err"]["value"] > result["checks"]["out_err"]["limit"]
