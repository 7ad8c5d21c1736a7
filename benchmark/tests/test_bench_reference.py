"""The plain references against NumPy at tiny sizes, and the TF32
rounding the controls use."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference.attention import causal_attention
from benchmark.reference.cholesky import blocked_cholesky_, componentwise_residual, plghe
from benchmark.reference.rounding import fp8_round, tf32_round


def test_plghe_is_symmetric_spd_and_seeded():
    a = plghe(64, 5, "cpu")
    assert torch.equal(a, a.mT) and torch.equal(a, plghe(64, 5, "cpu"))
    assert not torch.equal(a, plghe(64, 6, "cpu"))
    off = a - torch.diag(a.diagonal())
    assert off.abs().max() <= 0.5 and (a.diagonal() >= 64 - 0.5).all()
    assert torch.linalg.eigvalsh(a.double()).min() > 0


@pytest.mark.parametrize("n,nb", [(48, 16), (50, 16), (32, 32)])
def test_blocked_cholesky_matches_numpy(n, nb):
    a = plghe(n, 3, "cpu").double()
    want = np.linalg.cholesky(a.numpy())
    got = blocked_cholesky_(a.clone(), nb, "float64").numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert np.array_equal(np.triu(got, 1), np.zeros_like(got))


def test_blocked_cholesky_checks_its_dtype():
    with pytest.raises(ValueError):
        blocked_cholesky_(plghe(8, 1, "cpu"), 4, "float64")


def test_residual_separates_fp32_from_tf32_updates():
    a = plghe(512, 7, "cpu")
    exact = blocked_cholesky_(a.double(), 128, "float64")
    assert componentwise_residual(a, exact, 128) < 1e-14
    f32 = componentwise_residual(a, blocked_cholesky_(a.clone(), 128, "float32"), 128)
    tf32 = componentwise_residual(a, blocked_cholesky_(a.clone(), 128, "tf32"), 128)
    assert f32 < 2e-6 and tf32 > 10 * f32, (f32, tf32)


@pytest.mark.parametrize("fault", ["sign", "nan", "upper", "entry"])
def test_residual_fails_a_wrong_factor(fault):
    a = plghe(256, 8, "cpu")
    l = blocked_cholesky_(a.double(), 64, "float64")
    if fault == "sign":        # L D with D = +-1 gives the same L L^T
        l[:, 5] = -l[:, 5]
    elif fault == "nan":
        l[200, 3] = float("nan")
    elif fault == "upper":     # the check reads the lower triangle of L
        l[3, 200] = 1.0
    else:
        l[200, 3] *= 1 + 1e-4
    got = componentwise_residual(a, l.tril() if fault == "upper" else l, 64)
    if fault == "upper":
        assert got < 1e-14
    else:
        assert got > 1e-6


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.randn(10000, generator=torch.Generator().manual_seed(1))
    r = tf32_round(x)
    assert torch.equal(tf32_round(r), r)
    bits = r.view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    rel = ((r - x).abs() / x.abs()).max().item()
    assert 0 < rel <= 2.0 ** -11


def test_fp8_round_keeps_three_mantissa_bits():
    x = torch.randn(10000, generator=torch.Generator().manual_seed(3))
    r = fp8_round(x)
    assert r.dtype == torch.float32 and torch.equal(fp8_round(r), r)
    normal = x.abs() >= 2.0 ** -6
    rel = ((r - x).abs() / x.abs())[normal].max().item()
    assert 2.0 ** -6 < rel <= 2.0 ** -4


def _np_attention(q, k, v, scale):
    B, S, H, D = q.shape
    out = np.zeros((B, S, H, D))
    for b in range(B):
        for h in range(H):
            lg = q[b, :, h] @ k[b, :, h].T * scale
            lg[np.triu_indices(S, 1)] = -np.inf
            p = np.exp(lg - lg.max(-1, keepdims=True))
            out[b, :, h] = p @ v[b, :, h] / p.sum(-1, keepdims=True)
    return out


def test_causal_attention_matches_numpy():
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 37, 3, 8, generator=g) for _ in range(3))
    want = _np_attention(q.double().numpy(), k.double().numpy(), v.double().numpy(),
                         1 / math.sqrt(8))
    got = causal_attention(q, k, v, 1 / math.sqrt(8), "float64", rows=10)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() < 1e-12
    f8 = causal_attention(q, k, v, 1 / math.sqrt(8), "fp8", rows=16)
    err = np.abs(f8.double().numpy() - want).max()
    assert 1e-3 < err < 0.5, "the FP8 control rounds, and only by FP8's step"


def test_references_import_nothing_of_the_program():
    import ast
    from pathlib import Path

    for path in (Path(__file__).resolve().parents[1] / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in ("torch", "numpy", "__future__", "math"), \
                    f"{path.name} imports {m}"
