"""The tutorial examples of the port (``parsec_tpu_torch.examples``) against
the JAX package's repo-root ``examples/``.

Each of the 18 examples runs twice on the CPU: the port's
``main(device="cpu")`` (the CUDA device module bound to the torch CPU
device, ``GraphExecutor`` eager, the kernel wrappers on their plain
versions) and the JAX script through ``runpy``, as
``tests/apps/test_examples.py`` runs it.  Their self-check lines must be
the same once errors and timings are masked and the device words mapped
(``_JAX_WORDS``).  Then the port's returned results are held against the
JAX package on the same inputs: ex12's R and packed LU bit for bit
against ``parsec_tpu.ops.run_qr``/``run_lu`` on host bodies, ex13's task
counts and activations equal to the JAX run's, ex14's band storage
exactly the JAX PTG's, ex10's ring and Ulysses outputs within 1e-4 of
``parsec_tpu.parallel.attention_reference``, ex08's and ex11's factors
within the JAX example's 1e-4 relative error of the JAX ``GraphExecutor``'s
(its Pallas kernels in interpret mode for ex11).  The card-only parts
(ex10's ring through the B5 wrapper, ex12's device-body runs, ex11 without
kernels) run here on the torch CPU device by their keyword arguments.
"""

import ast
import importlib
import os
import re
import runpy

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
from parsec_tpu.datadist import TiledMatrix as RefTiledMatrix  # noqa: E402
from parsec_tpu.datadist.band import diag_band_to_rect_ptg as ref_band_ptg  # noqa: E402
from parsec_tpu.dsl.xla_lower import GraphExecutor as RefGraphExecutor  # noqa: E402
from parsec_tpu.ops import cholesky_ptg as ref_cholesky_ptg  # noqa: E402
from parsec_tpu.ops import run_lu as ref_run_lu, run_qr as ref_run_qr  # noqa: E402
from parsec_tpu.parallel import attention_reference as ref_attention  # noqa: E402
from parsec_tpu_torch.ops import kernels  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLES = os.path.join(ROOT, "examples")

# (port module under parsec_tpu_torch.examples, JAX script under examples/)
EXAMPLES = [
    ("ex00_startstop", "ex00_startstop.py"),
    ("ex01_helloworld", "ex01_helloworld.py"),
    ("ex02_chain", "ex02_chain.py"),
    ("ex03_chain_multirank", "ex03_chain_multirank.py"),
    ("ex04_chaindata", "ex04_chaindata.py"),
    ("ex05_broadcast", "ex05_broadcast.py"),
    ("ex06_raw", "ex06_raw.py"),
    ("ex07_raw_ctl", "ex07_raw_ctl.py"),
    ("ex08_cuda_graph", "ex08_tpu_graph.py"),
    ("ex09_jdf_graph", "ex09_jdf_graph.py"),
    ("ex10_sequence_parallel", "ex10_sequence_parallel.py"),
    ("ex11_kernels_native", "ex11_pallas_native.py"),
    ("ex12_qr_lu", "ex12_qr_lu.py"),
    ("ex13_segmented_native_dist", "ex13_segmented_native_dist.py"),
    ("ex14_round4_features", "ex14_round4_features.py"),
    ("dtd.dtd_helloworld", os.path.join("dtd", "dtd_helloworld.py")),
    ("dtd.dtd_hello_arg", os.path.join("dtd", "dtd_hello_arg.py")),
    ("dtd.dtd_untied", os.path.join("dtd", "dtd_untied.py")),
]

# the JAX examples' device words and the port's, on the torch CPU device
_JAX_WORDS = (("one XLA computation", "one captured plan"),
              ("pallas-chored", "kernel-chored"),
              ("-device ring", "-position ring"))

_MASKS = (
    (re.compile(r"-?\d+\.\d+e[+-]\d+"), "<err>"),                        # errors
    (re.compile(r"\d+ tasks in [\d.]+ ms \([\d.]+ tasks/s\)"), "<timing>"),  # ex11
    (re.compile(r"\d+/(\d+) readers"), r"<racy>/\1 readers"),             # ex06's race
)


def _sorted_dicts(line: str) -> str:
    """A printed ``{rank: count}`` in rank order (ranks finish in any)."""
    return re.sub(r"\{[\d: ,]+\}", lambda m: repr(dict(sorted(
        ast.literal_eval(m.group(0)).items()))), line)


def _lines(out: str, words=()) -> list:
    lines = []
    for line in out.strip().splitlines():
        for jax_word, port_word in words:
            line = line.replace(jax_word, port_word)
        for pat, repl in _MASKS:
            line = pat.sub(repl, line)
        lines.append(_sorted_dicts(line))
    return lines


def _port(name: str, capsys, **kw):
    mod = importlib.import_module(f"parsec_tpu_torch.examples.{name}")
    result = mod.main(device="cpu", **kw)
    return result, capsys.readouterr().out


def _jax(script: str, capsys):
    runpy.run_path(os.path.join(JAX_EXAMPLES, script), run_name="__main__")
    return capsys.readouterr().out


def _ref_factor(S, nb, **ptg_kw):
    A = RefTiledMatrix(S.shape[0], S.shape[0], nb, nb, name="A",
                       dtype=np.float32).from_array(S)
    tp = ref_cholesky_ptg(use_tpu=True, use_cpu=False, **ptg_kw).taskpool(NT=A.mt, A=A)
    RefGraphExecutor(tp)()
    return np.tril(np.asarray(A.to_array()))


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


# -- the results each example returns, held against the JAX package ---------

def _check_ex08(res, jax_out):
    from parsec_tpu_torch.examples.ex08_cuda_graph import spd

    assert res["tasks"] == 20
    assert _rel(np.tril(res["factor"]), _ref_factor(spd(256), 64)) < 1e-4


def _check_ex10(res, jax_out):
    q, k, v = (jax.numpy.asarray(res[n].numpy()) for n in ("q", "k", "v"))
    ref = np.asarray(ref_attention(q, k, v, causal=True))
    for name in ("ring", "ulysses"):
        assert np.abs(res[name].numpy() - ref).max() < 1e-4, name
    assert "ring_kernels" not in res  # the B5 run is the card's by default


def _check_ex11(res, jax_out):
    from parsec_tpu_torch.examples.ex08_cuda_graph import spd

    assert _rel(np.tril(res["factor"]), _ref_factor(spd(256), 64, use_pallas=True)) < 1e-4
    assert res["native_tasks"] == 120
    S2 = spd(256, np.float64)
    assert np.allclose(res["native_factor"] @ res["native_factor"].T, S2,
                       rtol=1e-8, atol=1e-8)


def _check_ex12(res, jax_out):
    with parsec_tpu.Context(nb_cores=4) as ctx:
        A = RefTiledMatrix(128, 128, 32, 32, name="A", dtype=np.float64).from_array(res["A0"])
        ref_run_qr(ctx, A, use_tpu=False)
        B = RefTiledMatrix(128, 128, 32, 32, name="A", dtype=np.float64).from_array(res["B0"])
        ref_run_lu(ctx, B, use_tpu=False)
    assert np.array_equal(res["R"], np.asarray(A.to_array()))
    assert np.array_equal(res["LU"], np.asarray(B.to_array()))
    assert "R_device" not in res  # the device-body run is the card's by default


def _check_ex13(res, jax_out):
    line = next(x for x in jax_out.splitlines() if x.startswith("native-dist"))
    tasks = ast.literal_eval(re.search(r"tasks (\{.*?\})", line).group(1))
    acts = int(re.search(r"(\d+) activations", line).group(1))
    assert res["native_dist"]["tasks"] == dict(sorted(tasks.items()))
    assert res["native_dist"]["activations"] == acts


def _check_ex14(res, jax_out):
    mb, nt = 8, 4
    Af = np.random.default_rng(4).standard_normal((nt * mb, nt * mb))
    A = RefTiledMatrix(nt * mb, nt * mb, mb, mb, name="A").from_array(Af)
    B = RefTiledMatrix(mb + 1, nt * (mb + 2), mb + 1, mb + 2, name="B")
    with parsec_tpu.Context(nb_cores=2) as ctx:
        tp = ref_band_ptg(mb, mb).taskpool(NT=nt, A=A, B=B)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
    assert np.array_equal(res["band"], np.asarray(B.to_array()))
    base = np.arange(256.0).reshape(16, 16)
    assert np.array_equal(res["staged"][:, ::2], base[:, ::2] * 10.0)
    assert np.array_equal(res["staged"][:, 1::2], base[:, 1::2])
    assert len(res["rebind_factors"]) == 3


CHECKS = {"ex08_cuda_graph": _check_ex08, "ex10_sequence_parallel": _check_ex10,
          "ex11_kernels_native": _check_ex11, "ex12_qr_lu": _check_ex12,
          "ex13_segmented_native_dist": _check_ex13, "ex14_round4_features": _check_ex14}


@pytest.mark.parametrize("name,script", EXAMPLES, ids=[n for n, _ in EXAMPLES])
def test_example_matches_the_jax_example(name, script, capsys):
    """The port's example prints the JAX example's self-check lines (errors
    and timings masked) and returns results that agree with the JAX
    package."""
    res, port_out = _port(name, capsys)
    jax_out = _jax(script, capsys)
    assert _lines(port_out) == _lines(jax_out, _JAX_WORDS)
    assert isinstance(res, dict) and res
    if name in CHECKS:
        CHECKS[name](res, jax_out)


def test_ex10_ring_through_the_b5_wrapper(capsys):
    """ex10 with ``use_kernels=True`` (the card's default): one batched B5
    call a position a step, R² in all, the output within 1e-4 of the JAX
    oracle and of the einsum ring."""
    before = kernels.flash_attention_block.calls
    res, out = _port("ex10_sequence_parallel", capsys, use_kernels=True)
    assert kernels.flash_attention_block.calls - before == 8 * 8
    q, k, v = (jax.numpy.asarray(res[n].numpy()) for n in ("q", "k", "v"))
    ref = np.asarray(ref_attention(q, k, v, causal=True))
    assert np.abs(res["ring_kernels"].numpy() - ref).max() < 1e-4
    assert res["ring_kernels_diff"] < 1e-4
    assert "ex10 ring with the B5 kernel" in out


def test_ex11_without_kernels_is_ex08(capsys):
    """ex11 part 1 with ``use_kernels=False`` runs ex08's DAG: the same
    factor bit for bit, and within 1e-4 of the kernel run's."""
    plain, _ = _port("ex11_kernels_native", capsys, use_kernels=False, native=False)
    graph, _ = _port("ex08_cuda_graph", capsys)
    kern, _ = _port("ex11_kernels_native", capsys, native=False)
    assert np.array_equal(plain["factor"], graph["factor"])
    assert _rel(kern["factor"], plain["factor"]) < 1e-4
    assert "native_tasks" not in plain


def test_ex12_device_bodies_agree_with_the_jax_host_run(capsys):
    """ex12's device-body runs (the card's default) on the torch CPU
    device: the same residual gates, and the packed LU within 1e-12 of the
    JAX package's host run on the same input."""
    res, out = _port("ex12_qr_lu", capsys, device_bodies=True)
    assert res["qr_resid_device"] < 1e-10 and res["lu_resid_device"] < 1e-12
    with parsec_tpu.Context(nb_cores=4) as ctx:
        B = RefTiledMatrix(128, 128, 32, 32, name="A", dtype=np.float64).from_array(res["B0"])
        ref_run_lu(ctx, B, use_tpu=False)
    assert _rel(res["LU_device"], np.asarray(B.to_array())) < 1e-12
    assert "device bodies" in out
