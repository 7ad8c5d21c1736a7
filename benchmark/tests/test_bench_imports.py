"""Nothing that a run of the harness drives loads JAX or the JAX package:
a small cell run end to end on the CPU in a fresh interpreter, then its
loaded modules compared by whole top-level name."""

import json
import subprocess
import sys

from benchmark.harness.spec import ROOT

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


def _fresh(name, traffic):
    code = SCRIPT.format(root=str(ROOT), name=name, traffic=traffic)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_dpotrf_run_loads_no_jax():
    got = _fresh("dpotrf_f32.n32768-nb2048",
                 dict(n=256, nb=64, warm_n=192, warm_jobs=1, sample_jobs=1))
    assert got == {"rc": 0, "forbidden": [], "program": True}


def test_a_prefill_run_loads_no_jax():
    got = _fresh("prefill_ouro-2.6b.s65536-b8192",
                 dict(batch=1, seq=256, q_block=64, kv_block=64, warm_seq=128,
                      warm_jobs=1, sample_jobs=1))
    assert got == {"rc": 0, "forbidden": [], "program": True}


def test_run_py_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "dpotrf_f32.n32768-nb2048", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    import torch
    if torch.cuda.is_available():
        return  # on a card this is a real run, checked elsewhere
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
