"""Import hygiene of the port, at run time: a fresh interpreter imports
every module of ``parsec_tpu_torch``, compiles and runs the JAX package's
``examples/jdf/cholesky.jdf`` on its CPU bodies through the port, runs a
module that the port's ``jdfc`` generated from it, and then neither JAX
nor the JAX package may be loaded (``tests/test_torch_runtime.py`` checks
the import statements; this checks what a run loads)."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, os, pkgutil, sys, tempfile
    import numpy as np
    import parsec_tpu_torch
    from parsec_tpu_torch.datadist import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl import compile_jdf_file, jdfc

    mods = [m.name for m in pkgutil.walk_packages(
        parsec_tpu_torch.__path__, "parsec_tpu_torch.")]
    for name in mods:
        importlib.import_module(name)

    path = os.path.join(sys.argv[1], "examples", "jdf", "cholesky.jdf")
    rng = np.random.default_rng(0)
    m = rng.standard_normal((64, 64))
    spd = m @ m.T + 64 * np.eye(64)

    def factor(tp_of):
        A = TwoDimBlockCyclic(64, 64, 16, 16, name="A").from_array(spd)
        with parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"]) as ctx:
            tp = tp_of(A)
            ctx.add_taskpool(tp)
            assert tp.wait(timeout=60)
        L = np.tril(A.to_array())
        assert np.allclose(L @ L.T, spd)
        return L

    L1 = factor(lambda A: compile_jdf_file(path).new(A=A, NT=A.mt))
    out = os.path.join(tempfile.mkdtemp(), "chol_gen.py")
    assert jdfc.main([path, "-o", out]) == 0
    spec = importlib.util.spec_from_file_location("chol_gen", out)
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    L2 = factor(lambda A: gen.new(A=A, NT=A.mt))
    assert np.array_equal(L1, L2)
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "parsec_tpu"))
    print("MODULES", len(mods), "LOADED", bad)
    assert not bad, bad
""")


def test_port_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, ROOT], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("MODULES"))
    assert int(line.split()[1]) > 40 and line.endswith("LOADED []")
