"""Import hygiene of the port, at run time: a fresh interpreter imports
every module of ``parsec_tpu_torch``, compiles and runs the JAX package's
``examples/jdf/cholesky.jdf`` on its CPU bodies through the port, runs a
module that the port's ``jdfc`` generated from it, and then neither JAX
nor the JAX package may be loaded (``tests/test_torch_runtime.py`` checks
the import statements; this checks what a run loads).  A second
interpreter drives the single-card core's modules — dense dependency
storage, a vpmap, ``user_trigger``, arenas, datatypes, a checkpoint, the
tiled-matrix operations, band storage, the template device and the legacy
ASYNC protocol with a mixed DAG on the CUDA module bound to the torch CPU
device — under the same rule."""

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


CORE_SCRIPT = textwrap.dedent("""
    import os, sys, tempfile
    import numpy as np
    import parsec_tpu_torch
    from parsec_tpu_torch import mca_param
    from parsec_tpu_torch.core.lifecycle import DEV_CUDA
    from parsec_tpu_torch.data import Arena, Vector, checkpoint
    from parsec_tpu_torch.datadist import TiledMatrix, apply_taskpool, reduce_taskpool
    from parsec_tpu_torch.datadist.band import (diag_band_to_rect_ptg,
                                                diag_band_to_rect_reference)
    from parsec_tpu_torch.device.template import DEV_TEMPLATE
    from parsec_tpu_torch.dsl import DTDTaskpool, INOUT
    from parsec_tpu_torch.dsl.native_exec import NativeExecutor
    from parsec_tpu_torch.ops import cholesky_ptg

    rng = np.random.default_rng(0)
    m = rng.standard_normal((64, 64)).astype(np.float32)
    spd = m @ m.T + 64 * np.eye(64, dtype=np.float32)

    ar = Arena((4,), np.float32, name="h")
    ar.release(ar.allocate())
    assert Vector(2, 2, 4, np.float32).pack(np.arange(8, dtype=np.float32)).tolist() == [0, 1, 4, 5]

    mca_param.set_param("runtime", "dep_storage", "dense")
    mca_param.set_param("runtime", "vpmap", "nb:2")
    A = TiledMatrix(64, 64, 16, 16, name="A", dtype=np.float32).from_array(spd)
    B = TiledMatrix(17, 4 * 18, 17, 18, name="B", dtype=np.float32)
    path = os.path.join(tempfile.mkdtemp(), "ck")
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu",
                                  devices=["cuda", "template"]) as ctx:
        tp = cholesky_ptg(use_kernels=True).taskpool(NT=4, A=A)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
        checkpoint.save(path, A)
        tp = diag_band_to_rect_ptg(16, 16).taskpool(NT=4, A=A, B=B)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
        assert reduce_taskpool(ctx, A, np.sum, lambda a, b: a + b).result is not None
        assert apply_taskpool(ctx, B, lambda t, i, j: t).wait(timeout=60)
        d = parsec_tpu_torch.data.data_create("x", payload=np.ones(2))
        dtd = DTDTaskpool(ctx)
        dtd.insert_task({DEV_TEMPLATE: lambda x: x * 2.0}, (d, INOUT))
        assert dtd.wait(timeout=60)
    factor = A.to_array()
    assert np.array_equal(B.to_array(), diag_band_to_rect_reference(factor, 16, 16, 4))
    C = TiledMatrix(64, 64, 16, 16, name="A", dtype=np.float32)
    assert checkpoint.restore(path, C) == 16 and np.array_equal(C.to_array(), factor)
    mca_param.unset("runtime", "dep_storage")

    t = parsec_tpu_torch.core.taskpool.Taskpool("u", termdet="user_trigger")
    assert type(t.tdm).__name__ == "TermDetUserTrigger"

    mca_param.set_param("device", "cuda_torch_device", "cpu")
    mca_param.set_param("runtime", "native_sched", "off")
    A2 = TiledMatrix(64, 64, 16, 16, name="A", dtype=np.float32).from_array(spd)
    ptg = cholesky_ptg(use_kernels=True)
    del ptg.classes["potrf"].bodies[DEV_CUDA]
    ex = NativeExecutor(ptg.taskpool(NT=4, A=A2), native_device=True)
    assert ex.run(nthreads=2) == 20 and ex.stats["completion_callbacks"] == 16
    ex.close()
    assert np.abs(A2.to_array() - factor).max() < 1e-3 * np.abs(factor).max()
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "parsec_tpu"))
    print("CORE LOADED", bad)
    assert not bad, bad
""")


def test_core_modules_load_neither_jax_nor_the_jax_package(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", CORE_SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "CORE LOADED []" in proc.stdout
