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
device — under the same rule, a third the trace stack: a traced pump
run through every tracer and PINS module, the dump read back and run
through the trace commands, and a fourth the serving plane and the live
planes: a RuntimeService with the flight recorder, the health exporter
(bound to 127.0.0.1 on an ephemeral port), the watchdog and the SLO
plane switched on, scraped, and read by ``serve-status``, ``top``,
``flightdump`` and the monitor, beside the native serve executor and a
rebound device executor.  A fifth lowers and runs array programs
(``parsec_tpu_torch.array``).  ``chip_smoke.py`` alone in a directory, or
on a machine without a GPU, exits non-zero and prints no result."""

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


TRACE_SCRIPT = textwrap.dedent("""
    import os, sys, tempfile
    import numpy as np
    from parsec_tpu_torch import mca_param
    from parsec_tpu_torch.analysis import hb
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.dsl.native_exec import NativeExecutor
    from parsec_tpu_torch.ops import cholesky_ptg
    from parsec_tpu_torch.profiling import (AlperfModule, DotGrapher, SDEModule,
                                            TaskProfiler, critpath, merge)
    from parsec_tpu_torch.profiling.binary import RankTraceSet, read_pbt
    from parsec_tpu_torch.profiling.checkers import IteratorsChecker
    from parsec_tpu_torch.profiling.overlap import measure_overlap
    from parsec_tpu_torch.profiling.tools import main as tools

    rng = np.random.default_rng(0)
    m = rng.standard_normal((64, 64)).astype(np.float32)
    A = TiledMatrix(64, 64, 16, 16, name="A", dtype=np.float32).from_array(
        m @ m.T + 64 * np.eye(64, dtype=np.float32))
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    d = tempfile.mkdtemp()
    mods = [TaskProfiler().install(), DotGrapher().install(), IteratorsChecker().install()]
    sde_mod, alperf = SDEModule(), AlperfModule()
    stats = {}
    with measure_overlap(stats, trace_dir=d):
        ex = NativeExecutor(cholesky_ptg(use_kernels=True).taskpool(NT=4, A=A),
                            native_device=True)
        assert ex.run() == 20
        ex.close()
    for mod in mods:
        mod.uninstall()
    sde_mod.disable()
    alperf.disable()
    p = os.path.join(d, "rank0.pbt")
    assert critpath.analyze(read_pbt(p))["n_tasks"] == 10
    assert merge.merge_traces([p])["metadata"]["ranks"] == [0]
    assert hb.analyze_trace(p) == []
    for argv in (["info", p], ["critpath", p], ["hbcheck", p],
                 ["merge", p, "-o", os.path.join(d, "m.json")]):
        assert tools(argv) == 0, argv
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "parsec_tpu"))
    print("TRACE LOADED", bad)
    assert not bad, bad
""")


def test_trace_stack_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A traced pump run through every tracer and PINS module of the
    port, the dump read back, merged, critpath'd and hbchecked, and the
    trace commands run: neither JAX nor the JAX package is loaded."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", TRACE_SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "TRACE LOADED []" in proc.stdout


LIVE_SCRIPT = textwrap.dedent("""
    import io, json, os, sys, tempfile, urllib.request
    from contextlib import redirect_stdout
    import numpy as np
    import torch
    for var in ("PARSEC_TPU_FLIGHT", "PARSEC_TPU_HEALTH", "PARSEC_TPU_WATCHDOG",
                "PARSEC_TPU_SLO"):
        os.environ[var] = "1"
    d = tempfile.mkdtemp()
    os.environ["PARSEC_TPU_FLIGHT_DIR"] = d
    from parsec_tpu_torch import mca_param
    from parsec_tpu_torch.dsl.native_exec import NativeExecutor, run_native
    from parsec_tpu_torch.ops import build_flash_attention
    from parsec_tpu_torch.profiling import monitor, tools
    from parsec_tpu_torch.profiling.binary import read_pbt
    from parsec_tpu_torch.serve import RuntimeService

    def decode(seed):
        rng = np.random.default_rng(seed)
        mk = lambda s: torch.from_numpy(rng.standard_normal((1, s, 2, 8)).astype(np.float32))
        return build_flash_attention(mk(8), mk(64), mk(64), causal=True, q_block=8,
                                     kv_block=16, use_cpu=False)

    sv = RuntimeService(nb_cores=2, cuda_device="cpu")
    ctx = sv.context
    host, port = ctx.health._httpd.server_address
    assert host == "127.0.0.1" and port > 0 and ctx.health.url.startswith("http://127.0.0.1:")
    hs = [sv.submit("decode", decode(i)[0]) for i in range(3)]
    assert all(h.wait(timeout=120) for h in hs)
    text = urllib.request.urlopen(ctx.health.url + "/metrics", timeout=10).read().decode()
    assert "parsec_serve_jobs_done_total" in text and "parsec_job_latency_seconds" in text
    out = io.StringIO()
    with redirect_stdout(out):
        assert tools.main(["serve-status", ctx.health.url]) == 0
        assert tools.main(["top", ctx.health.url, "--once"]) == 0
        assert tools.main(["flightdump", ctx.health.url, "-o", d]) == 0
        assert monitor.main([ctx.health.url]) == 0
    assert any(e["name"] == "tenant:decode" for e in read_pbt(os.path.join(d, "rank0.fr.pbt")))
    assert ctx.watchdog.status()["stalled"] is False
    assert sv.close(timeout=60)
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    counts = run_native([decode(7)[0], decode(8)[0]])
    assert counts[0] == counts[1] > 0, counts
    ex = NativeExecutor(decode(9)[0], native_device=True)
    ex.run()
    ex.rebind(decode(10)[0])
    ex.run()
    ex.close()
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "parsec_tpu"))
    print("LIVE LOADED", bad)
    assert not bad, bad
""")


def test_serving_and_live_planes_load_neither_jax_nor_the_jax_package(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", LIVE_SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "LIVE LOADED []" in proc.stdout


ARRAY_SCRIPT = textwrap.dedent("""
    import io, contextlib, sys
    import numpy as np
    import parsec_tpu_torch
    from parsec_tpu_torch import array as pa
    from parsec_tpu_torch.profiling import health, tools

    rng = np.random.default_rng(0)
    G = rng.standard_normal((20, 20)).astype(np.float32)
    rhs = rng.standard_normal((20, 2)).astype(np.float32)
    L = np.linalg.cholesky(G.astype(np.float64) @ G.T + 20 * np.eye(20))

    def program():
        A = pa.from_numpy(G, 8)
        B = pa.from_numpy(20 * np.eye(20, dtype=np.float32), 8)
        C = (A @ A.T + B).cholesky()
        return C, C.solve(pa.from_numpy(rhs, 8, 2))

    for kw in (dict(use_cuda=False), dict(use_cpu=False)):
        C, x = program()
        with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
            x.compute(ctx, others=[C], **kw)
            s = C.sum(ctx)
        assert np.allclose(np.tril(C.to_numpy()), L, atol=2e-3)
        assert abs(s - C.to_numpy().astype(np.float64).sum()) < 1e-6
    C, x = program()
    pa.lower([x, C], use_cuda=False).run_native(nthreads=2)
    assert np.allclose(x.to_numpy(), np.linalg.solve(L, rhs), atol=2e-3)
    with contextlib.redirect_stdout(io.StringIO()):
        assert tools.main(["lint", "array:mixed"]) == 0
    assert health._array_summary()["programs_lowered"] >= 4
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "parsec_tpu"))
    print("ARRAY LOADED", bad)
""")


def test_array_front_end_loads_neither_jax_nor_the_jax_package(tmp_path):
    """Importing parsec_tpu_torch.array, lowering and running a program on
    the CPU (host bodies, the CUDA module on the torch CPU device, the
    native engine), a reduction and ``tools lint array:mixed`` load
    neither JAX nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", ARRAY_SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "ARRAY LOADED []" in proc.stdout


def test_chip_smoke_fails_without_the_repo_and_without_a_gpu(tmp_path):
    """chip_smoke.py copied alone into a directory, and run from the
    checkout on a machine without a GPU: both exit non-zero and print no
    result line."""
    import shutil

    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for cwd in (alone, ROOT):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        env.pop("PYTHONPATH", None)
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
