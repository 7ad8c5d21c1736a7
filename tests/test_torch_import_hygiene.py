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
(``parsec_tpu_torch.array``), a sixth the comm layer, and a seventh the
cross-rank readers (a traced, watched 4-rank dpotrf through
``run_multirank_perf``, the distributed segmented Cholesky, the engine's
no-op run), an eighth the collectives, ``CollectiveTask``, redistribution,
the array's cross-rank ``sum`` and the reshape engine, and a ninth the
SPMD layer (``parsec_tpu_torch.parallel`` on CPU positions: ring
attention with the B5 wrapper, Ulysses, the SPMD Cholesky, SUMMA, the
ring GEMM, the SPMD stencil, a broadcast) and the ring-attention graphs
at 2 ranks, and a tenth runs every tutorial example of
``parsec_tpu_torch.examples`` on the torch CPU device.  ``chip_smoke.py`` alone in a directory, or
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
    from parsec_tpu_torch.profiling.torch_spans import ProfilerSpans

    rng = np.random.default_rng(0)
    m = rng.standard_normal((64, 64)).astype(np.float32)
    A = TiledMatrix(64, 64, 16, 16, name="A", dtype=np.float32).from_array(
        m @ m.T + 64 * np.eye(64, dtype=np.float32))
    mca_param.set_param("device", "cuda_torch_device", "cpu")
    d = tempfile.mkdtemp()
    mods = [TaskProfiler().install(), DotGrapher().install(), IteratorsChecker().install(),
            ProfilerSpans().install()]
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


COMM_SCRIPT = textwrap.dedent("""
    import sys, threading
    import numpy as np
    import parsec_tpu_torch
    from parsec_tpu_torch import comm
    from parsec_tpu_torch.comm import payload, termdet_fourcounter  # noqa
    from parsec_tpu_torch.datadist import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    from parsec_tpu_torch.ops import cholesky_ptg, insert_dpotrf

    rng = np.random.default_rng(0)
    m = rng.standard_normal((64, 64)).astype(np.float32)
    spd = m @ m.T + 64 * np.eye(64, dtype=np.float32)
    for mode in ("ptg", "dtd"):
        ces = comm.InprocFabric(2).endpoints()
        ctxs = [parsec_tpu_torch.Context(nb_cores=2, rank=r, nranks=2,
                                         comm=ces[r], cuda_device="cpu")
                for r in range(2)]
        mats, oks = {}, {}

        def run(r):
            A = mats[r] = TwoDimBlockCyclic(64, 64, 16, 16, p=1, q=2,
                                            myrank=r, name="A",
                                            dtype=np.float32).from_array(spd)
            if mode == "ptg":
                tp = cholesky_ptg(use_cpu=False, use_kernels=True).taskpool(
                    NT=A.mt, A=A)
                ctxs[r].add_taskpool(tp)
                oks[r] = tp.wait(timeout=60)
            else:
                d = DTDTaskpool(ctxs[r], name="d")
                insert_dpotrf(d, A, use_cpu=False, use_kernels=True)
                d.flush_all()
                d.close()
                oks[r] = True

        ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
        [t.start() for t in ts]
        [t.join(120) for t in ts]
        for c in ctxs:
            c.fini()
        assert oks == {0: True, 1: True}, oks
        assert all(c.comm.remote_dep.stats["eager_sent"] > 0 for c in ctxs)
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "parsec_tpu"))
    print("COMM LOADED", bad)
""")


def test_comm_layer_loads_neither_jax_nor_the_jax_package(tmp_path):
    """Importing parsec_tpu_torch.comm and running a 2-rank PTG and DTD
    dpotrf over the in-process fabric (B1 chores on the CUDA module bound
    to the torch CPU device) load neither JAX nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", COMM_SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "COMM LOADED []" in proc.stdout


READERS_SCRIPT = textwrap.dedent("""
    import json, sys, tempfile
    import numpy as np
    from parsec_tpu_torch import native
    from parsec_tpu_torch.datadist import TwoDimBlockCyclic
    from parsec_tpu_torch.multirank import run_multirank_perf
    from parsec_tpu_torch.ops import cholesky_ptg
    from parsec_tpu_torch.ops.segmented_chol_dist import run_dist_segmented_cholesky
    from parsec_tpu_torch.profiling import critpath, health, merge
    from parsec_tpu_torch.profiling.tools import main as tools

    rng = np.random.default_rng(0)
    m = rng.standard_normal((64, 64)).astype(np.float32)
    spd = m @ m.T + 64 * np.eye(64, dtype=np.float32)
    wds, summ = [], []

    def build(r, ctx):
        wds.append(health.Watchdog(ctx, window=30.0, poll=0.05, strict=True).start())
        A = TwoDimBlockCyclic(64, 64, 16, 16, p=2, q=2, myrank=r, name="A",
                              dtype=np.float32).from_array(spd)
        return cholesky_ptg(use_cpu=False, use_kernels=True).taskpool(
            NT=A.mt, A=A), ctx

    d = tempfile.mkdtemp()
    ctxs, stats = run_multirank_perf(4, build, trace_dir=d, cuda_device="cpu")
    for wd in wds:
        wd.stop()
    assert not any(wd.stalled for wd in wds)
    assert all(health._comm_summary(c)["wire_bytes"] > 0 for c in ctxs)
    doc = json.load(open(stats["merged_trace"]))
    assert sorted(critpath.analyze_ranks(doc["traceEvents"])) == [0, 1, 2, 3]
    assert tools(["critpath", stats["merged_trace"], "--per-rank"]) == 0
    assert merge.last_handshake(1) is not None
    err, st = run_dist_segmented_cholesky(4, 128, 32, cuda_device="cpu")
    assert err < 1e-3 and st["executed_tasks"] == 4 + 6
    g = native.NativeGraph()
    ids = [g.add_task(0, i) for i in range(100)]
    for t in ids:
        g.commit(t)
    g.seal()
    assert g.run_noop(2) == 100
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "parsec_tpu"))
    print("READERS LOADED", bad)
""")


def test_cross_rank_readers_load_neither_jax_nor_the_jax_package(tmp_path):
    """A traced, watched 4-rank dpotrf through ``run_multirank_perf`` (the
    clock handshake, the per-rank traces, the merge, per-rank critpath,
    the comm summary), the distributed segmented Cholesky and the engine's
    no-op run load neither JAX nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", READERS_SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "READERS LOADED []" in proc.stdout


COLL_SCRIPT = textwrap.dedent("""
    import importlib, sys, threading
    import numpy as np
    import torch
    import parsec_tpu_torch
    from parsec_tpu_torch import array as pa
    from parsec_tpu_torch import comm
    from parsec_tpu_torch.data.reshape import ReshapeSpec, get_copy_reshape, materialize
    from parsec_tpu_torch.data import data_create
    from parsec_tpu_torch.datadist import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl import CollectiveTask
    from parsec_tpu_torch.dsl.dtd import AFFINITY, INOUT, DTDTaskpool
    from parsec_tpu_torch.profiling import health

    rd = importlib.import_module("parsec_tpu_torch.datadist.redistribute")
    ces = comm.InprocFabric(2).endpoints()
    ctxs = [parsec_tpu_torch.Context(nb_cores=2, rank=r, nranks=2, comm=ces[r],
                                     cuda_device="cpu") for r in range(2)]
    G = np.arange(24 * 24, dtype=np.float64).reshape(24, 24)
    out = {}

    def run(r):
        ctx, ce = ctxs[r], ces[r]
        for algo in ("ring", "rd", "gather"):
            h = ce.coll_allreduce(torch.arange(64.0) + r, algo=algo)
            assert h.wait(timeout=60)
            out[(r, algo)] = h.result()
        h = ce.coll_bcast(np.arange(8.0) if r == 0 else np.zeros(8), root=0)
        assert h.wait(timeout=60)
        X = TwoDimBlockCyclic(8, 16, 8, 8, p=1, q=2, myrank=r,
                              name="X").from_array(np.ones((8, 16)))
        t = DTDTaskpool(ctx, name="ctask")
        CollectiveTask.allreduce(t, lambda rank: X.data_of(0, rank))
        assert t.wait(timeout=60)
        out[(r, "ctask")] = np.array(X.data_of(0, r).newest_copy().payload)
        S = TwoDimBlockCyclic(24, 24, 8, 8, p=2, q=1, myrank=r, name="S").from_array(G)
        T = TwoDimBlockCyclic(24, 24, 6, 12, p=1, q=2, myrank=r, name="T2")
        tp = rd.redistribute(ctx, S, T, algo="coll", mem_budget=4096)
        assert tp.wait(timeout=60)
        A = pa.from_numpy(G, 8, dist=pa.BlockCyclic(2, 1), myrank=r, name="A")
        out[(r, "sum")] = A.sum(ctx)

    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    [t.start() for t in ts]
    [t.join(120) for t in ts]
    assert not any(t.is_alive() for t in ts)
    assert out[(0, "sum")] == out[(1, "sum")] == G.sum()
    assert all(np.array_equal(out[(r, "ctask")], np.full((8, 8), 2.0)) for r in range(2))
    assert all(torch.equal(out[(r, a)], torch.arange(64.0) * 2 + 1)
               for r in range(2) for a in ("ring", "rd", "gather"))
    assert health._coll_summary(ctxs[0])["ops_done"] >= 4
    assert "parsec_coll_ops_done_total" in health.prometheus_text(ctxs[0])
    r = materialize(get_copy_reshape(data_create("x", payload=np.arange(4.0)),
                                     ReshapeSpec(dtype="bfloat16")))
    assert r.newest_copy().payload.dtype == torch.bfloat16
    for c in ctxs:
        c.fini()
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "parsec_tpu"))
    print("COLL LOADED", bad)
""")


def test_collectives_and_redistribution_load_neither_jax_nor_the_jax_package(tmp_path):
    """The collectives at 2 ranks (ring, rd and gather allreduces of torch
    tensors, a bcast, a ``CollectiveTask`` in a DTD graph), a collective
    redistribution, the array's cross-rank ``sum``, the health plane's
    collective families and a bfloat16 reshape load neither JAX nor the
    JAX package."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", COLL_SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "COLL LOADED []" in proc.stdout


PARALLEL_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from parsec_tpu_torch import parallel
    from parsec_tpu_torch.ops import run_ring_attention_graph
    from parsec_tpu_torch.parallel import collectives
    from parsec_tpu_torch.parallel.shard_map import P, shard_map

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 32, 4, 8)).astype(np.float32))
               for _ in range(3))
    ring = parallel.make_mesh((4, 1), axes=("sp", "u"), devices=["cpu"] * 4)
    ref = parallel.attention_reference(q, k, v, causal=True)
    for use_kernels in (False, True):
        out = parallel.ring_attention(q, k, v, ring, axis="sp", causal=True,
                                      use_kernels=use_kernels)
        assert torch.allclose(out, ref, rtol=2e-5, atol=2e-5)
    assert torch.allclose(parallel.ulysses_attention(q, k, v, ring, axis="sp", causal=True),
                          ref, rtol=2e-5, atol=2e-5)
    out, stats = run_ring_attention_graph(2, q, k, v, causal=True, cuda_device="cpu",
                                          use_cpu=False)
    assert torch.allclose(out, ref, rtol=2e-5, atol=2e-5)
    grid = parallel.make_mesh((2, 2), devices=["cpu"] * 4)
    m = rng.standard_normal((32, 32))
    spd = torch.from_numpy(m @ m.T + 32 * np.eye(32))
    L = parallel.spmd_cholesky(spd, 8, mesh=grid).tril()
    assert torch.allclose(L @ L.T, spd)
    a = torch.from_numpy(m)
    assert torch.allclose(parallel.summa_gemm(a, a, grid), a @ a)
    assert torch.allclose(parallel.ring_gemm(a, a, ring, axis="sp"), a @ a)
    g = parallel.spmd_stencil_5pt(torch.ones(16, 16), 2, grid)
    assert g.shape == (16, 16)
    x = torch.arange(4.0).reshape(4, 1)
    b = shard_map(lambda t: collectives.bcast(t, "sp", root=2), ring, P("sp", None),
                  P("sp", None))(x)
    assert b.ravel().tolist() == [2.0] * 4
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "parsec_tpu"))
    print("PARALLEL LOADED", bad)
""")


def test_spmd_layer_and_ring_graphs_load_neither_jax_nor_the_jax_package(tmp_path):
    """The SPMD layer on CPU positions (ring attention with and without the
    B5 wrapper, Ulysses, the SPMD Cholesky, SUMMA, the ring GEMM, the SPMD
    stencil, a broadcast) and the ring-attention graph at 2 ranks load
    neither JAX nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", PARALLEL_SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "PARALLEL LOADED []" in proc.stdout


EXAMPLES_SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    import parsec_tpu_torch.examples as pkg

    mods = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
                  if m.name.rsplit(".", 1)[-1].startswith(("ex", "dtd_")))
    assert len(mods) == 18, mods
    for name in mods:
        importlib.import_module(name).main(device="cpu")
    bad = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("jax", "jaxlib", "parsec_tpu", "examples"))
    print("EXAMPLES", len(mods), "LOADED", bad)
""")


def test_examples_load_neither_jax_nor_the_jax_package(tmp_path):
    """Every module of ``parsec_tpu_torch.examples`` imported and its
    ``main(device="cpu")`` run in one fresh interpreter: neither JAX, nor
    the JAX package, nor the repo-root ``examples/`` is loaded."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", EXAMPLES_SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "EXAMPLES 18 LOADED []" in proc.stdout

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
