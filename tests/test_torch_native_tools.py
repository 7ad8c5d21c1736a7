"""The native engine's two reference tools in the port, held to the JAX
package's (``tests/dsl/test_native_sched.py``'s ``run_noop`` cases and
``tests/class/test_native_tsan.py``):

* ``NativeGraph.run_noop(nthreads)`` — the dispatch-bound run with a
  native no-op body: the same graphs execute the same task counts on both
  packages, under each scheduler policy, and ``gd`` never steals;
* the ThreadSanitizer flavor — ``build_tsan_library()`` compiles the
  shared ``native/src`` with ``-fsanitize=thread`` into the port's own
  ``_build/`` (beside the default flavor, never over it), with every
  engine symbol and the sanitizer's instrumentation; the suppressions
  file is the shared ``native/tsan.supp``; and the staging pipeline's
  thread layout runs race-free against the instrumented engine in a
  subprocess with the sanitizer runtime preloaded.
"""

import glob
import os
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("jax")

from parsec_tpu import native as ref_native  # noqa: E402
from parsec_tpu_torch import native  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wide_graph(mod, levels, width):
    """``levels`` fork-join levels of ``width`` kids each (the reference
    test's graph), built on package ``mod``'s engine."""
    g = mod.NativeGraph()
    prev, total = None, 0
    for _ in range(levels):
        src = g.add_task(0, 0)
        total += 1
        if prev is not None:
            g.add_dep(prev, src)
        kids = []
        for i in range(width):
            k = g.add_task(i % 7, 0)
            total += 1
            g.add_dep(src, k)
            kids.append(k)
        join = g.add_task(0, 0)
        total += 1
        for k in kids:
            g.add_dep(k, join)
        g.commit(src)
        for k in kids:
            g.commit(k)
        g.commit(join)
        prev = join
    g.seal()
    return g, total


@pytest.mark.parametrize("policy", ["lfq", "gd"])
def test_run_noop_executes_every_task_as_the_reference(policy):
    mine, n = _wide_graph(native, 4, 500)
    theirs, n_ref = _wide_graph(ref_native, 4, 500)
    mine.set_policy(policy)
    theirs.set_policy(policy)
    assert n == n_ref
    assert mine.run_noop(8) == theirs.run_noop(8) == n
    assert mine.executed == n and mine.quiesced()


def test_run_noop_gd_never_steals():
    g, n = _wide_graph(native, 4, 500)
    g.set_policy("gd")
    assert g.run_noop(8) == n
    assert g.steals == 0


def test_run_noop_chain_and_default_threads():
    """A serial chain through the no-op run at the default worker count
    (the reference's ``nthreads=2``), then a rerun after ``reset`` (which
    leaves every task uncommitted)."""
    for mod in (native, ref_native):
        g = mod.NativeGraph()
        ids = [g.add_task(0, i) for i in range(300)]
        for a, b in zip(ids, ids[1:]):
            g.add_dep(a, b)
        for t in ids:
            g.commit(t)
        g.seal()
        assert g.run_noop() == 300
    g.reset()
    for t in ids:
        g.commit(t)
    assert g.run_noop(4) == 300


def _tsan_supported() -> bool:
    if shutil.which("g++") is None:
        return False
    probe = subprocess.run(
        ["g++", "-fsanitize=thread", "-x", "c++", "-shared", "-fPIC",
         "-o", "/dev/null", "-"],
        input="int probe(){return 0;}", capture_output=True, text=True)
    return probe.returncode == 0


needs_tsan = pytest.mark.skipif(not _tsan_supported(),
                                reason="toolchain lacks -fsanitize=thread")


@needs_tsan
def test_tsan_flavor_compiles_with_engine_symbols():
    path = native.build_tsan_library()
    assert path == os.path.join(native.BUILD_DIR, "libparsec_core_tsan.so")
    assert os.path.dirname(path).endswith(os.path.join("parsec_tpu_torch", "_build"))
    nm = subprocess.run(["nm", "-D", path], capture_output=True, text=True)
    assert nm.returncode == 0
    for sym in ("pz_graph_run_async", "pz_task_done", "pz_graph_fail",
                "pz_graph_pop_batch", "pz_graph_done_batch",
                "pz_graph_sched_config", "pz_graph_events_drain",
                "pz_graph_run_noop", "pz_rq_new", "pz_rq_push", "pz_rq_pop"):
        assert sym in nm.stdout, f"{sym} missing from TSan flavor"
    assert "__tsan" in nm.stdout


@needs_tsan
def test_tsan_flavor_is_a_separate_artifact():
    """The flavors never clobber each other: the TSan build lives beside
    the default one, which still loads with every declared symbol."""
    tsan = native.build_tsan_library()
    default = native.build_library()
    assert tsan != default and os.path.exists(tsan) and os.path.exists(default)
    lib = native.load()
    assert all(hasattr(lib, s) for s in native.abi.required_symbols())


def test_suppressions_file_is_the_shared_one():
    p = native.tsan_suppressions_path()
    assert os.path.exists(p)
    assert os.path.samefile(p, ref_native.tsan_suppressions_path())
    assert "called_from_lib:libpython" in open(p).read()


def _tsan_runtime() -> str:
    for pat in ("/usr/lib/*/libtsan.so.*", "/usr/lib/*/libtsan.so",
                "/usr/lib/gcc/*/*/libtsan.so"):
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return ""


# the reference's staging-pipeline scenario against the port's TSan
# flavor: two pump threads racing pop_batch/done_batch, a transfer-lane
# analog on the zone allocator, and a committer analog draining the
# lifecycle-event ring while retires are recorded.  The port's ABI spec
# is loaded from its file (it imports only the standard library), so the
# subprocess never imports torch under the sanitizer.
_STAGING_SCENARIO = r"""
import ctypes, importlib.util, sys, threading

spec = importlib.util.spec_from_file_location("abi", sys.argv[2])
abi = importlib.util.module_from_spec(spec)
spec.loader.exec_module(abi)

lib = ctypes.CDLL(sys.argv[1])
abi.bind(lib)

g = lib.pz_graph_new()
N = 64
ids = [lib.pz_graph_add_task(g, 0, i) for i in range(N)]
for i in range(0, N - 1, 2):          # half chains, half independent
    lib.pz_graph_add_dep(g, ids[i], ids[i + 1])
lib.pz_graph_sched_config(g, 0, 0, -1)
lib.pz_graph_events_enable(g, 1)
for t in ids:
    lib.pz_graph_task_commit(g, t)
lib.pz_graph_seal(g)

stop = threading.Event()
errors = []

# the interpreter is uninstrumented, so Thread.join's happens-before edge
# is invisible to TSan: every g-touching thread ends with a cap-0 drain
# (takes the event mutex) to publish its trailing lock-free reads
def _hb_fence():
    lib.pz_graph_events_drain(g, None, None, None, 0)

def pump():
    buf = (ctypes.c_int64 * 8)()
    try:
        while not lib.pz_graph_quiesced(g):
            n = lib.pz_graph_pop_batch(g, buf, 8)
            if n > 0:
                lib.pz_graph_done_batch(g, buf, n)
        _hb_fence()
    except Exception as e:
        errors.append(e)

def stage_lane():
    z = lib.pz_zone_new(1 << 20)
    try:
        while not stop.is_set():
            offs = [lib.pz_zone_alloc(z, 4096, 64) for _ in range(16)]
            for o in offs:
                if o >= 0:
                    lib.pz_zone_release(z, o)
            lib.pz_zone_used(z)
    except Exception as e:
        errors.append(e)
    finally:
        lib.pz_zone_destroy(z)

def committer():
    k = (ctypes.c_int32 * 32)()
    a = (ctypes.c_int64 * 32)()
    b = (ctypes.c_int64 * 32)()
    try:
        while not stop.is_set():
            lib.pz_graph_events_drain(g, k, a, b, 32)
        while lib.pz_graph_events_drain(g, k, a, b, 32):
            pass
    except Exception as e:
        errors.append(e)

threads = [threading.Thread(target=pump), threading.Thread(target=pump),
           threading.Thread(target=stage_lane),
           threading.Thread(target=committer)]
for t in threads:
    t.start()
threads[0].join(60); threads[1].join(60)
stop.set()
threads[2].join(60); threads[3].join(60)
assert not errors, errors
assert lib.pz_graph_quiesced(g), "pump did not quiesce"
lib.pz_graph_destroy(g)
print("TSAN-SCENARIO-OK")
"""


@needs_tsan
def test_tsan_staging_threads_race_free(tmp_path):
    """The staging pipeline's thread layout against the INSTRUMENTED
    engine: a data race in pop/done vs zone vs event drain makes the
    sanitizer fail the subprocess (exitcode=66)."""
    rt = _tsan_runtime()
    if not rt:
        pytest.skip("no preloadable libtsan runtime")
    lib = native.build_tsan_library()
    script = tmp_path / "tsan_staging_scenario.py"
    script.write_text(_STAGING_SCENARIO)
    env = dict(os.environ)
    env.update({
        "LD_PRELOAD": rt,
        "TSAN_OPTIONS": "suppressions="
                        f"{native.tsan_suppressions_path()} exitcode=66 "
                        "halt_on_error=0",
    })
    proc = subprocess.run(
        [sys.executable, str(script), lib, native.abi.__file__],
        capture_output=True, text=True, timeout=240, env=env, cwd=_REPO)
    if proc.returncode != 0 and "ThreadSanitizer" not in proc.stderr:
        pytest.skip("TSan runtime refused to preload into the "
                    f"interpreter: {proc.stderr[-300:]}")
    assert "TSAN-SCENARIO-OK" in proc.stdout, (
        f"scenario failed\nstdout: {proc.stdout[-1000:]}\n"
        f"stderr: {proc.stderr[-2000:]}")
    assert "WARNING: ThreadSanitizer" not in proc.stderr, (
        "data race in the native staging/pump paths:\n" + proc.stderr[-4000:])
    assert proc.returncode == 0
