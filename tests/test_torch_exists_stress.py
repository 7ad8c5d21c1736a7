"""The port's existence-predicate work counter
(``parsec_tpu_torch.dsl.ptg.exists_eval_count``) against the JAX
package's, and the scaling law it pins.

The reference's ``tests/dsl/test_exists_stress.py``: resolving an
out-of-range producer reference must cost O(#params) — never a walk of
the producer's parameter space.  The web makes the producer's declared
span huge (a strided range keeps the instance count at 2) while every
consumer references a nonexistent instance, so an O(span) predicate
would show as work scaling with the span.  Both packages run the same
web; the port's counter must not grow with the span, and must count the
reference's work unit for unit.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.data import LocalCollection as RefLocalCollection  # noqa: E402
from parsec_tpu.dsl import ptg as ref_ptg_mod  # noqa: E402
from parsec_tpu_torch.core.lifecycle import AccessMode  # noqa: E402
from parsec_tpu_torch.data import LocalCollection  # noqa: E402
from parsec_tpu_torch.dsl import ptg as ptg_mod  # noqa: E402

IN = AccessMode.IN
INOUT = AccessMode.INOUT


def _sparse_web(mod, M, C):
    ptg = mod.PTG(f"exists_stress_{M}")
    prod = ptg.task_class("prod", i=f"0 .. {M} .. {M}")
    prod.affinity("D(0)")
    prod.flow("A", INOUT, "<- D(0)", "-> D(0)")
    cons = ptg.task_class("cons", j=f"0 .. {C - 1}")
    cons.affinity("D(0)")
    cons.flow("A", IN, "<- A prod(2*j + 1)")
    seen = {"none": 0, "data": 0}

    def prod_body(A, i):
        pass

    def cons_body(A, j):
        seen["none" if A is None else "data"] += 1

    prod.body(cpu=prod_body)
    cons.body(cpu=cons_body)
    return ptg, seen


def _run(port, M, C):
    mod, Ctx, Coll = ((ptg_mod, parsec_tpu_torch.Context, LocalCollection) if port
                      else (ref_ptg_mod, parsec_tpu.Context, RefLocalCollection))
    ctx = Ctx(nb_cores=2, devices=["cpu"])
    try:
        web, seen = _sparse_web(mod, M, C)
        dc = Coll("D", shape=(4,), dtype=np.float64)
        mod.reset_exists_eval_count()
        tp = web.taskpool(D=dc)
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=120)
        work = mod.exists_eval_count()
        assert seen["none"] == C, seen  # every consumer took that path
        return work
    finally:
        ctx.fini()


@pytest.mark.parametrize("dep_storage", [None])
def test_out_of_range_refs_do_not_scan_producer_span(dep_storage):
    C = 400
    small, big = 256, 16384  # 64x span growth, same 2-instance class
    w_small = _run(True, small, C)
    w_big = _run(True, big, C)
    assert w_small > 0
    assert w_big <= 2 * w_small, (
        f"existence resolution scales with producer span: "
        f"span {small}: {w_small} work units, span {big}: {w_big}")


def test_counter_counts_the_references_work():
    """The same web costs the same predicate work units in both
    packages."""
    assert _run(True, 256, 50) == _run(False, 256, 50)


def test_counter_reset_returns_the_old_value():
    ptg_mod.reset_exists_eval_count()
    pc = _sparse_web(ptg_mod, 8, 2)[0].classes["prod"]
    assert pc.instance_exists((8,), {}) and not pc.instance_exists((3,), {})
    assert ptg_mod.exists_eval_count() == 4  # two direct calls, one range check each
    assert ptg_mod.reset_exists_eval_count() == 4 and ptg_mod.exists_eval_count() == 0
