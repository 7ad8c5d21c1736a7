"""The rest of the port's single-card core against the JAX package's: the
``user_trigger`` termination monitor (parsec_tpu_torch.core.termdet), the
template device module (parsec_tpu_torch.device.template), and the
virtual-process maps with core binding (parsec_tpu_torch.utils.binding,
``runtime_vpmap`` / ``runtime_bind_threads`` in ``Context``).

* ``tests/runtime/test_termdet_user_trigger.py``'s two cases on both
  packages, plus the refusal at more than one rank (ROADMAP A.8);
* ``tests/runtime/test_template_device.py``'s three cases, the JAX
  package's TPU module replaced by the CUDA module bound to the torch CPU
  device, and the same tiles in both packages;
* the VP maps equal the reference's for every spec, ``Context`` honors the
  param (invalid specs are fatal) and pins its workers when asked.
"""

import os
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.core import task as ref_task  # noqa: E402
from parsec_tpu.core.lifecycle import HookReturn as RefHookReturn  # noqa: E402
from parsec_tpu.core.taskpool import Taskpool as RefTaskpool  # noqa: E402
from parsec_tpu.data import data_create as ref_data_create  # noqa: E402
from parsec_tpu.device.template import TemplateDevice as RefTemplateDevice  # noqa: E402
from parsec_tpu.dsl import DTDTaskpool as RefDTD, INOUT as REF_INOUT  # noqa: E402
from parsec_tpu.utils import binding as ref_binding  # noqa: E402
from parsec_tpu.utils import mca_param as ref_mca_param  # noqa: E402
from parsec_tpu_torch import DEV_CUDA, mca_param  # noqa: E402
from parsec_tpu_torch.core import task as port_task  # noqa: E402
from parsec_tpu_torch.core.lifecycle import HookReturn  # noqa: E402
from parsec_tpu_torch.core.taskpool import Taskpool  # noqa: E402
from parsec_tpu_torch.core.termdet import TermDetUserTrigger  # noqa: E402
from parsec_tpu_torch.data import data_create  # noqa: E402
from parsec_tpu_torch.device.template import DEV_TEMPLATE, TemplateDevice  # noqa: E402
from parsec_tpu_torch.dsl.dtd import DTDTaskpool, INOUT, stage_to_cpu  # noqa: E402
from parsec_tpu_torch.utils import binding  # noqa: E402
from parsec_tpu_torch.utils.debug import FatalError  # noqa: E402

REF = dict(Context=lambda **kw: parsec_tpu.Context(nb_cores=2, devices=["cpu"], **kw),
           Taskpool=RefTaskpool, t=ref_task, Done=RefHookReturn.DONE)
PORT = dict(Context=lambda **kw: parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"], **kw),
            Taskpool=Taskpool, t=port_task, Done=HookReturn.DONE)


# ---------------------------------------------------------------------------
# tests/runtime/test_termdet_user_trigger.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_user_trigger_holds_until_triggered(P):
    t = P["t"]
    done = []
    with P["Context"]() as ctx:
        tp = P["Taskpool"]("ut", termdet="user_trigger")
        tc = t.TaskClass("noop", chores=[t.Chore("cpu", lambda es, x: P["Done"])])
        tc.release_deps = lambda es, x: []
        tp.add_task_class(tc)
        tp.on_complete = lambda _tp: done.append(True)
        tp.startup_hook = lambda c, _tp: [t.Task(_tp, tc, (i,)) for i in range(8)]
        ctx.add_taskpool(tp)
        # the tasks retire, but the pool must NOT terminate before the trigger
        assert not tp.wait(timeout=0.3)
        assert not done
        tp.tdm.trigger(tp)
        assert tp.wait(timeout=10)
        assert done == [True]
    assert type(tp.tdm).__name__ == "TermDetUserTrigger"


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_user_trigger_waits_for_task_drain(P):
    """A trigger before the tasks finish: termination still waits for the
    drain (``is_done`` polled directly: a participating ``wait`` would
    block the caller inside the slow hooks).  The hooks signal an event
    once they run, so the trigger lands while they do."""
    t = P["t"]
    running = threading.Event()
    release = threading.Event()

    def hook(es, x):
        running.set()
        release.wait(timeout=10)
        return P["Done"]

    with P["Context"]() as ctx:
        tp = P["Taskpool"]("ut2", termdet="user_trigger")
        tc = t.TaskClass("slow", chores=[t.Chore("cpu", hook)])
        tc.release_deps = lambda es, x: []
        tp.add_task_class(tc)
        tp.startup_hook = lambda c, _tp: [t.Task(_tp, tc, (i,)) for i in range(2)]
        ctx.add_taskpool(tp)
        ctx.start()
        assert running.wait(timeout=10)
        tp.tdm.trigger(tp)
        assert not tp.is_done()  # the trigger alone must not terminate
        release.set()
        assert tp.wait(timeout=10)


def test_user_trigger_is_never_auto_selected_and_resets():
    assert type(Taskpool("x").tdm).__name__ == "TermDetLocal"
    td = TermDetUserTrigger()
    tp = Taskpool("y")
    fired = []
    td.monitor_taskpool(tp, lambda _tp: fired.append(1))
    td.taskpool_ready(tp)
    td.trigger(tp)
    assert fired == [1] and td.is_terminated(tp)
    td.reset()
    assert not td.is_terminated(tp) and not td._triggered


def test_task_class_takes_dependencies_goal():
    """``TaskClass(..., dependencies_goal=)`` is stored as the reference
    stores it (ROADMAP C.9); the default is 0 on both."""
    from parsec_tpu.core.task import TaskClass as RefTaskClass
    from parsec_tpu_torch.core.task import TaskClass

    mine, theirs = TaskClass("x", dependencies_goal=2), RefTaskClass("x", dependencies_goal=2)
    assert mine.dependencies_goal == theirs.dependencies_goal == 2
    assert TaskClass("y").dependencies_goal == RefTaskClass("y").dependencies_goal == 0


def test_user_trigger_refuses_more_than_one_rank():
    """On a multi-rank context each rank triggers its own monitor, as the
    reference does: the trigger gates this rank's pool alone and raises
    nothing (the two-rank run is ``tests/test_torch_coll.py``'s)."""
    tp = Taskpool("z", termdet="user_trigger")
    tp.context = type("Ctx", (), {"nranks": 2})()
    tp.tdm.trigger(tp)
    assert tp.tdm._triggered


# ---------------------------------------------------------------------------
# tests/runtime/test_template_device.py
# ---------------------------------------------------------------------------

def test_template_inert_by_default():
    with parsec_tpu.Context(nb_cores=2) as ctx:
        assert not any(isinstance(d, RefTemplateDevice) for d in ctx.devices)
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
        assert [d.mca_name for d in ctx.devices] == ["cpu", "cuda"]
    mca_param.set_param("device", "template_enabled", 1)
    try:
        with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu") as ctx:
            assert [d.mca_name for d in ctx.devices] == ["cpu", "cuda", "template"]
    finally:
        mca_param.unset("device", "template_enabled")


def _times_three(x):
    return x * 3.0


def test_explicit_selection_attaches_and_executes():
    res = []
    for ctx, dc, DTD, key, cls, stage in (
            (parsec_tpu.Context(nb_cores=2, devices=["tpu", "template"]),
             ref_data_create, RefDTD, "template", RefTemplateDevice, None),
            (parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu",
                                      devices=["cuda", "template"]),
             data_create, DTDTaskpool, DEV_TEMPLATE, TemplateDevice, stage_to_cpu)):
        with ctx:
            tdev = next(d for d in ctx.devices if isinstance(d, cls))
            d = dc("x", payload=np.full(4, 2.0))
            tp = DTD(ctx)
            tp.insert_task({key: _times_three}, (d, REF_INOUT if stage is None else INOUT))
            assert tp.wait(timeout=30)
            res.append((np.array(d.newest_copy().payload), tdev.stats["executed_tasks"],
                        d.newest_copy().device_index))
    assert np.array_equal(res[0][0], res[1][0])
    np.testing.assert_array_equal(res[1][0], 6.0)
    assert res[0][1:] == res[1][1:] == (1, 0)


def _one_output_for_two(x, y):
    return x + 1.0


def test_wrong_output_count_is_reported():
    """A body returning N outputs for M writable flows fails the pool with
    the CPU path's ValueError (not a bare StopIteration)."""
    for ctx, dc, DTD, mode in (
            (parsec_tpu.Context(nb_cores=2, devices=["tpu", "template"]),
             ref_data_create, RefDTD, REF_INOUT),
            (parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu",
                                      devices=["cuda", "template"]),
             data_create, DTDTaskpool, INOUT)):
        with ctx:
            d1 = dc("a", payload=np.zeros(2))
            d2 = dc("b", payload=np.zeros(2))
            tp = DTD(ctx)
            tp.insert_task({"template": _one_output_for_two}, (d1, mode), (d2, mode))
            assert tp.wait(timeout=30) is False
            assert tp.failed
    assert "1 outputs for 2 writable flows" in tp.fail_reason


def _plus_one_dev(x):
    return x + 1.0


def _times_three_in_place(x):
    x *= 3.0


def test_template_reads_the_cuda_modules_version_and_writes_back():
    """The reference's ``test_template_device_writeback_after_tpu``: a tile
    the CUDA module wrote (its newest copy on the device), then read and
    written by a template body in place: the template sees 2.0, the host
    copy carries 6.0 at the newest version, and the device's detach does
    not roll it back."""
    with parsec_tpu_torch.Context(nb_cores=2, cuda_device="cpu",
                                  devices=["cuda", "template"]) as ctx:
        d = data_create("x", payload=np.full(4, 1.0))
        tp = DTDTaskpool(ctx)
        tp.insert_task({DEV_CUDA: _plus_one_dev}, (d, INOUT))
        tp.insert_task({DEV_TEMPLATE: _times_three_in_place}, (d, INOUT))
        assert tp.wait(timeout=60)
        assert d.newest_copy().device_index == 0
        version = d.get_copy(0).version
    np.testing.assert_array_equal(stage_to_cpu(d), 6.0)
    assert d.get_copy(0).version == version


# ---------------------------------------------------------------------------
# virtual-process maps and core binding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    ("flat", 5), ("nb", 7, 3), ("nb", 4, 1), ("spec", "0,1;2,3"),
    ("spec", "0,2;1;3,4,5")], ids=str)
def test_vpmap_matches_reference(make):
    maps = []
    for m in (ref_binding, binding):
        if make[0] == "flat":
            vm = m.VPMap.flat(make[1])
        elif make[0] == "nb":
            vm = m.VPMap.from_nb_vps(make[1], make[2])
        else:
            vm = m.VPMap.from_spec(make[1])
        cores = list(range(8))
        maps.append((vm.vps, vm.nb_vps(), [vm.vp_of(w) for w in range(8)],
                     [vm.core_for(w, cores) for w in range(6)],
                     [vm.core_for(w, [3]) for w in range(3)]))
    assert maps[0] == maps[1]


def test_available_cores_and_binding_match_reference():
    assert binding.available_cores() == ref_binding.available_cores()
    cores = binding.available_cores()
    out = []

    def pin():
        out.append((binding.bind_current_thread(cores[-1]),
                    sorted(os.sched_getaffinity(0))))

    th = threading.Thread(target=pin)
    th.start()
    th.join()
    assert out == [(True, [cores[-1]])]
    assert sorted(os.sched_getaffinity(0)) == cores  # only that thread moved
    assert binding.bind_current_thread(10 ** 6) is False


@pytest.mark.parametrize("spec", ["flat", "nb:2", "nb:3", "0,1;2,3"])
def test_context_reads_runtime_vpmap(spec):
    """Both packages' contexts build the same map from the param, and each
    execution stream carries its worker's VP."""
    got = []
    for make, params in (
            (lambda: parsec_tpu.Context(nb_cores=4, devices=["cpu"]), ref_mca_param),
            (lambda: parsec_tpu_torch.Context(nb_cores=4, devices=["cpu"]), mca_param)):
        params.set_param("runtime", "vpmap", spec)
        try:
            with make() as ctx:
                got.append((ctx.vpmap.vps, [es.vp_id for es in ctx.streams]))
        finally:
            params.unset("runtime", "vpmap")
    assert got[0] == got[1]


@pytest.mark.parametrize("spec", ["nb:0", "nb:x", "0,a;1"])
def test_invalid_vpmap_is_fatal(spec):
    mca_param.set_param("runtime", "vpmap", spec)
    try:
        with pytest.raises(FatalError, match="invalid runtime_vpmap"):
            parsec_tpu_torch.Context(nb_cores=2, devices=["cpu"])
    finally:
        mca_param.unset("runtime", "vpmap")


def test_bind_threads_pins_each_worker():
    """``runtime_bind_threads``: each worker pins itself to its VP's core
    (``VPMap.core_for``), as the reference's workers do."""
    seen = {}
    cores = binding.available_cores()
    mca_param.set_param("runtime", "bind_threads", 1)
    mca_param.set_param("runtime", "vpmap", "nb:2")
    try:
        with parsec_tpu_torch.Context(nb_cores=3, devices=["cpu"]) as ctx:
            t = port_task
            tp = Taskpool("pins")
            barrier = threading.Barrier(3, timeout=10)

            def hook(es, x):
                if es.worker_id:
                    seen[es.worker_id] = sorted(os.sched_getaffinity(0))
                    barrier.wait()  # hold each worker until both pinned ones ran
                return HookReturn.DONE

            tc = t.TaskClass("where", chores=[t.Chore("cpu", hook)])
            tc.release_deps = lambda es, x: []
            tp.add_task_class(tc)
            tp.startup_hook = lambda c, _tp: [t.Task(_tp, tc, (i,)) for i in range(2)]
            ctx.add_taskpool(tp)
            ctx.start()
            barrier.wait()
            assert tp.wait(timeout=30)
            want = {w: [ctx.vpmap.core_for(w, cores)] for w in (1, 2)}
    finally:
        mca_param.unset("runtime", "bind_threads")
        mca_param.unset("runtime", "vpmap")
    assert seen == want
