"""DTD — Dynamic Task Discovery front-end.

The port of :mod:`parsec_tpu.dsl.dtd`.  Reference:
``parsec/interfaces/dtd/`` — sequential-looking task insertion
(``parsec_dtd_insert_task``, ``insert_function.h:281``) with per-argument
access flags (``insert_function.h:53-72``); dependencies are inferred at
insert time from per-tile ``last_writer`` / reader tracking under a tile
lock (``insert_function.c:2812-2860``, tile struct
``insert_function_internal.h:199-209``); insertion is throttled by a window
so the DAG in flight stays bounded (window/threshold MCA knobs); task
classes are found-or-created from the body+signature
(``insert_function.c:193,942,2387``).

Multi-rank: every rank runs the same insert sequence (SPMD, reference
semantics); a task whose affinity tile is remote becomes a *shadow task*
that only advances the per-tile version (epoch) tracking.  Producer ranks
insert send tasks, consumer ranks insert recv tasks — matched pairs keyed
by (tile, epoch), carried over the comm engine's ``TAG_DTD`` channel.  A
tile version on the card crosses as a clone made on the card and lands in
the consumer's host slot as a CUDA tensor, which the consumer's CUDA
module stages device-to-device.

Device chores: ``insert_task({DEV_CPU: f, DEV_CUDA: g}, ...)`` gives a
task a numpy CPU incarnation and a torch CUDA one; the device selector
picks per task, and a CUDA chore runs through the CUDA device module
(:mod:`parsec_tpu_torch.device.cuda`) — staged tiles in, the body called
with positional tensors (values and ``SCRATCH`` buffers where the caller
put them), fresh tensors out for the writable arguments in order.  A
failed CUDA chore fails the pool; it never falls back to the CPU body.

Differences from the reference, by design:

* WAR hazards are broken by renaming (a fresh writer buffer, reference
  ``overlap_strategies.c``) at one rank, and serialized as dependencies
  across ranks, as the JAX package does.
* Bodies may mutate numpy payloads in place (reference semantics) **or**
  return replacement arrays (functional style, required for device
  chores): a non-None return rebinds the writable flows in order.

Usage::

    dtd = DTDTaskpool(ctx)
    dtd.insert_task(gemm_body,
                    (A.data_of(i, k), IN),
                    (B.data_of(k, j), IN),
                    (C.data_of(i, j), INOUT | AFFINITY),
                    alpha)                     # bare value => VALUE
    dtd.flush_all()
    dtd.wait()
"""

from __future__ import annotations

import threading
import time
import types
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.lifecycle import AccessMode, HookReturn, DEV_CPU
from ..core.task import Chore, Flow, Task, TaskClass
from ..core.taskpool import Taskpool
from ..comm.payload import is_device_array
from ..data.data import Data, host_array
from ..utils import mca_param
from .ptg import stage_to_cpu

IN = AccessMode.IN
OUT = AccessMode.OUT
INOUT = AccessMode.INOUT
CTL = AccessMode.CTL
VALUE = AccessMode.VALUE
SCRATCH = AccessMode.SCRATCH
ATOMIC_WRITE = AccessMode.ATOMIC_WRITE
AFFINITY = AccessMode.AFFINITY
DONT_TRACK = AccessMode.DONT_TRACK


class _TileState:
    """Per-Data dependency tracking (reference dtd tile,
    ``insert_function_internal.h:199-209``).

    ``current`` is the buffer holding the tile's latest logical version —
    it diverges from the home ``data`` when a WAR hazard is broken by
    renaming (reference ``overlap_strategies.c``): pending readers keep the
    old buffer while the writer proceeds on a fresh one."""

    __slots__ = ("lock", "last_writer", "readers", "atomic", "data", "current",
                 "renames", "epoch", "writer_rank", "have_local", "sent")

    def __init__(self, data: Optional[Data] = None) -> None:
        self.lock = threading.Lock()
        self.last_writer: Optional[Task] = None
        self.readers: List[Task] = []
        #: pending commutative writers (ATOMIC_WRITE): unordered among
        #: themselves, ordered against readers and exclusive writers
        self.atomic: List[Task] = []
        self.data = data
        self.current: Optional[Data] = data
        self.renames = 0
        # -- multi-rank (shadow-task protocol) fields --------------------
        #: logical version counter, advanced by every exclusive write; all
        #: ranks compute the same sequence from the SPMD insert stream
        self.epoch = 0
        #: rank that produced (owns) the current epoch's content
        self.writer_rank = 0
        #: True when the current epoch's content is materialized locally
        #: (we produced it, we hold the home tile, or a recv deposited it)
        self.have_local = True
        #: (epoch, dst_rank) versions already shipped from this rank
        self.sent: set = set()


class _DTDTaskState:
    """Successor bookkeeping attached to each inserted task."""

    __slots__ = ("lock", "pending", "successors", "completed", "gen", "args")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        # starts at 1: the "insertion in progress" dependency released at
        # the end of insert_task (avoids racing preds completing mid-insert)
        self.pending = 1
        self.successors: List[Task] = []
        self.completed = False
        #: untied-task support: a body returning a generator runs in slices,
        #: the worker is released between them (reference dtd_test_untie.c)
        self.gen = None
        self.args: Optional[List[Any]] = None


def copy_home(src: Data, dst: Data) -> None:
    """Copy ``src``'s newest version into ``dst``'s CPU copy and bump its
    version (shared by WAR-rename copies and flush-home).  The newest
    version is found by ``Data`` versions: a device copy newer than the
    host's is brought back first (:func:`stage_to_cpu` waits on its ready
    event), so a rename never copies a stale host copy."""
    arr = stage_to_cpu(src)
    arr = arr.clone() if isinstance(arr, torch.Tensor) else np.array(arr)
    c = dst.get_copy(0)
    if c is None:
        dst.attach_copy(0, arr)
    else:
        c.payload = arr
    dst.version_bump(0)


def _blank_like(payload):
    """A zeroed host buffer shaped and typed like ``payload`` (an ndarray,
    or a torch tensor on any device; bfloat16 stays a torch CPU tensor, as
    :func:`..data.data.host_array` keeps it)."""
    if isinstance(payload, torch.Tensor):
        z = torch.zeros(tuple(payload.shape), dtype=payload.dtype)
        return z if z.dtype == torch.bfloat16 else z.numpy()
    return np.zeros_like(np.asarray(payload))


class DTDTaskpool(Taskpool):
    """Reference ``parsec_dtd_taskpool_new`` (insert_function.h:332)."""

    def __init__(self, context=None, name: str = "dtd", *, auto_add: bool = True):
        super().__init__(name=name)
        self.taskpool_type = Taskpool.TYPE_DTD
        self._classes: Dict[Any, TaskClass] = {}
        self._tiles: Dict[int, _TileState] = {}
        self._tiles_lock = threading.Lock()
        self._inserted = 0
        self._retired = 0
        self._quiesce = threading.Condition()
        self._open = True
        self.window = mca_param.register(
            "dtd", "window_size", 2048,
            help="max in-flight inserted tasks before the inserter helps execute")
        self.threshold = mca_param.register(
            "dtd", "threshold_size", 1024,
            help="in-flight level the inserter drains down to when the window fills")
        self._war_rename = mca_param.register(
            "dtd", "war_rename", True,
            help="break WAR hazards by renaming (fresh writer buffer) instead of serializing")
        self._rename_tc: Optional[TaskClass] = None
        # -- multi-rank state (shadow-task protocol) ---------------------
        #: (wire_key, epoch) -> {"payload": arr|None, "task": recv Task|None}
        self._recv: Dict[Tuple[Any, int], Dict[str, Any]] = {}
        self._recv_lock = threading.Lock()
        self._send_tc: Optional[TaskClass] = None
        self._recv_tc: Optional[TaskClass] = None
        self._comm_seq = 0
        if context is not None and auto_add:
            context.add_taskpool(self)

    def attached(self, context) -> None:
        super().attached(context)
        # hold the "insertion open" runtime action so local termdet cannot
        # fire while the user may still insert (released by close()).
        self.tdm.taskpool_addto_runtime_actions(self, 1)

    # -----------------------------------------------------------------
    # task classes
    # -----------------------------------------------------------------
    def _class_of(
        self,
        bodies: Dict[str, Callable],
        modes: Tuple[AccessMode, ...],
        name: Optional[str],
    ) -> TaskClass:
        # keyed on the bodies' identity, as the reference: a body made
        # anew per insert makes a class per task
        key = (tuple((d, id(f)) for d, f in sorted(bodies.items())), modes, name)
        tc = self._classes.get(key)
        if tc is not None:
            return tc
        flows = [
            Flow(f"arg{i}", m & ~(AFFINITY | DONT_TRACK), i)
            for i, m in enumerate(modes)
        ]
        cname = name or next(
            (getattr(b, "__name__", "dtd_task") for b in bodies.values()), "dtd_task")
        tc = TaskClass(cname, flows=flows)
        for dev_type, fn in bodies.items():
            chore = Chore(dev_type, self._make_hook(dev_type, fn))
            if dev_type != DEV_CPU:
                chore.body_fn = fn
            tc.add_chore(chore)
        tc.release_deps = self._release_deps
        self._classes[key] = tc
        self.add_task_class(tc)
        return tc

    def _make_hook(self, dev_type: str, fn: Callable):
        if dev_type == DEV_CPU:
            def cpu_hook(es, task, _fn=fn):
                state: _DTDTaskState = task.user
                if state.gen is not None:
                    # untied resume: run the next slice on whichever worker
                    # picked the task up (reference untied-task semantics)
                    try:
                        next(state.gen)
                        return HookReturn.AGAIN
                    except StopIteration as si:
                        state.gen = None
                        self._commit_outputs(task, state.args, si.value)
                        return HookReturn.DONE
                args = self._resolve_cpu_args(task)
                result = _fn(*args)
                if isinstance(result, types.GeneratorType):
                    state.gen, state.args = result, args
                    try:
                        next(state.gen)
                        return HookReturn.AGAIN
                    except StopIteration as si:
                        state.gen = None
                        self._commit_outputs(task, args, si.value)
                        return HookReturn.DONE
                self._commit_outputs(task, args, result)
                return HookReturn.DONE

            return cpu_hook

        def accel_hook(es, task):
            # accelerator chores are driven by the device module's
            # kernel_scheduler; it stages data and invokes the chore's
            # body_fn on the device
            return task.selected_device.kernel_scheduler(es, task)

        return accel_hook

    # -----------------------------------------------------------------
    # body argument plumbing (CPU path)
    # -----------------------------------------------------------------
    def _resolve_cpu_args(self, task: Task) -> List[Any]:
        args = []
        for spec in task.body_args:
            kind, payload, mode = spec
            if kind == "data":
                arr = stage_to_cpu(payload)
                eff = AccessMode.INOUT if (mode & AccessMode.ATOMIC_WRITE) else (mode & AccessMode.INOUT)
                payload.transfer_ownership(0, eff)
                args.append(arr)
            elif kind == "scratch":
                shape, dtype = payload
                args.append(np.empty(shape, dtype))
            elif kind == "value":
                args.append(payload)
            # kind "ctl": dependency only, no body argument
        return args

    def _commit_outputs(self, task: Task, args: List[Any], result: Any) -> None:
        """In-place mutation needs only version bumps; a returned tuple
        rebinds writable flows in order."""
        writable = [
            (i, spec) for i, spec in enumerate(task.body_args)
            if spec[0] == "data" and (spec[2] & (AccessMode.OUT | AccessMode.ATOMIC_WRITE))
        ]
        if result is not None:
            outs = result if isinstance(result, (tuple, list)) else (result,)
            if len(outs) != len(writable):
                raise ValueError(
                    f"{task!r}: body returned {len(outs)} outputs for "
                    f"{len(writable)} writable flows")
            for (i, spec), new in zip(writable, outs):
                if spec[2] & AccessMode.ATOMIC_WRITE:
                    # concurrent atomic writers each computed from their own
                    # snapshot; rebinding would lose peer updates — atomic
                    # bodies must mutate in place
                    raise ValueError(
                        f"{task!r}: ATOMIC_WRITE flows require in-place "
                        "mutation, not a returned replacement array")
                copy = spec[1].get_copy(0)
                copy.payload = np.asarray(new)
        for i, spec in writable:
            spec[1].version_bump(0)

    # -----------------------------------------------------------------
    # insertion & dependency inference
    # -----------------------------------------------------------------
    @staticmethod
    def _rank_of_data(data: Data) -> Optional[int]:
        dc = data.collection
        if dc is None or dc.nodes <= 1:
            return None
        key = data.key if isinstance(data.key, tuple) else (data.key,)
        return dc.rank_of(*key)

    @staticmethod
    def _wire_key(data: Data) -> Any:
        """Rank-stable tile identity: (collection name, canonical key)."""
        dc = data.collection
        return (dc.name, data.key) if dc is not None else None

    def _tile_state(self, data: Data) -> _TileState:
        with self._tiles_lock:
            st = self._tiles.get(data.data_id)
            if st is None:
                st = self._tiles[data.data_id] = _TileState(data)
                if self.context is not None and self.context.nranks > 1:
                    owner = self._rank_of_data(data)
                    owner = self.context.rank if owner is None else owner
                    st.writer_rank = owner
                    st.have_local = owner == self.context.rank
            return st


    def insert_task(
        self,
        body: Union[Callable, Dict[str, Callable]],
        *args: Any,
        priority: int = 0,
        name: Optional[str] = None,
    ) -> Optional[Task]:
        """Reference ``parsec_dtd_insert_task`` (insert_function.h:281).

        ``body`` is a CPU body, or a dict of bodies by device type
        (``{DEV_CPU: f, DEV_CUDA: g}``).  ``args`` entries:

          * ``(Data, AccessMode)``        — tracked dataflow argument
          * ``((shape, dtype), SCRATCH)`` — per-task scratch buffer
            (numpy on the CPU, zeroed on the device)
          * ``(value, VALUE)`` or bare value — captured by value

        Returns the inserted :class:`Task`, or ``None`` when the task's
        affinity places it on another rank (shadow insertion — the
        reference's remote tasks are likewise not handed back).
        """
        if not self._open:
            raise RuntimeError("taskpool closed for insertion")
        if self.failed:
            raise RuntimeError(
                "taskpool was aborted; tasks inserted now would be "
                "silently discarded")
        if self.context is None:
            raise RuntimeError("DTD taskpool must be attached to a context before insertion")
        bodies = body if isinstance(body, dict) else {DEV_CPU: body}
        nranks = self.context.nranks
        myrank = self.context.rank

        specs: List[Tuple[str, Any, AccessMode]] = []
        modes: List[AccessMode] = []
        affinity_data: Optional[Data] = None
        for a in args:
            if isinstance(a, tuple) and len(a) == 2 and isinstance(a[1], AccessMode):
                val, mode = a
            else:
                val, mode = a, VALUE
            if mode & AccessMode.SCRATCH:
                specs.append(("scratch", val, mode))
            elif mode & AccessMode.CTL and isinstance(val, Data):
                # control-only dependency on a tile: tracked like a reader,
                # but contributes no body argument
                specs.append(("ctl", val, mode))
            elif mode & AccessMode.VALUE or not isinstance(val, Data):
                specs.append(("value", val, VALUE))
                mode = VALUE
            else:
                specs.append(("data", val, mode))
                if mode & AFFINITY and affinity_data is None:
                    affinity_data = val
            modes.append(mode)

        # rank placement (owner computes, reference PARSEC_AFFINITY flag):
        # the task executes on the rank owning the AFFINITY-tagged tile
        # (fallback: the first collection-backed tracked tile). Every rank
        # runs the same insert sequence; remote tasks are *shadow* tasks —
        # tracked for dependency/version inference, never executed locally.
        exec_rank = myrank
        if nranks > 1:
            pdata = affinity_data
            if pdata is None:
                pdata = next(
                    (d for (k, d, m) in specs
                     if k in ("data", "ctl") and not (m & DONT_TRACK)
                     and d.collection is not None and d.collection.nodes > 1),
                    None)
            if pdata is not None:
                r = self._rank_of_data(pdata)
                if r is not None:
                    exec_rank = r

        if nranks > 1 and exec_rank != myrank:
            self._track_shadow(specs, exec_rank)
            return None

        tc = self._class_of(bodies, tuple(modes), name)
        task = Task(self, tc, (self._inserted,), priority)
        task.body_args = specs
        state = _DTDTaskState()
        task.user = state
        task.on_complete = self._task_retired

        # dependency inference per tracked data argument (CTL args track
        # like readers: they order after the last writer). Multi-rank runs
        # serialize WAR hazards (renaming is a single-rank optimization:
        # cross-rank consistency is keyed by tile epoch, which must map
        # 1:1 onto the home buffer).
        rename_on = bool(self._war_rename) and nranks == 1
        for i, (kind, data, mode) in enumerate(specs):
            if kind not in ("data", "ctl") or (mode & DONT_TRACK):
                continue
            st = self._tile_state(data)
            copy_src = copy_dst = None
            copy_preds: List[Task] = []
            with st.lock:
                st.readers = [r for r in st.readers if not r.user.completed]
                st.atomic = [w for w in st.atomic if not w.user.completed]
                if nranks > 1:
                    # content of the current epoch must be materialized
                    # locally before any consuming local task can run
                    needs_in = bool(mode & (AccessMode.IN | AccessMode.ATOMIC_WRITE)) \
                        or not (mode & AccessMode.OUT)
                    if needs_in and not st.have_local:
                        self._ensure_recv_locked(st, st.epoch)
                buf = st.current if st.current is not None else data
                last = [st.last_writer] if st.last_writer is not None else []
                if (mode & AccessMode.ATOMIC_WRITE) and nranks == 1:
                    # commutative writer: after readers + exclusive writer,
                    # unordered among atomic peers
                    for p in st.readers + last:
                        if p is not task:
                            self._add_edge(p, task, state)
                    st.atomic.append(task)
                elif mode & (AccessMode.OUT | AccessMode.ATOMIC_WRITE):
                    # exclusive writer (OUT/INOUT; multi-rank also routes
                    # ATOMIC_WRITE here — commutativity is a local
                    # optimization, cross-rank epochs need a total order)
                    pending = [r for r in st.readers + st.atomic if r is not task]
                    if rename_on and kind == "data" and pending:
                        # WAR hazard: rename (overlap_strategies.c) — the
                        # writer proceeds on a fresh buffer while pending
                        # readers/atomics keep the old one
                        st.renames += 1
                        newd = Data((data.key, "war", st.renames),
                                    shape=buf.shape, dtype=buf.dtype)
                        if mode & AccessMode.IN:
                            # INOUT: the new buffer needs the old contents —
                            # a copy task ordered after the old buffer's
                            # producers (but NOT after its readers)
                            copy_src, copy_dst = buf, newd
                            copy_preds = [p for p in last + st.atomic if p is not task]
                        else:
                            self._attach_blank(newd, buf)
                        st.current = newd
                        st.last_writer = task
                        st.readers = []
                        st.atomic = []
                        buf = newd
                    else:
                        for p in pending + last:
                            if p is not task:
                                self._add_edge(p, task, state)
                        st.last_writer = task
                        st.readers = []
                        st.atomic = []
                    if nranks > 1:
                        st.epoch += 1
                        st.writer_rank = myrank
                        st.have_local = True
                else:  # reader: after exclusive writer + atomic writers
                    for p in st.atomic + last:
                        if p is not task:
                            self._add_edge(p, task, state)
                    st.readers.append(task)
            if kind == "data":
                specs[i] = (kind, buf, mode)  # bind the version's buffer
            if copy_src is not None:
                cpy = self._insert_rename_copy(copy_src, copy_dst, copy_preds)
                self._add_edge(cpy, task, state)

        with self._quiesce:
            self._inserted += 1
        # release the insertion-in-progress dependency
        ready = False
        with state.lock:
            state.pending -= 1
            ready = state.pending == 0
        if ready:
            es = self.context.current_es()
            self.context.schedule([task], es=es)
        self._throttle_window()
        return task

    @staticmethod
    def _attach_blank(newd: Data, like: Data) -> None:
        """Allocate a pure-OUT rename target shaped like the old buffer."""
        c = like.newest_copy()
        if c is not None:
            arr = _blank_like(c.payload)
        else:
            arr = np.zeros(like.shape or (1,), like.dtype or np.float64)
        newd.attach_copy(0, arr)

    def _rename_class(self) -> TaskClass:
        if self._rename_tc is None:
            def copy_hook(es, t):
                src, dst = t.body_args
                copy_home(src, dst)
                return HookReturn.DONE

            tc = TaskClass("war_rename_copy", chores=[Chore(DEV_CPU, copy_hook)])
            tc.release_deps = self._release_deps
            self._rename_tc = tc
            self.add_task_class(tc)
        return self._rename_tc

    def _insert_rename_copy(self, src: Data, dst: Data, preds: List[Task]) -> Task:
        """Internal insertion of the INOUT-rename copy task: reads the old
        buffer's final version into the writer's fresh buffer; ordered after
        the old buffer's producers only (readers run concurrently)."""
        t = Task(self, self._rename_class(), (self._inserted,), priority=0)
        t.body_args = (src, dst)
        st = _DTDTaskState()
        t.user = st
        t.on_complete = self._task_retired
        for p in preds:
            self._add_edge(p, t, st)
        with self._quiesce:
            self._inserted += 1
        ready = False
        with st.lock:
            st.pending -= 1
            ready = st.pending == 0
        if ready:
            self.context.schedule([t], es=self.context.current_es())
        return t

    # -----------------------------------------------------------------
    # multi-rank shadow-task protocol
    #
    # Reference: dtd remote tasks (insert_function.c — tasks whose
    # affinity rank is remote still walk the tile lists so every rank
    # infers matching communication from the same SPMD insert stream).
    # Cross-rank consistency is keyed by (tile, epoch): the producing
    # rank inserts a *send task* per consuming rank (ordered after the
    # local producer like a reader), the consuming rank inserts a *recv
    # task* (ordered after local buffer users like a writer — the
    # deposit overwrites the local buffer). Local tile lists only ever
    # hold local tasks; no cross-rank WAR edges are needed because each
    # rank mutates its own copy of the tile.
    # -----------------------------------------------------------------
    def _track_shadow(self, specs, exec_rank: int) -> None:
        """Bookkeeping for a task that executes on another rank."""
        myrank = self.context.rank
        for kind, data, mode in specs:
            if kind not in ("data", "ctl") or (mode & DONT_TRACK):
                continue
            st = self._tile_state(data)
            is_excl = bool(mode & (AccessMode.OUT | AccessMode.ATOMIC_WRITE))
            needs_in = bool(mode & (AccessMode.IN | AccessMode.ATOMIC_WRITE)) or not is_excl
            with st.lock:
                if needs_in and st.writer_rank == myrank:
                    self._insert_send_locked(st, st.epoch, exec_rank)
                if is_excl:
                    st.epoch += 1
                    st.writer_rank = exec_rank
                    st.have_local = False
                    # local reader/writer lists are kept: they encode WAR
                    # on the *local* buffer, consumed by the next local
                    # producer (_ensure_recv_locked or a local writer)

    def _comm_task(self, tc: TaskClass, body_args, preds: List[Task],
                   extra_pending: int = 0) -> Task:
        """Insert an internal communication task (send/recv); counted and
        retired like any inserted task so wait()/termdet see it."""
        self._comm_seq += 1
        t = Task(self, tc, (tc.name, self._comm_seq), priority=1 << 20)
        t.body_args = body_args
        state = _DTDTaskState()
        state.pending += extra_pending
        t.user = state
        t.on_complete = self._task_retired
        for p in preds:
            self._add_edge(p, t, state)
        with self._quiesce:
            self._inserted += 1
        ready = False
        with state.lock:
            state.pending -= 1  # release the insertion-in-progress dep
            ready = state.pending == 0
        if ready:
            self.context.schedule([t], es=self.context.current_es())
        return t

    def _send_class(self) -> TaskClass:
        if self._send_tc is None:
            def send_hook(es, t):
                data, wkey, epoch, dst = t.body_args
                # snapshot: the send retires (releasing its WAR edge) before
                # the wire serializes / the remote GET arrives — the next
                # local writer must not be able to mutate the shipped bytes.
                # A version on the card stays there: a device-capable fabric
                # clones it on the card inside send_dtd, queued behind its
                # producer (never a host bounce); anything else is copied
                # to a private host array
                comm = self.context.comm
                newest = data.newest_copy()
                if newest is None:
                    raise RuntimeError(f"{data!r} has no valid copy to send")
                arr = newest.payload
                if not (is_device_array(arr)
                        and getattr(comm, "device_payloads", False)):
                    arr = host_array(arr)
                comm.remote_dep.send_dtd(self, wkey, epoch, arr, dst)
                return HookReturn.DONE

            tc = TaskClass("dtd_send", chores=[Chore(DEV_CPU, send_hook)])
            tc.release_deps = self._release_deps
            self._send_tc = tc
            self.add_task_class(tc)
        return self._send_tc

    def _recv_class(self) -> TaskClass:
        if self._recv_tc is None:
            def recv_hook(es, t):
                data, wkey, epoch = t.body_args
                with self._recv_lock:
                    entry = self._recv.pop((wkey, epoch))
                buf = entry["payload"]
                # a CUDA arrival (the fabric's clone, this rank's alone)
                # lands as-is for the CUDA module's device-to-device
                # stage-in; a host one is copied out of its landing buffer
                if not is_device_array(buf):
                    buf = host_array(buf)
                c = data.get_copy(0)
                if c is None:
                    data.attach_copy(0, buf)
                else:
                    c.payload = buf
                data.version_bump(0)
                return HookReturn.DONE

            tc = TaskClass("dtd_recv", chores=[Chore(DEV_CPU, recv_hook)])
            tc.release_deps = self._release_deps
            self._recv_tc = tc
            self.add_task_class(tc)
        return self._recv_tc

    def _insert_send_locked(self, st: _TileState, epoch: int, dst: int) -> None:
        """Ship (tile, epoch) to rank dst once; ordered after the local
        producer like a reader (tile lock held)."""
        if (epoch, dst) in st.sent:
            return
        st.sent.add((epoch, dst))
        wkey = self._wire_key(st.data)
        if wkey is None:
            raise RuntimeError(
                f"{st.data!r}: cross-rank DTD flow needs a collection-backed tile")
        preds = list(st.atomic)
        if st.last_writer is not None:
            preds.append(st.last_writer)
        t = self._comm_task(self._send_class(), (st.data, wkey, epoch, dst), preds)
        st.readers.append(t)

    def _ensure_recv_locked(self, st: _TileState, epoch: int) -> Task:
        """Create the recv task that deposits (tile, epoch) into the local
        buffer; it becomes the tile's local producer (tile lock held)."""
        wkey = self._wire_key(st.data)
        if wkey is None:
            raise RuntimeError(
                f"{st.data!r}: cross-rank DTD flow needs a collection-backed tile")
        with self._recv_lock:
            entry = self._recv.get((wkey, epoch))
            if entry is None:
                entry = self._recv[(wkey, epoch)] = {"payload": None, "task": None}
            arrived = entry["payload"] is not None
            # WAR: the deposit overwrites the local buffer — order after
            # every local task still using it
            preds = st.readers + st.atomic
            if st.last_writer is not None:
                preds.append(st.last_writer)
            t = self._comm_task(self._recv_class(), (st.data, wkey, epoch),
                                preds, extra_pending=0 if arrived else 1)
            entry["task"] = t
        st.last_writer = t
        st.readers = []
        st.atomic = []
        st.have_local = True
        return t

    def dtd_incoming(self, wkey, epoch: int, payload) -> None:
        """AM deliver (runs on the comm/progress thread): park or release."""
        task = None
        with self._recv_lock:
            entry = self._recv.get((wkey, epoch))
            if entry is None:
                self._recv[(wkey, epoch)] = {"payload": payload, "task": None}
            else:
                entry["payload"] = payload
                task = entry["task"]
        if task is not None:
            state: _DTDTaskState = task.user
            with state.lock:
                state.pending -= 1
                ready = state.pending == 0
            if ready:
                self.context.schedule([task])
        with self._quiesce:
            self._quiesce.notify_all()


    @staticmethod
    def _add_edge(pred: Task, succ: Task, succ_state: "_DTDTaskState") -> None:
        # bump pending BEFORE publishing the edge: a predecessor completing
        # between publish and bump would double-schedule the successor. The
        # insertion-in-progress dependency keeps pending >= 1 throughout, so
        # the rollback below can never release the task early.
        with succ_state.lock:
            succ_state.pending += 1
        pstate: _DTDTaskState = pred.user
        added = False
        with pstate.lock:
            if not pstate.completed and succ not in pstate.successors:
                pstate.successors.append(succ)
                added = True
        if not added:  # pred already done, or duplicate edge
            with succ_state.lock:
                succ_state.pending -= 1

    def _release_deps(self, es, task: Task) -> List[Task]:
        state: _DTDTaskState = task.user
        with state.lock:
            state.completed = True
            succs = list(state.successors)
            state.successors = []
        ready = []
        for s in succs:
            sstate: _DTDTaskState = s.user
            with sstate.lock:
                sstate.pending -= 1
                if sstate.pending == 0:
                    ready.append(s)
        return ready

    def _task_retired(self, task: Task) -> None:
        with self._quiesce:
            self._retired += 1
            self._quiesce.notify_all()

    def _throttle_window(self) -> None:
        """Bound in-flight tasks (reference window throttling): the inserter
        thread helps execute until the backlog drains to the threshold."""
        in_flight = self._inserted - self._retired
        if in_flight < self.window:
            return
        self.context.start()
        while True:
            if self.failed:
                return  # aborted: the backlog will never drain
            with self._quiesce:
                if self._inserted - self._retired <= self.threshold:
                    return
            if not self.context.help_execute_one():
                # the backlog may be recv tasks blocked on remote arrivals:
                # drain the comm engine or a full window deadlocks the rank
                self.context._progress_comm()
                with self._quiesce:
                    self._quiesce.wait(0.001)

    # -----------------------------------------------------------------
    # quiescence / flush
    # -----------------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        """Wait until every task inserted so far retired; the pool remains
        open for more insertion (reference ``parsec_taskpool_wait``)."""
        if self.context is not None:
            self.context.start()
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        while True:
            if self.failed:
                return False  # Context.abort(): discarded tasks never retire
            with self._quiesce:
                if self._retired >= self._inserted:
                    return True
                if deadline is not None and time.monotonic() > deadline:
                    return False
            if self.context is not None and self.context.help_execute_one():
                continue
            if self.context is not None:
                # drive the comm engine: pending recv tasks need arrivals
                self.context._progress_comm()
            with self._quiesce:
                if self._retired >= self._inserted:
                    return True
                self._quiesce.wait(0.001)

    def data_flush(self, data: Data) -> None:
        """Push the final version of ``data`` home to its owner rank
        (reference ``parsec_dtd_data_flush``, insert_function.h:351-360).

        Single-rank: materialize the newest version on the CPU device —
        copying it back from a rename buffer if WAR renaming redirected the
        tile, or from the device that wrote it last — and drop tracking
        state. Multi-rank: asynchronous like the
        reference — inserts the home-bound send on the producing rank and
        the matching recv on the owner; completed by ``wait()``. All ranks
        must flush the same tiles (SPMD, as they inserted)."""
        if self.context is not None and self.context.nranks > 1:
            with self._tiles_lock:
                st = self._tiles.get(data.data_id)
            if st is None:
                return
            myrank = self.context.rank
            owner = self._rank_of_data(data)
            owner = myrank if owner is None else owner
            with st.lock:
                if st.writer_rank == myrank and owner != myrank:
                    self._insert_send_locked(st, st.epoch, owner)
                elif owner == myrank and not st.have_local:
                    self._ensure_recv_locked(st, st.epoch)
            return
        with self._tiles_lock:
            st = self._tiles.get(data.data_id)
        cur = st.current if st is not None and st.current is not None else data
        if cur is not data:
            copy_home(cur, data)
        else:
            stage_to_cpu(data)
        with self._tiles_lock:
            self._tiles.pop(data.data_id, None)

    def flush_all(self, collection=None) -> None:
        """Reference ``parsec_dtd_data_flush_all``: flush every tracked tile
        home (of one collection, or all)."""
        multirank = self.context is not None and self.context.nranks > 1
        if not multirank:
            self.wait()
        with self._tiles_lock:
            states = list(self._tiles.values())
        flushed = []
        for st in states:
            if st.data is None:
                continue
            if collection is not None and st.data.collection is not collection:
                continue
            self.data_flush(st.data)
            flushed.append(st)
        if multirank:
            self.wait()
            myrank = self.context.rank
            for st in flushed:
                owner = self._rank_of_data(st.data)
                if owner is None or owner == myrank:
                    stage_to_cpu(st.data)  # materialize home tiles on CPU
                with self._tiles_lock:
                    self._tiles.pop(st.data.data_id, None)

    def close(self) -> None:
        """End insertion; after this, ``context.wait()`` can terminate the
        pool."""
        if self._open:
            self._open = False
            self.tdm.taskpool_addto_runtime_actions(self, -1)
