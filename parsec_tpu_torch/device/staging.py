"""Asynchronous host<->device staging pipeline.

The port of :mod:`parsec_tpu.device.staging`.  Two threads keep transfers
off the dispatch thread:

* :class:`StageLane` — a transfer thread the native pump hands a ready
  batch to the moment it is popped behind an older one.  The lane
  prestages the batch's input tiles through :meth:`CudaDevice.prestage_batch
  <parsec_tpu_torch.device.cuda.CudaDevice.prestage_batch>` (pinned host
  buffers, the device's H2D copy stream), a chunk at a time, so that when
  the pump reaches the batch its plain inputs are residency hits whose
  copies the compute stream waits on by event.  The pump never waits for
  more than the chunk in flight: :meth:`_StageJob.wait` stops the lane
  there, and the batch's submit stages what is left.  Bounded by
  ``runtime_stage_depth`` (1 = synchronous, the default; 2 =
  double-buffered).

* :class:`WritebackCommitter` — a background thread draining
  version-guarded deferred write-backs.  Completed outputs enqueue at
  epilog (deduplicated per tile, so a re-dirtied tile commits its NEWEST
  version once); the committer drains in batched D2H copies on the
  device's D2H stream when an eviction needs a victim committed
  (:meth:`~WritebackCommitter.wait_for`, :meth:`~WritebackCommitter.kick`),
  at the :meth:`~WritebackCommitter.flush` barrier ``detach()`` takes,
  and, when a watermark is set (``runtime_wb_window_mb`` > 0), whenever
  that many dirty bytes are pending.  The watermark is off by default
  (the reference's is 32 MB): a tile drained mid-run is often rewritten
  later, so the drain moves versions nobody reads, and the committer's
  Python takes the interpreter lock from the dispatch thread.  The
  version guard makes a stale commit safe to drop, so the committer never
  takes the device residency lock: commits are Data-level operations and
  cannot deadlock against eviction waits.

A committer failure is STICKY: the stored exception re-raises on the next
``enqueue`` (failing the task pool through the device layer's fail-loudly
discipline) and on ``flush`` (failing ``detach()``), so a dead committer
surfaces as a pool failure, never a silent hang.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..profiling import pins
from ..utils import debug, mca_param

#: process-wide span ids for STAGE_IN/WRITEBACK begin/end pairing
_SPAN_SEQ = itertools.count(1)


def stage_depth_param() -> int:
    """The pipeline depth knob, shared by the device layer and the native
    pump: number of ready batches in flight in the prefetch window.  1,
    the default, disables the pipeline entirely (synchronous transfers, no
    committer); 2 double-buffers.  The reference defaults to 2; here the
    lane and the committer are Python threads that contend with the
    dispatch thread for the interpreter lock, and no path has measured
    faster at 2 than at 1 (PERF.md), so 1 stays the default until one
    does."""
    return max(1, int(mca_param.register(
        "runtime", "stage_depth", 1,
        help="host<->device staging pipeline depth: ready batches in "
             "flight in the prefetch window; also gates the async "
             "write-back committer (1 = synchronous transfers, the "
             "default; 2 = double-buffered)")))


def wb_window_bytes() -> int:
    """The deferred write-back watermark in bytes (``runtime_wb_window_mb``;
    0, the default, sets none)."""
    return max(0, int(mca_param.register(
        "runtime", "wb_window_mb", 0,
        help="deferred write-back watermark (MB): the committer drains "
             "batched D2H copies once this many dirty bytes are pending; "
             "0 = no watermark (drain on eviction, flush and close only)"))) << 20


class _StageJob:
    """One prestage request: a ready batch whose input tiles the lane
    stages while earlier waves compute."""

    __slots__ = ("batch", "done", "stop", "error")

    def __init__(self, batch: List[Any]):
        self.batch = batch
        self.done = threading.Event()
        #: set when the pump reaches the batch: the lane stops after the
        #: chunk in flight and the submit stages the rest
        self.stop = threading.Event()
        self.error: Optional[BaseException] = None

    def wait(self) -> None:
        """Stop the lane's work on this batch after its current chunk and
        block until it has.  Prestage errors are advisory — the submit
        path restages (and fails loudly) itself — so they are logged, not
        raised."""
        self.stop.set()
        self.done.wait()
        if self.error is not None:
            debug.warning("prestage of %d tasks failed (%s); submit path "
                          "will restage", len(self.batch), self.error)


class StageLane:
    """Dedicated transfer lane: prestages ready batches' input tiles on its
    own thread so H2D copies overlap the compute of earlier waves."""

    def __init__(self, dev):
        self._dev = dev
        self._cv = threading.Condition()
        self._jobs: Deque[_StageJob] = collections.deque()
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name=f"stage-lane:{dev.name}", daemon=True)
        self._thread.start()

    def stage(self, batch: List[Any]) -> _StageJob:
        job = _StageJob(batch)
        with self._cv:
            if self._stop:
                job.done.set()  # closed lane: the submit path stages
                return job
            self._jobs.append(job)
            self._cv.notify()
        return job

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._jobs and not self._stop:
                    self._cv.wait()
                if not self._jobs and self._stop:
                    return
                job = self._jobs.popleft()
            try:
                self._dev.prestage_batch(job.batch, job.stop)
            except Exception as e:  # the lane must outlive a bad prestage
                job.error = e
            finally:
                job.done.set()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30)
        # unblock any caller still parked on an undrained job
        with self._cv:
            while self._jobs:
                self._jobs.popleft().done.set()


class WritebackCommitter:
    """Background committer for version-guarded deferred write-backs.

    ``enqueue`` is called by the device epilog (and eviction) with the Data
    whose device copy is dirty; entries deduplicate per tile and the
    committer snapshots the NEWEST device version at commit time, so a tile
    re-dirtied while pending commits once.  It drains in batched D2H copies
    on :meth:`wait_for` and :meth:`kick` (eviction wants a victim home
    NOW), at the :meth:`flush` barrier, and once ``runtime_wb_window_mb``
    of dirty bytes are pending when that watermark is set."""

    def __init__(self, dev):
        self._dev = dev
        self._cv = threading.Condition()
        #: data_id -> (Data, [hb tickets], nbytes at enqueue)
        self._pending: "collections.OrderedDict[int, Tuple[Any, List[int], int]]" = \
            collections.OrderedDict()
        self._inflight: Dict[int, Any] = {}
        self._pending_bytes = 0
        self._window = wb_window_bytes()
        self._batch = max(1, int(mca_param.register(
            "runtime", "wb_batch", 32,
            help="max tiles per committer drain batch (one device sync "
                 "+ coalesced D2H gets per batch)")))
        self._tickets = itertools.count(1)
        self._kick = False
        self._flushing = False
        self._stop = False
        self.error: Optional[BaseException] = None
        self.stats: Dict[str, float] = {
            "enqueued": 0, "committed": 0, "dropped_stale": 0,
            "batches": 0, "capacity_waits": 0, "drain_s": 0.0}
        self._thread = threading.Thread(
            target=self._run, name=f"wb-committer:{dev.name}", daemon=True)
        self._thread.start()

    # -- producer side ---------------------------------------------------
    def enqueue(self, data) -> int:
        """Queue a deferred write-back of ``data``'s dirty device copy.
        Deduplicated per tile; with a watermark set, bounded by a capacity
        wait at 4x it so a stalled committer applies backpressure instead
        of accumulating unbounded dirty state (without one, the device
        budget bounds the dirty bytes through eviction).  Raises the stored
        committer error if the committer died — the caller's fail-loudly
        discipline turns that into a pool failure."""
        ticket = next(self._tickets)
        if pins.active(pins.HB_WB_ENQUEUE):
            pins.fire(pins.HB_WB_ENQUEUE, None,
                      {"ticket": ticket, "data": data.data_id})
        c = data.get_copy(self._dev.data_index)
        nb = c.nbytes if c is not None else 0
        with self._cv:
            self._raise_if_dead()
            cap = 4 * self._window
            while (cap and self._pending_bytes + nb > cap and self._pending
                   and self.error is None and not self._stop):
                self.stats["capacity_waits"] += 1
                self._cv.wait(timeout=1.0)
            self._raise_if_dead()
            entry = self._pending.get(data.data_id)
            if entry is None:
                self._pending[data.data_id] = (data, [ticket], nb)
                self._pending_bytes += nb
            else:
                entry[1].append(ticket)
            self.stats["enqueued"] += 1
            if self._should_drain():
                # wake the committer only when it has a drain to do: a
                # wake per epilog would hand the interpreter lock to it
                # and back once per task output
                self._cv.notify_all()
        return ticket

    def _raise_if_dead(self) -> None:
        if self.error is not None:
            raise RuntimeError(
                f"async write-back committer failed: {self.error!r}") \
                from self.error

    def kick(self) -> None:
        """Ask the committer to drain below-watermark pending entries
        (eviction pressure: a victim must be home before its device copy
        drops)."""
        with self._cv:
            self._kick = True
            self._cv.notify_all()

    def wait_for(self, data_id: int, timeout: float = 60.0) -> bool:
        """Block until ``data_id`` is neither pending nor in flight; its
        entry moves to the head of the queue, so the next drain takes it.
        Returns False on committer death or timeout — the caller falls back
        to a synchronous write-back (the version guard makes the duplicate
        safe)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            if data_id in self._pending:
                self._pending.move_to_end(data_id, last=False)
            self._kick = True
            self._cv.notify_all()
            while data_id in self._pending or data_id in self._inflight:
                if self.error is not None:
                    return False
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(left, 1.0))
            return self.error is None

    def flush(self, timeout: float = 300.0) -> None:
        """Barrier: every deferred write-back enqueued so far is committed
        (or provably stale) on return.  ``detach()`` and the executors'
        ``close()`` call this before host tiles are read.  The caller
        commits what is pending itself, in one batch of copies (the
        committer's thread takes at most ``runtime_wb_batch`` a drain),
        then waits out a drain in flight.  Re-raises a committer failure
        loudly."""
        with self._cv:
            self._raise_if_dead()
            grab = list(self._pending.items())
            self._pending.clear()
            self._pending_bytes = 0
            self._inflight.update((did, entry) for did, entry in grab)
        if grab:
            self._drain([entry for _did, entry in grab], [did for did, _e in grab])
        deadline = time.monotonic() + timeout
        with self._cv:
            self._flushing = True
            self._cv.notify_all()
            try:
                while self._pending or self._inflight:
                    if self.error is not None:
                        break
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise RuntimeError(
                            "async write-back committer flush timed out "
                            f"with {len(self._pending)} pending")
                    self._cv.wait(timeout=min(left, 1.0))
            finally:
                self._flushing = False
            self._raise_if_dead()

    # -- gauges ----------------------------------------------------------
    def pending(self) -> int:
        with self._cv:
            return len(self._pending) + len(self._inflight)

    def pending_bytes(self) -> int:
        with self._cv:
            return self._pending_bytes

    def drained(self) -> int:
        """Total entries the committer has disposed of (committed or
        dropped stale)."""
        return self.stats["committed"] + self.stats["dropped_stale"]

    @property
    def healthy(self) -> bool:
        return self.error is None and not self._stop

    # -- committer thread ------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while (not self._should_drain() and not self._stop
                       and self.error is None):
                    self._cv.wait(timeout=0.25)
                if self.error is not None or (self._stop and not self._pending):
                    return
                self._kick = False
                grab = list(itertools.islice(self._pending.items(), self._batch))
                for did, entry in grab:
                    del self._pending[did]
                    self._pending_bytes -= entry[2]
                    self._inflight[did] = entry
            if grab and not self._drain([entry for _did, entry in grab],
                                        [did for did, _entry in grab]):
                return

    def _drain(self, entries, ids) -> bool:
        """Commit ``entries`` (in flight under ``ids``) on the calling
        thread.  A failure is stored — re-raised at the next enqueue or
        flush — and stops the committer's thread: returns False."""
        t0 = time.perf_counter()
        try:
            self._commit(entries)
        except BaseException as e:  # stored, re-raised at enqueue/flush
            with self._cv:
                self.error = e
                self._inflight.clear()
                self._cv.notify_all()
            debug.error("write-back committer died: %s", e)
            return False
        finally:
            self.stats["drain_s"] += time.perf_counter() - t0
            with self._cv:
                for did in ids:
                    self._inflight.pop(did, None)
                self._cv.notify_all()
        return True

    def _should_drain(self) -> bool:
        if not self._pending:
            return False
        return ((self._window > 0 and self._pending_bytes >= self._window)
                or self._kick or self._flushing or self._stop)

    def _commit(self, entries) -> None:
        """One drain batch: snapshot (version guard), batched D2H copies
        with one wait, guarded host commits.  Runs entirely at the Data
        level — never takes the device residency lock."""
        dev = self._dev
        snaps = []
        tickets: List[int] = []
        for (data, tks, _nb) in entries:
            snap = dev._wb_snapshot(data)
            if snap is None:
                self.stats["dropped_stale"] += 1
                continue
            snaps.append((data, snap[0], snap[1]))
            tickets.extend(tks)
        if not snaps:
            return
        span = pins.active(pins.WRITEBACK_BEGIN)
        if span:
            info = {"rank": getattr(dev.context, "rank", 0),
                    "id": next(_SPAN_SEQ), "tiles": len(snaps),
                    "bytes": sum(int(getattr(p, "nbytes", 0)) for (_d, p, _v) in snaps)}
            pins.fire(pins.WRITEBACK_BEGIN, None, info)
            t0 = time.perf_counter()
        hosts = dev._d2h_batch([p for (_d, p, _v) in snaps])
        for (data, _payload, version), host in zip(snaps, hosts):
            if dev._commit_host(data, version, host):
                self.stats["committed"] += 1
            else:
                self.stats["dropped_stale"] += 1
        if pins.active(pins.HB_WB_COMMIT) and tickets:
            pins.fire(pins.HB_WB_COMMIT, None, {"tickets": tickets})
        if span:
            info = dict(info, seconds=time.perf_counter() - t0)
            pins.fire(pins.WRITEBACK_END, None, info)
        self.stats["batches"] += 1

    def close(self, flush: bool = True) -> None:
        if flush and self.error is None:
            try:
                self.flush()
            except Exception as e:  # close is teardown: the error surfaced
                debug.warning("write-back committer close: %s", e)
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=30)
