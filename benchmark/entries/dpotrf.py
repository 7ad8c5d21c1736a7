"""Jobs of the ``dpotrf`` entry: a tiled lower Cholesky factorization
through ``cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True)``
under ``NativeExecutor(tp, native_device=True)``, the way a user of the
port calls ``dpotrf``.

Traffic keys: ``n`` and ``nb`` (the matrix and its tiles), ``warm_n`` (the
warm-up job's size, same ``nb``), ``sample_jobs`` (how many of the
window's factors are copied aside and compared).

The input is DPLASMA's ``plghe`` matrix, made on the card from the seed
(:func:`benchmark.reference.cholesky.plghe`) and brought home once.  Each
job factors a fresh ``TiledMatrix`` of it, built by the harness between
jobs over host tiles made once at set-up, whose lower triangle is copied
back from the seed's matrix before every job: no job starts on host
memory the one before it did not touch.  A factor is judged by its
componentwise backward error against the same matrix, in float64
(:func:`benchmark.reference.cholesky.componentwise_residual`), as
DPLASMA's ``testing_spotrf`` checks ``A - L L^T``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.cholesky import blocked_cholesky_, componentwise_residual, plghe
from benchmark.roofline import work

#: the compared number: max over the lower triangle of
#: |A - L L^T|_ij / (|L| |L|^T)_ij
CHECKS = ("residual",)


class Job:
    """One cell's dpotrf jobs on ``device`` (``"cuda"`` or ``"cpu"``)."""

    precision = "fp32_accurate"

    def __init__(self, config, traffic, seed: int, device: str):
        from parsec_tpu_torch.datadist import TiledMatrix
        from parsec_tpu_torch.dsl.native_exec import NativeExecutor
        from parsec_tpu_torch.ops import cholesky_ptg, dpotrf_task_count

        if config["dtype"] != "float32":
            raise ValueError(f"dpotrf entry: dtype {config['dtype']} not float32")
        self._TiledMatrix, self._NativeExecutor = TiledMatrix, NativeExecutor
        self._cholesky_ptg = cholesky_ptg
        self.n, self.nb = int(traffic["n"]), int(traffic["nb"])
        self.warm_n = int(traffic["warm_n"])
        self.seed, self.device = int(seed), device
        self._task_count = dpotrf_task_count
        # the input, made on the card from the seed and brought home once
        a = plghe(self.n, self.seed, device)
        self.host = a.cpu().numpy()
        del a
        nt = (self.n + self.nb - 1) // self.nb
        # the jobs' input tiles (lower ones refilled before every job)
        self._tiles = {(i, j): np.ascontiguousarray(self._block(i, j))
                       for i in range(nt) for j in range(nt)}
        # the sampled factors' lower tiles are copied into these slots,
        # made and touched now so that no job finds its memory taken
        self._lower = {(i, j): k for k, (i, j) in enumerate(
            (i, j) for i in range(nt) for j in range(i + 1))}
        self.slots = int(traffic["sample_jobs"])
        self._slots = np.empty((self.slots, len(self._lower), self.nb, self.nb), np.float32)
        self._slots.fill(0.0)

    # -- the work -----------------------------------------------------------
    def work(self):
        """Useful flops and bytes of one job."""
        return work.dpotrf_flops(self.n), work.dpotrf_bytes(self.n, 4)

    # -- the harness's part between jobs --------------------------------------
    def _block(self, i: int, j: int) -> np.ndarray:
        nb = self.nb
        return self.host[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]

    def fresh_input(self, n: int = None):
        """A new tiled matrix holding the seed's matrix, over the host tiles
        made at set-up, its lower tiles copied back from the seed's matrix
        first (a warm-up at another size ``n`` gets a copy of the leading
        ``n`` x ``n`` block instead)."""
        n = n or self.n
        a = self._TiledMatrix(n, n, self.nb, self.nb, name="A", dtype=np.float32)
        if n != self.n:
            return a.from_array(self.host[:n, :n])
        for (i, j), tile in self._tiles.items():
            if i >= j:
                np.copyto(tile, self._block(i, j))
            _set_payload(a.data_of(i, j), tile)
        return a

    # -- the timed job ----------------------------------------------------------
    def run(self, a, span):
        """Factor ``a`` in place, from taskpool construction to the factor
        home on the host.  ``span(phase)`` marks the harness's phases.
        Returns the job's counters."""
        with span("capture"):
            tp = self._cholesky_ptg(use_cuda=True, use_cpu=False,
                                    use_kernels=True).taskpool(NT=a.mt, A=a)
            ex = self._NativeExecutor(tp, native_device=True)
        try:
            with span("run"):
                ran = ex.run()
                _sync(self.device)
        finally:
            with span("writeback"):
                ex.close()
                _sync(self.device)
        if ran != self._task_count(a.mt):
            raise RuntimeError(f"the pump ran {ran} tasks, the DAG has "
                               f"{self._task_count(a.mt)}")
        st = ex.device.stats
        return {"tasks": ran, "submit_s": float(ex.stats["submit_s"]),
                "bytes_in": int(st["bytes_in"]), "bytes_out": int(st["bytes_out"]),
                "output": a}

    def keep(self, a, slot: int) -> None:
        """Copy the lower tiles of the factor ``a`` into ``slot``."""
        from parsec_tpu_torch.data.data import host_array

        for (i, j), k in self._lower.items():
            tile = host_array(a.data_of(i, j).newest_copy().payload)
            h, w = tile.shape
            self._slots[slot, k, :h, :w] = tile

    def kept(self, count: int):
        """The first ``count`` slots, as :meth:`numbers` reads them."""
        return [self._slots[k] for k in range(count)]

    def warm(self, span):
        """One job at the warm-up size, with the cell's tile."""
        self.run(self.fresh_input(self.warm_n), span)

    # -- the comparison -------------------------------------------------------------
    def reference(self):
        """What the factors are judged against: the seed's matrix, made
        again on the device by the plain reference."""
        return plghe(self.n, self.seed, self.device)

    def control(self, precision: str):
        """The control in the program's place: the seed's matrix factored
        by the plain reference in ``precision`` (``"tf32"``)."""
        return blocked_cholesky_(plghe(self.n, self.seed, self.device), self.nb, precision)

    def numbers(self, outputs, a) -> dict:
        """The compared numbers of ``outputs`` (kept slots, or dense
        factors such as the control's) as factors of ``a``."""
        worst = 0.0
        nb = self.nb
        for out in outputs:
            if isinstance(out, torch.Tensor):
                l = out.to(a.device, torch.float64).tril_()
            else:
                l = torch.zeros((self.n, self.n), dtype=torch.float64, device=a.device)
                for (i, j), k in self._lower.items():
                    blk = l[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb]
                    blk.copy_(torch.from_numpy(out[k, :blk.shape[0], :blk.shape[1]]))
                l.tril_()
            worst = max(worst, componentwise_residual(a, l, nb))
            del l
        return {"residual": worst}


def _set_payload(data, tile: np.ndarray) -> None:
    """Make ``tile`` the host payload of ``data``, as
    ``TiledMatrix.from_array`` does with the copy it makes."""
    copy = data.get_copy(0) or data.attach_copy(0, tile)
    copy.payload = tile


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()
