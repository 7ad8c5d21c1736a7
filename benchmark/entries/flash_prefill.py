"""Jobs of the ``flash_prefill`` entry: one causal attention layer's
prefill through ``build_flash_attention(q, k, v, causal=True, ...)`` under
``NativeExecutor(tp, native_device=True)``, the graph and executor of
``run_flash_attention_native``, with the output assembled on the host.

Traffic keys: ``batch`` and ``seq`` (the prefill), ``q_block`` and
``kv_block`` (the tiles), ``warm_seq`` (the warm-up job's length, same
blocks), ``sample_jobs`` (how many of the window's outputs are copied
aside and compared).  The configuration gives the heads and the head dimension.

q, k and v are random bfloat16 activations made on the card from the seed
and brought home once; every job reads them (the graph copies its own
planes), and the graph's steps run B5's bfloat16 engine.  The output is
judged row by row against a float64 attention of the same q, k and v.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.attention import causal_attention
from benchmark.roofline import work

#: the compared number: the worst row's max |O - O_ref| over its max |O_ref|
CHECKS = ("out_err",)


class Job:
    """One cell's prefill jobs on ``device`` (``"cuda"`` or ``"cpu"``)."""

    dtype = torch.bfloat16
    precision = "bf16"

    def __init__(self, config, traffic, seed: int, device: str):
        from parsec_tpu_torch.dsl.native_exec import NativeExecutor
        from parsec_tpu_torch.ops import attention_task_count, build_flash_attention

        if config["dtype"] != "bfloat16":
            raise ValueError(f"flash_prefill entry: dtype {config['dtype']} not bfloat16")
        if config["num_key_value_heads"] != config["num_attention_heads"]:
            raise ValueError("flash_prefill entry: the graph takes MHA only")
        self._build, self._NativeExecutor = build_flash_attention, NativeExecutor
        self._task_count = attention_task_count
        self.heads, self.head_dim = int(config["num_attention_heads"]), int(config["head_dim"])
        self.batch, self.seq = int(traffic["batch"]), int(traffic["seq"])
        self.q_block, self.kv_block = int(traffic["q_block"]), int(traffic["kv_block"])
        self.warm_seq = int(traffic["warm_seq"])
        self.seed, self.device = int(seed), device
        self.q, self.k, self.v = (t.cpu() for t in self._qkv())
        # the sampled outputs are copied into these slots, made and
        # touched now so that no job finds its memory taken
        self.slots = int(traffic["sample_jobs"])
        self._slots = torch.zeros((self.slots, self.batch, self.seq, self.heads,
                                   self.head_dim), dtype=self.dtype)

    def _qkv(self):
        return make_qkv(self.batch, self.seq, self.heads, self.head_dim, self.seed,
                        self.device, self.dtype)

    def work(self):
        """Useful flops and bytes of one job."""
        pairs = work.causal_pairs_prefill(self.seq)
        return (work.attention_flops(self.batch, self.heads, self.head_dim, pairs),
                work.attention_bytes(self.batch, self.seq, self.seq, self.heads,
                                     self.head_dim, self.dtype.itemsize))

    def fresh_input(self, seq: int = None):
        """The job's q, k and v (their leading ``seq`` positions for the
        warm-up).  The graph copies its planes from them, so nothing is
        copied here."""
        s = seq or self.seq
        return tuple(t[:, :s] for t in (self.q, self.k, self.v))

    def run(self, qkv, span):
        """The prefill, from taskpool construction to the output home on
        the host.  Returns the job's counters."""
        q, k, v = qkv
        with span("capture"):
            tp, assemble = self._build(q, k, v, causal=True, q_block=self.q_block,
                                       kv_block=self.kv_block, use_cpu=False)
            ex = self._NativeExecutor(tp, native_device=True)
        try:
            with span("run"):
                ran = ex.run()
                _sync(self.device)
        finally:
            with span("writeback"):
                ex.close()
                _sync(self.device)
        with span("assemble"):
            out = assemble()
        want = self._task_count(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                                self.q_block, self.kv_block, causal=True)
        if ran != want:
            raise RuntimeError(f"the pump ran {ran} tasks, the DAG has {want}")
        st = ex.device.stats
        return {"tasks": ran, "submit_s": float(ex.stats["submit_s"]),
                "bytes_in": int(st["bytes_in"]), "bytes_out": int(st["bytes_out"]),
                "output": out}

    def keep(self, out, slot: int) -> None:
        """Copy the output ``out`` into ``slot``."""
        self._slots[slot].copy_(out)

    def kept(self, count: int):
        """The first ``count`` slots, as :meth:`numbers` reads them."""
        return [self._slots[k] for k in range(count)]

    def warm(self, span):
        """One job at the warm-up length, with the cell's blocks."""
        self.run(self.fresh_input(self.warm_seq), span)

    def reference(self):
        """The attention of the seed's q, k, v by the plain reference on
        the device, in float64: what the outputs are judged against."""
        return self.control("float64")

    def control(self, precision: str):
        """The plain reference in ``precision``: float64, or ``"fp8"``,
        the control put in the program's place."""
        return causal_attention(*self._qkv(), 1.0 / math.sqrt(self.head_dim), precision)

    def numbers(self, outputs, ref) -> dict:
        """The compared numbers of ``outputs`` (``[B, S, H, D]`` tensors)
        against ``ref``, a block of rows at a time."""
        worst = 0.0
        rows = 4096
        for out in outputs:
            for s0 in range(0, self.seq, rows):
                got = out[:, s0:s0 + rows].to(ref.device, torch.float64)
                want = ref[:, s0:s0 + rows].double()
                err = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
                worst = max(worst, err if math.isfinite(err) else float("inf"))
        return {"out_err": worst}


def make_qkv(batch: int, seq: int, heads: int, head_dim: int, seed: int, device, dtype):
    """q, k and v of shape ``[batch, seq, heads, head_dim]``, standard
    normal, made on ``device`` from ``seed`` in one call and rounded to
    ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    qkv = torch.randn((3, batch, seq, heads, head_dim), generator=gen,
                      device=device).to(dtype)
    return qkv[0], qkv[1], qkv[2]


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()
