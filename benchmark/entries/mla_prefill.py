"""Jobs of the ``mla_prefill`` entry: the causal prefill of one latent
attention (MLA) layer through ``build_mla_attention(q, c_kv, k_pe, w_kv_b,
causal=True, ...)`` under ``NativeExecutor(tp, native_device=True)``, with
the output assembled on the host.

Traffic keys: ``batch`` and ``seq`` (the prefill), ``q_block`` and
``kv_block`` (the tiles), ``warm_seq`` (the warm-up job's length, same
blocks), ``sample_jobs`` (how many of the window's outputs are copied
aside and compared).  The configuration gives the heads and the widths
(``qk_nope_head_dim``, ``qk_rope_head_dim``, ``v_head_dim``,
``kv_lora_rank``) and the YaRN scaling the softmax scale folds in.

q, the latent c, the rotary key k_pe and ``kv_b_proj`` are random
bfloat16 tensors made on the card from the seed and brought home once;
every job reads them (the graph's planes are views of them).  Each job's
``kv_up`` tasks expand the latent into K and V tiles on the card (B2),
and its steps run B5's bfloat16 engine at 192 / 128.  The output is judged
row by row against a float64 latent attention of the same inputs.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.mla import mla_attention, softmax_scale
from benchmark.roofline import mla, work

#: the compared number: the worst row's max |O - O_ref| over its max |O_ref|
CHECKS = ("out_err",)


class Job:
    """One cell's latent-attention prefill jobs on ``device`` (``"cuda"``
    or ``"cpu"``)."""

    dtype = torch.bfloat16
    precision = "bf16"

    def __init__(self, config, traffic, seed: int, device: str):
        from parsec_tpu_torch.dsl.native_exec import NativeExecutor
        from parsec_tpu_torch.ops import build_mla_attention, mla_attention_task_count

        if config["dtype"] != "bfloat16":
            raise ValueError(f"mla_prefill entry: dtype {config['dtype']} not bfloat16")
        if config.get("q_lora_rank") is not None:
            raise ValueError("mla_prefill entry: q comes whole; a q_lora_rank is outside the job")
        self._build, self._NativeExecutor = build_mla_attention, NativeExecutor
        self._task_count = mla_attention_task_count
        self.heads = int(config["num_attention_heads"])
        self.d_nope, self.d_rope = int(config["qk_nope_head_dim"]), int(config["qk_rope_head_dim"])
        self.d_qk, self.d_v = self.d_nope + self.d_rope, int(config["v_head_dim"])
        self.latent = int(config["kv_lora_rank"])
        self.scale = softmax_scale(self.d_nope, self.d_rope, config.get("rope_scaling"))
        self.batch, self.seq = int(traffic["batch"]), int(traffic["seq"])
        self.q_block, self.kv_block = int(traffic["q_block"]), int(traffic["kv_block"])
        self.warm_seq = int(traffic["warm_seq"])
        self.seed, self.device = int(seed), device
        self.inputs = tuple(t.cpu() for t in self._inputs())
        # the sampled outputs are copied into these slots, made and
        # touched now so that no job finds its memory taken
        self.slots = int(traffic["sample_jobs"])
        self._slots = torch.zeros((self.slots, self.batch, self.seq, self.heads, self.d_v),
                                  dtype=self.dtype)

    def _inputs(self):
        return make_inputs(self.batch, self.seq, self.heads, self.d_nope, self.d_rope,
                           self.d_v, self.latent, self.seed, self.device, self.dtype)

    def _attention_work(self, seq: int):
        """The attention part's flops and bytes of a job of ``seq``."""
        pairs = work.causal_pairs_prefill(seq)
        return (mla.attention_flops(self.batch, self.heads, self.d_qk, self.d_v, pairs),
                mla.attention_bytes(self.batch, seq, self.heads, self.d_qk, self.d_v,
                                    self.dtype.itemsize))

    def work(self):
        """Useful flops and bytes of one job."""
        attn, _ = self._attention_work(self.seq)
        return (attn + mla.expansion_flops(self.batch, self.seq, self.heads, self.latent,
                                           self.d_nope, self.d_v),
                mla.job_bytes(self.batch, self.seq, self.heads, self.d_qk, self.latent,
                              self.d_rope, self.d_nope, self.d_v, self.dtype.itemsize))

    def fresh_input(self, seq: int = None):
        """The job's q, c, k_pe (their leading ``seq`` positions for the
        warm-up) and the weight.  The graph's planes are views of them, so
        nothing is copied here."""
        s = seq or self.seq
        q, c, pe, w = self.inputs
        return q[:, :s], c[:, :s], pe[:, :s], w

    def run(self, inputs, span):
        """The prefill, from taskpool construction to the output home on
        the host.  Returns the job's counters."""
        q, c, pe, w = inputs
        with span("capture"):
            tp, assemble = self._build(q, c, pe, w, scale=self.scale, causal=True,
                                       q_block=self.q_block, kv_block=self.kv_block,
                                       use_cpu=False)
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
        want = self._task_count(q.shape[0], q.shape[1], q.shape[2], self.q_block,
                                self.kv_block, causal=True)
        if ran != want:
            raise RuntimeError(f"the pump ran {ran} tasks, the DAG has {want}")
        st = ex.device.stats
        attn_flops, attn_bytes = self._attention_work(q.shape[1])
        return {"tasks": ran, "submit_s": float(ex.stats["submit_s"]),
                "bytes_in": int(st["bytes_in"]), "bytes_out": int(st["bytes_out"]),
                "scratch_tiles": int(st["scratch_tiles"]),
                "scratch_bytes": int(st["scratch_bytes"]),
                "scratch_h2d_bytes": int(st["scratch_h2d_bytes"]),
                "attn_flops": attn_flops, "attn_bytes": attn_bytes,
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
        """The latent attention of the seed's inputs by the plain reference
        on the device, in float64: what the outputs are judged against."""
        return self.control("float64")

    def control(self, precision: str):
        """The plain reference in ``precision``: float64, or ``"fp8"``,
        the control put in the program's place."""
        return mla_attention(*self._inputs(), self.scale, precision)

    def numbers(self, outputs, ref) -> dict:
        """The compared numbers of ``outputs`` (``[B, S, H, Dv]`` tensors)
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


def make_inputs(batch: int, seq: int, heads: int, d_nope: int, d_rope: int, d_v: int,
                latent: int, seed: int, device, dtype):
    """q ``[batch, seq, heads, d_nope + d_rope]``, the latent ``[batch,
    seq, latent]`` and the rotary key ``[batch, seq, d_rope]``, standard
    normal, and ``kv_b_proj`` ``[heads * (d_nope + d_v), latent]`` with
    std ``1 / sqrt(latent)``, made on ``device`` from ``seed`` in one call
    and rounded to ``dtype``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes = (batch * seq * heads * (d_nope + d_rope), batch * seq * latent, batch * seq * d_rope,
             heads * (d_nope + d_v) * latent)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    q, c, pe, w = torch.split(flat, sizes)
    return (q.view(batch, seq, heads, d_nope + d_rope).to(dtype),
            c.view(batch, seq, latent).to(dtype),
            pe.view(batch, seq, d_rope).to(dtype),
            (w.view(heads * (d_nope + d_v), latent) / math.sqrt(latent)).to(dtype))


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()
