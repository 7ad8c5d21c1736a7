"""The yardstick of the latent-attention (MLA) prefill: useful work of one
job, counted from the algorithm as ``work.py`` counts the others.

Attention costs ``2 * (Dqk + Dv)`` flops per kept (query, key) pair and
head: ``q . k`` over the 192 query/key columns and ``p . v`` over the 128
value columns, a multiply and an add each.  The expansion of the latent
cache costs ``2 * L * (Dn + Dv)`` flops per token and head (``c`` times
the head's ``kv_b_proj`` rows).  The job's bytes are its inputs read once
(q, the latent, the rotary key, the weight) and its output written once;
the expanded K and V are made and read on the card, by the algorithm's
choice, and are not counted.  Later changes to the program cannot move
these numbers.
"""

from __future__ import annotations


def attention_flops(batch: int, heads: int, d_qk: int, d_v: int, pairs: int) -> float:
    """``2 * (Dqk + Dv)`` flops per kept pair, over every (batch, head)."""
    return 2.0 * (d_qk + d_v) * pairs * batch * heads


def expansion_flops(batch: int, seq: int, heads: int, latent: int, d_nope: int,
                    d_v: int) -> float:
    """The up-projection of the latent into each head's K and V columns."""
    return 2.0 * batch * seq * heads * latent * (d_nope + d_v)


def attention_bytes(batch: int, seq: int, heads: int, d_qk: int, d_v: int,
                    itemsize: int) -> int:
    """The attention part alone: q, the expanded K and V read once, the
    output written once."""
    return batch * seq * heads * (2 * d_qk + 2 * d_v) * itemsize


def job_bytes(batch: int, seq: int, heads: int, d_qk: int, latent: int, rope: int,
              d_nope: int, d_v: int, itemsize: int) -> int:
    """q, the latent, the rotary key and ``kv_b_proj`` read once, the
    output written once."""
    q = batch * seq * heads * d_qk
    cache = batch * seq * (latent + rope)
    weight = heads * (d_nope + d_v) * latent
    out = batch * seq * heads * d_v
    return (q + cache + weight + out) * itemsize
