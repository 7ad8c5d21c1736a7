"""The yardstick: useful work of one job, the card's peaks, and the least
time the card could take for that work.

Every count here is of the algorithm, not of one implementation: a
Cholesky factor costs N^3/3 flops whatever kernel, fusion or library call
computes it, and attention costs 4*D flops per (query, key) pair that the
causal mask keeps.  Bytes count each input byte read once and each output
byte written once.  Later changes to the program cannot move these
numbers.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

_PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks() -> Dict:
    """The peak table (``peaks.json``) with its reasons."""
    return json.loads(_PEAKS.read_text())


def dpotrf_flops(n: int) -> float:
    """Useful flops of one lower Cholesky factorization of an n x n
    matrix: n^3 / 3."""
    return n ** 3 / 3.0


def dpotrf_bytes(n: int, itemsize: int) -> int:
    """The lower triangle (diagonal included) read once and the factor
    written once."""
    return 2 * (n * (n + 1) // 2) * itemsize


def causal_pairs_prefill(s: int) -> int:
    """Pairs a causal prefill of s positions keeps: s (s + 1) / 2."""
    return s * (s + 1) // 2


def attention_flops(batch: int, heads: int, head_dim: int, pairs: int) -> float:
    """4 * D flops per kept (query, key) pair (q.k and p.v, a multiply and
    an add each), over every (batch, head) plane."""
    return 4.0 * head_dim * pairs * batch * heads


def attention_bytes(batch: int, seq_q: int, seq_k: int, heads: int, head_dim: int,
                    itemsize: int) -> int:
    """q, k and v read once and the output written once."""
    plane = batch * heads * head_dim * itemsize
    return plane * (2 * seq_q + 2 * seq_k)


def least_seconds(flops: float, nbytes: float, precision: str, table: Dict = None) -> float:
    """The least time the card could take: the larger of flops over the
    precision's peak and bytes over the HBM bandwidth."""
    table = table or peaks()
    return max(flops / table["flops_per_s"][precision],
               nbytes / table["bytes_per_s"]["hbm"])
