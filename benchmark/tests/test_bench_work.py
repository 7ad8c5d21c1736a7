"""The frozen work counts and the peak table against hand counts."""

import itertools

import pytest

from benchmark.roofline import work


def test_dpotrf_counts_by_hand():
    assert work.dpotrf_flops(3) == 9.0
    assert work.dpotrf_flops(32768) == pytest.approx(1.1728e13, rel=1e-4)
    # a 3 x 3 lower triangle holds 6 floats: read once, written once
    assert work.dpotrf_bytes(3, 4) == 2 * 6 * 4


@pytest.mark.parametrize("s", [1, 2, 4, 7, 64])
def test_causal_pairs_by_brute_force(s):
    brute = sum(1 for r, c in itertools.product(range(s), range(s)) if c <= r)
    assert work.causal_pairs_prefill(s) == brute


def test_prefill_counts():
    # the prefill cell: 4 D flops per kept pair over 16 heads
    flops = work.attention_flops(1, 16, 128, work.causal_pairs_prefill(65536))
    assert flops == 4 * 128 * 16 * 65536 * 65537 // 2
    assert flops == pytest.approx(1.76e13, rel=1e-3)
    # q, k, v read once, the output written once: 4 planes of 2 x 3 x 5 floats
    assert work.attention_bytes(1, 2, 2, 3, 5, 4) == 4 * 2 * 3 * 5 * 4


def test_peaks_carry_their_reasons():
    p = work.peaks()
    assert p["flops_per_s"]["fp32_accurate"] == pytest.approx(495e12 / 3)
    assert p["bytes_per_s"]["hbm"] == 3.35e12
    for key in list(p["flops_per_s"]) + list(p["bytes_per_s"]):
        assert p["why"][key]


def test_least_seconds_takes_the_larger_bound():
    p = work.peaks()
    # compute-bound: flops dominate
    assert work.least_seconds(165e12, 1.0, "fp32_accurate", p) == pytest.approx(1.0)
    # bytes-bound: 3.35 TB at 3.35 TB/s
    assert work.least_seconds(1.0, 3.35e12, "fp32_accurate", p) == pytest.approx(1.0)
