"""Interval arithmetic behind device_idle_share and kernels_roofline, on
synthetic events."""

import pytest

from benchmark.harness import trace as tr


def test_union_and_length():
    assert tr.union([(3, 4), (0, 2), (1, 3), (6, 6)]) == [(0, 4)]
    assert tr.union([(0, 1), (2, 3)]) == [(0, 1), (2, 3)]
    assert tr.length([(0, 2), (1, 3), (5, 6)]) == 4


def test_clip_and_gaps():
    assert tr.clip([(0, 10)], [(2, 3), (5, 7)]) == [(2, 3), (5, 7)]
    assert tr.clip([(0, 1)], [(2, 3)]) == []
    assert tr.gaps([(1, 2), (4, 5)], (0, 6)) == [(0, 1), (2, 4), (5, 6)]
    assert tr.gaps([], (0, 6)) == [(0, 6)]
    assert tr.gaps([(0, 6)], (1, 2)) == []


def test_kind_of_names():
    assert tr.kind_of("Memcpy HtoD (Pageable -> Device)") == "h2d"
    assert tr.kind_of("Memcpy DtoH (Device -> Pinned)") == "d2h"
    assert tr.kind_of("Memcpy DtoD (Device -> Device)") == "d2d"
    assert tr.kind_of("Memset (Device)") == "memset"
    assert tr.kind_of("void flash_block_kernel<float, 128, false>(...)") == "kernel"


def test_summarize_synthetic_window():
    # two jobs of 10 us each; the harness's gap between them (10..20) holds
    # a kernel that must not count
    host = [("job", 0, 10), ("capture", 0, 2), ("run", 2, 8), ("writeback", 8, 10),
            ("job", 20, 30), ("capture", 20, 21), ("run", 21, 30)]
    device = [("k1", 2, 5), ("k1", 4, 6),            # overlapping kernels: sum 5, union 4
              ("Memcpy HtoD (Pageable -> Device)", 6, 7),
              ("outside", 12, 18),
              ("k2", 25, 29), ("Memcpy DtoH (Device -> Pageable)", 29, 31)]
    s = tr.summarize(device, host, scale=1.0)
    assert s.jobs == 2
    assert s.window_s == 20
    assert s.busy_s == 4 + 1 + 4 + 1          # 2..7, 25..30 (the copy clipped at 30)
    assert s.kernel_s == 3 + 2 + 4            # summed, not unioned
    assert s.h2d_s == 1 and s.h2d_count == 1
    assert s.d2h_s == 1
    assert dict(s.device_ops)["k1"] == 5
    assert "outside" not in dict(s.device_ops)
    idle = dict(s.idle_gaps)
    # job 1 idle: 0..2 capture, 7..8 run, 8..10 writeback; job 2: 20..21
    # capture, 21..25 run
    assert idle == pytest.approx({"capture": 3, "run": 5, "writeback": 2})
    assert sum(idle.values()) == pytest.approx(s.window_s - s.busy_s)


def test_summarize_without_jobs_reads_nothing():
    s = tr.summarize([("k", 0, 1)], [])
    assert s.jobs == 0 and s.window_s == 0 and s.busy_s == 0
