"""The lower-precision controls come out as not correct.

On the card (marked ``cuda``) at each cell's own size on three seeds: the
program reads within its limit and the control above it.  On the CPU at a
small size: the control reads at least three times what the program does,
through the same comparison."""

import pytest

from benchmark.calibrate import readings
from benchmark.harness.spec import load_cell

SEEDS = [2 ** 31 + 901, 2 ** 31 + 902, 2 ** 31 + 903]
CONTROLS = {
    "dpotrf_f32.n32768-nb2048": ("tf32",),
    "prefill_ouro-2.6b.s65536-b8192": ("fp8",),
}
SMALL = {
    "dpotrf_f32.n32768-nb2048": dict(n=1024, nb=256, warm_n=768, sample_jobs=1),
    "prefill_ouro-2.6b.s65536-b8192": dict(batch=1, seq=1024, q_block=256, kv_block=256,
                                           warm_seq=512, sample_jobs=1),
}


def _control_of(cell) -> str:
    """The control that ``limits/<cell>.json`` holds the cell's number
    against."""
    return cell.limits[cell.entry.CHECKS[0]]["control"]


@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_control_reads_above_the_program_on_the_cpu(name):
    cell = load_cell(name, traffic=SMALL[name])
    check = cell.entry.CHECKS[0]
    for row in readings(cell, SEEDS[:2], CONTROLS[name], set(SEEDS), "cpu"):
        for control in CONTROLS[name]:
            assert row[control][check] >= 3 * row["program"][check], row


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_control_is_not_correct_on_the_card(name, card):
    cell = load_cell(name)
    check = cell.entry.CHECKS[0]
    limit = cell.limits[check]["limit"]
    control = _control_of(cell)
    assert (control,) == CONTROLS[name]
    for row in readings(cell, SEEDS, [control], set(SEEDS), card):
        assert row["program"][check] <= limit, row
        assert row[control][check] > limit, row
