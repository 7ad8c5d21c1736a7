"""The program's own spans beside the harness's reading of the card.

``parsec_tpu_torch.profiling.torch_spans.ProfilerSpans`` puts the
program's spans on the ``torch.profiler`` timeline as ``parsec.<span>``
host ranges.  On the card (marked ``cuda``), a traced job of each cell at
a small size, with the sink installed, leaves ``from_profiler``'s device
events free of them: ``device_idle_share``, ``kernels_roofline`` and
``h2d_gbps`` read the same kernels and copies with the sink as without
it.  A checkout whose program has no such sink skips."""

import pytest

from benchmark.harness import trace as tr
from benchmark.harness.cell import Phases, bind_device
from benchmark.harness.spec import load_cell

SMALL = {
    "dpotrf_f32.n32768-nb2048": dict(n=4096, nb=1024, warm_n=2048, sample_jobs=1),
    "prefill_ouro-2.6b.s65536-b8192": dict(batch=1, seq=8192, q_block=2048,
                                           kv_block=2048, warm_seq=4096, sample_jobs=1),
}
SEED = 2 ** 31 + 29


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_program_ranges_are_host_events_only(name, card):
    torch_spans = pytest.importorskip("parsec_tpu_torch.profiling.torch_spans")
    from torch.profiler import ProfilerActivity, profile

    cell = load_cell(name, traffic=SMALL[name])
    bind_device(card)
    job = cell.entry.Job(cell.config, cell.traffic, SEED, card)
    phases = Phases(True)
    job.warm(phases)
    sink = torch_spans.ProfilerSpans().install()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            phases.current = {}
            with phases("job"):
                job.run(job.fresh_input(), phases)
    finally:
        sink.uninstall()
    ranges = {ev.name for ev in prof.events() if ev.name.startswith("parsec.")}
    assert {"parsec.pump", "parsec.submit", "parsec.close"} <= ranges, ranges
    device, host = tr.from_profiler(prof)
    assert device and not [n for n, _a, _b in device if n.startswith("parsec.")]
    assert [n for n, _a, _b in host].count("job") == 1
    summary = tr.summarize(device, host)
    assert 0 < summary.busy_s <= summary.window_s
