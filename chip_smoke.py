#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (parsec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written CUDA kernels from ``parsec_tpu_torch/csrc`` and
   prints ptxas's registers and spills per kernel (stderr), then the native
   engine library from ``native/src`` (g++);
3. kernel phase: runs every mode of ``matmul_update`` (B1: f32, bf16,
   split_f32) and ``matmul`` (B2: f32, bf16), each with and without
   ``transpose_b``, at the dpotrf tile shape (512 x 512 x 512), a ragged
   shape, one 64 x 64 x 16 slab and a shape whose row pitches are not
   16-byte multiples;
   ``flash_attention_block`` (B5) in f32 and bf16 at the attention path's
   blocks (the prefill's full and diagonal blocks, the decode step's
   ragged 96 x 416 tail) and at a ragged (100, 300) with head dimensions
   37, 64 and 256, causal and not (every equal-width template and the
   predicated copies), the wide kernel at (100, 300) and (512, 512) with
   D = 320 and 512, a float16 and a mixed-dtype case (the f32 engine on
   float32 copies), and latent attention's q/k 192 against v 128 (the bf16
   ``<192, 128>`` template: the 512 block causal and not, the MLA cell's
   8192 blocks — below the diagonal, the diagonal and not causal — the
   ragged (100, 300) causal and not, and 165 / 99 on the same template),
   held to 1e-4 of each tensor's largest magnitude (at least 1); ``stencil_5pt`` (B3) in f32, f64, f16 and bf16 at its
   tile, ragged and at an unaligned shape (the scalar variant), timed
   L2-warm and L2-cold; ``stencil_5pt_fused`` (B4) in each mode (smem:
   512^2, 999^2 (a ragged last strip) and 2048^2 f32, 1024^2 f64 and f16;
   global: 2048^2 f64), timed at
   100 steps and at one.  Holds each against its plain PyTorch
   version on the card at the tolerances of
   tests/runtime/test_pallas_kernels.py (B1/B2 float32 1e-4 relative, bf16
   operands 1e-3: only the summation order differs; B2 with bf16 output
   one bf16 ulp; B5 1e-4 for its carry taken to the
   plain version's running max, and B5's masked-at-init update exactly, in
   both dtypes and at D = 512), B3 and B4 bit for bit
   (``torch.equal``); holds every f32-class B1/B2 mode against a float64
   product (< 1e-5, and the f32 modes at the tile within 2x of the plain
   version's, cuBLAS FP32, error) and every B5 case against the update in
   float64 (< 1e-4; the f32 mode at the full and diagonal blocks also
   within 2x of the plain version's error); checks that two launches on
   the same inputs are bit-identical; and times kernel, plain version and,
   for B1/B2, the one-call PyTorch yardstick (``torch.addmm``,
   ``torch.matmul``); B1 ``split_f32`` with B not transposed and B2 f32
   with B not transposed also at their callers' shapes (a segmented-LU
   strip, 15872 x 4096 x 512; tiled QR's tsmqr, (1024 x 1024) x
   (1024 x 512)), and B2 bf16 at latent attention's ``kv_up`` (8192 x 128
   x 512); then the batch axis: B1 (f32, bf16, split_f32 and f32
   with B not transposed at dpotrf's largest gemm group, 105 x 512^3, and
   the last at the tiled LU's, 225), B2 (f32 at dpotrf trtri's trsm group
   of 15 sharing one inverse, f32 with B not transposed at tiled QR's
   largest tsmqr group, 65), B3 (the stencil's 36 interior tiles of a
   step, halos strided slices of stacked neighbours, and a top-edge group
   sharing one zero halo row) and B5 (f32 and bf16 at the prefill's
   largest level, 256 x (512 x 512 x 128), each member's q offset its own,
   three fully masked; the wide kernel at 8 x D = 512; bf16 at 192 / 128,
   256 members), each one launch
   through ``torch.func.vmap`` as a level-batched replay makes it,
   ``torch.equal`` to its members launched one by one, within the
   kernel's tolerance of its batched plain version (B3 bit for bit), the
   masked members' carries exact, timed beside the members launched one
   by one, with its bound; then one latent-attention prefill job through
   the pump (``build_mla_attention``, 16 heads, 16384 tokens in the MLA
   cell's 8192-blocks): its tasks, B5 and B2 launches, task-made tiles
   (none staged in) and ``bytes_in`` against the graph's counts, its
   output against ``parsec_tpu_torch/reference/mla.py`` a head at a time
   by the MLA cell's comparison and limit;
4. dpotrf path: tiled dpotrf at N=8192 nb=512 float32 through
   ``Context`` / ``add_taskpool`` / ``wait`` with every task on the CUDA
   device module — hand kernels for the updates, then the ``use_trtri``
   variant (trsm as a B2 product), then ``bf16_updates`` — checking the
   factor, the task counts and the kernel launch counts of each run, per
   operand mode; ``kernels`` and ``kernels_trtri`` at
   ``runtime_stage_depth`` 1 (the default: no committer) and 2 (the
   write-back committer) in turns (1, 2, 2, 1, 1, 2), the factors
   ``torch.equal``; ``kernels_bf16`` at depth 2;
   then, through the native pump (``NativeExecutor(tp, native_device=True)``:
   the captured DAG on the C++ engine built by g++ from ``native/src``,
   one ``pop_batch`` and one ``done_batch`` per batch, no per-task
   interpreter entry), ``kernels`` and ``kernels_trtri`` at stage depth 1
   and 2 (the prefetch window) in turns (1, 2, 2, 1, 1, 2), each factor
   ``torch.equal`` to the dynamic run's and its B1/B2 launches per mode
   equal to the dynamic run's; then the pump's ``kernels`` under a 96 MB
   device budget (below
   the 256 MiB matrix: eviction and write-back under the pipeline), with
   waves on, its
   factor ``torch.equal`` too, with evictions and no synchronous
   write-back fallback; then each variant through ``GraphExecutor``
   (whole-DAG capture: the first call — warm-up, capture, replay — timed
   on its own, then five replays on reused device feeds), every output
   tile ``torch.equal`` to the dynamic factor, the launches of one eager
   warm-up and six replays; then each through ``GraphExecutor(tp,
   batch_levels=True)`` on the same feeds (``graph_batched`` lines: no
   group fallen back, the launches a call the plan's groups mode by mode,
   the factor within the path's gates, its max abs difference to the
   unbatched replay, first-call s, replay median beside the unbatched
   one, stack bytes a call); then the front ends (``front_ends`` lines):
   the same dpotrf inserted through DTD (``ops.insert_dpotrf``, an
   insertion window of 64 tasks) in the three variants, and compiled from
   the port's ``examples/jdf/cholesky.jdf`` — dynamic, through the pump,
   as a ``GraphExecutor`` first call, and as a module ``jdfc`` generated
   from the file — each factor ``torch.equal`` to the PTG's on the same
   path with the PTG's launches per mode, every task on the CUDA module;
   then DTD ``kernels`` at N=4096 under each of the twelve schedulers and
   ``spq``/``wdrr`` with ``sched_native_queue=1``, each factor
   ``torch.equal`` to ``lfq``'s and to the PTG's, with walls and tasks/s
   beside the PTG run's; then the ``legacy_async`` phase
   (:func:`legacy_async_phase`): ``kernels`` and ``kernels_trtri``
   through the native engine's legacy ASYNC-chore protocol — native
   workers hand each task to the CUDA module, whose completion callback
   calls ``NativeGraph.task_done`` — with ``runtime_native_sched=off`` and
   with ``device_cuda_eager_complete=0``, each factor ``torch.equal`` to
   the same call's pump factor with the pump's launches (B1 680, B2 120
   with ``trtri``) and one trampoline entry and one completion callback a
   task (816; 831 with ``trtri``), each ``legacy_async`` line with its
   wall beside the pump's; a mixed DAG (``potrf``'s CUDA body taken
   away: 16 host tasks through the ``Data`` staging discipline, 800 on
   the card) within 1e-3 of the pump's factor, with 680 B1 launches and
   the host versions of the diagonal tiles kept through the detach; the
   dynamic path with ``runtime_dep_storage=dense`` and with
   ``runtime_vpmap=nb:2`` and the pump with ``nb:2``, each ``torch.equal``
   to the hash and flat runs; a ``checkpoint.save`` of the factor while
   its tiles are newest on the card, restored into a fresh collection in
   a new ``Context`` (``np.array_equal``), and ``diag_band_to_rect`` of
   the device-newest factor against its host reference
   (``single_card_core`` lines); then the ``analysis`` phase
   (:func:`analysis_phase`): ``PTG.verify`` of the path's ``kernels`` and
   ``kernels_trtri`` graphs at N=8192 and ``tools lint --all`` over the
   registry, clean; the dynamic ``kernels`` and ``kernels_trtri`` and the
   depth-2 pump's ``kernels`` under ``PARSEC_TPU_LINT=strict``,
   ``PARSEC_TPU_HBCHECK=strict`` and ``PARSEC_TPU_LOCKDEP=1``, each right
   after the same run unchecked, every factor ``torch.equal`` to the
   dynamic path's with its launches and no checker finding; the schedule
   explorer over four seeds of the dynamic ``kernels`` dpotrf, each
   digest that factor's bit for bit; and ``verify_engine`` against the
   engine the port built (ABI, model, conformance at the nt=16 DAG) with
   no finding (``analysis_*`` lines); then the ``profiling`` phase
   (:func:`profiling_phase`): the dynamic ``kernels`` and
   ``kernels_trtri``, the depth-2 pump's ``kernels`` and the f32 prefill
   (through ``measure_overlap``) each once untraced and once under the
   binary tracer (``RankTraceSet``), every traced output ``torch.equal``
   to the untraced one with its launches; each dump read back (an
   ``exec`` pair a task, the DAG's edges, ``critpath``'s chain as long as
   the DAG's longest path, its buckets printed), ``tools info``,
   ``to-csv``, ``critpath``, ``merge``, ``hbcheck`` and ``check`` on the
   dumps, and a ``GraphExecutor`` traced cold (one ``compile`` span) and
   on a program-cache hit (none) (``profiling*`` lines);
5. device-module phase: a 2048 x 2048 dpotrf with event-polled
   completion and one under an 8 MB residency budget (eviction
   write-back), each checked against a float64 Cholesky;
6. attention path: ``run_flash_attention`` at Llama-2-7B's attention
   geometry (32 heads x 128, B=1), causal prefill of 4096 tokens in
   512-blocks in float32 and in bfloat16, and a 96-token decode against
   4000 keys, each checked against ``attention_reference`` in float64, with
   its task and B5 launch counts (the bf16 prefill and the decode at
   stage depth 2), the f32 prefill at stage depth 1 and 2 in turns, each
   output ``torch.equal`` to the first;
   ``scaled_dot_product_attention`` on the prefill problem is timed beside
   it as the yardstick; then the f32 prefill through
   ``run_flash_attention_native`` at stage depth 1 and 2 in turns (and
   once more through its pieces, to time capture and build apart), each
   output ``torch.equal`` to ``run_flash_attention``'s; then the f32
   prefill's taskpool through ``GraphExecutor``, each output plane equal
   to ``run_flash_attention``'s, and level-batched (8 B5 launches a call),
   ``torch.equal`` to the unbatched replay;
7. stencil path: ``stencil_ptg(use_kernels=True)`` on an 8192^2 float32
   grid in 1024^2 tiles for 20 steps (B3 launches counted), through
   ``Context`` at stage depth 1 and 2 in turns and then through the native
   pump at stage depth 1 and 2 in turns (and at 2 with the reference's
   32 MB write-back watermark: the committer draining mid-run beside the
   kernels), each grid ``torch.equal`` to the first; then through
   ``GraphExecutor``, equal tile by tile, and level-batched, ``torch.equal``
   to the unbatched replay; then B4 on the leading 2048^2
   block for 100 steps (one smem-mode launch), all against a float64
   reference;
8. transfer phase: the stencil's 64 tiles of 4 MiB, twice, host->device
   and back through the device module's copy engine (pinned buffers, copy
   streams) and through pageable ``.to()`` / ``.cpu()``, in turns, each
   direction's GB/s printed;
9. the dense factorizations beyond dpotrf: getrf's card tile body
   (``lu_factor_ex(pivot=False)``) against the rank-1 loop it replaces;
   ``SegmentedCholesky`` at N=32768 nb=512 (strip 4096, tail 4096) on the
   KMS matrix built on the card, through ``Context`` and the CUDA device
   module, static (twice), generic and bf16 storage, and
   ``WholeCholesky`` twice as the runtime-bypassing ceiling, each gated
   by the sampled 256-row reconstruction against the closed-form oracle
   (bench.py:2227-2256; the matrix factored in place, no host copy);
   ``SegmentedLU`` at N=16384 (tail 8192: plain f32, ``fused_update``
   through B1 ``split_f32``, bf16 storage) and ``SegmentedQR`` (tail
   2048), gated as bench.py:2475-2497; tiled LU and QR at N=8192 nb=512
   with the hand kernels (B1 and B2 with B not transposed) through
   ``Context``, the native pump (factor ``np.array_equal`` to the
   dynamic one) and ``GraphExecutor`` (first call and two replays;
   unbatched and level-batched), gated
   by a sampled reconstruction and by A^T A = R^T R on sampled columns;
   each run's B1/B2 launches per mode checked exactly;
10. with ``--profile``, runs the two f32 dpotrf variants, the f32 prefill
   and the stencil (through ``Context`` and through the pump, each at
   stage depth 1 and 2) once more under ``torch.profiler``, and the
   pump's dpotrf ``kernels`` (at stage depth 1 and 2) and f32 prefill,
   and prints the device busy time (the union of the kernels' and
   copies' intervals, beside their sum), the idle share, H2D/D2H device
   ms and GB/s, and how much of the copy time overlaps kernel time; then
   the pump's and the dynamic dpotrf and the stencil pump with waves on
   and off (``d2d_ms``: the wave chunks' device-to-device copies), and one
   ``GraphExecutor`` replay of dpotrf, the prefill and the stencil, and
   one level-batched replay of each (its member stacks show in ``top`` as
   ``CatArrayBatchedCopy`` kernels);
11. prints each path's walls at stage depth 1 and 2 (``stage_depth_walls``,
   with the ratio of their medians) and with waves on and off
   (``wave_walls``), the kernel table as one JSON line, the
   card line, and last ``{"ok": true, "device": {...}}``.

Wave batching (``device_cuda_wave_batch``): the dynamic and pump runs of
dpotrf ``kernels`` and ``kernels_trtri``, the f32 prefill and the stencil
each run six times more at stage depth 1, waves on (2) and off (0) in
turns (on, off, off, on, on, off), every output ``torch.equal`` to the
path's first run, with the same kernel launches; ``waves`` lines print
each run's wall, host ms a task and wave counters.  Each waves-on run
starts with no graph cached — the card's graphs go when the last device
module holding them detaches — so it pays its own captures, as a DAG run
once does (``capture_share``: capture seconds over the wall).  Then the
stencil pump runs on a grid twice the path's side, with waves off on the
open card and with waves on on a card that a ballast tensor has filled
to ``NEAR_FULL_MB`` free: the automatic budget falls below the grid's
tiles, the run evicts, and its graphs are captured within the room the
budget leaves them, with no out-of-memory error and the open card's
grid.

Supertask fusion (``runtime_fusion``): the dynamic and pump runs of dpotrf
``kernels`` and ``kernels_trtri``, the f32 prefill and the stencil each
run six times more at stage depth 1 with waves off, fusion off and
``auto`` in turns (off, auto, auto, off, off, auto), every output
``torch.equal`` to the path's first run with the same kernel launches;
under ``auto`` every region of the DAG is dispatched once
(``fused_submits`` and ``fused_tasks`` equal to the partition's regions
and members, dispatches = tasks - fused tasks + regions, and on the pumps
no per-task interpreter entry); ``fusion`` lines print each path's
regions by kind, dispatches against tasks, the walls, host ms a task and
the ratio of the medians (``fusion_walls``).  A wall is the window a user
waits for: on the dynamic path add_taskpool to the end of wait(), on the
dpotrf and stencil pumps the executor's set-up (capture, partition and
plans) plus its run — the pumps' lines also print the median set-up at
each setting — and on the prefill pump the whole call.  The fused dpotrf
``kernels`` pump runs once more at stage depth 2 (the transfer lane
prestages supertasks), and the prefill once through
``run_flash_attention_native(..., fusion="auto")``.  The near-full stencil
pump runs once more with fusion ``auto`` (waves off), its grid equal to
the open card's.  ``--profile`` adds the fused dpotrf ``kernels`` and
stencil pumps.

The serving plane (``serve`` phase, after the trace stack): three tenants
on the card, built from the checkout's entry points — 16 decode jobs (8
query rows at the tail of a 4096-token causal sequence, Llama-2-7B's 32
heads x 128, 512-key blocks: 256 B5 launches each), the f32 prefill (1152
B5 launches) and the dpotrf ``kernels`` (680 B1 launches) — run alone
(the oracles), then through a ``RuntimeService`` (wdrr, at most 8 pools in
flight, the decodes 2 ms apart) with the flight recorder, the health
exporter on 127.0.0.1, the watchdog and the SLO plane on, scraped
throughout; every served output ``torch.equal`` to its solo run with its
launches exact; ``tools serve-status``, ``top --once``, ``flightdump``,
``read_pbt`` and ``critpath`` against the live endpoint; the turn with the
four switches off and on in turns (the observability cost, ``serve_obs``);
the same turn on ``lfq`` (the decodes' p50/p95 latency beside wdrr's); the
whole mix admitted at once on wdrr and on lfq (the decodes' share of the
scheduler's pops while the prefill has work, and the ready queue's depth);
the native serve executor over the prefill, the dpotrf and four decodes,
with their weights and with every weight 1 (the decodes retire earlier
with theirs), and a ``rebind`` that captures nothing.

The array front end (``array`` phase, after the serving plane): the
reference's acceptance program ``C = (A @ A.T + B).cholesky(); x =
C.solve(b)`` at N=8192 nb=512 f32 (b 8192 x 1024), one taskpool of 5726
tasks, run through ``DistArray.compute`` with every task on the CUDA
module, gated on the card in float64 (‖C·Cᵀ − S‖ and ‖C·x − b‖ under
1e-3, C's upper triangle exactly zero), then through the pump, a
``GraphExecutor`` (first call, five replays, a rebuilt program's cache
hit) and a ``RuntimeService`` tenant job, each ``torch.equal`` to the
dynamic run; the fused elementwise chain (fusion off and ``auto``
``torch.equal``), ``sum`` and ``norm`` against float64; the array
counters grown as counted and B1–B5 launched +0 over the phase (the
array's device bodies are library calls).

The cross-rank core (``multirank`` phase, after the array front end): N
ranks in one process, each a full ``Context`` over one ``InprocFabric``,
driven from a thread a rank, every rank's CUDA module on ``cuda:0``.  The
dpotrf at N=8192 nb=512 (``kernels`` and ``kernels_trtri`` at 4 ranks on
a 2x2 grid, ``kernels`` at 2 ranks on 1x2, the 4-rank DTD dpotrf and a
4-rank run under the four-counter termination detector), each factor
``torch.equal`` to the one-rank dynamic factor with B1 +680 (B2 +120),
every rank's ``bytes_in`` exactly its own home tiles and its
``bytes_d2d`` > 0 (cross-rank tiles land device-to-device); the array
program at 4 ranks, C and x ``torch.equal`` to the array phase's; a body
raising on rank 3 failing every rank within 60 s, each context then
running a fresh 4-rank dpotrf.  Its runs' B1/B2 launches join the
``kernels`` line.  The PTG runs go through ``parsec_tpu_torch.multirank.
run_multirank_perf``, the harness every multi-rank consumer shares.

The cross-rank readers (``multirank_obs`` lines, the end of the
``multirank`` phase): (a) the 4-rank ``kernels`` dpotrf through
``run_multirank_perf(4, ..., overlap=True, trace_dir=chip_scratch/...)``:
the factor ``torch.equal`` to the one-rank dynamic factor, B1 +680, each
rank's ``.pbt`` event count, the merged trace's four tracks, the clock
handshake's offsets and round trips, the per-rank overlap (host comm
instants against host submit spans) and critpath's split of each rank's
chain, and of its whole window, into exec and, outside exec, comm, coll,
compile, transfer and the rest; (b) the same
dpotrf with a strict ``Watchdog`` and a ``HealthServer`` on every rank (a
0.1 s poll, the window from ``runtime_watchdog_window``, the clock re-sync
every 0.5 s): no finding, every rank hears every peer, ranks 1-3 each
record a re-sync sample, and each rank's ``/metrics`` shows the
``parsec_comm_*`` families with ``wire_bytes`` equal to its engine's
bytes; (c) the distributed segmented Cholesky at 4 ranks, N=8192 nb=512
f32: err < 1e-3 against numpy's float64 factor, NT + NT(NT-1)/2 tasks,
``bytes_d2d`` > 0; (d) ``NativeGraph.run_noop`` over the dpotrf DAG's
shape (816 tasks), its tasks/s beside the pump's host ms a task.

The collectives, reshape and redistribution (``coll`` phase, after the
cross-rank readers; ``coll_phase``): 4 ranks over one ``InprocFabric``,
every rank's CUDA module on ``cuda:0``.  (a) allreduce ``sum`` (ring, rd,
gather) and ``max`` (ring), a reduce-scatter, an allgather and a bcast of
64 MiB CUDA tensors a rank: every result ``torch.equal`` across ranks and
to the same collective over host tensors, within 1e-5 of float64, a CUDA
tensor, the torch combines (``jit_reduces``) as the algorithm makes them;
(b) ``CollectiveTask.allreduce`` between two chores on the card; (c) the
4-rank dpotrf (B1 +680, its launches join the ``kernels`` line) left on
the card and redistributed to a 1x4 grid of 1024 x 1024 tiles through
``dtd``, through ``coll`` under a 32 MiB budget and through a misaligned
window, every tile ``torch.equal`` to the one-rank factor's and the peak
extra bytes within the budget; (d) the array phase's matrix at 4 ranks
redistributed, then ``sum`` and ``norm`` within 1e-9 of float64; (e) a
``[type=bfloat16]`` dep on a CUDA tile, at one rank and on a remote read,
cast on the card (``bytes_out`` 0); (f) a traced allreduce (one ``coll``
span, one ``coll_seg`` instant a landed segment, each rank) and one rank
3 withholds (ranks 0-2 time out within their bound, OBS007 names it; rank
3 joins late, every rank holds the sum, a fresh allreduce follows).

The TCP backend and the launcher (``tcp`` phase, after ``coll``;
``tcp_phase``): the script runs itself as 4 rank processes
(``parsec_tpu_torch.comm.launch``, ``chip_smoke.py --tcp-rank``, one
launch), each a ``Context`` over its ``TCPComm`` with its CUDA module on
``cuda:0`` under a 4096 MB zone budget; the parent hands them S and the
one-rank factors through ``chip_scratch/tcp/``.  (a) dpotrf ``kernels``
and ``kernels_trtri`` on a 2x2 grid, every local tile ``torch.equal`` to
the one-rank factor, B1/B2 launches summed over the ranks equal to one
rank's mode by mode (they join the ``kernels`` line), activations equal to
the in-process 4-rank run's, ``bytes_d2d`` 0 and ``bytes_in`` each rank's
own tiles plus the bytes it pulled (a tile leaves by one D2H and arrives
by one H2D); (b) a ring ``sum`` allreduce of a 64 MiB CUDA tensor, the
result a tensor on the card bit-identical on every rank and to the same
contributions' host run; (c) ``NativeDistExecutor`` on host bodies at
N=4096, then ``rebind``, each ``torch.equal`` to the parent's one-rank
host run.  The 4-process dpotrf wall is printed beside the in-process
4-rank wall of the ``multirank`` phase.

The SPMD layer and the ring graphs (``parallel`` phase, after ``tcp``;
``parallel_phase``): one process drives a mesh of 4 positions on
``cuda:0``, a thread a position (``parallel.make_mesh((4, 1),
devices=[dev] * 4)``).  (a) ``ring_attention`` at the prefill's width
(B=1, S=4096, H=32, D=128: four 1024-row blocks), causal f32 and bf16
with ``use_kernels`` (16 batched B5 launches of 32 members each, counted;
the f32 run twice, ``torch.equal``), f32 without, and non-causal f32
with, each within 2e-5 (bf16 5e-2) of ``attention_reference`` in
float64; (b) ``run_ring_attention_graph`` over 4 in-process ranks, every
rank's CUDA module on ``cuda:0``: causal f32 (640 tasks, 512 single B5
launches) ``torch.equal`` to (a)'s f32 ``use_kernels`` output, and the
``bcast`` variant non-causal within 2e-5 of the oracle and of (a); each
rank's wire bytes exactly the other ranks' K and V planes; (c)
``ulysses_attention``; (d) on a 2x2 mesh ``spmd_cholesky`` of S (N=8192,
nb=512) within the dpotrf gate beside the unsharded run, ``summa_gemm``
and (4x1) ``ring_gemm`` at 8192^2 against ``torch.matmul``, and
``spmd_stencil_5pt`` on 8192^2 x 20 steps against the plain stencil; (e)
a position that raises: the call raises within 5 s, the next call
passes; then B5 at the ring's block, single f32 and batched f32 and bf16
over 32 members, against their plain versions, timed, with their bounds.
Its B5 launches join the kernel table.

The tutorial examples (``examples`` phase, after ``parallel``;
``examples_phase``): every module of ``parsec_tpu_torch.examples`` (ex00
to ex14 and ``dtd/``) through its ``main(device="cuda")`` at its own
defaults, each with its wall and launches (``examples`` lines): ex10's
8-position ring with ``use_kernels`` makes 64 batched B5 launches of 16
members, within 1e-4 of its einsum ring; ex11's kernel chores under a
``GraphExecutor`` make 10 B1 f32 launches a replay, 20 in the first call;
ex12 runs its device-body QR and LU.  Then ex08 and ex11 part 1 at
N=8192 nb=512 on the dpotrf path's S: ex11 without kernels
``torch.equal`` to ex08, with kernels (680 B1 launches a replay)
``torch.equal`` to the dynamic ``kernels`` factor and within 1e-3 of the
run without.  Its B1 and B5 launches join the kernel table.

Every run of the CUDA device module must end with no synchronous
write-back fallback (``wb_sync_fallbacks == 0``) and no wave that fell
back to per-task dispatch (``wave_fallbacks == 0``).  Kernel launches
inside captured CUDA graphs count at each replay, so every launch check
stays exact.

Kernel times are device times: the timed launches are queued behind a
spin kernel sized to outlast their enqueue, so the CUDA events measure
back-to-back execution, not the host's launch rate.

Any failed check raises, and the script exits non-zero.  Without a GPU, or
without the port beside it, it exits non-zero before printing a result.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

N, NB = 8192, 512          # bench.py's accelerator configuration
TILE = (512, 512, 512)     # (m, n, k) of every update on the main path
RAGGED = (500, 300, 200)
TINY = (64, 64, 16)        # one slab of one output tile
UNALIGNED = (130, 70, 37)  # row pitches that are not 16-byte multiples
SHAPES = (TILE, RAGGED, TINY, UNALIGNED)
# the B1/B2 modes the dense factorizations give callers, each timed at its
# caller's shape beside the tile rows: split_f32 at a segmented-LU strip
# (the first trailing strip at N=16384 nb=512, strip 4096) and B2 at
# tiled QR's tsmqr ((2nb x 2nb) Q^T times the stacked (2nb x nb) tiles),
# and B2 bf16 at latent attention's kv_up
#
# latent attention (DeepSeek-V2-Lite's config.json, ops/mla.py): q/k 192
# (128 + 64 rotary) against v 128, latent 512, 16 heads, in the benchmark
# MLA cell's 8192-row blocks; the pump run is one job at MLA_S tokens
MLA_D, MLA_DV, MLA_L, MLA_H, MLA_BLOCK, MLA_S = 192, 128, 512, 16, 8192, 16384
# the MLA cell's configuration (its YaRN scaling gives the softmax scale)
# and its limits file (the pump job is judged by the cell's own limit)
MLA_CONFIG = os.path.join("benchmark", "configs", "prefill_deepseek-v2-lite.json")
MLA_LIMITS = os.path.join("benchmark", "limits", "prefill_deepseek-v2-lite.s65536-b8192.json")
CALLER_SHAPES = {("matmul_update", "split_nt"): (15872, 4096, 512),
                 ("matmul", "f32_nt"): (1024, 512, 1024),
                 # latent attention's kv_up: an 8192-token latent block
                 # times one head's 128 key (or value) rows of kv_b_proj
                 ("matmul", "bf16"): (MLA_BLOCK, MLA_DV, MLA_L)}
TOL_F32, TOL_BF16, TOL_SPLIT_F64 = 1e-4, 1e-3, 1e-5
# B2 with bfloat16 output rounds the f32 sum once: one bf16 ulp at the
# largest element
TOL_BF16_OUT = 2.0 ** -7
# the f32 modes against float64 at the tile: at most this many times the
# plain version's (cuBLAS FP32) error
F64_GATE_FACTOR = 2.0
# B5, tests/runtime/test_pallas_kernels.py's tolerance (B3/B4 are held
# bit-identical to their plain versions)
TOL_ATTN = 1e-4

# attention path: Llama-2-7B's attention layer (Hugging Face
# meta-llama/Llama-2-7b-hf config.json: 32 heads, hidden 4096 -> head_dim
# 128, 4096 positions), B=1, in the kernel's own default 512-row blocks;
# the decode step puts 96 queries at the tail of 4000 keys
ATTN_B, ATTN_S, ATTN_H, ATTN_D, ATTN_BLOCK = 1, 4096, 32, 128, 512
DEC_SQ, DEC_SK = 96, 4000
# tests/runtime/test_attention_graph.py's bounds (allclose form: atol and
# rtol both the bound)
TOL_ATTN_F32, TOL_ATTN_BF16 = 2e-5, 5e-2
# stencil path: an 8192^2 float32 grid in 8 x 8 tiles of 1024^2, 20 steps;
# the fused kernel on the leading 2048^2 block for 100 steps
ST_N, ST_TILES, ST_T = 8192, 8, 20
FUSED_N, FUSED_ITERS = 2048, 100
TOL_STENCIL_PATH = 1e-5
# the stage depths each path runs at, in this order: three runs a depth in
# turns (A B B A A B) so that a drift over the run weighs on both depths
# alike, compared by their medians; the first at the default depth 1
STAGE_DEPTHS = (1, 2, 2, 1, 1, 2)
# wave batching on (the reference's minimum wave, 2) and off, in turns (on,
# off, off, on, on, off), each path at stage depth 1
WAVES = (2, 0, 0, 2, 2, 0)
# supertask fusion (runtime_fusion) off and auto, in turns (off, auto, auto,
# off, off, auto), each path at stage depth 1 with waves off
FUSION = ("off", "auto", "auto", "off", "off", "auto")
# GraphExecutor replays timed a path, as bench.py's graph path times them
GRAPH_REPLAYS = 5
# the front-ends phase: DTD's insertion window (below dpotrf's task count:
# the inserting thread runs tasks), the size of the scheduler sweep and
# the twelve schedulers, lfq (the default) first
FE_WINDOW, FE_SCHED_N = 64, 4096
FE_SCHEDULERS = ("lfq", "gd", "ap", "ll", "rnd", "spq", "llp", "ltq", "pbq",
                 "lhq", "ip", "wdrr")
# the near-full stencil pump run: a 16384^2 grid (2 GiB of tiles, both
# buffers) for this many steps, on a card a ballast tensor has left this
# many MB free: the automatic budget (about 1.4 GiB) then falls below them
NEAR_FULL_STEPS, NEAR_FULL_MB = 4, 2560

#: dense peaks from NVIDIA's data sheets: FP32 and FP64 on the CUDA cores,
#: BF16 and TF32 on the tensor cores, and device-memory bandwidth.  The SXM row is
#: the default; a card whose name says PCIe takes the PCIe row.
PEAKS = {
    "sxm": {"f32": 67e12, "f64": 34e12, "bf16": 989e12, "tf32": 495e12,
            "bytes": 3.35e12},
    "pcie": {"f32": 51e12, "f64": 26e12, "bf16": 756e12, "tf32": 378e12,
             "bytes": 2.0e12},
}


def say(tag: str, **fields) -> None:
    print(f"{tag} " + json.dumps(fields, sort_keys=True), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


@contextlib.contextmanager
def mca(mca_param, framework: str, name: str, value):
    """Run the block with the MCA param ``<framework>_<name>`` at ``value``
    (stage depth, wave batch and budget are read when a device module is
    built: a Context, or a NativeExecutor's own)."""
    mca_param.set_param(framework, name, value)
    try:
        yield
    finally:
        mca_param.unset(framework, name)


class ABWalls:
    """Each path's walls at two settings of one knob, from this run: one
    ``tag`` line a path with both settings' walls and the ratio of their
    medians, ``b`` over ``a``; ``a`` and ``b`` are (label, setting)."""

    def __init__(self, tag: str, a, b):
        self.tag, self.a, self.b = tag, a, b
        self.walls = {}

    def add(self, path: str, setting, wall: float) -> None:
        self.walls.setdefault(path, {self.a[1]: [], self.b[1]: []})[setting].append(wall)

    def report(self) -> None:
        for path, by_setting in self.walls.items():
            fields = {}
            for label, setting in (self.a, self.b):
                fields[f"{label}_s"] = by_setting[setting]
                fields[f"median_{label}_s"] = statistics.median(by_setting[setting])
            fields[f"{self.b[0]}_over_{self.a[0]}"] = \
                fields[f"median_{self.b[0]}_s"] / fields[f"median_{self.a[0]}_s"]
            say(self.tag, path=path, **fields)


WAVE_KEYS = ("wave_submits", "wave_tasks", "wave_graphs", "wave_capture_s",
             "wave_copy_bytes", "wave_graph_bytes", "wave_fallbacks", "oom_reliefs",
             "fused_submits", "fused_tasks")


def device_stats(dev, **extra) -> dict:
    """A CUDA device module's counters after a run, with its pinned bytes;
    fails the run if a wave fell back to per-task dispatch."""
    stats = dict(dev.stats, mem_budget=dev.mem_budget, **extra)
    stats["pinned_bytes"], stats["pinned_peak_bytes"] = dev.pinned_bytes
    check(stats["wave_fallbacks"] == 0,
          f"{stats['wave_fallbacks']} wave(s) fell back to per-task dispatch")
    return stats


def pipeline_fields(stats) -> dict:
    """The staging counters of a run's :func:`device_stats`."""
    keys = ("bytes_in", "bytes_out", "h2d_copies", "d2h_copies", "prefetched_tiles",
            "stage_batched_tiles", "wb_batches", "wb_sync_fallbacks", "wb_committed",
            "wb_dropped_stale", "wb_capacity_waits", "wb_drains", "wb_drain_s",
            "prestage_s", "evictions", "pinned_bytes", "pinned_peak_bytes", "flush_s",
            "detach_s", "lane_wait_s", "submit_s", "retire_s") + WAVE_KEYS
    return {k: stats[k] for k in keys if k in stats}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


# -- the other front ends: DTD, JDF and jdfc; the scheduler family ----------

def front_ends_phase(h):
    """Tiled dpotrf (N=8192 nb=512 f32, the dpotrf path's SPD matrix)
    inserted through DTD and compiled from the port's ``cholesky.jdf``, on
    the CUDA device module with the B1 and B2 kernels.

    DTD: the right-looking loop (``ops.insert_dpotrf``: potrf, trsm, syrk,
    gemm in k order, each class with a CPU and a CUDA body) in the
    ``kernels``, ``kernels_trtri`` and ``kernels_bf16`` variants, with an
    insertion window of ``FE_WINDOW`` tasks (the inserting thread runs
    tasks itself once it fills).  JDF: dynamic on ``Context``, through the
    pump and as a ``GraphExecutor`` replay, and once more as a module
    ``jdfc`` generated from the file.  Every factor ``torch.equal`` to the
    PTG's on the same path (the dynamic factor, which the pump and graph
    phases held their own factors to), every run on the CUDA module only,
    with the PTG's launches per mode.  Then DTD ``kernels`` at
    N=``FE_SCHED_N`` under each of the twelve schedulers, and ``spq`` and
    ``wdrr`` with ``sched_native_queue=1``, each factor ``torch.equal`` to
    ``lfq``'s and to the PTG's at that size.  ``h`` carries main's
    helpers and the dpotrf path's state; each run's launches go into
    ``h.launches`` (the kernel table's counts)."""
    np, torch, dev, card, say, check = h.np, h.torch, h.dev, h.card, h.say, h.check
    from parsec_tpu_torch import Context, mca_param
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.dsl import DTDTaskpool, GraphExecutor, compile_jdf_file, jdfc
    from parsec_tpu_torch.dsl.native_exec import NativeExecutor
    from parsec_tpu_torch.ops import cholesky_ptg, dpotrf_task_count, insert_dpotrf, kernels

    jdf_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "parsec_tpu_torch", "examples", "jdf", "cholesky.jdf")

    def counts():
        return {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                for fn in (kernels.matmul_update, kernels.matmul)}

    def cuda_module(ctx):
        d = next(d for d in ctx.devices if d.mca_name == "cuda")
        check(d.tdev.type == "cuda", f"CUDA module bound to {d.tdev}")
        return d

    def equal(A, ref, label):
        check(torch.equal(torch.from_numpy(A.to_array()), torch.from_numpy(ref)),
              f"{label}: the factor differs from the PTG's")

    def run_context(S_in, fill, sched=None):
        """One run on a fresh Context: ``fill(ctx, A)`` inserts or attaches
        and returns (taskpool, tasks, finish), ``finish()`` ending the
        window; the wall is fill + finish + synchronize.  The factor comes
        home after the window (DTD: ``flush_all``; ``ctx.fini()``)."""
        n_in = S_in.shape[0]
        A = TiledMatrix(n_in, n_in, NB, NB, name="A", dtype=np.float32).from_array(S_in)
        ctx = Context(scheduler=sched)
        try:
            cdev = cuda_module(ctx)
            check(ctx.scheduler.mca_name == (sched or "lfq"),
                  f"scheduler {ctx.scheduler.mca_name}, asked for {sched}")
            kernels.reset_counts()
            gc.collect()
            t0 = time.perf_counter()
            tp, ntasks, finish = fill(ctx, A)
            ok = finish()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = counts()
            if isinstance(tp, DTDTaskpool):
                tp.flush_all()
                tp.close()
                ok = ok and ctx.wait(timeout=600)
        finally:
            ctx.fini()
        check(ok and not tp.failed, f"taskpool failed ({tp.fail_reason})")
        stats = device_stats(cdev)
        check(stats["executed_tasks"] == ntasks,
              f"{stats['executed_tasks']} tasks on the CUDA module, expected {ntasks}")
        check(stats["wb_sync_fallbacks"] == 0, "synchronous write-back fallbacks")
        return A, ntasks, wall, c, stats

    def dtd(kw):
        def fill(ctx, A):
            tp = DTDTaskpool(ctx)
            n = insert_dpotrf(tp, A, **kw)
            return tp, n, lambda: tp.wait(timeout=600)
        return fill

    def ptg_fill(tp_of):
        def fill(ctx, A):
            tp = tp_of(A)
            ctx.add_taskpool(tp)
            return tp, dpotrf_task_count(A.mt), lambda: tp.wait(timeout=600)
        return fill

    nt = N // NB
    # -- DTD, the three variants ---------------------------------------------
    with mca(mca_param, "dtd", "window_size", FE_WINDOW), \
            mca(mca_param, "dtd", "threshold_size", FE_WINDOW // 2):
        for name, kw, _tol in h.variants:
            ntasks = dpotrf_task_count(nt, use_trtri=kw.get("use_trtri", False))
            check(ntasks > FE_WINDOW, "the window must be below the task count")
            A, n, wall, c, stats = run_context(h.S, dtd(kw))
            check(n == ntasks, f"dtd {name}: {n} tasks inserted, expected {ntasks}")
            check(c == h.launches[name], f"dtd {name}: launches {c}, the PTG's "
                  f"{h.launches[name]}")
            equal(A, h.dyn_factor[name], f"dtd {name}")
            h.launches[f"dtd_{name}"] = c
            say("front_ends", path="dtd", variant=name, N=N, nb=NB, tasks=ntasks,
                window=FE_WINDOW, wall_s=wall, tasks_per_s=ntasks / wall,
                ptg_wall_s=h.dyn_wall[name], ptg_tasks_per_s=ntasks / h.dyn_wall[name],
                launches=c, equal_ptg=True, card=card, **pipeline_fields(stats))
            del A

    # -- JDF: dynamic, pump, graph, and a jdfc-generated module ----------------
    ntasks = dpotrf_task_count(nt)
    want = h.launches["kernels"]
    jdf = compile_jdf_file(jdf_path)
    A, _n, wall, c, stats = run_context(h.S, ptg_fill(
        lambda A: jdf.new(A=A, NT=A.mt, KERNELS=1)))
    check(c == want, f"jdf dynamic: launches {c}, the PTG's {want}")
    equal(A, h.dyn_factor["kernels"], "jdf dynamic")
    h.launches["jdf_dynamic"] = c
    say("front_ends", path="jdf_dynamic", variant="kernels", N=N, nb=NB, tasks=ntasks,
        wall_s=wall, tasks_per_s=ntasks / wall, ptg_wall_s=h.dyn_wall["kernels"],
        launches=c, equal_ptg=True, card=card, **pipeline_fields(stats))

    A = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(h.S)
    tp = jdf.new(A=A, NT=A.mt, KERNELS=1)
    gc.collect()
    t0 = time.perf_counter()
    ex = NativeExecutor(tp, native_device=True)
    setup = time.perf_counter() - t0
    try:
        check(ex.device.tdev.type == "cuda", f"pump device bound to {ex.device.tdev}")
        kernels.reset_counts()
        t0 = time.perf_counter()
        ran = ex.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
    finally:
        ex.close()
    check(ran == ntasks, f"jdf pump: ran {ran} tasks, expected {ntasks}")
    check(c == want, f"jdf pump: launches {c}, the PTG's {want}")
    equal(A, h.dyn_factor["kernels"], "jdf pump")
    h.launches["jdf_pump"] = c
    pump = h.depth_walls.walls.get("dpotrf kernels pump")
    say("front_ends", path="jdf_pump", variant="kernels", N=N, nb=NB, tasks=ntasks,
        setup_s=setup, wall_s=wall, tasks_per_s=ntasks / wall,
        ptg_pump_median_depth1_s=statistics.median(pump[1]) if pump else None,
        launches=c, equal_ptg=True, card=card)

    A = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(h.S)
    ex = GraphExecutor(jdf.new(A=A, NT=A.mt, KERNELS=1))
    check(ex.device.type == "cuda", f"GraphExecutor bound to {ex.device}")
    feeds = {k: torch.from_numpy(A.data_of(*k[1]).newest_copy().payload).to(dev)
             for k in ex.input_keys}
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ex.apply(feeds)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    c = counts()
    # the first call: an eager warm-up and one replay, each launching what
    # one dynamic run launches
    want2 = {fn: {mode: 2 * n for mode, n in by_mode.items()} for fn, by_mode in want.items()}
    check(c == want2, f"jdf graph: launches {c}, expected {want2}")
    fac = torch.from_numpy(h.dyn_factor["kernels"]).to(dev)
    for (_c, (m, n)), tile in out.items():
        check(torch.equal(tile, fac[m * NB:(m + 1) * NB, n * NB:(n + 1) * NB]),
              f"jdf graph: tile ({m}, {n}) differs from the PTG's factor")
    h.launches["jdf_graph"] = c
    say("front_ends", path="jdf_graph", variant="kernels", N=N, nb=NB, tasks=ntasks,
        first_call_s=first_s, capture_s=ex.capture_s,
        ptg_first_call_s=h.first_calls.get(("dpotrf_kernels", False)),
        launches=c, equal_ptg=True, card=card)
    del ex, feeds, out, fac, A

    gen_dir = tempfile.mkdtemp(prefix="chip_smoke_jdfc_")
    try:
        gen_py = os.path.join(gen_dir, "cholesky_ptg.py")
        check(jdfc.main([jdf_path, "-o", gen_py]) == 0, "jdfc failed")
        import importlib.util

        spec = importlib.util.spec_from_file_location("cholesky_ptg_generated", gen_py)
        gen = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gen)
    finally:
        shutil.rmtree(gen_dir, True)
    A, _n, wall, c, stats = run_context(h.S, ptg_fill(
        lambda A: gen.new(A=A, NT=A.mt, KERNELS=1)))
    check(c == want, f"jdfc module: launches {c}, the PTG's {want}")
    equal(A, h.dyn_factor["kernels"], "jdfc module")
    h.launches["jdfc_dynamic"] = c
    say("front_ends", path="jdfc_dynamic", variant="kernels", N=N, nb=NB, tasks=ntasks,
        wall_s=wall, tasks_per_s=ntasks / wall, ptg_wall_s=h.dyn_wall["kernels"],
        launches=c, equal_ptg=True, card=card)
    del A

    # -- the scheduler family: DTD dpotrf kernels at FE_SCHED_N ----------------
    n_s = FE_SCHED_N
    S_s = np.ascontiguousarray(h.S[:n_s, :n_s])  # a leading block: SPD
    ntasks = dpotrf_task_count(n_s // NB)
    A, _n, ptg_wall, ptg_c, _stats = run_context(S_s, ptg_fill(
        lambda A: cholesky_ptg(use_cuda=True, use_cpu=False,
                               use_kernels=True).taskpool(NT=A.mt, A=A)))
    ptg_factor = A.to_array()
    h.launches["sched_ptg"] = ptg_c
    walls = {}
    lfq_factor = None
    runs = [(s, 0) for s in FE_SCHEDULERS] + [("spq", 1), ("wdrr", 1)]
    with mca(mca_param, "dtd", "window_size", FE_WINDOW), \
            mca(mca_param, "dtd", "threshold_size", FE_WINDOW // 2):
        for sched, nq in runs:
            with mca(mca_param, "sched", "native_queue", nq):
                A, n, wall, c, stats = run_context(S_s, dtd(dict(use_kernels=True)), sched)
            check(n == ntasks, f"dtd under {sched}: {n} tasks inserted")
            check(c == ptg_c, f"dtd under {sched}: launches {c}, the PTG's {ptg_c}")
            factor = A.to_array()
            check(torch.equal(torch.from_numpy(factor), torch.from_numpy(ptg_factor)),
                  f"dtd under {sched} (native queue {nq}): the factor differs from "
                  "the PTG's")
            if lfq_factor is None:
                lfq_factor = factor
            check(torch.equal(torch.from_numpy(factor), torch.from_numpy(lfq_factor)),
                  f"dtd under {sched} (native queue {nq}): the factor differs from lfq's")
            label = sched + ("_native_queue" if nq else "")
            h.launches[f"sched_{label}"] = c
            walls[label] = wall
            say("front_ends", path="dtd_sched", scheduler=sched, native_queue=nq,
                N=n_s, nb=NB, tasks=ntasks, wall_s=wall, tasks_per_s=ntasks / wall,
                ptg_wall_s=ptg_wall, launches=c, equal_lfq=True, equal_ptg=True,
                card=card)
            del A, factor
    say("front_ends_sched_walls", N=n_s, nb=NB, tasks=ntasks, ptg_lfq_wall_s=ptg_wall,
        walls_s=walls, card=card)


# -- level-batched whole-DAG replays (GraphExecutor(batch_levels=True)) -------

def legacy_async_phase(h):
    """Tiled dpotrf (N=8192 nb=512 f32, the dpotrf path's SPD matrix)
    through the legacy ASYNC-chore protocol and a mixed CPU/GPU DAG, and
    the rest of the single-card core on the same matrix.

    ``kernels`` and ``kernels_trtri`` through ``NativeExecutor(tp,
    native_device=True)`` three times each in one stretch: the pump, then
    ``runtime_native_sched=off``, then ``device_cuda_eager_complete=0``
    (both the legacy protocol: native workers enter the trampoline once a
    task and hand it to the CUDA module, whose completion callback calls
    ``task_done``).  Each legacy factor ``torch.equal`` to the pump's, the
    same B1/B2 launches per mode (680 B1, and 120 B2 with ``trtri``), one
    trampoline entry and one completion callback a task, every task on the
    CUDA module.  Then the mixed DAG: ``cholesky_ptg(use_kernels=True)``
    with the ``potrf`` class's CUDA body taken away, so its 16 tasks run on
    the host (``_make_cpu_data_body``) and the other 800 on the card;
    within 1e-3 of the pump's factor (PERF.md §2's gate), 680 B1
    launches, and the host versions of the diagonal tiles kept through the
    device's detach.  Then the dynamic path with
    ``runtime_dep_storage=dense`` and with ``runtime_vpmap=nb:2`` and the
    pump with ``nb:2``, each factor ``torch.equal`` to the hash/flat
    run's; in the dense run, while its tiles are newest on the card, a
    ``checkpoint.save`` of the factor and ``diag_band_to_rect`` of it; the
    checkpoint restored into a fresh collection in a new ``Context``,
    ``np.array_equal`` to the factor, and the band equal to its host
    reference.  ``h`` carries main's helpers and the dpotrf path's state;
    every run's launches go into ``h.launches``."""
    np, torch, dev, card, say, check = h.np, h.torch, h.dev, h.card, h.say, h.check
    S = h.S
    from parsec_tpu_torch import Context, mca_param
    from parsec_tpu_torch.core.lifecycle import DEV_CUDA
    from parsec_tpu_torch.data import checkpoint
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.datadist.band import (diag_band_to_rect_ptg,
                                                diag_band_to_rect_reference)
    from parsec_tpu_torch.dsl.native_exec import NativeExecutor
    from parsec_tpu_torch.ops import cholesky_ptg, dpotrf_task_count, kernels

    nt = N // NB
    t_phase = time.perf_counter()

    def counts():
        return {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                for fn in (kernels.matmul_update, kernels.matmul)}

    def native(kw, mixed=False):
        """One dpotrf through NativeExecutor(native_device=True) under the
        MCA params in force; the wall is ex.run() + synchronize, set-up
        (capture + build) apart.  Returns the matrix, tasks, wall, set-up,
        launches, stats and — for the mixed DAG — the diagonal tiles' host
        versions and values before the detach."""
        A = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(S)
        ptg = cholesky_ptg(use_cuda=True, use_cpu=mixed, **kw)
        if mixed:
            del ptg.classes["potrf"].bodies[DEV_CUDA]
        tp = ptg.taskpool(NT=nt, A=A)
        gc.collect()
        t0 = time.perf_counter()
        ex = NativeExecutor(tp, native_device=True)
        setup = time.perf_counter() - t0
        diag = None
        try:
            check(ex.device.tdev.type == "cuda", f"native device bound to {ex.device.tdev}")
            kernels.reset_counts()
            t0 = time.perf_counter()
            ran = ex.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = counts()
            stats = dict(ex.stats, pump=ex._pump)
            if mixed:
                diag = {k: (A.data_of(k, k).get_copy(0).version,
                            np.array(A.data_of(k, k).get_copy(0).payload),
                            A.data_of(k, k).newest_copy().device_index)
                        for k in range(nt)}
        finally:
            t0 = time.perf_counter()
            ex.close()
            flush = time.perf_counter() - t0
        stats.update(device_stats(ex.device, flush_s=flush))
        check(stats["wb_sync_fallbacks"] == 0, "synchronous write-back fallbacks")
        return A, ran, wall, setup, c, stats, diag

    def factor_errs(factor, ref_factor):
        """||LL^T - S||max/||S||max and the last tile's max error relative
        to the reference factor's, in float64 on the card."""
        L = torch.from_numpy(factor).to(dev).double().tril()
        recon = ((L @ L.mT - h.S64).abs().max() / h.s_max).item()
        ref_last = torch.from_numpy(ref_factor[-NB:, -NB:]).to(dev).double().tril()
        last = ((L[-NB:, -NB:] - ref_last).abs().max() / ref_last.abs().max()).item()
        del L
        return recon, last

    pump_factor = {}
    for name, kw, _tol in h.variants[:2]:
        trtri = kw.get("use_trtri", False)
        ntasks = dpotrf_task_count(nt, use_trtri=trtri)
        n_upd = nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
        n_mm = nt * (nt - 1) // 2 if trtri else 0
        A, ran, p_wall, p_setup, p_counts, p_stats, _ = native(kw)
        check(p_stats["pump"] and ran == ntasks
              and p_stats["trampoline_entries"] == p_stats["completion_callbacks"] == 0,
              f"legacy_async {name}: the pump run ({ran} tasks, {p_stats})")
        check(p_counts["matmul_update"]["total"] == n_upd and
              p_counts["matmul"]["total"] == n_mm,
              f"legacy_async {name}: pump launches {p_counts}")
        pump_factor[name] = A.to_array()
        check(np.array_equal(pump_factor[name], h.dyn_factor[name]),
              f"legacy_async {name}: the pump's factor differs from the dynamic path's")
        h.launches[f"legacy_pump_{name}"] = p_counts
        for protocol, param in (("native_sched_off", ("runtime", "native_sched", "off")),
                                ("eager_complete_0", ("device", "cuda_eager_complete", 0))):
            with mca(mca_param, *param):
                A, ran, wall, setup, c, stats, _ = native(kw)
            label = f"legacy_async {name} {protocol}"
            check(not stats["pump"] and ran == ntasks, f"{label}: pump={stats['pump']}, "
                  f"{ran} tasks")
            check(torch.equal(torch.from_numpy(A.to_array()),
                              torch.from_numpy(pump_factor[name])),
                  f"{label}: the factor differs from the pump's")
            check(c == p_counts, f"{label}: launches {c}, the pump's {p_counts}")
            check(stats["trampoline_entries"] == stats["completion_callbacks"] == ntasks,
                  f"{label}: {stats['trampoline_entries']} trampoline entries and "
                  f"{stats['completion_callbacks']} completion callbacks, "
                  f"expected {ntasks} each")
            check(stats["executed_tasks"] == ntasks and stats["pop_batches"] == 0,
                  f"{label}: {stats['executed_tasks']} tasks on the CUDA module")
            h.launches[f"legacy_{name}_{protocol}"] = c
            say("legacy_async", variant=name, protocol=protocol, N=N, nb=NB, tasks=ran,
                wall_s=wall, setup_s=setup, pump_wall_s=p_wall, pump_setup_s=p_setup,
                wall_over_pump=wall / p_wall,
                setup_plus_wall_over_pump=(setup + wall) / (p_setup + p_wall),
                host_ms_per_task=wall / ran * 1e3,
                pump_host_ms_per_task=p_wall / ran * 1e3,
                trampoline_entries=stats["trampoline_entries"],
                completion_callbacks=stats["completion_callbacks"], launches=c,
                equal_pump=True, card=card, **pipeline_fields(stats))

    # -- the mixed DAG: potrf on the host, the rest on the card -----------------
    ntasks = dpotrf_task_count(nt)
    A, ran, wall, setup, c, stats, diag = native(dict(use_kernels=True), mixed=True)
    check(not stats["pump"] and ran == ntasks, f"mixed: pump={stats['pump']}, {ran} tasks")
    check(c["matmul_update"]["total"] == nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
          and c["matmul"]["total"] == 0, f"mixed: launches {c}")
    check(stats["trampoline_entries"] == ntasks
          and stats["completion_callbacks"] == stats["executed_tasks"] == ntasks - nt,
          f"mixed: {stats['trampoline_entries']} entries, {stats['completion_callbacks']} "
          f"callbacks, {stats['executed_tasks']} tasks on the CUDA module")
    for k, (version, tile, where) in diag.items():
        home = A.data_of(k, k).get_copy(0)
        check(where == 0 and home.version == version and np.array_equal(home.payload, tile),
              f"mixed: the host version of potrf tile {k} did not survive the detach")
    mixed_factor = A.to_array()
    recon, last = factor_errs(mixed_factor, pump_factor["kernels"])
    check(recon < 1e-3 and last < 1e-3,
          f"mixed: ||LL^T-S||max/||S||max {recon}, last tile {last} (gate 1e-3)")
    h.launches["legacy_mixed"] = c
    say("legacy_async", variant="kernels", protocol="mixed_host_potrf", N=N, nb=NB,
        tasks=ran, host_tasks=nt, wall_s=wall, setup_s=setup,
        pump_wall_s=None, recon_err=recon, last_tile_err_vs_pump=last,
        max_abs_diff_vs_pump=float(np.abs(mixed_factor - pump_factor["kernels"]).max()),
        trampoline_entries=stats["trampoline_entries"],
        completion_callbacks=stats["completion_callbacks"], launches=c, card=card,
        **pipeline_fields(stats))
    del mixed_factor

    # -- the single-card core: dense storage, vpmaps, checkpoint, band ------------
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ck_")
    try:
        path = os.path.join(ckdir, "factor")
        walls = {}
        for label, param in (("dense", ("runtime", "dep_storage", "dense")),
                             ("vpmap_nb2", ("runtime", "vpmap", "nb:2"))):
            A = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(S)
            with mca(mca_param, *param):
                ctx = Context()
                try:
                    tp = cholesky_ptg(use_cuda=True, use_cpu=False,
                                      use_kernels=True).taskpool(NT=nt, A=A)
                    kernels.reset_counts()
                    gc.collect()
                    t0 = time.perf_counter()
                    ctx.add_taskpool(tp)
                    ok = tp.wait(timeout=600)
                    torch.cuda.synchronize()
                    walls[label] = time.perf_counter() - t0
                    c = counts()
                    check(ok, f"{label}: taskpool failed ({tp.fail_reason})")
                    if label == "dense":
                        check(type(tp.deps).__name__ == "DenseDepTracker" and tp._counted,
                              "dense: the PTG did not take the dense storage")
                    else:
                        check(ctx.vpmap.nb_vps() == 2, f"vpmap: {ctx.vpmap.vps}")
                    if label == "dense":
                        # the factor's tiles (the lower triangle) are newest
                        # on the card here
                        on_card = sum(A.data_of(i, j).newest_copy().device_index != 0
                                      for (i, j) in A.local_tiles() if i >= j)
                        check(on_card == nt * (nt + 1) // 2,
                              f"checkpoint: {on_card} factor tiles device-newest")
                        t0 = time.perf_counter()
                        checkpoint.save(path, A, meta={"N": N, "nb": NB})
                        save_s = time.perf_counter() - t0
                        Bb = TiledMatrix(NB + 1, nt * (NB + 2), NB + 1, NB + 2, name="B",
                                         dtype=np.float32)
                        t0 = time.perf_counter()
                        tpb = diag_band_to_rect_ptg(NB, NB).taskpool(NT=nt, A=A, B=Bb)
                        ctx.add_taskpool(tpb)
                        check(tpb.wait(timeout=600), f"band: failed ({tpb.fail_reason})")
                        band_s = time.perf_counter() - t0
                finally:
                    ctx.fini()
            check(torch.equal(torch.from_numpy(A.to_array()),
                              torch.from_numpy(h.dyn_factor["kernels"])),
                  f"{label}: the factor differs from the hash/flat dynamic run's")
            check(c == h.launches["kernels"], f"{label}: launches {c}, "
                  f"the hash/flat run's {h.launches['kernels']}")
            h.launches[f"core_{label}"] = c
            say("single_card_core", path="dpotrf kernels dynamic", run=label, N=N, nb=NB,
                wall_s=walls[label], hash_flat_wall_s=h.dyn_wall["kernels"],
                equal_hash_flat=True, launches=c, card=card)
        factor = h.dyn_factor["kernels"]
        band_ref = diag_band_to_rect_reference(factor, NB, NB, nt)
        check(np.array_equal(Bb.to_array(), band_ref),
              "band: diag_band_to_rect of the device-newest factor differs from the "
              "host reference")
        # the checkpoint, restored into a fresh collection in a new Context
        B = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32)
        with Context():
            t0 = time.perf_counter()
            n_tiles = checkpoint.restore(path, B)
            restore_s = time.perf_counter() - t0
        check(n_tiles == len(list(B.local_tiles())), f"restore: {n_tiles} tiles")
        check(np.array_equal(B.to_array(), factor),
              "checkpoint: the restored factor differs from the factor")
        shard_mb = os.path.getsize(path + ".rank0.npz") / 2 ** 20
        say("single_card_core", path="checkpoint", tiles=n_tiles, save_s=save_s,
            restore_s=restore_s, shard_mb=shard_mb, equal=True,
            manifest=checkpoint.manifest(path)[0], card=card)
        say("single_card_core", path="diag_band_to_rect", NT=nt, MB=NB, seconds=band_s,
            equal_host_reference=True, card=card)
        del A, B, Bb
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # the pump with runtime_vpmap=nb:2 (the engine's steal map; the pump
    # has no worker threads to steal, so the factor must not move)
    with mca(mca_param, "runtime", "vpmap", "nb:2"):
        A, ran, wall, setup, c, stats, _ = native(dict(use_kernels=True))
    check(stats["pump"] and torch.equal(torch.from_numpy(A.to_array()),
                                        torch.from_numpy(pump_factor["kernels"])),
          "vpmap nb:2: the pump's factor differs from the flat pump's")
    check(c == h.launches["legacy_pump_kernels"], f"vpmap nb:2 pump: launches {c}")
    h.launches["core_vpmap_nb2_pump"] = c
    say("single_card_core", path="dpotrf kernels pump", run="vpmap_nb2", N=N, nb=NB,
        wall_s=wall, equal_flat=True, launches=c, card=card)
    say("legacy_async_phase", seconds=time.perf_counter() - t_phase, card=card)


# -- the graph verifier and the runtime checkers on the dpotrf path ---------

#: the checker switches the phase's checked runs set before their Context
CHECKED_ENV = {"PARSEC_TPU_LINT": "strict", "PARSEC_TPU_HBCHECK": "strict",
               "PARSEC_TPU_LOCKDEP": "1"}


def analysis_phase(h):
    """The analysis layer over the dpotrf path (N=8192 nb=512 f32, the
    path's SPD matrix), every task on the CUDA module with the hand
    kernels.

    Lint: ``PTG.verify`` of ``cholesky_ptg`` ``kernels`` and
    ``kernels_trtri`` over the path's TiledMatrix (no error finding), and
    ``tools lint --all`` over the registry (every buildable graph clean,
    the array front end's canonical programs and the distributed
    segmented Cholesky and the two ring-attention graphs among them, each
    reported OK).  Checked
    runs, under ``PARSEC_TPU_LINT=strict``, ``PARSEC_TPU_HBCHECK=strict``
    and ``PARSEC_TPU_LOCKDEP=1`` (restored after): the dynamic ``kernels``
    and ``kernels_trtri`` and the pump's ``kernels`` at stage depth 2 (the
    transfer lane and the write-back committer), each right after the same
    run unchecked; every factor ``torch.equal`` to the dynamic path's
    first, the launches its, no hb finding and no lock-order finding.  The
    schedule explorer: four seeds of the dynamic ``kernels`` dpotrf
    (``rnd`` pop order, completion jitter, hb-check), every digest the
    dynamic factor's bit for bit.  ``verify_engine`` against the engine
    library the port built: ABI, model and conformance (the nt=16 dpotrf
    DAG, seeds 0-3) with no finding; the clang-tidy leg may only report
    ENG021 (not installed).  ``h`` carries main's helpers and the path's
    state; the phase's launches go into ``h.launches``."""
    import io

    np, torch, card, say, check = h.np, h.torch, h.card, h.say, h.check
    from parsec_tpu_torch import Context, mca_param
    from parsec_tpu_torch.analysis import errors_of, hb, lockdep
    from parsec_tpu_torch.analysis.edges import count_instances
    from parsec_tpu_torch.analysis.engine_verify import verify_engine
    from parsec_tpu_torch.analysis.schedules import explore
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.dsl.native_exec import NativeExecutor
    from parsec_tpu_torch.ops import cholesky_ptg, dpotrf_task_count, kernels
    from parsec_tpu_torch.profiling import tools

    nt = N // NB
    t_phase = time.perf_counter()

    def counts():
        return {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                for fn in (kernels.matmul_update, kernels.matmul)}

    def matrix():
        return TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(h.S)

    def equal_dyn(A, name):
        return torch.equal(torch.from_numpy(A.to_array()),
                           torch.from_numpy(h.dyn_factor[name]))

    # -- lint: the path's PTG at N=8192, then the registry ----------------
    A = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32)
    for name, kw, _tol in h.variants[:2]:
        ptg = cholesky_ptg(use_cuda=True, use_cpu=False, **kw)
        t0 = time.perf_counter()
        findings = ptg.verify({"NT": nt, "A": A})
        seconds = time.perf_counter() - t0
        check(errors_of(findings) == [], f"lint {name}: {[str(f) for f in findings]}")
        say("analysis_lint", graph=f"cholesky_ptg {name}", N=N, nb=NB,
            instances=count_instances(ptg, {"NT": nt, "A": A}, 10 ** 6),
            findings=len(findings), seconds=seconds, card=card)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tools.main(["lint", "--all"])
    seconds = time.perf_counter() - t0
    out = buf.getvalue().splitlines()
    summary = out[-1] if out else ""
    from parsec_tpu_torch.analysis import registry

    clean = [ln.split(":")[0] for ln in out if ln.endswith(": OK") or ": OK (" in ln]
    check(rc == 0 and " 0 error(s), 0 warning(s)" in summary,
          f"tools lint --all: rc {rc}, {summary}")
    check(sorted(clean) == sorted(registry.names()),
          f"tools lint --all: OK for {clean}, the registry {registry.names()}")
    say("analysis_lint", graph="registry --all", summary=summary, clean=len(clean),
        seconds=seconds, card=card)

    # -- checked runs: each right after the same run unchecked ------------
    def dynamic(kw):
        A = matrix()
        tp = cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(NT=nt, A=A)
        gc.collect()
        kernels.reset_counts()
        ctx = Context()
        try:
            t0 = time.perf_counter()
            ctx.add_taskpool(tp)
            ok = tp.wait(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = counts()
        finally:
            ctx.fini()
        check(ok, f"analysis dpotrf {kw}: taskpool failed ({tp.fail_reason})")
        return A, wall, c, ctx

    def pump(kw):
        A = matrix()
        tp = cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(NT=nt, A=A)
        gc.collect()
        kernels.reset_counts()
        t0 = time.perf_counter()
        ex = NativeExecutor(tp, native_device=True)
        try:
            check(ex.device.tdev.type == "cuda", f"native device bound to {ex.device.tdev}")
            ex.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = counts()
        finally:
            ex.close()
        check(ex._pump, "analysis pump: the pump did not run")
        check(ex.device.stats["wb_sync_fallbacks"] == 0, "synchronous write-back fallbacks")
        return A, wall, c, ex

    saved = {k: os.environ.pop(k, None) for k in CHECKED_ENV}
    runs = [("kernels", "dynamic", 1), ("kernels_trtri", "dynamic", 1),
            ("kernels", "pump", 2)]
    try:
        for name, path, depth in runs:
            kw = dict(next(v[1] for v in h.variants if v[0] == name))
            run = dynamic if path == "dynamic" else pump
            label = f"dpotrf {name} {path} depth {depth}"
            with mca(mca_param, "runtime", "stage_depth", depth):
                A, plain_wall, plain_c, _ = run(kw)
                check(equal_dyn(A, name), f"{label} unchecked: the factor differs")
                # the checkers observe the checked run only: installed here
                # (a Context would install them from the switches; the pump
                # has none) and removed after it
                os.environ.update(CHECKED_ENV)
                rec = hb.ensure_live().install()
                lockdep.install()
                n0 = len(rec.events)
                try:
                    A, wall, c, owner = run(kw)
                    # a Context reports at fini; the pump has none: here
                    hb_findings = (owner.hb_findings if path == "dynamic"
                                   else hb.live_report())
                    lock_findings = lockdep.checker().findings()
                    n_locks = lockdep.checker().n_locks
                finally:
                    for k in CHECKED_ENV:
                        os.environ.pop(k, None)
                    rec.uninstall()
                    lockdep.uninstall()
            events = rec.events[n0:]
            kinds = {}
            for e in events:
                kinds[e.kind] = kinds.get(e.kind, 0) + 1
            check(equal_dyn(A, name), f"{label} checked: the factor differs from "
                  "the dynamic path's")
            check(c == plain_c == h.launches[name],
                  f"{label}: launches {c}, unchecked {plain_c}, dynamic {h.launches[name]}")
            check(hb_findings == [], f"{label}: hb findings {[str(f) for f in hb_findings]}")
            check(lock_findings == [],
                  f"{label}: lockdep findings {[str(f) for f in lock_findings]}")
            check(rec.dropped == 0, f"{label}: {rec.dropped} hb events dropped")
            if path == "pump":
                check(all(kinds.get(k, 0) > 0 for k in
                          ("stage_in", "wb_enqueue", "wb_commit", "dep_dec", "task_publish")),
                      f"{label}: lane/committer/drain events missing: {kinds}")
                check(owner.stats["prefetched_batches"] > 0, f"{label}: the lane never ran")
            h.launches[f"analysis_{name}_{path}"] = c
            h.launches[f"analysis_{name}_{path}_unchecked"] = plain_c
            say("analysis_checked", path=label, N=N, nb=NB, wall_s=wall,
                unchecked_wall_s=plain_wall, checked_over_unchecked=wall / plain_wall,
                hb_events=len(events), hb_event_kinds=kinds, hb_findings=0,
                lock_findings=0, locks_tracked=n_locks,
                equal_dynamic=True, launches=c, card=card)
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v

    # -- the schedule explorer: four seeds of the dynamic kernels dpotrf ---
    kw = dict(next(v[1] for v in h.variants if v[0] == "kernels"))

    def build(rank, ctx):
        A = matrix()
        return cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(NT=nt, A=A), A

    want = {}
    for (i, j) in A.local_tiles():
        tile = h.dyn_factor["kernels"][i * NB:(i + 1) * NB, j * NB:(j + 1) * NB]
        want[(i, j)] = ((NB, NB), "float32", np.ascontiguousarray(tile).tobytes())
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = explore(build, nranks=1, seeds=range(4), hbcheck=True, timeout=600)
    seconds = time.perf_counter() - t0
    c = counts()
    check(res.identical and not res.errors, f"explorer: {res.summary()}")
    check(res.race_findings() == [], f"explorer: {res.race_findings()}")
    for seed in res.seeds:
        check(res.digests[seed][0] == want,
              f"explorer seed {seed}: the digest differs from the dynamic factor")
    check(c["matmul_update"]["total"] == 4 * h.launches["kernels"]["matmul_update"]["total"],
          f"explorer: launches {c}")
    h.launches["analysis_explore"] = c
    say("analysis_explore", path="dpotrf kernels dynamic", N=N, nb=NB, seeds=res.seeds,
        wall_s=[res.wall_s[s] for s in res.seeds], seconds=seconds,
        findings=sum(len(f) for f in res.findings.values()), identical=True,
        equal_dynamic=True, launches=c, card=card)

    # -- engine-verify against the library the port built ------------------
    t0 = time.perf_counter()
    findings, stats = verify_engine(conformance_nt=nt, conformance_seeds=(0, 1, 2, 3))
    seconds = time.perf_counter() - t0
    by_code = {}
    for f in findings:
        by_code[f.code] = by_code.get(f.code, 0) + 1
    check(set(by_code) <= {"ENG021"},
          f"engine-verify: {[str(f) for f in findings if f.code != 'ENG021']}")
    check(stats["abi"]["findings"] == 0 and stats["conformance"]["runs"] == 4
          and stats["conformance"]["tasks"] == dpotrf_task_count(nt),
          f"engine-verify: {stats}")
    check(all(not s["truncated"] for s in stats["model"].values()),
          f"engine-verify: model truncated {stats['model']}")
    say("analysis_engine", abi=stats["abi"], conformance=stats["conformance"],
        model={d: {k: s[k] for k in ("states", "transitions", "terminals")}
               for d, s in stats["model"].items()},
        tidy=[str(f) for f in findings if f.code == "ENG021"], errors=0,
        seconds=seconds, card=card)
    say("analysis_phase", seconds=time.perf_counter() - t_phase, card=card)


# -- the trace stack on the main path ----------------------------------------

def _dag_shape(tp, capture):
    """(tasks, edges, longest path in tasks, sources) of a taskpool's
    captured DAG; an edge is a (producer, consumer) pair per flow, as the
    pump publishes them."""
    g = capture(tp, ranks=[0])
    succ = {t: [s for (_f, s, _sf) in n.out_edges if s != t] for t, n in g.nodes.items()}
    indeg = dict.fromkeys(g.nodes, 0)
    for t in g.nodes:
        for s in succ[t]:
            indeg[s] += 1
    sources = [t for t, d in indeg.items() if d == 0]
    depth = dict.fromkeys(g.nodes, 1)
    ready = list(sources)
    while ready:
        t = ready.pop()
        for s in succ[t]:
            depth[s] = max(depth[s], depth[t] + 1)
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    return len(g.nodes), sum(len(v) for v in succ.values()), max(depth.values()), len(sources)


def profiling_phase(h):
    """The trace stack over the main path: dpotrf N=8192 nb=512 f32 (the
    path's SPD matrix) with every task on the CUDA module and the hand
    kernels, and the f32 flash-attention prefill at Llama-2-7B's layer.

    Each run goes once untraced and then once under ``RankTraceSet(1)``
    (the binary tracer): the dynamic ``kernels`` and ``kernels_trtri``
    at stage depth 1, the pump's ``kernels`` at depth 2 (the lane's
    ``stage_in`` and the committer's ``writeback`` spans), and the
    prefill through ``measure_overlap(nranks=1)``.  Each traced output is
    ``torch.equal`` to the untraced one with the untraced launches (B1
    680 a dpotrf, B2 120 with ``trtri``, B5 1152 a prefill).  Each dump
    is read back (``read_pbt``): an ``exec`` pair for every task; the
    pump's ``dep_edge`` instants are its captured DAG's edges and
    ``critpath.analyze`` walks a chain as long as the DAG's longest path;
    the dynamic path's are releases (one a non-source task: the
    predecessor whose completion made it ready), its ``hb_dep_dec``
    instants the DAG's edges, and its chain the executed release chain
    from a source to the last task (the longest path or shorter, both
    printed); every run's buckets printed.
    ``tools info``, ``to-csv``, ``critpath`` and ``merge`` run on every
    dump, ``hbcheck`` on the pump's finds nothing and ``tools check``
    passes.  A ``GraphExecutor`` of the dpotrf DAG traced cold shows one
    ``compile`` span; a second one on a same-shaped pool hits the program
    cache and shows none.  On the card an ``exec`` span is the host's
    submit of the task, not the kernel's run."""
    import io

    np, torch, card, say, check = h.np, h.torch, h.card, h.say, h.check
    from parsec_tpu_torch import Context, compile_cache, mca_param
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.dsl import GraphExecutor
    from parsec_tpu_torch.dsl.graph import capture
    from parsec_tpu_torch.dsl.native_exec import NativeExecutor
    from parsec_tpu_torch.ops import (build_flash_attention, cholesky_ptg, kernels,
                                      run_flash_attention)
    from parsec_tpu_torch.profiling import critpath, tools
    from parsec_tpu_torch.profiling.binary import RankTraceSet, read_pbt
    from parsec_tpu_torch.profiling.overlap import measure_overlap

    nt = N // NB
    t_phase = time.perf_counter()
    tdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")

    def counts():
        return {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                for fn in (kernels.matmul_update, kernels.matmul, kernels.flash_attention_block)}

    def matrix():
        return TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(h.S)

    def tool(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tools.main(argv)
        return rc, buf.getvalue()

    def traced(run, trace):
        """``run()`` under a fresh RankTraceSet (installed only when
        ``trace``); returns run's result and the set."""
        ts = RankTraceSet(1).install() if trace else None
        try:
            return run(), ts
        finally:
            if ts is not None:
                ts.uninstall()

    def read_back(label, path, shape, pump, wall, plain_wall):
        ntasks, nedges, longest, sources = shape
        t0 = time.perf_counter()
        evs = read_pbt(path)
        read_s = time.perf_counter() - t0
        c = {}
        for e in evs:
            c[(e["name"], e["ph"])] = c.get((e["name"], e["ph"]), 0) + 1
        n_exec = (c.get(("exec", "B"), 0), c.get(("exec", "E"), 0))
        check(n_exec == (ntasks, ntasks), f"profiling {label}: exec pairs {n_exec}, "
              f"{ntasks} tasks")
        dep = c.get(("dep_edge", "i"), 0)
        if pump:
            check(dep == nedges, f"profiling {label}: {dep} dep_edge instants, "
                  f"the DAG has {nedges} edges")
        else:
            # the dynamic path records a release: the one predecessor whose
            # completion made its successor ready; every edge decrements
            dec = c.get(("hb_dep_dec", "i"), 0)
            check(dep == ntasks - sources and dec == nedges,
                  f"profiling {label}: {dep} dep_edge (releases, want "
                  f"{ntasks - sources}), {dec} hb_dep_dec (want {nedges} edges)")
        t0 = time.perf_counter()
        rep = critpath.analyze(evs)
        crit_s = time.perf_counter() - t0
        chain = [r["token"] for r in rep["chain"]]
        if pump:
            # every edge published: the walk from the last task through the
            # predecessor submitted last is the DAG's longest path
            check(rep["n_tasks"] == longest, f"profiling {label}: critical path of "
                  f"{rep['n_tasks']} tasks, the DAG's longest path is {longest}")
        else:
            # releases only: the walk is the executed binding chain — from a
            # source, through each task's releasing predecessor, to the last
            # task — never longer than the DAG's longest path
            edges = {(e["args"]["event_id"], e["args"]["info"])
                     for e in evs if e["name"] == "dep_edge"}
            released = {d for _p, d in edges}
            check(chain and chain[0] not in released
                  and all(pair in edges for pair in zip(chain, chain[1:]))
                  and 1 < rep["n_tasks"] <= longest,
                  f"profiling {label}: critical path of {rep['n_tasks']} tasks is not "
                  f"a release chain from a source (longest path {longest})")
        rcs = {}
        for cmd, extra in (("info", []), ("to-csv", ["-o", path + ".csv"]),
                           ("critpath", []), ("merge", ["-o", path + ".merged.json"])):
            rc, _out = tool([cmd, path, *extra])
            rcs[cmd] = rc
        check(all(rc == 0 for rc in rcs.values()), f"profiling {label}: tools {rcs}")
        nbytes = os.path.getsize(path) + os.path.getsize(path + ".meta.json")
        n_events = len(evs)
        b = rep["buckets"]
        say("profiling", run=label, N=N if "prefill" not in label else None,
            tasks=ntasks, dag_edges=nedges, longest_path=longest, wall_s=wall,
            untraced_wall_s=plain_wall, traced_over_untraced=wall / plain_wall,
            events=n_events, events_per_task=n_events / ntasks,
            events_per_s=n_events / wall, dump_bytes=nbytes,
            exec_pairs=n_exec[0], dep_edges=dep,
            stage_in_spans=c.get(("stage_in", "B"), 0),
            writeback_spans=c.get(("writeback", "B"), 0),
            chain_tasks=rep["n_tasks"], chain_is_longest=rep["n_tasks"] == longest,
            chain_wall_us=rep["wall_us"],
            coverage=rep["coverage"], buckets=b,
            bucket_share={k[:-3]: (v / rep["wall_us"] if rep["wall_us"] else 0.0)
                          for k, v in b.items()},
            read_s=read_s, critpath_s=crit_s, tools_rc=rcs, card=card)
        return rep

    # -- dpotrf: dynamic kernels and kernels_trtri, the depth-2 pump ---------
    def dpotrf(kw, path):
        A = matrix()
        tp = cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(NT=nt, A=A)
        gc.collect()
        kernels.reset_counts()
        if path == "dynamic":
            ctx = Context()
            try:
                t0 = time.perf_counter()
                ctx.add_taskpool(tp)
                ok = tp.wait(timeout=600)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                c = counts()
            finally:
                ctx.fini()  # the write-back home: traced too
            check(ok, f"profiling dpotrf {kw}: taskpool failed ({tp.fail_reason})")
        else:
            t0 = time.perf_counter()
            ex = NativeExecutor(tp, native_device=True)
            try:
                check(ex.device.tdev.type == "cuda", f"native device bound to {ex.device.tdev}")
                ex.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                c = counts()
            finally:
                ex.close()
            check(ex._pump, "profiling pump: the pump did not run")
            check(ex.device.stats["wb_sync_fallbacks"] == 0, "synchronous write-back fallbacks")
        return A, wall, c

    pump_dump = None
    lean_ratio = None
    for name, path, depth in (("kernels", "dynamic", 1), ("kernels_trtri", "dynamic", 1),
                              ("kernels", "pump", 2)):
        kw = dict(next(v[1] for v in h.variants if v[0] == name))
        label = f"dpotrf_{name}_{path}_depth{depth}"
        shape = _dag_shape(cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(
            NT=nt, A=TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32)), capture)
        with mca(mca_param, "runtime", "stage_depth", depth):
            (A0, plain_wall, plain_c), _ = traced(lambda: dpotrf(kw, path), False)
            (A1, wall, c), ts = traced(lambda: dpotrf(kw, path), True)
        p = ts.dump(os.path.join(tdir, label))[0]
        ts.close()
        f0, f1 = torch.from_numpy(A0.to_array()), torch.from_numpy(A1.to_array())
        check(torch.equal(f1, f0) and torch.equal(f0, torch.from_numpy(h.dyn_factor[name])),
              f"profiling {label}: the traced factor differs from the untraced one "
              "or from the dynamic path's")
        want = {k: v for k, v in h.launches[name].items()}
        got = {k: c[k] for k in want}
        check(got == {k: plain_c[k] for k in want} == want,
              f"profiling {label}: launches {got}, untraced {plain_c}, dynamic {want}")
        check(c["flash_attention_block"]["total"] == 0, f"profiling {label}: B5 launched")
        h.launches[f"profiling_{name}_{path}"] = got
        h.launches[f"profiling_{name}_{path}_untraced"] = {k: plain_c[k] for k in want}
        read_back(label, p, shape, path == "pump", wall, plain_wall)
        if path == "pump":
            pump_dump = p
        elif name == "kernels":
            # the same run under a lean set: no select or prepare_input
            # subscribers (a select callback runs on every scheduler poll,
            # idle ones included, on every worker)
            def lean():
                ts = RankTraceSet(1, lean=True).install()
                try:
                    return dpotrf(kw, path), ts
                finally:
                    ts.uninstall()

            (A2, lean_wall, lean_c), ts = lean()
            n_lean = ts.traces[0].total_events
            ts.close()
            check(torch.equal(torch.from_numpy(A2.to_array()), f0) and lean_c == c,
                  f"profiling {label} lean: the factor or the launches differ")
            lean_ratio = lean_wall / plain_wall
            h.launches[f"profiling_{name}_{path}_lean"] = {k: lean_c[k] for k in want}
            say("profiling_lean", run=label, wall_s=lean_wall, untraced_wall_s=plain_wall,
                traced_over_untraced=lean_ratio, events=n_lean,
                events_per_task=n_lean / shape[0], card=card)
            del A2
        del A0, A1, f0, f1

    # -- hbcheck over the pump's dump, and the aggregate gate ---------------
    rc, out = tool(["hbcheck", pump_dump])
    summary = out.strip().splitlines()[-1] if out.strip() else ""
    check(rc == 0 and " 0 race(s), 0 warning(s)" in summary, f"tools hbcheck: rc {rc}, {summary}")
    t0 = time.perf_counter()
    rc_check, out = tool(["check", "--hbcheck", pump_dump])
    check_s = time.perf_counter() - t0
    check(rc_check == 0, "tools check: " + " | ".join(out.strip().splitlines()[-8:]))
    say("profiling_tools", hbcheck=summary, check=out.strip().splitlines()[-1],
        check_s=check_s, card=card)

    # -- the f32 prefill through measure_overlap(nranks=1) ------------------
    rng = np.random.default_rng(9)
    pf_in = [torch.from_numpy(rng.standard_normal((ATTN_B, ATTN_S, ATTN_H, ATTN_D)).astype(
        np.float32)) for _ in range(3)]
    pf_kw = dict(causal=True, q_block=ATTN_BLOCK, kv_block=ATTN_BLOCK)
    shape = _dag_shape(build_flash_attention(*pf_in, use_cpu=False, **pf_kw)[0], capture)

    def prefill(stats):
        """One prefill, traced through measure_overlap when ``stats`` is a
        dict (the context's fini, the write-back home, inside the scope)."""
        ctx = Context()
        kernels.reset_counts()
        gc.collect()
        scope = (measure_overlap(stats, nranks=1, trace_dir=os.path.join(tdir, "prefill"))
                 if stats is not None else contextlib.nullcontext())
        with scope:
            try:
                t0 = time.perf_counter()
                out = run_flash_attention(ctx, *pf_in, use_cpu=False, **pf_kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                c = counts()
            finally:
                ctx.fini()
        return out, wall, c

    plain_out, plain_wall, plain_c = prefill(None)
    stats = {}
    out, wall, c = prefill(stats)
    n_steps = c["flash_attention_block"]["total"]
    # one B5 launch a step: every task but the (B x H x query blocks) outs
    steps = shape[0] - ATTN_B * ATTN_H * (ATTN_S // ATTN_BLOCK)
    check(torch.equal(out, plain_out), "profiling prefill: the traced output differs")
    check(c == plain_c and n_steps == steps,
          f"profiling prefill: launches {c}, untraced {plain_c}, {steps} steps")
    check(stats["n_comm_events"] == 0 and stats["trace_ranks"] == 1,
          f"profiling prefill: overlap stats {stats}")
    # B5's launches of the phase join the attention phases' count
    h.b5_launches["profiling_prefill"] = c["flash_attention_block"]
    h.b5_launches["profiling_prefill_untraced"] = plain_c["flash_attention_block"]
    read_back("prefill_f32_dynamic", os.path.join(tdir, "prefill", "rank0.pbt"), shape,
              False, wall, plain_wall)
    say("profiling_overlap", run="prefill_f32_dynamic", overlap_fraction=stats["overlap_fraction"],
        n_comm_events=stats["n_comm_events"], busy_us=stats["busy_us"],
        trace_ranks=stats["trace_ranks"], card=card)
    del out, plain_out, pf_in

    # -- capture spans: a cold GraphExecutor, then a program-cache hit -------
    cache = compile_cache.ProgramCache()  # cold whatever earlier phases cached
    spans = []
    for rep in range(2):
        A = matrix()
        tp = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True).taskpool(NT=nt, A=A)
        ex = GraphExecutor(tp)
        ex.cache = cache
        kernels.reset_counts()

        def call():
            t0 = time.perf_counter()
            ex()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        first_s, ts = traced(call, True)
        c = counts()
        h.launches[f"profiling_graph{rep}"] = {k: c[k] for k in ("matmul_update", "matmul")}
        p = ts.dump(os.path.join(tdir, f"graph{rep}"))[0]
        ts.close()
        evs = [e for e in read_pbt(p) if e["name"] == "compile"]
        n = (sum(e["ph"] == "B" for e in evs), sum(e["ph"] == "E" for e in evs))
        want = (1, 1) if rep == 0 else (0, 0)
        check(ex.cache_hit == (rep == 1) and n == want,
              f"profiling graph {rep}: cache hit {ex.cache_hit}, compile spans {n}")
        if rep == 0:
            check(evs[1]["args"]["info"] == 0, "profiling graph: a miss's span not marked miss")
        check(torch.equal(torch.from_numpy(A.to_array()), torch.from_numpy(h.dyn_factor["kernels"])),
              f"profiling graph {rep}: the factor differs from the dynamic path's")
        spans.append(n[0])
        say("profiling_capture", rep=rep, cache_hit=ex.cache_hit, compile_spans=n[0],
            compile_us=(evs[1]["ts"] - evs[0]["ts"]) if evs else 0.0, first_call_s=first_s,
            capture_s=ex.capture_s,
            launches={f"{fn}.{mode}": n for (fn, mode), n in ex.launches.items()}, card=card)
        del ex, tp, A
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(tdir, ignore_errors=True)
    say("profiling_phase", seconds=time.perf_counter() - t_phase,
        lean_traced_over_untraced=lean_ratio, card=card)


# -- the serving plane and the live planes on the main path ------------------
# three tenants on one Context with the CUDA module (stage depth 1, fusion
# and waves off): SERVE_K decode jobs of SERVE_DEC_Q query rows at the tail
# of the 4096-token causal sequence at Llama-2-7B's layer (ATTN_H x ATTN_D,
# ATTN_BLOCK-key blocks), beside the f32 prefill and the dpotrf N=8192
SERVE_K, SERVE_DEC_Q, SERVE_INFLIGHT, SERVE_GAP_S = 16, 8, 8, 0.002
SERVE_WEIGHTS = {"decode": 4, "prefill": 1, "factor": 1}
SERVE_NATIVE_DECODES = 4
# the four switches off for the observability cost, one turn after the live
# turn, which is the run with them on: (on, off) — one pair keeps the whole
# call inside its time limit on a slower host
SERVE_OBS = (False,)
SERVE_SWITCHES = ("PARSEC_TPU_FLIGHT", "PARSEC_TPU_HEALTH", "PARSEC_TPU_WATCHDOG",
                  "PARSEC_TPU_SLO")
# the flight ring a thread during the phase: holds a whole served turn
SERVE_FR_EVENTS = 1 << 17


def serve_phase(h):
    """The serving plane and the live planes on the main path.

    Three tenants, built from the checkout's entry points on the card:
    ``decode`` (weight 4) — ``SERVE_K`` decode jobs, each ``SERVE_DEC_Q``
    query rows at the tail of a 4096-token causal KV sequence, 32 heads x
    128, f32, q block 8, kv block 512 (256 B5 launches a job; each job's
    q/k/v from its own stream, a generator seeded by the crc32 of its tag);
    ``prefill`` (weight 1) — the causal prefill S = 4096 (1152 B5 launches);
    ``factor`` (weight 1) — dpotrf N=8192 nb=512 f32 ``kernels`` on the
    path's SPD matrix (680 B1 launches).

    1. Solo: each job alone on the context (the oracles); the factor
       ``torch.equal`` to the dynamic path's, decode 0 within 2e-5 of its
       float64 attention.
    2. A ``RuntimeService`` (wdrr, ``serve_max_inflight_pools`` 8, the four
       switches on, the health exporter on an ephemeral 127.0.0.1 port):
       prefill and factor first, then the decodes 2 ms apart.  Every output
       ``torch.equal`` to its solo run, the launches exact, every job done,
       the counters adding up, at least one job queued at its submit; a
       thread scrapes ``/metrics``, ``/status`` and ``/healthz`` through
       the turn.  After it, ``tools serve-status``, ``top --once`` and
       ``flightdump`` against the endpoint; the dump read back (``exec``
       spans, ``job_phase`` and ``tenant:`` instants of all three
       tenants), ``critpath`` sliced to one job a tenant (its per-tenant
       table names the tenant); the watchdog reports no stall and
       ``diagnose()`` no error; the SLO plane's job histograms count each
       tenant's jobs.
       Under wdrr the decodes' median completion comes before the
       prefill's.
    3. The observability cost: the turn with the four switches off and on
       in turns, the live turn the first run with them on (``SERVE_OBS``),
       the median ratio.
    4. The same turn on an ``lfq`` context (fairness off): decode p50/p95
       latency under both.
    5. The whole mix admitted at once (no admission queue), switches off,
       on wdrr and on lfq, every task the scheduler hands out recorded
       with the ready tasks it still held: while the decode and the
       prefill tenants both have work left, the decodes' share of their
       pops and the queue's depth (reported).
    6. The native serve executor over the prefill, the factor and
       ``SERVE_NATIVE_DECODES`` decodes (weights 1, 1, 4, ...): each output
       ``torch.equal`` to its solo pump run, every decode pool retired
       before the factor's last task, no trampoline entry; again with
       every weight 1, where each decode pool retires its last task later
       and the prefill its last no later; the same pools
       through a ``RuntimeService`` for the wall beside it; then ``rebind``
       of a decode executor to a fresh same-shaped pool: nothing captured,
       its output ``torch.equal`` to its solo run.

    Every run's launches are counted (``serve_launches``), the pump's solo
    runs and the rebound executor's first run included.
    """
    import collections
    import io
    import threading
    import urllib.request
    import zlib

    np, torch, dev, card, say, check = h.np, h.torch, h.dev, h.card, h.say, h.check
    from parsec_tpu_torch import Context, mca_param
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.dsl import native_exec
    from parsec_tpu_torch.dsl.native_exec import NativeExecutor, NativeServeExecutor
    from parsec_tpu_torch.ops import build_flash_attention, cholesky_ptg, kernels
    from parsec_tpu_torch.profiling import critpath, tools
    from parsec_tpu_torch.profiling.binary import read_pbt
    from parsec_tpu_torch.profiling.jobtrace import hex_id, trace_id_of
    from parsec_tpu_torch.serve import RuntimeService

    t_phase = time.perf_counter()
    b5_counts, mm_counts = _launch_readers(kernels)
    nt, nkv = N // NB, ATTN_S // ATTN_BLOCK
    n_dec = ATTN_H * nkv                           # B5 launches a decode job
    n_pf = ATTN_H * nkv * (nkv + 1) // 2           # B5 launches the prefill
    n_b1 = nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
    fdir = tempfile.mkdtemp(prefix="chip_smoke_flight_")
    saved_env = {k: os.environ.get(k) for k in SERVE_SWITCHES + ("PARSEC_TPU_FLIGHT_DIR",)}
    os.environ["PARSEC_TPU_FLIGHT_DIR"] = fdir

    def seeded(tag, shape):
        """A tensor from the job tag's own stream (crc32 of the tag seeds
        a generator on the card), kept on the host as a user's input is."""
        g = torch.Generator(device=dev)
        g.manual_seed(zlib.crc32(tag.encode()))
        return torch.randn(shape, generator=g, device=dev).cpu()

    kv_shape = (ATTN_B, ATTN_S, ATTN_H, ATTN_D)
    inputs = {f"decode{i}": (seeded(f"decode{i}.q", (ATTN_B, SERVE_DEC_Q, ATTN_H, ATTN_D)),
                             seeded(f"decode{i}.k", kv_shape), seeded(f"decode{i}.v", kv_shape))
              for i in range(SERVE_K + 1)}  # the last one: the rebind's fresh pool
    inputs["prefill"] = tuple(seeded(f"prefill.{x}", kv_shape) for x in "qkv")

    def named(tp, tag):
        # a job's trace id comes from its pool's name: one a job
        tp.name, tp.trace_id = tag, trace_id_of(tag)
        return tp

    def build(tag):
        """(taskpool, read) of one job: read() gives its output on the host."""
        if tag == "factor":
            A = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(h.S)
            tp = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True).taskpool(
                NT=A.mt, A=A)
            return named(tp, tag), lambda: torch.from_numpy(A.to_array())
        qb = ATTN_BLOCK if tag == "prefill" else SERVE_DEC_Q
        tp, assemble = build_flash_attention(*inputs[tag], causal=True, q_block=qb,
                                             kv_block=ATTN_BLOCK, use_cpu=False)
        return named(tp, tag), assemble

    def tenant_of(tag):
        return "decode" if tag.startswith("decode") else tag

    def switches(on):
        for var in SERVE_SWITCHES:
            os.environ.pop(var, None)
        if on:
            for var in SERVE_SWITCHES:
                os.environ[var] = "1"
        else:
            os.environ["PARSEC_TPU_SLO"] = "0"  # a service installs one otherwise

    def context(on, scheduler="wdrr"):
        switches(on)
        ctx = Context(scheduler=scheduler)
        cuda_dev = next(d for d in ctx.devices if d.mca_name == "cuda")
        check(cuda_dev.tdev.type == "cuda", f"serve: CUDA module bound to {cuda_dev.tdev}")
        planes = (ctx.flight, ctx.health, ctx.watchdog, ctx.slo)
        check(all(p is not None for p in planes) if on else not any(planes),
              f"serve: the switches {'on' if on else 'off'} gave the planes {planes}")
        return ctx, cuda_dev

    def finish(ctx, cuda_dev, label):
        cuda_dev.detach()
        stats = device_stats(cuda_dev)
        ctx.fini()
        check(stats["wb_sync_fallbacks"] == 0, f"serve {label}: synchronous write-back "
              f"fallbacks {stats['wb_sync_fallbacks']}")

    decode_tags = [f"decode{i}" for i in range(SERVE_K)]
    mix = ["prefill", "factor"] + decode_tags

    def launches_of(tags):
        n_pf_jobs = sum(t == "prefill" for t in tags)
        return (n_dec * sum(t.startswith("decode") for t in tags) + n_pf * n_pf_jobs,
                n_b1 * sum(t == "factor" for t in tags))

    h.serve_decode_launches = 0
    phase_launches = {}

    def counted(label, tags):
        """The launches since the last reset, kept for the kernel table
        (the decodes' share of B5's apart, for its decode-shape row)."""
        b5, mm = b5_counts(), mm_counts()
        h.b5_launches[f"serve_{label}"] = b5
        h.launches[f"serve_{label}"] = mm
        h.serve_decode_launches += b5["f32"] - n_pf * sum(t == "prefill" for t in tags)
        phase_launches[label] = (b5["total"], mm["matmul_update"]["total"])
        return b5, mm

    # -- 1. solo runs on one context: the oracles ---------------------------
    ctx, cuda_dev = context(True)
    solo, solo_walls = {}, {}
    for tag in ["decode0", "prefill", "factor"] + decode_tags[1:] + [f"decode{SERVE_K}"]:
        tp, read = build(tag)
        kernels.reset_counts()
        t0 = time.perf_counter()
        ctx.add_taskpool(tp)
        check(tp.wait(timeout=600), f"serve solo {tag}: {tp.fail_reason}")
        torch.cuda.synchronize()
        solo_walls[tag] = time.perf_counter() - t0
        b5, mm = counted(f"solo_{tag}", [tag])
        want_b5, want_b1 = launches_of([tag])
        check(b5["f32"] == b5["total"] == want_b5 and mm["matmul_update"]["f32"] == want_b1,
              f"serve solo {tag}: launches B5 {b5}, B1 {mm['matmul_update']}")
        solo[tag] = read()
        check(bool(torch.isfinite(solo[tag]).all()), f"serve solo {tag}: non-finite output")
    finish(ctx, cuda_dev, "solo")
    check(torch.equal(solo["factor"], torch.from_numpy(h.dyn_factor["kernels"])),
          "serve solo factor: differs from the dynamic path's factor")
    q, k, v = (x.to(dev).double() for x in inputs["decode0"])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * ATTN_D ** -0.5
    pos_q = torch.arange(ATTN_S - SERVE_DEC_Q, ATTN_S, device=dev)[:, None]
    logits = logits.masked_fill(torch.arange(ATTN_S, device=dev)[None, :] > pos_q, float("-inf"))
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
    dec_err = (solo["decode0"].to(dev).double() - ref).abs().max().item()
    check(dec_err <= TOL_ATTN_F32 * (1 + ref.abs().max().item()),
          f"serve solo decode0: {dec_err} from its float64 attention")
    del q, k, v, logits, ref
    say("serve_solo", jobs=len(solo), decode_wall_s_median=statistics.median(
        solo_walls[t] for t in decode_tags), prefill_wall_s=solo_walls["prefill"],
        factor_wall_s=solo_walls["factor"], decode0_err_vs_f64=dec_err,
        launches_a_decode=n_dec, card=card)

    # -- the served turn -----------------------------------------------------
    def scraper(url, stop, log):
        """Fetches /metrics, /status and /healthz over 127.0.0.1 until
        ``stop``; every response kept (a failed fetch ends the loop)."""
        try:
            while True:
                got = {}
                for path in ("/metrics", "/status", "/healthz"):
                    with urllib.request.urlopen(url + path, timeout=60) as r:
                        got[path] = (r.status, r.read().decode())
                log["scrapes"].append(got)
                if stop.wait(0.05):
                    return
        except Exception as e:  # the phase checks it
            log["error"] = repr(e)

    def turn(label, on, tags, scheduler="wdrr", scrape=False, after=None,
             inflight=SERVE_INFLIGHT):
        """One served turn: ``tags`` submitted in order (the decodes
        SERVE_GAP_S apart) to a RuntimeService on a fresh context, at most
        ``inflight`` pools admitted at once; returns the turn's record
        after checking every output against its solo run, the launches,
        the states and the counters.  The record's ``pops`` is the job of
        every task the scheduler handed out, in the order it did."""
        ctx, cuda_dev = context(on, scheduler)
        sv = RuntimeService(ctx, fairness=scheduler == "wdrr")
        pops, depths = [], []
        sched = ctx.scheduler
        real_select = sched.select

        def select(es):
            task = real_select(es)
            if task is not None:
                pops.append(task.taskpool.name)
                depths.append(sched.pending_estimate())
            return task

        sched.select = select
        try:
            check(sv.fairness == (scheduler == "wdrr"), f"serve {label}: fairness {sv.fairness}")
            sv.max_inflight_pools = inflight
            for tenant, w in SERVE_WEIGHTS.items():
                sv.tenant(tenant, weight=w)
            jobs = [(tag, *build(tag)) for tag in tags]
            log = {"scrapes": [], "error": None}
            stop = threading.Event()
            th = threading.Thread(target=scraper, args=(ctx.health.url, stop, log),
                                  daemon=True) if scrape else None
            kernels.reset_counts()
            gc.collect()
            if th is not None:
                th.start()
            t0 = time.perf_counter()
            handles, queued = [], 0
            for i, (tag, tp, _read) in enumerate(jobs):
                if i and tag.startswith("decode"):
                    time.sleep(SERVE_GAP_S)
                hd = sv.submit(tenant_of(tag), tp)
                queued += hd.state == "queued"
                handles.append(hd)
            for hd in handles:
                check(hd.wait(timeout=600), f"serve {label}: {hd!r} {hd.status()}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            b5, mm = counted(label, tags)
            if th is not None:
                stop.set()
                th.join(timeout=120)
            want_b5, want_b1 = launches_of(tags)
            check(b5["f32"] == b5["total"] == want_b5 and mm["matmul_update"]["f32"] ==
                  mm["matmul_update"]["total"] == want_b1 and mm["matmul"]["total"] == 0,
                  f"serve {label}: launches B5 {b5}, B1/B2 {mm}, want {want_b5}, {want_b1}")
            for (tag, _tp, read), hd in zip(jobs, handles):
                check(hd.status()["state"] == "done", f"serve {label}: {tag} {hd.status()}")
                check(torch.equal(read(), solo[tag]), f"serve {label}: {tag} differs from solo")
            cnt = sv.counters()
            check(cnt["done"] == len(tags) and cnt["rejected"] == cnt["failed"] == 0
                  and cnt["queued"] == cnt["inflight"] == 0,
                  f"serve {label}: counters {cnt}")
            doc = sv.status_doc()
            check(sum(t["submitted"] for t in doc["tenants"].values()) == len(tags)
                  and sum(t["completed"] for t in doc["tenants"].values()) == len(tags),
                  f"serve {label}: tenants {doc['tenants']}")
            rec = {"wall": wall, "handles": dict(zip(tags, handles)), "queued": queued,
                   "log": log, "counters": cnt, "pops": pops, "depths": depths}
            if after is not None:
                after(sv, ctx, rec)
            return rec
        finally:
            sv.close(timeout=600)
            finish(ctx, cuda_dev, label)

    def percentile(xs, q):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]

    def latencies(rec):
        dec = [rec["handles"][t] for t in rec["handles"] if t.startswith("decode")]
        lat = [hd.latency_s for hd in dec]
        qd = [hd.queue_delay_s for hd in dec]
        out = {"decode_p50_ms": percentile(lat, 0.5) * 1e3,
               "decode_p95_ms": percentile(lat, 0.95) * 1e3,
               "decode_queue_p50_ms": percentile(qd, 0.5) * 1e3,
               "decode_queue_p95_ms": percentile(qd, 0.95) * 1e3}
        for tag in ("prefill", "factor"):
            if tag in rec["handles"]:
                out[f"{tag}_ms"] = rec["handles"][tag].latency_s * 1e3
                out[f"{tag}_queue_ms"] = rec["handles"][tag].queue_delay_s * 1e3
        return out

    # -- 2. the served turn with the live planes, scraped ---------------------
    def live_checks(sv, ctx, rec):
        log = rec["log"]
        check(log["error"] is None and len(log["scrapes"]) >= 3,
              f"serve live: {len(log['scrapes'])} scrapes, error {log['error']}")
        seen_pool, retired, tenants_seen = False, {}, set()
        for got in log["scrapes"]:
            check(all(code == 200 for code, _ in got.values()),
                  f"serve live: a scrape answered {[c for c, _ in got.values()]}")
            metrics = got["/metrics"][1]
            check(all(f in metrics for f in ("parsec_serve_jobs_queued", "parsec_serve_jobs_inflight",
                                            "parsec_serve_jobs_done_total")),
                  "serve live: /metrics lacks the parsec_serve_jobs_* families")
            seen_pool |= "parsec_taskpool_retired_total" in metrics
            st = json.loads(got["/status"][1])
            tenants_seen |= set(st["serve"]["tenants"])
            for p in st["taskpools"]:
                key = p["taskpool_id"]
                check(p["retired"] >= retired.get(key, 0),
                      f"serve live: pool {p['name']} retired went back to {p['retired']}")
                retired[key] = p["retired"]
            check(json.loads(got["/healthz"][1])["ok"] is True, "serve live: /healthz not ok")
        check(seen_pool, "serve live: no scrape saw a parsec_taskpool_* family")
        check(tenants_seen == set(SERVE_WEIGHTS), f"serve live: /status tenants {tenants_seen}")
        check(rec["queued"] >= 1, "serve live: no job was queued before its admission")
        url = ctx.health.url
        outs = {}
        for argv in (["serve-status", url], ["top", url, "--once"],
                     ["flightdump", url, "-o", fdir]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = tools.main(argv)
            outs[argv[0]] = buf.getvalue()
            check(rc == 0, f"serve live: tools {argv[0]} exited {rc}: {buf.getvalue()[-2000:]}")
        check(all(t in outs["serve-status"] for t in SERVE_WEIGHTS),
              "serve live: serve-status lacks a tenant")
        dump = os.path.join(fdir, f"rank{ctx.rank}.fr.pbt")
        evs = read_pbt(dump)
        names = collections.Counter(e["name"] for e in evs)
        check(names["exec"] > 0 and names["job_phase"] > 0,
              f"serve live: the dump lacks exec spans or job_phase instants ({len(evs)} events)")
        check(all(names[f"tenant:{t}"] > 0 for t in SERVE_WEIGHTS),
              f"serve live: tenant instants {[n for n in names if n.startswith('tenant:')]}")
        paths = {}
        for tag in ("prefill", "factor", "decode0"):
            rep = critpath.analyze(evs, job=hex_id(trace_id_of(tag)))
            text = critpath.render(rep)
            check(rep["n_tasks"] > 0 and tenant_of(tag) in rep["per_tenant"]
                  and tenant_of(tag) in text,
                  f"serve live: critpath --job {tag}: per-tenant {list(rep['per_tenant'])}")
            paths[tag] = (len(rep["chain"]), rep["per_tenant"][tenant_of(tag)]["count"])
        wd = ctx.watchdog.status()
        diag = ctx.watchdog.diagnose()
        check(wd["stalled"] is False and not diag.errors,
              f"serve live: watchdog {wd}, findings {[str(f) for f in diag.findings]}")
        for tenant, n in (("decode", SERVE_K), ("prefill", 1), ("factor", 1)):
            hist = ctx.slo.hist("job_latency", ("tenant", tenant))
            check(hist.count == n, f"serve live: {tenant} job_latency count {hist.count} != {n}")
        rec.update(scrapes=len(log["scrapes"]), dump_events=len(evs),
                   dump_bytes=os.path.getsize(dump), critpath=paths,
                   metrics_bytes=len(log["scrapes"][-1]["/metrics"][1]))

    with mca(mca_param, "runtime", "stage_depth", 1), \
            mca(mca_param, "runtime", "fusion", "off"), \
            mca(mca_param, "device", "cuda_wave_batch", 0), \
            mca(mca_param, "profiling", "fr_events", SERVE_FR_EVENTS):
        try:
            live = turn("wdrr", True, mix, scrape=True, after=live_checks)
            dec_done = sorted(live["handles"][t].t_done for t in decode_tags)
            check(statistics.median(dec_done) < live["handles"]["prefill"].t_done,
                  "serve wdrr: the decodes' median completion came after the prefill's")
            say("serve_wdrr", wall_s=live["wall"], solo_sum_s=sum(solo_walls[t] for t in mix),
                queued_at_submit=live["queued"], counters=live["counters"],
                scrapes=live["scrapes"], flight_events=live["dump_events"],
                flight_bytes=live["dump_bytes"], metrics_bytes=live["metrics_bytes"],
                critpath_chain_and_tenant_tasks=live["critpath"], **latencies(live), card=card)

            # -- 3. the observability cost: the switches off and on ----------
            # the live turn is the first run with them on
            walls = {False: [], True: [live["wall"]]}
            for rep, on in enumerate(SERVE_OBS):
                walls[on].append(turn(f"obs{rep}_{'on' if on else 'off'}", on, mix)["wall"])
            ratio = statistics.median(walls[True]) / statistics.median(walls[False])
            say("serve_obs", walls_off_s=walls[False], walls_on_s=walls[True],
                median_on_over_off=ratio, card=card)

            # -- 4. fairness off: the same turn on lfq -----------------------
            lfq = turn("lfq", True, mix, scheduler="lfq")
            lat_w, lat_l = latencies(live), latencies(lfq)
            say("serve_fairness", wdrr=lat_w, lfq=lat_l,
                p95_lfq_over_wdrr=lat_l["decode_p95_ms"] / lat_w["decode_p95_ms"],
                p50_lfq_over_wdrr=lat_l["decode_p50_ms"] / lat_w["decode_p50_ms"],
                wall_wdrr_s=live["wall"], wall_lfq_s=lfq["wall"], card=card)

            # -- 5. the whole mix admitted at once: no admission queue -------
            # from the first pop of the last decode job (every job admitted
            # and started) to the first time the decode or the prefill
            # tenant has no task left, both tenants have work: the decodes'
            # share of the two tenants' pops there, and how many ready tasks
            # the scheduler held after each pop.  wdrr can give the decodes
            # their weight's share (4/5) only while its bins hold tasks; an
            # idle worker takes every ready task at once and hands it to the
            # CUDA module's pending queue (first in, first out), so the
            # depth says how often the scheduler had a choice to make.
            # Reported, not gated: the native run below is the check that
            # the weights act on the card
            def decode_share(rec):
                pops, depths = rec["pops"], rec["depths"]
                ten = [tenant_of(tag) for tag in pops]
                start = pops.index(decode_tags[-1])
                end = min(len(ten) - 1 - ten[::-1].index(t) for t in ("decode", "prefill"))
                window = collections.Counter(ten[start:end])
                both = window["decode"] + window["prefill"]
                depth = sorted(depths[start:end]) or [0]
                return dict(decode_share=window["decode"] / both if both else 0.0,
                            window=(start, end), pops_in_window=dict(window),
                            depth_p50=percentile(depth, 0.5), depth_p90=percentile(depth, 0.9),
                            depth_max=depth[-1],
                            depth_zero_frac=sum(d == 0 for d in depth) / len(depth))

            co = {}
            for sched in ("wdrr", "lfq"):
                rec = turn(f"coadmitted_{sched}", False, mix, scheduler=sched, inflight=len(mix))
                check(rec["queued"] == 0, f"serve co-admitted {sched}: {rec['queued']} queued")
                co[sched] = dict(decode_share(rec), pops=len(rec["pops"]), wall_s=rec["wall"],
                                 **latencies(rec))
            say("serve_coadmitted", weight_share=SERVE_WEIGHTS["decode"] / (
                SERVE_WEIGHTS["decode"] + SERVE_WEIGHTS["prefill"]), **co, card=card)

            # -- 6. the native serve executor, the same pools served, rebind --
            ntags = ["prefill", "factor"] + decode_tags[:SERVE_NATIVE_DECODES]
            pump_solo = {}
            for tag in ntags:
                tp, read = build(tag)
                ex = NativeExecutor(tp, native_device=True)
                try:
                    kernels.reset_counts()
                    ex.run()
                    torch.cuda.synchronize()
                    counted(f"pump_solo_{tag}", [tag])
                finally:
                    ex.close()
                pump_solo[tag] = read()
                check(torch.equal(pump_solo[tag], solo[tag]),
                      f"serve native: the pump's solo {tag} differs from the dynamic solo")
            def native_run(label, weights):
                """The pools as tenants of one native serve executor:
                (executor, counts, setup s, wall s, last retire a pool)."""
                jobs = [(tag, *build(tag)) for tag in ntags]
                t0 = time.perf_counter()
                sx = NativeServeExecutor([tp for _t, tp, _r in jobs], weights=weights)
                setup_s = time.perf_counter() - t0
                try:
                    kernels.reset_counts()
                    t0 = time.perf_counter()
                    counts = sx.run()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    b5, mm = counted(label, ntags)
                finally:
                    sx.close()
                want_b5, want_b1 = launches_of(ntags)
                check(b5["f32"] == want_b5 and mm["matmul_update"]["f32"] == want_b1,
                      f"serve {label}: launches B5 {b5}, B1 {mm}")
                check(counts == [len(ch.graph.nodes) for ch in sx.children],
                      f"serve {label}: counts {counts}")
                check(sx.stats["trampoline_entries"] == 0 == sx.stats["completion_callbacks"],
                      f"serve {label}: stats {sx.stats}")
                for tag, _tp, read in jobs:
                    check(torch.equal(read(), pump_solo[tag]), f"serve {label}: {tag} differs")
                last = {i: max(pos for t, pos, _s in sx.retire_log if t == i)
                        for i in range(len(ntags))}
                return sx, counts, setup_s, wall, last

            sx, counts, setup_s, native_wall, last = native_run(
                "native", [SERVE_WEIGHTS[tenant_of(t)] for t in ntags])
            check(all(last[i] < last[1] for i in range(2, len(ntags))),
                  f"serve native: last retires {last}")
            # the weights at work: with every weight 1 each decode pool
            # retires its last task later, the prefill its last no later
            _sx, _c, _s, equal_wall, last_equal = native_run("native_equal", [1] * len(ntags))
            check(all(last[i] < last_equal[i] for i in range(2, len(ntags)))
                  and last[0] >= last_equal[0],
                  f"serve native: last retires weighted {last}, all weights 1 {last_equal}")
            same = turn("same_pools", False, ntags)
            # rebind: a decode executor re-aimed at a fresh same-shaped pool
            captures = []
            real_capture = native_exec.capture
            native_exec.capture = lambda *a, **kw: captures.append(1) or real_capture(*a, **kw)
            try:
                tp, read = build("decode0")
                ex = NativeExecutor(tp, native_device=True)
                try:
                    kernels.reset_counts()
                    ex.run()
                    torch.cuda.synchronize()
                    counted("rebind_first", ["decode0"])
                    fresh, fresh_read = build(f"decode{SERVE_K}")
                    kernels.reset_counts()
                    t0 = time.perf_counter()
                    ex.rebind(fresh)
                    rebind_s = time.perf_counter() - t0
                    ex.run()
                    torch.cuda.synchronize()
                    b5, _mm = counted("rebind", ["decode"])
                finally:
                    ex.close()
            finally:
                native_exec.capture = real_capture
            check(captures == [1], f"serve rebind: {len(captures)} captures, want the first only")
            check(b5["f32"] == n_dec, f"serve rebind: B5 launches {b5}")
            check(torch.equal(read(), solo["decode0"]) and torch.equal(
                fresh_read(), solo[f"decode{SERVE_K}"]), "serve rebind: an output differs")
            say("serve_native", pools=ntags, counts=counts, setup_s=setup_s, wall_s=native_wall,
                service_wall_s=same["wall"], native_over_service=native_wall / same["wall"],
                pop_batches=sx.stats["pop_batches"], trampoline_entries=0,
                last_retire=last, last_retire_equal_weights=last_equal,
                equal_weights_wall_s=equal_wall, rebind_s=rebind_s, card=card)
        finally:
            for var, val in saved_env.items():
                if val is None:
                    os.environ.pop(var, None)
                else:
                    os.environ[var] = val
            shutil.rmtree(fdir, ignore_errors=True)
    # every run of the phase counted, B5 and B1 launches a run
    say("serve_launches", runs=phase_launches,
        b5_total=sum(b5 for b5, _b1 in phase_launches.values()),
        b1_total=sum(b1 for _b5, b1 in phase_launches.values()),
        b5_decode=h.serve_decode_launches)
    say("serve_phase", seconds=time.perf_counter() - t_phase, card=card)


def batched_graph(h, label, tp, feeds, ref_out, ref_median_s, kernel_of, tasks, exact,
                  replays=GRAPH_REPLAYS):
    """``GraphExecutor(tp, batch_levels=True)`` on the feeds of the path's
    unbatched executor: the first call (warm-up, capture, replay) timed on
    its own, then ``replays`` replays.  ``kernel_of`` maps each task class
    that launches a hand kernel to its (wrapper, mode).  Checks that no
    group fell back; that a call launches each kernel once a batched group
    (under the mode's ``_b``) and once a task run per task, mode by mode,
    and so every call; and that the outputs equal the unbatched replay's
    where ``exact`` (the stencil and the prefill: every batched group is a
    hand kernel or elementwise), else prints their max abs difference for
    the caller's gate.  Returns the executor, its last outputs and the
    kernel counters of its calls."""
    torch = h.torch
    from parsec_tpu_torch.dsl import GraphExecutor
    from parsec_tpu_torch.ops import kernels

    gc.collect()
    t0 = time.perf_counter()
    ex = GraphExecutor(tp, batch_levels=True)
    plan_s = time.perf_counter() - t0
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = ex.apply(feeds)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    h.first_calls[(label, True)] = first_s
    gc.collect()  # the timed replays start with no garbage pending
    replay_s = []
    for _ in range(replays):
        t0 = time.perf_counter()
        last = ex.apply(feeds)
        torch.cuda.synchronize()
        replay_s.append(time.perf_counter() - t0)
    h.check(ex.batch_fallbacks == 0,
            f"graph_batched {label}: {ex.batch_fallbacks} groups fell back per task")
    groups = ex.group_counts()
    want = {}
    for cls, (fn, mode) in kernel_of.items():
        by = want.setdefault(fn, {})
        row = groups.get(cls, {})
        for m, n in ((mode, row.get("per_task", 0)), (mode + "_b", row.get("batched", 0))):
            if n:
                by[m] = by.get(m, 0) + n
    per_call = {}
    for (fn, mode), n in ex.launches.items():
        if mode not in ("total", "members") and n:
            per_call.setdefault(fn, {})[mode] = n
    h.check(per_call == want, f"graph_batched {label}: launches a call {per_call}, "
            f"the plan's groups {want}")
    calls = 2 + replays  # the warm-up, the first call's replay, the replays
    wrappers = {fn.__name__: fn for fn in kernels._WRAPPERS}
    counted = {fn: {m: n for m, n in wrappers[fn].launches_by_mode.items() if n}
               for fn in want}
    h.check(counted == {fn: {m: n * calls for m, n in by.items()} for fn, by in want.items()},
            f"graph_batched {label}: {counted} launched over {calls} calls, "
            f"{want} a call")
    members = {fn: ex.launches.get((fn, "members"), 0) for fn in want}
    equal = all(torch.equal(first[k], ref_out[k]) and torch.equal(last[k], ref_out[k])
                for k in ref_out)
    diff = max((last[k].double() - ref_out[k].double()).abs().max().item() for k in ref_out)
    if exact:
        h.check(equal, f"graph_batched {label}: outputs differ from the unbatched "
                f"replay's (max abs {diff})")
    med = statistics.median(replay_s)
    h.say("graph_batched", path=label, tasks=tasks, plan_s=plan_s, first_call_s=first_s,
          capture_s=ex.capture_s, replay_s=replay_s, median_replay_s=med,
          unbatched_median_replay_s=ref_median_s, batched_over_unbatched=med / ref_median_s,
          host_ms_per_task=med / tasks * 1e3, groups=groups, launches_per_call=per_call,
          members_per_call=members, batch_fallbacks=ex.batch_fallbacks,
          stack_bytes_per_call=ex.stack_bytes, graph_pool_bytes=ex.graph_pool_bytes,
          equal_unbatched=equal, max_abs_diff_unbatched=diff, card=h.card)
    del first
    return ex, last, {fn: dict(wrappers[fn].launches_by_mode) for fn in want}


# -- the dense factorizations beyond dpotrf ------------------------------------
# sizes from the reference's own bench: the panel stage's N=32768 nb=512
# (bench.py:205-206) and the QR/LU stage's largest leg, N=16384
# (bench.py:2544); the tiled LU and QR at the dpotrf path's N=8192 nb=512
SEG_CHOL_N, SEG_NB, SEG_STRIP, SEG_CHOL_TAIL = 32768, 512, 4096, 4096
SEG_QRLU_N, SEG_LU_TAIL, SEG_QR_TAIL = 16384, 8192, 2048
SEG_SAMPLES = 256
# gates: bench.py:2227-2256 (the KMS oracle, f32 1e-3, bf16 storage 1e-2)
# and :2475-2497 (LU 1e-3, storage 1e-2; QR reconstruction and
# orthogonality 1e-3); the tiled LU at the reference test's f32 rtol
# (tests/collections/test_lu.py:43) and QR at _check_r's
# (tests/collections/test_qr.py:53)
TOL_SEG, TOL_SEG_STORAGE, TOL_TILED_LU, TOL_TILED_QR = 1e-3, 1e-2, 1e-4, 5e-3
# a card getrf tile against the rank-1 loop it replaces (f32 ulps over nb
# steps)
TOL_GETRF = 1e-4
TILED_REPLAYS = 2
# the task classes whose bodies launch the tiled path's hand kernel
TILED_KERNEL_CLASSES = {"lu": ("gemm",), "qr": ("unmqr", "tsmqr")}


def factorization_phases(h):
    """Segmented Cholesky (N=32768), segmented LU and QR (N=16384) through
    ``Context`` and the CUDA device module, ``WholeCholesky`` as the
    runtime-bypassing ceiling, then tiled LU and QR (N=8192) with the hand
    kernels through ``Context``, the native pump and ``GraphExecutor``.
    Each run is gated before its line prints.  ``h`` carries main's
    helpers (numpy, torch, the device, the card line, ``say``,
    ``check``, and ``profiled``: None, or with ``--profile`` the profile
    pass, which then runs each path once more under ``torch.profiler``);
    returns each gated run's B1/B2 launches per mode."""
    np, torch, dev, card, say, check = h.np, h.torch, h.dev, h.card, h.say, h.check
    profiled = h.profiled
    from parsec_tpu_torch import Context, tuning
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.dsl import GraphExecutor
    from parsec_tpu_torch.dsl.native_exec import NativeExecutor
    from parsec_tpu_torch.ops import (SegmentedCholesky, SegmentedLU, SegmentedQR,
                                      WholeCholesky, kernels, lu_ptg, lu_task_count,
                                      n_segments, qr_constants, qr_ptg, qr_task_count)
    from parsec_tpu_torch.ops.lu import getrf_cuda, getrf_plain

    launches = {}

    def counts():
        return {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                for fn in (kernels.matmul_update, kernels.matmul)}

    def only(fn_name, mode, n):
        """The launch counts of a run that launched ``n`` kernels of one
        B1/B2 mode and nothing else."""
        want = {fn.__name__: dict(dict.fromkeys(fn.launches_by_mode, 0), total=0)
                for fn in (kernels.matmul_update, kernels.matmul)}
        want[fn_name][mode] = want[fn_name]["total"] = n
        return want

    def timed(fn):
        gc.collect()  # each timed window starts with no garbage pending
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def cuda_module(ctx):
        d = next(d for d in ctx.devices if d.mca_name == "cuda")
        check(d.tdev.type == "cuda", f"CUDA module bound to {d.tdev}")
        return d

    # -- getrf's card body against the rank-1 loop it replaces ---------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    T = torch.randn((SEG_NB, SEG_NB), generator=gen, device=dev) \
        + SEG_NB * torch.eye(SEG_NB, device=dev)
    card_lu, plain_lu = getrf_cuda(T), getrf_plain(T)
    err = ((card_lu - plain_lu).abs().max() / plain_lu.abs().max()).item()
    check(err < TOL_GETRF, f"getrf: card body vs rank-1 loop {err} >= {TOL_GETRF}")
    say("getrf_tile", nb=SEG_NB, rel_err=err, tol=TOL_GETRF, card=card)
    del T, card_lu, plain_lu

    # -- segmented Cholesky, N=32768 ------------------------------------------
    n, nb = SEG_CHOL_N, SEG_NB
    # the KMS matrix rho^|i-j| (rho = 1/2) + 3 I, provably SPD, built on the
    # card strip by strip (bench.py:2213-2225)
    pristine = torch.empty((n, n), device=dev)
    cols = torch.arange(n, device=dev, dtype=torch.float32)
    for i0 in range(0, n, 2048):
        pristine[i0:i0 + 2048] = torch.exp2(-(cols[i0:i0 + 2048, None] - cols[None, :]).abs())
    pristine.diagonal().add_(3.0)
    del cols
    idx = torch.from_numpy(np.sort(np.random.default_rng(3).choice(
        n, SEG_SAMPLES, replace=False))).to(dev)

    def chol_gate(L):
        """Sampled reconstruction against the closed-form oracle: rows idx
        of L, masked to their lower triangle, times their transpose, held
        against the KMS entries (bench.py:2227-2256), in float64."""
        R = L[idx].double()  # gather first, upcast the 256 rows after
        R *= torch.arange(n, device=dev)[None, :] <= idx[:, None]
        d = (idx[:, None] - idx[None, :]).abs().double()
        S = torch.exp2(-d) + 3.0 * torch.eye(SEG_SAMPLES, device=dev, dtype=torch.float64)
        return ((R @ R.mT - S).abs().max() / 4.0).item()

    flops = n ** 3 / 3
    work = torch.empty_like(pristine)
    # the panel width's search (its own seeded SPD matrix, the runs in place
    # on the card); the driver built with nb="auto" below takes the winner
    # and factors the KMS matrix within the gate
    t0 = time.perf_counter()
    seg_doc = tuning.autotune_nb("dpotrf_seg", n, candidates=TUNE_NB, reps=1)
    tuning_line(h, seg_doc, time.perf_counter() - t0)
    walls = {}
    ctx = Context()
    try:
        cuda_dev = cuda_module(ctx)
        for label, kw, tol in (("f32_static", dict(specialize="static"), TOL_SEG),
                               ("f32_static", dict(specialize="static"), TOL_SEG),
                               ("f32_generic", dict(specialize="generic"), TOL_SEG),
                               ("bf16_storage", dict(bf16="storage"), TOL_SEG_STORAGE)):
            sc = SegmentedCholesky(ctx, n, nb, strip=SEG_STRIP, tail=SEG_CHOL_TAIL, **kw)
            if kw.get("bf16"):
                inp = pristine.to(torch.bfloat16)
            else:
                work.copy_(pristine)
                inp = work
            ptr, moved = inp.data_ptr(), (cuda_dev.stats["bytes_in"],
                                          cuda_dev.stats["bytes_out"])
            L, wall = timed(lambda: sc.run(inp))
            check(L.data_ptr() == ptr, f"segmented cholesky {label}: the matrix moved")
            check((cuda_dev.stats["bytes_in"], cuda_dev.stats["bytes_out"]) == moved,
                  f"segmented cholesky {label}: the matrix was copied host<->device")
            err = chol_gate(L)
            check(err < tol, f"segmented cholesky {label}: sampled error {err} >= {tol}")
            walls.setdefault(label, []).append(wall)
            say("segmented", path="cholesky", variant=label, N=n, nb=nb, strip=SEG_STRIP,
                tail=SEG_CHOL_TAIL, tasks=sc.nt_tasks, wall_s=wall,
                gflops=flops / wall / 1e9, host_ms_per_task=wall / sc.nt_tasks * 1e3,
                sampled_err=err, tol=tol, in_place=True, card=card)
            del L, inp
        sc = SegmentedCholesky(ctx, n, strip=SEG_STRIP, tail=SEG_CHOL_TAIL)
        check(sc.nb == seg_doc["best"], f"segmented cholesky nb=auto took {sc.nb}, "
              f"the winner is {seg_doc['best']}")
        work.copy_(pristine)
        L, wall = timed(lambda: sc.run(work))
        err = chol_gate(L)
        check(err < TOL_SEG, f"segmented cholesky nb=auto: sampled error {err} >= {TOL_SEG}")
        say("tuning_auto", path="segmented_cholesky", N=n, nb=sc.nb, tasks=sc.nt_tasks,
            wall_s=wall, gflops=flops / wall / 1e9, sampled_err=err, tol=TOL_SEG, card=card)
        del L
        if profiled:
            sc = SegmentedCholesky(ctx, n, nb, strip=SEG_STRIP, tail=SEG_CHOL_TAIL)
            work.copy_(pristine)
            profiled("seg_cholesky_f32_static", lambda: (timed(lambda: sc.run(work))[1], {}))
    finally:
        ctx.fini()
    wc = WholeCholesky(n, nb, strip=SEG_STRIP, device=dev)
    for rep in range(2):
        work.copy_(pristine)
        L, wall = timed(lambda: wc.run(work))
        err = chol_gate(L)
        check(err < TOL_SEG, f"whole cholesky: sampled error {err} >= {TOL_SEG}")
        walls.setdefault("whole", []).append(wall)
        del L
    if profiled:
        work.copy_(pristine)
        profiled("whole_cholesky_f32", lambda: (timed(lambda: wc.run(work))[1], {}))
    runtime = min(walls["f32_static"])
    whole = min(walls["whole"])
    say("segmented", path="cholesky_whole", N=n, nb=nb, strip=SEG_STRIP,
        walls_s=walls["whole"], gflops=flops / whole / 1e9, sampled_err=err,
        runtime_wall_s=runtime, runtime_over_whole=runtime / whole, card=card)
    del pristine, work
    torch.cuda.empty_cache()

    # -- segmented LU and QR, N=16384 -----------------------------------------
    n = SEG_QRLU_N
    gen.manual_seed(12)
    A_lu = torch.randn((n, n), generator=gen, device=dev)
    A_lu.diagonal().add_(float(n))  # diagonally dominant: nopiv-class input
    gen.manual_seed(11)
    A_qr = torch.randn((n, n), generator=gen, device=dev)
    idx = torch.from_numpy(np.sort(np.random.default_rng(13).choice(
        n, SEG_SAMPLES, replace=False))).to(dev)
    rows = torch.arange(n, device=dev)
    ref_lu = A_lu[idx][:, idx].double()

    def lu_gate(M):
        """Sampled L[idx, :] @ U[:, idx] against A[idx, idx], relative to
        the sample's largest entry (bench.py:2487-2495), in float64."""
        Lr = M[idx].double() * (rows[None, :] < idx[:, None]) \
            + (rows[None, :] == idx[:, None])
        Uc = M[:, idx].double() * (rows[:, None] <= idx[None, :])
        return ((Lr @ Uc - ref_lu).abs().max() / ref_lu.abs().max()).item()

    # split_f32 launches of one fused static run: one per trailing strip
    n_split = sum(-(-(n - k0) // SEG_STRIP) for k0 in range(nb, n, nb))
    work = torch.empty_like(A_lu)
    ctx = Context()
    try:
        cuda_dev = cuda_module(ctx)
        for label, kw, tol in (("f32", {}, TOL_SEG),
                               ("fused_split", dict(fused_update=True), TOL_SEG),
                               ("bf16_storage", dict(bf16="storage"), TOL_SEG_STORAGE)):
            sl = SegmentedLU(ctx, n, nb, strip=SEG_STRIP, tail=SEG_LU_TAIL,
                             specialize="static", **kw)
            if kw.get("bf16"):
                inp = A_lu.to(torch.bfloat16)
            else:
                work.copy_(A_lu)
                inp = work
            ptr = inp.data_ptr()
            kernels.reset_counts()
            M, wall = timed(lambda: sl.run(inp))
            got = counts()
            want = only("matmul_update", "split_nt", n_split if kw.get("fused_update") else 0)
            check(got == want, f"segmented LU {label}: launches {got}, expected {want}")
            launches[f"seg_lu_{label}"] = got
            check(M.data_ptr() == ptr, f"segmented LU {label}: the matrix moved")
            err = lu_gate(M)
            check(err < tol, f"segmented LU {label}: sampled error {err} >= {tol}")
            # the fused update's copies: each strip out and back (R x w
            # read + written twice) and the U-row slice made contiguous
            copy_bytes = 4 * sum(4 * (n - k0) * min(SEG_STRIP, n - c0) + 2 * nb * min(SEG_STRIP, n - c0)
                                 for k0 in range(nb, n, nb) for c0 in range(k0, n, SEG_STRIP))
            say("segmented", path="lu", variant=label, N=n, nb=nb, strip=SEG_STRIP,
                tail=SEG_LU_TAIL, specialize="static", tasks=sl.nt_tasks, wall_s=wall,
                gflops=2 / 3 * n ** 3 / wall / 1e9, host_ms_per_task=wall / sl.nt_tasks * 1e3,
                sampled_err=err, tol=tol, launches=got,
                strip_copy_bytes=copy_bytes if kw.get("fused_update") else 0, card=card)
            del M, inp
        if profiled:
            sl = SegmentedLU(ctx, n, nb, strip=SEG_STRIP, tail=SEG_LU_TAIL,
                             specialize="static", fused_update=True)
            work.copy_(A_lu)
            profiled("seg_lu_fused_split", lambda: (timed(lambda: sl.run(work))[1], {}))
        del A_lu, ref_lu
        sq = SegmentedQR(ctx, n, nb, strip=SEG_STRIP, tail=SEG_QR_TAIL)
        work.copy_(A_qr)
        kernels.reset_counts()
        (Q, R), wall = timed(lambda: sq.run(work))
        check(counts() == only("matmul", "f32", 0), f"segmented QR: launches {counts()}")
        check(Q.data_ptr() == work.data_ptr(), "segmented QR: the matrix moved")
        rec = Q.double() @ R[:, idx].double()
        ref = A_qr[:, idx].double()
        rec_err = ((rec - ref).abs().max() / ref.abs().max()).item()
        qs = Q[:, idx].double()
        orth = (qs.mT @ qs - torch.eye(SEG_SAMPLES, device=dev, dtype=torch.float64)
                ).abs().max().item()
        del rec, ref, qs, Q, R
        check(rec_err < TOL_SEG and orth < TOL_SEG,
              f"segmented QR: reconstruction {rec_err}, orthogonality {orth} (>= {TOL_SEG})")
        say("segmented", path="qr", N=n, nb=nb, strip=SEG_STRIP, tail=SEG_QR_TAIL,
            specialize="generic", tasks=sq.nt_tasks, wall_s=wall,
            gflops=4 / 3 * n ** 3 / wall / 1e9, host_ms_per_task=wall / sq.nt_tasks * 1e3,
            rec_err=rec_err, orth_err=orth, tol=TOL_SEG, card=card)
        if profiled:
            work.copy_(A_qr)
            profiled("seg_qr", lambda: (timed(lambda: sq.run(work))[1], {}))
    finally:
        ctx.fini()
    del A_qr, work
    torch.cuda.empty_cache()

    # -- tiled LU and QR, N=8192, hand kernels: dynamic, pump, GraphExecutor -
    n = N
    nt = n // NB
    gen.manual_seed(21)
    A_lu = (torch.randn((n, n), generator=gen, device=dev)
            + n * torch.eye(n, device=dev)).cpu().numpy()
    gen.manual_seed(22)
    A_qr = torch.randn((n, n), generator=gen, device=dev).cpu().numpy()
    idx = torch.from_numpy(np.sort(np.random.default_rng(14).choice(
        n, SEG_SAMPLES, replace=False))).to(dev)
    rows = torch.arange(n, device=dev)

    def tiled_lu_gate(P):
        Pd = torch.from_numpy(P).to(dev)
        Lr = Pd[idx].double() * (rows[None, :] < idx[:, None]) + (rows[None, :] == idx[:, None])
        Uc = Pd[:, idx].double() * (rows[:, None] <= idx[None, :])
        ref = torch.from_numpy(A_lu).to(dev)[idx][:, idx].double()
        return ((Lr @ Uc - ref).abs().max() / ref.abs().max()).item()

    def tiled_qr_gate(P):
        """A^T A = R^T R on the sampled columns (R upper: its zeroed lower
        triangle checked exactly), relative to the sample's largest
        entry."""
        Rd = torch.from_numpy(P).to(dev)
        check(bool((Rd.tril(-1) == 0).all()), "tiled QR: R has entries below the diagonal")
        Rs = Rd[:, idx].double()
        As = torch.from_numpy(A_qr).to(dev)[:, idx].double()
        ref = As.mT @ As
        return ((Rs.mT @ Rs - ref).abs().max() / ref.abs().max()).item()

    tiled = (("lu", lu_ptg, lambda A: {}, A_lu, tiled_lu_gate, TOL_TILED_LU,
              lu_task_count(nt), ("matmul_update", "f32_nt", (nt - 1) * nt * (2 * nt - 1) // 6),
              2 / 3 * n ** 3),
             ("qr", qr_ptg, qr_constants, A_qr, tiled_qr_gate, TOL_TILED_QR,
              qr_task_count(nt), ("matmul", "f32_nt", nt * (nt - 1) // 2
                                  + (nt - 1) * nt * (2 * nt - 1) // 6),
              4 / 3 * n ** 3))
    for path, make_ptg, consts, A0, gate, tol, ntasks, (fn_name, mode, n_mm), fl in tiled:
        def pool():
            A = TiledMatrix(n, n, NB, NB, name="A", dtype=np.float32).from_array(A0)
            tp = make_ptg(use_cuda=True, use_cpu=False, use_kernels=True).taskpool(
                NT=A.mt, A=A, **consts(A))
            return A, tp

        def dynamic():
            """One run through Context: (matrix, wall, launches, device
            stats, seconds of ctx.fini(): the write-back home)."""
            A, tp = pool()
            ctx = Context()
            try:
                cuda_dev = cuda_module(ctx)
                kernels.reset_counts()

                def run():
                    ctx.add_taskpool(tp)
                    return tp.wait(timeout=600)

                ok, wall = timed(run)
                got = counts()
            finally:
                t0 = time.perf_counter()
                ctx.fini()
                flush = time.perf_counter() - t0
            check(ok, f"tiled {path}: taskpool failed ({tp.fail_reason})")
            return A, wall, got, dict(cuda_dev.stats), flush

        def pump():
            """One run through the native pump: (matrix, tasks, run wall,
            capture + build s, launches, close() s)."""
            A, tp = pool()
            t0 = time.perf_counter()
            ex = NativeExecutor(tp, native_device=True)
            setup = time.perf_counter() - t0
            try:
                kernels.reset_counts()
                ran, wall = timed(ex.run)
                got = counts()
            finally:
                t0 = time.perf_counter()
                ex.close()
                flush = time.perf_counter() - t0
            return A, ran, wall, setup, got, flush

        want = only(fn_name, mode, n_mm)
        A, wall, got, stats, _flush = dynamic()
        check(stats["executed_tasks"] == ntasks,
              f"tiled {path}: {stats['executed_tasks']} tasks, expected {ntasks}")
        check(got == want, f"tiled {path}: launches {got}, expected {want}")
        launches[f"tiled_{path}_dynamic"] = got
        dyn = A.to_array()
        err = gate(dyn)
        check(err < tol, f"tiled {path}: sampled error {err} >= {tol}")
        say("tiled", path=path, runtime="dynamic", N=n, nb=NB, tasks=ntasks, wall_s=wall,
            gflops=fl / wall / 1e9, host_ms_per_task=wall / ntasks * 1e3,
            sampled_err=err, tol=tol, launches=got, card=card)
        dyn_wall = wall
        A, ran, wall, setup, got, _flush = pump()
        check(ran == ntasks, f"tiled {path} pump: {ran} tasks, expected {ntasks}")
        check(got == want, f"tiled {path} pump: launches {got}, expected {want}")
        launches[f"tiled_{path}_pump"] = got
        check(np.array_equal(A.to_array(), dyn),
              f"tiled {path} pump: the factor differs from the dynamic path's")
        say("tiled", path=path, runtime="pump", N=n, nb=NB, tasks=ran, wall_s=wall,
            capture_build_s=setup, gflops=fl / wall / 1e9,
            host_ms_per_task=wall / ran * 1e3, setup_plus_wall_s=setup + wall,
            dynamic_wall_s=dyn_wall, same_window_ratio=(setup + wall) / dyn_wall,
            equal_dynamic=True, card=card)
        # GraphExecutor: the first call (warm-up, capture, replay), then
        # TILED_REPLAYS replays
        A, tp = pool()
        ex = GraphExecutor(tp)
        feeds = {k: torch.from_numpy(A.data_of(*k[1]).newest_copy().payload).to(dev)
                 for k in ex.input_keys}
        kernels.reset_counts()
        first, first_s = timed(lambda: ex.apply(feeds))
        replay_s = [timed(lambda: ex.apply(feeds))[1] for _ in range(TILED_REPLAYS)]
        got = counts()
        want_graph = {f: {m: c * (2 + TILED_REPLAYS) for m, c in by.items()}
                      for f, by in want.items()}
        check(got == want_graph, f"tiled {path} graph: launches {got}, expected {want_graph}")
        launches[f"tiled_{path}_graph"] = got
        out = np.zeros((n, n), np.float32)
        for (_c, (i, j)), tile in first.items():
            out[i * NB:(i + 1) * NB, j * NB:(j + 1) * NB] = tile.cpu().numpy()
        err = gate(out)
        check(err < tol, f"tiled {path} graph: sampled error {err} >= {tol}")
        med = statistics.median(replay_s)
        say("tiled", path=path, runtime="graph", N=n, nb=NB, tasks=ntasks,
            first_call_s=first_s, capture_s=ex.capture_s, replay_s=replay_s,
            gflops=fl / med / 1e9, host_ms_per_task=med / ntasks * 1e3,
            sampled_err=err, tol=tol, equal_dynamic=bool(np.array_equal(out, dyn)),
            graph_pool_bytes=ex.graph_pool_bytes, card=card)
        # the same DAG level-batched: each B1/B2 group one launch; its
        # batched library solves and QRs may round apart from the
        # per-tile calls, so the factor passes the path's gate and its
        # distance to the unbatched replay's is printed
        b_ex, b_last, h.batched_launches[f"tiled_{path}"] = batched_graph(
            h, f"tiled_{path}", tp, feeds, first, med,
            {cls: (fn_name, mode) for cls in TILED_KERNEL_CLASSES[path]}, ntasks,
            exact=False, replays=TILED_REPLAYS)
        out = np.zeros((n, n), np.float32)
        for (_c, (i, j)), tile in b_last.items():
            out[i * NB:(i + 1) * NB, j * NB:(j + 1) * NB] = tile.cpu().numpy()
        err = gate(out)
        check(err < tol, f"tiled {path} graph_batched: sampled error {err} >= {tol}")
        say("tiled", path=path, runtime="graph_batched", N=n, nb=NB, sampled_err=err, tol=tol,
            card=card)
        if profiled:
            # the window a user waits for: the run plus its write-back home
            # (the pump's also its capture + build)
            def dyn_window():
                _A, wall, _got, stats, flush = dynamic()
                return wall + flush, dict(wall_s=wall, flush_s=flush,
                                          bytes_in=stats["bytes_in"],
                                          bytes_out=stats["bytes_out"])

            def pump_window():
                _A, _ran, wall, setup, _got, flush = pump()
                return setup + wall + flush, dict(capture_build_s=setup, wall_s=wall,
                                                  flush_s=flush)

            profiled(f"tiled_{path}", dyn_window)
            profiled(f"tiled_{path}_native", pump_window)
            profiled(f"graph_tiled_{path}", lambda: (timed(lambda: ex.apply(feeds))[1], {}))
            profiled(f"graph_batched_tiled_{path}",
                     lambda: (timed(lambda: b_ex.apply(feeds))[1], {}))
        del ex, b_ex, b_last, feeds, first, out, dyn, A
        torch.cuda.empty_cache()
    return launches


# -- the autotuner, the program cache and fusion's partition cache -----------
# the sweeps' candidates: the attention blocks around the path's 512, and
# the panel and tile widths around nb=512
# -- the array front end: one mixed program through every runtime --------

#: the array phase's acceptance program (bench.py:137-138's dpotrf size):
#: C = (A @ A.T + B).cholesky(), x = C.solve(b) with A N x N standard
#: normal, B = N I and b N x ARR_NRHS, all in ARR_NB tiles
ARR_N, ARR_NB, ARR_NRHS = N, NB, 1024
ARR_SEED = 19
ARR_REPLAYS = 5
#: reductions against float64, relative
TOL_ARR_REDUCE = 1e-9


def array_task_counts(nt: int, nc: int) -> dict:
    """Tasks a class prefix of the mixed program at ``nt`` tile rows and
    ``nc`` rhs tile columns: transpose, the matmul's init and k-chain, the
    add, the Cholesky's four classes, the solve's three (no ``arr_cp``:
    the add is a single-consumer private producer)."""
    return {"arr_tr": nt * nt, "arr_mi": nt * nt, "arr_mm": (nt - 1) * nt * nt,
            "arr_ew": nt * nt, "arr_po": nt, "arr_ts": nt * (nt - 1) // 2,
            "arr_sy": nt * (nt - 1) // 2, "arr_gm": nt * (nt - 1) * (nt - 2) // 6,
            "arr_sv": nt * nc, "arr_sb": (nt - 1) * nc, "arr_su": nt * (nt - 1) // 2 * nc}


def array_phase(h):
    """The array front end (``parsec_tpu_torch.array``) on the card: the
    reference's acceptance program ``C = (A @ A.T + B).cholesky(); x =
    C.solve(b)`` at N=8192 nb=512 f32 (A standard normal from seed
    ``ARR_SEED``, B = N I, b 8192 x 1024), lowered into ONE taskpool of
    5726 tasks (the class counts checked against the pool's).

    1. Dynamic: ``x.compute(ctx, others=[C], use_cpu=False)`` on a
       ``Context`` with the CUDA module, every task on it.
    2. Gates on the card in float64: ‖C·Cᵀ − S‖max/‖S‖max < 1e-3 for S =
       A·Aᵀ + B, the upper triangle of C exactly zero, ‖C·x − b‖max/‖b‖max
       < 1e-3.
    3. The native pump (``run_native(native_device=True)``): C and x
       ``torch.equal`` to the dynamic run's.
    4. ``GraphExecutor``: the first call, then the median of
       ``ARR_REPLAYS`` replays, ``torch.equal`` to the dynamic run; a
       rebuilt same-shaped program's executor is a program-cache hit that
       captures nothing, with the same bits.
    5. Fusion: ``((A + B) * 0.5 - B).scale(2.0)`` (A, B standard normal)
       with ``runtime_fusion`` off and ``auto``: ``torch.equal``,
       ``fused_submits`` > 0 under ``auto`` and 0 under off, within f32
       rounding (2 eps of |A| + |B|) of the float64 formula; the fused
       result's ``sum`` in the same context, its tiles newest on the card
       (the host-only partials stage them home), within 1e-9 of its host
       copy's float64 sum.
    6. ``A.sum(ctx)`` and ``A.norm(ctx)`` within 1e-9 relative of float64.
    7. Serving: the program as a tenant job of a ``RuntimeService`` that
       attaches the CUDA module, ``torch.equal`` to the dynamic run.
    8. ``pa.counters()`` grew by the programs lowered and pools built, and
       no hand-written kernel launched over the phase (B1–B5 +0): the
       array's device bodies are library calls, as the reference's are XLA
       calls.

    One ``array`` line a run: wall, tasks, tasks/s, host ms a task, the
    card; the replay's first call and median."""
    np, torch, dev, card, say, check = h.np, h.torch, h.dev, h.card, h.say, h.check
    import re

    from parsec_tpu_torch import Context, compile_cache, mca_param
    from parsec_tpu_torch import array as pa
    from parsec_tpu_torch.dsl import GraphExecutor
    from parsec_tpu_torch.ops import kernels
    from parsec_tpu_torch.serve import RuntimeService

    t_phase = time.perf_counter()
    counters0 = pa.counters()
    launches0 = kernels.launch_counts()
    nt, nc = ARR_N // ARR_NB, ARR_NRHS // ARR_NB
    want_counts = array_task_counts(nt, nc)
    n_tasks = sum(want_counts.values())
    rng = np.random.default_rng(ARR_SEED)
    G = rng.standard_normal((ARR_N, ARR_N), dtype=np.float32)
    H = np.eye(ARR_N, dtype=np.float32) * ARR_N
    rhs = rng.standard_normal((ARR_N, ARR_NRHS), dtype=np.float32)
    #: programs lowered and pools built by the phase, as counted here
    expect = {"programs_lowered": 0, "taskpools_built": 0}

    def expect_(lowered, built):
        expect["programs_lowered"] += lowered
        expect["taskpools_built"] += built

    def arrays():
        """Fresh leaves and the lazy mixed program over them: (A, C, x)."""
        A = pa.from_numpy(G, ARR_NB)
        C = (A @ A.T + pa.from_numpy(H, ARR_NB)).cholesky()
        return A, C, C.solve(pa.from_numpy(rhs, ARR_NB))

    def program():
        """A fresh build of the mixed program, lowered: (C, x, program)."""
        _A, C, x = arrays()
        expect_(1, 0)
        return C, x, pa.lower([x, C], use_cpu=False)

    def line(run, wall, tasks, **extra):
        say("array", run=run, wall_s=wall, tasks=tasks, tasks_per_s=tasks / wall,
            host_ms_per_task=1e3 * wall / tasks, card=card, **extra)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- 1. dynamic ------------------------------------------------------------
    _C, _x, twin = program()  # the program lowered apart: its class counts
    counts = {}
    for name, pc in twin.ptg.classes.items():
        key = re.sub(r"\d+$", "", name)
        counts[key] = counts.get(key, 0) + sum(1 for _ in pc.param_space(twin.constants))
    check(counts == want_counts, f"array: the program's classes {counts}, "
                                 f"expected {want_counts}")
    if (ARR_N, ARR_NB, ARR_NRHS) == (8192, 512, 1024):
        check(n_tasks == 5726, f"array: {n_tasks} tasks, expected 5726")
    del _C, _x, twin
    A, C, x = arrays()
    expect_(1, 1)  # compute() lowers and builds its own
    with Context() as ctx:
        cuda_dev = next(d for d in ctx.devices if d.mca_name == "cuda")
        before = dict(cuda_dev.stats)
        _, wall = timed(lambda: x.compute(ctx, others=[C], use_cpu=False))
        stats = device_stats(cuda_dev)
        executed = stats["executed_tasks"] - before["executed_tasks"]
        check(executed == n_tasks,
              f"array dynamic: {executed} tasks on the CUDA module, expected {n_tasks}")
        check(stats["wb_sync_fallbacks"] == 0, "array dynamic: a synchronous write-back")
        C_np, x_np = C.to_numpy(), x.to_numpy()
    line("dynamic", wall, n_tasks, cuda_tasks=executed, **pipeline_fields(stats))
    h.arr_out.update(C=C_np, x=x_np, wall=wall)  # the multirank phase's oracle

    # -- 2. gates on the card in float64 --------------------------------------
    Cg = torch.from_numpy(C_np).to(dev).double()
    Ag = torch.from_numpy(G).to(dev).double()
    S = Ag @ Ag.mT + ARR_N * torch.eye(ARR_N, dtype=torch.float64, device=dev)
    recon = ((Cg @ Cg.mT - S).abs().max() / S.abs().max()).item()
    upper = int(torch.count_nonzero(torch.triu(Cg, 1)).item())
    bg = torch.from_numpy(rhs).to(dev).double()
    resid = ((Cg @ torch.from_numpy(x_np).to(dev).double() - bg).abs().max()
             / bg.abs().max()).item()
    check(recon < 1e-3, f"array: |C C^T - S|/|S| = {recon} >= 1e-3")
    check(upper == 0, f"array: {upper} nonzeros above C's diagonal")
    check(resid < 1e-3, f"array: |C x - b|/|b| = {resid} >= 1e-3")
    say("array_gates", recon_err=recon, solve_resid=resid, upper_nonzeros=upper,
        tol=1e-3, card=card)
    del Cg, Ag, S, bg
    torch.cuda.empty_cache()

    def same(C2, x2, what):
        check(np.array_equal(C2.to_numpy(), C_np) and np.array_equal(x2.to_numpy(), x_np),
              f"array {what}: C or x differs from the dynamic run's")

    # -- 3. the native pump ----------------------------------------------------
    C2, x2, prog = program()
    expect_(0, 1)
    _, wall = timed(lambda: prog.run_native(native_device=True))
    same(C2, x2, "pump")
    line("pump", wall, n_tasks, equal_dynamic=True)
    del C2, x2, prog

    # -- 4. GraphExecutor: first call, replays, a rebuilt program's hit -------
    def graph_of(prog):
        expect_(0, 1)
        tp = prog.taskpool()
        prog.finalize()
        ex = GraphExecutor(tp)
        return tp, ex

    C3, x3, prog = program()
    (tp3, ex), plan_s = timed(lambda: graph_of(prog))
    feeds = {(c, k): torch.from_numpy(np.asarray(
        tp3.constants[c].data_of(*k).newest_copy().payload)).to(dev)
        for (c, k) in ex.input_keys}
    cache = compile_cache.default_cache()
    snap0 = cache.snapshot()
    out, first_s = timed(lambda: ex.apply(feeds))
    replays = [timed(lambda: ex.apply(feeds))[1] for _ in range(ARR_REPLAYS)]
    names = {id(v): k for k, v in tp3.constants.items()}
    c_name, x_name = names[id(C3._node.coll)], names[id(x3._node.coll)]

    def graph_equal(outs):
        for (cname, (i, j)), t in outs.items():
            ref = {c_name: C_np, x_name: x_np}.get(cname)
            if ref is None:
                continue
            tile = ref[i * ARR_NB:(i + 1) * ARR_NB, j * ARR_NB:(j + 1) * ARR_NB]
            if not torch.equal(t.cpu(), torch.from_numpy(np.ascontiguousarray(tile))):
                return False
        return True

    check(graph_equal(out), "array graph: a C or x tile differs from the dynamic run's")
    line("graph", statistics.median(replays), n_tasks, plan_s=plan_s, first_call_s=first_s,
         replay_s=replays, median_replay_s=statistics.median(replays),
         capture_s=ex.capture_s, graph_pool_bytes=ex.graph_pool_bytes, equal_dynamic=True)
    C4, x4, prog4 = program()
    tp4, ex2 = graph_of(prog4)
    check(ex2.input_keys == ex.input_keys, "array graph: the rebuilt program's inputs differ")
    snap1 = cache.snapshot()
    out2, first2_s = timed(lambda: ex2.apply(feeds))
    snap2 = cache.snapshot()
    check(ex2.cache_hit and snap2.get("captures") == snap1.get("captures")
          and snap2["hits"] == snap1["hits"] + 1,
          f"array graph rebuilt: cache {snap1} -> {snap2}, hit {ex2.cache_hit}")
    check(graph_equal(out2), "array graph rebuilt: a tile differs from the dynamic run's")
    say("array_program_cache", first_call_s=first2_s, first_executor_first_call_s=first_s,
        capture_s=ex2.capture_s, captures=snap2.get("captures", 0) - snap0.get("captures", 0),
        cache=snap2, card=card)
    del out, out2, ex, ex2, tp3, tp4, feeds, C3, x3, C4, x4, prog, prog4
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5. fusion off / auto on the elementwise chain -------------------------
    F = np.random.default_rng(ARR_SEED + 1).standard_normal((ARR_N, ARR_N), dtype=np.float32)
    chain = {}
    for mode in ("off", "auto"):
        with mca(mca_param, "runtime", "fusion", mode):
            out = ((pa.from_numpy(G, ARR_NB) + pa.from_numpy(F, ARR_NB)) * 0.5
                   - pa.from_numpy(F, ARR_NB)).scale(2.0)
            expect_(2, 2)  # the chain and its sum
            with Context() as ctx:
                cuda_dev = next(d for d in ctx.devices if d.mca_name == "cuda")
                before = dict(cuda_dev.stats)
                _, wall = timed(lambda: out.compute(ctx, use_cpu=False))
                delta = {k: cuda_dev.stats[k] - before[k]
                         for k in ("executed_tasks", "fused_submits", "fused_tasks")}
                dev_sum = out.sum(ctx)
            res = out.to_numpy()
        chain[mode] = res
        host_sum = float(res.astype(np.float64).sum())
        check(abs(dev_sum - host_sum) <= TOL_ARR_REDUCE * abs(host_sum),
              f"array fusion {mode}: sum {dev_sum} vs {host_sum}")
        line(f"fusion_{mode}", wall, 4 * nt * nt, **delta, sum=dev_sum)
        check((delta["fused_submits"] > 0) == (mode == "auto"),
              f"array fusion {mode}: fused_submits {delta['fused_submits']}")
    check(np.array_equal(chain["off"], chain["auto"]), "array fusion: auto differs from off")
    Gg, Fg = torch.from_numpy(G).to(dev).double(), torch.from_numpy(F).to(dev).double()
    want = ((Gg + Fg) * 0.5 - Fg) * 2.0
    err = (torch.from_numpy(chain["auto"]).to(dev).double() - want).abs().max().item()
    bound = 2 * float(np.finfo(np.float32).eps) * (Gg.abs() + Fg.abs()).max().item()
    check(err <= bound, f"array fusion: |out - f64| = {err} > {bound}")
    say("array_fusion_gate", max_abs_err=err, bound=bound, card=card)
    del chain, Fg, want, F

    # -- 6. reductions ----------------------------------------------------------
    expect_(2, 2)
    with Context() as ctx:
        (s, nrm), wall = timed(lambda: (A.sum(ctx), A.norm(ctx)))
    s64, n64 = Gg.sum().item(), Gg.norm().item()
    check(abs(s - s64) <= TOL_ARR_REDUCE * abs(s64) and abs(nrm - n64) <= TOL_ARR_REDUCE * n64,
          f"array reductions: sum {s} vs {s64}, norm {nrm} vs {n64}")
    line("reductions", wall, 2 * nt * nt, sum=s, sum_f64=s64, norm=nrm, norm_f64=n64)
    del Gg

    # -- 7. served as a tenant job ---------------------------------------------
    C5, x5, prog = program()
    with RuntimeService() as sv:
        check(any(d.mca_name == "cuda" for d in sv.context.devices),
              "array serve: the service attached no CUDA module")
        sv.tenant("arrays", weight=1)
        expect_(0, 1)
        tp = prog.taskpool()
        ok, wall = timed(lambda: sv.submit("arrays", tp).wait(timeout=600))
        check(ok, f"array serve: the job did not finish ({tp.fail_reason})")
        prog.finalize()
        same(C5, x5, "serve")
    line("serve", wall, n_tasks, tenant=tp.progress()["tenant"], equal_dynamic=True)
    del C5, x5, prog, tp

    # -- 8. counters and launches ----------------------------------------------
    counters1 = pa.counters()
    grew = {k: counters1[k] - counters0[k] for k in counters1}
    check(all(grew[k] == n for k, n in expect.items()) and grew["classes_generated"] > 0,
          f"array counters grew {grew}, expected {expect}")
    moved = {k: n - launches0.get(k, 0) for k, n in kernels.launch_counts().items()
             if n != launches0.get(k, 0)}
    check(not moved, f"array: hand-written kernels launched over the phase: {moved}")
    say("array_phase", seconds=time.perf_counter() - t_phase, counters=counters1,
        counters_grew=grew, kernel_launches_moved=moved, recon_err=recon,
        solve_resid=resid, tasks=n_tasks, card=card)


#: the multirank phase: ranks a run, their process grid, worker streams a
#: rank (4 ranks x 2 = the one-rank context's 8), the abort's time limit
MR_GRIDS = {4: (2, 2), 2: (1, 2)}
MR_CORES = 2
MR_ABORT_S = 60.0
# the watched run: the watchdog's poll (its heartbeat period) and the clock
# re-sync interval; the stall window stays runtime_watchdog_window's
MR_POLL_S, MR_RESYNC_S = 0.1, 0.5
# engine workers of the no-op dispatch runs over the dpotrf DAG
MR_NOOP_THREADS = (1, 2, 8)


def rank_cuda_module(h, ctx, r, label):
    """Rank r's CUDA module, checked to be bound to ``cuda:0``."""
    d = next(d for d in ctx.devices if d.mca_name == "cuda")
    h.check(d.tdev.type == h.dev.type and d.tdev.index in (None, 0),
            f"{label} rank {r}: CUDA module bound to {d.tdev}")
    return d


def rank_mesh(h, nranks, label):
    """``nranks`` ranks in one process: one ``Context(rank=r, nranks=n,
    comm=ces[r])`` a rank over one ``InprocFabric``; returns the engines,
    the contexts and their CUDA modules."""
    from parsec_tpu_torch import Context
    from parsec_tpu_torch.comm import InprocFabric

    ces = InprocFabric(nranks).endpoints()
    ctxs = [Context(nb_cores=MR_CORES, rank=r, nranks=nranks, comm=ces[r])
            for r in range(nranks)]
    return ces, ctxs, [rank_cuda_module(h, c, r, label) for r, c in enumerate(ctxs)]


def drive_ranks(h, items, per_rank, label, timeout=600.0):
    """Run ``per_rank(r, items[r])`` on one thread a rank, all started
    together; returns each rank's (result, seconds from the common start)
    and the whole run's wall (to the card's idle)."""
    import threading

    out = [None] * len(items)
    errors = []
    t0 = time.perf_counter()

    def worker(r):
        try:
            res = per_rank(r, items[r])
            out[r] = (res, time.perf_counter() - t0)
        except BaseException as e:  # reported by the check below
            errors.append((r, repr(e)))

    ts = [threading.Thread(target=worker, args=(r,), name=f"{label}-rank{r}")
          for r in range(len(items))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout + 60)
    h.torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h.check(not errors and not any(t.is_alive() for t in ts),
            f"{label}: rank errors {errors}")
    return out, wall


def multirank_phase(h):
    """The cross-rank core (``parsec_tpu_torch.comm``) on the card: N ranks
    in one process, each a full ``Context(rank=r, nranks=N, comm=ces[r])``
    over one ``InprocFabric(N)``, each rank driven from its own thread (the
    reference's ``run_ranks``), every rank's CUDA module bound to
    ``cuda:0`` (``rank % device_count`` on a one-card host) with its own
    automatic budget.  Runs, each on a fresh mesh:

    1. ``cholesky_ptg`` ``kernels`` and ``kernels_trtri`` at 4 ranks on a
       2x2 ``TwoDimBlockCyclic``, and ``kernels`` at 2 ranks on a 1x2 grid:
       N=8192 nb=512 f32, the one-rank dynamic runs' matrix (not cut).
       The factor assembled from the ranks' home tiles is ``torch.equal``
       to the one-rank dynamic factor; ‖LLᵀ − S‖max/‖S‖max < 1e-3; B1
       +680 (B2 +120 with trtri); every rank executed device tasks and
       sent activations; every rank that received a tile counted
       ``bytes_d2d`` > 0, and its ``bytes_in`` is exactly its own home
       tiles (and its trtri's NEW tiles): no cross-rank tile came through
       the host.
    2. The same 4-rank dpotrf through DTD (``insert_dpotrf``, shadow tasks
       across ranks, ``flush_all`` home): ``torch.equal``, B1 +680.
    3. The 4-rank ``kernels`` run under ``termdet="fourcounter"``: equal,
       and every rank's pool terminated by the wave.
    4. The array program ``C = (A @ A.T + B).cholesky(); x = C.solve(b)``
       at 4 ranks (2x2): C and x ``torch.equal`` to the ``array`` phase's
       one-rank result; B1–B5 +0.
    5. A body raising on rank 3 of a 4-rank dpotrf: every rank's ``wait``
       returns False within ``MR_ABORT_S``; each context then runs a small
       4-rank dpotrf to the right factor.

    One ``multirank`` line a run."""
    np, torch, dev, card, say, check = h.np, h.torch, h.dev, h.card, h.say, h.check
    from parsec_tpu_torch import DEV_CPU
    from parsec_tpu_torch import array as pa
    from parsec_tpu_torch.comm.termdet_fourcounter import TermDetFourCounter
    from parsec_tpu_torch.datadist import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.dtd import DTDTaskpool
    from parsec_tpu_torch.multirank import run_multirank_perf
    from parsec_tpu_torch.ops import cholesky_ptg, dpotrf_task_count, insert_dpotrf, kernels

    import urllib.request

    t_phase = time.perf_counter()
    nt = N // NB
    h.mr_walls, h.mr_acts = {}, {}
    S64 = torch.from_numpy(h.S).to(dev).double()
    s_max = S64.abs().max().item()

    mesh = functools.partial(rank_mesh, h, label="multirank")
    drive = functools.partial(drive_ranks, h, label="multirank")
    cuda_of = functools.partial(rank_cuda_module, h, label="multirank")

    def matrix(nranks, r):
        p, q = MR_GRIDS[nranks]
        return TwoDimBlockCyclic(N, N, NB, NB, p=p, q=q, myrank=r, name="A",
                                 dtype=np.float32).from_array(h.S)

    def assemble(mats):
        out = np.zeros((N, N), np.float32)
        for A in mats:
            for (i, j) in A.local_tiles():
                out[i * NB:(i + 1) * NB, j * NB:(j + 1) * NB] = np.asarray(
                    A.data_of(i, j).newest_copy().payload)
        return out

    def b1b2():
        return {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                for fn in (kernels.matmul_update, kernels.matmul)}

    def gates(label, factor, want, trtri):
        check(torch.equal(torch.from_numpy(factor), torch.from_numpy(want)),
              f"multirank {label}: the factor differs from the one-rank dynamic factor")
        L = torch.from_numpy(factor).to(dev).double().tril()
        recon = ((L @ L.mT - S64).abs().max() / s_max).item()
        del L
        check(recon < 1e-3, f"multirank {label}: ||LL^T-S||max/||S||max {recon} >= 1e-3")
        return recon

    def expected_counts(trtri):
        n_upd = nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
        n_mm = nt * (nt - 1) // 2 if trtri else 0
        exp = {fn.__name__: dict(dict.fromkeys(fn.launches_by_mode, 0), total=0)
               for fn in (kernels.matmul_update, kernels.matmul)}
        exp["matmul_update"].update(f32=n_upd, total=n_upd)
        exp["matmul"].update(f32=n_mm, total=n_mm)
        return exp

    def rank_fields(ces, cuda_devs, tasks):
        rds = [ce.remote_dep for ce in ces]
        return dict(
            tasks_by_rank=tasks,
            activations_sent=[int(rd.stats["activations_sent"]) for rd in rds],
            activations_recv=[int(rd.stats["activations_recv"]) for rd in rds],
            dtd_sent=[int(rd.stats["dtd_sent"]) for rd in rds],
            eager_sent=[int(rd.stats["eager_sent"]) for rd in rds],
            eager_bytes=[int(rd.stats["eager_bytes"]) for rd in rds],
            rdv_pulls=[int(rd.stats["rdv_pulls"]) for rd in rds],
            parked=[int(rd.stats["parked"] + rd.stats["dtd_parked"]) for rd in rds],
            frames_sent=[int(ce.stats["frames_sent"]) for ce in ces],
            frames_coalesced=[int(ce.stats["frames_coalesced"]) for ce in ces],
            bytes_in=[int(d.stats["bytes_in"]) for d in cuda_devs],
            bytes_d2d=[int(d.stats["bytes_d2d"]) for d in cuda_devs],
            mem_budget=[int(d.mem_budget) for d in cuda_devs])

    def placements(tp, r):
        return [(name, loc) for name, pc in tp.ptg.classes.items()
                for loc in pc.param_space(tp.constants)
                if pc.rank_of(loc, tp.constants) == r]

    def ptg_pool(label, A, kw, termdet=None):
        tp = cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(
            NT=A.mt, A=A, termdet=termdet)
        tp.name = f"dpotrf_{label}"
        return tp

    def harness_run(label, nranks, mats, pools, kw, termdet=None, **opts):
        """A PTG dpotrf through the shared harness: one Context a rank,
        each finalized (its dirty home tiles written back) before the
        harness returns; returns the harness's stats and each rank's comm
        engine and CUDA module."""
        ces, cuda_devs = [None] * nranks, [None] * nranks

        def build(r, ctx):
            ces[r], cuda_devs[r] = ctx.comm, cuda_of(ctx, r)
            pools[r] = ptg_pool(label, mats[r], kw, termdet)
            return pools[r], mats[r]

        try:
            _users, st = run_multirank_perf(nranks, build, nb_cores=MR_CORES,
                                            timeout=600, **opts)
        except RuntimeError as e:
            raise RuntimeError(f"check failed: multirank {label}: a rank's pool failed "
                               f"({[getattr(tp, 'fail_reason', None) for tp in pools]}): "
                               f"{e}") from e
        torch.cuda.synchronize()
        return st, ces, cuda_devs

    def run_dpotrf(label, nranks, kw, mode="ptg", termdet=None):
        """One distributed dpotrf; returns the fields of its line."""
        trtri = kw.get("use_trtri", False)
        mats = [matrix(nranks, r) for r in range(nranks)]
        pools = [None] * nranks
        kernels.reset_counts()
        gc.collect()
        if mode == "ptg":
            st, ces, cuda_devs = harness_run(label, nranks, mats, pools, kw, termdet)
            per, wall = [(True, t) for t in st["rank_wall_s"]], st["wall_s"]
            counts = b1b2()
            tasks = [int(d.stats["executed_tasks"]) for d in cuda_devs]
            fields = rank_fields(ces, cuda_devs, tasks)
            if termdet is not None:
                tdms = [tp.tdm for tp in pools]
                check(all(isinstance(t, TermDetFourCounter) for t in tdms)
                      and all(t.is_terminated(tp) for t, tp in zip(tdms, pools)),
                      f"multirank {label}: a pool did not terminate by the wave")
                fields.update(termdet_waves=tdms[0]._wave_id,
                              termdet_dedicated_sent=[t.dedicated_sent for t in tdms],
                              termdet_waves_suppressed=tdms[0].waves_suppressed)
        else:
            ces, ctxs, cuda_devs = mesh(nranks)

            def per_rank(r, ctx):
                d = pools[r] = DTDTaskpool(ctx, name=f"dtd_{label}")
                insert_dpotrf(d, mats[r], use_cpu=False, **kw)
                d.flush_all()
                ok = d.wait(timeout=600)
                d.close()
                return ok

            try:
                per, wall = drive(ctxs, per_rank)
                counts = b1b2()
                tasks = [int(d.stats["executed_tasks"]) for d in cuda_devs]
                fields = rank_fields(ces, cuda_devs, tasks)
            finally:
                for c in ctxs:
                    c.fini()  # writes every rank's dirty home tiles back
        check(all(ok for ok, _t in per), f"multirank {label}: a rank's pool failed "
              f"({[getattr(tp, 'fail_reason', None) for tp in pools]})")
        ntasks = dpotrf_task_count(nt, use_trtri=trtri)
        check(sum(tasks) == ntasks and all(n > 0 for n in tasks),
              f"multirank {label}: device tasks by rank {tasks}, expected {ntasks} in all")
        check(counts == expected_counts(trtri),
              f"multirank {label}: launches {counts}, expected {expected_counts(trtri)}")
        for r in range(nranks):
            own = dpotrf_home_bytes(mats[r], r, pools[r] if mode == "ptg" else None)
            check(fields["bytes_in"][r] == own,
                  f"multirank {label} rank {r}: bytes_in {fields['bytes_in'][r]}, "
                  f"expected its own tiles' {own}: a cross-rank tile came through "
                  "the host")
            check(fields["bytes_d2d"][r] > 0,
                  f"multirank {label} rank {r}: no tile landed device-to-device")
            check((fields["activations_sent"][r] if mode == "ptg"
                   else fields["dtd_sent"][r]) > 0,
                  f"multirank {label} rank {r}: sent nothing")
        recon = gates(label, assemble(mats), h.mr_factor["kernels_trtri" if trtri
                                                          else "kernels"], trtri)
        by_rank = [{"matmul_update": sum(1 for c, locs in placements(pools[r], r)
                                         if c in ("syrk", "gemm")),
                    "matmul": sum(1 for c, locs in placements(pools[r], r)
                                  if c == "trsm") if trtri else 0}
                   for r in range(nranks)] if mode == "ptg" else None
        h.launches[f"multirank_{label}"] = counts
        h.mr_walls[label] = wall
        h.mr_acts[label] = sum(fields["activations_sent"] if mode == "ptg"
                               else fields["dtd_sent"])
        one_rank = h.mr_wall["kernels_trtri" if trtri else "kernels"]
        say("multirank", run=label, mode=mode, nranks=nranks, grid=list(MR_GRIDS[nranks]),
            N=N, nb=NB, variant="kernels_trtri" if trtri else "kernels",
            termdet=termdet or "local", wall_s=wall,
            rank_wall_s=[t for _ok, t in per],
            host_ms_per_task=[1e3 * t / max(1, n) for (_ok, t), n in zip(per, tasks)],
            one_rank_wall_s=one_rank, wall_ratio=wall / one_rank, tasks=ntasks,
            launches=counts, launches_by_rank=by_rank, recon_err=recon,
            equal_one_rank=True, card=card, **fields)

    run_dpotrf("ptg4_kernels", 4, dict(use_kernels=True))
    run_dpotrf("ptg4_kernels_trtri", 4, dict(use_kernels=True, use_trtri=True))
    run_dpotrf("ptg2_kernels", 2, dict(use_kernels=True))
    run_dpotrf("dtd4_kernels", 4, dict(use_kernels=True), mode="dtd")
    run_dpotrf("ptg4_fourcounter", 4, dict(use_kernels=True), termdet="fourcounter")

    # -- the array program at 4 ranks -----------------------------------------
    rng = np.random.default_rng(ARR_SEED)
    G = rng.standard_normal((ARR_N, ARR_N), dtype=np.float32)
    H = np.eye(ARR_N, dtype=np.float32) * ARR_N
    rhs = rng.standard_normal((ARR_N, ARR_NRHS), dtype=np.float32)
    ces, ctxs, cuda_devs = mesh(4)
    outs = [None] * 4

    def array_rank(r, ctx):
        dist = pa.BlockCyclic(*MR_GRIDS[4])
        A = pa.from_numpy(G, ARR_NB, dist=dist, myrank=r)
        C = (A @ A.T + pa.from_numpy(H, ARR_NB, dist=dist, myrank=r)).cholesky()
        x = C.solve(pa.from_numpy(rhs, ARR_NB, dist=dist, myrank=r))
        x.compute(ctx, others=[C], use_cpu=False, timeout=600)
        outs[r] = (C, x)
        return True

    try:
        kernels.reset_counts()
        gc.collect()
        per, wall = drive(ctxs, array_rank)
        moved = {k: n for k, n in kernels.launch_counts().items() if n}
        tasks = [int(d.stats["executed_tasks"]) for d in cuda_devs]
        fields = rank_fields(ces, cuda_devs, tasks)
    finally:
        for c in ctxs:
            c.fini()
    check(not moved, f"multirank array: hand-written kernels launched: {moved}")
    check(all(n > 0 for n in tasks), f"multirank array: device tasks by rank {tasks}")
    for which, k in (("C", 0), ("x", 1)):
        full = np.zeros_like(h.arr_out[which])
        for r in range(4):
            coll = outs[r][k]._node.coll
            local = outs[r][k].to_numpy()
            for (i, j) in coll.local_tiles():
                hh, ww = coll.tile_shape(i, j)
                sl = np.s_[i * ARR_NB:i * ARR_NB + hh, j * ARR_NB:j * ARR_NB + ww]
                full[sl] = local[sl]
        check(torch.equal(torch.from_numpy(full), torch.from_numpy(h.arr_out[which])),
              f"multirank array: {which} differs from the one-rank array phase's")
    say("multirank", run="array4", mode="array", nranks=4, grid=list(MR_GRIDS[4]),
        N=ARR_N, nb=ARR_NB, wall_s=wall, rank_wall_s=[t for _ok, t in per],
        host_ms_per_task=[1e3 * t / max(1, n) for (_ok, t), n in zip(per, tasks)],
        one_rank_wall_s=h.arr_out["wall"], wall_ratio=wall / h.arr_out["wall"],
        tasks=sum(tasks), launches=moved, equal_one_rank=True, card=card, **fields)
    del outs, G, H, rhs
    gc.collect()

    # -- a body raising on rank 3: every rank fails, the contexts stay usable --
    ces, ctxs, cuda_devs = mesh(4)
    mats = [matrix(4, r) for r in range(4)]

    def boom(T, k):
        raise RuntimeError("multirank abort: injected failure on rank 3")

    def abort_rank(r, ctx):
        g = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True)
        if r == 3:
            g.classes["potrf"].bodies = {DEV_CPU: boom}
        tp = g.taskpool(NT=mats[r].mt, A=mats[r])
        tp.name = "dpotrf_abort"
        t0 = time.perf_counter()
        ctx.add_taskpool(tp)
        ok = tp.wait(timeout=MR_ABORT_S)
        return ok, time.perf_counter() - t0, tp.fail_reason

    n_small = N // 4  # a leading block: SPD as every leading block is
    S_small = np.ascontiguousarray(h.S[:n_small, :n_small])

    def after_rank(r, ctx):
        A = TwoDimBlockCyclic(n_small, n_small, NB, NB, p=2, q=2, myrank=r, name="A",
                              dtype=np.float32).from_array(S_small)
        tp = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True).taskpool(
            NT=A.mt, A=A)
        tp.name = "dpotrf_after_abort"
        ctx.add_taskpool(tp)
        return tp.wait(timeout=300), A

    try:
        per, wall = drive(ctxs, abort_rank, timeout=MR_ABORT_S)
        after, wall_after = drive(ctxs, after_rank, timeout=300)
    finally:
        for c in ctxs:
            c.fini()
    results = [res for res, _t in per]
    check(all(ok is False and t < MR_ABORT_S for ok, t, _why in results),
          f"multirank abort: rank results {[(ok, t) for ok, t, _w in results]}")
    check(all(ok for (ok, _A), _t in after), "multirank abort: a context failed the "
          "follow-up pool")
    small = np.zeros((n_small, n_small), np.float32)
    for (_ok, A), _t in after:
        for (i, j) in A.local_tiles():
            small[i * NB:(i + 1) * NB, j * NB:(j + 1) * NB] = np.asarray(
                A.data_of(i, j).newest_copy().payload)
    L = torch.from_numpy(small).to(dev).double().tril()
    S_s = S64[:n_small, :n_small]
    recon_small = ((L @ L.mT - S_s).abs().max() / S_s.abs().max()).item()
    check(recon_small < 1e-3, f"multirank after abort: recon {recon_small} >= 1e-3")
    say("multirank", run="abort4", mode="ptg", nranks=4, grid=list(MR_GRIDS[4]), N=N,
        nb=NB, wall_s=wall, rank_fail_s=[t for _ok, t, _w in results],
        fail_reasons=[w for _ok, _t, w in results], limit_s=MR_ABORT_S,
        after_wall_s=wall_after, after_N=n_small, after_recon_err=recon_small, card=card)
    del L, S_s, mats
    gc.collect()
    torch.cuda.empty_cache()
    say("multirank_phase", seconds=time.perf_counter() - t_phase, card=card)

    # -- the cross-rank readers -------------------------------------------------
    t_obs = time.perf_counter()
    from parsec_tpu_torch import mca_param, native
    from parsec_tpu_torch.ops.segmented_chol_dist import run_dist_segmented_cholesky
    from parsec_tpu_torch.profiling import critpath
    from parsec_tpu_torch.profiling.health import HealthServer, Watchdog

    # (a) a traced 4-rank dpotrf: per-rank traces, the handshake, the merge
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_scratch",
                             "multirank_obs")
    shutil.rmtree(trace_dir, ignore_errors=True)
    mats = [matrix(4, r) for r in range(4)]
    pools = [None] * 4
    kernels.reset_counts()
    gc.collect()
    st, ces, cuda_devs = harness_run("traced4", 4, mats, pools, dict(use_kernels=True),
                                     overlap=True, trace_dir=trace_dir)
    counts = b1b2()
    check(counts == expected_counts(False),
          f"multirank_obs traced: launches {counts}, expected {expected_counts(False)}")
    recon = gates("traced4", assemble(mats), h.mr_factor["kernels"], False)
    h.launches["multirank_traced4"] = counts
    del mats
    pbt_events = []
    for r in range(4):
        with open(os.path.join(trace_dir, f"rank{r}.pbt"), "rb") as f:
            check(f.read(8) == b"PBTRACE1", f"multirank_obs: rank{r}.pbt is not a trace")
            pbt_events.append(int(np.frombuffer(f.read(8), "<i8")[0]))
    check(st["trace_ranks"] == 4 and all(n > 0 for n in pbt_events),
          f"multirank_obs: {st['trace_ranks']} merged tracks, events {pbt_events}")
    t0 = time.perf_counter()
    with open(st["merged_trace"]) as f:
        events = json.load(f)["traceEvents"]
    per = critpath.analyze_ranks(events)
    mesh_rep = critpath.analyze(events)
    analyze_s = time.perf_counter() - t0
    check(sorted(per) == [0, 1, 2, 3], f"multirank_obs: critpath ranks {sorted(per)}")
    tasks = [int(d.stats["executed_tasks"]) for d in cuda_devs]
    split = {r: dict(chain_tasks=p["n_tasks"], chain_wall_ms=p["wall_us"] / 1e3,
                     **{k[:-3] + "_ms": v / 1e3 for k, v in p["buckets"].items()},
                     **{("window_ms" if k == "window_us" else f"window_{k[:-3]}_ms"):
                        v / 1e3 for k, v in p["window"].items() if k.endswith("_us")},
                     exec_spans=p["window"]["exec_spans"])
             for r, p in per.items()}
    del events
    say("multirank_obs", run="traced4", nranks=4, N=N, nb=NB, wall_s=st["wall_s"],
        rank_wall_s=st["rank_wall_s"], untraced_wall_s=h.mr_walls["ptg4_kernels"],
        traced_over_untraced=st["wall_s"] / h.mr_walls["ptg4_kernels"],
        host_ms_per_task=[1e3 * t / max(1, n) for t, n in zip(st["rank_wall_s"], tasks)],
        tasks_by_rank=tasks, launches=counts, recon_err=recon, equal_one_rank=True,
        pbt_events=pbt_events, pbt_bytes=[os.path.getsize(os.path.join(
            trace_dir, f"rank{r}.pbt")) for r in range(4)],
        merged_tracks=st["trace_ranks"], merged_bytes=os.path.getsize(st["merged_trace"]),
        clock_offsets_ns=st["clock_offsets_ns"], handshake_rtt_ns=st["handshake_rtt_ns"],
        overlap_per_rank=st["overlap_per_rank"], overlap_fraction=st["overlap_fraction"],
        overlap_union=st["overlap_union"], n_comm_events=st["n_comm_events"],
        mesh_chain_tasks=mesh_rep["n_tasks"],
        mesh_chain_ms={k[:-3]: v / 1e3 for k, v in mesh_rep["buckets"].items()},
        critpath_by_rank=split, analyze_s=analyze_s, wire_bytes=st["wire_bytes"],
        eager_hit_rate=st["eager_hit_rate"], card=card)
    shutil.rmtree(trace_dir, ignore_errors=True)
    gc.collect()

    # (b) a watched run: a strict watchdog and a health exporter on every rank
    ces, ctxs, cuda_devs = mesh(4)
    mats = [matrix(4, r) for r in range(4)]
    wds, servers, scraped = [], [], []
    try:
        with mca(mca_param, "runtime", "clock_resync_interval", MR_RESYNC_S):
            for ctx in ctxs:
                ctx.watchdog = Watchdog(ctx, poll=MR_POLL_S, strict=True).start()
                wds.append(ctx.watchdog)
                servers.append(HealthServer(ctx).start())

        def watched_rank(r, ctx):
            tp = ptg_pool("watched4", mats[r], dict(use_kernels=True))
            ctx.add_taskpool(tp)
            return tp.wait(timeout=600)

        kernels.reset_counts()
        per, wall = drive(ctxs, watched_rank)
        counts = b1b2()
        check(all(ok for ok, _t in per), "multirank_obs watched: a rank's pool failed")
        check(counts == expected_counts(False), f"multirank_obs watched: launches {counts}")
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 10.0 and not all(
                all(wd.heartbeats.get(p, 0) >= 1 for p in range(4) if p != r)
                and (r == 0 or wd.resync_samples) for r, wd in enumerate(wds)):
            time.sleep(0.02)
        heard = [{p: wd.heartbeats.get(p, 0) for p in range(4) if p != r}
                 for r, wd in enumerate(wds)]
        samples = [list(wd.resync_samples) for wd in wds]
        check(all(n >= 1 for hb in heard for n in hb.values()),
              f"multirank_obs watched: heartbeats received {heard}")
        check(all(samples[r] for r in range(1, 4)),
              f"multirank_obs watched: re-sync samples {[len(x) for x in samples]}")
        check(not any(wd.stalled or wd.last_report is not None for wd in wds),
              "multirank_obs watched: a watchdog reported a stall on a healthy run")
        findings = [[f.code for f in wd.diagnose().findings] for wd in wds]
        check(not any(findings), f"multirank_obs watched: findings {findings}")
        for r, (ce, hs) in enumerate(zip(ces, servers)):
            text = urllib.request.urlopen(hs.url + "/metrics", timeout=10).read().decode()
            fams = {}
            for ln in text.splitlines():
                if ln.startswith("parsec_comm_") and f'{{rank="{r}"}}' in ln:
                    name, _, val = ln.partition(" ")
                    fams[name.split("{")[0]] = float(val)
            want = int(ce.stats.get("am_bytes", 0)) + int(ce.stats.get("get_bytes", 0))
            check(set(fams) >= {"parsec_comm_wire_bytes_total", "parsec_comm_frames_sent_total",
                                "parsec_comm_eager_hit_rate", "parsec_comm_rdv_pulls_inflight",
                                "parsec_comm_eager_bytes_total", "parsec_comm_rdv_bytes_total"},
                  f"multirank_obs watched rank {r}: /metrics comm families {sorted(fams)}")
            check(fams["parsec_comm_wire_bytes_total"] == want > 0,
                  f"multirank_obs watched rank {r}: wire_bytes "
                  f"{fams['parsec_comm_wire_bytes_total']} != the engine's {want}")
            scraped.append(fams)
    finally:
        for wd in wds:
            wd.stop()
        for hs in servers:
            hs.stop()
        for c in ctxs:
            c.fini()
    recon = gates("watched4", assemble(mats), h.mr_factor["kernels"], False)
    h.launches["multirank_watched4"] = counts
    say("multirank_obs", run="watched4", nranks=4, N=N, nb=NB, wall_s=wall,
        rank_wall_s=[t for _ok, t in per], untraced_wall_s=h.mr_walls["ptg4_kernels"],
        watched_over_unwatched=wall / h.mr_walls["ptg4_kernels"], launches=counts,
        recon_err=recon, equal_one_rank=True, window_s=wds[0].window, poll_s=MR_POLL_S,
        resync_interval_s=MR_RESYNC_S, heartbeats=heard,
        resync_samples=[len(x) for x in samples],
        resync_offset_ns=[[x["offset_ns"] for x in xs] for xs in samples],
        resync_rtt_ns=[[x["rtt_ns"] for x in xs] for xs in samples],
        findings=findings, metrics_comm=scraped,
        wire_bytes=[f["parsec_comm_wire_bytes_total"] for f in scraped],
        wire_bytes_total=sum(f["parsec_comm_wire_bytes_total"] for f in scraped),
        eager_bytes_total=sum(f["parsec_comm_eager_bytes_total"] for f in scraped),
        card=card)
    del mats
    gc.collect()

    # (c) the distributed segmented Cholesky at the dpotrf's size
    kernels.reset_counts()
    t0 = time.perf_counter()
    err, sst = run_dist_segmented_cholesky(4, N, NB, nb_cores=MR_CORES, timeout=600)
    seg_s = time.perf_counter() - t0
    moved = {k: n for k, n in kernels.launch_counts().items() if n}
    nt_seg = N // NB
    check(err < 1e-3, f"multirank_obs segmented: err {err} >= 1e-3")
    check(sst["executed_tasks"] == nt_seg + nt_seg * (nt_seg - 1) // 2,
          f"multirank_obs segmented: {sst['executed_tasks']} tasks")
    check(sst["bytes_d2d"] > 0, "multirank_obs segmented: no panel landed device-to-device")
    check(not moved, f"multirank_obs segmented: hand-written kernels launched: {moved}")
    say("multirank_obs", run="segchol4", nranks=4, N=N, nb=NB, err=err,
        wall_s=sst["wall_s"], call_s=seg_s, rank_wall_s=sst["rank_wall_s"],
        tasks=sst["executed_tasks"], gflops=sst["gflops"], activations=sst["activations"],
        bytes_d2d=sst["bytes_d2d"], wire_bytes=sst["wire_bytes"],
        eager_hit_rate=sst["eager_hit_rate"], card=card)
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the engine's dispatch ceiling on the dpotrf DAG's shape
    A = TwoDimBlockCyclic(N, N, NB, NB, p=1, q=1, myrank=0, name="A", dtype=np.float32)
    cap = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True).taskpool(
        NT=A.mt, A=A).capture()
    rates = []
    for threads in MR_NOOP_THREADS:
        g = native.NativeGraph()
        try:
            tids = list(cap.nodes)
            index = {tid: g.add_task(priority=cap.nodes[tid].priority) for tid in tids}
            for tid in tids:
                for (_f, succ, _sf) in cap.nodes[tid].out_edges:
                    g.add_dep(index[tid], index[succ])
            for tid in tids:
                g.commit(index[tid])
            g.seal()
            t0 = time.perf_counter()
            ran = g.run_noop(threads)
            dt = time.perf_counter() - t0
        finally:
            g.close()
        check(ran == dpotrf_task_count(nt), f"multirank_obs run_noop: ran {ran}")
        rates.append(dict(nthreads=threads, tasks=ran, seconds=dt, tasks_per_s=ran / dt,
                          us_per_task=1e6 * dt / ran))
    say("multirank_obs", run="noop", tasks=dpotrf_task_count(nt), rates=rates,
        pump_host_ms_per_task=h.pump_ms_per_task,
        dynamic_host_ms_per_task=1e3 * h.mr_wall["kernels"] / dpotrf_task_count(nt),
        traced4_host_ms_per_task=max(1e3 * t / max(1, n)
                                     for t, n in zip(st["rank_wall_s"], tasks)),
        card=card)
    del A, cap, S64
    gc.collect()
    torch.cuda.empty_cache()
    say("multirank_obs_phase", seconds=time.perf_counter() - t_obs, card=card)


#: the collectives phase: the contributions' shape (4096 x 4096 f32 =
#: 64 MiB a rank; the allgather's blocks are a quarter of it), their seed,
#: the DTD CollectiveTask tile, the redistribution targets' tiling and
#: budget, the misaligned window, and the bf16 reshape tile
COLL_SHAPE = (4096, 4096)
COLL_SEED = 22
COLL_TILE = 2048
COLL_TARGET_NB = 1024
COLL_BUDGET = 32 << 20
COLL_WINDOW = dict(ia=100, ja=100, ib=37, jb=37, m=5000, n=5000)
COLL_RESHAPE_N = 2048
# a rank's wait on the wedged allreduce, and the slack over it allowed
COLL_WEDGE_WAIT_S, COLL_WEDGE_SLACK_S = 1.0, 5.0


def coll_phase(h):
    """The collectives, reshape and redistribution (``comm.coll``,
    ``dsl.CollectiveTask``, ``data.reshape``, ``datadist.redistribute``)
    on the card: 4 ranks in one process, each a full ``Context`` over one
    ``InprocFabric(4)``, every rank's CUDA module on ``cuda:0``, a thread a
    rank.  One ``coll`` line a run:

    (a) collectives on CUDA tensors, 64 MiB a rank (4096 x 4096 f32, seeded
        on the card): allreduce ``sum`` under ring, rd and gather, ``max``
        under ring, a reduce-scatter, an allgather of 16 MiB blocks and a
        64 MiB bcast from rank 2.  Every rank's result ``torch.equal`` to
        every other's (the reduce-scatter's partitions to their slices),
        each ``torch.equal`` to the same collective over host tensors of
        the same values, within 1e-5 relative of a float64 sum, a CUDA
        tensor on ``cuda:0``, ``jit_reduces`` the combines the algorithm
        makes (ring N-1 a rank, rd log2 N, gather N-1 at the root);
    (b) ``CollectiveTask.allreduce`` between a produce and a consume chore
        on the card, 2048 x 2048 f32 a rank: every pool terminates, every
        consumed tile ``torch.equal`` to the host allreduce of the produced
        tiles;
    (c) the 4-rank ``kernels`` dpotrf (N=8192 nb=512, 2x2; B1 +680) left
        on the card, redistributed to a 1x4 grid at 1024 x 1024 tiles
        through ``dtd``, through ``coll`` under a 32 MiB budget and through
        a misaligned ``coll`` window: every target tile ``torch.equal`` to
        the one-rank factor's slice, ``peak_extra_bytes`` <= the budget;
    (d) the array phase's N=8192 matrix on a 2x2 grid redistributed to
        1024 x 1024 tiles, then ``sum`` and ``norm``: equal on every rank,
        within 1e-9 relative of the float64 host values;
    (e) a PTG whose consumer reads the producer's CUDA tile through a
        ``[type=bfloat16]`` dep, at one rank and on a remote read at 2
        ranks: the payload ``torch.equal`` to ``.to(torch.bfloat16)`` of
        the producer's tile, and the consumer's module moved no byte off
        the card (``bytes_out`` 0: the cast ran on the card);
    (f) a traced 4-rank allreduce (each rank's ``.pbt``: one ``coll``
        span, one ``coll_seg`` instant a landed segment), then an
        allreduce rank 3 withholds: ranks 0-2's ``wait`` returns False
        within its bound, OBS007 names the op on each, rank 3 joins late
        and every rank holds the sum, and each context runs a small
        allreduce right afterwards."""
    np, torch, dev, card, say, check = h.np, h.torch, h.dev, h.card, h.say, h.check
    import importlib

    from parsec_tpu_torch import Context, DEV_CUDA
    from parsec_tpu_torch import array as pa
    from parsec_tpu_torch.comm import InprocFabric
    from parsec_tpu_torch.datadist import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl import PTG, CollectiveTask
    from parsec_tpu_torch.dsl.dtd import AFFINITY, IN, INOUT, DTDTaskpool
    from parsec_tpu_torch.ops import cholesky_ptg, kernels
    from parsec_tpu_torch.profiling import merge
    from parsec_tpu_torch.profiling.binary import RankTraceSet
    from parsec_tpu_torch.profiling.health import Watchdog

    redist = importlib.import_module("parsec_tpu_torch.datadist.redistribute")
    t_phase = time.perf_counter()
    nr = 4

    mesh = functools.partial(rank_mesh, h, label="coll")

    def drive(items, per_rank, timeout=600.0):
        """``drive_ranks``: each rank's result and the wall."""
        out, wall = drive_ranks(h, items, per_rank, label="coll", timeout=timeout)
        return [res for res, _t in out], wall

    def waited(label, hd, timeout=600):
        """A collective's result once ``hd`` completed within ``timeout``."""
        check(hd.wait(timeout=timeout), f"coll {label}: timed out")
        return hd.result()

    def host_collective(call, contribs):
        """The same collective over host tensors of the same values, on a
        fresh fabric: each rank's result."""
        ces = InprocFabric(len(contribs)).endpoints()
        for ce in ces:
            _ = ce.coll
        out, _wall = drive(ces, lambda r, ce: waited("host run", call(ce, contribs[r])))
        return out

    # -- (a) collectives on CUDA tensors --------------------------------------
    ces, ctxs, cuda_devs = mesh(nr)
    try:
        gen = torch.Generator(device=dev)
        contribs = []
        for r in range(nr):
            gen.manual_seed(COLL_SEED + r)
            contribs.append(torch.randn(COLL_SHAPE, generator=gen, device=dev))
        nbytes = contribs[0].numel() * 4
        quarter = COLL_SHAPE[0] // nr
        runs = [
            ("allreduce_ring_sum", "allreduce", dict(algo="ring"), 2 * (nr - 1) / nr,
             [nr - 1] * nr),
            ("allreduce_rd_sum", "allreduce", dict(algo="rd"), 2 * (nr - 1) / nr, [2] * nr),
            ("allreduce_gather_sum", "allreduce", dict(algo="gather"), 2 * (nr - 1) / nr,
             [nr - 1] + [0] * (nr - 1)),
            ("allreduce_ring_max", "allreduce", dict(algo="ring", op="max"),
             2 * (nr - 1) / nr, [nr - 1] * nr),
            ("reduce_scatter", "reduce_scatter", {}, (nr - 1) / nr, [nr - 1] * nr),
            ("allgather", "allgather", {}, (nr - 1) / nr, [0] * nr),
            ("bcast_root2", "bcast", dict(root=2), 1.0, [0] * nr),
        ]
        wide = sum(c.double() for c in contribs)
        wide_max = torch.stack(contribs).amax(0).double()
        for label, kind, kw, factor, want_reduces in runs:
            if kind == "allgather":
                mine = [c[:quarter] for c in contribs]
            elif kind == "bcast":
                mine = [c if r == 2 else torch.zeros_like(c) for r, c in enumerate(contribs)]
            else:
                mine = contribs

            def call(ce, x, kind=kind, kw=kw):
                return getattr(ce.coll, kind)(x, **kw)

            before = [dict(ce.coll.stats) for ce in ces]
            gc.collect()
            outs, wall = drive(ces, lambda r, ce: waited(label, call(ce, mine[r])))
            delta = [{k: int(ce.coll.stats.get(k, 0) - b.get(k, 0))
                      for k in ("jit_reduces", "bytes_landed", "seg_done", "bytes_d2h",
                                "bytes_h2d")}
                     for ce, b in zip(ces, before)]
            hosts = host_collective(call, [x.cpu() for x in mine])
            for r in range(nr):
                check(isinstance(outs[r], torch.Tensor) and outs[r].device == mine[r].device,
                      f"coll {label}: rank {r}'s result is not on {mine[r].device}")
                check(torch.equal(outs[r].cpu(), hosts[r]),
                      f"coll {label}: rank {r} differs from the host run")
            if kind == "reduce_scatter":
                flat = wide.reshape(-1)
                bounds = [k * flat.numel() // nr for k in range(nr + 1)]
                whole = torch.cat([o for o in outs])
                ref = flat
            elif kind == "allgather":
                whole = outs[0]
                ref = torch.cat(mine).double()
            elif kind == "bcast":
                whole = outs[0]
                ref = contribs[2].double()
            else:
                whole = outs[0]
                ref = wide_max if kw.get("op") == "max" else wide
            if kind != "reduce_scatter":
                check(all(torch.equal(o, outs[0]) for o in outs),
                      f"coll {label}: the ranks' results differ")
            else:
                check(all(o.numel() == bounds[r + 1] - bounds[r] for r, o in enumerate(outs)),
                      f"coll {label}: partition sizes {[o.numel() for o in outs]}")
            rel = ((whole.double().reshape(-1) - ref.reshape(-1)).abs().max()
                   / ref.abs().max()).item()
            check(rel <= 1e-5, f"coll {label}: {rel} from the float64 reference")
            got_reduces = [d["jit_reduces"] for d in delta]
            check(got_reduces == want_reduces,
                  f"coll {label}: jit_reduces {got_reduces}, expected {want_reduces}")
            # nbytes: the full buffer (the allgather's result), as NCCL's
            # algbw/busbw count it
            say("coll", run=label, kind=kind, nranks=nr, nbytes=nbytes,
                contribution_bytes=mine[0].numel() * 4, wall_s=wall,
                algbw_GBps=nbytes / wall / 1e9, busbw_factor=factor,
                busbw_GBps=factor * nbytes / wall / 1e9,
                bytes_landed=[d["bytes_landed"] for d in delta],
                segments=[d["seg_done"] for d in delta],
                bytes_d2h=[d["bytes_d2h"] for d in delta],
                bytes_h2d=[d["bytes_h2d"] for d in delta],
                jit_reduces=got_reduces, rel_err_vs_f64=rel,
                equal_host_run=True, result_device=str(outs[0].device), card=card)
            del outs, hosts, whole
        del contribs, wide, wide_max

        # -- (b) CollectiveTask.allreduce between two chores on the card ----
        rng = np.random.default_rng(COLL_SEED)
        Xg = rng.standard_normal((COLL_TILE, nr * COLL_TILE), dtype=np.float32)
        produced, consumed = [None] * nr, [None] * nr

        def produce(t):
            return t * 2.0 + 1.0

        def consume_of(r):
            def consume(t):
                consumed[r] = t.clone()
                return ()  # a read-only chore: no writable flow
            return consume

        def noop(t):
            return ()

        def ctask_rank(r, ctx):
            X = TwoDimBlockCyclic(COLL_TILE, nr * COLL_TILE, COLL_TILE, COLL_TILE, p=1, q=nr,
                                  myrank=r, name="X", dtype=np.float32).from_array(Xg)
            tiles = {k: X.data_of(0, k) for k in range(nr)}
            tp = DTDTaskpool(ctx, name="coll_ctask")
            for k in range(nr):
                tp.insert_task({DEV_CUDA: produce}, (tiles[k], INOUT | AFFINITY),
                               name="produce")
            CollectiveTask.allreduce(tp, tiles)
            for k in range(nr):
                tp.insert_task({DEV_CUDA: consume_of(r) if k == r else noop},
                               (tiles[k], IN | AFFINITY), name="consume")
            ok = tp.wait(timeout=600)
            tp.close()
            return ok

        _outs, wall = drive(ctxs, ctask_rank)
        check(all(_outs), f"coll ctask: pools terminated {_outs}")
        for r in range(nr):
            produced[r] = torch.from_numpy(Xg[:, r * COLL_TILE:(r + 1) * COLL_TILE]).to(dev) * 2.0 + 1.0
        want = host_collective(lambda ce, x: ce.coll.allreduce(x), [p.cpu() for p in produced])
        check(all(c is not None and c.device.type == dev.type for c in consumed),
              "coll ctask: a consume chore did not run on the card")
        check(all(torch.equal(consumed[r].cpu(), want[r]) for r in range(nr)),
              "coll ctask: a consumed tile differs from the allreduce of the produced tiles")
        say("coll", run="ctask_allreduce", nranks=nr, tile=[COLL_TILE, COLL_TILE],
            wall_s=wall, pools_terminated=True, consumed_equal=True,
            device_tasks=[int(d.stats["executed_tasks"]) for d in cuda_devs], card=card)
        del produced, consumed, want, Xg

        # -- (f) a traced allreduce, then one rank 3 withholds ---------------
        trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_scratch",
                                 "coll_obs")
        shutil.rmtree(trace_dir, ignore_errors=True)
        os.makedirs(trace_dir)
        gen.manual_seed(COLL_SEED)
        obs_in = [torch.randn(1024, 1024, generator=gen, device=dev) for _ in range(nr)]
        seg0 = [int(ce.coll.stats["seg_done"]) for ce in ces]
        traces = RankTraceSet(nr).install()
        try:
            outs, wall = drive(ces, lambda r, ce: waited("traced", ce.coll.allreduce(obs_in[r])))
            paths = traces.dump(trace_dir)
        finally:
            traces.uninstall()
            traces.close()
        segs = [int(ce.coll.stats["seg_done"]) - s for ce, s in zip(ces, seg0)]
        events = merge.merge_traces(paths)["traceEvents"]
        spans = [[e["ph"] for e in events if e["name"] == "coll" and e["pid"] == r]
                 for r in range(nr)]
        seg_instants = [sum(1 for e in events if e["name"] == "coll_seg" and e["pid"] == r)
                        for r in range(nr)]
        tokens = {e["args"]["event_id"] for e in events if e["name"] == "coll"}
        check(all(sorted(s) == ["B", "E"] for s in spans) and len(tokens) == 1,
              f"coll traced: coll spans by rank {spans}, tokens {tokens}")
        check(seg_instants == segs and all(n > 0 for n in segs),
              f"coll traced: coll_seg instants {seg_instants}, landed segments {segs}")
        check(all(torch.equal(o, outs[0]) for o in outs), "coll traced: results differ")
        pbt_bytes = [os.path.getsize(p) for p in paths]
        shutil.rmtree(trace_dir, ignore_errors=True)
        say("coll", run="traced_allreduce", nranks=nr, nbytes=obs_in[0].numel() * 4,
            wall_s=wall, coll_spans=[len(s) // 2 for s in spans], coll_seg_instants=seg_instants,
            segments=segs, pbt_bytes=pbt_bytes, card=card)
        del events, outs

        cid = ("coll_phase", "wedge")
        wedged = [None] * nr

        def wedge_rank(r, ce):
            if r == nr - 1:
                return None  # rank 3 withholds its contribution
            wedged[r] = ce.coll.allreduce(obs_in[r], cid=cid)
            t0 = time.perf_counter()
            ok = wedged[r].wait(timeout=COLL_WEDGE_WAIT_S)
            return ok, time.perf_counter() - t0

        waits, _wall = drive(ces, wedge_rank)
        check(all(w[0] is False and w[1] < COLL_WEDGE_WAIT_S + COLL_WEDGE_SLACK_S
                  for w in waits[:nr - 1]),
              f"coll wedge: ranks 0-2's waits {waits[:nr - 1]}")
        obs = []
        for r in range(nr - 1):
            wd = Watchdog(ctxs[r], window=3600.0, poll=3600.0)
            try:
                found = [f.message for f in wd.diagnose().findings if f.code == "OBS007"]
            finally:
                wd.stop()
            check(len(found) == 1 and "allreduce[ring]" in found[0] and "wedge" in found[0]
                  and "step " in found[0], f"coll wedge: rank {r}'s OBS007 {found}")
            obs.append(found[0])
        late = ces[nr - 1].coll.allreduce(obs_in[nr - 1], cid=cid)
        joined, wall_join = drive(ces, lambda r, ce: waited(
            "wedge", late if r == nr - 1 else wedged[r]))
        want = host_collective(lambda ce, x: ce.coll.allreduce(x), [x.cpu() for x in obs_in])
        check(all(torch.equal(joined[r].cpu(), want[r]) for r in range(nr)),
              "coll wedge: the late-joined allreduce differs from the host run")
        check(all(ce.coll.ops_in_flight() == [] for ce in ces), "coll wedge: ops left in flight")
        after, wall_after = drive(ces, lambda r, ce: waited(
            "after wedge", ce.coll.allreduce(torch.full((1024,), float(r + 1), device=dev)),
            timeout=60))
        check(all(torch.equal(a, torch.full((1024,), 10.0, device=dev)) for a in after),
              "coll after wedge: the follow-up allreduce is wrong")
        say("coll", run="wedged_allreduce", nranks=nr, withheld_by=nr - 1,
            wait_limit_s=COLL_WEDGE_WAIT_S, waits_s=[w[1] for w in waits[:nr - 1]],
            obs007=obs, late_join_wall_s=wall_join, after_wall_s=wall_after, card=card)
        del obs_in, joined, after, want
    finally:
        for c in ctxs:
            c.fini()
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) redistribute the 4-rank dpotrf factor, left on the card ----------
    ces, ctxs, _devs = mesh(nr)
    factor = h.mr_factor["kernels"]
    try:
        mats = [TwoDimBlockCyclic(N, N, NB, NB, p=2, q=2, myrank=r, name="A",
                                  dtype=np.float32).from_array(h.S) for r in range(nr)]

        def dpotrf_rank(r, ctx):
            tp = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True).taskpool(
                NT=mats[r].mt, A=mats[r])
            tp.name = "dpotrf_coll"
            ctx.add_taskpool(tp)
            return tp.wait(timeout=600)

        kernels.reset_counts()
        oks, wall = drive(ctxs, dpotrf_rank)
        check(all(oks), "coll dpotrf: a rank's pool failed")
        counts = {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                  for fn in (kernels.matmul_update, kernels.matmul)}
        nt = N // NB
        n_upd = nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
        check(counts["matmul_update"]["f32"] == counts["matmul_update"]["total"] == n_upd
              and counts["matmul"]["total"] == 0, f"coll dpotrf: launches {counts}")
        h.launches["coll_dpotrf4"] = counts
        on_card = [sum(1 for k in m.local_tiles()
                       if m.data_of(*k).newest_copy().device_index != 0)
                   for m in mats]
        check(all(n > 0 for n in on_card), f"coll dpotrf: tiles on the card {on_card}")
        say("coll", run="dpotrf4_source", nranks=nr, N=N, nb=NB, wall_s=wall,
            launches=counts, tiles_on_card=on_card, card=card)

        def target(label):
            return [TwoDimBlockCyclic(N, N, COLL_TARGET_NB, COLL_TARGET_NB, p=1, q=nr,
                                      myrank=r, name=f"T_{label}", dtype=np.float32)
                    for r in range(nr)]

        whole = torch.from_numpy(factor)
        for label, kw in (("dtd", dict(algo="dtd")),
                          ("coll", dict(algo="coll", mem_budget=COLL_BUDGET)),
                          ("coll_misaligned", dict(algo="coll", mem_budget=COLL_BUDGET,
                                                   **COLL_WINDOW))):
            T = target(label)
            pools = [None] * nr

            def redist_rank(r, ctx):
                pools[r] = redist.redistribute(ctx, mats[r], T[r], **kw)
                ok = pools[r].wait(timeout=600)
                pools[r].close()
                return ok

            gc.collect()
            oks, wall = drive(ctxs, redist_rank)
            check(all(oks), f"coll redistribute {label}: a rank's pool failed")
            if "m" in kw:
                want = torch.zeros(N, N)
                w = COLL_WINDOW
                want[w["ib"]:w["ib"] + w["m"], w["jb"]:w["jb"] + w["n"]] = \
                    whole[w["ia"]:w["ia"] + w["m"], w["ja"]:w["ja"] + w["n"]]
            else:
                want = whole
            bad = []
            for r in range(nr):
                for (i, j) in T[r].local_tiles():
                    got = T[r].data_of(i, j).newest_copy().payload
                    sl = want[i * COLL_TARGET_NB:(i + 1) * COLL_TARGET_NB,
                              j * COLL_TARGET_NB:(j + 1) * COLL_TARGET_NB]
                    if not torch.equal(torch.as_tensor(got).cpu(), sl):
                        bad.append((r, i, j))
            check(not bad, f"coll redistribute {label}: target tiles differ {bad[:8]}")
            peaks = [p.user.get("peak_extra_bytes") for p in pools]
            if kw["algo"] == "coll":
                check(all(0 < pk <= COLL_BUDGET for pk in peaks),
                      f"coll redistribute {label}: peak extra bytes {peaks} over "
                      f"{COLL_BUDGET}")
            say("coll", run=f"redistribute_{label}", nranks=nr, N=N, from_nb=NB,
                to_nb=COLL_TARGET_NB, grid=[1, nr], window=kw.get("m") and COLL_WINDOW,
                algo=pools[0].user["algo"], wall_s=wall, budget=kw.get("mem_budget"),
                peak_extra_bytes=peaks,
                bytes_landed=[int(ce.coll.stats["bytes_landed"]) for ce in ces],
                equal_one_rank=True, card=card)
            del T, pools, want

        # -- (d) the array at 4 ranks: a geometry change, sum, norm --------
        rng = np.random.default_rng(ARR_SEED)
        G = rng.standard_normal((ARR_N, ARR_N), dtype=np.float32)
        G64 = torch.from_numpy(G).to(dev).double()
        s64, n64 = G64.sum().item(), torch.linalg.norm(G64).item()
        del G64

        def array_rank(r, ctx):
            # one leaf name on every rank, as each process of an SPMD run
            # draws it (the in-process ranks share one leaf counter)
            A = pa.from_numpy(G, ARR_NB, dist=pa.BlockCyclic(2, 2), myrank=r, name="A_coll")
            t0 = time.perf_counter()
            R = A.redistribute(pa.BlockCyclic(2, 2), mb=COLL_TARGET_NB, nb=COLL_TARGET_NB,
                               context=ctx)
            t1 = time.perf_counter()
            s = R.sum(ctx)
            nrm = R.norm(ctx)
            t2 = time.perf_counter()
            coll = R._node.coll
            bad = [(i, j) for (i, j) in coll.local_tiles()
                   if not torch.equal(torch.as_tensor(coll.data_of(i, j).newest_copy().payload),
                                      torch.from_numpy(G[i * COLL_TARGET_NB:(i + 1) * COLL_TARGET_NB,
                                                         j * COLL_TARGET_NB:(j + 1) * COLL_TARGET_NB]))]
            return s, nrm, bad, t1 - t0, t2 - t1

        gc.collect()
        res, wall = drive(ctxs, array_rank)
        check(all(not b for _s, _n, b, _t, _u in res), f"coll array: tiles differ {res}")
        check(all(x[0] == res[0][0] and x[1] == res[0][1] for x in res),
              f"coll array: sum/norm differ across ranks {[x[:2] for x in res]}")
        s, nrm = res[0][0], res[0][1]
        check(abs(s - s64) <= TOL_ARR_REDUCE * abs(s64) and abs(nrm - n64) <= TOL_ARR_REDUCE * n64,
              f"coll array: sum {s} / norm {nrm} against float64 {s64} / {n64}")
        say("coll", run="array4_redistribute_sum_norm", nranks=nr, N=ARR_N, from_nb=ARR_NB,
            to_nb=COLL_TARGET_NB, wall_s=wall, redistribute_s=[x[3] for x in res],
            sum_norm_s=[x[4] for x in res], sum=s, norm=nrm, sum_f64=s64, norm_f64=n64,
            sum_rel_err=abs(s - s64) / abs(s64), norm_rel_err=abs(nrm - n64) / n64,
            tol=TOL_ARR_REDUCE, card=card)
        del G, res, mats
    finally:
        for c in ctxs:
            c.fini()
    gc.collect()
    torch.cuda.empty_cache()

    # -- (e) a [type=bfloat16] dep on the card: one rank, a remote read -------
    n_e = COLL_RESHAPE_N
    rng = np.random.default_rng(COLL_SEED + 7)
    Y = rng.standard_normal((n_e, 2 * n_e), dtype=np.float32)
    want = (torch.from_numpy(Y[:, :n_e]).to(dev) * 2.0 + 1.0).to(torch.bfloat16)

    def reshape_ptg(nranks, r, seen):
        D = TwoDimBlockCyclic(n_e, 2 * n_e, n_e, n_e, p=1, q=nranks, myrank=r, name="D",
                              dtype=np.float32).from_array(Y)
        g = PTG("coll_reshape")
        prod = g.task_class("prod")
        prod.affinity("D(0, 0)")
        prod.flow("X", INOUT, "<- D(0, 0)", "-> X cons()")
        prod.body(cuda=lambda X: X * 2.0 + 1.0)
        cons = g.task_class("cons")
        cons.affinity(f"D(0, {nranks - 1})")
        cons.flow("X", IN, "<- X prod() [type=bfloat16]")
        cons.flow("Z", INOUT, f"<- D(0, {nranks - 1})", f"-> D(0, {nranks - 1})")

        def cbody(X, Z):
            seen["X"] = X.clone()
            return Z

        cons.body(cuda=cbody)
        return g.taskpool(D=D, bfloat16=torch.bfloat16)

    lines = []
    for nranks in (1, 2):
        seen = {}
        if nranks == 1:
            ctxs1 = [Context(nb_cores=MR_CORES)]
            devs1 = [rank_cuda_module(h, ctxs1[0], 0, "coll")]
        else:
            _ces, ctxs1, devs1 = mesh(nranks)
        try:
            def e_rank(r, ctx):
                tp = reshape_ptg(nranks, r, seen)
                ctx.add_taskpool(tp)
                return tp.wait(timeout=600)

            oks, wall = drive(ctxs1, e_rank)
            check(all(oks), f"coll reshape {nranks} rank(s): a pool failed")
            cons_dev = devs1[nranks - 1]
            out_bytes = int(cons_dev.stats["bytes_out"])
            x = seen.get("X")
            check(x is not None and x.device.type == dev.type and x.dtype == torch.bfloat16
                  and torch.equal(x, want),
                  f"coll reshape {nranks} rank(s): the consumer's bf16 tile differs")
            check(out_bytes == 0, f"coll reshape {nranks} rank(s): the consumer's module "
                  f"moved {out_bytes} bytes off the card")
            lines.append(dict(nranks=nranks, wall_s=wall, consumer_bytes_out=out_bytes,
                              consumer_bytes_d2d=int(cons_dev.stats["bytes_d2d"]),
                              consumer_bytes_in=int(cons_dev.stats["bytes_in"])))
        finally:
            for c in ctxs1:
                c.fini()
    say("coll", run="reshape_bf16", n=n_e, runs=lines, equal_to_cast=True, card=card)
    del Y, want
    gc.collect()
    torch.cuda.empty_cache()
    say("coll_phase", seconds=time.perf_counter() - t_phase, card=card)

# -- the TCP backend: 4 rank processes on the one card ------------------------

TCP_NRANKS = 4
TCP_GRID = (2, 2)
#: the native-dist dpotrf's order (host bodies): the leading block of S
TCP_ND_N = 4096
TCP_ND_THREADS = 2
#: each rank process's zone budget (the automatic one takes 85% of the
#: free card, which four processes on one card cannot each take)
TCP_BUDGET_MB = 4096
TCP_TIMEOUT_S = 400.0
TCP_VARIANTS = (("kernels", dict(use_kernels=True)),
                ("kernels_trtri", dict(use_kernels=True, use_trtri=True)))


def tcp_scratch() -> str:
    """The directory the TCP phase hands its data to the rank processes
    through (gitignored; removed after the phase)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_scratch", "tcp")


def dpotrf_home_bytes(A, r, tp=None) -> int:
    """The bytes rank r's CUDA module stages from its own host memory in a
    dpotrf over the f32 matrix ``A``: its lower home tiles and, with the
    PTG's trtri (``tp``), the NEW tiles of its trtri tasks."""
    import numpy as np

    nt = A.mt
    tile = A.mb * A.nb * np.dtype(np.float32).itemsize
    out = tile * sum(1 for i in range(nt) for j in range(i + 1) if A.rank_of(i, j) == r)
    if tp is not None and "trtri" in tp.ptg.classes:
        shape, dtype = tp.new_tile_spec("trtri", "I")
        out += (sum(1 for k in range(nt - 1) if A.rank_of(k, k) == r)
                * int(np.prod(shape)) * np.dtype(dtype).itemsize)
    return out


def tcp_rank_main() -> int:
    """One rank of the TCP phase (``chip_smoke.py --tcp-rank`` under
    ``parsec_tpu_torch.comm.launch``): its ``TCPComm`` from the launcher's
    environment, one ``Context(rank=, nranks=4, comm=ce)`` with its CUDA
    module on ``cuda:0``.  (a) the dpotrf ``kernels`` and
    ``kernels_trtri`` at N=8192 nb=512 on a 2x2 grid, every local tile
    ``torch.equal`` to the one-rank factor, ``bytes_d2d`` 0 and
    ``bytes_in`` its own home tiles plus the bytes it pulled; (b) a ring
    ``sum`` allreduce of a 64 MiB f32 CUDA tensor, the result a tensor on
    the card equal to the same contributions' run over host tensors and
    within 1e-5 of float64; (c) ``NativeDistExecutor`` on host bodies at
    N=4096, then ``rebind`` and again, each local tile equal to the
    one-rank host factor.  Any failed check raises (a non-zero exit); on
    success the rank prints one JSON line."""
    import hashlib

    import numpy as np
    import torch

    from parsec_tpu_torch import Context, native
    from parsec_tpu_torch.comm import endpoint_from_env
    from parsec_tpu_torch.datadist import TwoDimBlockCyclic
    from parsec_tpu_torch.dsl.native_dist import NativeDistExecutor
    from parsec_tpu_torch.ops import cholesky_ptg, kernels

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scratch = os.environ["PARSEC_CHIP_TCP_DIR"]
    ce = endpoint_from_env()
    r, nr = ce.rank, ce.nranks
    kernels.build()
    native.load()
    S = np.load(os.path.join(scratch, "S.npy"), mmap_mode="r")
    ctx = Context(nb_cores=MR_CORES, rank=r, nranks=nr, comm=ce)
    cuda = next(d for d in ctx.devices if d.mca_name == "cuda")
    dev = cuda.tdev
    check(dev.type == "cuda" and dev.index in (None, 0),
          f"tcp rank {r}: CUDA module bound to {dev}")
    # warm the solver libraries at tile size, as main does before its
    # dpotrf runs (handle creation is set-up, not dpotrf time)
    tile = torch.from_numpy(np.ascontiguousarray(S[:NB, :NB])).to(dev)
    torch.linalg.cholesky_ex(tile)
    torch.linalg.solve_triangular(tile, tile, upper=False)
    torch.cuda.synchronize()
    del tile
    out = {"rank": r, "device": str(dev), "mem_budget": int(cuda.mem_budget),
           "startup_s": time.perf_counter() - t_start}
    rd = ce.remote_dep

    def host(payload):
        if isinstance(payload, torch.Tensor):
            return payload.detach().cpu()
        return torch.from_numpy(np.ascontiguousarray(payload))

    def equal_tiles(A, want, label):
        for (i, j) in A.local_tiles():
            got = host(A.data_of(i, j).newest_copy().payload)
            sl = np.s_[i * A.mb:(i + 1) * A.mb, j * A.nb:(j + 1) * A.nb]
            check(torch.equal(got, torch.from_numpy(np.ascontiguousarray(want[sl]))),
                  f"tcp rank {r} {label}: tile ({i}, {j}) differs from the one-rank factor")

    def delta(after, before, keys):
        return {k: int(after.get(k, 0) - before.get(k, 0)) for k in keys}

    try:
        # -- (a) the dpotrf on the card over TCP ------------------------------
        runs = {}
        for name, kw in TCP_VARIANTS:
            p, q = TCP_GRID
            A = TwoDimBlockCyclic(N, N, NB, NB, p=p, q=q, myrank=r, name="A",
                                  dtype=np.float32).from_array(S)
            b_rd, b_ce, b_dev = dict(rd.stats), dict(ce.stats), dict(cuda.stats)
            kernels.reset_counts()
            ce.barrier()  # a common start: the ranks' walls compare
            t0 = time.perf_counter()
            tp = cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(NT=A.mt, A=A)
            tp.name = f"dpotrf_tcp_{name}"
            ctx.add_taskpool(tp)
            ok = tp.wait(timeout=600)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            synced = time.perf_counter() - t0
            check(ok, f"tcp rank {r} {name}: the pool failed ({tp.fail_reason})")
            counts = {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                      for fn in (kernels.matmul_update, kernels.matmul)}
            wire = delta(rd.stats, b_rd, ("activations_sent", "activations_recv",
                                          "rdv_pulls", "rdv_bytes", "eager_sent",
                                          "eager_recv", "parked"))
            frames = delta(ce.stats, b_ce, ("frames_sent", "am_bytes", "get_bytes"))
            moved = delta(cuda.stats, b_dev, ("bytes_in", "bytes_out", "bytes_d2d",
                                              "executed_tasks"))
            own = dpotrf_home_bytes(A, r, tp)
            check(moved["bytes_d2d"] == 0,
                  f"tcp rank {r} {name}: bytes_d2d {moved['bytes_d2d']} on a serializing wire")
            check(moved["bytes_in"] == own + wire["rdv_bytes"],
                  f"tcp rank {r} {name}: bytes_in {moved['bytes_in']}, expected its own "
                  f"tiles' {own} + the {wire['rdv_bytes']} bytes it pulled")
            equal_tiles(A, np.load(os.path.join(scratch, f"{name}.npy"), mmap_mode="r"), name)
            tasks = moved["executed_tasks"]
            runs[name] = dict(wall_s=wall, synced_wall_s=synced, tasks=tasks,
                              host_ms_per_task=1e3 * wall / max(1, tasks), launches=counts,
                              own_home_bytes=own, **wire, **frames, **moved, equal=True)
            del A, tp
            gc.collect()
        out["dpotrf"] = runs

        # -- (b) a ring allreduce of a 64 MiB CUDA tensor ----------------------
        gen = torch.Generator(device=dev)
        contribs = []
        for k in range(nr):
            gen.manual_seed(COLL_SEED + k)
            contribs.append(torch.randn(COLL_SHAPE, generator=gen, device=dev))
        x = contribs[r]
        nbytes = x.numel() * x.element_size()
        b_coll, b_ce = dict(ce.coll.stats), dict(ce.stats)
        ce.barrier()
        t0 = time.perf_counter()
        hd = ce.coll_allreduce(x, op="sum", algo="ring", cid=("tcp_allreduce", 0))
        check(hd.wait(timeout=300), f"tcp rank {r} allreduce: timed out")
        res = hd.result()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(isinstance(res, torch.Tensor) and res.device == x.device,
              f"tcp rank {r} allreduce: the result is not a tensor on {x.device}")
        coll = delta(ce.coll.stats, b_coll, ("jit_reduces", "bytes_d2h", "bytes_h2d",
                                             "bytes_landed", "seg_done"))
        frames = delta(ce.stats, b_ce, ("frames_sent", "am_bytes", "get_bytes"))
        ce.barrier()
        t0 = time.perf_counter()
        hh = ce.coll_allreduce(x.cpu(), op="sum", algo="ring", cid=("tcp_allreduce", 1))
        check(hh.wait(timeout=300), f"tcp rank {r} host allreduce: timed out")
        host_wall = time.perf_counter() - t0
        res_h = res.cpu()
        check(torch.equal(res_h, hh.result()),
              f"tcp rank {r} allreduce: differs from the same contributions' host run")
        wide = sum(c.double() for c in contribs)
        rel = ((res.double() - wide).abs().max() / wide.abs().max()).item()
        check(rel <= 1e-5, f"tcp rank {r} allreduce: {rel} from the float64 sum")
        out["allreduce"] = dict(
            nbytes=nbytes, wall_s=wall, host_run_wall_s=host_wall,
            busbw_GBps=2 * (nr - 1) / nr * nbytes / wall / 1e9, rel_err_vs_f64=rel,
            digest=hashlib.sha256(res_h.numpy().tobytes()).hexdigest(),
            equal_host_run=True, result_device=str(res.device), **coll, **frames)
        del contribs, x, res, res_h, wide, hd, hh
        gc.collect()

        # -- (c) NativeDistExecutor on host bodies, then rebind ----------------
        Snd = np.ascontiguousarray(S[:TCP_ND_N, :TCP_ND_N])
        want = np.load(os.path.join(scratch, "native_dist.npy"))

        def nd_pool():
            A = TwoDimBlockCyclic(TCP_ND_N, TCP_ND_N, NB, NB, p=TCP_GRID[0], q=TCP_GRID[1],
                                  myrank=r, name="A", dtype=np.float32).from_array(Snd)
            tp = cholesky_ptg(use_cuda=False, use_cpu=True).taskpool(NT=A.mt, A=A)
            tp.name = "dpotrf_tcp_native_dist"
            return A, tp

        nd = []
        ex = None
        for rnd in range(2):
            A, tp = nd_pool()
            b_rd = dict(rd.stats)
            ce.barrier()
            t0 = time.perf_counter()
            ex = NativeDistExecutor(tp, ce) if ex is None else ex.rebind(tp)
            setup = time.perf_counter() - t0
            n_local = ex.run(nthreads=TCP_ND_THREADS)
            wall = time.perf_counter() - t0
            equal_tiles(A, want, f"native_dist round {rnd}")
            nd.append(dict(round=rnd, rebind=rnd > 0, wall_s=wall, setup_s=setup,
                           local_tasks=n_local, phantoms=ex._n_phantoms, name=ex.name,
                           **delta(rd.stats, b_rd, ("activations_sent", "activations_recv",
                                                    "writebacks_sent", "rdv_pulls")),
                           equal=True))
        ex.close()
        out["native_dist"] = nd
        ce.barrier()
    finally:
        ctx.fini()  # closes the endpoint (the FIN handshake)
    out["rank_s"] = time.perf_counter() - t_start
    print(json.dumps(out), flush=True)
    return 0


def tcp_phase(h):
    """The TCP backend and the launcher on the card: ``chip_smoke.py``
    runs itself as 4 rank processes (``comm.launch.launch(4, [__file__,
    "--tcp-rank"])``, one launch for every part, so CUDA starts once a
    process), each a full ``Context`` over its ``TCPComm`` with its CUDA
    module on ``cuda:0`` under a ``TCP_BUDGET_MB`` zone budget
    (``PARSEC_MCA_device_cuda_mem_budget_mb``).  The parent hands the
    ranks ``S`` and this call's one-rank ``kernels`` and
    ``kernels_trtri`` factors, and the one-rank host factor of the
    native-dist dpotrf it computes, through ``chip_scratch/tcp/`` (removed
    after).  Each rank runs :func:`tcp_rank_main`; the parent checks every
    rank's line: (a) the dpotrf's B1/B2 launches summed over the ranks
    equal the one-rank run's mode by mode, its activations summed equal
    the in-process 4-rank run's (a protocol invariant), every rank's
    ``bytes_d2d`` is 0; (b) the allreduce's result is bit-identical on
    every rank; (c) every native-dist round ran every task once.  One
    ``tcp`` line a part and a ``tcp`` summary: the walls of (a)-(c), the
    4-process dpotrf wall (the slowest rank's, from a common barrier to
    its ``wait``) beside the in-process 4-rank wall of the ``multirank``
    phase, the summed launches."""
    np, torch, say, check, card = h.np, h.torch, h.say, h.check, h.card
    from parsec_tpu_torch.comm.launch import launch
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.dsl.native_exec import NativeExecutor
    from parsec_tpu_torch.ops import cholesky_ptg, dpotrf_task_count

    t_phase = time.perf_counter()
    scratch = tcp_scratch()
    os.makedirs(scratch, exist_ok=True)
    try:
        np.save(os.path.join(scratch, "S.npy"), h.S)
        for name, _kw in TCP_VARIANTS:
            np.save(os.path.join(scratch, f"{name}.npy"), h.mr_factor[name])
        # the one-rank host factor of the native-dist dpotrf
        A = TiledMatrix(TCP_ND_N, TCP_ND_N, NB, NB, name="A", dtype=np.float32).from_array(
            np.ascontiguousarray(h.S[:TCP_ND_N, :TCP_ND_N]))
        ex = NativeExecutor(cholesky_ptg(use_cuda=False, use_cpu=True).taskpool(NT=A.mt, A=A))
        t0 = time.perf_counter()
        ex.run(nthreads=TCP_ND_THREADS)
        nd_one_rank_s = time.perf_counter() - t0
        ex.close()
        np.save(os.path.join(scratch, "native_dist.npy"), A.to_array())
        del A, ex
        gc.collect()
        torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        try:
            results = launch(TCP_NRANKS, [os.path.abspath(__file__), "--tcp-rank"],
                             env={"PARSEC_MCA_device_cuda_mem_budget_mb": str(TCP_BUDGET_MB),
                                  "PARSEC_CHIP_TCP_DIR": scratch},
                             timeout=TCP_TIMEOUT_S)
        except RuntimeError as e:
            raise RuntimeError(f"check failed: tcp: {e}") from None
        launch_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    ranks = [json.loads(res.stdout.strip().splitlines()[-1]) for res in results]
    check([o["rank"] for o in ranks] == list(range(TCP_NRANKS)), "tcp: rank lines out of order")
    nt = N // NB

    summary_launches = {}
    walls = {}
    for name, kw in TCP_VARIANTS:
        runs = [o["dpotrf"][name] for o in ranks]
        summed = {fn: {m: sum(rr["launches"][fn][m] for rr in runs)
                       for m in runs[0]["launches"][fn]}
                  for fn in runs[0]["launches"]}
        check(summed == h.launches[name],
              f"tcp {name}: launches summed over the ranks {summed}, one rank's "
              f"{h.launches[name]}")
        h.launches[f"tcp_{name}"] = summed
        summary_launches[name] = {fn: c["total"] for fn, c in summed.items()}
        acts = sum(rr["activations_sent"] for rr in runs)
        in_proc = h.mr_acts[f"ptg4_{name}"]
        check(acts == in_proc, f"tcp {name}: {acts} activations, the in-process 4-rank "
              f"run's {in_proc}")
        check(all(rr["bytes_d2d"] == 0 for rr in runs), f"tcp {name}: bytes_d2d on the wire")
        check(all(rr["bytes_in"] == rr["own_home_bytes"] + rr["rdv_bytes"] for rr in runs),
              f"tcp {name}: a rank's bytes_in is not its own tiles plus its pulls")
        tasks = [rr["tasks"] for rr in runs]
        ntasks = dpotrf_task_count(nt, use_trtri=kw.get("use_trtri", False))
        check(sum(tasks) == ntasks and all(n > 0 for n in tasks),
              f"tcp {name}: device tasks by rank {tasks}, expected {ntasks} in all")
        wall = max(rr["wall_s"] for rr in runs)
        walls[name] = wall
        in_proc_wall = h.mr_walls[f"ptg4_{name}"]
        fields = {k: [rr[k] for rr in runs] for k in (
            "wall_s", "synced_wall_s", "host_ms_per_task", "tasks", "activations_sent",
            "activations_recv", "rdv_pulls", "rdv_bytes", "frames_sent", "am_bytes",
            "get_bytes", "bytes_in", "bytes_out", "bytes_d2d", "own_home_bytes")}
        say("tcp", run=f"dpotrf_{name}", nranks=TCP_NRANKS, grid=list(TCP_GRID), N=N, nb=NB,
            processes_wall_s=wall, in_process_wall_s=in_proc_wall,
            processes_over_in_process=wall / in_proc_wall, one_rank_wall_s=h.mr_wall[name],
            activations=acts, in_process_activations=in_proc, launches=summed,
            equal_one_rank=True, rank_fields=fields, card=card)
    digests = [o["allreduce"]["digest"] for o in ranks]
    check(len(set(digests)) == 1, f"tcp allreduce: the ranks' results differ ({digests})")
    ar = [o["allreduce"] for o in ranks]
    ar_wall = max(a["wall_s"] for a in ar)
    say("tcp", run="allreduce_ring_sum", nranks=TCP_NRANKS, nbytes=ar[0]["nbytes"],
        wall_s=ar_wall, busbw_GBps=2 * (TCP_NRANKS - 1) / TCP_NRANKS * ar[0]["nbytes"]
        / ar_wall / 1e9, rank_busbw_GBps=[a["busbw_GBps"] for a in ar],
        host_run_wall_s=[a["host_run_wall_s"] for a in ar],
        rel_err_vs_f64=max(a["rel_err_vs_f64"] for a in ar), equal_across_ranks=True,
        equal_host_run=True, result_device=ar[0]["result_device"],
        **{k: [a[k] for a in ar] for k in ("jit_reduces", "bytes_d2h", "bytes_h2d",
                                           "bytes_landed", "seg_done", "frames_sent",
                                           "am_bytes", "get_bytes")}, card=card)
    nd_walls = []
    nd_tasks = dpotrf_task_count(TCP_ND_N // NB)
    for rnd in range(2):
        rows = [o["native_dist"][rnd] for o in ranks]
        check(sum(rw["local_tasks"] for rw in rows) == nd_tasks,
              f"tcp native_dist round {rnd}: local tasks {[rw['local_tasks'] for rw in rows]}, "
              f"expected {nd_tasks} in all")
        nd_walls.append(max(rw["wall_s"] for rw in rows))
        say("tcp", run="native_dist", path="host bodies", round=rnd, rebind=rnd > 0,
            N=TCP_ND_N, nb=NB, processes_wall_s=nd_walls[-1],
            one_rank_host_wall_s=nd_one_rank_s, equal_one_rank_host=True,
            rank_wall_s=[rw["wall_s"] for rw in rows],
            **{k: [rw[k] for rw in rows] for k in ("setup_s", "local_tasks", "phantoms",
                                                   "activations_sent", "writebacks_sent",
                                                   "name")}, card=card)
    say("tcp", run="summary", nranks=TCP_NRANKS, setup_s=setup_s, launch_s=launch_s,
        rank_startup_s=[o["startup_s"] for o in ranks],
        rank_s=[o["rank_s"] for o in ranks],
        dpotrf_processes_wall_s=walls,
        dpotrf_in_process_wall_s={n: h.mr_walls[f"ptg4_{n}"] for n, _ in TCP_VARIANTS},
        allreduce_wall_s=ar_wall, native_dist_wall_s=nd_walls, launches=summary_launches,
        seconds=time.perf_counter() - t_phase, card=card)


# the SPMD layer and the ring graphs: 4 positions / ranks on the one card,
# at the attention path's width (B=1, S=4096, H=32, D=128: four 1024-row
# sequence blocks)
PAR_R = 4
PAR_GRID = (2, 2)
PAR_SEED = 24
PAR_STENCIL_STEPS = 20
PAR_FAIL_S = 5.0
TOL_PAR_GEMM = 1e-5


def parallel_phase(h):
    """The SPMD layer (``parsec_tpu_torch.parallel``) and the ring-attention
    graphs on the card, every mesh position a thread on ``cuda:0``.  (a)
    ``ring_attention`` on a 4-position ring at the prefill's width, causal:
    f32 with ``use_kernels`` (twice, ``torch.equal``), bf16 with
    ``use_kernels`` — each 4 positions x 4 steps = 16 batched B5 launches
    of B·H = 32 members — and f32 without; non-causal f32 with
    ``use_kernels``; each within 2e-5 (bf16 5e-2) of ``attention_reference``
    in float64.  (b) ``run_ring_attention_graph`` at 4 in-process ranks,
    every rank's CUDA module on ``cuda:0``: causal f32 (640 tasks, 512
    single B5 launches) ``torch.equal`` to (a)'s f32 ``use_kernels``
    output (the same B5 updates in the same ``(r + s) % R`` order), and
    the ``bcast`` variant non-causal within 2e-5 of the oracle and of
    (a)'s non-causal run; each rank's wire bytes (every rank receives
    the other ranks' K and V planes once).  (c)
    ``ulysses_attention`` within 2e-5.  (d) on a 2x2 mesh:
    ``spmd_cholesky`` of the dpotrf path's S (N=8192, nb=512, f32) within
    the dpotrf gate, beside the unsharded run; ``summa_gemm`` and, on the
    4x1 ring, ``ring_gemm`` at 8192^2 within ``TOL_PAR_GEMM`` of
    ``torch.matmul``; ``spmd_stencil_5pt`` on 8192^2 x 20 steps within
    1e-5 of the plain stencil.  (e) a position that raises: the call
    raises within ``PAR_FAIL_S`` and the next call passes.  Then B5 at
    the ring's block (1024 x 1024 x 128), single f32 and batched f32 and
    bf16 over 32 members, each against its plain version, timed, with its
    bound.  Returns the B5 launches for the kernel table and the three
    rows at the ring's block."""
    np, torch, dev, card, say, check = h.np, h.torch, h.dev, h.card, h.say, h.check
    from torch.func import vmap

    from parsec_tpu_torch import parallel
    from parsec_tpu_torch.comm import InprocFabric
    from parsec_tpu_torch.ops import kernels, run_ring_attention_graph
    from parsec_tpu_torch.parallel import collectives
    from parsec_tpu_torch.parallel.shard_map import P, shard_map

    t_phase = time.perf_counter()
    b5 = kernels.flash_attention_block
    R, G, sb = PAR_R, ATTN_B * ATTN_H, ATTN_S // PAR_R
    ring = parallel.make_mesh((R, 1), axes=("sp", "u"), devices=[dev] * R)
    grid = parallel.make_mesh(PAR_GRID, devices=[dev] * (PAR_GRID[0] * PAR_GRID[1]))
    check(all(d == dev for d in ring.devices.flat) and ring.shape == {"sp": R, "u": 1},
          f"parallel: ring mesh {ring}")
    rng = np.random.default_rng(PAR_SEED)
    q_np, k_np, v_np = (rng.standard_normal((ATTN_B, ATTN_S, ATTN_H, ATTN_D))
                        .astype(np.float32) for _ in range(3))
    q, k, v = (torch.from_numpy(a).to(dev) for a in (q_np, k_np, v_np))

    def counts():
        return dict(b5.launches_by_mode, total=b5.launches, members=b5.members)

    def gate(out, ref, tol):
        """max(|out - ref| - tol*|ref|) (<= tol: allclose at rtol = atol =
        tol) and the max abs difference, in float64 on the card."""
        diff = (out.to(dev).double() - ref).abs()
        return (diff - tol * ref.abs()).max().item(), diff.max().item()

    oracle = {}

    def ref_of(dtype, causal):
        key = (dtype, causal)
        if key not in oracle:
            oracle[key] = parallel.attention_reference(
                *(t.to(dtype).double() for t in (q, k, v)), causal=causal)
        return oracle[key]

    # -- (a) the SPMD ring --------------------------------------------------
    spmd_out, launches, single, batched = {}, {}, {}, {}
    runs = [("f32_kernels", torch.float32, True, True),
            ("f32_kernels_rerun", torch.float32, True, True),
            ("bf16_kernels", torch.bfloat16, True, True),
            ("f32_einsum", torch.float32, True, False),
            ("f32_kernels_noncausal", torch.float32, False, True)]
    for label, dt, causal, use_kernels in runs:
        qi, ki, vi = (t.to(dt) for t in (q, k, v))
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        out = parallel.ring_attention(qi, ki, vi, ring, axis="sp", causal=causal,
                                      use_kernels=use_kernels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        mode = "bf16_b" if dt == torch.bfloat16 else "f32_b"
        want = R * R if use_kernels else 0
        check(c["total"] == want and c[mode] == want and c["members"] == want * G,
              f"parallel spmd {label}: B5 launches {c}, expected {want} {mode} of {G} members")
        check(tuple(out.shape) == tuple(q.shape) and out.dtype == dt and out.device == dev
              and bool(torch.isfinite(out).all()),
              f"parallel spmd {label}: output {tuple(out.shape)} {out.dtype} {out.device}")
        tol = TOL_ATTN_BF16 if dt == torch.bfloat16 else TOL_ATTN_F32
        g, err = gate(out, ref_of(dt, causal), tol)
        check(g <= tol, f"parallel spmd {label}: |out - ref| - {tol}|ref| reaches {g}")
        if label == "f32_kernels_rerun":
            check(torch.equal(out, spmd_out["f32_kernels"]),
                  "parallel spmd: a rerun differs from the first run")
        spmd_out[label] = out
        if use_kernels:
            batched[f"parallel_spmd_{label}"] = {"flash_attention_block": c}
        launches[f"spmd_{label}"] = c["total"]
        say("parallel_spmd", run=label, positions=R, B=ATTN_B, S=ATTN_S, H=ATTN_H,
            D=ATTN_D, dtype=str(dt), causal=causal, use_kernels=use_kernels,
            launches=c["total"], members=c["members"], wall_s=wall,
            nominal_gflops=4.0 * G * ATTN_S * ATTN_S * ATTN_D / wall / 1e9,
            max_abs_err=err, gate=g, tol=tol, card=card)
        del qi, ki, vi

    # -- (b) the ring PTG at 4 in-process ranks -----------------------------
    ptg_out = {}
    for label, variant, causal in (("ring_causal", "ring", True),
                                   ("bcast_noncausal", "bcast", False)):
        fabric = InprocFabric(R)
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        out, stats = run_ring_attention_graph(R, q_np, k_np, v_np, causal=causal,
                                              variant=variant, use_cpu=False,
                                              fabric=fabric, timeout=600)
        wall = time.perf_counter() - t0
        c = counts()
        tasks = G * R * (R + 1) + (G * R if variant == "bcast" else 0)
        check(stats["executed_tasks"] == tasks,
              f"parallel ptg {label}: {stats['executed_tasks']} tasks, expected {tasks}")
        check(c["total"] == c["f32"] == G * R * R,
              f"parallel ptg {label}: B5 launches {c}, expected {G * R * R} f32")
        # every rank receives every other rank's K and V planes once: the
        # ring forwards them one hop a step, the bcast variant down its tree
        rank_wire = [int(fabric.engines[r].stats.get("am_bytes", 0)
                         + fabric.engines[r].stats.get("get_bytes", 0)) for r in range(R)]
        plane_bytes = sb * ATTN_D * 4
        check(stats["activations"] > 0
              and sum(rank_wire) == R * (R - 1) * G * 2 * plane_bytes
              and (variant == "bcast" or rank_wire == [(R - 1) * G * 2 * plane_bytes] * R),
              f"parallel ptg {label}: wire bytes a rank {rank_wire}")
        g, err = gate(out, ref_of(torch.float32, causal), TOL_ATTN_F32)
        check(g <= TOL_ATTN_F32, f"parallel ptg {label}: gate {g}")
        spmd = spmd_out["f32_kernels" if causal else "f32_kernels_noncausal"].cpu()
        equal = bool(torch.equal(out, spmd))
        if causal:
            check(equal, "parallel ptg ring: not torch.equal to the SPMD ring with "
                  f"use_kernels (max abs diff {(out - spmd).abs().max().item()})")
        else:
            g2, _ = gate(out, spmd.to(dev).double(), TOL_ATTN_F32)
            check(g2 <= TOL_ATTN_F32, f"parallel ptg bcast: gate {g2} against the SPMD ring")
        ptg_out[label] = out
        single[f"parallel_ptg_{label}"] = c
        launches[f"ptg_{label}"] = c["total"]
        say("parallel_ptg", run=label, variant=variant, causal=causal, ranks=R, tasks=tasks,
            launches=c["total"], wall_s=wall, tasks_per_s=tasks / wall,
            host_ms_per_task=1e3 * wall / tasks,
            rank_wall_s=stats["rank_wall_s"], activations=stats["activations"],
            bytes_d2d=stats["bytes_d2d"], wire_bytes=stats["wire_bytes"],
            rank_wire_bytes=rank_wire,
            eager_hit_rate=stats["eager_hit_rate"], equal_spmd=equal,
            max_abs_err=err, gate=g, card=card)
        del out, stats, fabric

    # -- (c) Ulysses --------------------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = parallel.ulysses_attention(q, k, v, ring, axis="sp", causal=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    g, err = gate(out, ref_of(torch.float32, True), TOL_ATTN_F32)
    check(g <= TOL_ATTN_F32 and out.device == dev, f"parallel ulysses: gate {g}")
    say("parallel_ulysses", positions=R, causal=True, wall_s=wall, max_abs_err=err, gate=g,
        card=card)
    del out, q, k, v, spmd_out, ptg_out
    oracle.clear()
    torch.cuda.empty_cache()

    # -- (d) the dense SPMD kernels on a 2x2 mesh ---------------------------
    S = torch.from_numpy(h.S).to(dev)
    S64 = S.double()
    chol = {}
    for label, mesh in (("unsharded", None), ("sharded_2x2", grid)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Lf = parallel.spmd_cholesky(S, NB, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        L = Lf.tril()
        Ld = L.double()
        recon = ((Ld @ Ld.mT - S64).abs().max() / S64.abs().max()).item()
        check(recon < 1e-3 and L.device == dev and L.dtype == torch.float32,
              f"parallel spmd_cholesky {label}: ||LL^T - S||/||S|| = {recon}")
        chol[label] = L
        say("parallel_dense", run=f"spmd_cholesky_{label}", N=N, nb=NB, wall_s=wall,
            gflops=N ** 3 / 3 / wall / 1e9, recon_err=recon, card=card)
        del Lf, Ld
    diff = (chol["sharded_2x2"] - chol["unsharded"]).abs().max().item()
    say("parallel_dense", run="spmd_cholesky_sharded_vs_unsharded", max_abs_diff=diff,
        card=card)
    del chol, S64, L
    gen = torch.Generator(device=dev)
    gen.manual_seed(PAR_SEED)
    A = torch.randn((N, N), generator=gen, device=dev)
    Bm = torch.randn((N, N), generator=gen, device=dev)
    ref = A @ Bm
    for label, fn in (("summa_gemm_2x2", lambda: parallel.summa_gemm(A, Bm, grid)),
                      ("ring_gemm_4x1", lambda: parallel.ring_gemm(A, Bm, ring, axis="sp"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        err = ((C.double() - ref.double()).abs().max() / ref.double().abs().max()).item()
        check(err < TOL_PAR_GEMM and C.device == dev, f"parallel {label}: error {err}")
        say("parallel_dense", run=label, N=N, wall_s=wall, tflops=2 * N ** 3 / wall / 1e12,
            rel_err=err, tol=TOL_PAR_GEMM, card=card)
        del C
    del A, Bm, ref
    g0 = torch.randn((N, N), generator=gen, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = parallel.spmd_stencil_5pt(g0, PAR_STENCIL_STEPS, grid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plain = kernels.stencil_5pt_fused_plain(g0, PAR_STENCIL_STEPS)
    err = (out - plain).abs().max().item()
    check(err <= TOL_STENCIL_PATH and out.device == dev, f"parallel spmd_stencil: error {err}")
    say("parallel_dense", run="spmd_stencil_2x2", N=N, steps=PAR_STENCIL_STEPS, wall_s=wall,
        gcells_per_s=N * N * PAR_STENCIL_STEPS / wall / 1e9, max_abs_err=err,
        equal_plain=bool(torch.equal(out, plain)), card=card)
    del g0, out, plain, S
    torch.cuda.empty_cache()

    # -- (e) a position that raises ------------------------------------------
    x = torch.arange(float(R), device=dev).reshape(R, 1)

    def bad(t):
        if collectives.my_index("sp") == 2:
            raise ValueError("position 2 fails")
        return collectives.allreduce_sum(t, "sp")

    t0 = time.perf_counter()
    raised = None
    try:
        shard_map(bad, ring, P("sp", None), P("sp", None))(x)
    except ValueError as e:
        raised = str(e)
    fail_s = time.perf_counter() - t0
    check(raised == "position 2 fails" and fail_s < PAR_FAIL_S,
          f"parallel: a failing position gave {raised!r} after {fail_s} s")
    after = shard_map(lambda t: collectives.allreduce_sum(t, "sp"), ring, P("sp", None),
                      P("sp", None))(x)
    check(after.cpu().ravel().tolist() == [float(sum(range(R)))] * R,
          f"parallel: the call after a failure gave {after.ravel().tolist()}")
    say("parallel_abort", raised=raised, seconds=fail_s, next_call_ok=True, card=card)

    # -- B5 at the ring's block ---------------------------------------------
    rows = []
    q_off, k_off = sb, 0  # a block below the diagonal: every pair computed
    pairs = h.attn_pairs(sb, sb, q_off, k_off, True)
    kw = dict(causal=True, scale=ATTN_D ** -0.5)
    for label, dt, n_mem in (("f32", torch.float32, 1), ("f32_b", torch.float32, G),
                             ("bf16_b", torch.bfloat16, G)):
        gen.manual_seed(PAR_SEED + n_mem)
        qb, kb, vb = (torch.randn((n_mem, sb, ATTN_D), generator=gen, device=dev).to(dt)
                      for _ in range(3))
        acc = torch.randn((n_mem, sb, ATTN_D), generator=gen, device=dev)
        m = torch.randn((n_mem, sb, 1), generator=gen, device=dev)
        l = torch.randn((n_mem, sb, 1), generator=gen, device=dev).abs()
        args = (qb, kb, vb, acc, m, l)
        if n_mem == 1:
            run = lambda: b5(*(t[0] for t in args), q_off, k_off, **kw)  # noqa: E731
            plain = lambda: kernels.flash_attention_block_plain(  # noqa: E731
                *(t[0] for t in args), q_off, k_off, **kw)
        else:
            run = lambda: vmap(lambda *a: b5(*a, q_off, k_off, **kw))(*args)  # noqa: E731
            plain = lambda: kernels.flash_attention_block_plain(  # noqa: E731
                *args, q_off, k_off, **kw)
        out, out2, ref = run(), run(), plain()
        torch.cuda.synchronize()
        err = h.carry_err(out, ref)
        same = all(torch.equal(a, b) for a, b in zip(out, out2))
        one_by_one = None
        if n_mem > 1:
            ones = [b5(*(t[i] for t in args), q_off, k_off, **kw) for i in range(n_mem)]
            one_by_one = all(torch.equal(out[j][i], ones[i][j])
                             for i in range(n_mem) for j in range(3))
        check(err < TOL_ATTN and same and one_by_one in (None, True),
              f"flash_attention_block[{label}] at the ring's block: error {err}, two "
              f"launches equal {same}, equal one by one {one_by_one}")
        isz = qb.element_size()
        nbytes = n_mem * ((3 * sb * ATTN_D) * isz + 2 * sb * ATTN_D * 4 + 4 * sb * 4)
        flops, op_type = ((6 * ATTN_D * pairs * n_mem, "bf16") if dt == torch.bfloat16
                          else (3 * 4 * ATTN_D * pairs * n_mem, "tf32"))
        bound_ms, bound_by = h.bound(flops, nbytes, op_type)
        n_launch = sum(cs[label] for cs in single.values()) if n_mem == 1 else \
            sum(cs["flash_attention_block"][label] for cs in batched.values())
        row = {"name": f"flash_attention_block[{label}_ring]", "route": "cuda",
               "shape": ([n_mem] if n_mem > 1 else []) + [sb, sb, ATTN_D],
               "source": "parsec_tpu_torch/csrc/attention.cu",
               "replaces": "parsec_tpu/ops/pallas_kernels.py:283",
               "launches": n_launch, "max_abs_err": err,
               "ms": h.time_ms(run, 10), "plain_ms": h.time_ms(plain, 3),
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
               "library_call": "none"}
        if n_mem > 1:
            row["members"] = n_mem
            row["one_by_one_ms"] = h.time_ms(
                lambda: [b5(*(t[i] for t in args), q_off, k_off, **kw) for i in range(n_mem)], 3)
        rows.append(row)
        say("kernel", **row)
        del qb, kb, vb, acc, m, l, args, out, out2, ref
    torch.cuda.empty_cache()
    say("parallel", launches=launches, seconds=time.perf_counter() - t_phase, card=card)
    return {"single": single, "batched": batched, "rows": rows}



#: the tutorial examples of ``parsec_tpu_torch.examples``, in the order
#: the README lists them
EXAMPLES = ("ex00_startstop", "ex01_helloworld", "ex02_chain", "ex03_chain_multirank",
            "ex04_chaindata", "ex05_broadcast", "ex06_raw", "ex07_raw_ctl",
            "ex08_cuda_graph", "ex09_jdf_graph", "ex10_sequence_parallel",
            "ex11_kernels_native", "ex12_qr_lu", "ex13_segmented_native_dist",
            "ex14_round4_features", "dtd.dtd_helloworld", "dtd.dtd_hello_arg",
            "dtd.dtd_untied")
TOL_EX_DPOTRF = 1e-3   # the dpotrf path's gate
TOL_EX_RING = 1e-4     # ex10's own bound


def examples_phase(h):
    """The tutorial examples on the card.  Every example's
    ``main(device="cuda")`` at its own defaults, timed, with the kernel
    launches it made: ex10's ring with ``use_kernels`` must make R² = 64
    batched B5 launches of B·H = 16 members (one a position a step) and
    agree with its einsum ring within ``TOL_EX_RING``; ex11's kernel
    chores under a ``GraphExecutor`` must make the dpotrf's syrk and gemm
    count for NT = 4 in B1 f32 launches a replay, twice in the first call
    (the warm-up and the replay).  Then ex08 and ex11 part 1 at the main
    path's width (N=8192, nb=512) on the path's input S: ex11 with
    ``use_kernels=False`` ``torch.equal`` to ex08 (the same DAG), ex11
    with kernels ``torch.equal`` to the dynamic path's ``kernels`` factor
    and within ``TOL_EX_DPOTRF`` of the run without.  Adds each run's
    B1/B2 launches to ``h.launches`` and returns ex10's batched B5
    launches for the kernel table (no other example launches B5)."""
    import importlib

    np, torch, card, say, check = h.np, h.torch, h.card, h.say, h.check
    from parsec_tpu_torch.ops import dpotrf_task_count, kernels

    t_phase = time.perf_counter()
    b5 = kernels.flash_attention_block
    batched, walls = {}, {}

    def n_upd(nt):
        return nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6

    def run(label, name, **kw):
        mod = importlib.import_module(f"parsec_tpu_torch.examples.{name}")
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        res = mod.main(device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mm = {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
              for fn in (kernels.matmul_update, kernels.matmul)}
        attn = dict(b5.launches_by_mode, total=b5.launches, members=b5.members)
        h.launches[f"examples_{label}"] = mm
        if attn["total"]:
            batched[f"examples_{label}"] = {"flash_attention_block": attn}
        walls[label] = wall
        say("examples", example=label, wall_s=wall,
            launches={"matmul_update": mm["matmul_update"]["total"],
                      "matmul": mm["matmul"]["total"], "flash_attention_block": attn["total"],
                      "flash_attention_block_members": attn["members"]},
            card=card)
        return res, mm, attn

    for name in EXAMPLES:
        res, mm, attn = run(name, name)
        check(isinstance(res, dict) and res, f"examples {name}: returned {type(res)}")
        if name == "ex10_sequence_parallel":
            R, G = 8, 2 * 8
            check(attn["total"] == attn["f32_b"] == R * R and attn["members"] == R * R * G,
                  f"examples ex10: B5 launches {attn}, expected {R * R} f32_b of {G} members")
            diff = (res["ring_kernels"] - res["ring"]).abs().max().item()
            check(res["ring_kernels"].device.type == "cuda" and diff <= TOL_EX_RING
                  and res["ring_kernels_err"] <= TOL_EX_RING,
                  f"examples ex10: the B5 ring differs from the einsum ring by {diff}")
            say("examples_ring", positions=R, members=G, launches=attn["total"],
                max_abs_diff_einsum=diff, max_abs_err=res["ring_kernels_err"],
                tol=TOL_EX_RING, card=card)
        elif name == "ex11_kernels_native":
            want = n_upd(256 // 64)
            check(mm["matmul_update"]["total"] == mm["matmul_update"]["f32"] == 2 * want
                  and res["replay_launches"].get(("matmul_update", "f32")) == want,
                  f"examples ex11: B1 launches {mm['matmul_update']}, a replay "
                  f"{res['replay_launches']}, expected {want} a replay")
        elif name == "ex12_qr_lu":
            check("R_device" in res, "examples ex12: no device-body run on the card")
        else:
            check(attn["total"] == 0, f"examples {name}: B5 launches {attn}")

    # ex08 and ex11 part 1 at the main path's width, on its input
    nt = N // NB
    S = h.S
    full = {}
    for label, name, kw in (("ex08_full", "ex08_cuda_graph", {}),
                            ("ex11_full_plain", "ex11_kernels_native",
                             dict(use_kernels=False, native=False)),
                            ("ex11_full_kernels", "ex11_kernels_native", dict(native=False))):
        res, mm, attn = run(label, name, n=N, nb=NB, S=S, **kw)
        kernel_run = label == "ex11_full_kernels"
        want = n_upd(nt) if kernel_run else 0
        check(mm["matmul_update"]["total"] == mm["matmul_update"]["f32"] == 2 * want
              and mm["matmul"]["total"] == 0 and attn["total"] == 0
              and res["replay_launches"].get(("matmul_update", "f32"), 0) == want,
              f"examples {label}: launches {mm}, a replay {res['replay_launches']}, "
              f"expected {want} B1 f32 a replay")
        check(res["tasks"] == dpotrf_task_count(nt),
              f"examples {label}: {res['tasks']} tasks, expected {dpotrf_task_count(nt)}")
        full[label] = torch.from_numpy(res["factor"])
        say("examples_full", example=label, N=N, nb=NB, wall_s=walls[label],
            tasks=res["tasks"], b1_launches=mm["matmul_update"]["total"],
            b1_per_replay=want, card=card)
        del res
    check(torch.equal(full["ex11_full_plain"], full["ex08_full"]),
          "examples: ex11 without kernels is not torch.equal to ex08")
    check(torch.equal(full["ex11_full_kernels"], torch.from_numpy(h.kernels_factor)),
          "examples: ex11's kernel factor is not torch.equal to the dynamic kernels factor")
    dev = h.dev
    Lk = full["ex11_full_kernels"].to(dev).double().tril()
    Lp = full["ex11_full_plain"].to(dev).double().tril()
    rel = ((Lk - Lp).abs().max() / Lp.abs().max()).item()
    check(rel < TOL_EX_DPOTRF, f"examples: ex11 with kernels is {rel} from the run without")
    del Lk, Lp, full
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    say("examples_summary", examples=len(EXAMPLES), kernels_vs_plain_rel=rel,
        tol=TOL_EX_DPOTRF, walls_s=walls, seconds=seconds, card=card)
    return batched


TUNE_BLOCKS = (256, 512)
TUNE_NB = (256, 512, 1024)


def tuning_line(h, doc, seconds):
    """One ``tuning`` line: a persisted search document and its key."""
    from parsec_tpu_torch import tuning

    h.check(not doc["failures"], f"tuning {doc['op']} {doc['param']}: failed candidates "
            f"{doc['failures']}")
    h.check(doc["device_kind"] == h.kind, f"tuning {doc['op']}: keyed on "
            f"{doc['device_kind']!r}, not the card {h.kind!r}")
    key = tuning.tune_key(doc["op"], doc["n"], doc["dtype"], doc["device_kind"], doc["param"])
    h.check(tuning.default_store().load(key) == doc, f"tuning {key}: not persisted")
    h.say("tuning", op=doc["op"], param=doc["param"], n=doc["n"], dtype=doc["dtype"],
          best=doc["best"], timings_s=doc["timings_s"], failures=doc["failures"],
          reps=doc["reps"], meta=doc["meta"], key=key, search_s=seconds, card=h.card)
    return key


def _launch_readers(kernels):
    """(B5 counts, B1/B2 counts) readers in the forms the kernel table sums."""
    b5 = kernels.flash_attention_block

    def b5_counts():
        return dict(b5.launches_by_mode, total=b5.launches)

    def mm_counts():
        return {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                for fn in (kernels.matmul_update, kernels.matmul)}

    return b5_counts, mm_counts


def tuning_phase(h):
    """``autotune_attention`` at the prefill's geometry over TUNE_BLOCKS
    (the kv sweep against the q winner), then a prefill with "auto"
    blocks, its B5 launches and output those of an explicit run with the
    winners; ``autotune_nb("dpotrf", N)`` over TUNE_NB; the wave search at
    the reference's default, a caller's explicit setting restored after it
    (the segmented Cholesky's search runs in factorization_phases, beside
    its gate).  Runs under the fresh cache root main set: no winner of an
    earlier run is read.  ``h`` carries main's helpers, the prefill's
    inputs and ``run_attention``, and the launch dicts, which take the
    phase's launches."""
    torch, card, say, check = h.torch, h.card, h.say, h.check
    from parsec_tpu_torch import mca_param, tuning
    from parsec_tpu_torch.ops import attention, attention_task_count, kernels

    b5_counts, _ = _launch_readers(kernels)
    # -- the attention blocks at Llama-2-7B's layer ---------------------------
    kernels.reset_counts()
    t0 = time.perf_counter()
    docs = tuning.autotune_attention(ATTN_S, d=ATTN_D, heads=ATTN_H, batch=ATTN_B,
                                     dtype="float32", causal=True, candidates=TUNE_BLOCKS,
                                     reps=1)
    sweep_s = time.perf_counter() - t0
    h.attn_launches["tuning_sweep"] = b5_counts()
    for doc in docs.values():
        tuning_line(h, doc, sweep_s)
    qb, kvb = docs["q_block"]["best"], docs["kv_block"]["best"]
    check((attention._resolve_block("auto", "q_block", ATTN_S, torch.float32),
           attention._resolve_block("auto", "kv_block", ATTN_S, torch.float32)) == (qb, kvb),
          "attention: auto blocks do not resolve to the persisted winners")
    explicit, wall_e, n_e, _ = h.run_attention(*h.pf_in, causal=True, q_block=qb,
                                               kv_block=kvb)
    auto, wall_a, n_a, _ = h.run_attention(*h.pf_in, causal=True, q_block="auto",
                                           kv_block="auto")
    steps = attention_task_count(ATTN_B, ATTN_S, ATTN_S, ATTN_H, qb, kvb, causal=True) \
        - ATTN_B * ATTN_H * (-(-ATTN_S // qb))
    check(n_a == n_e and n_a["f32"] == n_a["total"] == steps,
          f"attention auto: B5 launches {n_a}, explicit ({qb}, {kvb}) {n_e}, steps {steps}")
    check(torch.equal(auto, explicit), "attention auto: output differs from the explicit "
          "blocks' run")
    h.attn_launches["tuning_explicit"], h.attn_launches["tuning_auto"] = n_e, n_a
    say("tuning_auto", path="attention", q_block=qb, kv_block=kvb, launches=n_a["total"],
        wall_auto_s=wall_a, wall_explicit_s=wall_e, equal_explicit=True, card=card)
    del explicit, auto

    # -- dpotrf N=8192 and the wave-batch minimum -------------------------------
    t0 = time.perf_counter()
    doc = tuning.autotune_nb("dpotrf", N, candidates=TUNE_NB, reps=1)
    key = tuning_line(h, doc, time.perf_counter() - t0)
    check(tuning._SAFE.sub("-", h.kind) in key, f"dpotrf: key {key} lacks the card's name")
    with mca(mca_param, "device", "cuda_wave_batch", 0):  # a caller's explicit setting
        t0 = time.perf_counter()
        doc = tuning.autotune_wave(reps=1)
        wave_s = time.perf_counter() - t0
        check(mca_param.source("device", "cuda_wave_batch") == "api"
              and mca_param.get("device", "cuda_wave_batch") == 0,
              "autotune_wave: the caller's cuda_wave_batch was not restored")
    tuning_line(h, doc, wave_s)


def program_cache_phase(h):
    """For dpotrf ``kernels`` and the f32 prefill, unbatched and
    level-batched, a GraphExecutor on a fresh same-shaped pool after the
    graph phases' first one: its first call captures nothing (the cache's
    captures unchanged, one more hit), launches a warm-up and a replay of
    the first executor's launches, and returns the first executor's bits
    on the same feeds.  ``h`` carries the dpotrf matrix ``S``, the graph
    phases' executors with their feeds (``graph_execs``,
    ``batched_execs``) and first-call seconds (``first_calls``), the
    prefill's inputs, and the launch dicts."""
    np, torch, card, say, check = h.np, h.torch, h.card, h.say, h.check
    from parsec_tpu_torch import compile_cache
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.dsl import GraphExecutor
    from parsec_tpu_torch.ops import build_flash_attention, cholesky_ptg, kernels

    b5_counts, mm_counts = _launch_readers(kernels)
    b5 = kernels.flash_attention_block
    cache = compile_cache.default_cache()

    def fresh_pool(path):
        if path == "dpotrf":
            A = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(h.S)
            return cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True).taskpool(
                NT=A.mt, A=A)
        return build_flash_attention(*h.pf_in, use_cpu=False, **h.pf_kw)[0]

    for label, path in (("dpotrf_kernels", "dpotrf"), (h.pf_name, "attention")):
        for batched, execs in ((False, h.graph_execs), (True, h.batched_execs)):
            first, feeds = execs[label]
            tp = fresh_pool(path)
            before = cache.snapshot()
            gc.collect()
            t0 = time.perf_counter()
            ex = GraphExecutor(tp, batch_levels=batched)
            plan_s = time.perf_counter() - t0
            kernels.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ex.apply(feeds)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counted = {k: n for k, n in kernels.launch_counts().items() if n}
            after = cache.snapshot()
            what = f"program_cache {label}{' batched' if batched else ''}"
            check(ex.cache_hit and after["captures"] == before["captures"]
                  and after["hits"] == before["hits"] + 1,
                  f"{what}: cache {before} -> {after}, hit {ex.cache_hit}")
            check(ex.launches == first.launches,
                  f"{what}: launches a replay {ex.launches}, the first's {first.launches}")
            check(counted == {k: 2 * n for k, n in first.launches.items() if n},
                  f"{what}: first call launched {counted}, not a warm-up and a replay of "
                  f"{first.launches}")
            if batched:
                check(ex.batch_fallbacks == 0 and ex.group_counts() == first.group_counts(),
                      f"{what}: groups {ex.group_counts()}, the first's {first.group_counts()}")
            ref = first.apply(feeds)
            torch.cuda.synchronize()
            check(all(torch.equal(out[k], ref[k]) for k in ref),
                  f"{what}: outputs differ from the first executor's")
            runs = mm_counts() if path == "dpotrf" else {b5.__name__: b5_counts()}
            tag = f"program_cache_{label}"
            if batched:
                h.batched_launches[f"{tag}_batched"] = runs
            elif path == "dpotrf":
                h.launches[tag] = runs
            else:
                h.attn_launches[tag] = runs[b5.__name__]
            say("program_cache", path=label, batch_levels=batched, plan_s=plan_s,
                first_call_s=first_s, first_executor_first_call_s=h.first_calls[(label, batched)],
                capture_s=ex.capture_s, first_executor_capture_s=first.capture_s,
                launches_per_call={f"{fn}[{m}]": n for (fn, m), n in ex.launches.items() if n},
                graph_pool_bytes=ex.graph_pool_bytes, cache=after,
                equal_first_executor=True, card=card)
            del ex, out, ref, tp


def fusion_cache_phase(h):
    """Dynamic dpotrf ``kernels`` from one PTG definition in one context:
    fusion off, then ``auto`` on two same-shaped pools; the second takes
    the cached partition (no capture, no partition), every factor and
    every run's launches equal.  ``h`` carries the dpotrf matrix ``S`` and
    the launch dicts."""
    np, torch, card, say, check = h.np, h.torch, h.card, h.say, h.check
    from parsec_tpu_torch import Context, mca_param
    from parsec_tpu_torch.datadist import TiledMatrix
    from parsec_tpu_torch.dsl import fusion
    from parsec_tpu_torch.ops import cholesky_ptg, kernels

    _, mm_counts = _launch_readers(kernels)
    ptg = cholesky_ptg(use_cuda=True, use_cpu=False, use_kernels=True)
    rows, mats = [], []
    ctx = Context()
    try:
        cuda_dev = next(d for d in ctx.devices if d.mca_name == "cuda")
        for rep, mode in enumerate(("off", "auto", "auto")):
            with mca(mca_param, "runtime", "fusion", mode):
                A = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(h.S)
                tp = ptg.taskpool(NT=A.mt, A=A)
                before, fused = dict(fusion.stats), cuda_dev.stats["fused_submits"]
                kernels.reset_counts()
                gc.collect()
                t0 = time.perf_counter()
                ctx.add_taskpool(tp)
                ok = tp.wait(timeout=600)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                check(ok, f"fusion_cache {mode} {rep}: {tp.fail_reason}")
                counts = mm_counts()
                check(counts == h.launches["kernels"],
                      f"fusion_cache {mode} {rep}: launches {counts}")
                h.launches[f"fusion_cache_{mode}_{rep}"] = counts
                delta = {k: fusion.stats[k] - before[k] for k in before}
                regions = len(tp._fusion.live) if tp._fusion is not None else 0
                rows.append(dict(mode=mode, rep=rep, wall_s=wall, setup_s=tp.fusion_setup_s,
                                 regions=regions, **delta,
                                 fused_submits=cuda_dev.stats["fused_submits"] - fused))
                mats.append(A)
                del tp
    finally:
        ctx.fini()
    off, miss, hit = rows
    check((off["captures"], off["partitions"], off["hits"], off["regions"]) == (0, 0, 0, 0),
          f"fusion_cache off: {off}")
    check((miss["captures"], miss["partitions"], miss["hits"]) == (1, 1, 0)
          and miss["regions"] > 0 and miss["fused_submits"] == miss["regions"],
          f"fusion_cache first fused pool: {miss}")
    check((hit["captures"], hit["partitions"], hit["hits"]) == (0, 0, 1)
          and hit["regions"] == miss["regions"] and hit["fused_submits"] == hit["regions"],
          f"fusion_cache second fused pool: {hit}")
    factors = [m.to_array() for m in mats]
    check(np.array_equal(factors[1], factors[0]) and np.array_equal(factors[2], factors[0]),
          "fusion_cache: a fused factor differs from fusion off's")
    say("fusion_cache", path="dpotrf kernels", N=N, nb=NB, runs=rows,
        setup_first_s=miss["setup_s"], setup_cached_s=hit["setup_s"],
        equal_fusion_off=True, card=card)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from parsec_tpu_torch import Context, mca_param
        from parsec_tpu_torch.datadist import TiledMatrix
        from parsec_tpu_torch.ops import (
            StencilBuffers,
            attention_task_count,
            cholesky_ptg,
            dpotrf_task_count,
            build_flash_attention,
            kernels,
            run_flash_attention,
            run_flash_attention_native,
            stencil_ptg,
        )
        from parsec_tpu_torch import native
        from parsec_tpu_torch.device import cuda as cuda_module
        from parsec_tpu_torch.dsl import GraphExecutor
        from parsec_tpu_torch.dsl import fusion
        from parsec_tpu_torch.dsl.native_exec import NativeExecutor
        from parsec_tpu_torch.parallel import attention_reference
    except ImportError as e:
        print(f"chip_smoke: the parsec_tpu_torch package is not importable "
              f"({e}); run from the root of a checkout", file=sys.stderr)
        return 2

    # a fresh cache root for this run: the autotuner's winners of an
    # earlier run are never read, and nothing is written beyond the temp dir
    cache_root = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    atexit.register(shutil.rmtree, cache_root, True)
    os.environ["PARSEC_TPU_COMPILE_CACHE"] = cache_root

    torch.backends.cuda.matmul.allow_tf32 = False  # true FP32 products,
    torch.backends.cudnn.allow_tf32 = False        # never TF32
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    peaks = PEAKS["pcie" if "pcie" in kind.lower() else "sxm"]

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib = kernels.build()
    say("build", seconds=round(time.perf_counter() - t0, 3), library=lib.name,
        torch=torch.__version__, cuda=torch.version.cuda)
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas " + line.strip(), file=sys.stderr)
    # the native engine (g++ over native/src), built here so that no
    # pump run's capture + build time includes the compile
    t0 = time.perf_counter()
    engine = native.load()
    say("build_native", seconds=round(time.perf_counter() - t0, 3), library=engine._name)

    # -- kernel phase -------------------------------------------------------
    gen = torch.Generator(device=dev)

    def rand(shape, seed, dtype=torch.float32):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    # spin-kernel calibration: device clock cycles per millisecond
    s, e = events()
    torch.cuda._sleep(1 << 20)
    s.record()
    torch.cuda._sleep(1 << 24)
    e.record()
    e.synchronize()
    cycles_per_ms = (1 << 24) / s.elapsed_time(e)

    def time_ms(fn, reps=50):
        """Device milliseconds per call: warm up, then queue ``reps`` calls
        behind a spin kernel that outlasts their enqueue (three times the
        slowest of three measured host times of one call, per call, plus
        2 ms), so the events time the calls back to back on the device."""
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        host_s = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            host_s = max(host_s, time.perf_counter() - t0)
        torch.cuda.synchronize()
        s, e = events()
        torch.cuda._sleep(int(cycles_per_ms * (3e3 * host_s * reps + 2.0)))
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / reps

    def bound(flops, nbytes, op_type):
        t_ops = flops / peaks[op_type] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")

    def library_update(C, A, B, alpha, tb):
        """One PyTorch call computing C + alpha * A @ op(B) in f32: cuBLAS
        SGEMM for f32 operands (split_f32 computes the same function), and
        for bf16 operands a bf16 GEMM with f32 output and accumulation
        (bf16 x bf16 products are exact in f32).  Timed only."""
        b = B.mT if tb else B
        if A.dtype == torch.float32:
            return (lambda: torch.addmm(C, A, b, alpha=alpha)), "torch.addmm"
        return ((lambda: torch.addmm(C, A, b, out_dtype=torch.float32, alpha=alpha)),
                "torch.addmm(out_dtype=float32)")

    def rel_err(out, ref):
        return ((out.double() - ref.double()).abs().max() / ref.double().abs().max()).item()

    # B1/B2: every mode at every shape; a failed gate is recorded and the
    # phase raises once every row is printed
    results = {}
    failures = []
    seed = 100
    cases = [((m, n, k), name, mode) for (m, n, k) in SHAPES
             for name in ("matmul_update", "matmul")
             for mode in (("f32", "f32_nt", "bf16", "bf16_nt", "split", "split_nt")
                          if name == "matmul_update" else ("f32", "f32_nt", "bf16", "bf16_nt"))]
    cases += [(shape, name, mode) for (name, mode), shape in CALLER_SHAPES.items()]
    for (m, n, k), name, mode in cases:
        seed += 1
        tb = not mode.endswith("_nt")
        op_dtype = torch.bfloat16 if mode.startswith("bf16") else torch.float32
        split = mode.startswith("split")
        alpha = -1.0 if tb else 1.0
        A = rand((m, k), seed + 1000, op_dtype)
        B = rand((n, k) if tb else (k, n), seed + 2000, op_dtype)
        b = B.mT if tb else B
        if name == "matmul_update":
            C = rand((m, n), seed)
            kw = dict(alpha=alpha, transpose_b=tb, split_f32=split)
            run = lambda: kernels.matmul_update(C, A, B, **kw)  # noqa: E731
            plain = lambda: kernels.matmul_update_plain(C, A, B, **kw)  # noqa: E731
            lib_fn, lib_call = library_update(C, A, B, alpha, tb)
            tol = TOL_BF16 if op_dtype == torch.bfloat16 else TOL_F32
        else:
            C, alpha = None, 1.0
            run = lambda: kernels.matmul(A, B, transpose_b=tb)  # noqa: E731
            plain = lambda: kernels.matmul_plain(A, B, transpose_b=tb)  # noqa: E731
            lib_fn, lib_call = (lambda: torch.matmul(A, b)), "torch.matmul"
            tol = TOL_BF16_OUT if op_dtype == torch.bfloat16 else TOL_F32
        label = f"{name}[{mode}] {m}x{n}x{k}"
        out, out2, ref = run(), run(), plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = rel_err(out, ref)
        row = {"shape": [m, n, k], "max_abs_err": err, "rel_err": rel, "tol": tol,
               "bit_identical": bool(torch.equal(out, out2))}
        if not (bool(torch.isfinite(out).all()) and rel < tol):
            failures.append(f"{label}: rel err {rel} >= {tol}")
        if not row["bit_identical"]:
            failures.append(f"{label}: two launches on the same inputs differ")
        if op_dtype == torch.float32:
            # f32-class modes against a float64 product: < 1e-5 at
            # every shape; the f32 modes at the tile also within 2x
            # of the plain version's (cuBLAS FP32, TF32 off) error
            r64 = A.double() @ b.double()
            if C is not None:
                r64 = C.double() + alpha * r64
            row["rel_err_vs_f64"] = rel_err(out, r64)
            row["plain_rel_err_vs_f64"] = rel_err(ref, r64)
            if row["rel_err_vs_f64"] >= TOL_SPLIT_F64:
                failures.append(f"{label} vs f64: {row['rel_err_vs_f64']} "
                                f">= {TOL_SPLIT_F64}")
            if (not split and (m, n, k) == TILE and row["rel_err_vs_f64"]
                    > F64_GATE_FACTOR * row["plain_rel_err_vs_f64"]):
                failures.append(f"{label} vs f64: {row['rel_err_vs_f64']} > "
                                f"{F64_GATE_FACTOR} x the plain version's "
                                f"{row['plain_rel_err_vs_f64']}")
        if (m, n, k) == TILE or CALLER_SHAPES.get((name, mode)) == (m, n, k):
            row["config"] = kernels._mm_config(
                m, n, k, operand_dtype=A.dtype, out_dtype=out.dtype,
                transpose_b=tb, split_f32=split, a_ptr=A.data_ptr(),
                b_ptr=B.data_ptr(), o_ptr=out.data_ptr(),
                c_ptr=None if C is None else C.data_ptr())._asdict()
            row["ms"] = time_ms(run)
            row["plain_ms"] = time_ms(plain)
            lib_rel = rel_err(lib_fn(), ref)
            if lib_rel >= tol:
                failures.append(f"library {lib_call} disagrees with the plain "
                                f"{label}: {lib_rel}")
            row["library_call"] = lib_call
            row["library_ms"] = time_ms(lib_fn)
            isz = A.element_size()
            c_bytes = 2 * m * n * 4 if C is not None else m * n * out.element_size()
            nbytes = (m * k + n * k) * isz + c_bytes
            flops = 2 * m * n * k + (2 * m * n if C is not None else 0)
            if op_dtype == torch.bfloat16:
                row["bound_ms"], row["bound_by"] = bound(flops, nbytes, "bf16")
            elif split:
                row["bound_ms"], row["bound_by"] = bound(3 * flops, nbytes, "bf16")
            else:
                # f32: three TF32 tensor-core passes (this design);
                # true FP32 on the CUDA cores printed beside it
                row["bound_ms"], row["bound_by"] = bound(3 * flops, nbytes, "tf32")
                row["bound_fp32_ms"], _ = bound(flops, nbytes, "f32")
        results[(name, mode, (m, n, k))] = row
        say("kernel", name=name, mode=mode, **row)
    check(not failures, "B1/B2 kernel phase:\n  " + "\n  ".join(failures))

    # -- B5 flash_attention_block at the attention path's blocks ----------------
    def attn_pairs(sq, sk, q_off, k_off, causal):
        """(query, key) pairs the update needs: all of them, or under the
        causal mask those with q_off + row >= k_off + col."""
        if not causal:
            return sq * sk
        rows = torch.arange(sq, dtype=torch.int64)
        return int((q_off + rows - k_off + 1).clamp(0, sk).sum())

    # (label, Sq, Sk, D, dtype, causal, q_off, k_off): the path's blocks
    # (the prefill's full and diagonal blocks, the decode step's ragged
    # tail), then every head-dimension template and the predicated copies
    # (D = 37: f32 row pitches that are not 16-byte multiples) at a ragged
    # (100, 300)
    f32, bf16 = torch.float32, torch.bfloat16
    dec_k_off = (DEC_SK - 1) // ATTN_BLOCK * ATTN_BLOCK
    attn_cases = [
        ("f32", ATTN_BLOCK, ATTN_BLOCK, ATTN_D, f32, False, 0, 0),
        ("f32_causal_diag", ATTN_BLOCK, ATTN_BLOCK, ATTN_D, f32, True, 0, 0),
        ("f32_ragged", DEC_SQ, DEC_SK - dec_k_off, ATTN_D, f32, True,
         DEC_SK - DEC_SQ, dec_k_off),
        # the serve phase's decode job: 8 query rows at the tail of the
        # 4096-token sequence against one full 512-key block
        ("f32_decode_8x512", SERVE_DEC_Q, ATTN_BLOCK, ATTN_D, f32, True,
         ATTN_S - SERVE_DEC_Q, 0),
        ("bf16", ATTN_BLOCK, ATTN_BLOCK, ATTN_D, bf16, True, ATTN_BLOCK, 0),
        ("bf16_causal_diag", ATTN_BLOCK, ATTN_BLOCK, ATTN_D, bf16, True, 0, 0),
        ("bf16_ragged", DEC_SQ, DEC_SK - dec_k_off, ATTN_D, bf16, True,
         DEC_SK - DEC_SQ, dec_k_off),
    ] + [(f"{name}_d{d}{'_causal' if causal else ''}", 100, 300, d, dt, causal,
          250 if causal else 0, 0)
         for d in (37, 64, 256) for name, dt in (("f32", f32), ("bf16", bf16))
         for causal in (False, True)]
    # the wide kernel (D > 256): the ragged (100, 300) and the path's block
    # size, causal (the diagonal) and not, in both engine dtypes
    attn_cases += [(f"{name}_{sq}x{sk}_d{d}{'_causal' if causal else ''}", sq, sk, d, dt,
                    causal, (250 if sq == 100 else 0) if causal else 0, 0)
                   for sq, sk in ((100, 300), (ATTN_BLOCK, ATTN_BLOCK)) for d in (320, 512)
                   for name, dt in (("f32", f32), ("bf16", bf16)) for causal in (False, True)]
    # operands the f32 engine takes as float32 copies: float16 at the
    # path's block, and mixed q/k/v on the wide kernel
    attn_cases += [("f16_causal_diag", ATTN_BLOCK, ATTN_BLOCK, ATTN_D, torch.float16, True,
                    0, 0),
                   ("mixed_d320_causal", 100, 300, 320, (f32, bf16, torch.float16), True,
                    250, 0)]
    # latent attention's step, the bf16 engine's <192, 128> template (a
    # ninth field: v's width): the 512 block causal and not, the MLA cell's
    # 8192 blocks (the full block below the diagonal, the diagonal, and not
    # causal), the ragged (100, 300) causal and not, and narrower widths on
    # the same template (predicated copies: 330- and 198-byte rows)
    attn_cases += [
        ("bf16_mla", ATTN_BLOCK, ATTN_BLOCK, MLA_D, bf16, False, 0, 0, MLA_DV),
        ("bf16_mla_causal_diag", ATTN_BLOCK, ATTN_BLOCK, MLA_D, bf16, True, 0, 0, MLA_DV),
        ("bf16_mla_8192_full", MLA_BLOCK, MLA_BLOCK, MLA_D, bf16, True, MLA_BLOCK, 0, MLA_DV),
        ("bf16_mla_8192_causal_diag", MLA_BLOCK, MLA_BLOCK, MLA_D, bf16, True, 0, 0, MLA_DV),
        ("bf16_mla_8192", MLA_BLOCK, MLA_BLOCK, MLA_D, bf16, False, 0, 0, MLA_DV),
        ("bf16_mla_ragged", 100, 300, MLA_D, bf16, False, 0, 0, MLA_DV),
        ("bf16_mla_ragged_causal", 100, 300, MLA_D, bf16, True, 250, 0, MLA_DV),
        ("bf16_mla_d165_dv99_causal", 100, 300, 165, bf16, True, 250, 0, 99),
    ]
    f64_gated = ("f32", "f32_causal_diag")

    def max_err(out, ref):
        return max((o.double() - r.double()).abs().max().item() for o, r in zip(out, ref))

    def scaled_err(out, ref):
        """max_err with each tensor's distance over its largest magnitude
        (at least 1): at 8192 keys l reaches the hundreds, where float32
        itself rounds by ~1e-5 a term (tests/test_torch_mla.py's card case
        holds the kernel so)."""
        return max((o.double() - r.double()).abs().max().item()
                   / max(1.0, r.double().abs().max().item()) for o, r in zip(out, ref))

    def carry_err(out, ref, err=max_err):
        """Distance of the kernel's carry from the plain version's as the
        carries they are: (acc, m, l) and (acc e^-d, m + d, l e^-d) are the
        same carry, so acc and l are taken to the plain version's running
        max first (m is compared as it is).  Two f32 versions disagree on
        the largest logit of a row by ~1e-6, which moves an l of ~100 by
        ~1e-4 without changing what the carry holds."""
        acc_k, m_k, l_k = (t.double() for t in out)
        acc_p, m_p, l_p = (t.double() for t in ref)
        shift = torch.exp(m_k - m_p)
        return err((acc_k * shift, m_k, l_k * shift), (acc_p, m_p, l_p))

    failures = []
    for label, sq, sk, d, dt, causal, q_off, k_off, *dv in attn_cases:
        seed += 1
        dv = dv[0] if dv else d
        dts = dt if isinstance(dt, tuple) else (dt,) * 3
        q, k, v = (rand((n, w), seed + off, t)
                   for n, w, off, t in zip((sq, sk, sk), (d, d, dv), (0, 1000, 2000), dts))
        mode = kernels._attention_mode(*dts, d, dv)
        gate = scaled_err if dv != d else max_err
        acc = rand((sq, dv), seed + 3000)
        m = rand((sq, 1), seed + 4000)
        l = rand((sq, 1), seed + 5000).abs()
        kw = dict(causal=causal, scale=d ** -0.5)
        args = (q, k, v, acc, m, l, q_off, k_off)
        run = lambda: kernels.flash_attention_block(*args, **kw)  # noqa: E731
        plain = lambda: kernels.flash_attention_block_plain(*args, **kw)  # noqa: E731
        out, out2, ref = run(), run(), plain()
        r64 = kernels.flash_attention_block_plain(*args, **kw, compute_dtype=torch.float64)
        torch.cuda.synchronize()
        row = {"shape": [sq, sk, d] + ([dv] if dv != d else []), "causal": causal,
               "q_off": q_off, "kernel": mode, "k_off": k_off, "tol": TOL_ATTN,
               "gate": "scaled" if gate is scaled_err else "abs",
               "max_abs_err": max((o - r).abs().max().item() for o, r in zip(out, ref)),
               "carry_err": carry_err(out, ref, gate),
               "err_vs_f64": gate(out, r64), "plain_err_vs_f64": gate(ref, r64),
               "bit_identical": all(torch.equal(a, b) for a, b in zip(out, out2))}
        if not all(bool(torch.isfinite(o).all()) for o in out):
            failures.append(f"{label}: non-finite output")
        if row["err_vs_f64"] >= TOL_ATTN:
            failures.append(f"{label}: max abs err vs the update in float64 "
                            f"{row['err_vs_f64']} >= {TOL_ATTN}")
        if row["carry_err"] >= TOL_ATTN:
            failures.append(f"{label}: carry differs from the plain version's by "
                            f"{row['carry_err']} >= {TOL_ATTN}")
        if not row["bit_identical"]:
            failures.append(f"{label}: two launches on the same inputs differ")
        if label in f64_gated:
            # the f32 mode against the update in float64: at most
            # F64_GATE_FACTOR x the plain version's (cuBLAS FP32) error
            if row["err_vs_f64"] > F64_GATE_FACTOR * row["plain_err_vs_f64"]:
                failures.append(f"{label} vs f64: {row['err_vs_f64']} > "
                                f"{F64_GATE_FACTOR} x the plain version's "
                                f"{row['plain_err_vs_f64']}")
        row["ms"] = time_ms(run)
        row["plain_ms"] = time_ms(plain)
        row["library_ms"], row["library_call"] = None, "none"
        # the bound of this design: f32 as three TF32 passes of each
        # product; bf16 one pass of q.k and two (p's hi and lo) of p.v;
        # f32 on the CUDA cores (the FP32-FMA design) beside it; the wide kernel
        # on the CUDA cores, its logits once per 128-column slab beside it
        pairs = attn_pairs(sq, sk, q_off, k_off, causal)
        nbytes = (q.numel() * q.element_size() + k.numel() * k.element_size()
                  + v.numel() * v.element_size() + 2 * sq * dv * 4 + 4 * sq * 4)
        if mode.endswith("_wide"):
            row["bound_ms"], row["bound_by"] = bound(4 * d * pairs, nbytes, "f32")
            row["bound_design_ms"], _ = bound(
                2 * d * pairs * (1 + -(-d // 128)), nbytes, "f32")
        elif mode == "bf16":
            # one pass of q.k over d, two of p.v over dv; the useful
            # 2 (d + dv) a pair beside it
            row["bound_ms"], row["bound_by"] = bound((2 * d + 4 * dv) * pairs, nbytes, "bf16")
            row["bound_useful_ms"], _ = bound(2 * (d + dv) * pairs, nbytes, "bf16")
        else:
            row["bound_ms"], row["bound_by"] = bound(3 * 4 * d * pairs, nbytes, "tf32")
            row["bound_fp32_ms"], _ = bound(4 * d * pairs, nbytes, "f32")
        results[("flash_attention_block", label)] = row
        say("kernel", name="flash_attention_block", mode=label, **row)

    # the exact no-op, in both dtypes: a fully masked block met while the
    # carry is still at its -1e30/0/0 init leaves acc = 0, l = 0 and m
    # bit-identical
    for name, dt, d, dv in (("f32", f32, ATTN_D, ATTN_D), ("bf16", bf16, ATTN_D, ATTN_D),
                            ("f32_d512", f32, 512, 512), ("bf16_d512", bf16, 512, 512),
                            ("bf16_mla", bf16, MLA_D, MLA_DV)):
        q, k, v = (rand((ATTN_BLOCK, w), seed + off, dt)
                   for w, off in ((d, 6000), (d, 7000), (dv, 8000)))
        acc0 = torch.zeros((ATTN_BLOCK, dv), device=dev)
        m0 = torch.full((ATTN_BLOCK, 1), -1e30, device=dev)
        l0 = torch.zeros((ATTN_BLOCK, 1), device=dev)
        acc1, m1, l1 = kernels.flash_attention_block(q, k, v, acc0, m0, l0, 0,
                                                     ATTN_BLOCK, causal=True, scale=0.1)
        torch.cuda.synchronize()
        exact = (acc1.abs().max().item() == 0.0 and l1.abs().max().item() == 0.0
                 and torch.equal(m1, m0))
        if not exact:
            failures.append(f"masked_at_init_{name}: the carry changed")
        say("kernel", name="flash_attention_block", mode=f"masked_at_init_{name}",
            exact=exact)
    check(not failures, "B5 kernel phase:\n  " + "\n  ".join(failures))

    # -- B3 stencil_5pt: every dtype at the path's tile, ragged, unaligned --
    # each output torch.equal to the plain version's and to a second launch
    # (the same additions in the same order, in the grid's dtype)
    st_tile = ST_N // ST_TILES
    dtypes = {"f32": torch.float32, "f64": torch.float64, "f16": torch.float16,
              "bf16": torch.bfloat16}
    st_cases = [(name, (st_tile, st_tile), dt) for name, dt in dtypes.items()] + [
        ("f32_ragged", (1000, 600), torch.float32),
        ("f32_unaligned", (37, 130), torch.float32),     # a 520-byte row pitch
        ("f16_unaligned", (37, 130), torch.float16)]

    def halo_args(h, w, dt, seed):
        old = rand((h, w), seed, dt)
        up, down = rand((1, w), seed + 1000, dt), rand((1, w), seed + 2000, dt)
        # halo columns as the path passes them: edge columns of neighbour
        # tiles, strided views
        left = rand((h, 8), seed + 3000, dt)[:, -1:]
        right = rand((h, 8), seed + 4000, dt)[:, :1]
        return old, up, down, left, right

    failures = []
    for label, (h, w), dt in st_cases:
        seed += 1
        args = halo_args(h, w, dt, seed)
        out, out2 = kernels.stencil_5pt(*args), kernels.stencil_5pt(*args)
        ref = kernels.stencil_5pt_plain(*args)
        torch.cuda.synchronize()
        err = (out.double() - ref.double()).abs().max().item()
        vec = kernels._stencil_vec(w, args[0].element_size(), args[0].data_ptr(),
                                   args[1].data_ptr(), args[2].data_ptr(), out.data_ptr())
        row = {"shape": [h, w], "vec": vec, "max_abs_err": err,
               "equal_plain": bool(torch.equal(out, ref)),
               "bit_identical": bool(torch.equal(out, out2)),
               "ms": time_ms(lambda: kernels.stencil_5pt(*args)),
               "plain_ms": time_ms(lambda: kernels.stencil_5pt_plain(*args)),
               "library_ms": None, "library_call": "none"}
        if not (row["equal_plain"] and row["bit_identical"]):
            failures.append(f"stencil_5pt[{label}]: equal to plain {row['equal_plain']}, "
                            f"two launches equal {row['bit_identical']}")
        isz = args[0].element_size()
        nbytes = (2 * h * w + 2 * (h + w)) * isz
        row["bound_ms"], row["bound_by"] = bound(
            4 * h * w, nbytes, "f64" if dt == torch.float64 else "f32")
        if (h, w) == (st_tile, st_tile):
            # cold L2: rotate over enough distinct inputs and outputs (each
            # output kept alive until its slot comes round again) to exceed
            # twice the 50 MB L2
            n_sets = -(-2 * 50 * 2 ** 20 // (2 * h * w * isz)) + 1
            sets = [halo_args(h, w, dt, seed + 10000 * (i + 1)) for i in range(n_sets)]
            outs = [None] * n_sets
            turn = [0]

            def cold():
                i = turn[0] = (turn[0] + 1) % n_sets
                outs[i] = None
                outs[i] = kernels.stencil_5pt(*sets[i])

            row["cold_ms"] = time_ms(cold, 4 * n_sets)
            row["cold_sets"] = n_sets
            del sets, outs
        results[("stencil_5pt", label)] = row
        say("kernel", name="stencil_5pt", mode=label, **row)
    check(not failures, "B3 kernel phase:\n  " + "\n  ".join(failures))

    # -- B4 stencil_5pt_fused: each mode, dtype by dtype ---------------------
    # (label, n, dtype, expected mode); each torch.equal to the plain
    # version; iters = 1 timed too, so one step costs (t(100) - t(1)) / 99
    sms, smem_optin = kernels._stencil_device_limits(dev)
    fused_cases = [("smem_f32_512", 512, torch.float32, "smem"),
                   ("smem_f32", FUSED_N, torch.float32, "smem"),
                   ("smem_f32_999", 999, torch.float32, "smem"),  # a ragged last strip
                   ("smem_f64_1024", 1024, torch.float64, "smem"),
                   ("smem_f16_1024", 1024, torch.float16, "smem"),
                   ("global_f64", FUSED_N, torch.float64, "global")]
    for label, n, dt, want in fused_cases:
        seed += 1
        grid = rand((n, n), seed, dt)
        cfg = kernels._fused_mode(n, n, grid.element_size(), sms, smem_optin)
        check(cfg.mode == want, f"stencil_5pt_fused[{label}]: mode {cfg}, expected {want}")
        kernels.reset_counts()
        out = kernels.stencil_5pt_fused(grid, FUSED_ITERS)
        out2 = kernels.stencil_5pt_fused(grid, FUSED_ITERS)
        by_mode = dict(kernels.stencil_5pt_fused.launches_by_mode)
        ref = kernels.stencil_5pt_fused_plain(grid, FUSED_ITERS)
        one = kernels.stencil_5pt_fused(grid, 1)
        torch.cuda.synchronize()
        err = (out.double() - ref.double()).abs().max().item()
        vec = cfg.mode == "smem" and kernels._stencil_vec(n, grid.element_size(),
                                                          out.data_ptr())
        row = {"shape": [n, n], "iters": FUSED_ITERS, "config": cfg._asdict(), "vec": vec,
               "max_abs_err": err, "equal_plain": bool(torch.equal(out, ref)),
               "bit_identical": bool(torch.equal(out, out2)),
               "iters1_equal_plain": bool(torch.equal(
                   one, kernels.stencil_5pt_fused_plain(grid, 1))),
               "ms": time_ms(lambda: kernels.stencil_5pt_fused(grid, FUSED_ITERS), 10),
               "iters1_ms": time_ms(lambda: kernels.stencil_5pt_fused(grid, 1), 20),
               "plain_ms": time_ms(lambda: kernels.stencil_5pt_fused_plain(grid, FUSED_ITERS), 3),
               "library_ms": None, "library_call": "none"}
        row["step_ms"] = (row["ms"] - row["iters1_ms"]) / (FUSED_ITERS - 1)
        check(by_mode[want] == 2 and sum(by_mode.values()) == 2,
              f"stencil_5pt_fused[{label}]: launches by mode {by_mode}")
        check(row["equal_plain"] and row["bit_identical"] and row["iters1_equal_plain"],
              f"stencil_5pt_fused[{label}]: equal to plain {row['equal_plain']}, two "
              f"launches equal {row['bit_identical']}, one step equal "
              f"{row['iters1_equal_plain']} (max abs err {err})")
        row["bound_ms"], row["bound_by"] = bound(
            4 * n * n * FUSED_ITERS, 2 * n * n * grid.element_size(),
            "f64" if dt == torch.float64 else "f32")
        results[("stencil_5pt_fused", label)] = row
        say("kernel", name="stencil_5pt_fused", mode=label, **row)
        del grid, out, out2, ref, one

    # -- the batch axis: B1, B2, B3 and B5, one launch over a level's group ---
    # each kernel as a level-batched replay calls it (the wrapper under
    # torch.func.vmap, its custom op's vmap rule launching once over the
    # members), at the largest group a path makes; each batched launch
    # torch.equal to its members launched one by one and within the
    # kernel's tolerance of its batched plain version; timed beside the
    # members launched one by one, its bound the members' work together
    from torch.func import vmap

    batched_results = {}
    failures = []

    def batched_row(key, n_mem, run_b, one, plain_b, err, tol, flops, nbytes, op_type,
                    library=None, **extra):
        out_b = run_b()
        outs_1 = [one(i) for i in range(n_mem)]
        ref = plain_b()
        torch.cuda.synchronize()
        if isinstance(out_b, tuple):
            stacked = tuple(torch.stack(parts) for parts in zip(*outs_1))
            equal = all(torch.equal(a, b) for a, b in zip(out_b, stacked))
            finite = all(bool(torch.isfinite(o).all()) for o in out_b)
        else:
            equal = bool(torch.equal(out_b, torch.stack(outs_1)))
            finite = bool(torch.isfinite(out_b).all())
        row = {"members": n_mem, "err": err(out_b, ref), "tol": tol,
               "max_abs_err": max((o.double() - r.double()).abs().max().item()
                                  for o, r in zip(*((out_b, ref) if isinstance(out_b, tuple)
                                                    else ((out_b,), (ref,))))),
               "equal_one_by_one": equal, **extra}
        # tol 0: bit for bit (B3, whose plain version is elementwise)
        if not (finite and (row["err"] <= tol if tol == 0.0 else row["err"] < tol)):
            failures.append(f"{key}: error {row['err']} against the batched plain "
                            f"version, tolerance {tol}")
        if not equal:
            failures.append(f"{key}: the batched launch differs from its members "
                            "launched one by one")
        del out_b, outs_1, ref
        row["ms"] = time_ms(run_b, 10)
        row["single_ms"] = time_ms(lambda: one(n_mem - 1), 20)
        row["one_by_one_ms"] = time_ms(lambda: [one(i) for i in range(n_mem)], 3)
        row["members_x_single_ms"] = n_mem * row["single_ms"]
        row["plain_ms"] = time_ms(plain_b, 3)
        row["library_ms"], row["library_call"] = None, "none"
        if library is not None:
            row["library_call"] = library[1]
            row["library_ms"] = time_ms(library[0], 10)
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, op_type)
        batched_results[key] = row
        say("kernel_batched", name=key[0], mode=key[1], **row)

    def library_batched(C, A, b, alpha):
        """One PyTorch call of C + alpha * A @ b over the members (f32
        operands: cuBLAS batched SGEMM; bf16: f32 output if this torch
        has ``out_dtype``), else None.  Timed only."""
        b = b.expand(A.shape[0], *b.shape[-2:])
        if A.dtype == torch.float32:
            return (lambda: torch.baddbmm(C, A, b, alpha=alpha)), "torch.baddbmm"
        try:
            torch.baddbmm(C, A, b, alpha=alpha, out_dtype=torch.float32)
        except (TypeError, RuntimeError):
            return None
        return ((lambda: torch.baddbmm(C, A, b, alpha=alpha, out_dtype=torch.float32)),
                "torch.baddbmm(out_dtype=float32)")

    # (name, mode, members, (m, n, k), B shared): B1 at dpotrf's largest
    # gemm group (105) in every mode the paths run, and with B not
    # transposed at the tiled LU's largest (225); B2 at dpotrf trtri's
    # trsm group (15, the level's one inverse shared) and the tiled QR's
    # largest tsmqr group (65)
    mm_batched = [("matmul_update", "f32_b", 105, TILE, False),
                  ("matmul_update", "bf16_b", 105, TILE, False),
                  ("matmul_update", "split_b", 105, TILE, False),
                  ("matmul_update", "f32_nt_b", 105, TILE, False),
                  ("matmul_update", "f32_nt_b", 225, TILE, False),
                  ("matmul", "f32_b", 15, TILE, True),
                  ("matmul", "f32_nt_b", 65, CALLER_SHAPES[("matmul", "f32_nt")], False)]
    for name, mode, n_mem, (m, n, k), shared_b in mm_batched:
        seed += 1
        tb = "_nt" not in mode
        op_dtype = torch.bfloat16 if mode.startswith("bf16") else torch.float32
        split = mode.startswith("split")
        A = rand((n_mem, m, k), seed + 1000, op_dtype)
        b_shape = (n, k) if tb else (k, n)
        B = rand(b_shape if shared_b else (n_mem, *b_shape), seed + 2000, op_dtype)
        b_dim = None if shared_b else 0
        b = B.mT if tb else B
        member_b = (lambda i: B) if shared_b else (lambda i: B[i])  # noqa: E731
        isz = A.element_size()
        b_bytes = B.numel() * isz
        if name == "matmul_update":
            C = rand((n_mem, m, n), seed)
            alpha = -1.0 if tb else 1.0
            kw = dict(alpha=alpha, transpose_b=tb, split_f32=split)
            run_b = lambda: vmap(lambda c, a, bb: kernels.matmul_update(  # noqa: E731
                c, a, bb, **kw), in_dims=(0, 0, b_dim))(C, A, B)
            one = lambda i: kernels.matmul_update(C[i], A[i], member_b(i), **kw)  # noqa: E731
            plain_b = lambda: kernels.matmul_update_plain(C, A, B, **kw)  # noqa: E731
            lib = library_batched(C, A, b, alpha)
            tol = TOL_BF16 if op_dtype == torch.bfloat16 else TOL_F32
            flops = n_mem * (2 * m * n * k + 2 * m * n)
            nbytes = n_mem * (m * k * isz + 2 * m * n * 4) + b_bytes
        else:
            run_b = lambda: vmap(lambda a, bb: kernels.matmul(  # noqa: E731
                a, bb, transpose_b=tb), in_dims=(0, b_dim))(A, B)
            one = lambda i: kernels.matmul(A[i], member_b(i), transpose_b=tb)  # noqa: E731
            plain_b = lambda: kernels.matmul_plain(A, B, transpose_b=tb)  # noqa: E731
            lib = ((lambda: torch.matmul(A, b)), "torch.matmul")
            tol = TOL_F32
            flops = n_mem * 2 * m * n * k
            nbytes = n_mem * (m * k + m * n) * isz + b_bytes
        op_type = "bf16" if op_dtype == torch.bfloat16 or split else "tf32"
        batched_row((name, f"{mode}_{n_mem}"), n_mem, run_b, one, plain_b, rel_err, tol,
                    (1 if op_type == "bf16" and not split else 3) * flops, nbytes, op_type,
                    library=lib, shape=[m, n, k], b_shared=shared_b)
        del A, B, b
    check(not failures, "B1/B2 batched launches:\n  " + "\n  ".join(failures))

    # B3 at the stencil's largest group: its 36 interior tiles of a step,
    # each halo a strided slice of a stacked neighbour tile as the body
    # takes it; and a top-edge group (6 tiles) whose absent upper halo is
    # one zero row every member shares (batch stride 0)
    st_tile = ST_N // ST_TILES
    for label, n_mem, top_edge in (("interior", (ST_TILES - 2) ** 2, False),
                                   ("top_edge", ST_TILES - 2, True)):
        seed += 1
        h = w = st_tile
        old, nu, nd, nl, nr = (rand((n_mem, h, w), seed + 1000 * j) for j in range(5))
        zrow = torch.zeros((1, w), device=dev)

        def st_body(o, U, D, L, R, _top=top_edge):
            up = zrow if _top else U[-1:, :]
            return kernels.stencil_5pt(o, up, D[:1, :], L[:, -1:], R[:, :1])

        args = (old, nu, nd, nl, nr)
        run_b = lambda: vmap(st_body)(*args)  # noqa: E731
        one = lambda i: st_body(*(t[i] for t in args))  # noqa: E731
        plain_b = lambda: kernels.stencil_5pt_plain(  # noqa: E731
            old, zrow.expand(n_mem, 1, w) if top_edge else nu[:, -1:, :], nd[:, :1, :],
            nl[:, :, -1:], nr[:, :, :1])
        batched_row(("stencil_5pt", f"step_b_{label}_{n_mem}"), n_mem, run_b, one, plain_b,
                    lambda o, r: float(not torch.equal(o, r)), 0.0,
                    n_mem * 4 * h * w, n_mem * (2 * h * w + 2 * (h + w)) * 4, "f32",
                    shape=[h, w])
        del old, nu, nd, nl, nr, args
    check(not failures, "B3 batched launches:\n  " + "\n  ".join(failures))

    # B5 at the f32 prefill's largest level: 256 (head, q block) steps at
    # one key block, each member's q offset its own (read on the card from
    # an int64 tensor), k and v stacked; members whose query rows all lie
    # before the key block are fully masked and must keep their carry
    # exactly.  The wide kernel (D = 512) at a small batch; latent
    # attention's 192 / 128 (the <192, 128, batched> build) at the bf16 size.
    for label, n_mem, d, dv, dt in (("f32", 256, ATTN_D, ATTN_D, f32),
                                    ("bf16", 256, ATTN_D, ATTN_D, bf16),
                                    ("f32_wide", 8, 512, 512, f32),
                                    ("bf16_mla", 256, MLA_D, MLA_DV, bf16)):
        seed += 1
        sq = sk = ATTN_BLOCK
        k_off = 3 * ATTN_BLOCK
        q_offs = [(j % (ATTN_S // ATTN_BLOCK)) * ATTN_BLOCK for j in range(n_mem)]
        q_off_t = torch.tensor(q_offs, dtype=torch.int64, device=dev)
        q, k, v = (rand((n_mem, n, w), seed + off, dt)
                   for n, w, off in ((sq, d, 0), (sk, d, 1000), (sk, dv, 2000)))
        acc = rand((n_mem, sq, dv), seed + 3000)
        m = rand((n_mem, sq, 1), seed + 4000)
        l = rand((n_mem, sq, 1), seed + 5000).abs()
        kw = dict(causal=True, scale=d ** -0.5)

        def attn_body(Q, K, V, ACC, M, L, qo):
            return kernels.flash_attention_block(Q, K, V, ACC, M, L, qo, k_off, **kw)

        args = (q, k, v, acc, m, l)
        run_b = lambda: vmap(attn_body)(*args, q_off_t)  # noqa: E731
        one = lambda i: kernels.flash_attention_block(  # noqa: E731
            *(t[i] for t in args), q_offs[i], k_off, **kw)
        plain_b = lambda: kernels.flash_attention_block_plain(  # noqa: E731
            *args, q_off_t, k_off, **kw)
        masked = [i for i, qo in enumerate(q_offs) if qo + sq - 1 < k_off]
        out_b = run_b()
        torch.cuda.synchronize()
        exact = all(torch.equal(out_b[0][i], acc[i]) and torch.equal(out_b[1][i], m[i])
                    and torch.equal(out_b[2][i], l[i]) for i in masked)
        if not exact:
            failures.append(f"flash_attention_block[{label}_b]: a fully masked member's "
                            "carry changed")
        del out_b
        pairs = sum(attn_pairs(sq, sk, qo, k_off, True) for qo in q_offs)
        nbytes = n_mem * ((q[0].numel() + k[0].numel() + v[0].numel()) * q.element_size()
                          + 2 * sq * dv * 4 + 4 * sq * 4)
        flops, op_type = ((4 * d * pairs, "f32") if label.endswith("_wide") else
                          ((2 * d + 4 * dv) * pairs, "bf16") if label.startswith("bf16") else
                          (3 * 4 * d * pairs, "tf32"))
        batched_row(("flash_attention_block", f"{label}_b_{n_mem}"), n_mem, run_b, one,
                    plain_b, carry_err, TOL_ATTN, flops, nbytes, op_type,
                    shape=[sq, sk, d] + ([dv] if dv != d else []),
                    masked_members=len(masked), masked_exact=exact)
        del q, k, v, acc, m, l, args
    check(not failures, "B5 batched launches:\n  " + "\n  ".join(failures))
    torch.cuda.empty_cache()

    # -- latent attention through the pump: one causal prefill job ----------
    # build_mla_attention under NativeExecutor(native_device=True), as the
    # benchmark's MLA cell runs it, at MLA_S tokens in the cell's blocks:
    # kv_up's B2 and the steps' 192 / 128 B5 launches counted against the
    # graph's tasks, the task-made K and V tiles homed on the card and none
    # staged in, and the output judged a head at a time against the plain
    # reference (float32 on the card) by the MLA cell's comparison and limit
    def mla_pump(seed):
        from parsec_tpu_torch.ops import build_mla_attention, mla_attention_task_count
        from parsec_tpu_torch.reference.mla import mla_attention, softmax_scale
        here = os.path.dirname(os.path.abspath(__file__))
        with open(os.path.join(here, MLA_CONFIG)) as f:
            cfg = json.load(f)
        with open(os.path.join(here, MLA_LIMITS)) as f:
            limit = json.load(f)["out_err"]["limit"]
        dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        check((dn + dr, cfg["v_head_dim"], cfg["kv_lora_rank"], cfg["num_attention_heads"])
              == (MLA_D, MLA_DV, MLA_L, MLA_H), f"{MLA_CONFIG}: widths differ from this script's")
        scale = softmax_scale(dn, dr, cfg["rope_scaling"])
        rows_h = dn + MLA_DV  # a head's rows of kv_b_proj
        inputs = (rand((1, MLA_S, MLA_H, MLA_D), seed, bf16),
                  rand((1, MLA_S, MLA_L), seed + 1000, bf16),
                  rand((1, MLA_S, dr), seed + 2000, bf16),
                  (rand((MLA_H * rows_h, MLA_L), seed + 3000) * MLA_L ** -0.5).to(bf16))
        host = tuple(t.cpu() for t in inputs)
        mm, b5 = kernels.matmul, kernels.flash_attention_block
        before = dict(mm.launches_by_mode), dict(b5.launches_by_mode)
        t0 = time.perf_counter()
        tp, assemble = build_mla_attention(*host, scale=scale, causal=True, q_block=MLA_BLOCK,
                                           kv_block=MLA_BLOCK, use_cpu=False)
        ex = NativeExecutor(tp, native_device=True)
        ran = ex.run()
        ex.close()
        out = assemble()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = ex.device.stats
        run = {"b2": {k: n - before[0][k] for k, n in mm.launches_by_mode.items()
                      if n != before[0][k]},
               "b5": {k: n - before[1][k] for k, n in b5.launches_by_mode.items()
                      if n != before[1][k]}}
        nk = -(-MLA_S // MLA_BLOCK)
        n_up, n_steps = MLA_H * nk, MLA_H * nk * (nk + 1) // 2
        worst = 0.0
        for h in range(MLA_H):
            ref = mla_attention(inputs[0][:, :, h:h + 1], inputs[1], inputs[2],
                                inputs[3][h * rows_h:(h + 1) * rows_h], scale, True)
            got = out[:, :, h:h + 1].to(dev, torch.float32)
            worst = max(worst, ((got - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item())
            del ref, got
        # q, the latent and rotary blocks and the weights once each; the
        # carries are made on the card
        bytes_in = (MLA_S * MLA_H * MLA_D + MLA_S * (MLA_L + dr) + MLA_H * rows_h * MLA_L) * 2
        say("mla_pump", S=MLA_S, heads=MLA_H, block=MLA_BLOCK, tasks=ran,
            b5_launches=run["b5"], b2_launches=run["b2"], scratch_tiles=st["scratch_tiles"],
            scratch_bytes=st["scratch_bytes"], scratch_h2d_bytes=st["scratch_h2d_bytes"],
            bytes_in=st["bytes_in"], out_err=worst, limit=limit, wall_s=wall)
        want = mla_attention_task_count(1, MLA_S, MLA_H, MLA_BLOCK, MLA_BLOCK, causal=True)
        check(ran == want, f"mla pump: {ran} tasks, want {want}")
        check(run["b5"] == {"bf16": n_steps} and run["b2"] == {"bf16": 2 * n_up},
              f"mla pump: launches B5 {run['b5']}, B2 {run['b2']}; want bf16 "
              f"{n_steps} and {2 * n_up}")
        # kv_up's K and V tiles, and each chain's acc, m and l
        check(st["scratch_tiles"] == 2 * n_up + 3 * MLA_H * nk and st["scratch_h2d_bytes"] == 0
              and st["scratch_bytes"] == MLA_H * MLA_S * ((MLA_D + MLA_DV) * 2
                                                          + (MLA_DV + 2) * 4),
              f"mla pump: task-made tiles {st['scratch_tiles']}, {st['scratch_bytes']} B, "
              f"{st['scratch_h2d_bytes']} B staged in")
        check(st["bytes_in"] == bytes_in, f"mla pump: bytes_in {st['bytes_in']}, want {bytes_in}")
        check(worst < limit, f"mla pump: out_err {worst} >= the cell's limit {limit}")
        return run

    seed += 1
    mla_run = mla_pump(seed)
    torch.cuda.empty_cache()

    # -- main path: dpotrf N=8192 nb=512 on the CUDA device module ----------
    # SPD input made from a numpy seed as bench.py makes it (M M^T + N I),
    # the product taken on the card; the oracle is a float64 Cholesky
    rng = np.random.default_rng(0)
    Mg = torch.from_numpy(rng.standard_normal((N, N)).astype(np.float32)).to(dev)
    Sg = Mg @ Mg.mT + N * torch.eye(N, device=dev)
    del Mg
    S = Sg.cpu().numpy()
    S64 = Sg.double()
    L_ref = torch.linalg.cholesky(S64)
    L_ref_last = L_ref[-NB:, -NB:].tril()
    scale = max(1.0, L_ref.abs().max().item())
    del L_ref
    s_max = S64.abs().max().item()
    # warm the solver libraries at tile size (handle creation is set-up,
    # not dpotrf time)
    tile = Sg[:NB, :NB].contiguous()
    torch.linalg.cholesky_ex(tile)
    torch.linalg.solve_triangular(tile, tile, upper=False)
    torch.cuda.synchronize()

    variants = [
        ("kernels", dict(use_kernels=True), 1e-3),
        ("kernels_trtri", dict(use_kernels=True, use_trtri=True), 1e-3),
        ("kernels_bf16", dict(use_kernels=True, bf16_updates=True), 2e-2),
    ]
    nt = N // NB

    def run_dpotrf(kw, S_in=S):
        """One dpotrf through Context/add_taskpool/wait; returns the
        factored matrix, wall seconds, kernel launches per operand mode and
        the CUDA device module's stats, with ``flush_s``: the seconds of
        ctx.fini(), which writes the factor home after the window."""
        n_in = S_in.shape[0]
        A = TiledMatrix(n_in, n_in, NB, NB, name="A", dtype=np.float32).from_array(S_in)
        ctx = Context()
        try:
            cuda_dev = next(d for d in ctx.devices if d.mca_name == "cuda")
            check(cuda_dev.tdev.type == "cuda", f"CUDA module bound to {cuda_dev.tdev}")
            tp = cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(NT=A.mt, A=A)
            kernels.reset_counts()
            gc.collect()  # each timed window starts with no garbage pending
            t0 = time.perf_counter()
            ctx.add_taskpool(tp)
            ok = tp.wait(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                      for fn in (kernels.matmul_update, kernels.matmul)}
        finally:
            # the write-back home (committer flush + batched D2H), timed
            # apart from fini's teardown; fini's own detach finds it done
            t0 = time.perf_counter()
            cuda_dev.detach()
            detach_s = time.perf_counter() - t0
            ctx.fini()
            flush = time.perf_counter() - t0
        check(ok, f"dpotrf {kw}: taskpool failed ({tp.fail_reason})")
        stats = device_stats(cuda_dev, flush_s=flush, detach_s=detach_s)
        check(stats["wb_sync_fallbacks"] == 0, f"dpotrf {kw}: synchronous write-back "
              f"fallbacks {stats['wb_sync_fallbacks']}")
        return A, wall, counts, stats

    launches = {}
    dyn_factor, dyn_wall = {}, {}
    depth_walls = ABWalls("stage_depth_walls", ("depth1", 1), ("depth2", 2))
    for name, kw, recon_tol in variants:
        trtri = kw.get("use_trtri", False)
        ntasks = dpotrf_task_count(nt, use_trtri=trtri)
        # the f32 variants at the default stage depth 1 (no committer) and
        # at depth 2 (the write-back committer), in turns
        depths = STAGE_DEPTHS if name in ("kernels", "kernels_trtri") else (2,)
        for rep, depth in enumerate(depths):
            with mca(mca_param, "runtime", "stage_depth", depth):
                A, wall, counts, stats = run_dpotrf(kw)
            if rep == 0:
                dyn_wall[name] = wall
            if len(depths) > 1:
                depth_walls.add(f"dpotrf {name}", depth, wall)
            executed = stats["executed_tasks"]
            check(executed == ntasks,
                  f"{name}: {executed} tasks on the CUDA device, expected {ntasks}")
            n_upd = nt * (nt - 1) // 2 + nt * (nt - 1) * (nt - 2) // 6
            n_mm = nt * (nt - 1) // 2 if trtri else 0
            upd_mode = "bf16" if kw.get("bf16_updates") else "f32"
            expected = {fn.__name__: dict(dict.fromkeys(fn.launches_by_mode, 0), total=0)
                        for fn in (kernels.matmul_update, kernels.matmul)}
            expected["matmul_update"]["total"] = n_upd
            expected["matmul"].update(f32=n_mm, total=n_mm)
            expected["matmul_update"][upd_mode] = n_upd
            check(counts == expected, f"{name}: launches {counts}, expected {expected}")
            launches[name if rep == 0 else f"{name}_{rep}"] = counts
            factor = A.to_array()
            if rep == 0:
                dyn_factor[name] = factor  # every other run must equal it
            else:
                check(np.array_equal(factor, dyn_factor[name]),
                      f"{name} at depth {depth}: the factor differs from the "
                      "first run's")
            L = torch.from_numpy(factor).to(dev).double().tril()
            check(bool(torch.isfinite(L).all()), f"{name}: non-finite factor")
            recon = ((L @ L.mT - S64).abs().max() / s_max).item()
            last = ((L[-NB:, -NB:] - L_ref_last).abs().max() / scale).item()
            del L
            check(last < 1e-3, f"{name}: last-tile error {last} >= 1e-3")
            check(recon < recon_tol,
                  f"{name}: ||LL^T-S||max/||S||max {recon} >= {recon_tol}")
            say("dpotrf", variant=name, stage_depth=depth, rep=rep, N=N, nb=NB,
                tasks=ntasks, wall_s=wall, gflops=N ** 3 / 3 / wall / 1e9,
                tasks_per_s=ntasks / wall, launches=counts, last_tile_err=last,
                recon_err=recon, recon_tol=recon_tol, equal_first_run=True,
                **pipeline_fields(stats))
            del factor

    # waves on and off in turns at stage depth 1 (the default): each factor
    # equal to the first run's, the same launches per operand mode.  Every
    # waves-on run starts with no graph cached: the card's graphs go when
    # the run's device module detaches, so each run pays its own captures
    # (a one-shot DAG's cost)
    wave_walls = ABWalls("wave_walls", ("waves_off", 0), ("waves_on", 2))

    def wave_line(path, wave, rep, tasks, wall, stats, **extra):
        wave_walls.add(path, wave, wall)
        check((stats["wave_tasks"] > 0) == (wave > 0),
              f"{path} at wave batch {wave}: {stats['wave_tasks']} tasks in waves")
        check(cuda_module.wave_graph_bytes(dev) == 0,
              f"{path} at wave batch {wave}: the card's wave graphs outlived the run")
        say("waves", path=path, wave_batch=wave, rep=rep, tasks=tasks, wall_s=wall,
            host_ms_per_task=wall / tasks * 1e3,
            capture_share=stats["wave_capture_s"] / wall, **extra, **pipeline_fields(stats))

    # supertask fusion off and auto in turns (FUSION), at stage depth 1 with
    # waves off: every output equal to fusion off's, the same launches, and
    # under auto every region of the DAG dispatched once (one fusion line a
    # path: the medians and their ratio)
    fusion_walls = ABWalls("fusion_walls", ("fusion_off", "off"), ("fusion_auto", "auto"))

    def fusion_plan(tp):
        """The regions runtime_fusion=auto carves out of ``tp``'s DAG at
        the default horizon (both runtimes partition the whole captured
        DAG alike): (regions by kind, regions, member tasks)."""
        regions = fusion.partition(tp.capture(), tp.ptg.classes, mode="auto",
                                   max_tasks=fusion.fusion_max_tasks())
        kinds = {}
        for r in regions:
            kinds[r.kind] = kinds.get(r.kind, 0) + 1
        return kinds, len(regions), sum(len(r.members) for r in regions)

    def fusion_turns(path, ntasks, plan, run_one, window):
        """``run_one(mode, rep)`` runs ``path`` once (its output and
        launches checked against fusion off's) and returns (wall, stats,
        host seconds beside the wall).  The wall is the ``window`` a user
        waits for: the dynamic call from add_taskpool to the end of wait(),
        a pump's set-up (capture, partition, plans) and run, or the whole
        entry-point call; a pump's extras carry its set-up seconds
        (``capture_build_s``).  Checks every run's dispatches — a fused
        region counts one — and prints the path's fusion line, with the
        median set-up at each setting where the pump reports it."""
        kinds, n_regions, n_members = plan
        turns = {"off": [], "auto": []}
        for rep, mode in enumerate(FUSION):
            with mca(mca_param, "runtime", "fusion", mode), \
                    mca(mca_param, "runtime", "stage_depth", 1), \
                    mca(mca_param, "device", "cuda_wave_batch", 0):
                wall, stats, extra = run_one(mode, rep)
            fused = mode == "auto"
            want = (n_regions, n_members) if fused else (0, 0)
            check((stats["fused_submits"], stats["fused_tasks"]) == want,
                  f"{path} at fusion {mode}: fused submits and tasks "
                  f"{stats['fused_submits']}, {stats['fused_tasks']}, expected {want}")
            dispatches = ntasks - stats["fused_tasks"] + stats["fused_submits"]
            check(stats["executed_tasks"] == dispatches,
                  f"{path} at fusion {mode}: {stats['executed_tasks']} dispatches, "
                  f"expected {dispatches}")
            if "completion_callbacks" in stats:
                check(stats["trampoline_entries"] == stats["completion_callbacks"] == 0
                      and stats["pumped_tasks"] == dispatches,
                      f"{path} at fusion {mode}: pump stats {stats}")
            fusion_walls.add(path, mode, wall)
            turns[mode].append((wall, dispatches, stats, extra))
        med = {m: statistics.median(w for w, _, _, _ in runs) for m, runs in turns.items()}
        setup = {f"median_setup_{m}_s": statistics.median(t[3]["capture_build_s"]
                                                          for t in runs)
                 for m, runs in turns.items() if "capture_build_s" in runs[0][3]}
        say("fusion", path=path, window=window, tasks=ntasks, regions=kinds,
            fused_submits=n_regions, fused_tasks=n_members,
            dispatches_auto=turns["auto"][0][1], dispatches_off=ntasks,
            mean_region=n_members / n_regions, walls_off_s=[t[0] for t in turns["off"]],
            walls_auto_s=[t[0] for t in turns["auto"]], median_off_s=med["off"],
            median_auto_s=med["auto"], auto_over_off=med["auto"] / med["off"],
            host_ms_per_task_off=med["off"] / ntasks * 1e3,
            host_ms_per_task_auto=med["auto"] / ntasks * 1e3, **setup,
            extra_off=turns["off"][-1][3], extra_auto=turns["auto"][-1][3],
            last_auto={k: turns["auto"][-1][2][k] for k in (
                "bytes_in", "bytes_out", "h2d_copies", "evictions", "oom_reliefs",
                "wave_fallbacks", "wb_sync_fallbacks")})

    for name, kw, _tol in variants[:2]:
        ntasks = dpotrf_task_count(nt, use_trtri=kw.get("use_trtri", False))
        for rep, wave in enumerate(WAVES):
            with mca(mca_param, "device", "cuda_wave_batch", wave):
                A, wall, counts, stats = run_dpotrf(kw)
            check(counts == launches[name],
                  f"{name} at wave batch {wave}: launches {counts}, first run {launches[name]}")
            check(np.array_equal(A.to_array(), dyn_factor[name]),
                  f"{name} at wave batch {wave}: the factor differs from the first run's")
            launches[f"{name}_waves{wave}_{rep}"] = counts
            wave_line(f"dpotrf {name}", wave, rep, ntasks, wall, stats, launches=counts)
            del A

    # -- native phase: the same dpotrf through the native pump ---------------
    def run_dpotrf_native(kw):
        """One dpotrf through NativeExecutor(native_device=True).  Capture
        and build stay outside the timed window (as bench.py's
        dynamic_native_leg); the window is ex.run() + synchronize; close()
        (the write-back home) follows it, as ctx.fini() does for the
        dynamic path.  The dynamic window holds the startup enumeration
        that capture + build replace, so set-up + wall is what compares
        with the dynamic wall.  Returns the matrix, tasks run, wall and
        set-up seconds, launches per operand mode and the executor's stats
        merged with its device module's (:func:`device_stats`, ``flush_s``
        the seconds of close())."""
        A = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(S)
        tp = cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(NT=A.mt, A=A)
        gc.collect()  # each timed window starts with no garbage pending
        t0 = time.perf_counter()
        ex = NativeExecutor(tp, native_device=True)
        setup = time.perf_counter() - t0
        try:
            check(ex.device.tdev.type == "cuda", f"pump device bound to {ex.device.tdev}")
            kernels.reset_counts()
            t0 = time.perf_counter()
            ran = ex.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                      for fn in (kernels.matmul_update, kernels.matmul)}
            stats = dict(ex.stats)
        finally:
            t0 = time.perf_counter()
            ex.close()
            flush = time.perf_counter() - t0
        stats.update(device_stats(ex.device, flush_s=flush))
        check(stats["wb_sync_fallbacks"] == 0, f"native dpotrf {kw}: synchronous "
              f"write-back fallbacks {stats['wb_sync_fallbacks']}")
        return A, ran, wall, setup, counts, stats

    def pump_gates(label, ran, ntasks, stats):
        check(ran == ntasks, f"{label}: the pump ran {ran} tasks, expected {ntasks}")
        check(stats["trampoline_entries"] == 0 and stats["completion_callbacks"] == 0,
              f"{label}: per-task interpreter entries in pump mode ({stats})")
        check(stats["pop_batches"] > 0 and stats["pumped_tasks"] == ntasks,
              f"{label}: pump stats {stats}")

    def native_dpotrf_checks(label, kw, recon_tol, A, ran, counts, stats, dyn_name):
        """The pump run's gates: tasks, launches and factor equal to the
        dynamic run's; returns the factor's errors."""
        pump_gates(label, ran, dpotrf_task_count(nt, use_trtri=kw.get("use_trtri", False)),
                   stats)
        check(counts == launches[dyn_name],
              f"{label}: launches {counts}, dynamic path {launches[dyn_name]}")
        factor = A.to_array()
        check(np.array_equal(factor, dyn_factor[dyn_name]),
              f"{label}: factor differs from the dynamic path's")
        L = torch.from_numpy(factor).to(dev).double().tril()
        recon = ((L @ L.mT - S64).abs().max() / s_max).item()
        last = ((L[-NB:, -NB:] - L_ref_last).abs().max() / scale).item()
        del L, factor
        check(last < 1e-3, f"{label}: last-tile error {last} >= 1e-3")
        check(recon < recon_tol, f"{label}: ||LL^T-S||max/||S||max {recon} >= {recon_tol}")
        return last, recon

    pump_ms_per_task = []  # the pump's kernels dpotrf at depth 1, for the no-op line
    for name, kw, recon_tol in variants[:2]:
        for rep, depth in enumerate(STAGE_DEPTHS):
            with mca(mca_param, "runtime", "stage_depth", depth):
                A, ran, wall, setup, counts, stats = run_dpotrf_native(kw)
            label = f"native {name} depth {depth}"
            last, recon = native_dpotrf_checks(label, kw, recon_tol, A, ran, counts,
                                               stats, name)
            check((stats["prefetched_batches"] > 0) == (depth > 1),
                  f"{label}: {stats['prefetched_batches']} prefetched batches")
            launches[f"native_{name}_{rep}"] = counts
            depth_walls.add(f"dpotrf {name} pump", depth, wall)
            if name == "kernels" and depth == 1:
                pump_ms_per_task.append(wall / ran * 1e3)
            # wall_s is ex.run() alone; the dynamic wall also holds its
            # startup enumeration, so set-up + run is the window that
            # compares with it (the dynamic run at the default depth 1)
            say("native", path="dpotrf", variant=name, stage_depth=depth, rep=rep,
                N=N, nb=NB, tasks=ran, wall_s=wall, capture_build_s=setup,
                tasks_per_s=ran / wall,
                host_ms_per_task=wall / ran * 1e3, pop_batches=stats["pop_batches"],
                prefetched_batches=stats["prefetched_batches"],
                setup_plus_wall_s=setup + wall, dynamic_wall_s=dyn_wall[name],
                same_window_ratio=(setup + wall) / dyn_wall[name],
                same_window_host_ms_per_task=(setup + wall) / ran * 1e3,
                dynamic_host_ms_per_task=dyn_wall[name] / ran * 1e3,
                launches=counts, equal_dynamic=True, last_tile_err=last, recon_err=recon,
                **pipeline_fields(stats))

    for name, kw, recon_tol in variants[:2]:
        for rep, wave in enumerate(WAVES):
            with mca(mca_param, "device", "cuda_wave_batch", wave):
                A, ran, wall, setup, counts, stats = run_dpotrf_native(kw)
            native_dpotrf_checks(f"native {name} wave batch {wave}", kw, recon_tol, A, ran,
                                 counts, stats, name)
            launches[f"native_{name}_waves{wave}_{rep}"] = counts
            wave_line(f"dpotrf {name} pump", wave, rep, ran, wall, stats,
                      capture_build_s=setup, pop_batches=stats["pop_batches"])
            del A

    # eviction under pressure: a 96 MB device budget, below the 256 MiB
    # matrix, so the pump's device evicts and commits under the pipeline,
    # with waves on
    name, kw, recon_tol = variants[0]
    with mca(mca_param, "device", "cuda_mem_budget_mb", 96), \
            mca(mca_param, "runtime", "stage_depth", 2), \
            mca(mca_param, "device", "cuda_wave_batch", 2):
        A, ran, wall, setup, counts, stats = run_dpotrf_native(kw)
    last, recon = native_dpotrf_checks(f"native {name} under 96 MB", kw, recon_tol,
                                       A, ran, counts, stats, name)
    check(stats["evictions"] > 0 and stats["wave_tasks"] > 0,
          f"native {name} under 96 MB: no eviction or no wave ({stats})")
    launches[f"native_{name}_pressure"] = counts
    say("native", path="dpotrf", variant=name, stage_depth=2, budget_mb=96, N=N, nb=NB,
        tasks=ran, wall_s=wall, capture_build_s=setup, setup_plus_wall_s=setup + wall,
        pop_batches=stats["pop_batches"], prefetched_batches=stats["prefetched_batches"],
        launches=counts, equal_dynamic=True, last_tile_err=last, recon_err=recon,
        **pipeline_fields(stats))

    fusion_plans = {}
    for name, kw, _tol in variants[:2]:
        ntasks = dpotrf_task_count(nt, use_trtri=kw.get("use_trtri", False))
        plan = fusion_plan(cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(
            NT=nt, A=TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32)))

        def dynamic_one(mode, rep, name=name, kw=kw):
            A, wall, counts, stats = run_dpotrf(kw)
            check(counts == launches[name],
                  f"{name} at fusion {mode}: launches {counts}, first run {launches[name]}")
            check(np.array_equal(A.to_array(), dyn_factor[name]),
                  f"{name} at fusion {mode}: the factor differs from the first run's")
            launches[f"{name}_fusion_{mode}_{rep}"] = counts
            return wall, stats, {"detach_s": stats["detach_s"]}

        def pump_one(mode, rep, name=name, kw=kw, ntasks=ntasks):
            A, ran, wall, setup, counts, stats = run_dpotrf_native(kw)
            check(ran == ntasks, f"native {name} at fusion {mode}: {ran} tasks")
            check(counts == launches[name],
                  f"native {name} at fusion {mode}: launches {counts}, dynamic {launches[name]}")
            check(np.array_equal(A.to_array(), dyn_factor[name]),
                  f"native {name} at fusion {mode}: the factor differs from the dynamic path's")
            launches[f"native_{name}_fusion_{mode}_{rep}"] = counts
            return setup + wall, stats, {"capture_build_s": setup, "run_s": wall,
                                         "flush_s": stats["flush_s"],
                                         "pop_batches": stats["pop_batches"]}

        fusion_turns(f"dpotrf {name}", ntasks, plan, dynamic_one, "add_taskpool..wait")
        fusion_turns(f"dpotrf {name} pump", ntasks, plan, pump_one, "setup+run")
        fusion_plans[name] = plan

    # one fused pump run at stage depth 2: the transfer lane prestages the
    # supertasks' slots like any batch, and the factor stays the dynamic one
    name, kw, _tol = variants[0]
    ntasks = dpotrf_task_count(nt, use_trtri=kw.get("use_trtri", False))
    _kinds, n_regions, n_members = fusion_plans[name]
    with mca(mca_param, "runtime", "fusion", "auto"), \
            mca(mca_param, "runtime", "stage_depth", 2), \
            mca(mca_param, "device", "cuda_wave_batch", 0):
        A, ran, wall, setup, counts, stats = run_dpotrf_native(kw)
    label = f"native {name} fusion auto depth 2"
    dispatches = ntasks - n_members + n_regions
    check(ran == ntasks and counts == launches[name],
          f"{label}: {ran} tasks, launches {counts}, dynamic {launches[name]}")
    check(np.array_equal(A.to_array(), dyn_factor[name]),
          f"{label}: the factor differs from the dynamic path's")
    check((stats["fused_submits"], stats["fused_tasks"]) == (n_regions, n_members),
          f"{label}: fused submits and tasks {stats['fused_submits']}, "
          f"{stats['fused_tasks']}, expected {(n_regions, n_members)}")
    check(stats["trampoline_entries"] == stats["completion_callbacks"] == 0
          and stats["pumped_tasks"] == stats["executed_tasks"] == dispatches,
          f"{label}: pump stats {stats}")
    check(stats["prefetched_batches"] > 0 and stats["prefetched_tiles"] > 0,
          f"{label}: the lane prestaged nothing ({stats})")
    launches[f"native_{name}_fusion_depth2"] = counts
    say("fusion_depth2", path=f"dpotrf {name} pump", stage_depth=2, tasks=ran,
        dispatches=dispatches, wall_s=wall, capture_build_s=setup,
        setup_plus_wall_s=setup + wall, pop_batches=stats["pop_batches"],
        prefetched_batches=stats["prefetched_batches"], equal_dynamic=True,
        **pipeline_fields(stats))
    del A

    # -- graph phase: dpotrf through GraphExecutor (whole-DAG capture) -------
    # the first call (warm-up, capture, replay) timed on its own; then
    # GRAPH_REPLAYS replays on reused device feeds (apply + synchronize),
    # every output tile equal to the dynamic factor's; then the same DAG
    # level-batched (batched_graph)
    graph_execs = {}
    batched_execs, batched_launches = {}, {}
    #: (path, batch_levels) -> the first call's seconds of its first executor
    first_calls = {}
    # what batched_graph needs of this scope (``h`` is a loop variable here)
    hb = types.SimpleNamespace(torch=torch, card=card, say=say, check=check,
                               first_calls=first_calls)

    def factor_gate(label, tiles, recon_tol):
        """The dpotrf path's gates on a factor given as output tiles:
        ||LL^T - S||max / ||S||max and the last tile against the float64
        Cholesky."""
        L = torch.zeros((N, N), dtype=torch.float64, device=dev)
        for (_c, (m, n)), tile in tiles.items():
            L[m * NB:(m + 1) * NB, n * NB:(n + 1) * NB] = tile
        L = L.tril()
        check(bool(torch.isfinite(L).all()), f"{label}: non-finite factor")
        recon = ((L @ L.mT - S64).abs().max() / s_max).item()
        last = ((L[-NB:, -NB:] - L_ref_last).abs().max() / scale).item()
        del L
        check(last < 1e-3, f"{label}: last-tile error {last} >= 1e-3")
        check(recon < recon_tol, f"{label}: ||LL^T-S||max/||S||max {recon} >= {recon_tol}")
        return recon, last

    def run_graph(ex, feeds):
        """The first call and GRAPH_REPLAYS replays of ``ex`` on ``feeds``:
        (first call's outputs, last replay's outputs, first-call seconds,
        replay seconds)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = ex.apply(feeds)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        gc.collect()  # the timed replays start with no garbage pending
        replay_s = []
        for _ in range(GRAPH_REPLAYS):
            t0 = time.perf_counter()
            last = ex.apply(feeds)
            torch.cuda.synchronize()
            replay_s.append(time.perf_counter() - t0)
        return first, last, first_s, replay_s

    def graph_fields(ex, first_s, replay_s, tasks):
        med = statistics.median(replay_s)
        per_replay = {}
        for (fn, mode), n in ex.launches.items():
            per_replay.setdefault(fn, {})[mode] = n
        return dict(tasks=tasks, first_call_s=first_s, capture_s=ex.capture_s,
                    replay_s=replay_s, median_replay_s=med,
                    host_ms_per_task=med / tasks * 1e3, launches_per_replay=per_replay,
                    graph_pool_bytes=ex.graph_pool_bytes,
                    static_input_bytes=sum(int(t.nbytes) for t in ex._prog.static_in))

    for name, kw, _tol in variants:
        ntasks = dpotrf_task_count(nt, use_trtri=kw.get("use_trtri", False))
        A = TiledMatrix(N, N, NB, NB, name="A", dtype=np.float32).from_array(S)
        tp = cholesky_ptg(use_cuda=True, use_cpu=False, **kw).taskpool(NT=A.mt, A=A)
        gc.collect()
        t0 = time.perf_counter()
        ex = GraphExecutor(tp)
        plan_s = time.perf_counter() - t0
        check(ex.device.type == "cuda", f"GraphExecutor bound to {ex.device}")
        feeds = {k: torch.from_numpy(A.data_of(*k[1]).newest_copy().payload).to(dev)
                 for k in ex.input_keys}
        kernels.reset_counts()
        first, last, first_s, replay_s = run_graph(ex, feeds)
        counts = {fn.__name__: dict(fn.launches_by_mode, total=fn.launches)
                  for fn in (kernels.matmul_update, kernels.matmul)}
        # one eager warm-up, then 1 + GRAPH_REPLAYS replays, each launching
        # what one dynamic run launches
        want = {fn: {mode: n * (2 + GRAPH_REPLAYS) for mode, n in by_mode.items()}
                for fn, by_mode in launches[name].items()}
        check(counts == want, f"graph {name}: launches {counts}, expected {want}")
        launches[f"graph_{name}"] = counts
        fac = torch.from_numpy(dyn_factor[name]).to(dev)
        for (_c, (m, n)), tile in first.items():
            ref = fac[m * NB:(m + 1) * NB, n * NB:(n + 1) * NB]
            check(torch.equal(tile, ref) and torch.equal(last[(_c, (m, n))], ref),
                  f"graph {name}: tile ({m}, {n}) differs from the dynamic factor")
        del fac, first
        fields = graph_fields(ex, first_s, replay_s, ntasks)
        first_calls[(f"dpotrf_{name}", False)] = first_s
        pump = depth_walls.walls.get(f"dpotrf {name} pump")
        say("graph", path="dpotrf", variant=name, N=N, nb=NB, plan_s=plan_s,
            gflops=N ** 3 / 3 / fields["median_replay_s"] / 1e9,
            dynamic_wall_s=dyn_wall[name],
            pump_median_depth1_s=statistics.median(pump[1]) if pump else None,
            equal_dynamic=True, **fields)
        graph_execs[f"dpotrf_{name}"] = (ex, feeds)
        # the same DAG level-batched: each B1/B2 group one launch; its
        # batched library potrf/trsm groups may round apart from the
        # per-tile calls, so the factor passes the path's gates and its
        # distance to the unbatched replay's is printed
        upd = "bf16" if kw.get("bf16_updates") else "f32"
        kernel_of = {"syrk": ("matmul_update", upd), "gemm": ("matmul_update", upd)}
        if kw.get("use_trtri"):
            kernel_of["trsm"] = ("matmul", "f32")
        b_ex, b_last, batched_launches[f"dpotrf_{name}"] = batched_graph(
            hb, f"dpotrf_{name}", tp, feeds, last, fields["median_replay_s"], kernel_of,
            ntasks, exact=False)
        recon, last_err = factor_gate(f"graph_batched {name}", b_last, _tol)
        say("graph_batched_gate", path=f"dpotrf_{name}", recon_err=recon, tol=_tol,
            last_tile_err=last_err, card=card)
        batched_execs[f"dpotrf_{name}"] = (b_ex, feeds)
        del A, tp, last, b_last

    # -- front ends: DTD, JDF, jdfc and the schedulers on dpotrf --------------
    front_ends_phase(types.SimpleNamespace(
        np=np, torch=torch, dev=dev, card=card, say=say, check=check, S=S,
        variants=variants, launches=launches, dyn_factor=dyn_factor,
        dyn_wall=dyn_wall, depth_walls=depth_walls, first_calls=first_calls))

    # -- legacy ASYNC protocol, a mixed CPU/GPU DAG, the single-card core ------
    legacy_async_phase(types.SimpleNamespace(
        np=np, torch=torch, dev=dev, card=card, say=say, check=check, S=S, S64=S64,
        s_max=s_max, variants=variants, launches=launches, dyn_factor=dyn_factor,
        dyn_wall=dyn_wall))

    # -- the graph verifier and the runtime checkers on the dpotrf path -----
    analysis_phase(types.SimpleNamespace(
        np=np, torch=torch, card=card, say=say, check=check, S=S,
        variants=variants, launches=launches, dyn_factor=dyn_factor))

    # -- the trace stack: traced dpotrf, pump, prefill and a capture ---------
    profiling_b5 = {}
    profiling_phase(types.SimpleNamespace(
        np=np, torch=torch, card=card, say=say, check=check, S=S,
        variants=variants, launches=launches, dyn_factor=dyn_factor,
        b5_launches=profiling_b5))

    # -- the serving plane and the live planes: three tenants served --------
    serve = types.SimpleNamespace(
        np=np, torch=torch, dev=dev, card=card, say=say, check=check, S=S,
        launches=launches, dyn_factor=dyn_factor, b5_launches=profiling_b5)
    serve_phase(serve)
    mr_factor = {k: dyn_factor[k] for k in ("kernels", "kernels_trtri")}
    del dyn_factor

    # -- the array front end: one mixed program through every runtime ------
    arr_out = {}
    array_phase(types.SimpleNamespace(
        np=np, torch=torch, dev=dev, card=card, say=say, check=check, arr_out=arr_out))
    gc.collect()
    torch.cuda.empty_cache()

    # -- the cross-rank core: 2 and 4 ranks on the one card ------------------
    mr = types.SimpleNamespace(
        np=np, torch=torch, dev=dev, card=card, say=say, check=check, S=S,
        launches=launches, mr_factor=mr_factor, mr_wall=dyn_wall, arr_out=arr_out,
        pump_ms_per_task=pump_ms_per_task)
    multirank_phase(mr)
    gc.collect()
    torch.cuda.empty_cache()

    # -- collectives, reshape and redistribution at 4 ranks ------------------
    coll_phase(types.SimpleNamespace(
        np=np, torch=torch, dev=dev, card=card, say=say, check=check, S=S,
        launches=launches, mr_factor=mr_factor))
    gc.collect()
    torch.cuda.empty_cache()

    # -- the TCP backend: 4 rank processes over loopback on the one card -----
    tcp_phase(types.SimpleNamespace(
        np=np, torch=torch, card=card, say=say, check=check, S=S, launches=launches,
        mr_factor=mr_factor, mr_wall=dyn_wall, mr_walls=mr.mr_walls, mr_acts=mr.mr_acts))
    kernels_factor = mr_factor["kernels"]
    del mr_factor, arr_out, mr
    gc.collect()
    torch.cuda.empty_cache()

    # -- the SPMD layer and the ring graphs: 4 positions on the one card -----
    par = parallel_phase(types.SimpleNamespace(
        np=np, torch=torch, dev=dev, card=card, say=say, check=check, S=S,
        time_ms=time_ms, bound=bound, carry_err=carry_err, attn_pairs=attn_pairs))
    batched_launches.update(par["batched"])
    gc.collect()
    torch.cuda.empty_cache()

    # -- the tutorial examples: each on the card, ex08/ex11 at full width ----
    batched_launches.update(examples_phase(types.SimpleNamespace(
        np=np, torch=torch, dev=dev, card=card, say=say, check=check, S=S,
        launches=launches, kernels_factor=kernels_factor)))
    del kernels_factor
    gc.collect()
    torch.cuda.empty_cache()

    # -- device-module phase: the CUDA module's GPU-only paths ----------------
    # event-polled completion (cuda_eager_complete=0) and eviction with
    # device->host write-back (an 8 MB budget for 10 MB of tiles), on the
    # leading 2048 x 2048 block of S (SPD as every leading block is)
    n_small = 2048
    S_small = np.ascontiguousarray(S[:n_small, :n_small])
    L_small = torch.linalg.cholesky(Sg[:n_small, :n_small].double())
    small_scale = L_small.abs().max().item()
    for label, params in (("event_polled", {"cuda_eager_complete": 0}),
                          ("eviction", {"cuda_mem_budget_mb": 8})):
        for key, value in params.items():
            mca_param.set_param("device", key, value)
        try:
            A, wall, _counts, stats = run_dpotrf(dict(use_kernels=True), S_small)
        finally:
            for key in params:
                mca_param.unset("device", key)
        L = torch.from_numpy(A.to_array()).to(dev).double().tril()
        err = ((L - L_small).abs().max() / small_scale).item()
        check(err < 1e-3, f"device module [{label}]: factor error {err} >= 1e-3")
        check(stats["executed_tasks"] == dpotrf_task_count(n_small // NB),
              f"device module [{label}]: {stats['executed_tasks']} tasks")
        if label == "eviction":
            check(stats["evictions"] > 0 and stats["bytes_out"] > 0,
                  f"device module [eviction]: no eviction write-back ({stats})")
        say("device_module", check=label, N=n_small, nb=NB, wall_s=wall,
            factor_err=err, **pipeline_fields(stats))

    # -- attention path: run_flash_attention on the CUDA device module -------
    # q/k/v from numpy seed 9 as bench.py makes them; the decode step's
    # queries are the last DEC_SQ rows of a DEC_SK-row q, so its oracle is
    # the tail of the full causal attention
    rng = np.random.default_rng(9)
    mk = lambda s_len: rng.standard_normal(  # noqa: E731
        (ATTN_B, s_len, ATTN_H, ATTN_D)).astype(np.float32)
    pre_q, pre_k, pre_v = mk(ATTN_S), mk(ATTN_S), mk(ATTN_S)
    dec_q, dec_k, dec_v = mk(DEC_SK), mk(DEC_SK), mk(DEC_SK)

    def on_card(*arrays, dtype=torch.float32):
        return [torch.from_numpy(a).to(dev).to(dtype) for a in arrays]

    def allclose_gate(out, ref, tol):
        """max(|out - ref| - tol*|ref|): <= tol is allclose(rtol=tol, atol=tol)."""
        diff = (out.to(dev).double() - ref).abs()
        return (diff - tol * ref.abs()).max().item(), diff.max().item()

    def run_attention(q, k, v, **kw):
        """One run_flash_attention through Context/add_taskpool/wait with
        every task on the CUDA device module; returns the output, wall
        seconds (build, run and assemble: the whole entry-point call), B5
        launches and the CUDA module's stats with ``flush_s``, the seconds
        of ctx.fini()."""
        ctx = Context()
        try:
            cuda_dev = next(d for d in ctx.devices if d.mca_name == "cuda")
            check(cuda_dev.tdev.type == "cuda", f"CUDA module bound to {cuda_dev.tdev}")
            kernels.reset_counts()
            gc.collect()  # each timed window starts with no garbage pending
            t0 = time.perf_counter()
            out = run_flash_attention(ctx, q, k, v, use_cpu=False, **kw)
            wall = time.perf_counter() - t0
            n_launch = dict(kernels.flash_attention_block.launches_by_mode,
                            total=kernels.flash_attention_block.launches)
        finally:
            # the write-back home (committer flush + batched D2H), timed
            # apart from fini's teardown; fini's own detach finds it done
            t0 = time.perf_counter()
            cuda_dev.detach()
            detach_s = time.perf_counter() - t0
            ctx.fini()
            flush = time.perf_counter() - t0
        stats = device_stats(cuda_dev, flush_s=flush, detach_s=detach_s)
        check(stats["wb_sync_fallbacks"] == 0, f"attention {kw}: synchronous write-back "
              f"fallbacks {stats['wb_sync_fallbacks']}")
        return out, wall, n_launch, stats

    attn_runs = [  # (name, q, k, v, dtype, kwargs, tolerance)
        ("attn_prefill_f32", (pre_q, pre_k, pre_v), torch.float32,
         dict(causal=True, q_block=ATTN_BLOCK, kv_block=ATTN_BLOCK), TOL_ATTN_F32),
        ("attn_prefill_bf16", (pre_q, pre_k, pre_v), torch.bfloat16,
         dict(causal=True, q_block=ATTN_BLOCK, kv_block=ATTN_BLOCK), TOL_ATTN_BF16),
        ("attn_decode", (dec_q[:, -DEC_SQ:], dec_k, dec_v), torch.float32,
         dict(causal=True, q_block="auto", kv_block=ATTN_BLOCK), TOL_ATTN_F32),
    ]
    attn_launches = dict(profiling_b5)
    attn_launches.update(par["single"])  # the ring PTG's single launches
    attn_out, attn_wall = {}, {}
    for name, (q_np, k_np, v_np), dt, kw, tol in attn_runs:
        q_in, k_in, v_in = (torch.from_numpy(a).to(dt) for a in (q_np, k_np, v_np))
        sq, sk = q_in.shape[1], k_in.shape[1]
        qb = ATTN_BLOCK if kw["q_block"] != "auto" else min(128, sq)
        ntasks = attention_task_count(ATTN_B, sq, sk, ATTN_H, qb, kw["kv_block"],
                                      causal=True)
        n_steps = ntasks - ATTN_B * ATTN_H * (-(-sq // qb))
        expected = dict.fromkeys(kernels.flash_attention_block.launches_by_mode, 0)
        expected.update({"bf16" if dt == torch.bfloat16 else "f32": n_steps, "total": n_steps})
        # the f32 prefill at the default stage depth 1 and at depth 2, in turns
        depths = STAGE_DEPTHS if name == "attn_prefill_f32" else (2,)
        runs = []
        for rep, depth in enumerate(depths):
            with mca(mca_param, "runtime", "stage_depth", depth):
                out, wall, n_launch, stats = run_attention(q_in, k_in, v_in, **kw)
            check(tuple(out.shape) == tuple(q_in.shape) and out.dtype == dt,
                  f"{name}: output {tuple(out.shape)} {out.dtype}")
            check(stats["executed_tasks"] == ntasks,
                  f"{name}: {stats['executed_tasks']} tasks on the CUDA device, "
                  f"expected {ntasks}")
            check(n_launch == expected,
                  f"{name}: flash_attention_block launches {n_launch}, expected {expected}")
            attn_launches[name if rep == 0 else f"{name}_{rep}"] = n_launch
            if rep == 0:
                first, attn_wall[name] = out, wall
            else:
                check(torch.equal(out, first),
                      f"{name} at depth {depth}: output differs from the first run's")
            if len(depths) > 1:
                depth_walls.add(name, depth, wall)
            runs.append((depth, wall, stats))
            del out
        out = first
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        # float64 oracle on the inputs the run saw (bf16-rounded for bf16)
        if name == "attn_decode":
            q64, k64, v64 = on_card(dec_q, dec_k, dec_v, dtype=torch.float64)
            ref = attention_reference(q64, k64, v64, causal=True)[:, -DEC_SQ:]
        else:
            q64, k64, v64 = (t.to(dev).double() for t in (q_in, k_in, v_in))
            ref = attention_reference(q64, k64, v64, causal=True)
        del q64, k64, v64
        gate, max_err = allclose_gate(out, ref, tol)
        del ref
        check(gate <= tol, f"{name}: |out - ref| - {tol}|ref| reaches {gate} > {tol}")
        flops = 4.0 * ATTN_B * ATTN_H * sq * sk * ATTN_D
        if name == "attn_prefill_f32":
            attn_out[name] = out  # the pump's output must equal it
        for rep, (depth, wall, stats) in enumerate(runs):
            say("attention", run=name, stage_depth=depth, rep=rep, B=ATTN_B, Sq=sq,
                Sk=sk, H=ATTN_H, D=ATTN_D, dtype=str(dt), q_block=qb,
                kv_block=kw["kv_block"], tasks=ntasks, launches=n_steps, wall_s=wall,
                nominal_gflops=flops / wall / 1e9, tasks_per_s=ntasks / wall,
                max_abs_err=max_err, gate=gate, tol=tol, equal_first_run=True,
                **pipeline_fields(stats))
        del out, first
        torch.cuda.empty_cache()

    # -- native phase: the f32 prefill through the native pump ----------------
    pf_name, (q_np, k_np, v_np), dt, pf_kw, tol = attn_runs[0]
    pf_in = [torch.from_numpy(a).to(dt) for a in (q_np, k_np, v_np)]
    pf_tasks = attention_task_count(ATTN_B, ATTN_S, ATTN_S, ATTN_H, ATTN_BLOCK,
                                    ATTN_BLOCK, causal=True)
    pf_steps = pf_tasks - ATTN_B * ATTN_H * (ATTN_S // ATTN_BLOCK)

    # the dynamic f32 prefill with waves on and off, in turns, each output
    # equal to the first run's
    for rep, wave in enumerate(WAVES):
        with mca(mca_param, "device", "cuda_wave_batch", wave):
            out, wall, n_launch, stats = run_attention(*pf_in, **pf_kw)
        check(n_launch == attn_launches[pf_name],
              f"{pf_name} at wave batch {wave}: B5 launches {n_launch}")
        check(torch.equal(out, attn_out[pf_name]),
              f"{pf_name} at wave batch {wave}: output differs from the first run's")
        attn_launches[f"{pf_name}_waves{wave}_{rep}"] = n_launch
        wave_line(pf_name, wave, rep, pf_tasks, wall, stats)
        del out

    def run_attention_native(fusion=None):
        """run_flash_attention_native, the user entry point: build, capture,
        pump and assemble in one call, on a device module of its own so
        its staging counters can be read (``fusion`` its argument).
        Returns the output, wall seconds, B5 launches per mode and the
        device's stats."""
        kernels.reset_counts()
        gc.collect()  # each timed window starts with no garbage pending
        t0 = time.perf_counter()
        pump_dev = NativeExecutor._make_device()
        out = run_flash_attention_native(*pf_in, device=pump_dev, fusion=fusion, **pf_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = device_stats(pump_dev, flush_s=0.0)
        check(stats["wb_sync_fallbacks"] == 0, "native prefill: synchronous write-back "
              f"fallbacks {stats['wb_sync_fallbacks']}")
        return out, wall, dict(kernels.flash_attention_block.launches_by_mode,
                               total=kernels.flash_attention_block.launches), stats

    def b5_gates(label, out, n_launch):
        expected = dict.fromkeys(kernels.flash_attention_block.launches_by_mode, 0)
        expected.update({"f32": pf_steps, "total": pf_steps})
        check(n_launch == expected,
              f"{label}: flash_attention_block launches {n_launch}, expected {expected}")
        check(torch.equal(out, attn_out[pf_name]),
              f"{label}: output differs from run_flash_attention's")

    ref = attention_reference(*(t.to(dev).double() for t in pf_in), causal=True)
    for rep, depth in enumerate(STAGE_DEPTHS):
        with mca(mca_param, "runtime", "stage_depth", depth):
            out, wall_total, n_launch, stats = run_attention_native()
        b5_gates(f"native attn_prefill_f32 depth {depth}", out, n_launch)
        attn_launches[f"{pf_name}_native_{rep}"] = n_launch
        depth_walls.add(f"{pf_name} pump", depth, wall_total)
        gate, max_err = allclose_gate(out, ref, tol)
        del out
        check(gate <= tol, f"native {pf_name} depth {depth}: |out - ref| - {tol}|ref| "
                           f"reaches {gate} > {tol}")
        # the whole entry-point call against the whole dynamic call
        say("native", path="attention", run=pf_name, stage_depth=depth, rep=rep,
            entry_point_wall_s=wall_total, dynamic_wall_s=attn_wall[pf_name],
            same_window_ratio=wall_total / attn_wall[pf_name],
            launches=n_launch["total"], equal_dynamic=True, max_abs_err=max_err,
            gate=gate, tol=tol, **pipeline_fields(stats))
    for rep, wave in enumerate(WAVES):
        with mca(mca_param, "device", "cuda_wave_batch", wave):
            out, wall_total, n_launch, stats = run_attention_native()
        b5_gates(f"native {pf_name} wave batch {wave}", out, n_launch)
        attn_launches[f"{pf_name}_native_waves{wave}_{rep}"] = n_launch
        wave_line(f"{pf_name} pump", wave, rep, pf_tasks, wall_total, stats)
        del out
    del ref
    # the default depth's entry-point wall, the median of its runs
    wall_total = statistics.median(depth_walls.walls[f"{pf_name} pump"][1])

    def prefill_pump():
        """What run_flash_attention_native does, each piece timed apart on
        an executor whose stats stay readable: the graph's build, capture +
        engine build (with fusion, the partition and the plans), the pump,
        close() and assemble().  Returns the output, the pieces' seconds
        (``wall`` the whole call), tasks run, B5 launches and the
        executor's stats merged with its device's."""
        kernels.reset_counts()
        gc.collect()  # each timed window starts with no garbage pending
        t = [time.perf_counter()]
        tp, assemble = build_flash_attention(*pf_in, use_cpu=False, **pf_kw)
        t.append(time.perf_counter())
        ex = NativeExecutor(tp, native_device=True)
        t.append(time.perf_counter())
        try:
            ran = ex.run()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            stats = dict(ex.stats)
        finally:
            ex.close()
        t.append(time.perf_counter())
        out = assemble()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        secs = dict(zip(("graph_build_s", "capture_build_s", "run_s", "close_s",
                         "assemble_s"), np.diff(t).tolist()), wall=t[-1] - t[0])
        stats.update(device_stats(ex.device, flush_s=secs["close_s"]))
        check(stats["wb_sync_fallbacks"] == 0, "native prefill: synchronous write-back "
              f"fallbacks {stats['wb_sync_fallbacks']}")
        return out, secs, ran, dict(kernels.flash_attention_block.launches_by_mode,
                                    total=kernels.flash_attention_block.launches), stats

    # the same call's pieces, to time each apart
    out, secs, ran, n_launch, stats = prefill_pump()
    pump_gates(f"native {pf_name} (pieces)", ran, pf_tasks, stats)
    b5_gates(f"native {pf_name} (pieces)", out, n_launch)
    del out
    attn_launches[f"{pf_name}_native_pieces"] = n_launch
    wall = pump_run_s = secs["run_s"]
    # wall_s is ex.run() alone; the dynamic wall is the whole
    # run_flash_attention call (build, run, assemble), so the whole
    # run_flash_attention_native call is the window that compares with it
    say("native", path="attention", run=pf_name, tasks=ran, wall_s=wall,
        capture_build_s=secs["capture_build_s"], tasks_per_s=ran / wall,
        host_ms_per_task=wall / ran * 1e3, pop_batches=stats["pop_batches"],
        graph_build_s=secs["graph_build_s"], close_s=secs["close_s"],
        assemble_s=secs["assemble_s"], entry_point_wall_s=wall_total,
        dynamic_wall_s=attn_wall[pf_name], same_window_ratio=wall_total / attn_wall[pf_name],
        same_window_host_ms_per_task=wall_total / ran * 1e3,
        dynamic_host_ms_per_task=attn_wall[pf_name] / ran * 1e3,
        prefetched_batches=stats["prefetched_batches"], launches=n_launch["total"],
        equal_dynamic=True, **pipeline_fields(stats))

    pf_plan = fusion_plan(build_flash_attention(*pf_in, use_cpu=False, **pf_kw)[0])

    def prefill_dynamic_one(mode, rep):
        out, wall, n_launch, stats = run_attention(*pf_in, **pf_kw)
        check(n_launch == attn_launches[pf_name],
              f"{pf_name} at fusion {mode}: B5 launches {n_launch}")
        check(torch.equal(out, attn_out[pf_name]),
              f"{pf_name} at fusion {mode}: output differs from the first run's")
        attn_launches[f"{pf_name}_fusion_{mode}_{rep}"] = n_launch
        return wall, stats, {"detach_s": stats["detach_s"]}

    def prefill_pump_one(mode, rep):
        out, secs, ran, n_launch, stats = prefill_pump()
        check(ran == pf_tasks, f"native {pf_name} at fusion {mode}: {ran} tasks")
        b5_gates(f"native {pf_name} at fusion {mode}", out, n_launch)
        attn_launches[f"{pf_name}_native_fusion_{mode}_{rep}"] = n_launch
        return secs["wall"], stats, dict(secs, pop_batches=stats["pop_batches"])

    fusion_turns(pf_name, pf_tasks, pf_plan, prefill_dynamic_one, "the whole call")
    fusion_turns(f"{pf_name} pump", pf_tasks, pf_plan, prefill_pump_one, "the whole call")
    # the user's entry point with its fusion= argument (runtime_fusion off)
    out, entry_wall, n_launch, stats = run_attention_native(fusion="auto")
    b5_gates(f"run_flash_attention_native({pf_name}, fusion='auto')", out, n_launch)
    del out
    check((stats["fused_submits"], stats["fused_tasks"]) == pf_plan[1:],
          f"run_flash_attention_native(fusion='auto'): fused submits and tasks "
          f"{stats['fused_submits']}, {stats['fused_tasks']}, expected {pf_plan[1:]}")
    attn_launches[f"{pf_name}_native_fusion_entry"] = n_launch
    say("fusion_entry_point", path=f"{pf_name} pump", fusion="auto",
        entry_point_wall_s=entry_wall, tasks=pf_tasks,
        dispatches=stats["executed_tasks"], **pipeline_fields(stats))

    # -- graph phase: the f32 prefill through GraphExecutor --------------------
    tp, assemble = build_flash_attention(*pf_in, use_cpu=False, **pf_kw)
    t0 = time.perf_counter()
    ex = GraphExecutor(tp)
    plan_s = time.perf_counter() - t0
    feeds = {k: torch.as_tensor(tp.constants[k[0]].data_of(*k[1]).newest_copy().payload)
             .to(dev) for k in ex.input_keys}
    kernels.reset_counts()
    first, last, first_s, replay_s = run_graph(ex, feeds)
    n_launch = dict(kernels.flash_attention_block.launches_by_mode,
                    total=kernels.flash_attention_block.launches)
    want = {mode: n * (2 + GRAPH_REPLAYS) for mode, n in attn_launches[pf_name].items()}
    check(n_launch == want, f"graph {pf_name}: B5 launches {n_launch}, expected {want}")
    attn_launches[f"{pf_name}_graph"] = n_launch
    # every output plane O(g, i), from the first call and the last replay,
    # equal to run_flash_attention's output block
    want_out = attn_out[pf_name].to(dev)
    check([k[0] for k in last] == ["O"] * (ATTN_B * ATTN_H * (ATTN_S // ATTN_BLOCK)),
          f"graph {pf_name}: outputs {sorted({k[0] for k in last})}")
    for key, plane in last.items():
        b, h = divmod(key[1][0], ATTN_H)
        o = key[1][1] * ATTN_BLOCK
        ref = want_out[b, o:o + ATTN_BLOCK, h, :]
        check(torch.equal(plane, ref) and torch.equal(first[key], ref),
              f"graph {pf_name}: output plane {key} differs from run_flash_attention's")
    del first, want_out
    say("graph", path="attention", run=pf_name, plan_s=plan_s,
        nominal_gflops=4.0 * ATTN_B * ATTN_H * ATTN_S ** 2 * ATTN_D
        / statistics.median(replay_s) / 1e9,
        dynamic_wall_s=attn_wall[pf_name], pump_run_s=pump_run_s, equal_dynamic=True,
        **graph_fields(ex, first_s, replay_s, pf_tasks))
    graph_execs[pf_name] = (ex, feeds)
    first_calls[(pf_name, False)] = first_s
    # level-batched: each level's (head, q block) steps one B5 launch over
    # the members' own q offsets, every output plane equal to the replay's
    b_ex, _b_last, batched_launches[pf_name] = batched_graph(
        hb, pf_name, tp, feeds, last, statistics.median(replay_s),
        {"attn_step": ("flash_attention_block", "f32")}, pf_tasks, exact=True)
    batched_execs[pf_name] = (b_ex, feeds)
    del tp, assemble, attn_out, last, _b_last
    torch.cuda.empty_cache()

    # the yardstick users would otherwise call: PyTorch's fused attention on
    # the whole f32 prefill problem ([B, H, S, D] layout), timed only
    qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous()
                  for t in on_card(pre_q, pre_k, pre_v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, is_causal=True)
    sdpa_out = sdpa().permute(0, 2, 1, 3)
    ref = attention_reference(*on_card(pre_q, pre_k, pre_v, dtype=torch.float64),
                              causal=True)
    sdpa_rel = ((sdpa_out.double() - ref).abs().max() / ref.abs().max()).item()
    del ref, sdpa_out
    check(sdpa_rel < 1e-3, f"scaled_dot_product_attention disagrees with the "
                           f"reference: {sdpa_rel}")
    sdpa_ms = time_ms(sdpa, 10)
    say("attention_yardstick", call="torch.nn.functional.scaled_dot_product_attention"
        "(is_causal=True)", shape=[ATTN_B, ATTN_H, ATTN_S, ATTN_D], dtype="float32",
        ms=sdpa_ms, rel_err=sdpa_rel,
        nominal_gflops=4.0 * ATTN_B * ATTN_H * ATTN_S ** 2 * ATTN_D / sdpa_ms / 1e6)
    del qh, kh, vh
    torch.cuda.empty_cache()

    # -- the autotuner, the program cache, fusion's partition cache -------------
    # before the near-full stencil run: that run must pass with the cached
    # graphs' pools held
    hc = types.SimpleNamespace(
        np=np, torch=torch, card=card, kind=kind, say=say, check=check, S=S,
        graph_execs=graph_execs, batched_execs=batched_execs, first_calls=first_calls,
        pf_in=pf_in, pf_kw=pf_kw, pf_name=pf_name, run_attention=run_attention,
        launches=launches, attn_launches=attn_launches, batched_launches=batched_launches)
    tuning_phase(hc)
    program_cache_phase(hc)
    fusion_cache_phase(hc)
    torch.cuda.empty_cache()

    # -- stencil path: the stencil PTG with the B3 chore, then B4 ----------
    grid = np.random.default_rng(0).standard_normal((ST_N, ST_N)).astype(np.float32)
    g64 = torch.from_numpy(grid).to(dev).double()
    zr = torch.zeros((1, ST_N), dtype=torch.float64, device=dev)
    zc = torch.zeros((ST_N, 1), dtype=torch.float64, device=dev)
    st_ref = g64
    for _ in range(ST_T):
        st_ref = kernels.stencil_5pt_plain(st_ref, zr, zr, zc, zc)
    n_tasks_st = ST_T * ST_TILES * ST_TILES

    def run_stencil():
        """One stencil PTG run (B3 chores, every task on the CUDA device
        module); returns the buffers, wall seconds, B3 launches, stats with
        ``flush_s``, the seconds of ctx.fini()."""
        A = StencilBuffers(grid, ST_TILES, ST_TILES)
        ctx = Context()
        try:
            cuda_dev = next(d for d in ctx.devices if d.mca_name == "cuda")
            tp = stencil_ptg(use_kernels=True, use_cpu=False).taskpool(
                T=ST_T, MT=ST_TILES, NT=ST_TILES, A=A)
            kernels.reset_counts()
            gc.collect()  # each timed window starts with no garbage pending
            t0 = time.perf_counter()
            ctx.add_taskpool(tp)
            ok = tp.wait(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_launch = kernels.stencil_5pt.launches
        finally:
            # the write-back home (committer flush + batched D2H), timed
            # apart from fini's teardown; fini's own detach finds it done
            t0 = time.perf_counter()
            cuda_dev.detach()
            detach_s = time.perf_counter() - t0
            ctx.fini()
            flush = time.perf_counter() - t0
        check(ok, f"stencil: taskpool failed ({tp.fail_reason})")
        stats = device_stats(cuda_dev, flush_s=flush, detach_s=detach_s)
        check(stats["wb_sync_fallbacks"] == 0, "stencil: synchronous write-back "
              f"fallbacks {stats['wb_sync_fallbacks']}")
        return A, wall, n_launch, stats

    def run_stencil_native(g=grid, steps=ST_T):
        """The same stencil through NativeExecutor(native_device=True): set-up
        (capture + build) outside the window, the window ex.run() +
        synchronize, then close() (the write-back home).  Returns the
        buffers, tasks run, wall and set-up seconds, B3 launches and the
        executor's stats merged with its device module's.  ``g`` (in
        1024^2 tiles) and ``steps`` default to the path's."""
        tiles = g.shape[0] // (ST_N // ST_TILES)
        A = StencilBuffers(g, tiles, tiles)
        tp = stencil_ptg(use_kernels=True, use_cpu=False).taskpool(
            T=steps, MT=tiles, NT=tiles, A=A)
        gc.collect()  # each timed window starts with no garbage pending
        t0 = time.perf_counter()
        ex = NativeExecutor(tp, native_device=True)
        setup = time.perf_counter() - t0
        try:
            check(ex.device.tdev.type == "cuda", f"pump device bound to {ex.device.tdev}")
            kernels.reset_counts()
            t0 = time.perf_counter()
            ran = ex.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_launch = kernels.stencil_5pt.launches
            stats = dict(ex.stats)
        finally:
            t0 = time.perf_counter()
            ex.close()
            flush = time.perf_counter() - t0
        stats.update(device_stats(ex.device, flush_s=flush))
        check(stats["wb_sync_fallbacks"] == 0, "native stencil: synchronous write-back "
              f"fallbacks {stats['wb_sync_fallbacks']}")
        return A, ran, wall, setup, n_launch, stats

    # through Context at the default stage depth 1 and at depth 2, in turns
    st_launch_total = 0
    for rep, depth in enumerate(STAGE_DEPTHS):
        with mca(mca_param, "runtime", "stage_depth", depth):
            A, wall, st_launches, stats = run_stencil()
        check(stats["executed_tasks"] == n_tasks_st,
              f"stencil: {stats['executed_tasks']} tasks on the CUDA device, "
              f"expected {n_tasks_st}")
        check(st_launches == n_tasks_st,
              f"stencil: {st_launches} stencil_5pt launches, expected {n_tasks_st}")
        st_launch_total += st_launches
        depth_walls.add("stencil", depth, wall)
        if rep == 0:
            st_dyn, st_wall = A.to_array(ST_T % 2), wall
            got = torch.from_numpy(st_dyn).to(dev).double()
            st_gate, st_err = allclose_gate(got, st_ref, TOL_STENCIL_PATH)
            del got
            check(st_gate <= TOL_STENCIL_PATH, f"stencil: |out - ref| - tol|ref| "
                                               f"reaches {st_gate} > {TOL_STENCIL_PATH}")
        else:
            check(np.array_equal(A.to_array(ST_T % 2), st_dyn),
                  f"stencil at depth {depth}: grid differs from the first run's")
        say("stencil", N=ST_N, tile=ST_N // ST_TILES, T=ST_T, tasks=n_tasks_st,
            launches=st_launches, wall_s=wall, stage_depth=depth, rep=rep,
            gcells_per_s=ST_N * ST_N * ST_T / wall / 1e9, max_abs_err=st_err,
            gate=st_gate, tol=TOL_STENCIL_PATH, equal_first_run=True,
            **pipeline_fields(stats))
        del A
    for rep, wave in enumerate(WAVES):
        with mca(mca_param, "device", "cuda_wave_batch", wave):
            A, wall, st_launches, stats = run_stencil()
        check(st_launches == n_tasks_st,
              f"stencil at wave batch {wave}: {st_launches} stencil_5pt launches")
        check(np.array_equal(A.to_array(ST_T % 2), st_dyn),
              f"stencil at wave batch {wave}: grid differs from the first run's")
        st_launch_total += st_launches
        wave_line("stencil", wave, rep, n_tasks_st, wall, stats)
        del A
    # the stencil through the native pump, at stage depth 1 and 2 in turns,
    # then at depth 2 with the reference's 32 MB write-back watermark (the
    # committer then drains mid-run, beside the kernels)
    for rep, (depth, window_mb) in enumerate([(d, None) for d in STAGE_DEPTHS]
                                             + [(2, 32)]):
        with mca(mca_param, "runtime", "wb_window_mb", window_mb or 0), \
                mca(mca_param, "runtime", "stage_depth", depth):
            A, ran, wall, setup, n_launch, stats = run_stencil_native()
        label = f"native stencil depth {depth}" + (f" window {window_mb} MB"
                                                   if window_mb else "")
        pump_gates(label, ran, n_tasks_st, stats)
        check(n_launch == n_tasks_st,
              f"{label}: {n_launch} stencil_5pt launches, expected {n_tasks_st}")
        check(np.array_equal(A.to_array(ST_T % 2), st_dyn),
              f"{label}: grid differs from the dynamic path's")
        check((stats["prefetched_batches"] > 0) == (depth > 1),
              f"{label}: {stats['prefetched_batches']} prefetched batches")
        st_launch_total += n_launch
        if window_mb is None:
            depth_walls.add("stencil pump", depth, wall)
        say("native", path="stencil", stage_depth=depth, rep=rep,
            wb_window_mb=window_mb or 0, N=ST_N, tile=ST_N // ST_TILES,
            T=ST_T, tasks=ran, launches=n_launch, wall_s=wall, capture_build_s=setup,
            setup_plus_wall_s=setup + wall, dynamic_wall_s=st_wall,
            same_window_ratio=(setup + wall) / st_wall, host_ms_per_task=wall / ran * 1e3,
            pop_batches=stats["pop_batches"], prefetched_batches=stats["prefetched_batches"],
            equal_dynamic=True, **pipeline_fields(stats))
        del A
    for rep, wave in enumerate(WAVES):
        with mca(mca_param, "device", "cuda_wave_batch", wave):
            A, ran, wall, setup, n_launch, stats = run_stencil_native()
        label = f"native stencil wave batch {wave}"
        pump_gates(label, ran, n_tasks_st, stats)
        check(n_launch == n_tasks_st, f"{label}: {n_launch} stencil_5pt launches")
        check(np.array_equal(A.to_array(ST_T % 2), st_dyn),
              f"{label}: grid differs from the dynamic path's")
        st_launch_total += n_launch
        wave_line("stencil pump", wave, rep, ran, wall, stats, capture_build_s=setup,
                  pop_batches=stats["pop_batches"])
        del A
    # the stencil's fusion turns, through Context and the pump: its levels
    # fuse into waves of the default horizon
    st_plan = fusion_plan(stencil_ptg(use_kernels=True, use_cpu=False).taskpool(
        T=ST_T, MT=ST_TILES, NT=ST_TILES, A=StencilBuffers(grid, ST_TILES, ST_TILES)))

    def stencil_dynamic_one(mode, rep):
        nonlocal st_launch_total
        A, wall, n_launch, stats = run_stencil()
        check(n_launch == n_tasks_st,
              f"stencil at fusion {mode}: {n_launch} stencil_5pt launches")
        check(np.array_equal(A.to_array(ST_T % 2), st_dyn),
              f"stencil at fusion {mode}: grid differs from the first run's")
        st_launch_total += n_launch
        return wall, stats, {"detach_s": stats["detach_s"]}

    def stencil_pump_one(mode, rep):
        nonlocal st_launch_total
        A, ran, wall, setup, n_launch, stats = run_stencil_native()
        check(ran == n_tasks_st and n_launch == n_tasks_st,
              f"native stencil at fusion {mode}: {ran} tasks, {n_launch} launches")
        check(np.array_equal(A.to_array(ST_T % 2), st_dyn),
              f"native stencil at fusion {mode}: grid differs from the dynamic path's")
        st_launch_total += n_launch
        return setup + wall, stats, {"capture_build_s": setup, "run_s": wall,
                                     "flush_s": stats["flush_s"],
                                     "pop_batches": stats["pop_batches"]}

    fusion_turns("stencil", n_tasks_st, st_plan, stencil_dynamic_one, "add_taskpool..wait")
    fusion_turns("stencil pump", n_tasks_st, st_plan, stencil_pump_one, "setup+run")

    # a near-full card: a grid twice the path's side (2 GiB of tiles) for
    # NEAR_FULL_STEPS steps through the pump, with waves off on the open
    # card, then after a ballast tensor has left NEAR_FULL_MB free, once
    # with waves on and once with fusion on.  With waves the automatic
    # budget (85% of what the wave graphs' room and a chunk in flight
    # leave) is below the tiles, so the pump evicts while its graphs are
    # captured within their room; with fusion the budget gives up a
    # region's room (twice its output bytes) and its regions run within
    # what is left.  No out-of-memory error, and the grid equals the open
    # card's
    big = np.random.default_rng(1).standard_normal((2 * ST_N, 2 * ST_N)).astype(np.float32)
    big_tasks = 4 * ST_TILES * ST_TILES * NEAR_FULL_STEPS
    with mca(mca_param, "device", "cuda_wave_batch", 0):
        A, ran, _wall, _setup, n_launch, _stats = run_stencil_native(big, NEAR_FULL_STEPS)
    check(ran == n_launch == big_tasks, f"open-card big stencil: {ran} tasks, {n_launch} launches")
    big_want = A.to_array(NEAR_FULL_STEPS % 2)
    del A

    def near_full(settings):
        """The big stencil through the pump behind a ballast leaving
        NEAR_FULL_MB free, with the MCA ``settings`` ((framework, name):
        value); returns the free bytes left, the bytes the run reserved
        beyond the card's state at its start, and the run's results."""
        gc.collect()
        torch.cuda.empty_cache()
        free, _total = torch.cuda.mem_get_info(dev)
        ballast = torch.empty(free - (NEAR_FULL_MB << 20), dtype=torch.uint8, device=dev)
        try:
            free_left, _total = torch.cuda.mem_get_info(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            reserved = torch.cuda.memory_reserved(dev)
            with contextlib.ExitStack() as params:
                for (framework, name), value in settings.items():
                    params.enter_context(mca(mca_param, framework, name, value))
                res = run_stencil_native(big, NEAR_FULL_STEPS)
            peak = torch.cuda.max_memory_reserved(dev) - reserved
        finally:
            del ballast
            torch.cuda.empty_cache()
        return (free_left, peak) + res

    free_left, peak, A, ran, wall, setup, n_launch, stats = near_full(
        {("device", "cuda_wave_batch"): 2})
    label = f"native stencil {2 * ST_N}^2, {NEAR_FULL_MB} MB free, waves on"
    pump_gates(label, ran, big_tasks, stats)
    check(n_launch == big_tasks, f"{label}: {n_launch} stencil_5pt launches")
    check(np.array_equal(A.to_array(NEAR_FULL_STEPS % 2), big_want),
          f"{label}: grid differs from the open card's")
    check(stats["mem_budget"] < big.nbytes * 2 and stats["evictions"] > 0
          and stats["wave_graphs"] > 0,
          f"{label}: budget {stats['mem_budget']}, evictions {stats['evictions']}, "
          f"graphs {stats['wave_graphs']}")
    check(cuda_module.wave_graph_bytes(dev) == 0, f"{label}: the wave graphs outlived the run")
    say("native", path="stencil", near_full_free_bytes=free_left, N=2 * ST_N,
        tile=ST_N // ST_TILES, T=NEAR_FULL_STEPS, wave_batch=2, tasks=ran, launches=n_launch,
        wall_s=wall, capture_build_s=setup, mem_budget=stats["mem_budget"],
        run_peak_reserved_bytes=peak, equal_open_card=True, **pipeline_fields(stats))
    del A
    big_plan = fusion_plan(stencil_ptg(use_kernels=True, use_cpu=False).taskpool(
        T=NEAR_FULL_STEPS, MT=2 * ST_TILES, NT=2 * ST_TILES,
        A=StencilBuffers(big, 2 * ST_TILES, 2 * ST_TILES)))
    free_left, peak, A, ran, wall, setup, n_launch, stats = near_full(
        {("runtime", "fusion"): "auto", ("device", "cuda_wave_batch"): 0})
    label = f"native stencil {2 * ST_N}^2, {NEAR_FULL_MB} MB free, fusion auto"
    check(ran == n_launch == big_tasks, f"{label}: {ran} tasks, {n_launch} launches")
    check(stats["trampoline_entries"] == stats["completion_callbacks"] == 0,
          f"{label}: per-task interpreter entries in pump mode ({stats})")
    check((stats["fused_submits"], stats["fused_tasks"]) == big_plan[1:],
          f"{label}: fused submits and tasks {stats['fused_submits']}, "
          f"{stats['fused_tasks']}, expected {big_plan[1:]}")
    check(np.array_equal(A.to_array(NEAR_FULL_STEPS % 2), big_want),
          f"{label}: grid differs from the open card's")
    say("native", path="stencil", near_full_free_bytes=free_left, N=2 * ST_N,
        tile=ST_N // ST_TILES, T=NEAR_FULL_STEPS, fusion="auto", regions=big_plan[0],
        tasks=ran, launches=n_launch, wall_s=wall, capture_build_s=setup,
        mem_budget=stats["mem_budget"], run_peak_reserved_bytes=peak, equal_open_card=True,
        **pipeline_fields(stats))
    st_launch_total += n_launch
    del A, big, big_want
    del st_ref, zr, zc

    # -- graph phase: the stencil through GraphExecutor -------------------------
    A = StencilBuffers(grid, ST_TILES, ST_TILES)
    tp = stencil_ptg(use_kernels=True, use_cpu=False).taskpool(
        T=ST_T, MT=ST_TILES, NT=ST_TILES, A=A)
    t0 = time.perf_counter()
    ex = GraphExecutor(tp)
    plan_s = time.perf_counter() - t0
    feeds = {k: torch.from_numpy(A.data_of(*k[1]).newest_copy().payload).to(dev)
             for k in ex.input_keys}
    kernels.reset_counts()
    first, last, first_s, replay_s = run_graph(ex, feeds)
    want = n_tasks_st * (2 + GRAPH_REPLAYS)
    check(kernels.stencil_5pt.launches == want,
          f"graph stencil: {kernels.stencil_5pt.launches} stencil_5pt launches, expected {want}")
    st_launch_total += kernels.stencil_5pt.launches
    tile = ST_N // ST_TILES
    want_grid = torch.from_numpy(st_dyn).to(dev)
    for i in range(ST_TILES):
        for j in range(ST_TILES):
            key = ("A", (ST_T % 2, i, j))
            ref = want_grid[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
            check(torch.equal(first[key], ref) and torch.equal(last[key], ref),
                  f"graph stencil: tile ({i}, {j}) differs from the dynamic path's")
    del first, want_grid
    say("graph", path="stencil", N=ST_N, tile=tile, T=ST_T, plan_s=plan_s,
        gcells_per_s=ST_N * ST_N * ST_T / statistics.median(replay_s) / 1e9,
        dynamic_wall_s=st_wall,
        pump_median_depth1_s=statistics.median(depth_walls.walls["stencil pump"][1]),
        equal_dynamic=True, **graph_fields(ex, first_s, replay_s, n_tasks_st))
    graph_execs["stencil"] = (ex, feeds)
    # level-batched: each step's tiles of one halo pattern one B3 launch,
    # every tile equal to the replay's
    b_ex, _b_last, batched_launches["stencil"] = batched_graph(
        hb, "stencil", tp, feeds, last, statistics.median(replay_s),
        {"stencil": ("stencil_5pt", "step")}, n_tasks_st, exact=True)
    batched_execs["stencil"] = (b_ex, feeds)
    del A, tp, last, _b_last

    g_lead = torch.from_numpy(np.ascontiguousarray(grid[:FUSED_N, :FUSED_N])).to(dev)
    f_ref = g_lead.double()
    zr = torch.zeros((1, FUSED_N), dtype=torch.float64, device=dev)
    zc = torch.zeros((FUSED_N, 1), dtype=torch.float64, device=dev)
    for _ in range(FUSED_ITERS):
        f_ref = kernels.stencil_5pt_plain(f_ref, zr, zr, zc, zc)
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    f_out = kernels.stencil_5pt_fused(g_lead, FUSED_ITERS)
    torch.cuda.synchronize()
    f_wall = time.perf_counter() - t0
    fused_launches = dict(kernels.stencil_5pt_fused.launches_by_mode)
    check(fused_launches == {"smem": 1, "global": 0},
          f"stencil fused: launches by mode {fused_launches}, expected one smem launch")
    f_gate, f_err = allclose_gate(f_out, f_ref, TOL_STENCIL_PATH)
    check(f_gate <= TOL_STENCIL_PATH,
          f"stencil fused: |out - ref| - tol|ref| reaches {f_gate} > {TOL_STENCIL_PATH}")
    say("stencil_fused", N=FUSED_N, iters=FUSED_ITERS, launches=fused_launches["smem"],
        wall_s=f_wall, gcells_per_s=FUSED_N * FUSED_N * FUSED_ITERS / f_wall / 1e9,
        max_abs_err=f_err, gate=f_gate, tol=TOL_STENCIL_PATH)
    del g64, f_ref, f_out, g_lead
    torch.cuda.empty_cache()

    # -- transfer phase: the copy engine against pageable copies --------------
    # the stencil's 64 tiles of 4 MiB, twice (512 MiB each way), through the
    # device module's engine (pinned ring, copy streams; in batches of 32,
    # as the lane and the committer move them) and through pageable .to() /
    # .cpu(), in turns: pageable, engine, engine, pageable
    xfer_dev = NativeExecutor._make_device()
    tile = ST_N // ST_TILES
    host_tiles = [np.ascontiguousarray(grid[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile])
                  for i in range(ST_TILES) for j in range(ST_TILES)] * 2
    xfer_bytes = sum(t.nbytes for t in host_tiles)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    gbps = {"h2d_pageable": [], "h2d_engine": [], "d2h_pageable": [], "d2h_engine": []}
    for how in ("pageable", "engine", "engine", "pageable"):
        if how == "engine":
            d_tiles, secs = timed(lambda: [d for i in range(0, len(host_tiles), 32)
                                           for d in xfer_dev._h2d_batch(host_tiles[i:i + 32])])
            d2h = lambda: [h for i in range(0, len(d_tiles), 32)  # noqa: E731
                           for h in xfer_dev._d2h_batch(d_tiles[i:i + 32])]
        else:
            d_tiles, secs = timed(lambda: [torch.from_numpy(t).to(dev) for t in host_tiles])
            d2h = lambda: [t.cpu().numpy() for t in d_tiles]  # noqa: E731
        gbps[f"h2d_{how}"].append(xfer_bytes / secs / 1e9)
        hosts, secs = timed(d2h)
        gbps[f"d2h_{how}"].append(xfer_bytes / secs / 1e9)
        check(all(np.array_equal(h, t) for h, t in zip(hosts, host_tiles)),
              f"transfer [{how}]: the round trip changed a tile")
        del d_tiles, hosts
    say("transfer", tiles=len(host_tiles), tile_bytes=host_tiles[0].nbytes,
        bytes_each_way=xfer_bytes, gbps=gbps, pinned_peak_bytes=xfer_dev.pinned_bytes[1],
        h2d_copies=xfer_dev.stats["h2d_copies"], d2h_copies=xfer_dev.stats["d2h_copies"])
    del host_tiles, xfer_dev
    torch.cuda.empty_cache()

    profiled = None
    if "--profile" in sys.argv[1:]:
        # where the time goes: one extra run of each f32 dpotrf variant, the
        # f32 prefill and the stencil under torch.profiler.  Copies run on
        # their own streams and may overlap kernels, so device busy is the
        # UNION of every kernel's and copy's device interval (their sum is
        # printed beside it), and the copy time that overlaps kernel time is
        # union(copies) + union(kernels) - union(all).  `run` returns the
        # seconds its busy time is counted against — the timed window plus
        # the write-back home that follows it (ctx.fini() / close()), whose
        # copies the profiler sees too — and those seconds' parts, with
        # the bytes each direction moved
        from torch.profiler import ProfilerActivity, profile

        def union_us(spans):
            total, end = 0.0, None
            for s0, s1 in sorted(spans):
                if end is None or s0 > end:
                    total += s1 - s0
                    end = s1
                elif s1 > end:
                    total += s1 - end
                    end = s1
            return total

        def profiled(label, run):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                wall, parts = run()
            spans = {"h2d": [], "d2h": [], "kernel": []}
            rows = {}
            # device-to-device copies: wave chunks' and graph calls' copies
            # in and out (Memcpy DtoD, or _foreach_copy_'s multi-tensor
            # kernel), counted in the kernel spans too
            d2d = []
            for ev in prof.events():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                what = ("h2d" if ev.name.startswith("Memcpy HtoD") else
                        "d2h" if ev.name.startswith("Memcpy DtoH") else "kernel")
                spans[what].append((ev.time_range.start, ev.time_range.end))
                if ev.name.startswith("Memcpy DtoD") or "multi_tensor_apply" in ev.name:
                    d2d.append(ev.time_range.end - ev.time_range.start)
                row = rows.setdefault(ev.name, [0.0, 0])
                row[0] += ev.time_range.end - ev.time_range.start
                row[1] += 1
            copies = spans["h2d"] + spans["d2h"]
            busy_us = union_us(copies + spans["kernel"])
            copy_us, kernel_us = union_us(copies), union_us(spans["kernel"])
            overlap_us = copy_us + kernel_us - busy_us
            h2d_ms = sum(e - b for b, e in spans["h2d"]) / 1e3
            d2h_ms = sum(e - b for b, e in spans["d2h"]) / 1e3
            top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:8]
            say("profile", variant=label, window_s=wall, device_busy_ms=busy_us / 1e3,
                busy_sum_ms=sum(e - b for v in spans.values() for b, e in v) / 1e3,
                device_idle_share=1.0 - busy_us / 1e6 / wall,
                h2d_ms=h2d_ms, h2d_count=len(spans["h2d"]),
                d2h_ms=d2h_ms, d2h_count=len(spans["d2h"]),
                h2d_gbps=parts.get("bytes_in", 0) / h2d_ms / 1e6 if h2d_ms else None,
                d2h_gbps=parts.get("bytes_out", 0) / d2h_ms / 1e6 if d2h_ms else None,
                kernel_ms=kernel_us / 1e3, copy_kernel_overlap_ms=overlap_us / 1e3,
                d2d_ms=sum(d2d) / 1e3, d2d_count=len(d2d),
                copy_overlap_share=overlap_us / copy_us if copy_us else None,
                parts=parts, top=[{"kernel": k[:90], "count": c, "ms": us / 1e3}
                                  for k, (us, c) in top])

        def with_flush(wall, stats):
            return wall + stats["flush_s"], dict(
                wall_s=wall, flush_s=stats["flush_s"], bytes_in=stats["bytes_in"],
                bytes_out=stats["bytes_out"])

        def native_window(r):
            stats = r[-1]
            setup, wall = r[3], r[2]
            return setup + wall + stats["flush_s"], dict(
                capture_build_s=setup, wall_s=wall, flush_s=stats["flush_s"],
                bytes_in=stats["bytes_in"], bytes_out=stats["bytes_out"])

        for name, kw, _tol in variants[:2]:
            profiled(name, lambda: with_flush(*run_dpotrf(kw)[1::2]))
        name, arrays, dt, kw, _tol = attn_runs[0]
        profiled(name, lambda: with_flush(*run_attention(
            *(torch.from_numpy(a).to(dt) for a in arrays), **kw)[1::2]))
        # the stencil's staging, through Context and the pump, at each depth
        for depth in (1, 2):
            with mca(mca_param, "runtime", "stage_depth", depth):
                profiled(f"stencil_depth{depth}",
                         lambda: with_flush(*run_stencil()[1::2]))
                profiled(f"stencil_native_depth{depth}",
                         lambda: native_window(run_stencil_native()))
        # set-up + run + close(): the same span as the dynamic run's window
        # (startup enumeration inside it) plus its fini(); at each depth
        for depth in (1, 2):
            with mca(mca_param, "runtime", "stage_depth", depth):
                profiled(f"kernels_native_depth{depth}",
                         lambda: native_window(run_dpotrf_native(variants[0][1])))

        def prefill_native():
            _out, wall, _n, stats = run_attention_native()
            return wall, dict(bytes_in=stats["bytes_in"], bytes_out=stats["bytes_out"])

        # the whole entry-point call: close() and assemble() are inside it
        profiled("attn_prefill_f32_native", prefill_native)

        # waves on and off (their device-to-device copies: d2d_ms), through
        # the pump and the dynamic path, at stage depth 1
        for wave in (2, 0):
            with mca(mca_param, "device", "cuda_wave_batch", wave):
                profiled(f"kernels_native_waves{wave}",
                         lambda: native_window(run_dpotrf_native(variants[0][1])))
                profiled(f"kernels_waves{wave}",
                         lambda: with_flush(*run_dpotrf(variants[0][1])[1::2]))
                profiled(f"stencil_native_waves{wave}", lambda: native_window(run_stencil_native()))

        # the fused dpotrf and stencil pumps (runtime_fusion=auto), beside
        # the unfused depth-1 and waves-off rows above
        with mca(mca_param, "runtime", "fusion", "auto"):
            profiled("kernels_native_fusion",
                     lambda: native_window(run_dpotrf_native(variants[0][1])))
            profiled("stencil_native_fusion", lambda: native_window(run_stencil_native()))

        def graph_replay(ex, feeds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ex.apply(feeds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return wall, dict(replay_s=wall)

        # one GraphExecutor replay a path, beside the pump rows above, and
        # one level-batched replay (its member stacks: the top list's
        # CatArrayBatchedCopy kernels)
        for label, (ex, feeds) in graph_execs.items():
            profiled(f"graph_{label}", lambda: graph_replay(ex, feeds))
        for label, (ex, feeds) in batched_execs.items():
            profiled(f"graph_batched_{label}", lambda: graph_replay(ex, feeds))

    # the dense factorizations, each path once more under the profiler
    # with --profile
    factor_launches = factorization_phases(types.SimpleNamespace(
        np=np, torch=torch, dev=dev, card=card, kind=kind, say=say, check=check,
        profiled=profiled, batched_launches=batched_launches, first_calls=first_calls))

    def entry(name, mode, n_launch, source="matmul.cu", line="70", key=None):
        row = results[key or (name, mode, TILE)]
        out = {"name": f"{name}[{mode}]", "route": "cuda", "shape": row["shape"],
               "source": f"parsec_tpu_torch/csrc/{source}",
               "replaces": f"parsec_tpu/ops/pallas_kernels.py:{line}",
               "launches": n_launch, "max_abs_err": row["max_abs_err"],
               "ms": row["ms"], "plain_ms": row["plain_ms"],
               "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
               "library_ms": row["library_ms"], "library_call": row["library_call"]}
        return out

    def mm_launches(name, mode):
        """launches of one B1/B2 mode over every run of the paths that call
        them: dpotrf (dynamic at both depths, the pump at both depths and
        under the 96 MB budget, waves, fusion, graph), the segmented LU
        (split_f32, B not transposed) and the tiled LU and QR (dynamic,
        pump, graph; B not transposed); split_f32 with B transposed and
        B1/B2 with bf16 operands and B not transposed run on no ported
        path"""
        return sum(counts[name][mode]
                   for counts in (*launches.values(), *factor_launches.values()))

    def caller_entry(name, mode, line="70"):
        return entry(name, mode, mm_launches(name, mode), line=line,
                     key=(name, mode, CALLER_SHAPES[(name, mode)]))

    table = [
        entry("matmul_update", "f32", mm_launches("matmul_update", "f32")),
        entry("matmul_update", "f32_nt", mm_launches("matmul_update", "f32_nt")),
        entry("matmul_update", "bf16", mm_launches("matmul_update", "bf16")),
        entry("matmul_update", "split", mm_launches("matmul_update", "split")),
        caller_entry("matmul_update", "split_nt"),
        entry("matmul", "f32", mm_launches("matmul", "f32"), line="158"),
        caller_entry("matmul", "f32_nt", line="158"),
        entry("matmul", "bf16", mm_launches("matmul", "bf16"), line="158"),
        entry("stencil_5pt", "f32", st_launch_total, "stencil.cu", "219",
              ("stencil_5pt", "f32")),
        entry("stencil_5pt_fused", "smem", fused_launches["smem"], "stencil.cu", "239",
              ("stencil_5pt_fused", "smem_f32")),
        entry("stencil_5pt_fused", "global", fused_launches["global"], "stencil.cu", "239",
              ("stencil_5pt_fused", "global_f64")),
    ] + [
        entry("flash_attention_block", mode, sum(n[mode] for n in attn_launches.values()),
              "attention.cu", "283", ("flash_attention_block", case))
        for mode, case in (("f32", "f32"), ("bf16", "bf16"), ("f32_wide", "f32_512x512_d512"),
                           ("bf16_wide", "bf16_512x512_d512"))
    ] + [
        # the f32 mode at the serve phase's decode shape (8 x 512 x 128):
        # the decode jobs' launches, a share of the f32 row's
        entry("flash_attention_block", "f32_decode", serve.serve_decode_launches,
              "attention.cu", "283", ("flash_attention_block", "f32_decode_8x512")),
        # latent attention's step and expansion at the MLA cell's block:
        # the launches of the kernel phase's pump job
        entry("flash_attention_block", "bf16_mla", mla_run["b5"]["bf16"], "attention.cu",
              "283", ("flash_attention_block", "bf16_mla_8192_full")),
        entry("matmul", "bf16_kv_up", mla_run["b2"]["bf16"], line="158",
              key=("matmul", "bf16", CALLER_SHAPES[("matmul", "bf16")])),
    ]

    def batched_entry(name, mode, key, source, line):
        """A batched mode's row: its launches over the level-batched
        replays, its times and bound at the largest group a path makes."""
        row = batched_results[(name, key)]
        n_launch = sum(c.get(name, {}).get(mode, 0) for c in batched_launches.values())
        check(n_launch > 0, f"{name}[{mode}]: no launch on the level-batched replays")
        return {"name": f"{name}[{mode}]", "route": "cuda",
                "shape": [row["members"], *row["shape"]],
                "source": f"parsec_tpu_torch/csrc/{source}",
                "replaces": f"parsec_tpu/ops/pallas_kernels.py:{line}",
                "launches": n_launch, "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "library_call": row["library_call"],
                "members": row["members"], "one_by_one_ms": row["one_by_one_ms"]}

    # the batched modes the level-batched replays and the SPMD ring launch
    # (split_b and B5's wide batch run on no batched path: printed above
    # only); B5's modes at the ring's 1024-row block, a share of the
    # launches of the rows above, from the parallel phase
    table += par["rows"]
    table += [
        batched_entry("matmul_update", "f32_b", "f32_b_105", "matmul.cu", "70"),
        batched_entry("matmul_update", "bf16_b", "bf16_b_105", "matmul.cu", "70"),
        batched_entry("matmul_update", "f32_nt_b", "f32_nt_b_225", "matmul.cu", "70"),
        batched_entry("matmul", "f32_b", "f32_b_15", "matmul.cu", "158"),
        batched_entry("matmul", "f32_nt_b", "f32_nt_b_65", "matmul.cu", "158"),
        batched_entry("stencil_5pt", "step_b", "step_b_interior_36", "stencil.cu", "219"),
        batched_entry("flash_attention_block", "f32_b", "f32_b_256", "attention.cu", "283"),
        batched_entry("flash_attention_block", "bf16_b", "bf16_b_256", "attention.cu", "283"),
    ]
    depth_walls.report()
    wave_walls.report()
    fusion_walls.report()
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(tcp_rank_main() if "--tcp-rank" in sys.argv[1:] else main())
