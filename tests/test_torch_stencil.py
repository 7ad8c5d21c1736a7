"""The port's 5-point stencil (parsec_tpu_torch.ops.stencil and the B3/B4
kernel wrappers) against the JAX package's.

The wrappers run their plain PyTorch versions here (a CUDA kernel cannot
run on the CPU) against ``pallas_kernels.stencil_5pt`` and
``stencil_5pt_fused`` in interpret mode.  The stencil PTG's host chores do
the same numpy arithmetic in the same order as the JAX package's, so their
grids must be bit-identical; its kernel chores run on the port's CUDA
device module bound to the torch CPU device.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import parsec_tpu  # noqa: E402
import parsec_tpu_torch  # noqa: E402
from parsec_tpu.ops import pallas_kernels as pk  # noqa: E402
from parsec_tpu.ops import stencil as ref_stencil  # noqa: E402
from parsec_tpu.ops import tiles as ref_tiles  # noqa: E402
from parsec_tpu_torch.ops import kernels, stencil, tiles  # noqa: E402


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _halo_case(seed, h, w, dtype):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(dtype)  # noqa: E731
    # the halo columns are the facing edge columns of wider neighbour
    # tiles, as the stencil chore passes them
    return mk(h, w), mk(1, w), mk(1, w), mk(h, 5), mk(h, 3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(16, 128), (37, 20)])
def test_stencil_5pt_matches_pallas(dtype, shape):
    old, up, down, lt, rt = _halo_case(3, *shape, dtype)
    left, right = _t(lt)[:, -1:], _t(rt)[:, :1]   # strided views
    assert not left.is_contiguous() and left.stride(0) == 5
    out = kernels.stencil_5pt(_t(old), _t(up), _t(down), left, right)
    assert out.dtype == _t(old).dtype
    ref = np.asarray(pk.stencil_5pt(*map(jnp.asarray, (old, up, down, lt[:, -1:],
                                                        rt[:, :1]))))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    # and the stencil module's zero-padded formula
    pad = np.zeros((shape[0] + 2, shape[1] + 2), dtype)
    pad[1:-1, 1:-1], pad[0, 1:-1], pad[-1, 1:-1] = old, up[0], down[0]
    pad[1:-1, 0], pad[1:-1, -1] = lt[:, -1], rt[:, 0]
    formula = 0.25 * (pad[:-2, 1:-1] + pad[2:, 1:-1] + pad[1:-1, :-2] + pad[1:-1, 2:])
    np.testing.assert_array_equal(out.numpy(), formula)


@pytest.mark.parametrize("dtype,iters", [(np.float32, 5), (np.float64, 7),
                                         (np.float32, 1)])
def test_stencil_5pt_fused_matches_pallas(dtype, iters):
    g = np.random.default_rng(4).standard_normal((32, 128)).astype(dtype)
    out = kernels.stencil_5pt_fused(_t(g), iters)
    ref = np.asarray(pk.stencil_5pt_fused(jnp.asarray(g), iters))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), stencil.reference_stencil(g, iters),
                               rtol=1e-5, atol=1e-5)


_NARROW = [("float16", torch.float16, jnp.float16),
           ("bfloat16", torch.bfloat16, jnp.bfloat16)]


def _narrow(x, tdt):
    """A numpy float32 array rounded to ``tdt`` (a torch dtype)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(tdt)


@pytest.mark.parametrize("name,tdt,jdt", _NARROW)
@pytest.mark.parametrize("shape", [(16, 128), (37, 20)])
def test_stencil_5pt_narrow_bit_identical_to_pallas(name, tdt, jdt, shape):
    """float16 and bfloat16 grids: the kernel computes in the grid's dtype,
    every partial sum of ((u + d) + l) + r rounded to it, as the Pallas
    kernel does in interpret mode -- bit for bit, in both types."""
    old, up, down, lt, rt = _halo_case(7, *shape, np.float32)
    t_old, t_up, t_down, t_lt, t_rt = (_narrow(x, tdt) for x in (old, up, down, lt, rt))
    out = kernels.stencil_5pt(t_old, t_up, t_down, t_lt[:, -1:], t_rt[:, :1])
    assert out.dtype == tdt
    ref = pk.stencil_5pt(*(jnp.asarray(x.float().numpy(), dtype=jdt)
                           for x in (t_old, t_up, t_down, t_lt[:, -1:], t_rt[:, :1])),
                         interpret=True)
    assert ref.dtype == jdt
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("name,tdt,jdt", _NARROW)
@pytest.mark.parametrize("iters", [1, 6])
def test_stencil_5pt_fused_narrow_bit_identical_to_pallas(name, tdt, jdt, iters):
    g = _narrow(np.random.default_rng(9).standard_normal((32, 128)).astype(np.float32), tdt)
    out = kernels.stencil_5pt_fused(g, iters)
    assert out.dtype == tdt
    ref = pk.stencil_5pt_fused(jnp.asarray(g.float().numpy(), dtype=jdt), iters,
                               interpret=True)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("h,w,itemsize,mode,rows,blocks", [
    (2048, 2048, 4, "smem", 16, 128),    # the path's fused grid: 18 x 8 KiB rows
    (512, 512, 4, "smem", 4, 128),
    (1024, 1024, 8, "smem", 8, 128),
    (1024, 1024, 2, "smem", 8, 128),
    (2048, 2048, 8, "global", 0, 0),     # 32 MiB: wider than 512 threads x 2 columns
    (2112, 2048, 4, "smem", 16, 132),    # every SM holds 16 rows
    (2113, 2048, 4, "smem", 17, 125),
    (2112, 1024, 8, "smem", 16, 132),    # f64: 18 x 8 KiB rows
    (3036, 2048, 4, "smem", 23, 132),    # (25 x 2048 + 4 x 64 x 23) x 4 B = 228,352
    (3037, 2048, 4, "global", 0, 0),     # 24 rows a block: over 227 KB
    (2048, 2049, 4, "global", 0, 0),     # wider than 512 threads x 4 columns
    (2048, 1800, 8, "global", 0, 0),     # f64: 18 x 1800 x 8 B over 227 KB
    (5, 7, 2, "smem", 1, 5),
    (1, 1, 4, "smem", 1, 1),
])
def test_fused_mode(h, w, itemsize, mode, rows, blocks):
    """B4 keeps the grid in shared memory on one block per SM where the
    strips plus their halo rows and edge columns fit the opt-in shared
    memory (H100: 132 SMs, 232,448 bytes) and its threads' column slots."""
    cfg = kernels._fused_mode(h, w, itemsize, 132, 232448)
    assert cfg == (mode, rows, blocks)
    assert cfg.mode in kernels.stencil_5pt_fused.launches_by_mode
    if mode == "smem":
        assert ((rows + 2) * w + 4 * -(-w // 32) * rows) * itemsize <= 232448
        assert blocks <= 132
        assert (blocks - 1) * rows < h <= blocks * rows


def _emulate_fused_smem(grid, iters, vec, rows, rng):
    """B4's smem step (``csrc/stencil.cu``) in numpy, float32: each warp
    slot (a span of 32 * vec columns) first computes its strip's top and
    bottom rows for the exchange, then walks its columns down the strip,
    writing each new row in place at once; the warp-edge lanes read the
    neighbouring spans' edge columns from the copy kept a step behind.
    The spans of a block run interleaved a row at a time in random order,
    so a read of a value already overwritten shows as a wrong result."""
    h, w = grid.shape
    nb, spans, sw = -(-h // rows), -(-w // (32 * vec)), 32 * vec
    f = np.float32
    bufs, sides, ns = [], [], []
    for b in range(nb):
        n = min(rows, h - b * rows)
        buf = np.zeros((n + 2, w), f)
        lo, hi = max(b * rows - 1, 0), min(b * rows + n + 1, h)
        buf[lo - (b * rows - 1):hi - (b * rows - 1)] = grid[lo:hi]
        side = np.full((2, spans, 2, rows), np.nan, f)
        for s in range(spans):
            side[0, s, 0, :n] = buf[1:n + 1, s * sw]
            if (s + 1) * sw <= w:
                side[0, s, 1, :n] = buf[1:n + 1, (s + 1) * sw - 1]
        bufs.append(buf), sides.append(side), ns.append(n)
    out = np.full_like(grid, np.nan)
    for t in range(iters):
        last, p, edges = t == iters - 1, t & 1, {}
        for b in range(nb):
            buf, side, n = bufs[b], sides[b], ns[b]

            def walk(s):
                lo, hi = s * sw, min((s + 1) * sw, w)
                full = hi - lo == sw

                def new_row(i, up, cur, dn):
                    lf = np.concatenate([[side[p, s - 1, 1, i] if s else 0], cur[:-1]]).astype(f)
                    rt = np.concatenate([cur[1:], [side[p, s + 1, 0, i]
                                                   if full and s + 1 < spans else 0]]).astype(f)
                    return (((up + dn) + lf) + rt) * f(0.25)
                if not last:
                    for j, i in enumerate((0, n - 1)):
                        edges[b, j, s] = new_row(i, *(buf[i + d, lo:hi].copy() for d in range(3)))
                    yield
                x = [buf[d, lo:hi].copy() for d in range(3)]
                for i in range(n):
                    o = new_row(i, *x)
                    x = x[1:] + [buf[min(i + 3, n + 1), lo:hi].copy()]
                    yield
                    if last:
                        out[b * rows + i, lo:hi] = o
                        continue
                    buf[i + 1, lo:hi] = o
                    side[p ^ 1, s, 0, i] = o[0]
                    if full:
                        side[p ^ 1, s, 1, i] = o[-1]
            live = [walk(s) for s in range(spans)]
            while live:
                g = live[rng.integers(len(live))]
                if next(g, StopIteration) is StopIteration:
                    live.remove(g)
        if not last:
            for b in range(nb):
                if b > 0:
                    bufs[b][0] = np.concatenate([edges[b - 1, 1, s] for s in range(spans)])
                if b < nb - 1:
                    bufs[b][ns[b] + 1] = np.concatenate([edges[b + 1, 0, s] for s in range(spans)])
    return out


@pytest.mark.parametrize("h,w,vec,rows", [
    (40, 256, 4, 5),     # 16-byte f32 groups: two full spans
    (37, 130, 1, 4),     # scalar: a partial last span, a ragged last strip
    (20, 96, 4, 20),     # one block: both halos zero throughout
    (9, 33, 1, 1),       # one row a block: its top row is its bottom row
])
def test_fused_smem_walk_emulated_in_any_warp_order_equals_plain(h, w, vec, rows):
    """B4's smem step is race-free in its own order of reads and writes:
    whatever the order the warps run in, the result is the plain
    version's bit for bit."""
    g = np.random.default_rng(h * w).standard_normal((h, w)).astype(np.float32)
    ref = kernels.stencil_5pt_fused_plain(torch.from_numpy(g), 3).numpy()
    for seed in range(3):
        out = _emulate_fused_smem(g, 3, vec, rows, np.random.default_rng(seed))
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("w,itemsize,ptrs,vec", [
    (1024, 4, (0, 4096, 8192, 256), True), (1024, 2, (16, 32, 48, 64), True),
    (130, 4, (0, 0, 0, 0), False),  # a 520-byte pitch
    (1024, 4, (0, 4, 0, 0), False), (8, 2, (0, 0, 0, 0), True), (6, 8, (0,) * 4, True),
    (37, 8, (0,) * 4, False),
])
def test_stencil_vec(w, itemsize, ptrs, vec):
    """B3 takes 16-byte column groups only where the row pitch and the
    bases of old, up, down and the output are 16-byte multiples."""
    assert kernels._stencil_vec(w, itemsize, *ptrs) is vec


def test_stencil_5pt_fused_zero_iters_is_a_copy():
    g = _t(np.random.default_rng(5).standard_normal((8, 8)).astype(np.float32))
    out = kernels.stencil_5pt_fused(g, 0)
    assert torch.equal(out, g) and out.data_ptr() != g.data_ptr()


def _ok_halos(h=4, w=6, dtype=torch.float32):
    return [torch.zeros(s, dtype=dtype) for s in ((h, w), (1, w), (1, w), (h, 1), (h, 1))]


@pytest.mark.parametrize("bad", [
    "old_complex", "old_int", "mixed_dtype", "up_shape", "left_shape", "old_noncontig",
    "up_noncontig", "not_2d", "empty", "halo_not_tensor", "meta_device",
])
def test_stencil_5pt_rejects_bad_input(bad):
    args = _ok_halos()
    err = ValueError
    if bad == "old_complex":
        args, err = [a.to(torch.complex64) for a in args], TypeError
    elif bad == "old_int":
        args, err = [a.int() for a in args], TypeError
    elif bad == "mixed_dtype":
        args[3], err = args[3].double(), TypeError
    elif bad == "up_shape":
        args[1] = torch.zeros(1, 5)
    elif bad == "left_shape":
        args[3] = torch.zeros(3, 1)
    elif bad == "old_noncontig":
        args[0] = torch.zeros(6, 4).mT
    elif bad == "up_noncontig":
        args[1] = torch.zeros(6, 2)[:, :1].mT
    elif bad == "not_2d":
        args[0] = torch.zeros(4, 6, 1)
    elif bad == "empty":
        args = [torch.zeros(s) for s in ((0, 6), (1, 6), (1, 6), (0, 1), (0, 1))]
    elif bad == "halo_not_tensor":
        args[2], err = np.zeros((1, 6), np.float32), TypeError
    elif bad == "meta_device":
        args = [a.to("meta") for a in args]
    with pytest.raises(err):
        kernels.stencil_5pt(*args)


@pytest.mark.parametrize("bad", ["negative_iters", "fractional_iters", "int", "1d",
                                 "noncontig"])
def test_stencil_5pt_fused_rejects_bad_input(bad):
    g, iters, err = torch.zeros(4, 6), 2, ValueError
    if bad == "negative_iters":
        iters = -1
    elif bad == "fractional_iters":
        iters = 1.5
    elif bad == "int":
        g, err = g.to(torch.int16), TypeError
    elif bad == "1d":
        g = torch.zeros(6)
    else:
        g = torch.zeros(6, 4).mT
    with pytest.raises(err):
        kernels.stencil_5pt_fused(g, iters)


def test_stencil_wrappers_count_calls_not_launches_on_cpu():
    kernels.reset_counts()
    kernels.stencil_5pt(*_ok_halos())
    kernels.stencil_5pt_fused(torch.zeros(4, 4), 3)
    kernels.stencil_5pt_fused(torch.zeros(4, 4), 0)
    assert (kernels.stencil_5pt.calls, kernels.stencil_5pt_fused.calls) == (1, 2)
    assert (kernels.stencil_5pt.launches, kernels.stencil_5pt_fused.launches) == (0, 0)
    assert not any(kernels.stencil_5pt_fused.launches_by_mode.values())
    kernels._count_mode(kernels.stencil_5pt_fused, "smem")
    assert kernels.stencil_5pt_fused.launches_by_mode == {"smem": 1, "global": 0}
    kernels.reset_counts()
    assert not any(kernels.stencil_5pt_fused.launches_by_mode.values())
    assert kernels.stencil_5pt_fused.calls == 0


# -- the stencil PTG --------------------------------------------------------

def _run_ref(grid, mt, nt, iters, **kw):
    A = ref_stencil.StencilBuffers(grid, mt, nt)
    tp = ref_stencil.stencil_ptg(**kw).taskpool(T=iters, MT=mt, NT=nt, A=A)
    # host chores on a host-only context; the Pallas chore on the JAX
    # package's own device module (JAX's CPU backend, interpret mode)
    devices = None if kw.get("use_pallas") else ["cpu"]
    with parsec_tpu.Context(nb_cores=3, devices=devices) as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60)
    return A.to_array(iters % 2)


def _run_port(grid, mt, nt, iters, ctx_kw, **kw):
    A = stencil.StencilBuffers(grid, mt, nt)
    tp = stencil.stencil_ptg(**kw).taskpool(T=iters, MT=mt, NT=nt, A=A)
    with parsec_tpu_torch.Context(nb_cores=3, **ctx_kw) as ctx:
        ctx.add_taskpool(tp)
        assert tp.wait(timeout=60), tp.fail_reason
        executed = sum(d.stats["executed_tasks"] for d in ctx.devices)
        on_cuda = [d.stats["executed_tasks"] for d in ctx.devices if d.mca_name == "cuda"]
        out = A.to_array(iters % 2)
    assert executed == iters * mt * nt
    return out, on_cuda


def test_default_stencil_adds_a_card_chore_unlike_the_reference():
    """ROADMAP C.11, a deliberate divergence: ``stencil_ptg()`` defaults to
    ``use_cuda=True``, as the port's other builders put a card chore in by
    default; the reference's ``use_tpu=False`` gives host chores only."""
    grid = np.zeros((8, 8))

    def chores(mod):
        tp = mod.stencil_ptg().taskpool(T=1, MT=2, NT=2, A=mod.StencilBuffers(grid, 2, 2))
        return [[ch.device_type for ch in tc.chores] for tc in tp.task_classes.values()]

    assert chores(stencil) == [["cpu", "cuda"]]
    assert chores(ref_stencil) == [["cpu"]]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("iters,mt,nt", [(1, 4, 3), (2, 4, 3), (5, 4, 3), (3, 1, 1)])
def test_host_stencil_bit_identical_to_reference(dtype, iters, mt, nt):
    grid = np.random.default_rng(0).standard_normal((32, 48)).astype(dtype)
    mine, _ = _run_port(grid, mt, nt, iters, dict(devices=["cpu"]),
                        use_cuda=False, use_cpu=True)
    theirs = _run_ref(grid, mt, nt, iters, use_tpu=False, use_cpu=True)
    assert mine.dtype == theirs.dtype == dtype
    np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(mine, stencil.reference_stencil(grid, iters))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("chore", ["kernels", "torch"])
def test_device_stencil_matches_reference(dtype, chore):
    """Every task on the CUDA module (bound to the torch CPU device): the B3
    wrapper's chore and the plain-torch chore match the host result and the
    JAX package's Pallas chore within 1e-6."""
    grid = np.random.default_rng(2).standard_normal((16, 24)).astype(dtype)
    kw = dict(use_kernels=True) if chore == "kernels" else dict(use_cuda=True)
    kernels.reset_counts()
    mine, on_cuda = _run_port(grid, 2, 2, 3, dict(cuda_device="cpu"),
                              use_cpu=False, **kw)
    assert on_cuda == [12]
    assert kernels.stencil_5pt.calls == (12 if chore == "kernels" else 0)
    host = stencil.reference_stencil(grid, 3)
    np.testing.assert_allclose(mine, host, rtol=1e-6, atol=1e-6)
    if dtype == np.float32:
        theirs = _run_ref(grid, 2, 2, 3, use_pallas=True, use_cpu=False)
        np.testing.assert_allclose(mine, theirs, rtol=1e-6, atol=1e-6)


def test_device_stencil_float16_bit_identical_to_reference():
    """A float16 grid, the reference's StencilBuffers dtype as the port's:
    the B3 chore on the CUDA module (bound to the torch CPU device) gives
    the JAX package's Pallas chore and its host chores bit for bit."""
    grid = np.random.default_rng(3).standard_normal((16, 24)).astype(np.float16)
    kernels.reset_counts()
    mine, on_cuda = _run_port(grid, 2, 2, 3, dict(cuda_device="cpu"), use_cpu=False,
                              use_kernels=True)
    assert on_cuda == [12] and kernels.stencil_5pt.calls == 12
    assert mine.dtype == np.float16
    theirs = _run_ref(grid, 2, 2, 3, use_pallas=True, use_cpu=False)
    assert theirs.dtype == np.float16
    np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(mine, _run_ref(grid, 2, 2, 3, use_tpu=False, use_cpu=True))
    np.testing.assert_array_equal(mine, stencil.reference_stencil(grid, 3))


def test_apply_5pt_torch_branch_equals_numpy_branch():
    rng = np.random.default_rng(6)
    tiles5 = [rng.standard_normal((6, 7)) for _ in range(5)]
    for drop in (None, 1, 2, 3, 4):
        np_args = [None if i == drop else a for i, a in enumerate(tiles5)]
        t_args = [None if a is None else _t(a) for a in np_args]
        np.testing.assert_array_equal(stencil._apply_5pt(torch, *t_args).numpy(),
                                      stencil._apply_5pt(np, *np_args))


def test_stencil_builders_reject_bad_input():
    with pytest.raises(ValueError, match="not divisible"):
        stencil.StencilBuffers(np.zeros((10, 12)), 3, 4)
    with pytest.raises(ValueError, match="no BODY"):
        stencil.stencil_ptg(use_cuda=False, use_kernels=False, use_cpu=False)


@pytest.mark.parametrize("args", [
    (10, 5, {}), (10, 3, dict(allow_ragged=True)), (10, 3, {}), (0, 4, {}),
    (8, -2, {}), (8, 2.5, {}), (7.0, 7, {}),
])
def test_check_tiling_matches_reference(args):
    n, nb, kw = args

    def outcome(fn):
        try:
            return fn(n, nb, what="rows", op="t", **kw)
        except ValueError as e:
            return f"ValueError: {e}"

    assert outcome(tiles.check_tiling) == outcome(ref_tiles.check_tiling)


# -- a distributed stencil: StencilBuffers placed by rank_of -----------------

def _stencil_ranks(pkg, comm, nranks, grid, T, MT, NT, ctx_kw, ptg_kw):
    """``tests/profiling/test_overlap.py``'s 2-rank stencil (row
    distribution: the UP/DOWN halos cross ranks every iteration) on one
    package's in-process fabric; returns the grid assembled from each
    rank's own tiles."""
    import threading

    ces = comm.InprocFabric(nranks).endpoints()
    ctxs = [pkg.Context(nb_cores=2, rank=r, nranks=nranks, comm=ces[r], **ctx_kw)
            for r in range(nranks)]
    mod = stencil if pkg is parsec_tpu_torch else ref_stencil
    bufs, oks = {}, [None] * nranks

    def worker(r):
        A = mod.StencilBuffers(grid, MT, NT, nodes=nranks, myrank=r,
                               rank_of=lambda i, j: i % nranks)
        bufs[r] = A
        tp = mod.stencil_ptg(use_cpu=True, **ptg_kw).taskpool(T=T, MT=MT, NT=NT, A=A)
        ctxs[r].add_taskpool(tp)
        oks[r] = tp.wait(timeout=120)

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(nranks)]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=150)
    finally:
        for c in ctxs:
            c.fini()
    assert all(oks), oks
    th, tw = grid.shape[0] // MT, grid.shape[1] // NT
    out = np.zeros_like(grid)
    for i in range(MT):
        for j in range(NT):
            A = bufs[i % nranks]
            assert A.rank_of(T % 2, i, j) == i % nranks == A.rank_of((T % 2, i, j))
            c = A.data_of(T % 2, i, j).newest_copy()
            out[i * th:(i + 1) * th, j * tw:(j + 1) * tw] = np.asarray(c.payload)
    return out


def test_two_rank_stencil_equals_the_reference():
    """A 2-rank stencil over ``StencilBuffers(..., rank_of=lambda i, j: i %
    2)`` on host chores is bit-identical to the JAX package's and to the
    dense oracle's arithmetic."""
    from parsec_tpu import comm as ref_comm
    from parsec_tpu_torch import comm

    T, MT, NT, tile = 6, 2, 2, 24
    grid = np.random.default_rng(5).standard_normal((MT * tile, NT * tile))
    ours = _stencil_ranks(parsec_tpu_torch, comm, 2, grid, T, MT, NT,
                          {"devices": ["cpu"]}, {"use_cuda": False})
    theirs = _stencil_ranks(parsec_tpu, ref_comm, 2, grid, T, MT, NT,
                            {"devices": ["cpu"]}, {"use_tpu": False})
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_allclose(ours, stencil.reference_stencil(grid, T), rtol=1e-12)
    A = stencil.StencilBuffers(grid, MT, NT)
    assert A.rank_of(0, 1, 1) == 0 and A.nodes == 1 and A.myrank == 0
