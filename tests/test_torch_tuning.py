"""The port's autotuner (parsec_tpu_torch.tuning) against the JAX package's.

* the mirrors of ``tests/class/test_autotune.py``: the fastest candidate
  wins and persists, a failing candidate is recorded and skipped, all
  failing raises, the divisor guard, ``auto_nb``'s passthrough and
  clipping, a corrupt entry reads as absent, the segmented drivers'
  ``nb="auto"`` takes the tuned winner, and ``tools autotune`` on a tiny
  dpotrf — on the torch CPU device (``device="cpu"``);
* parity, bit for bit (both packages do the same host arithmetic): the
  ``tune_key`` strings, ``resolve_nb``/``auto_nb`` over a grid of (nb, n,
  divides, stored best), and a document written by either package's
  ``TuningStore`` read back identically by the other's;
* the readers: attention's ``"auto"`` blocks (q keyed on Sq, kv on Sk),
  fusion's horizon (op ``fusion``, param ``max_tasks``), and the wave
  search restoring a caller's setting.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from parsec_tpu import tuning as ref_tuning  # noqa: E402
from parsec_tpu.dsl import fusion as ref_fusion  # noqa: E402
from parsec_tpu.ops import attention as ref_attention  # noqa: E402
from parsec_tpu_torch import Context, mca_param, tuning  # noqa: E402
from parsec_tpu_torch.dsl import fusion  # noqa: E402
from parsec_tpu_torch.ops import attention  # noqa: E402
from parsec_tpu_torch.ops.segmented_chol import SegmentedCholesky  # noqa: E402
from parsec_tpu_torch.ops.segmented_lu import SegmentedLU  # noqa: E402
from parsec_tpu_torch.ops.segmented_qr import SegmentedQR  # noqa: E402
from parsec_tpu_torch.profiling.tools import main as tools_main  # noqa: E402


@pytest.fixture
def store(tmp_path):
    return tuning.TuningStore(str(tmp_path / "autotune"))


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A fresh cache root for both packages: their default stores read
    ``<root>/autotune``."""
    monkeypatch.setenv("PARSEC_TPU_COMPILE_CACHE", str(tmp_path))
    return tmp_path


@pytest.fixture
def ctx():
    c = Context(nb_cores=2, cuda_device="cpu")
    yield c
    c.fini()


def test_device_kind_is_the_card_name_or_cpu():
    assert tuning._device_kind("cpu") == tuning._device_kind(torch.device("cpu")) == "cpu"
    if not torch.cuda.is_available():
        assert tuning._device_kind() == "cpu"
    else:
        assert tuning._device_kind() == torch.cuda.get_device_name()


# -- the mirrors of tests/class/test_autotune.py --------------------------------

def test_autotune_picks_fastest_and_persists(store):
    times = {16: 0.5, 32: 0.1, 64: 0.3}
    calls = []

    def runner(nb):
        calls.append(nb)
        return times[nb]

    doc = tuning.autotune("demo", 128, "float32", param="nb", candidates=[16, 32, 64],
                          runner=runner, reps=2, store=store)
    assert doc["best"] == 32
    # one warm-up + reps timed calls per candidate
    assert calls.count(16) == 3 and calls.count(32) == 3
    key = tuning.tune_key("demo", 128, "float32", tuning._device_kind(), "nb")
    assert store.load(key)["best"] == 32
    assert tuning.resolve_nb("demo", 128, "float32", store=store) == 32


def test_autotune_survives_failing_candidate(store):
    def runner(nb):
        if nb == 64:
            raise MemoryError("tile too big")
        return 1.0 / nb

    doc = tuning.autotune("demo", 128, "float32", param="nb", candidates=[16, 64],
                          runner=runner, reps=1, store=store)
    assert doc["best"] == 16
    assert "64" in doc["failures"] and "MemoryError" in doc["failures"]["64"]


def test_autotune_all_failed_raises(store):
    def runner(nb):
        raise RuntimeError("no")

    with pytest.raises(RuntimeError, match="every candidate failed"):
        tuning.autotune("demo", 64, "float32", param="nb", candidates=[16], runner=runner,
                        store=store)


def test_resolve_nb_divisor_guard(store):
    tuning.autotune("demo", 100, "float32", param="nb", candidates=[48],
                    runner=lambda nb: 0.1, reps=1, store=store)
    # 48 does not divide 100: the default stands
    assert tuning.resolve_nb("demo", 100, "float32", store=store, default=32, divides=100) == 32
    assert tuning.resolve_nb("demo", 100, "float32", store=store, default=32) == 48


def test_auto_nb_passthrough_and_default_clipping(root):
    assert tuning.auto_nb(256, "demo", 512) == 256
    assert tuning.auto_nb("auto", "never_tuned_op", 96, default=512, divides=96) == 32


def test_corrupt_tuning_entry_reads_as_absent(store):
    key = tuning.tune_key("demo", 64, "float32", "cpu", "nb")
    os.makedirs(store.dir, exist_ok=True)
    with open(os.path.join(store.dir, f"{key}.json"), "w") as f:
        f.write("{ not json")
    assert store.load(key) is None
    with open(os.path.join(store.dir, f"{key}.json"), "w") as f:
        json.dump({"no": "best"}, f)
    assert store.load(key) is None


def test_disabled_cache_keeps_winners_in_memory(monkeypatch):
    monkeypatch.setenv("PARSEC_TPU_COMPILE_CACHE", "0")
    st = tuning.default_store()
    assert st.dir == "<memory>"
    try:
        tuning.autotune("demo_mem", 64, "float32", candidates=[16], runner=lambda nb: 0.1,
                        reps=1)
        assert tuning.resolve_nb("demo_mem", 64, "float32") == 16
    finally:
        st.purge()


def test_segmented_drivers_nb_auto_use_tuned_winner(root, ctx):
    """The drivers' nb="auto" reads the winner for (op, N, dtype, this
    device); an explicit nb wins; an untuned size keeps the clipped
    default; a bf16-storage driver reads the bfloat16 key."""
    n = 128
    st = tuning.default_store()
    for op in ("dpotrf_seg", "getrf_seg", "geqrf_seg"):
        st.save(tuning.tune_key(op, n, "float32", "cpu", "nb"), {"best": 32, "param": "nb"})
    st.save(tuning.tune_key("dpotrf_seg", n, "bfloat16", "cpu", "nb"),
            {"best": 64, "param": "nb"})
    assert SegmentedCholesky(ctx, n).nb == 32
    assert SegmentedLU(ctx, n).nb == 32
    assert SegmentedQR(ctx, n).nb == 32
    assert SegmentedCholesky(ctx, n, bf16="storage").nb == 64
    assert SegmentedCholesky(ctx, n, nb=64).nb == 64
    assert 96 % SegmentedCholesky(ctx, 96).nb == 0


def test_segmented_autotune_then_auto_takes_the_winner(root):
    """A real search on the CPU device (the in-place runs on a device copy
    of the seeded matrix), then ``SegmentedCholesky(ctx, n)`` takes its
    winner and factors correctly."""
    n = 128
    doc = tuning.autotune_nb("dpotrf_seg", n, candidates=[32, 64], reps=1, device="cpu")
    assert not doc["failures"] and doc["device_kind"] == "cpu"
    assert set(doc["timings_s"]) == {"32", "64"}
    c = Context(nb_cores=2, cuda_device="cpu")
    try:
        sc = SegmentedCholesky(c, n)
        assert sc.nb == doc["best"]
        S = tuning._matrix(n, "float32", torch.device("cpu"), True).numpy()
        L = sc(S)
        assert np.abs(L @ L.T - S).max() / np.abs(S).max() < 1e-5
    finally:
        c.fini()


@pytest.mark.parametrize("argv", [
    ["--op", "dpotrf", "--n", "64", "--nb", "16,32"],
    ["--attention", "--n", "32", "--nb", "8,16"],
    ["--wave", "--n", "64", "--nb", "16"],
], ids=["dpotrf", "attention", "wave"])
def test_tools_autotune_cli_real_runs(root, capsys, argv):
    """End to end on the torch CPU device: the CLI times real (tiny)
    dynamic runs a candidate and persists winners "auto" resolves."""
    assert tools_main(["autotune", *argv, "--reps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAILED" not in out
    if "--attention" in argv:
        assert "best q_block=" in out and "best kv_block=" in out
        assert attention._resolve_block("auto", "q_block", 32, "float32") in (8, 16)
    elif "--wave" in argv:
        assert "best cuda_wave_batch=" in out
    else:
        assert "best nb=" in out
        assert tuning.resolve_nb("dpotrf", 64, "float32") in (16, 32)


# -- parity with the JAX package ---------------------------------------------------

@pytest.mark.parametrize("op,n,dtype,kind,param", [
    ("dpotrf", 8192, "float32", "cpu", "nb"),
    ("dpotrf_seg", 32768, np.float32, "NVIDIA H100 80GB HBM3", "nb"),
    ("getrf_seg", 16384, "bfloat16", "TPU v5 lite", "nb"),
    ("attention", 4096, np.dtype("float32"), "cpu", "q_block"),
    ("attention", 4000, np.float64, "cpu", "kv_block"),
    ("fusion", 0, "any", "cpu", "max_tasks"),
    ("a/b c", 1, "int8", "we:ird*kind", "wave"),
])
def test_tune_key_strings_match_reference(op, n, dtype, kind, param):
    assert tuning.tune_key(op, n, dtype, kind, param) == \
        ref_tuning.tune_key(op, n, dtype, kind, param)


def test_tune_key_takes_torch_dtypes_as_numpy_names():
    for t, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
                    (torch.float64, "float64")):
        assert tuning.tune_key("op", 8, t, "cpu") == ref_tuning.tune_key("op", 8, name, "cpu")


_BESTS = (None, 16, 48, 64, 512, 0, "x")


@pytest.mark.parametrize("best", _BESTS, ids=[repr(b) for b in _BESTS])
def test_resolve_and_auto_nb_match_reference(root, best):
    """The same stored winner (or none, or a bad one) gives the same
    answers in both packages over a grid of (nb, n, divides)."""
    ns = (64, 96, 100, 128, 1000)
    if best is not None:
        for n in ns:
            tuning.default_store().save(tuning.tune_key("grid", n, "float32", "cpu", "nb"),
                                        {"best": best, "param": "nb"})
    for n in ns:
        for divides in (None, n, 1024):
            for default in (None, 32, 512):
                assert tuning.resolve_nb("grid", n, "float32", default=default,
                                         divides=divides) == \
                    ref_tuning.resolve_nb("grid", n, "float32", default=default,
                                          divides=divides)
        for nb in ("auto", 16, 256):
            for divides in (None, n):
                assert tuning.auto_nb(nb, "grid", n, default=512, divides=divides) == \
                    ref_tuning.auto_nb(nb, "grid", n, default=512, divides=divides)


def test_stored_documents_cross_read(tmp_path):
    """A document written by either package's TuningStore reads back
    identically in the other's, and a search's document too."""
    mine = tuning.TuningStore(str(tmp_path / "autotune"))
    theirs = ref_tuning.TuningStore(str(tmp_path / "autotune"))
    doc = {"op": "demo", "n": 64, "best": 32, "timings_s": {"16": 0.25, "32": 0.125},
           "failures": {"64": "MemoryError: tile too big"}, "meta": {"d": 8}}
    mine.save("from_port", doc)
    theirs.save("from_reference", doc)
    assert theirs.load("from_port") == mine.load("from_port") == doc
    assert mine.load("from_reference") == theirs.load("from_reference") == doc
    searched = tuning.autotune("demo", 128, "float32", candidates=[16, 32],
                               runner=lambda nb: 1.0 / nb, reps=1, store=mine)
    key = tuning.tune_key("demo", 128, "float32", "cpu", "nb")
    assert theirs.load(key) == searched
    assert ref_tuning.resolve_nb("demo", 128, "float32", store=theirs) == 32
    assert [e["key"] for e in mine.entries()] == [e["key"] for e in theirs.entries()]
    assert mine.purge() == 3 and theirs.entries() == []


# -- the readers ------------------------------------------------------------------

def test_attention_auto_keys_q_on_sq_and_kv_on_sk(root):
    """Prefill and decode: "auto" reads q_block under Sq and kv_block
    under Sk (the reference's keys), each on q's dtype."""
    st = tuning.default_store()
    st.save(tuning.tune_key("attention", 8, "float32", "cpu", "q_block"), {"best": 4})
    st.save(tuning.tune_key("attention", 64, "float32", "cpu", "kv_block"), {"best": 16})
    st.save(tuning.tune_key("attention", 64, "float32", "cpu", "q_block"), {"best": 32})
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 64, 2, 8)).astype(np.float32) for _ in range(3))
    tp, _ = attention.build_flash_attention(q[:, -8:], k, v, causal=True)
    assert (tp.constants["QB"], tp.constants["KVB"]) == (4, 16)
    tp, _ = attention.build_flash_attention(q, k, v, causal=True)
    assert (tp.constants["QB"], tp.constants["KVB"]) == (32, 16)
    # another dtype reads other keys: the empty-store default
    tp, _ = attention.build_flash_attention(q.astype(np.float64), k, v, causal=True)
    assert (tp.constants["QB"], tp.constants["KVB"]) == (64, 64)
    for value, param, seq in (("auto", "q_block", 8), ("auto", "kv_block", 64),
                              ("auto", "q_block", 64), ("auto", "kv_block", 8)):
        assert attention._resolve_block(value, param, seq, np.float32) == \
            ref_attention._resolve_block(value, param, seq, np.float32)


def test_autotune_attention_persists_the_pair_then_auto_runs_it(root, ctx):
    """The kv sweep runs against the q winner; "auto" then takes both
    winners and runs bit-identical to the explicit blocks."""
    docs = tuning.autotune_attention(32, d=8, heads=2, candidates=[8, 16], reps=1,
                                     device="cpu")
    assert set(docs) == {"q_block", "kv_block"}
    for param, doc in docs.items():
        assert doc["param"] == param and not doc["failures"] and doc["n"] == 32
    qb, kvb = docs["q_block"]["best"], docs["kv_block"]["best"]
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 32, 2, 8)).astype(np.float32) for _ in range(3))
    auto = attention.run_flash_attention(ctx, q, k, v, causal=True)
    fixed = attention.run_flash_attention(ctx, q, k, v, causal=True, q_block=qb,
                                          kv_block=kvb)
    assert torch.equal(auto, fixed)
    with pytest.raises(ValueError, match="q_block/kv_block"):
        tuning.attention_runner(32, param="nb", device="cpu")


def test_fusion_horizon_reads_the_stored_max_tasks(root):
    """``runtime_fusion_max_tasks`` 0 reads op fusion, param max_tasks for
    the card, as the reference's; the MCA value wins over the store."""
    assert fusion.fusion_max_tasks() == fusion.DEFAULT_HORIZON == 16
    tuning.default_store().save(tuning.tune_key("fusion", 0, "any", "cpu", "max_tasks"),
                                {"best": 5, "param": "max_tasks"})
    assert fusion.fusion_max_tasks() == 5 == ref_fusion.fusion_max_tasks()
    assert fusion.fusion_max_tasks(device=torch.device("cpu")) == 5
    mca_param.set_param("runtime", "fusion_max_tasks", 3)
    try:
        assert fusion.fusion_max_tasks() == 3
    finally:
        mca_param.unset("runtime", "fusion_max_tasks")


@pytest.mark.parametrize("preset", [None, 4], ids=["unset", "api"])
def test_autotune_wave_restores_the_callers_setting(root, preset):
    if preset is not None:
        mca_param.set_param("device", "cuda_wave_batch", preset)
    try:
        doc = tuning.autotune_wave(n=64, nb=16, candidates=(0, 2), reps=1, device="cpu")
        assert doc["param"] == "wave" and doc["best"] in (0, 2) and not doc["failures"]
        assert doc["meta"] == {"nb": 16}
        if preset is None:
            assert mca_param.source("device", "cuda_wave_batch") != "api"
        else:
            assert mca_param.source("device", "cuda_wave_batch") == "api"
            assert mca_param.get("device", "cuda_wave_batch") == preset
    finally:
        mca_param.unset("device", "cuda_wave_batch")


def test_runners_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the runners take it")
    with pytest.raises(RuntimeError, match="is_available"):
        tuning.dpotrf_runner(64)
