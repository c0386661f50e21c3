"""kernels.autotune of the port: the tiling cache for Hopper.

The contract of tests/test_autotune.py, for the port:

* ``tune`` is deterministic given a fixed measurement table (ties go to
  the earlier candidate), and ``store=False`` publishes nothing;
* the candidates are legal on Hopper in the layout both methods share: a
  block of row_block rows in whole warps holds at most 512 threads and no
  shared memory, and row_block is no larger than the row bucket;
* a torn, damaged, foreign or stale table is a miss, never a crash;
* ``resolve`` never measures, and dispatch on CPU tensors never calls it;
* winners publish through ``ckpt.atomic_write_json``, which leaves either
  the old document or the new one.

Every test points the cache at its own ``tmp_path`` through
``REPRO_TORCH_AUTOTUNE_CACHE``. Nothing here measures: no card is needed.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import oga_step as toga
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path))
    autotune.reset_cache()
    autotune.reset_stats()
    yield
    autotune.reset_cache()
    autotune.reset_stats()


def _fake_measure(table):
    """Measurement from a fixed {(row_block, method, iters): us} table."""
    return lambda cfg: table[(cfg.row_block, cfg.method, cfg.iters)]


def _table(fn, methods=("sortscan",)):
    out = {}
    for rb in autotune.ROW_BLOCKS:
        for m in methods:
            for it in ((0,) if m == "sortscan" else autotune.BISECT_ITERS):
                out[(rb, m, it)] = float(fn(rb, m, it))
    return out


# ------------------------------------------------------------- determinism --
def test_tune_is_deterministic_given_fixed_measurements():
    table = _table(lambda rb, m, it: 100.0 - rb / 2)
    table[(8, "sortscan", 0)] = 1.0  # the planted winner
    win1, m1 = autotune.tune("oga_step", 256, 10, measure=_fake_measure(table))
    win2, m2 = autotune.tune("oga_step", 256, 10, measure=_fake_measure(table))
    assert win1 == win2 == autotune.KernelConfig(8, "sortscan", 0)
    assert m1 == m2 and list(m1) == [f"rb{rb}-sortscan" for rb in autotune.ROW_BLOCKS]
    assert autotune.resolve("oga_step", 256, 10) == win1


def test_tune_ties_go_to_the_earlier_candidate():
    table = _table(lambda rb, m, it: 7.0, methods=autotune.PROJ_METHODS)
    win, _ = autotune.tune("proj", 256, 10, methods=("bisect", "sortscan"),
                           measure=_fake_measure(table))
    assert win == autotune.KernelConfig(1, "bisect", autotune.BISECT_ITERS[0])


def test_tune_store_false_does_not_publish():
    table = _table(lambda rb, m, it: rb)
    autotune.tune("proj", 64, 10, measure=_fake_measure(table), store=False)
    assert autotune.lookup("proj", 64, 10) is None
    assert not os.path.exists(autotune.cache_path())


def test_default_config_is_the_untuned_layout():
    """An empty cache runs one block per row with the exact sortscan."""
    assert autotune.DEFAULT_CONFIG == autotune.KernelConfig(1, "sortscan", 20)
    assert autotune.resolve("oga_step", 768, 10) == autotune.DEFAULT_CONFIG
    assert autotune.DEFAULT_CONFIG.to_dict() == {"row_block": 1, "method": "sortscan",
                                                 "iters": 20}


# ---------------------------------------------------------- candidate space --
@pytest.mark.parametrize("n", [1, 5, 64, 768, 49152])
@pytest.mark.parametrize("L", [1, 10, 16, 17, 33, 100, 129, 512])
def test_candidates_are_legal_on_hopper(n, L):
    """Both methods' candidates launch in the one layout: rows in whole
    warps (lanes_per_row lanes a row), at most SORTSCAN_MAX_THREADS a block,
    no shared memory; a wide row one block of WIDE_THREADS."""
    nb, pb = autotune.shape_bucket(n, L)
    assert pb == autotune.slots_for(L)
    limit = autotune.SORTSCAN_MAX_THREADS
    for method in autotune.PROJ_METHODS:
        cands = autotune.candidates("oga_step", n, L, methods=(method,))
        assert cands and cands[0].row_block == 1
        for c in cands:
            threads = autotune.block_threads(c.row_block, L, method)
            assert threads % autotune.WARP == 0 and threads <= limit
            if L > autotune.WIDE_L:
                assert threads == autotune.WIDE_THREADS   # one block a row
            else:
                assert threads == -(-c.row_block // autotune.rows_per_warp(L)) * autotune.WARP
            assert c.row_block <= nb
            assert c.row_block & (c.row_block - 1) == 0
        # every legal power of two up to the bucket is offered
        legal = [rb for rb in autotune.ROW_BLOCKS
                 if rb <= nb and autotune.block_threads(rb, L, method) <= limit]
        assert sorted({c.row_block for c in cands}) == legal


def test_candidate_row_blocks_at_the_main_path_widths():
    rbs = lambda n, L, m="sortscan": sorted(
        {c.row_block for c in autotune.candidates("oga_step", n, L, methods=(m,))})
    assert rbs(768, 10) == [1, 2, 4, 8, 16, 32]     # 32 rows of 16 lanes: 16 warps
    assert rbs(49152, 10) == [1, 2, 4, 8, 16, 32]
    assert rbs(6144, 100) == [1, 2, 4, 8, 16]       # one warp a row, 512 threads
    assert rbs(3, 10) == [1, 2, 4]
    assert rbs(64, autotune.WIDE_L) == [1, 2, 4, 8, 16]
    assert rbs(64, autotune.MAX_L) == [1]            # one block a row
    assert rbs(768, 10, "bisect") == [1, 2, 4, 8, 16, 32]
    assert rbs(6144, 100, "bisect") == [1, 2, 4, 8, 16]    # sortscan's rule
    assert rbs(64, autotune.MAX_L, "bisect") == [1]


@pytest.mark.parametrize("row_block,L,method,legal", [
    (1, 10, "sortscan", True),      # half a warp, the other half idle
    (32, 10, "sortscan", True),     # 32 rows of 16 lanes: 512 threads
    (64, 10, "sortscan", False),    # not in ROW_BLOCKS
    (16, 100, "sortscan", True),    # 16 one-warp rows: 512 threads
    (32, 100, "sortscan", False),   # 1024 threads > SORTSCAN_MAX_THREADS
    (16, 256, "sortscan", True),
    (1, 512, "sortscan", True),     # a wide row: one block of 512 threads
    (2, 512, "sortscan", False),
    (3, 10, "sortscan", False),     # not a power of two
    (0, 10, "sortscan", False),
    (32, 10, "bisect", True),       # 32 rows of 16 lanes: 512 threads
    (4, 100, "bisect", True),       # 4 one-warp rows
    (8, 100, "bisect", True),       # 8 one-warp rows: 256 threads
    (32, 100, "bisect", False),     # 1024 threads > SORTSCAN_MAX_THREADS
    (1, 512, "bisect", True),
    (2, 512, "bisect", False),
], ids=lambda v: str(v))
def test_legal_row_block_per_method(row_block, L, method, legal):
    assert autotune.legal_row_block(row_block, L, method) is legal


def test_both_methods_take_one_launch_rule():
    """The bisection runs on the sortscan layout: at every width the kernels
    take, every row block is legal for both methods or for neither, and a
    row has the same threads."""
    for L in range(1, autotune.MAX_L + 1):
        assert autotune.row_threads(L, "bisect") == autotune.row_threads(L, "sortscan")
        for rb in autotune.ROW_BLOCKS:
            assert (autotune.legal_row_block(rb, L, "bisect")
                    == autotune.legal_row_block(rb, L, "sortscan")), (rb, L)


def test_candidates_bisect_enumerates_iters():
    cands = autotune.candidates("proj", 256, 10, methods=("bisect",))
    assert {c.iters for c in cands} == set(autotune.BISECT_ITERS)
    assert {c.method for c in cands} == {"bisect"}
    assert {c.method for c in autotune.candidates("proj", 256, 10)} == {"sortscan"}


def test_candidates_reject_unknown_kernels_methods_and_widths():
    with pytest.raises(ValueError):
        autotune.candidates("flash", 8, 8)
    with pytest.raises(ValueError):
        autotune.candidates("proj", 8, 8, methods=("newton",))
    with pytest.raises(ValueError):
        autotune.candidates("proj", 8, autotune.MAX_L + 1)


def test_shape_bucketing_shares_winners_between_neighbours():
    # 250 rows x 10 lanes and 256 rows x 16 lanes run the same block shape
    assert autotune.cache_key("proj", 250, 10) == autotune.cache_key("proj", 256, 16)
    assert autotune.cache_key("proj", 256, 16) != autotune.cache_key("proj", 256, 17)
    win, _ = autotune.tune("proj", 256, 10, measure=_fake_measure(_table(lambda rb, m, it: rb)))
    assert autotune.resolve("proj", 250, 16) == win
    assert autotune.cache_stats()["hits"] == 1


# -------------------------------------------------- corrupt / stale = miss --
def _write_cache(payload) -> str:
    path = autotune.cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        if isinstance(payload, str):
            f.write(payload)
        else:
            json.dump(payload, f)
    autotune.reset_cache()
    return path


def _entry(L=10, **kw):
    ent = {"row_block": 8, "method": "sortscan", "iters": 0, "us": 1.0}
    ent.update(kw)
    return {"version": autotune.TABLE_VERSION,
            "entries": {autotune.cache_key("proj", 256, L): ent}}


@pytest.mark.parametrize("payload", [
    "{ not json at all",                                     # garbage bytes
    "",                                                      # truncated empty
    lambda: json.dumps(_entry())[:37],                       # torn mid-write
    {"version": autotune.TABLE_VERSION + 1, "entries": {}},  # future schema
    {"entries": "not-a-dict", "version": autotune.TABLE_VERSION},
    [1, 2, 3],                                               # wrong top type
], ids=["garbage", "empty", "torn", "version", "schema", "toptype"])
def test_damaged_table_is_a_miss_not_a_crash(payload):
    _write_cache(payload() if callable(payload) else payload)
    assert autotune.lookup("proj", 256, 10) is None
    assert autotune.resolve("proj", 256, 10) == autotune.DEFAULT_CONFIG
    assert autotune.cache_stats()["misses"] == 1


@pytest.mark.parametrize("L,ent_kw", [
    (10, {"row_block": 24}),          # not a power of two
    (10, {"row_block": 64}),          # 64 rows x 32 threads > 1024
    (100, {"row_block": 32, "method": "bisect"}),  # 32 bisect rows x 32 lanes > 512
    (100, {"row_block": 32}),         # 32 sortscan rows x 32 threads > 512
    (10, {"row_block": "8"}),         # wrong type
    (10, {"row_block": True}),        # a bool is not a row count
    (10, {"row_block": None}),
    (10, {"method": "quickselect"}),  # unknown method
    (10, {"iters": -3}),              # out of range
    (10, {"iters": 999}),
], ids=["rb24", "rb64", "rb32-bisect", "rb32-wide", "str-rb", "bool-rb", "none-rb", "method",
        "neg-iters", "huge-iters"])
def test_malformed_or_illegal_entry_is_a_miss(L, ent_kw):
    _write_cache(_entry(L, **ent_kw))
    assert autotune.lookup("proj", 256, L) is None
    assert autotune.resolve("proj", 256, L) == autotune.DEFAULT_CONFIG


def test_legal_entry_is_a_hit():
    _write_cache(_entry(100, row_block=4))
    assert autotune.resolve("proj", 256, 100) == autotune.KernelConfig(4, "sortscan", 0)
    assert autotune.cache_stats() == {"hits": 1, "misses": 0, "measurements": 0}


def test_foreign_card_toolchain_or_source_is_a_clean_miss(monkeypatch):
    key = autotune.cache_key("proj", 256, 10)
    foreign = [key.replace(old, new) for old, new in [
        (f"|{autotune.device_tag()}|", "|NVIDIA A100-SXM4-80GB|sm80|"),
        (f"|torch{torch.__version__}|", "|torch1.0.0|"),
        (f"|cuda{torch.version.cuda}|", "|cuda11.0|"),
        (f"|src{autotune._source_tag()}", "|src0123456789abcdef"),
    ]]
    assert len(set(foreign + [key])) == 5
    _write_cache({"version": autotune.TABLE_VERSION,
                  "entries": {k: {"row_block": 8, "method": "sortscan", "iters": 0}
                              for k in foreign}})
    assert autotune.lookup("proj", 256, 10) is None
    _write_cache(_entry())
    assert autotune.lookup("proj", 256, 10) == autotune.KernelConfig(8, "sortscan", 0)
    # an edited kernel source or another card reads the same table as a miss
    monkeypatch.setattr(autotune, "_source_tag", lambda: "edited")
    assert autotune.lookup("proj", 256, 10) is None
    monkeypatch.undo()
    monkeypatch.setattr(autotune, "device_tag", lambda device=None: "other|sm90")
    assert autotune.lookup("proj", 256, 10) is None


def test_store_recovers_a_torn_table():
    _write_cache("{ torn")
    win, _ = autotune.tune("proj", 256, 10, measure=_fake_measure(_table(lambda rb, m, it: rb)))
    assert autotune.lookup("proj", 256, 10) == win


# ------------------------------------------------------------ atomic publish --
def test_store_publishes_atomically_no_temp_droppings():
    table = _table(lambda rb, m, it: 1.0 / rb)
    autotune.tune("proj", 256, 10, measure=_fake_measure(table))
    autotune.tune("oga_step", 64, 10, measure=_fake_measure(table))
    cache_dir = os.path.dirname(autotune.cache_path())
    assert sorted(os.listdir(cache_dir)) == ["autotune.json"]
    raw = json.load(open(autotune.cache_path()))
    assert raw["version"] == autotune.TABLE_VERSION
    assert len(raw["entries"]) == 2  # the second store kept the first entry
    ent = raw["entries"][autotune.cache_key("oga_step", 64, 10)]
    assert ent["row_block"] == 32 and ent["us"] == 1.0 / 32
    assert set(ent["measured"]) == {f"rb{rb}-sortscan" for rb in autotune.ROW_BLOCKS}


def test_atomic_write_json_leaves_the_old_or_the_new_document(tmp_path, monkeypatch):
    path = str(tmp_path / "sub" / "doc.json")
    ckpt.atomic_write_json(path, {"v": 1})
    assert json.load(open(path)) == {"v": 1}

    def crash(tmp, final, directory):
        raise OSError("crash before the rename")

    monkeypatch.setattr(ckpt, "_publish", crash)
    with pytest.raises(OSError):
        ckpt.atomic_write_json(path, {"v": 2, "pad": "x" * 4096})
    assert json.load(open(path)) == {"v": 1}  # the old document, whole
    monkeypatch.undo()
    ckpt.atomic_write_json(path, {"v": 3})
    assert json.load(open(path)) == {"v": 3}
    assert sorted(os.listdir(tmp_path / "sub")) == ["doc.json"]


# --------------------------------------------- resolve never measures (pin) --
def test_resolve_never_measures_even_on_miss():
    assert autotune.resolve("oga_step", 512, 24) == autotune.DEFAULT_CONFIG
    assert autotune.measurement_count() == 0
    assert autotune.cache_stats()["misses"] == 1


def test_warmed_resolution_zero_measurements_zero_misses():
    """Once tuned, every resolution of the shape comes off the table."""
    N, L = 768, 10
    autotune.tune("oga_step", N, L, measure=_fake_measure(_table(lambda rb, m, it: 1.0 / rb)))
    autotune.reset_stats()
    for _ in range(5):
        assert autotune.resolve("oga_step", N, L).row_block == 32
    assert autotune.cache_stats() == {"hits": 5, "misses": 0, "measurements": 0}


def _fake_cuda(n, L):
    """Something with the shape and device of a CUDA tensor, for the
    dispatch's tiling resolution (this host has no card)."""
    return types.SimpleNamespace(shape=(n, L), device=torch.device("cuda"))


def test_dispatch_forces_sortscan_even_if_cache_says_bisect(monkeypatch):
    """Cache state never changes values, only speed: a bisect entry gives
    the dispatch its row block, and the exact sortscan still runs."""
    N, L = 8, 16
    autotune._store("oga_step", N, L, autotune.KernelConfig(4, "bisect", 12), 1.0, {})
    autotune._store("proj", N, L, autotune.KernelConfig(2, "bisect", 28), 1.0, {})
    calls = []
    monkeypatch.setattr(toga, "oga_step_fused", lambda *a, **kw: calls.append(kw))
    y = _fake_cuda(N, L)
    ops._dispatch_fused(y, y, y, y, y, y)
    ops.oga_step_fused(y, y, y, y, y, y)
    pin = autotune.KernelConfig(2, "bisect", 28)
    ops.oga_step_fused(y, y, y, y, y, y, tiling=pin)
    assert calls == [
        {"method": "sortscan", "row_block": 4},
        {"method": "sortscan", "row_block": 4, "iters": None},
        {"method": "bisect", "row_block": 2, "iters": 28},
    ]
    # the projection's iteration count stays the default unless pinned
    cfg = ops._tiling("proj", y, None, iters=0)
    assert (cfg.row_block, cfg.method, cfg.iters) == (2, "bisect", 0)
    assert autotune.cache_stats()["misses"] == 0


@pytest.mark.parametrize("L,tuned,want", [(100, 8, 8), (100, 2, 2), (10, 32, 32),
                                           (autotune.WIDE_L, 16, 16)])
def test_dispatch_fits_a_sortscan_row_block_to_bisect(monkeypatch, L, tuned, want):
    """The "proj" table's winner is a sortscan row block, and the bisect
    layout is the sortscan's: dispatch runs the bisection at the tuned row
    block as it stands, and an explicit tiling as pinned."""
    N = 64
    autotune._store("proj", N, L, autotune.KernelConfig(tuned, "sortscan", 0), 1.0, {})
    calls = []
    monkeypatch.setattr(ops._pb, "proj_bisect", lambda *a, **kw: calls.append(kw))
    z = _fake_cuda(N, L)
    ops.proj_bisect(z, z, z, z)
    ops.proj_bisect(z, z, z, z, tiling=autotune.KernelConfig(1, "bisect", 28))
    assert calls == [{"row_block": want, "iters": None}, {"row_block": 1, "iters": 28}]
    assert autotune.legal_row_block(want, L, "bisect")
    assert all(autotune.legal_row_block(rb, L, "bisect") == autotune.legal_row_block(rb, L)
               for rb in autotune.ROW_BLOCKS)


def test_cpu_dispatch_never_resolves(monkeypatch):
    """On CPU tensors every dispatcher runs its plain version and never
    asks the cache, even when the table has an entry for the shape."""
    N, L = 14, 10
    autotune._store("oga_step", N, L, autotune.KernelConfig(2, "bisect", 12), 1.0, {})

    def fail(*a, **kw):
        raise AssertionError("resolve called on a CPU tensor")

    monkeypatch.setattr(autotune, "resolve", fail)
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.uniform(0, 2, (N, L)).astype(np.float32))
    a = torch.full((N, L), 1.5)
    ones = torch.ones((N, L))
    scal = torch.tensor([[1.2, 0.4, 5.0, 1.0, 0.5]] * N)
    want = tref.oga_step_ref(y, a, ones, ones, ones, scal)
    assert torch.equal(ops.oga_step_fused(y, a, ones, ones, ones, scal), want)
    c = torch.full((N,), 3.0)
    assert torch.equal(ops.proj_sortscan(y, a, ones, c), tref.proj_rows_sorted(y, a, ones, c))
    assert torch.equal(ops.proj_bisect(y, a, ones, c), tref.proj_rows_bisect(y, a, ones, c))
    assert autotune.cache_stats() == {"hits": 0, "misses": 0, "measurements": 0}


def test_measuring_needs_a_card():
    with pytest.raises(RuntimeError):
        autotune._measure_config("proj", autotune.DEFAULT_CONFIG,
                                 autotune._bench_operands("proj", 8, 10, torch.device("cpu")), 1)
    assert autotune.measurement_count() == 0


def test_bench_operands_are_seeded():
    one = autotune._bench_operands("oga_step", 16, 10, torch.device("cpu"))
    two = autotune._bench_operands("oga_step", 16, 10, torch.device("cpu"))
    assert len(one) == 6 and one[-1].shape == (16, toga.NUM_SCAL)
    assert all(torch.equal(p, q) for p, q in zip(one, two))
    assert [t.shape for t in autotune._bench_operands("proj", 16, 10, torch.device("cpu"))] == [
        (16, 10), (16, 10), (16, 10), (16,)]


# ------------------------------------------------------------- env override --
def test_cache_path_honours_env_override(tmp_path, monkeypatch):
    assert autotune.cache_path() == str(tmp_path / "autotune.json")
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    assert autotune.cache_path().endswith(
        os.path.join(".cache", "repro-torch-kernels", "autotune.json"))


def test_kernel_config_is_hashable():
    cfg = autotune.KernelConfig(32, "sortscan", 0)
    assert hash(cfg) == hash(autotune.KernelConfig(32, "sortscan", 0))
    assert cfg.to_dict() == {"row_block": 32, "method": "sortscan", "iters": 0}
    assert cfg.label == "rb32-sortscan"
    assert autotune.KernelConfig(2, "bisect", 12).label == "rb2-bisect-it12"
