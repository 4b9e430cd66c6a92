"""The tuning registry and the autotuner of the port (``repro_torch.kernels.
common.tuning``/``autotune``), held against ``repro``'s in one process:
the reference's registry and engine-tuning cases run on the port with
tiles its kernels launch, the keys every family asks for, the checked-in
H100 table, and the launch check the port adds to ``validate_table``."""

import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import SVMModel as JSVM  # noqa: E402
from repro.core import families as jfamilies  # noqa: E402
from repro.kernels.common import tuning as jtuning  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import families  # noqa: E402
from repro_torch.kernels.common import TileConfig, autotune, tuning  # noqa: E402
from repro_torch.kernels.quadform.kernel import BLOCK_N  # noqa: E402
from repro_torch.serve import SVMEngine  # noqa: E402
from repro_torch.serve.svm_engine import bucket_size  # noqa: E402

D, N_SV, K = 12, 80, 3
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _clean_tuning():
    tuning.clear_overrides()
    yield
    tuning.clear_overrides()


def _svms(k=K, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((N_SV, D)) * 0.3).astype(np.float32)
    ay = rng.standard_normal((k, N_SV) if k > 1 else (N_SV,)).astype(np.float32)
    b = rng.standard_normal(k).astype(np.float32) if k > 1 else np.float32(0.2)
    gamma = np.float32(0.5 / D)
    jm = JSVM(X=jnp.asarray(X), alpha_y=jnp.asarray(ay), b=jnp.asarray(b), gamma=jnp.asarray(gamma))
    return jm, convert.svm_from_numpy(X, ay, b, gamma, device="cpu")


# ---------------------------------------------------------- tuning registry


def test_bucket_policy_shared_with_engine():
    """Dispatch-level lookups key on the SAME buckets the engine pads to
    and the sweep records — a batch of 1000 resolves the 1024 entry."""
    assert tuning.bucket(1000) == 1024
    assert tuning.bucket(5) == 32
    assert tuning.bucket(9000) == 8192
    for n in (1, 32, 33, 100, 1000, 8192, 10_000):
        assert tuning.bucket(n) == bucket_size(n) == jtuning.bucket(n)
    tuned = TileConfig(block_n=64)
    tuning.record("quadform", tuning.shape_key(d=64, k=1, n=1024), tuned)
    key_for_1000 = tuning.shape_key(d=64, k=1, n=tuning.bucket(1000))
    assert key_for_1000 == jtuning.shape_key(d=64, k=1, n=jtuning.bucket(1000))
    assert tuning.lookup("quadform", key_for_1000) == tuned


def test_tuning_lookup_default_and_override():
    key = tuning.shape_key(d=64, k=10, n=1024)
    assert key == "d64_k10_n1024"
    assert tuning.lookup("quadform", key, platform_name="cpu") == tuning.DEFAULTS["quadform"]
    with pytest.raises(KeyError):
        tuning.lookup("quadform", key, strict=True, platform_name="cpu")
    tuned = TileConfig(block_n=64)
    tuning.record("quadform", key, tuned, measured_ms=1.0, default_ms=2.0)
    assert tuning.lookup("quadform", key) == tuned
    assert tuning.lookup("quadform", key, strict=True) == tuned
    # other buckets unaffected
    assert tuning.lookup("quadform", "d64_k10_n32", platform_name="cpu") == (
        tuning.DEFAULTS["quadform"]
    )
    with pytest.raises(KeyError):
        tuning.lookup("nonexistent_kernel")


def test_tuning_table_roundtrip(tmp_path):
    path = str(tmp_path / "table.json")
    tuned = TileConfig(block_n=64, splits=2)
    tuning.lookup("quadform", "warm_the_default_table_cache")
    tuning.record("rbf_pred", "d100_m512_n256", tuned, measured_ms=0.5, source="unit-test")
    tuning.save_table(path)
    with open(path) as f:
        saved = json.load(f)
    entry = saved["entries"][tuning.platform()]["rbf_pred"]["d100_m512_n256"]
    assert entry["config"]["block_n"] == 64
    assert entry["measured_ms"] == 0.5
    assert TileConfig.from_json(entry["config"]) == tuned
    # saving to a scratch path must not dump the checked-in default table
    # into it, nor leak the override into the cached default table
    assert set(saved["entries"]) == {tuning.platform()}
    assert set(saved["entries"][tuning.platform()]) == {"rbf_pred"}
    tuning.clear_overrides()
    assert tuning.lookup("rbf_pred", "d100_m512_n256") == tuning.DEFAULTS["rbf_pred"]


def test_load_table_validates_and_roundtrips(tmp_path):
    """save_table -> load_table round-trips clean entries; malformed keys,
    unknown kernels and bad configs are dropped with a warning instead of
    surfacing later deep in a launch."""
    path = str(tmp_path / "table.json")
    tuned = TileConfig(block_n=64)
    tuning.record("quadform", "d64_k1_n256", tuned, measured_ms=0.25, platform_name="cpu")
    tuning.save_table(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        table = tuning.load_table(path)  # clean: no warning
    entry = table["entries"]["cpu"]["quadform"]["d64_k1_n256"]
    assert TileConfig.from_json(entry["config"]) == tuned

    # corrupt the file with every malformation class
    table["entries"]["cpu"]["not_a_kernel"] = {"d64_n32": {"config": {"block_n": 32}}}
    table["entries"]["cpu"]["rbf_pred"] = {
        "TOTALLY wrong key!": {"config": {"block_n": 32}},  # bad key
        "d64_m512_n256": {"config": {"block_n": -5}},  # bad config value
        "d32_m512_n256": {"note": "no config at all"},  # missing config
        "d16_m512_n256": {"config": {"block_n": 128}},  # survivor
    }
    with open(path, "w") as f:
        json.dump(table, f)
    with pytest.warns(UserWarning) as warned:
        clean = tuning.load_table(path)
    assert len(warned) == 4
    assert "not_a_kernel" not in clean["entries"]["cpu"]
    assert set(clean["entries"]["cpu"]["rbf_pred"]) == {"d16_m512_n256"}
    # the pre-existing good entry survives validation untouched
    assert clean["entries"]["cpu"]["quadform"]["d64_k1_n256"] == entry


def test_load_table_rejects_malformed_top_level(tmp_path):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump({"entries": ["this", "is", "not", "a", "dict"]}, f)
    with pytest.warns(UserWarning, match="top-level structure"):
        assert tuning.load_table(path) == {"version": 1, "entries": {}}
    with open(path, "w") as f:
        f.write("{ not json")
    assert tuning.load_table(path) == {"version": 1, "entries": {}}


def test_autotune_picks_fastest_and_records():
    key = "unit_test_key"
    seen = []

    def build(cfg):
        def run():
            seen.append(cfg)
            return torch.zeros(())

        return run

    winner, rows = autotune.autotune(
        "quadform", key, build, [TileConfig(block_n=32), TileConfig(block_n=64)],
        repeats=1, warmup=0,
    )
    # the default was appended: 3 candidates timed, winner recorded
    assert len(rows) == 3
    assert any(r["config"] == tuning.DEFAULTS["quadform"] for r in rows)
    assert tuning.lookup("quadform", key, strict=True) == winner
    assert winner == min(rows, key=lambda r: r["ms"])["config"]
    assert set(seen) == {TileConfig(block_n=32), TileConfig(block_n=64), tuning.DEFAULTS["quadform"]}


def test_autotune_prior_prunes_but_keeps_the_default():
    """Rank and prune: with ``prior_keep=1`` only the predicted-cheapest
    and the default are measured; the recorded entry carries both times."""
    cands = [TileConfig(block_n=32), TileConfig(block_n=64), TileConfig(block_n=128, splits=2)]
    timed = []

    def build(cfg):
        return lambda: timed.append(cfg)

    _, rows = autotune.autotune(
        "quadform", "d8_k1_n64", build, cands, repeats=1, warmup=0,
        prior=lambda c: c.block_n, prior_keep=1, source="unit-test",
    )
    assert [r["config"] for r in rows] == [TileConfig(block_n=32), tuning.DEFAULTS["quadform"]]
    assert set(timed) == {TileConfig(block_n=32), tuning.DEFAULTS["quadform"]}


# the default's three readings span 0.2 ms; the candidate's beside them
IN_TURNS = [
    ([0.5, 0.6, 0.7], 32),  # ahead by more than the spread in every round
    ([0.5, 0.6, 1.05], 64),  # not in the third round
    ([0.9, 1.05, 0.95], 64),  # ahead every round, by less than the spread
]


@pytest.mark.parametrize("candidate_ms, picked", IN_TURNS, ids=["wins", "one_round_short", "within_spread"])
def test_autotune_in_turns_keeps_the_default_unless_a_candidate_wins_every_round(candidate_ms, picked):
    """With ``rounds=3`` each candidate is timed right after the default,
    and beats it only by more than the default's spread in every round;
    the recorded entry carries both medians."""
    default = TileConfig(block_n=64)
    readings = {64: iter([1.0, 1.2, 1.1]), 32: iter(candidate_ms)}
    order = []

    def timer(fn):
        order.append(fn())
        return next(readings[order[-1]])

    winner, rows = autotune.autotune(
        "rff_score", "unit_in_turns", lambda cfg: lambda: cfg.block_n,
        [default, TileConfig(block_n=32)], rounds=3, timer=timer, default=default,
    )
    assert order == [64, 32] * 3
    assert winner == TileConfig(block_n=picked)
    assert rows[0]["config"] == default and rows[0]["spread"] == pytest.approx(0.2)
    assert rows[1]["pairs"] == list(zip([1.0, 1.2, 1.1], candidate_ms))
    assert tuning.lookup("rff_score", "unit_in_turns", strict=True) == winner
    entry = tuning._overrides_meta[(tuning.platform(), "rff_score", "unit_in_turns")]
    assert entry["default_ms"] == pytest.approx(1.1)
    assert entry["measured_ms"] == pytest.approx(1.1 if picked == 64 else 0.6)


def test_tile_sweep_line_comes_from_autotune():
    """``scripts/tile_sweep.py`` records through ``autotune.autotune`` in
    three rounds and reports what it recorded."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "tile_sweep.py"
    spec = importlib.util.spec_from_file_location("tile_sweep", path)
    tile_sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tile_sweep)
    readings = {64: iter([1.0, 1.2, 1.1]), 32: iter([0.5, 0.6, 0.7])}
    cands = [TileConfig(block_n=64), TileConfig(block_n=32)]
    line = tile_sweep.sweep_key(
        "rff_score_q8", "d780_f1024_n64", lambda cfg: lambda: cfg.block_n,
        cands, lambda fn: next(readings[fn()]), "card, 700.00 W",
    )
    assert line["pick"] == cands[1].to_json() and line["default"] == cands[0].to_json()
    assert (line["measured_ms"], line["default_ms"]) == pytest.approx((0.6, 1.1))
    assert line["default_spread_ms"] == pytest.approx(0.2)
    assert line["candidates"][0]["pairs"] == [(1.0, 0.5), (1.2, 0.6), (1.1, 0.7)]
    meta = tuning._overrides_meta[(tuning.platform(), "rff_score_q8", "d780_f1024_n64")]
    assert meta["source"] == "scripts/tile_sweep.py; card, 700.00 W"


# ------------------------------------------------------ port's own checks


def test_tileconfig_json_roundtrip_and_refusals():
    cfg = TileConfig(block_n=32, splits=4, chunk=64)
    assert TileConfig.from_json(json.loads(json.dumps(cfg.to_json()))) == cfg
    with pytest.raises(TypeError, match="block_m"):
        TileConfig.from_json({"block_n": 64, "block_m": 256})
    with pytest.raises(ValueError):
        TileConfig.from_json({"block_n": 0})


@pytest.mark.parametrize(
    "config, why",
    [({"block_n": 128, "block_m": 256}, "block_m"), ({"block_n": 256}, "cannot launch")],
    ids=["reference_field", "block_n_b1_cannot_launch"],
)
def test_table_entry_the_port_cannot_launch_is_dropped(tmp_path, config, why):
    """A table naming the TPU config's ``block_m``, or a ``block_n`` B1 is
    not compiled for, loses that entry with one warning; its neighbour
    stays."""
    path = tmp_path / "table.json"
    keep = {"config": {"block_n": 64}}
    table = {"version": 1, "entries": {H100: {"quadform": {"d780_k10_n64": keep, "d780_k10_n1024": {"config": config}}}}}
    path.write_text(json.dumps(table))
    with pytest.warns(UserWarning) as warned:
        clean = tuning.load_table(str(path))
    assert len(warned) == 1 and why in str(warned[0].message)
    assert clean["entries"][H100]["quadform"] == {"d780_k10_n64": keep}


@pytest.mark.parametrize(
    "kernel, config, launches",
    [
        ("quadform", TileConfig(block_n=b), b in BLOCK_N)
        for b in (16, 32, 64, 128, 256)
    ]
    + [("fwht", TileConfig(block_n=b), b % 16 == 0) for b in (16, 24, 48, 64)]
    + [
        ("flash_attn", TileConfig(block_q=64, block_k=64), True),
        ("flash_attn", TileConfig(block_q=128, block_k=64), False),
        ("maclaurin_attn", TileConfig(chunk=100), True),
    ],
)
def test_launch_refusal_follows_the_wrappers(kernel, config, launches):
    assert (tuning.launch_refusal(kernel, config) is None) == launches


def test_checked_in_table_loads_clean_with_h100_entries_for_b1_to_b7():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        table = tuning.load_table(tuning.TABLE_PATH)
    entries = table["entries"]
    cards = [plat for plat in entries if plat.startswith("NVIDIA H100")]
    assert cards, sorted(entries)
    kernels = ("quadform", "quadform_q8", "rbf_pred", "rff_score", "rff_score_q8", "fwht", "fwht_q8")
    for plat in cards:
        assert set(kernels) <= set(entries[plat]), sorted(entries[plat])
        for kernel in kernels:
            for key, entry in entries[plat][kernel].items():
                assert {"measured_ms", "default_ms", "source"} <= set(entry), (kernel, key)
                assert entry["measured_ms"] <= entry["default_ms"], (kernel, key)
                assert "scripts/tile_sweep.py" in entry["source"] and "W" in entry["source"]
    # the engine's keys on paths 1-3: B1/B3 at d=780, K=10, buckets 32..1024
    for n in (32, 64, 128, 256, 512, 1024):
        key = tuning.shape_key(d=780, k=10, n=n)
        assert tuning.lookup("quadform", key, platform_name=cards[0], strict=True).block_n <= n


def test_platform_is_cpu_without_a_card(monkeypatch):
    tuning.platform.cache_clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        assert tuning.platform() == "cpu"
    finally:
        tuning.platform.cache_clear()


# ------------------------------------------- keys and engine resolution


ARTIFACTS = [
    ("maclaurin", "float32", {}),
    ("maclaurin", "int8", {}),
    ("poly2", "float32", {}),
    ("poly2", "int8", {}),
    ("fourier", "float32", {"num_features": 64}),
    ("fourier", "int8", {"num_features": 64}),
    ("fourier", "float32", {"num_features": 64, "structured": True}),
    ("fourier", "int8", {"num_features": 64, "structured": True}),
]


@pytest.mark.parametrize(
    "family, dtype, opts", ARTIFACTS, ids=[f"{f}-{d}-{len(o)}" for f, d, o in ARTIFACTS]
)
def test_tile_lookup_keys_equal_the_reference(family, dtype, opts):
    jm, tm = _svms()
    jart = jfamilies.get_family(family).compile(jm, dtype=dtype, **opts)
    art = families.get_family(family).compile(tm, dtype=dtype, **opts)
    for b in (32, 64, 1024):
        got = families.get_family(family).tile_lookup(art, b)
        assert got == jfamilies.get_family(family).tile_lookup(jart, b)
        assert got[0] in tuning.DEFAULTS


def _toy_engine(**kw):
    _, tm = _svms(k=1)
    return SVMEngine(families.maclaurin.compile(tm), tm, device="cpu", **kw)


def test_engine_resolves_tuned_config_per_bucket():
    tuned = TileConfig(block_n=32, splits=2)
    art = _toy_engine().artifact
    kernel, key = families.maclaurin.tile_lookup(art, 64)
    tuning.record(kernel, key, tuned)
    eng = _toy_engine(min_bucket=32, max_batch=128)
    eng.warmup()
    # bucket 64 picked up the measured entry, the others the default
    # (clamped to the bucket)
    assert eng.bucket_configs[64] == tuned
    for b in (32, 128):
        assert eng.bucket_configs[b] == tuning.lookup(kernel).clamp_block_n(b)
        assert eng.bucket_configs[b].block_n == min(tuning.DEFAULTS[kernel].block_n, b)
    f, _ = eng.predict(np.zeros((5, D), np.float32))
    assert f.shape == (5,)


def test_engine_explicit_tile_config_pins_all_buckets():
    eng = _toy_engine(min_bucket=32, max_batch=128, tile_config=TileConfig(block_n=32))
    eng.warmup()
    assert all(c.block_n == 32 for c in eng.bucket_configs.values())


def test_engine_bucket_configs_come_from_the_table(monkeypatch, tmp_path):
    """With a table on disk naming this platform's keys, every bucket's
    config is the tabled entry, clamped to the bucket."""
    art = _toy_engine().artifact
    kernel = families.maclaurin.tile_lookup(art, 32)[0]
    entries = {
        families.maclaurin.tile_lookup(art, b)[1]: {"config": {"block_n": 32, "splits": s}}
        for b, s in ((32, 1), (64, 2), (128, 4))
    }
    path = tmp_path / "table.json"
    path.write_text(json.dumps({"version": 1, "entries": {tuning.platform(): {kernel: entries}}}))
    monkeypatch.setattr(tuning, "TABLE_PATH", str(path))
    tuning.reload_table()
    try:
        eng = _toy_engine(min_bucket=32, max_batch=128)
        eng.warmup()
        for b, s in ((32, 1), (64, 2), (128, 4)):
            want = tuning.lookup(*families.maclaurin.tile_lookup(art, b)).clamp_block_n(b)
            assert eng.bucket_configs[b] == want == TileConfig(block_n=32, splits=s)
    finally:
        tuning.reload_table()
