"""The port's Super Kernel tile table (`kernels/super_gmm/tuning.py`) against
the reference's (`tests/test_tuning.py`): schema, version gate, registry,
the sweep space, the tile a table hands each launch, and the sweep
harness's table round trip.  On the CPU the wrappers run their plain
versions, so a table changes no number here; which tile runs is spied."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.super_gmm import tuning as jax_tuning
from repro.kernels.super_gmm.ops import super_moe_ffn as jax_super_moe_ffn
from repro.models.common import ModelConfig as JaxModelConfig
from repro_torch.kernels.super_gmm import ops, tuning
from repro_torch.kernels.super_gmm import super_gmm as sg
from repro_torch.launch import serve, tune_superkernel
from repro_torch.models.common import ModelConfig


@pytest.fixture(autouse=True)
def _isolated_registry():
    """Each test gets a clean process-global table registry and restores the
    prior state afterwards (other tests must never see a leftover table)."""
    with tuning._table_lock:
        saved = (tuning._active, tuning._env_checked)
        tuning._active, tuning._env_checked = None, True
    yield
    with tuning._table_lock:
        tuning._active, tuning._env_checked = saved


@pytest.mark.parametrize("dtype,want", [
    ((np.float32, torch.float32), "e8_d128_f256_float32"),
    ((jnp.bfloat16, torch.bfloat16), "e8_d128_f256_bfloat16"),
    (("float32", "float32"), "e8_d128_f256_float32")])
def test_config_key_canonical_and_equal_to_the_reference(dtype, want):
    """One JSON schema serves both packages: the same geometry gives the
    reference's exact string, a torch dtype the name numpy gives JAX's."""
    jd, td = dtype
    assert tuning.config_key(8, 128, 256, td) == want
    assert tuning.config_key(8, 128, 256, td) == \
        jax_tuning.config_key(8, 128, 256, jd)
    assert tuning.config_key(8, 128, 256, np.float32) == \
        "e8_d128_f256_float32"


def test_put_lookup_exact_bucket_only():
    t = tuning.TuningTable()
    t.put("e8_d128_f256_bfloat16", 16, (128, 128, 64), (64, 256, 64),
          us=12.5)
    assert t.lookup("e8_d128_f256_bfloat16", 16) == \
        ((128, 128, 64), (64, 256, 64))
    # no nearest-bucket guessing
    assert t.lookup("e8_d128_f256_bfloat16", 32) is None
    assert t.lookup("e4_d128_f256_bfloat16", 16) is None


def test_save_load_roundtrip_and_version_gate(tmp_path):
    t = tuning.TuningTable(meta={"platform": "gpu"})
    t.put("e8_d128_f64_bfloat16", 8, (64, 128, 64), (128, 256, 64), us=1.0)
    path = str(tmp_path / "table.json")
    t.save(path)
    loaded = tuning.TuningTable.load(path)
    assert loaded.lookup("e8_d128_f64_bfloat16", 8) == \
        ((64, 128, 64), (128, 256, 64))
    assert loaded.meta["platform"] == "gpu"
    # the schema is the reference's: its loader reads the port's file
    assert jax_tuning.TuningTable.load(path).lookup(
        "e8_d128_f64_bfloat16", 8) == ((64, 128, 64), (128, 256, 64))
    # a future-versioned table must refuse to load, not silently misapply
    with open(path) as f:
        payload = json.load(f)
    payload["version"] = 99
    with open(path, "w") as f:
        json.dump(payload, f)
    with pytest.raises(ValueError, match="re-run"):
        tuning.TuningTable.load(path)


def test_registry_explicit_install_and_env_fallback(tmp_path, monkeypatch):
    t = tuning.TuningTable()
    t.put("e2_d16_f32_bfloat16", 8, (64, 128, 64), (128, 128, 64))
    # explicit install wins
    tuning.set_table(t)
    assert tuning.lookup_blocks(2, 16, 32, torch.bfloat16, 8) == \
        ((64, 128, 64), (128, 128, 64))
    assert tuning.lookup_blocks(2, 16, 32, torch.bfloat16, 16) is None
    tuning.set_table(None)
    assert tuning.get_table() is None
    # env fallback: honoured lazily once when nothing was installed
    path = str(tmp_path / "env_table.json")
    t.save(path)
    monkeypatch.setenv(tuning.ENV_VAR, path)
    assert tuning.ENV_VAR == jax_tuning.ENV_VAR == "ASAP_TUNING_TABLE"
    with tuning._table_lock:
        tuning._active, tuning._env_checked = None, False
    assert tuning.get_table() is not None
    assert tuning.lookup_blocks(2, 16, 32, torch.bfloat16, 8) == \
        ((64, 128, 64), (128, 128, 64))
    # a broken env path raises instead of silently falling back
    monkeypatch.setenv(tuning.ENV_VAR, str(tmp_path / "missing.json"))
    with tuning._table_lock:
        tuning._active, tuning._env_checked = None, False
    with pytest.raises(FileNotFoundError):
        tuning.get_table()


def test_sweep_space_default_first():
    """The candidates are the instantiated (BM, BN, 64) tiles, the default
    first, so a truncated sweep still contains the default tile."""
    cands = tuning.candidate_blockings()
    assert cands == [(bm, bn, 64) for bm, bn in sg.TILES]
    assert cands[0] == (*sg.DEFAULT_TILE, 64) == (128, 256, 64)
    assert len(set(cands)) == len(cands) > 1
    assert tuning.candidate_blockings(limit=3) == cands[:3]
    assert tuning.candidate_blockings(limit=1) == [(128, 256, 64)]
    assert tuning.block_candidates("m") == [128, 64]
    assert tuning.block_candidates("n") == [256, 128]
    assert tuning.block_candidates("k") == [64]


# ------------------------------------------------------------- numerics --

def _ffn(seed=0, L=2, E=4, C=8, d=64, f=32):
    rng = np.random.RandomState(seed)
    experts = {"w_gate": rng.randn(L, E, d, f) * d ** -0.5,
               "w_up": rng.randn(L, E, d, f) * d ** -0.5,
               "w_down": rng.randn(L, E, f, d) * f ** -0.5}
    xb = rng.randn(E, C, d)
    kw = dict(name="t", family="moe", vocab_size=8, d_model=d, d_ff=f,
              num_layers=L, num_heads=2, num_kv_heads=2, head_dim=8,
              num_experts=E, top_k=2, moe_d_ff=f)
    return {k: v.astype(np.float32) for k, v in experts.items()}, \
        xb.astype(np.float32), kw


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def test_tuned_super_moe_ffn_equals_untuned_and_the_reference():
    """A table changes the tile only: on the CPU the output is torch.equal
    to the untuned one, and both are within 1e-4 of the JAX super_moe_ffn
    (Pallas interpret mode) on the same bf16 inputs (the same products,
    fp32 sums in another order)."""
    experts, xb, kw = _ffn()
    E, C, d = xb.shape
    f = kw["moe_d_ff"]
    cfg = ModelConfig(dtype=torch.bfloat16, **kw)
    tex = {k: _bf16(v) for k, v in experts.items()}
    lid = torch.tensor([1], dtype=torch.int32)
    base = ops.super_moe_ffn(lid, tex, _bf16(xb), cfg)
    t = tuning.TuningTable()
    t.put(tuning.config_key(E, d, f, torch.bfloat16), C, (64, 128, 64),
          (128, 128, 64))
    tuning.set_table(t)
    tuned = ops.super_moe_ffn(lid, tex, _bf16(xb), cfg)
    assert torch.equal(tuned, base)
    jcfg = JaxModelConfig(dtype=jnp.bfloat16, **kw)
    want = jax_super_moe_ffn(
        jnp.asarray([1], jnp.int32),
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in experts.items()},
        jnp.asarray(xb, jnp.bfloat16), jcfg, interpret=True)
    np.testing.assert_allclose(tuned.numpy(), np.asarray(want, np.float32),
                               rtol=1e-4, atol=1e-4)


def _spy(monkeypatch):
    calls = []
    real = ops.super_gmm

    def spy(layer_id, w, x, counts=None, tile=None):
        calls.append((w.shape[-1], tile))
        return real(layer_id, w, x, counts, tile=tile)

    monkeypatch.setattr(ops, "super_gmm", spy)
    return calls


def test_table_tiles_reach_gate_up_and_down_launches(monkeypatch):
    """On a hit the up tile goes to the gate and up launches and the down
    tile to the down launch; without a table, or for another bucket, every
    launch takes the default (tile None)."""
    experts, xb, kw = _ffn()
    E, C, d = xb.shape
    f = kw["moe_d_ff"]
    cfg = ModelConfig(dtype=torch.bfloat16, **kw)
    tex = {k: _bf16(v) for k, v in experts.items()}
    lid = torch.tensor([0], dtype=torch.int32)
    calls = _spy(monkeypatch)
    ops.super_moe_ffn(lid, tex, _bf16(xb), cfg)
    assert calls == [(f, None), (f, None), (d, None)]
    t = tuning.TuningTable()
    t.put(tuning.config_key(E, d, f, torch.bfloat16), C, (64, 256, 64),
          (128, 128, 64))
    tuning.set_table(t)
    calls.clear()
    ops.super_moe_ffn(lid, tex, _bf16(xb), cfg)
    assert calls == [(f, (64, 256)), (f, (64, 256)), (d, (128, 128))]
    calls.clear()
    xb16 = torch.cat([_bf16(xb), _bf16(xb)], 1)  # bucket 16: no entry
    ops.super_moe_ffn(lid, tex, xb16, cfg)
    assert calls == [(f, None), (f, None), (d, None)]


@pytest.mark.parametrize("entry,dtype", [
    (((16, 64, 128), (16, 128, 64)), torch.bfloat16),  # a TPU blocking
    (((128, 256, 32), (128, 256, 64)), torch.bfloat16),  # BK 32
    (((128, 256, 64), (128, 256, 128)), torch.bfloat16),  # BK 128
    (((128, 64, 64), (128, 256, 64)), torch.bfloat16),  # BN 64: no variant
    (((256, 256, 64), (128, 256, 64)), torch.bfloat16),  # BM 256
    (((128, 256, 64), (128, 256, 64)), torch.float32)])  # fp32 takes fma
def test_entries_the_kernel_cannot_launch_raise(entry, dtype):
    """An entry that is not a tile of the kernel raises ValueError naming
    the instantiated set, on the CPU too: a tuned run that silently ran
    another tile would invalidate the measurement."""
    experts, xb, kw = _ffn()
    E, C, d = xb.shape
    f = kw["moe_d_ff"]
    cfg = ModelConfig(dtype=dtype, **kw)
    tex = {k: torch.from_numpy(v).to(dtype) for k, v in experts.items()}
    t = tuning.TuningTable()
    t.put(tuning.config_key(E, d, f, dtype), C, *entry)
    tuning.set_table(t)
    with pytest.raises(ValueError, match=r"\(128, 256, 64\)"):
        ops.super_moe_ffn(torch.tensor([0], dtype=torch.int32), tex,
                          torch.from_numpy(xb).to(dtype), cfg)


def test_super_gmm_tile_argument_on_the_cpu():
    """On a CPU tensor the plain version runs whatever instantiated tile is
    named; a tile that is not instantiated raises."""
    rng = np.random.RandomState(3)
    w = torch.from_numpy(rng.randn(2, 3, 64, 32).astype(np.float32))
    x = torch.from_numpy(rng.randn(3, 8, 64).astype(np.float32))
    lid = torch.tensor([1], dtype=torch.int32)
    base = sg.super_gmm(lid, w, x)
    for tile in sg.TILES:
        assert torch.equal(sg.super_gmm(lid, w, x, tile=tile), base)
    for bad in ((128, 64), (256, 256), (64, 64), (16, 128)):
        with pytest.raises(ValueError, match="instantiated"):
            sg.super_gmm(lid, w, x, tile=bad)


def test_launch_counts_by_tile_start_at_zero_and_reset():
    assert set(sg.super_gmm.launches_by_tile) == \
        {sg.tile_name(t) for t in sg.TILES} == \
        {"128x256", "128x128", "64x256", "64x128"}

    def kern():
        pass
    kern.launches = 0
    kern.launches_by_route = {"wgmma": 0}
    kern.launches_by_tile = {"128x256": 0, "64x128": 0}
    from repro_torch.kernels import _launch
    _launch.count_launch(kern, "wgmma", "64x128")
    _launch.count_launch(kern, "wgmma", "64x128")
    assert kern.launches_by_tile == {"128x256": 0, "64x128": 2}
    with pytest.raises(KeyError):
        _launch.count_launch(kern, "wgmma", "32x32")
    assert kern.launches == 2 and kern.launches_by_route["wgmma"] == 2
    _launch.reset_launches(kern)
    assert set(kern.launches_by_tile.values()) == {0}


# ------------------------------------------------------- sweep harness --

def test_sweep_run_raises_on_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="no tiles to time"):
        tune_superkernel.run(quick=True, out=str(tmp_path / "t.json"),
                             device="cpu")
    assert not (tmp_path / "t.json").exists()


def test_sweep_geometry_is_the_serve_configurations_moe_device():
    g = tune_superkernel.geometry()
    assert (g["n_experts"], g["d_model"], g["d_ff"], g["num_layers"],
            g["dtype"]) == (32, 4096, 1536, 4, torch.bfloat16)
    assert tune_superkernel.BUCKETS == [8, 16, 32, 64, 128, 256, 512]
    assert len(tune_superkernel.QUICK_BUCKETS) == 2
    assert tune_superkernel.OUT.endswith("results/superkernel_tuning_h100.json")


def test_sweep_rows_to_table_roundtrip_on_hand_made_timings(tmp_path):
    """`run`'s timings -> rows and table -> save -> load round trip, on
    hand-made timings in place of the card's: each GMM's fastest tile wins
    per bucket (the earlier candidate on a tie), and every winner reads
    back, also through the reference's loader."""
    timings = {
        "8": {"up": {"128x256": 10.0, "128x128": 9.0, "64x256": 9.0,
                     "64x128": 12.0},
              "down": {"128x256": 10.0, "128x128": 11.0, "64x256": 10.5,
                       "64x128": 8.0}},
        "512": {"up": {"128x256": 30.0, "128x128": 31.0, "64x256": 40.0,
                       "64x128": 50.0},
                "down": {"128x256": 33.0, "128x128": 33.0, "64x256": 41.0,
                         "64x128": 52.0}}}
    key = tuning.config_key(32, 4096, 1536, torch.bfloat16)
    table, rows = tune_superkernel.build_table(key, timings,
                                               {"buckets": [8, 512]})
    assert rows == [
        (key, 8, "(128, 128, 64)", "9.0", "(64, 128, 64)", "8.0"),
        (key, 512, "(128, 256, 64)", "30.0", "(128, 256, 64)", "33.0")]
    out = str(tmp_path / "sweep.json")
    table.save(out)
    for loader in (tuning.TuningTable.load, jax_tuning.TuningTable.load):
        loaded = loader(out)
        assert loaded.meta["buckets"] == [8, 512]
        assert loaded.meta["us_by_tile"] == timings
        for k, C, up, _, down, _ in rows:
            got = loaded.lookup(k, int(C))
            assert got is not None and \
                (str(got[0]), str(got[1])) == (up, down)
    assert tuning.TuningTable.load(out).entries[key]["8"]["us"] == 17.0


# ------------------------------------------------------------------ serve --

def _full_width_table(tmp_path) -> str:
    """A table tuned for the card's serve geometry: loading it into a CPU
    smoke run installs it, and no smoke launch hits it."""
    t = tuning.TuningTable(meta={"platform": "gpu"})
    t.put(tuning.config_key(32, 4096, 1536, torch.bfloat16), 512,
          (128, 256, 64), (64, 256, 64))
    path = str(tmp_path / "table.json")
    t.save(path)
    return path


@pytest.mark.parametrize("mode", [[], ["--mode", "pd"]], ids=["asap", "pd"])
def test_serve_tuning_table_loads_and_prints_the_reference_line(
        tmp_path, capsys, mode):
    path = _full_width_table(tmp_path)
    rc = serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                     "--time-scale", "50", "--tuning-table", path] + mode)
    assert rc == 0
    out = capsys.readouterr().out
    assert f"super-kernel tuning table loaded from {path}\n" in out
    assert tuning.get_table().entries == \
        tuning.TuningTable.load(path).entries


def test_serve_tuning_table_refused_with_the_simulator(tmp_path):
    path = _full_width_table(tmp_path)
    with pytest.raises(SystemExit) as e:
        serve.main(["--engine", "sim", "--tuning-table", path])
    assert e.value.code == 2  # argparse error: the sim has no launches
    assert tuning.get_table() is None
