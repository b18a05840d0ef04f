"""The manifest loader, and a cell added as new files only."""
import json
import pathlib
import shutil
import time

import pytest

from perfbench import cell, manifest
from perfbench.tests import smoke

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _doc():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_loads_and_every_cell_plans():
    doc = manifest.load(ROOT)
    for w in doc["workloads"]:
        plan = manifest.plan(w["name"], root=ROOT)
        assert plan.end_to_end and plan.per_layer
        assert "setup_s" in [m["name"] for m in plan.end_to_end]
        for m in plan.per_layer:
            assert callable(plan.readers[m["name"]])


@pytest.mark.parametrize("bad", ["has space", "comma,", "slash/x", ".dot",
                                 "-dash", "x" * 65, "grüß"])
def test_names_with_other_characters_are_refused(bad):
    doc = _doc()
    doc["workloads"][0]["name"] = bad
    with pytest.raises(manifest.ManifestError):
        manifest.check(doc)


@pytest.mark.parametrize("bad", ["tokens per second", "µs", "", "x" * 17])
def test_units_with_other_characters_are_refused(bad):
    doc = _doc()
    doc["end_to_end"][0]["unit"] = bad
    with pytest.raises(manifest.ManifestError):
        manifest.check(doc)


def test_a_metric_must_move_an_end_to_end_metric():
    doc = _doc()
    doc["per_layer"][0]["moves"] = "nothing_s"
    with pytest.raises(manifest.ManifestError):
        manifest.check(doc)


def test_new_config_mix_and_metric_as_files_only(tmp_path):
    """A later change adds a configuration, a mix and a metric as new
    files and entries; the harness plans and runs them unedited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    doc = _doc()
    cfg = json.loads((ROOT / "perfbench/configs/qwen3_moe_235b_a22b.d8.json")
                     .read_text())
    cfg["model"].update(smoke.SMALL)
    (tmp_path / "perfbench/configs/tiny_moe.json").write_text(
        json.dumps(cfg))
    mix = dict(json.loads(
        (ROOT / "perfbench/traffic/isl4096_backlog.json").read_text()))
    mix.update(smoke.MIX, lengths={"kind": "lognormal", "median": 24,
                                   "sigma": 0.5, "min": 8, "max": 64,
                                   "set": 16})
    (tmp_path / "perfbench/traffic/mixed_small.json").write_text(
        json.dumps(mix))
    (tmp_path / "perfbench/limits/tiny_moe.mixed_small.json").write_text(
        json.dumps({"hidden_rel_err_median": 1e-3, "token_gap": 1e-3}))
    (tmp_path / "perfbench/metrics/jobs_in_window.py").write_text(
        "def read(rec):\n    return float(len(rec.jobs)) or None\n")
    doc["configs"].append({"name": "tiny_moe", "source": "test",
                           "file": "perfbench/configs/tiny_moe.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "tiny_moe.mixed_small",
                             "config": "tiny_moe", "traffic": "mixed_small",
                             "chips": 1, "why": "test"})
    doc["per_layer"].append({"name": "jobs_in_window", "unit": "jobs",
                             "better": "higher", "source": "program_counter",
                             "layer": "engine",
                             "moves": "prefill_tokens_per_s",
                             "workloads": ["tiny_moe.mixed_small"]})
    doc["end_to_end"].append({"name": "prefill_tokens_per_s",
                              "unit": "tokens/s", "better": "higher",
                              "bound": 0.25, "source": "host_clock",
                              "workloads": ["tiny_moe.mixed_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    plan = manifest.plan("tiny_moe.mixed_small", root=tmp_path)
    assert [m["name"] for m in plan.per_layer] == ["jobs_in_window"]
    result, checks, rec, _ = cell.execute(plan, 11, 1.0, True, "cpu",
                                       time.monotonic(),
                                       model=plan.config["model"],
                                       exact=False)
    assert result["correct"], checks
    assert result["metrics"]["jobs_in_window"]["value"] == len(rec.jobs) > 0
    assert len({r["length"] for r in rec.results}) > 1
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there changed
