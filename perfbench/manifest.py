"""`BENCHMARK.json` and the files it names: load, check, and find a cell's
pieces by name.

A cell names a configuration (`perfbench/configs/<config>.json`, found by
the configuration's `file`) and a traffic mix (`perfbench/traffic/<mix>.json`);
each per-layer metric is a reader in `perfbench/metrics/<metric>.py`; each
cell's correctness limits are in `perfbench/limits/<cell>.json`.  Adding a
cell, a mix, a configuration or a metric adds files and entries; no file
that is there changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import re
from typing import Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


class ManifestError(ValueError):
    pass


def _name(value, what: str) -> str:
    if not isinstance(value, str) or not NAME.match(value):
        raise ManifestError(f"{what} {value!r}: a name is 1-64 of letters, "
                            f"digits, '_', '.', '-', not starting with "
                            f"'.' or '-'")
    return value


def _unit(value, what: str) -> str:
    if not isinstance(value, str) or not UNIT.match(value):
        raise ManifestError(f"{what} unit {value!r}: 1-16 of letters, "
                            f"digits, '_', '/', '%', '.', '-'")
    return value


def check(doc: dict) -> dict:
    """Raise `ManifestError` where `doc` breaks the rules the harness
    relies on (names, units, references between entries)."""
    configs = {_name(c["name"], "config"): c for c in doc["configs"]}
    if len(configs) != len(doc["configs"]):
        raise ManifestError("two configurations share a name")
    for c in doc["configs"]:
        for k in c.get("reduced", []):
            _name(k, f"config {c['name']} reduced key")
    cells = {}
    for w in doc["workloads"]:
        _name(w["name"], "workload")
        _name(w["traffic"], "traffic")
        if _name(w["config"], "workload config") not in configs:
            raise ManifestError(f"workload {w['name']}: no config "
                                f"{w['config']!r}")
        if w["name"] in cells:
            raise ManifestError(f"two workloads named {w['name']}")
        cells[w["name"]] = w
    seen = set()
    for group in ("end_to_end", "per_layer"):
        for m in doc[group]:
            _name(m["name"], "metric")
            _unit(m["unit"], m["name"])
            if m["name"] in seen:
                raise ManifestError(f"two metrics named {m['name']}")
            seen.add(m["name"])
            if m["better"] not in ("lower", "higher"):
                raise ManifestError(f"{m['name']}: better is lower/higher")
            if m["source"] not in SOURCES:
                raise ManifestError(f"{m['name']}: source {m['source']!r}")
            for w in m.get("workloads", []):
                if w not in cells:
                    raise ManifestError(f"{m['name']}: no workload {w!r}")
    e2e = {m["name"] for m in doc["end_to_end"]}
    for m in doc["per_layer"]:
        if m["moves"] not in e2e:
            raise ManifestError(f"{m['name']} moves {m['moves']!r}, which "
                                f"is not an end-to-end metric")
    return doc


def load(root: pathlib.Path = ROOT) -> dict:
    path = pathlib.Path(root) / "BENCHMARK.json"
    if not path.exists():
        raise ManifestError(f"no {path}")
    return check(json.loads(path.read_text()))


def _reports(metric: dict, cell: str) -> bool:
    ws = metric.get("workloads")
    return ws is None or cell in ws


@dataclasses.dataclass
class Plan:
    """Everything one run of one cell needs, found by name."""
    cell: dict
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    limits: dict  # the cell's correctness limits
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]  # per-layer metric name -> read(run)


def load_reader(name: str, root: pathlib.Path = ROOT) -> Callable:
    path = pathlib.Path(root) / "perfbench" / "metrics" / f"{name}.py"
    if not path.exists():
        raise ManifestError(f"metric {name}: no reader {path}")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def plan(workload: str, doc: Optional[dict] = None,
         root: pathlib.Path = ROOT) -> Plan:
    root = pathlib.Path(root)
    doc = load(root) if doc is None else check(doc)
    cells = {w["name"]: w for w in doc["workloads"]}
    if workload not in cells:
        raise ManifestError(f"no workload {workload!r} (have "
                            f"{sorted(cells)})")
    cell = cells[workload]
    cfg_entry = next(c for c in doc["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (root / "perfbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    limits = json.loads(
        (root / "perfbench" / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in doc["end_to_end"] if _reports(m, workload)]
    layer = [m for m in doc["per_layer"] if _reports(m, workload)]
    readers = {m["name"]: load_reader(m["name"], root) for m in layer}
    return Plan(cell=cell, config=config, traffic=traffic, limits=limits,
                end_to_end=e2e, per_layer=layer, readers=readers)


def prepare_env(traffic: dict, root: pathlib.Path = ROOT) -> None:
    """The process settings every run of a cell takes, set before torch is
    imported: torch's host threads as the mix fixes them, one allocator
    setting (the weights leave the executor's streams little room, and
    fixed-size segments fragment it), and every build and kernel cache at a
    fixed path in the checkout."""
    build = pathlib.Path(root) / "build"
    os.environ["OMP_NUM_THREADS"] = str(traffic["host_threads"])
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "perfbench" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "perfbench" / "triton")
