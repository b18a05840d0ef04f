"""Capacity-bucket tile table for the MoE Super Kernel.

The wgmma kernel of `csrc/super_gmm.cu` is instantiated at several output
tiles (BM, BN) -- `super_gmm.TILES` -- with BK fixed at 64, and its launch
picks one at run time.  Which tile is fastest depends on the geometry
(n_experts, d_model, d_ff, dtype) and on the capacity bucket C, so
`python -m repro_torch.launch.tune_superkernel` times every tile for the two
GMM shapes `super_moe_ffn` launches -- gate/up ([E, C, d] @ [E, d, f]) and
down ([E, C, f] @ [E, f, d]) -- on the card and persists the winners here
as JSON.

At serve time `super_moe_ffn` consults the table on every call:

  * `set_table(TuningTable.load(path))` -- explicit (serve's --tuning-table);
  * `ASAP_TUNING_TABLE=<path>` -- env fallback, loaded lazily once;
  * no table / no entry -> the default tile, `super_gmm.DEFAULT_TILE`.

The lookup is a host dict read keyed by the launch's shapes and dtype: no
host sync and no new launch signature.  A tile never changes the K
reduction order (BK and the k16 steps stay in ascending K), so a tuned launch
gives the same bits as an untuned one, and merged capacity buffers stay
bitwise equal to per-region ones under any table.

Table schema (versioned; the reference's, so one file format serves both
packages):

  {"version": 1,
   "entries": {"e32_d4096_f1536_bfloat16": {"512": {"up": [128, 256, 64],
                                                    "down": [64, 256, 64],
                                                    "us": 123.4}, ...}, ...}}

The (bc, bn, bk) triples of the port mean (BM, BN, BK).  `us` (measured
microseconds of the winning tiles' two launches) is carried for provenance
only; lookups ignore it.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.super_gmm.super_gmm import BK, TILES

Blocks = Tuple[int, int, int]

ENV_VAR = "ASAP_TUNING_TABLE"
TABLE_VERSION = 1


def _dtype_name(dtype) -> str:
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    import numpy as np
    return np.dtype(dtype).name


def config_key(n_experts: int, d_model: int, d_ff: int, dtype) -> str:
    """Canonical key for one super-kernel geometry: the reference's string
    for the same geometry.  `dtype` is a torch dtype, anything numpy can
    name, or a name ("bfloat16", "float32", ...)."""
    return f"e{n_experts}_d{d_model}_f{d_ff}_{_dtype_name(dtype)}"


@dataclass
class TuningTable:
    """Best-known (up, down) tiles per geometry x capacity bucket."""

    entries: Dict[str, Dict[str, dict]] = field(default_factory=dict)
    meta: Dict[str, object] = field(default_factory=dict)

    def put(self, key: str, capacity: int, up: Blocks, down: Blocks,
            us: Optional[float] = None) -> None:
        rec: dict = {"up": list(up), "down": list(down)}
        if us is not None:
            rec["us"] = us
        self.entries.setdefault(key, {})[str(int(capacity))] = rec

    def lookup(self, key: str, capacity: int
               ) -> Optional[Tuple[Blocks, Blocks]]:
        """Exact (key, bucket) hit or None -- no nearest-bucket guessing: a
        tile tuned for one C says nothing about another."""
        rec = self.entries.get(key, {}).get(str(int(capacity)))
        if rec is None:
            return None
        return tuple(rec["up"]), tuple(rec["down"])  # type: ignore[return-value]

    def save(self, path: str) -> None:
        payload = {"version": TABLE_VERSION, "meta": self.meta,
                   "entries": self.entries}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        with open(path) as f:
            payload = json.load(f)
        if payload.get("version") != TABLE_VERSION:
            raise ValueError(
                f"tuning table {path!r}: version {payload.get('version')!r} "
                f"!= supported {TABLE_VERSION} -- re-run "
                f"python -m repro_torch.launch.tune_superkernel to "
                f"re-baseline")
        return cls(entries=payload.get("entries", {}),
                   meta=payload.get("meta", {}))


# ---------------------------------------------------------------------------
# Active-table registry (process-global, set once at engine setup)
# ---------------------------------------------------------------------------

_table_lock = threading.Lock()
_active: Optional[TuningTable] = None  # guarded_by: _table_lock
_env_checked = False  # guarded_by: _table_lock


def set_table(table: Optional[TuningTable]) -> None:
    """Install (or clear, with None) the process-wide active table.  Called
    at engine construction, before worker threads launch any kernel."""
    global _active, _env_checked
    with _table_lock:
        _active = table
        _env_checked = True  # explicit install wins over the env fallback


def get_table() -> Optional[TuningTable]:
    """The active table; on first call honours ASAP_TUNING_TABLE if no table
    was installed explicitly.  A broken env path raises -- a tuned run that
    silently falls back to the default tile would invalidate the
    measurement."""
    global _active, _env_checked
    with _table_lock:
        if not _env_checked:
            _env_checked = True
            path = os.environ.get(ENV_VAR)
            if path:
                _active = TuningTable.load(path)
        return _active


def lookup_blocks(n_experts: int, d_model: int, d_ff: int, dtype,
                  capacity: int) -> Optional[Tuple[Blocks, Blocks]]:
    """One-stop consult for `super_moe_ffn`: returns ((BM, BN, BK) for the
    gate/up GMMs, (BM, BN, BK) for the down GMM) on a hit, else None."""
    table = get_table()
    if table is None:
        return None
    return table.lookup(config_key(n_experts, d_model, d_ff, dtype), capacity)


def tile_of(blocks, dtype) -> Tuple[int, int]:
    """The (BM, BN) a table entry names, checked: a triple of the
    instantiated tiles with BK 64, for a bf16 launch (the wgmma route, the
    only one with tiles).  Anything else -- a TPU blocking, another BK, a
    float32 geometry -- raises ValueError naming the instantiated set."""
    blocks = tuple(int(b) for b in blocks)
    ok = (len(blocks) == 3 and blocks[2] == BK and blocks[:2] in TILES)
    if not ok:
        raise ValueError(
            f"tuning table entry {blocks} is not a tile of the Super Kernel: "
            f"the instantiated (BM, BN, BK) are {candidate_blockings()}")
    if _dtype_name(dtype) != "bfloat16":
        raise ValueError(
            f"tuning table entry {blocks} for a {_dtype_name(dtype)} launch: "
            f"only bf16 launches (the wgmma route) take a tile of "
            f"{candidate_blockings()}")
    return blocks[:2]


# ---------------------------------------------------------------------------
# Sweep space (shared by launch/tune_superkernel.py and the tests)
# ---------------------------------------------------------------------------


def block_candidates(axis: str) -> List[int]:
    """The instantiated sizes along one axis of the tile, in the order of
    `super_gmm.TILES` (default first): "m" -> BM, "n" -> BN, "k" -> BK."""
    if axis == "k":
        return [BK]
    i = {"m": 0, "n": 1}[axis]
    return list(dict.fromkeys(t[i] for t in TILES))


def candidate_blockings(limit: Optional[int] = None) -> List[Blocks]:
    """The (BM, BN, BK) sweep space: every instantiated tile, the default
    first, so a truncated sweep (`limit`) still contains it.  The kernel
    masks every ragged edge, so each tile takes every GMM shape (the
    reference's space depends on the shape; this one does not)."""
    out = [(bm, bn, BK) for bm, bn in TILES]
    return out if limit is None else out[:limit]
