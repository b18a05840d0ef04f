"""Tile sweep for the MoE Super Kernel on the card.

For the serve configuration's per-MoE-device geometry -- qwen3_moe_235b_a22b
at its published widths on E=4 MoE devices: 128 / 4 = 32 experts, d_model
4096, expert d_ff 1536, bf16, the resident stack of L = 4 layers -- and each
capacity bucket C, times every instantiated (BM, BN) tile of the wgmma
kernel (`tuning.candidate_blockings`) for the two GMM shapes `super_moe_ffn`
launches, gate/up ([E, C, d] @ [E, d, f]) and down ([E, C, f] @ [E, f, d]),
and persists the winners as a versioned `tuning.TuningTable`.  The two GMMs
are swept independently: they are separate launches, and the best tile for
one says nothing about the other.  Each candidate is one launch timed with
CUDA events, best of N, after a warm-up launch; every row of the bucket is
real (dense x), as the reference's sweep times it.

  PYTHONPATH=src python -m repro_torch.launch.tune_superkernel [--quick]
      [--out results/superkernel_tuning_h100.json] [--buckets 8,64,512]

Serve with the result through `python -m repro_torch.launch.serve
--tuning-table <path>` or `ASAP_TUNING_TABLE=<path>`.  The table's `meta`
names the card (nvidia-smi's name and power limit) it was timed on.  There
are no tiles to time on a CPU: the sweep raises there.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.kernels.super_gmm import tuning
from repro_torch.kernels.super_gmm.ops import round_capacity
from repro_torch.kernels.super_gmm.super_gmm import super_gmm, tile_name

OUT = str(pathlib.Path(__file__).resolve().parents[3] / "results"
          / "superkernel_tuning_h100.json")
ARCH = "qwen3_moe_235b_a22b"
MOE_DEVICES = 4  # the serve configuration's E
LAYERS = 4  # the serve configuration's depth (the resident stack's L)
# round_capacity(1) = 8 up to 512, the buckets of the serve wave's regions
BUCKETS = [round_capacity(1) << i for i in range(7)]
QUICK_BUCKETS = [BUCKETS[0], BUCKETS[-1]]


def geometry() -> dict:
    cfg = get_config(ARCH)
    return dict(n_experts=cfg.num_experts // MOE_DEVICES,
                d_model=cfg.d_model, d_ff=cfg.expert_d_ff,
                num_layers=LAYERS, dtype=torch.bfloat16)


def card() -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit` gives it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as ex:
        return f"nvidia-smi failed: {ex}"
    return out[0] if out else "nvidia-smi printed nothing"


def _time_tile(lid, w, x, tile, reps: int) -> float:
    """Best-of-`reps` microseconds of one super_gmm launch at `tile`, each
    timed with CUDA events on the current stream, after a warm-up launch
    (the library build and the shared-memory opt-in are not timed)."""
    super_gmm(lid, w, x, tile=tile)
    torch.cuda.synchronize()  # sync-ok: timing harness, off the serving path
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(reps):
        t0.record()
        super_gmm(lid, w, x, tile=tile)
        t1.record()
        t1.synchronize()  # sync-ok: ends the timed launch
        best = min(best, t0.elapsed_time(t1) * 1e3)
    return best


def _sweep_gmm(w, x, lid, reps: int) -> Dict[str, float]:
    """Every candidate tile's us for one [E, C, K] @ [E, K, N] shape, by
    tile name, in candidate order."""
    return {tile_name(b): _time_tile(lid, w, x, b[:2], reps)
            for b in tuning.candidate_blockings()}


def winner(us_by_tile: Dict[str, float]):
    """((BM, BN, BK), us) of the fastest tile; the earlier candidate (the
    default first) on a tie."""
    name = min(us_by_tile, key=us_by_tile.get)
    bm, bn = (int(v) for v in name.split("x"))
    return (bm, bn, tuning.BK), us_by_tile[name]


def build_table(key: str, timings: Dict[str, dict], meta: dict):
    """The table and the printed rows from per-bucket timings
    ({C: {"up": {tile: us}, "down": {tile: us}}}): each GMM's winner per
    bucket, independently."""
    table = tuning.TuningTable(meta=dict(meta, us_by_tile=timings))
    rows: List[tuple] = []
    for C, t in timings.items():
        up, up_us = winner(t["up"])
        down, down_us = winner(t["down"])
        table.put(key, int(C), up, down, us=up_us + down_us)
        rows.append((key, int(C), str(up), f"{up_us:.1f}", str(down),
                     f"{down_us:.1f}"))
    return table, rows


def run(quick: bool = False, buckets: Optional[Sequence[int]] = None,
        out: str = OUT, device="cuda", seed: int = 0) -> dict:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("tune_superkernel times the Super Kernel's tiles "
                           "on the card; there are no tiles to time on "
                           f"{device}")
    g = geometry()
    E, d, f, L, dtype = (g["n_experts"], g["d_model"], g["d_ff"],
                         g["num_layers"], g["dtype"])
    buckets = list(buckets or (QUICK_BUCKETS if quick else BUCKETS))
    reps = 5 if quick else 20
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    w_up = randn((L, E, d, f), d ** -0.5)
    w_down = randn((L, E, f, d), f ** -0.5)
    lid = torch.tensor([1], dtype=torch.int32, device=device)
    timings: Dict[str, dict] = {}
    for C in buckets:
        timings[str(C)] = {
            "up": _sweep_gmm(w_up, randn((E, C, d)), lid, reps),
            "down": _sweep_gmm(w_down, randn((E, C, f)), lid, reps)}
    meta = dict(
        platform="gpu", device=torch.cuda.get_device_name(device),
        card=card(), buckets=buckets, reps=reps, geometry={
            "arch": ARCH, "n_experts": E, "d_model": d, "d_ff": f,
            "num_layers": L, "dtype": "bfloat16"},
        candidates=[list(b) for b in tuning.candidate_blockings()])
    table, rows = build_table(tuning.config_key(E, d, f, dtype), timings,
                              meta)
    table.save(out)
    return dict(table=table, rows=rows, out=out, timings=timings)


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help=f"two buckets ({QUICK_BUCKETS}), fewer repetitions")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--buckets", default=None,
                    help="comma-separated capacity buckets (powers of two)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    bl = [int(b) for b in args.buckets.split(",")] if args.buckets else None
    r = run(quick=args.quick, buckets=bl, out=args.out, seed=args.seed)
    print(f"== Super Kernel tile sweep on {r['table'].meta['card']} ==")
    head = ("geometry", "C", "up tile", "up us", "down tile", "down us")
    print("  ".join(head))
    for row in r["rows"]:
        print("  ".join(str(v) for v in row))
    print(f"wrote {os.path.relpath(r['out'])}")
    # round trip: the persisted table must give back every winner
    loaded = tuning.TuningTable.load(r["out"])
    for key, C, up, _, down, _ in r["rows"]:
        got = loaded.lookup(key, int(C))
        if got is None or (str(got[0]), str(got[1])) != (up, down):
            raise SystemExit(f"table round trip mismatch at {key} C={C}")
    return r


if __name__ == "__main__":
    main()
