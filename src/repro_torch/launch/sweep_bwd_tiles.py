"""Tile sweep for the flash backward at head dims 192 and 256 on the card.

`wgbw::Tiles<DH>` in `csrc/flash_attention.cu` fixes four numbers a head dim
at compile time: the dK/dV kernel's queries per tile and ring stages, and
the dQ kernel's keys per tile and ring stages.  Each variant below is a copy
of this package whose `.cu` carries other tiles (the exact-byte layout
assert dropped, the shared-memory cap kept), built into its own directory
and run in its own process.  In each it times `flash_attention_bwd` at
deepseek_v32's attention geometry and at gemma3_1b's local and global
layers (device ms over the kernels named `flash_bwd`, by torch.profiler),
after holding it against `attention_bwd_ref` at a small shape of each head
dim.  The variants run in turns (every variant once, then again), so a
card's drift shows as a spread rather than as a ranking.

  PYTHONPATH=src python -m repro_torch.launch.sweep_bwd_tiles
      [--out chiprun_out/bwd_tiles.json]

ptxas's registers and spill bytes of each variant's two wide kernels are
printed beside its times.  There is nothing to build on a CPU: a variant's
process raises there.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import torch

PKG = pathlib.Path(__file__).resolve().parents[1]
ROOT = PKG.parents[1]
WORK = ROOT / "build" / "bwd_tile_sweep"
# name -> {head dim: (dK/dV queries per tile, its stages, dQ keys per tile,
# its stages)}; "kept" is what the .cu ships
VARIANTS = {
    "kept": {192: (64, 3, 64, 2), 256: (64, 2, 32, 3)},
    "kv_q32_at_256": {192: (64, 3, 64, 2), 256: (32, 4, 32, 3)},
    "q_k32_at_192": {192: (64, 3, 32, 4), 256: (64, 2, 32, 3)},
    "kv_q32_at_192": {192: (32, 6, 64, 2), 256: (64, 2, 32, 3)},
}
# name, B, S, H, KVH, dh, causal, window
SHAPES = [
    ("deepseek_v32", 1, 2048, 128, 8, 192, True, None),
    ("gemma3_local", 1, 4096, 4, 1, 256, True, 512),
    ("gemma3_global", 1, 4096, 4, 1, 256, True, None),
]
# each head dim against attention_bwd_ref: ragged S, GQA, a window at 256
CHECKS = [(1, 300, 4, 2, 192, True, None), (1, 300, 4, 1, 256, True, 64)]
TOL = 1e-2  # bf16 relative Frobenius error, chip_smoke.py's BWD_TOL
FIELDS = ("KV_QT", "KV_ST", "Q_KT", "Q_ST")
TURNS = 2
SEED = 0


def with_tiles(src: str, tiles: dict) -> str:
    """The .cu text with `Tiles<DH>`'s four numbers replaced, and the assert
    on the shipped tiles' exact layout sizes dropped."""
    for dh, values in tiles.items():
        head = f"template <> struct Tiles<{dh}> {{"
        start = src.index(head)
        end = src.index("};", start)
        body = src[start:end]
        for field, value in zip(FIELDS, values):
            body, n = re.subn(rf"({field} = )\d+;", rf"\g<1>{value};", body)
            if n != 1:
                raise ValueError(f"Tiles<{dh}>::{field} not found once")
        src = src[:start] + body + src[end:]
    src, n = re.subn(r"static_assert\(SmemKV<192>::BYTES == .*?"
                     r"\"wide backward layouts\"\);\n", "", src, flags=re.S)
    if n != 1:
        raise ValueError("the wide backward's layout assert not found once")
    return src


def stage(name: str) -> pathlib.Path:
    """A copy of the package with variant `name`'s tiles; its `src` dir."""
    src = WORK / name / "src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(PKG, src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = src / "repro_torch" / "csrc" / "flash_attention.cu"
    cu.write_text(with_tiles(cu.read_text(), VARIANTS[name]))
    return src


def _device_ms(fn, reps: int = 10) -> float:
    """Device ms per call of the kernels named flash_bwd, by torch.profiler
    after one warm-up step.  The profiler may lose some of a kernel's
    events, so each kernel counts its mean time per event seen times its
    launches per call (a whole number: every call launches the same
    kernels)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()  # sync-ok: timing harness, off the serving path
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()  # sync-ok: ends the profiler's warm-up step
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()  # sync-ok: ends the timed step
        prof.step()
    ms = sum(e.device_time_total / 1e3 / e.count * max(1, round(e.count
                                                                 / reps))
             for e in prof.key_averages()
             if e.count and e.device_type == torch.autograd.DeviceType.CUDA
             and "flash_bwd" in e.key)
    if ms <= 0:
        raise RuntimeError("the profiler saw no flash_bwd kernel")
    return ms


def _ptxas() -> dict:
    """Registers and spill bytes of the wide kernels in ptxas's report."""
    from repro_torch.kernels import _build
    report = _build.ptxas_report()
    out, fn = {"C7520": "C7520" in report}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        kern = fn and re.search(r"flash_bwd_(dkdv|dq)_wide_kernelILi(\d+)",
                                fn)
        if not kern:
            continue
        key = f"{kern.group(1)}_{kern.group(2)}"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.setdefault(key, {})["spill"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def run_variant() -> dict:
    """In a variant's process: its checks, ptxas figures and times."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_launch)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(B, S, H, KVH, dh):
        return [torch.randn(s, generator=gen, device="cuda").bfloat16()
                for s in ((B, S, H, dh), (B, S, KVH, dh), (B, S, KVH, dh),
                          (B, S, H, dh))]

    rel = []
    for B, S, H, KVH, dh, causal, window in CHECKS:
        q, k, v, do = inputs(B, S, H, KVH, dh)
        kw = dict(causal=causal, window=window, softcap=None)
        o, lse = flash_launch(q, k, v, with_lse=True, **kw)
        before = flash_attention_bwd.launches_by_route["wgmma"]
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        if flash_attention_bwd.launches_by_route["wgmma"] != before + 1:
            raise RuntimeError(f"dh {dh}: the backward left the wgmma route")
        want = attention_bwd_ref(q.float(), k.float(), v.float(), o.float(),
                                 lse, do.float(), **kw)
        rel.append(max(float((a.float() - b).norm() / b.norm())
                       for a, b in zip(got, want)))
    if max(rel) > TOL:
        raise RuntimeError(f"relative error {rel} > {TOL}")
    ms = {}
    for name, B, S, H, KVH, dh, causal, window in SHAPES:
        q, k, v, do = inputs(B, S, H, KVH, dh)
        kw = dict(causal=causal, window=window, softcap=None)
        o, lse = flash_launch(q, k, v, with_lse=True, **kw)
        ms[name] = _device_ms(
            lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw))
        del q, k, v, do, o, lse
    return {"max_rel_err": max(rel), "ptxas": _ptxas(), "device_ms": ms}


def card() -> str:
    """The card as `nvidia-smi --query-gpu=name,power.limit` gives it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "bwd_tiles.json"))
    ap.add_argument("--in-variant", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.in_variant:  # a variant's own process, in its copy
        print(json.dumps(run_variant()))
        return 0
    if not torch.cuda.is_available():
        print("sweep_bwd_tiles: no CUDA device", file=sys.stderr)
        return 1
    srcs = {name: stage(name) for name in VARIANTS}
    runs = {name: [] for name in VARIANTS}
    for turn in range(TURNS):
        for name, src in srcs.items():
            env = dict(os.environ, PYTHONPATH=str(src),
                       REPRO_TORCH_BUILD_DIR=str(src.parent / "build"))
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.sweep_bwd_tiles",
                 "--in-variant"],
                env=env, capture_output=True, text=True, cwd=src.parent)
            if out.returncode != 0:
                raise RuntimeError(f"variant {name}: {out.stderr[-4000:]}")
            runs[name].append(json.loads(out.stdout.splitlines()[-1]))
            print(f"turn {turn} {name} {VARIANTS[name]}: "
                  f"{runs[name][-1]['device_ms']} "
                  f"ptxas {runs[name][-1]['ptxas']}", flush=True)
    result = {"card": card(), "shapes": SHAPES,
              "variants": {n: {"tiles": VARIANTS[n], "runs": runs[n]}
                           for n in VARIANTS}}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(result["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
