#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the GPU.

    python3 chip_smoke.py            # all phases, one NVIDIA H100

Phases (each prints its own lines; any failure is a non-zero exit):

  device    card name and power limit, as nvidia-smi gives them
  build     nvcc builds the kernel library from src/repro_torch/csrc
  kernels   super_gmm and flash_attention against their plain PyTorch
            versions on the card: main-path shapes (bf16) and edge shapes
            (fp32, C=192, S=192, window, softcap, every layer id from one
            launch signature with no host sync between launches)
  executor  DisaggregatedExecutor output against the port's own
            lm_backbone(moe_mode="dense") on the card, one small batch at the
            full width of qwen3_moe_235b_a22b
  serve     ExecutorEngine serves 8 requests of 256-2048 tokens at full
            width, bf16, depth cut to 4 layers; launch counts are set to 0
            just before and read just after
  timing    each kernel timed at the shapes the serve phase gave it, beside
            its bound, its plain version and one library call (library_ms is
            a yardstick timed here and used nowhere in the port)
  profile   (only with --phases ...,profile) the served requests once more
            under torch.profiler: device time by kernel, busy share

Without a CUDA device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build, _launch
from repro_torch.kernels.flash_attention.flash_attention import (
    attention_ref, flash_attention)
from repro_torch.kernels.flash_attention.ops import _expand_kv, mha_flash
from repro_torch.kernels.super_gmm.ops import (pack_capacity,
                                               pack_capacity_multi,
                                               super_moe_ffn, unpack_capacity,
                                               unpack_capacity_multi)
from repro_torch.kernels.super_gmm.ref import super_moe_ffn_ref
from repro_torch.kernels.super_gmm.super_gmm import super_gmm, super_gmm_ref
from repro_torch.models.common import act_fn

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

DEV = "cuda"
ARCH = "qwen3_moe_235b_a22b"
SERVE_LAYERS = 4  # the one cut: depth 94 -> 4, every width as published


class Failed(RuntimeError):
    pass


def expect(cond: bool, what: str):
    if not cond:
        raise Failed(what)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of one call in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------- phases --


def phase_device() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {out}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    return out


def phase_build(verbose: bool):
    t0 = time.time()
    _build.load(verbose=verbose)
    srcs = [s.name for s in _build.sources()]
    print(f"[build] {srcs} -> {_build.build_dir()} in "
          f"{time.time() - t0:.1f}s")


def _gmm_inputs(gen, L, E, C, K, N, dtype):
    w = (torch.randn((L, E, K, N), generator=gen, device=DEV)
         / K ** 0.5).to(dtype)
    x = torch.randn((E, C, K), generator=gen, device=DEV).to(dtype)
    return w, x


def check_super_gmm(gen) -> float:
    """Edge shapes in fp32 and bf16, then the main-path shapes in bf16.
    Returns the max abs error at the main-path shapes."""
    # every layer id through ONE launch signature, no host sync in between
    L, E, C, K, N = 3, 4, 192, 128, 64
    w, x = _gmm_inputs(gen, L, E, C, K, N, torch.float32)
    lids = torch.arange(L, dtype=torch.int32, device=DEV)
    syncs_before = _launch.host_syncs
    outs = [super_gmm(lids[l:l + 1], w, x) for l in range(L)]
    expect(_launch.host_syncs == syncs_before,
           "a host sync between super_gmm launches")
    torch.cuda.synchronize()
    for l in range(L):
        ref = super_gmm_ref(lids[l:l + 1], w, x)
        err = max_err(outs[l], ref)
        expect(err <= 1e-5, f"super_gmm fp32 C=192 layer {l}: err {err}")
    expect(not torch.equal(outs[0], outs[1]), "layer id ignored")
    print(f"[kernels] super_gmm fp32 L={L} E={E} C={C} K={K} N={N}: every "
          f"layer id from one launch signature, tol 1e-5 ok")
    # ragged edges: C=8, K and N off the tile and off the 16-byte chunk
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-3)):
        for (E, C, K, N) in ((4, 8, 128, 64), (3, 70, 72, 40),
                             (2, 5, 68, 36), (2, 130, 100, 200)):
            w, x = _gmm_inputs(gen, 2, E, C, K, N, dtype)
            lid = torch.tensor([1], dtype=torch.int32, device=DEV)
            err = max_err(super_gmm(lid, w, x), super_gmm_ref(lid, w, x))
            expect(err <= tol, f"super_gmm {dtype} E={E} C={C} K={K} N={N}: "
                   f"err {err} > {tol}")
    print("[kernels] super_gmm ragged C/K/N edges fp32 (tol 1e-5) and bf16 "
          "(tol 2e-3) ok")
    # per-expert row counts: rows beyond counts[e] are padding -> zeros, also
    # where x holds something there; counts of 0 and above C included
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-3)):
        E, C, K, N = 6, 200, 128, 192
        w, x = _gmm_inputs(gen, 2, E, C, K, N, dtype)
        counts = torch.tensor([0, 1, 64, 65, 200, 999], dtype=torch.int32,
                              device=DEV)
        lid = torch.tensor([0], dtype=torch.int32, device=DEV)
        got = super_gmm(lid, w, x, counts)
        err = max_err(got, super_gmm_ref(lid, w, x, counts))
        expect(err <= tol, f"super_gmm {dtype} with counts: err {err}")
        expect(float(got[0].abs().max()) == 0.0
               and float(got[2, 64:].abs().max()) == 0.0
               and float(got[2, :64].abs().max()) > 0.0,
               "super_gmm: padding rows are not zero")
    print("[kernels] super_gmm with per-expert row counts (0, 1, 64, 65, C, "
          ">C): padding rows zero, real rows vs plain ok")
    # merged capacity buffer == per-region, bitwise (bf16, tensor cores)
    cfg = get_config(ARCH).smoke().replace(dtype=torch.bfloat16)
    n_e, d, f = 4, cfg.d_model, cfg.expert_d_ff
    experts = {
        "w_gate": _gmm_inputs(gen, 2, n_e, 1, d, f, torch.bfloat16)[0],
        "w_up": _gmm_inputs(gen, 2, n_e, 1, d, f, torch.bfloat16)[0],
        "w_down": _gmm_inputs(gen, 2, n_e, 1, f, d, torch.bfloat16)[0]}
    lid = torch.tensor([1], dtype=torch.int32, device=DEV)
    sizes = [5, 1, 300, 3]
    toks = [torch.randn((n, d), generator=gen, device=DEV).bfloat16()
            for n in sizes]
    eids = [torch.randint(0, n_e, (n,), generator=gen, device=DEV)
            for n in sizes]
    def counts_of(e):
        return torch.bincount(e, minlength=n_e).to(torch.int32)

    xb, order, slots, C, bounds = pack_capacity_multi(toks, eids, n_e)
    merged = unpack_capacity_multi(
        super_moe_ffn(lid, experts, xb, cfg, counts_of(torch.cat(eids))),
        order, slots, bounds)
    for r, (t, e) in enumerate(zip(toks, eids)):
        for cap in (C, None):
            for cnt in (counts_of(e), None):
                xb1, o1, s1, _ = pack_capacity(t, e, n_e, capacity=cap)
                one = unpack_capacity(
                    super_moe_ffn(lid, experts, xb1, cfg, cnt), o1, s1,
                    len(t))
                expect(torch.equal(merged[r], one),
                       f"merged != per-region bitwise (region {r}, cap "
                       f"{cap}, counts {cnt is not None})")
    ref = super_moe_ffn_ref(lid, experts, xb, act_fn(cfg.act))
    err = max_err(super_moe_ffn(lid, experts, xb, cfg), ref)
    expect(err <= 2e-2, f"super_moe_ffn bf16 vs plain: err {err}")
    print(f"[kernels] super_moe_ffn merged == per-region bitwise on the card "
          f"(bf16); vs plain err {err:.2e} (tol 2e-2)")
    # main-path shapes: one MoE device of qwen3 (32 experts), gate/up + down
    full = get_config(ARCH)
    worst = 0.0
    for (K, N) in ((full.d_model, full.expert_d_ff),
                   (full.expert_d_ff, full.d_model)):
        for C in (8, 64, 512):
            w, x = _gmm_inputs(gen, 2, 32, C, K, N, torch.bfloat16)
            err = max_err(super_gmm(lid, w, x), super_gmm_ref(lid, w, x))
            expect(err <= 2e-3, f"super_gmm bf16 main C={C} K={K} N={N}: "
                   f"err {err}")
            worst = max(worst, err)
            del w, x
    print(f"[kernels] super_gmm bf16 main-path shapes n_e=32 C in (8,64,512) "
          f"K/N {full.d_model}/{full.expert_d_ff}: max err {worst:.2e} "
          f"(tol 2e-3) ok")
    return worst


def check_flash_attention(gen) -> float:
    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)

    cases = [dict(causal=True), dict(causal=True, window=24),
             dict(causal=True, softcap=30.0),
             dict(causal=True, window=7, softcap=20.0), dict(causal=False)]
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 4e-2)):
        for dh in (32, 64, 128):
            for S in (192, 50, 257):
                q, k, v = (rnd((3, S, dh), dtype) for _ in range(3))
                for kw in cases:
                    err = max_err(flash_attention(q, k, v, **kw),
                                  attention_ref(q, k, v, **kw))
                    expect(err <= tol, f"flash_attention {dtype} dh={dh} "
                           f"S={S} {kw}: err {err} > {tol}")
    print("[kernels] flash_attention [BH,S,dh] S in (192,50,257) dh in "
          "(32,64,128), causal/window/softcap/non-causal: fp32 tol 2e-5, "
          "bf16 tol 4e-2 ok")
    # model layout + GQA, the KV head indexed in the kernel
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 4e-2)):
        q = rnd((2, 192, 8, 32), dtype)
        k, v = rnd((2, 192, 2, 32), dtype), rnd((2, 192, 2, 32), dtype)
        got = mha_flash(q, k, v, window=40)
        ref = mha_flash(q.cpu(), k.cpu(), v.cpu(), window=40).to(DEV)
        err = max_err(got, ref)
        expect(err <= tol, f"mha_flash GQA {dtype}: err {err} > {tol}")
    try:
        flash_attention(rnd((1, 8, 48), torch.float32),
                        rnd((1, 8, 48), torch.float32),
                        rnd((1, 8, 48), torch.float32))
    except ValueError:
        pass
    else:
        raise Failed("flash_attention took a head dim it has no kernel for")
    print("[kernels] mha_flash [B,S,H,dh] GQA ok; unsupported head dim "
          "raises")
    # main-path shape: qwen3 heads, bf16
    full = get_config(ARCH)
    worst = 0.0
    for (B, S) in ((1, 256), (2, 1024)):
        q = rnd((B, S, full.num_heads, full.head_dim), torch.bfloat16)
        k = rnd((B, S, full.num_kv_heads, full.head_dim), torch.bfloat16)
        v = rnd((B, S, full.num_kv_heads, full.head_dim), torch.bfloat16)
        err = max_err(mha_flash(q, k, v), _mha_plain(q, k, v))
        expect(err <= 4e-2, f"mha_flash bf16 main B={B} S={S}: err {err}")
        worst = max(worst, err)
    print(f"[kernels] mha_flash bf16 main-path shape H={full.num_heads} "
          f"KVH={full.num_kv_heads} dh={full.head_dim}: max err {worst:.2e} "
          f"(tol 4e-2) ok")
    return worst


def _mha_plain(q, k, v):
    """The plain version of mha_flash, run on the card."""
    B, S, H, dh = q.shape

    def to_bh(x):
        return _expand_kv(x, H).permute(0, 2, 1, 3).reshape(B * H, S, dh)

    o = attention_ref(to_bh(q), to_bh(k), to_bh(v))
    return o.reshape(B, H, S, dh).permute(0, 2, 1, 3)


def phase_kernels(gen) -> dict:
    errs = {"super_gmm": check_super_gmm(gen),
            "flash_attention": check_flash_attention(gen)}
    torch.cuda.synchronize()
    return errs


def build_model(layers: int, seed: int):
    from repro_torch.models.lm import init_lm_params
    cfg = get_config(ARCH).replace(num_layers=layers)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    t0 = time.time()
    params = init_lm_params(gen, cfg, DEV)
    torch.cuda.synchronize()
    print(f"[model] {cfg.name} full width, {layers} layers, bf16: "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB in "
          f"{time.time() - t0:.1f}s")
    return cfg, params


def _executor_vs_oracle(cfg, params, B, S):
    """Run 2 jobs through DisaggregatedExecutor(D=2, E=4) and the port's own
    dense oracle; returns (max abs err, relative Frobenius err)."""
    from repro_torch.core.executor import BatchJob, DisaggregatedExecutor
    from repro_torch.models.lm import lm_backbone
    rng = np.random.RandomState(0)
    jobs = [BatchJob(tokens=rng.randint(0, cfg.vocab_size, (B, S)), bid=i)
            for i in range(2)]
    ex = DisaggregatedExecutor(params, cfg, D=2, E=4, device=DEV)
    done = ex.run([jobs[:1], jobs[1:]])
    torch.cuda.synchronize()
    worst, num, den = 0.0, 0.0, 0.0
    with torch.inference_mode():
        for j in done:
            ref, _ = lm_backbone(
                params, cfg, torch.as_tensor(j.tokens, device=DEV),
                moe_mode="dense", use_dense=True)
            expect(tuple(j.result.shape) == tuple(ref.shape), "shape")
            expect(bool(torch.isfinite(j.result.float()).all()),
                   "executor output not finite")
            diff = j.result.float() - ref.float()
            worst = max(worst, float(diff.abs().max()))
            num += float(diff.square().sum())
            den += float(ref.float().square().sum())
    return worst, (num / den) ** 0.5


def phase_executor(cfg, params):
    """Executor vs the port's own dense oracle on the card: exactly, in fp32
    at the small config (both kernels' fp32 paths); then one small batch at
    full width in bf16."""
    from repro_torch.models.lm import init_lm_params
    small = get_config(ARCH).smoke().replace(num_layers=3)
    gen = torch.Generator(device=DEV).manual_seed(1)
    worst, rel = _executor_vs_oracle(small, init_lm_params(gen, small, DEV),
                                     2, 48)
    # fp32 end to end; the two paths sum the same terms in another order
    expect(worst <= 2e-4, f"executor vs dense oracle (fp32): err {worst}")
    print(f"[executor] fp32 {small.num_layers}L x {small.num_experts}e "
          f"d_model={small.d_model}: D=2 E=4 vs lm_backbone(moe_mode="
          f"'dense'): max err {worst:.2e} (tol 2e-4)")
    worst, rel = _executor_vs_oracle(cfg, params, 2, 64)
    # bf16 end to end: the two paths round at different places, and a token
    # whose top-k boundary is a near-tie may change experts in a later layer,
    # so the bound is on the relative Frobenius error, not the worst element
    # (a wrong expert or a lost row would put it near 1)
    expect(rel <= 0.1, f"executor vs dense oracle (bf16): rel err {rel}")
    print(f"[executor] bf16 full width {cfg.num_layers}L: D=2 E=4, 2 jobs of "
          f"[2, 64] tokens vs lm_backbone(moe_mode='dense'): relative "
          f"Frobenius err {rel:.3e} (tol 1e-1), max abs err {worst:.3e}")


def phase_serve(cfg, params, seed: int) -> dict:
    from repro_torch.launch.serve import serve_requests
    rng = np.random.default_rng(seed)
    lengths = [int(x) for x in rng.integers(256, 2049, size=8)]
    kw = dict(rps=8.0, time_scale=1.0, seed=seed, device=DEV,
              max_batch_tokens=4096)
    # set-up, not counted: one wave through the long-lived executor that
    # then serves, so that every worker thread has made its first calls into
    # cuBLAS and the caching allocator on its own stream
    ex = serve_requests(cfg, params, lengths=[1900, 1500, 700, 900, 300, 400],
                        **kw)["executor"]
    kw["executor"] = ex
    torch.cuda.synchronize()
    super_gmm.launches = 0
    flash_attention.launches = 0
    _launch.reset_host_syncs()
    torch.cuda.reset_peak_memory_stats()
    ms = torch.cuda.memory_stats()
    alloc0 = (ms["num_device_alloc"], ms["num_device_free"],
              ms["num_alloc_retries"])
    out = serve_requests(cfg, params, lengths=lengths, verbose=True, **kw)
    torch.cuda.synchronize()
    launches = {"super_gmm": super_gmm.launches,
                "flash_attention": flash_attention.launches}
    syncs = _launch.reset_host_syncs()
    results, st = out["results"], out["stats"]
    expect(len(results) == 8 and all(r.ok for r in results),
           "serve: not every request ok")
    expect(all(r.first_token is not None
               and 0 <= r.first_token < cfg.vocab_size for r in results),
           "serve: bad first token")
    expect(launches["super_gmm"] > 0 and launches["flash_attention"] > 0,
           f"serve: a kernel was never launched: {launches}")
    tokens = sum(lengths)
    batch_layers = out["batch_layers"]
    decomp = {k: float(np.mean([r.decomposition[k] for r in results]))
              for k in results[0].decomposition}
    print(f"[serve] 8 requests, lengths {lengths} ({tokens} tokens), "
          f"{cfg.num_layers} layers, D=2 E=4, arrivals at 8 req/s (last at "
          f"{out['arrivals'][-1]:.2f}s): all ok in {out['wall']:.2f}s wall "
          f"-> {tokens / out['wall']:.0f} tokens/s, mean TTFT "
          f"{np.mean([r.ttft for r in results]):.3f}s, max TTFT "
          f"{np.max([r.ttft for r in results]):.3f}s")
    print("[serve] mean TTFT split (s): "
          + " ".join(f"{k}={v:.3f}" for k, v in decomp.items())
          + f"; MoE device util {np.round(st.moe_device_util, 2).tolist()}, "
          f"attention group util {np.round(st.group_util, 2).tolist()}, "
          f"capacity occupancy {st.moe_batch_occupancy:.2f}, buckets "
          f"{st.bucket_hits} hit / {st.bucket_misses} new")
    ms = torch.cuda.memory_stats()
    print(f"[serve] allocator: peak reserved "
          f"{ms['reserved_bytes.all.peak'] / 1e9:.1f} GB, cudaMalloc calls "
          f"{ms['num_device_alloc'] - alloc0[0]}, cudaFree calls "
          f"{ms['num_device_free'] - alloc0[1]}, allocation retries "
          f"{ms['num_alloc_retries'] - alloc0[2]} during the served run")
    print(f"[serve] launches {launches}; host syncs {syncs} over "
          f"{batch_layers} batch-layers = "
          f"{syncs / max(batch_layers, 1):.2f} per batch-layer (1 read of "
          f"the router ids per batch-layer on the attention side, 1 stream "
          f"wait per non-empty region on the MoE side, 2 per job); peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    # the timed arrivals bound the wall time from below; the same requests
    # arriving at once say what the pipeline sustains (not counted above)
    burst = serve_requests(cfg, params, lengths=lengths,
                           **{**kw, "rps": 1e6})
    expect(len(burst["results"]) == 8
           and all(r.ok for r in burst["results"]), "burst: not all ok")
    print(f"[serve] burst (the same 8 requests arriving at once): "
          f"{burst['wall']:.2f}s wall -> {tokens / burst['wall']:.0f} "
          f"tokens/s, mean TTFT "
          f"{np.mean([r.ttft for r in burst['results']]):.3f}s, MoE device "
          f"util {np.round(burst['stats'].moe_device_util, 2).tolist()}, "
          f"attention group util "
          f"{np.round(burst['stats'].group_util, 2).tolist()}")
    expect(not ex.errors, "executor worker failed")
    return {"launches": launches, "shapes": out["shapes"],
            "buckets": out["buckets"], "counts": out["counts"],
            "lengths": lengths, "kw": kw}


def phase_profile(cfg, params, serve: dict, trace_out):
    """Not in the default run: the same 8 requests once more under
    torch.profiler -- device time by kernel and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import serve_requests
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = serve_requests(cfg, params, lengths=serve["lengths"],
                             **serve["kw"])
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    print(f"[profile] wall {out['wall']:.2f}s; device time summed over "
          f"kernels {total:.1f} ms = {total / 1e3 / out['wall']:.1%} of the "
          f"wall time (streams overlap, so this is an upper bound of the "
          f"busy share)")
    for key, ms, count in rows[:14]:
        print(f"[profile] {ms:9.2f} ms {count:6d}x  {key[:90]}")
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])
    for key, ms, count in host[:10]:
        print(f"[profile] host self time {ms:9.2f} ms {count:6d}x  "
              f"{key[:70]}")
    if trace_out:
        os.makedirs(os.path.dirname(os.path.abspath(trace_out)),
                    exist_ok=True)
        prof.export_chrome_trace(trace_out)


def phase_timing(serve: dict, errs: dict, gen) -> dict:
    """Each kernel at the shape the serve phase launched it with most."""
    full = get_config(ARCH)
    bf = torch.bfloat16
    # ---- super_gmm: modal capacity bucket, gate/up projection ----------
    (n_e, C), _ = collections.Counter(serve["buckets"]).most_common(1)[0]
    # of the launches in that bucket, the one with the median row total
    same = sorted((c for b, c in zip(serve["buckets"], serve["counts"])
                   if b == (n_e, C)), key=sum)
    cnt = same[len(same) // 2]
    counts = torch.tensor(cnt, dtype=torch.int32, device=DEV)
    K, N = full.d_model, full.expert_d_ff
    w, x = _gmm_inputs(gen, SERVE_LAYERS, n_e, C, K, N, bf)
    x = x * (torch.arange(C, device=DEV)[None, :, None]
             < counts[:, None, None])  # as pack_capacity leaves it
    lid = torch.tensor([1], dtype=torch.int32, device=DEV)
    gmm_ms = cuda_ms(lambda: super_gmm(lid, w, x, counts))
    gmm_dense = cuda_ms(lambda: super_gmm(lid, w, x))
    gmm_plain = cuda_ms(lambda: super_gmm_ref(lid, w, x, counts), iters=3,
                        warmup=1)
    gmm_lib = cuda_ms(lambda: torch.bmm(x, w[1]))
    # what this launch's data needs: the rows that exist, the weights of the
    # experts that have any, the whole output written once
    real = sum(min(c, C) for c in cnt)
    used = sum(1 for c in cnt if c > 0)
    nbytes = 2 * (used * K * N + real * K) + 4 * n_e * C * N
    ops = 2.0 * real * K * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[bf]
    gmm = {"name": "super_gmm", "route": "cuda",
           "source": "src/repro_torch/csrc/super_gmm.cu",
           "replaces": "src/repro/kernels/super_gmm/super_gmm.py:68",
           "launches": serve["launches"]["super_gmm"],
           "max_abs_err": errs["super_gmm"], "ms": gmm_ms,
           "plain_ms": gmm_plain, "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": gmm_lib,
           "ms_without_counts": gmm_dense,
           "shape": {"n_e": n_e, "C": C, "K": K, "N": N, "dtype": "bf16",
                     "real_rows": real, "experts_with_rows": used}}
    del w, x
    # ---- flash_attention: modal (B, S) of the served batches -----------
    (B, S), _ = collections.Counter(serve["shapes"]).most_common(1)[0]
    H, KVH, dh = full.num_heads, full.num_kv_heads, full.head_dim
    q = torch.randn((B, S, H, dh), generator=gen, device=DEV).to(bf)
    k = torch.randn((B, S, KVH, dh), generator=gen, device=DEV).to(bf)
    v = torch.randn((B, S, KVH, dh), generator=gen, device=DEV).to(bf)
    fa_ms = cuda_ms(lambda: mha_flash(q, k, v))
    fa_plain = cuda_ms(lambda: _mha_plain(q, k, v), iters=3, warmup=1)
    qh, kh, vh = (_expand_kv(t, H).permute(0, 2, 1, 3).contiguous()
                  for t in (q, k, v))
    fa_lib = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True))
    nbytes = 2 * (2 * B * S * H * dh + 2 * B * S * KVH * dh)
    ops = 4.0 * B * H * S * S * dh / 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[bf]
    fa = {"name": "flash_attention", "route": "cuda",
          "source": "src/repro_torch/csrc/flash_attention.cu",
          "replaces":
              "src/repro/kernels/flash_attention/flash_attention.py:97",
          "launches": serve["launches"]["flash_attention"],
          "max_abs_err": errs["flash_attention"], "ms": fa_ms,
          "plain_ms": fa_plain, "bound_ms": 1e3 * max(t_bytes, t_ops),
          "bound_by": "bytes" if t_bytes >= t_ops else "operations",
          "library_ms": fa_lib,
          "shape": {"B": B, "S": S, "H": H, "KVH": KVH, "dh": dh,
                    "dtype": "bf16", "causal": True}}
    return {"kernels": [gmm, fa]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="device,build,kernels,executor,"
                    "serve,timing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="profile phase: also write the chrome trace here")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's -Xptxas -v output")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device -- this script measures on the "
              "card and does not fall back to the CPU", file=sys.stderr)
        return 1
    phases = args.phases.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    card = phase_device()
    if "build" in phases:
        phase_build(args.verbose_build)
    errs = phase_kernels(gen) if "kernels" in phases else None
    serve = None
    if "executor" in phases or "serve" in phases:
        cfg, params = build_model(SERVE_LAYERS, args.seed)
        if "executor" in phases:
            phase_executor(cfg, params)
            gc.collect()  # the executors' resident stacks go before serving
            torch.cuda.empty_cache()
        if "serve" in phases:
            serve = phase_serve(cfg, params, args.seed)
        if "profile" in phases:
            expect(serve is not None, "profile needs the serve phase")
            phase_profile(cfg, params, serve, args.trace_out)
        del params
        torch.cuda.empty_cache()
    if "timing" in phases:
        expect(serve is not None and errs is not None,
               "timing needs the kernels and serve phases")
        print(json.dumps(phase_timing(serve, errs, gen)))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
