#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the GPU.

    python3 chip_smoke.py            # all phases, one NVIDIA H100

Phases (each prints its own lines; any failure is a non-zero exit):

  device    card name and power limit, as nvidia-smi gives them
  build     nvcc builds the kernel library from src/repro_torch/csrc
  kernels   super_gmm, flash_attention, dispatch_scatter and
            combine_gather against their plain PyTorch versions on the
            card: main-path shapes (bf16) and edge shapes (fp32, C=192,
            S=192, window, softcap, head dims 192 and 256 in GQA model
            layout (S 192/2047, window 512/16, softcap, bf16 on the
            wide-head wgmma kernel twice torch.equal and its lse against
            the plain one, unaligned bases on wmma), every layer
            id from one launch signature
            with no host sync between launches; d=16/4100, N=0/1, every
            pair dropped, unaligned bases); the decode MoE layer's routes:
            dispatch_scatter "whole" torch.equal to moe_dispatch on every
            output (decode shape, T=1, one hot expert, the rank chunk's
            edges, N > 4096, E=256, strided x), combine_gather "weighted"
            bitwise equal to its plain version and within 1 bf16 ulp / 1e-6
            of moe_combine, and kernel_moe_dispatch/combine with no host
            sync
  executor  DisaggregatedExecutor output against the port's own
            lm_backbone(moe_mode="dense") on the card, one small batch at the
            full width of qwen3_moe_235b_a22b
  serve     ExecutorEngine serves 8 requests of 256-2048 tokens at full
            width, bf16, depth cut to 4 layers; launch counts are set to 0
            just before and read just after
  pd        prefill->decode: first a teacher-forced check in fp32 at the
            small config (every generated token == the argmax of the dense
            lm_forward over prompt + tokens so far), then a PD wave at full
            width through the serve phase's executor (emit_kv): 8 requests,
            out_len lognormal mean 16 cv 0.5 capped at 64, decode width 8
            over a 2112-token cache, KV handoff priced on the H100 link;
            counts of all four kernels set to 0 just before, read just after
  analysis  the port's asaplint (`repro_torch.analysis`) on this checkout's
            src/repro_torch with stale suppressions failing: no
            unsuppressed finding; every `extern "C"` launch function the
            launch-contract pass parsed from csrc/*.cu is a symbol of the
            library just built, with as many `argtypes` as C parameters,
            each of the mapped type, and restype c_int; ptxas's report:
            every kernel's registers and spill bytes, no C7520 warning
            anywhere and 0 spill bytes in the wgmma kernels; then (after
            the serve executor is released) the serve wave -- the serve
            phase's model, requests and set-up wave -- with the port's
            runtime lockdep installed before the executor and engine are
            built, raising at any violation: 8/8 served, no violation,
            super_gmm and flash_attention launched inside it (all wgmma),
            its wall time and learned lock-order edges beside the serve
            phase's wall.  `--phases device,build,analysis` runs it alone
  batching  (after the serve and pd executors are released) continuous
            MoE batching at full width: 8 pinned jobs of 256 tokens through
            a per-region and a batched executor (D=4 E=4, window 10 ms),
            torch.equal, regions/launch > 1, every super_gmm launch on
            wgmma, 0 bucket misses after prewarm; the light-load arm (D=8
            groups of 64-256-token prompts, E=2, window 2 ms) per-region vs
            batched in interleaved turns, best of 3: tokens/s, host syncs per
            batch-layer, launches, regions/launch, occupancy, peak reserved
            memory (reported, not gated); the eager and host-combine
            baselines vs the dense oracle in fp32 (tol 2e-4), host combine
            torch.equal device combine, fused vs eager tokens/s at full width
  gmm       lm_forward(gmm=make_super_kernel_gmm(...)): fp32 at the
            reference's test config vs the einsum path (tol 2e-4); full
            width on tokens [1, 2048] vs default_gmm (relative Frobenius
            error of the logits, tol 1e-1) with super_gmm 3, dispatch
            "whole" 1 and combine "weighted" 1 launch per layer; the "whole"
            dispatch at that N (16384 pairs) timed against the TPU-signature
            zero fill + "scatter"
  faults    supervised failover at the serve phase's full width, each arm
            on a fresh DisaggregatedExecutor(D=2, E=4) released after it:
            8 pinned jobs of [1, 512] fault-free (wall W), then MoE device 1
            crashed at 0.3 W (per-region, and batched with a 2 ms window),
            device 0 dropping a combine (region_timeout 2 s) and device 0
            stalled (stall_timeout 0.5 s) -- every output torch.equal to the
            fault-free wave, one failover where a device died, every
            super_gmm / flash_attention launch on wgmma, the kernel library
            not rebuilt; the failover's wall time, the swap's seconds, the
            bytes its gathers moved against the HBM bound, new bucket misses
            and memory before and after; then the serve wave through
            ExecutorEngine with device 1 crashed at 0.5 s of trace: 8/8 ok,
            one failover, TTFT beside the fault-free serve phase's.
            `--phases device,build,faults` runs it alone
  rebalance live re-placement under skewed routing at the same width: the
            fields of cost_model.H100 measured on this card beside the
            preset; the router of a shallow copy of the model zipf(2.0)-
            skewed onto device 0's round-robin experts; two arms, each a
            fresh DisaggregatedExecutor(D=2, E=4) released after it --
            frozen round-robin, and live (ExecutorEngine with
            rebalance_interval 0.25, threshold 1.02, target replicated(2),
            TraceClock speed 1000): two warm waves of 4 x 512 tokens and a
            measured wave of 10 x 512, all arriving at 0, then 8 pinned
            jobs of [1, 512]; gated: >= 1 live migration to "replicated",
            every request ok exactly once, the table ExpertLoadModel gives,
            first tokens equal rid by rid and pinned jobs torch.equal
            between the arms, wgmma only, no rebuild; tokens/s, the window
            that fired, the swap's seconds and gather rate, bucket misses,
            memory (a {"rebalance": ...} line).
            `--phases device,build,rebalance` runs it alone
  tuning    the Super Kernel's (BM, BN) tiles and the tuning table at the
            serve configuration's MoE device (32 experts, d 4096, f 1536,
            bf16, L 4): every tile torch.equal to the default 128x256 and
            within 2e-3 of the plain version (gate/up and down, the serve
            wave's counts and dense, C 8 and 512); the quick sweep's table
            saved, reloaded and every winner looked up again, and the full
            sweep (per-tile us per bucket, a reading); the serve wave's
            prompts as pinned jobs untuned and under a table naming
            non-default tiles per bucket: torch.equal, launches_by_tile ==
            what the table gives the wave's buckets; merged == per-region
            torch.equal under a table giving the per-region buckets and the
            merged bucket different tiles; untuned vs the sweep's table
            tokens/s of the serve wave as a burst in interleaved turns, best
            of 3 (a reading, not gated); one {"tuning": ...} line.
            `--phases device,build,tuning` runs it alone
  examples  (after the qwen3 model is released) the examples' twins, each
            in its own process on the card: torch_quickstart (its
            super-kernel vs einsum max err within 2e-3), torch_serve_asap
            (10/10 completed), torch_imbalance_demo, torch_train_moe (50
            steps, a failure injected at 25 and recovered from, the loss
            improves, both backward kernels launch); each must exit 0; their
            kernel launches by route are a reading (one {"examples": ...}
            line).  `--phases device,build,examples` runs it alone
  train     (after the qwen3 model is released) training on the card:
            (a) first, the wgmma launches on threads with no current CUDA
            context (a remat recompute of the wgmma flash forward at dh 256
            and 128 as the first op of the autograd thread, gradients
            torch.equal to no remat; the flash forward at dh 128 and 256,
            its backward and super_gmm each alone on a new thread,
            torch.equal); then
            flash_attention_bwd against attention_bwd_ref --
            FLASH_BWD_CASES: the main-path shape (bf16, B 1, S 2048, H 64,
            KVH 4, dh 128, causal), fp32, S 192, window 512 and 16,
            softcap, dh 64, non-causal, an unaligned base, strided q/k/v,
            fp32 dh 32, gemma3_1b's local layer (dh 256, S 4096, H 4, KVH
            1, window 512) and its global layer (no window), dh 256 at a ragged S 1000, deepseek_v32's
            geometry (dh 192, S 2048, H 128, KVH 8), fp32 dh 192 and 256,
            no GQA (H = KVH 8), dh 192 and 256 at unaligned bases, dh 192
            strided, dh 256 with a softcap and a window, dh 192 at S 129
            (the scratch rows' PAD edge) and non-causal with a window --
            dq/dk/dv relative error within BWD_TOL, two runs torch.equal,
            each on the route it must take (bf16 at dh 64/128/192/256 in
            model layout, strided included, on "wgmma"; unaligned on
            "wmma"; fp32 on "fma"), the
            forward's o torch.equal with and without its lse and within
            the kernels phase's bars of the plain forward's at every case's
            shape, head dim 16 raising; combine_weighted_bwd at the full-width shape, dyb
            bitwise and dw within DW_TOL, deterministic; the dispatch's
            backward at E 128 ("whole") and 1117 ("scatter") torch.equal
            to the plain version; (b) one train step at the small fp32
            config on the card against the CPU's (every leaf's gradient
            present and non-zero, within STEP_GRAD_TOL); (d) a
            ResilientTrainer run with a failure at step 3 of 6 torch.equal
            to an uninterrupted one; (c) qwen3_moe_235b_a22b at published
            width, depth 1, bf16: 4 build_train_step steps on one [1, 2048]
            batch, then gemma3_1b at published width and all 26 layers on
            one [1, 4096] batch (loss falls, finite, every leaf a non-zero
            gradient, one flash_attention_bwd per attention layer and step
            on "wgmma" for both -- gemma3's head dim 256 on the wide-head
            backward kernels --, every flash forward -- remat's recompute
            included -- on "wgmma" for both, no
            host sync for gemma3; per step the launches, host syncs,
            forward / backward / optimizer ms, tokens/s, peak memory, model
            FLOPs share); the backward kernels timed at those steps'
            inputs, flash_attention_bwd at gemma3's global-layer shape
            and at deepseek_v32's geometry, each beside its bound, its
            plain version and SDPA's backward on expanded heads (the
            backend that ran named) (a {"train": ...} line).  `--phases device,build,train` runs it alone
  spmd      the mesh steps on one card: a one-rank NCCL process group
            (rendezvous through a FileStore under build/), the (1, 1)
            (data, model) mesh, the param specs; (a) gemma3_1b at published
            width and all 26 layers, [1, 4096], bf16, AdamW lr 3e-4: 2
            build_train_step and 2 build_sharded_train_step steps from the
            same init in turns (plain, sharded, sharded, plain), params and
            moments torch.equal, losses equal, 52 flash forward and 26 backward launches a sharded step,
            all on "wgmma"; (b) the same gate at qwen3_moe_235b_a22b's
            published width, depth 1, [1, 2048] (the plain step's state
            waits on the host: two states do not fit), the dispatch /
            combine kernels launched; (c) build_compressed_dp_step at
            gemma3_1b, 3 steps, torch.equal to the same steps composed in
            one process (compress_with_feedback, AdamW.update), one
            all-reduce per leaf and step (and one for the loss), the loss
            falls, the residuals finite; (d) CheckpointManager.save of the
            sharded gemma3 params and restore(mesh=, specs=) torch.equal.
            Per step: ms of sharded beside plain, tokens/s, peak memory,
            the bytes allocated in the step, the bytes the per-layer
            gathers made (pshard.GATHER_BYTES: none at world size 1); a
            {"spmd": ...} line.  Everything it allocates is freed and the
            group destroyed before the next phase.  `--phases
            device,build,spmd` runs it alone
  tp        tensor / expert parallel over "model" on one card: the plain
            one-device steps first, in a process of their own (records and
            the fp32 run's params kept on the host, then freed); then two
            ranks of a gloo group (NCCL
            refuses two ranks on one device; a FileStore under build/),
            each a process spawned beside the plain one and waiting for
            its results, a join timeout that kills all three, the (1, 2)
            (data, model) mesh, build_sharded_train_step:
            (a) gemma3_1b at published width and all 26 layers, [1, 4096],
            bf16 -- 2 local q heads, K / V whole (KVH 1), the FFN's and the
            vocab's halves --, 52 flash forward and 26 backward launches a
            step, all on "wgmma"; (b) qwen3_moe_235b_a22b at published
            width, depth 1, [1, 2048], bf16 -- 32 heads and 64 experts a
            rank --, dispatch_scatter, combine_gather and
            combine_weighted_bwd launched; 2 steps each, losses and grad
            norms within TP_BF16_BAND of the plain step's, every leaf
            finite; each distinct flash call of (a) and (b) (the local
            heads as the main path gave them: gemma3 q [1, 4096, 2, 256], k
            [1, 4096, 1, 256] at window 512 and global; qwen3 q [1, 2048,
            32, 128], k [1, 2048, 2, 128]) run again, forward and backward,
            on "wgmma" against the plain versions at the kernels' bf16
            bars; (c) gemma3_1b's first superblock (6 layers) in fp32,
            [1, 2048]: the losses, grad norms and every leaf after 2 steps
            within TP_FP32_TOL (relative Frobenius, each rank's shards
            against the plain step's); qwen3's MoE layer in fp32 at
            published width on each rank's 64 experts: its output
            torch.equal to the one-device layer's, its gradients (x, the
            router, the rank's experts) within TP_FP32_TOL.  Per rank:
            peak allocated beside the plain step's, step ms, the bytes the
            per-layer gathers made.  Then each rank serves on the same
            mesh (build_sharded_prefill_step, build_sharded_decode_step
            fed the plain run's greedy tokens): gemma3_1b whole in bf16,
            its one kv head putting the caches over the sequence (split-K
            decode), prefill [1, 4096] into 4128 slots and 32 decode
            steps; qwen3 depth 1 in bf16, its caches over the kv heads (2
            kv and 32 q heads a rank), [1, 2048] and 16 steps; gemma3's
            first superblock and qwen3 depth 1 in fp32, 8 steps each.
            Every step's logits within TP_SERVE_BANDS of the plain
            api.prefill / api.decode (fp32: TP_FP32_TOL; bf16: qwen3
            TP_BF16_BAND, gemma3's 26 layers TP_BF16_BAND_GEMMA3); the
            plain bf16 run's distance from the same run in fp32, and for
            qwen3 from one routed as the bf16 run was, and the greedy
            tokens that agree (reported, not gated);
            flash on "wgmma" at the local heads, one launch a layer, each
            distinct call against the plain versions; dispatch_scatter
            and combine_gather in qwen3's prefill and every decode step;
            no host sync counted in the decode steps; prefill ms, decode
            ms a step and peak allocated beside the plain run's.  Then
            the recurrent, hybrid and encoder-decoder families over
            "model" on the same mesh: zamba2_1p2b whole in bf16 (38 Mamba2
            layers on 32 of 64 SSD heads a rank, in_proj's output and the
            conv's gathered, the shared block on 16 of 32 heads; train 2
            steps at [1, 4096], serve [1, 4096] into 4112 slots and 16
            steps) and its first superblock in fp32 ([1, 2048], 8 steps);
            rwkv6_7b in fp32 ([1, 2048]: 32 of 64 wkv heads a rank) at
            depth 1 (train) and depth 4 (train, its grad norms and leaves
            reported; serve, 8 steps), and whole in bf16 (serve, reported:
            ZOO_FP32_DECODE); seamless_m4t_large_v2 whole in bf16 ([1,
            4096] frames, 2048 decoder tokens, 8 of 16 heads a rank in the
            encoder, decoder and cross attention; train, serve 8 steps)
            and at 2 + 2 layers in fp32.  fp32 (AdamW eps TP_FP32_EPS):
            losses, grad norms, every leaf after 2 steps and every step's
            logits within TP_FP32_TOL, each train run beside the same
            plain run from params perturbed by TP_PERTURB; bf16: losses
            and grad norms within TP_BF16_BAND, logits within
            TP_SERVE_BANDS (zamba2 TP_BF16_BAND_ZAMBA2, seamless
            TP_BF16_BAND); flash on "wgmma" at the local heads (zamba2 q
            [1, 4096, 16, 64], seamless q [1, 2048, 8, 64]; 2 forward and
            1 backward launches a causal layer and train step), each
            distinct call against the plain versions; every cache (KV,
            wkv, ssm, conv ring) written in place, no host sync in
            decode.  A {"tp": ...} line.  `--phases device,build,tp` runs
            it alone
  zoo       (after the qwen3 model is released) the model families
            behind build_api: first fp32 at each family's smoke config
            (every greedy token == the argmax of api.forward over prompt +
            tokens so far), then at published width in bf16 --
            gemma3_1b (26 layers, head dim 256, local window 512), qwen2_1p5b
            (28), olmo_1b (16), deepseek_coder_33b and chameleon_34b (depth
            cut to 8), rwkv6_7b (32, attention-free), zamba2_1p2b (38 mamba
            layers, the shared attention block 6 times, dh 64) and
            seamless_m4t_large_v2 (24 + 24, dh 64; [2, 16384] frame
            embeddings -> 2048 decoder tokens) -- api.prefill of [2, 2048]
            tokens (flash launches == causal attention layers: 0 / 6 / 24
            for the last three, on wgmma at dh 256, 128 and 64; each
            launch's output vs the plain version on its own q, k, v; the
            logits vs the dense attention oracle) and 32 (gemma, rwkv6) or 8
            greedy api.decode steps with no host sync (the recurrent
            states written in place), each step's logits within 1e-1
            relative Frobenius error of api.forward (rwkv6: reported in
            bf16, where its random weights amplify rounding ~100x, and
            gated in fp32 at the same width and depth, 30 GB of
            weights); then deepseek_v32 at
            published width, depth 1: lm_forward on the Super Kernel
            (E=256, wgmma) and flash at dh 192 (wgmma) vs default_gmm (tol
            1e-1), and its flash, dispatch, gmm and combine calls each vs
            the plain version on the path's own inputs; one {"zoo": ...}
            line.
            `--phases device,build,zoo` runs it alone
  timing    each kernel timed at the shapes its path gave it, beside its
            bound, its plain version and one library call (library_ms is a
            yardstick timed here and used nowhere in the port): super_gmm
            gate/up and down at the serve wave's median launch (counts) and
            dense, flash_attention at the wave's modal (B, S) and at the one
            with the largest share of launches * B * S^2 and at the zoo's
            head dims 192, 256 and 64 (zamba2's and seamless's shapes; S
            2048, causal) and gemma3_1b's train shapes ([1, 4096], window
            512 and global), each with its route, dispatch_scatter
            and combine_gather at the decode shape on the decode path's
            route and on the TPU signature; the host's cost of each step of
            a wrapper call
  profile   (only with --phases ...,profile) the served requests once more
            under torch.profiler: device time by kernel, busy share

The {"kernels": ...} line's super_gmm row also carries its device ms per
tile at the serve wave's median launch (`device_ms_by_tile`) and the serve
wave's launches by tile.

The {"kernels": ...} line also carries the two backward kernels
(flash_attention_bwd, combine_weighted_bwd): their launches are the
full-width train step's, their times at that step's inputs.

No kernel falls back to another route or to its plain version on the card:
a wgmma launch whose tensor maps cannot be encoded, or that fails to
launch, raises (flash_attention_bwd's included).

Every super_gmm and flash_attention launch of the serve wave must take the
wgmma route, and every dispatch_scatter / combine_gather launch of the pd
wave's decode steps the "whole" / "weighted" route (the per-route launch
counts say so).  Each path's launches (serve, pd, batching, gmm, faults,
rebalance, tuning -- the tuned wave --, train, spmd -- the sharded steps
--, tp -- both ranks' sharded train steps and mesh serving runs --, zoo, and each example twin's whole run) stand in the {"kernels": ...} line under "launches_by_path".

To time another tree's kernels at the same shapes (a parent commit, say):
with the {"kernels": ...} line of a full run in the file F, copy this script
into the other tree's root and run it there as
    python3 chip_smoke.py --phases device,build,timing --shapes-from F
which times super_gmm, flash_attention and flash_attention_bwd alone at
that line's shapes, the decode MoE layer's kernel_moe_dispatch /
kernel_moe_combine calls, a decode step alone and a profiled gemma3_1b
train step (its device time by kernel, the flash forward's and backward's
share), with the repro_torch beside the script, and prints one
{"timing": ...} line.

Without a CUDA device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import warnings

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
from repro_torch.kernels.super_gmm import tuning
from repro_torch.kernels.super_gmm.super_gmm import (DEFAULT_TILE, TILES,
                                                      super_gmm,
                                                      super_gmm_ref,
                                                      tile_name)
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


def row_rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst row (last axis) of |got - ref| / |ref|: an attention row's
    output shrinks as 1/sqrt(keys seen), so a bound on the absolute error
    alone misses faults on the late rows (a lost key tile, a wrong rescale)."""
    ref = ref.float()
    return float(((got.float() - ref).norm(dim=-1)
                  / ref.norm(dim=-1)).max())


# flash_attention's bound on row_rel_err, beside the absolute bound: ~12x
# and ~3x the worst a sound kernel gave over every case of the kernels
# phase on an H100 (fp32 8.2e-7, bf16 5.9e-3)
ROW_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


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
    _build.load()
    srcs = [s.name for s in _build.sources()]
    print(f"[build] {srcs} -> {_build.build_dir()} in "
          f"{time.time() - t0:.1f}s")
    if verbose:  # registers, shared memory and spills of every kernel
        print("\n".join(f"[build] {line}" for line in
                        _build.ptxas_report().splitlines() if line.strip()))


def _gmm_inputs(gen, L, E, C, K, N, dtype):
    w = (torch.randn((L, E, K, N), generator=gen, device=DEV)
         / K ** 0.5).to(dtype)
    x = torch.randn((E, C, K), generator=gen, device=DEV).to(dtype)
    return w, x


def _routes(wrapper) -> dict:
    return dict(wrapper.launches_by_route)


def _took(wrapper, before: dict, route: str, what: str):
    """Every launch since `before` (a _routes snapshot) took `route`."""
    now = _routes(wrapper)
    diff = {r: now[r] - before.get(r, 0) for r in now}
    expect(diff.get(route, 0) > 0 and sum(diff.values()) == diff[route],
           f"{what}: launches by route {diff}, expected all {route}")


def check_super_gmm(gen) -> float:
    """Edge shapes in fp32 and bf16, then the main-path shapes in bf16.
    Returns the max abs error at the main-path shapes."""
    # every layer id through ONE launch signature, no host sync in between
    L, E, C, K, N = 3, 4, 192, 128, 64
    for dtype, tol, route in ((torch.float32, 1e-5, "fma"),
                              (torch.bfloat16, 2e-3, "wgmma")):
        w, x = _gmm_inputs(gen, L, E, C, K, N, dtype)
        lids = torch.arange(L, dtype=torch.int32, device=DEV)
        syncs_before, routes = _launch.host_syncs, _routes(super_gmm)
        outs = [super_gmm(lids[l:l + 1], w, x) for l in range(L)]
        expect(_launch.host_syncs == syncs_before,
               "a host sync between super_gmm launches")
        _took(super_gmm, routes, route, f"super_gmm {dtype} layers")
        torch.cuda.synchronize()
        for l in range(L):
            ref = super_gmm_ref(lids[l:l + 1], w, x)
            err = max_err(outs[l], ref)
            expect(err <= tol, f"super_gmm {dtype} C=192 layer {l}: err "
                   f"{err}")
        expect(not torch.equal(outs[0], outs[1]), "layer id ignored")
    print(f"[kernels] super_gmm fp32 (fma) and bf16 (wgmma) L={L} E={E} "
          f"C={C} K={K} N={N}: every layer id from one launch signature, "
          f"tol 1e-5 / 2e-3 ok")
    # ragged edges: C=8, K and N off the tile and off the 16-byte chunk
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-3)):
        for (E, C, K, N) in ((4, 8, 128, 64), (3, 70, 72, 40),
                             (2, 5, 68, 36), (2, 130, 100, 200)):
            w, x = _gmm_inputs(gen, 2, E, C, K, N, dtype)
            lid = torch.tensor([1], dtype=torch.int32, device=DEV)
            err = max_err(super_gmm(lid, w, x), super_gmm_ref(lid, w, x))
            expect(err <= tol, f"super_gmm {dtype} E={E} C={C} K={K} N={N}: "
                   f"err {err} > {tol}")
        # an x base one element past a 16-byte boundary: not for TMA
        if dtype == torch.bfloat16:
            w, _ = _gmm_inputs(gen, 2, 3, 1, 64, 64, dtype)
            x = _unaligned((3, 40, 64), dtype, gen)
            routes = _routes(super_gmm)
            got = super_gmm(lid, w, x)
            _took(super_gmm, routes, "wmma", "super_gmm unaligned x")
            err = max_err(got, super_gmm_ref(lid, w, x))
            expect(err <= tol, f"super_gmm unaligned x: err {err}")
    print("[kernels] super_gmm ragged C/K/N edges fp32 (tol 1e-5) and bf16 "
          "(tol 2e-3; K or N off 8 and an unaligned x take wmma) ok")
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
    # the persistent walk at 128 experts (counts 0, 1, BM, BM + 1, C, > C)
    # on a strided view of the weights, as the resident stacks are
    E, C, K, N = 128, 160, 256, 264
    wfull, x = _gmm_inputs(gen, 2, 2 * E, C, K, N, torch.bfloat16)
    w, x = wfull[:, 1::2], x[:E]
    pick = torch.tensor([0, 1, 128, 129, 160, 999, 7, 64],
                        dtype=torch.int32, device=DEV)
    counts = pick[torch.randint(0, len(pick), (E,), generator=gen,
                                device=DEV)]
    routes = _routes(super_gmm)
    # the output lands in a block the allocator just freed full of NaN, so
    # an element the kernel's walk does not write shows
    torch.full((E, C, N), float("nan"), device=DEV)
    got = super_gmm(lid, w, x, counts)
    _took(super_gmm, routes, "wgmma", "super_gmm E=128 strided")
    err = max_err(got, super_gmm_ref(lid, w, x, counts))
    expect(err <= 2e-3, f"super_gmm E=128 strided weights: err {err}")
    pad = torch.arange(C, device=DEV)[None, :] >= counts[:, None]
    expect(float(got[pad].abs().max()) == 0.0,
           "super_gmm E=128: padding rows are not exactly zero")
    print("[kernels] super_gmm with per-expert row counts (0, 1, 64, 65, C, "
          ">C; and 128 experts with counts 0, 1, BM, BM+1, C, >C on strided "
          "weights into a NaN-filled block): padding rows exactly zero, real "
          "rows vs plain ok")
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
    routes = _routes(super_gmm)
    for (K, N) in ((full.d_model, full.expert_d_ff),
                   (full.expert_d_ff, full.d_model)):
        for C in (8, 64, 512):
            w, x = _gmm_inputs(gen, 2, 32, C, K, N, torch.bfloat16)
            err = max_err(super_gmm(lid, w, x), super_gmm_ref(lid, w, x))
            expect(err <= 2e-3, f"super_gmm bf16 main C={C} K={K} N={N}: "
                   f"err {err}")
            worst = max(worst, err)
            del w, x
    _took(super_gmm, routes, "wgmma", "super_gmm main-path shapes")
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
    routes = _routes(flash_attention)
    rel = dict.fromkeys(ROW_REL_TOL, 0.0)  # worst row_rel_err by dtype

    def check(got, ref, dtype, tol, what):
        err, r = max_err(got, ref), row_rel_err(got, ref)
        rel[dtype] = max(rel[dtype], r)
        expect(err <= tol and r <= ROW_REL_TOL[dtype],
               f"{what}: err {err} (tol {tol}), row rel err {r} (tol "
               f"{ROW_REL_TOL[dtype]})")
        return err

    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 4e-2)):
        for dh in (32, 64, 128):
            for S in (192, 50, 257):
                q, k, v = (rnd((3, S, dh), dtype) for _ in range(3))
                for kw in cases:
                    check(flash_attention(q, k, v, **kw),
                          attention_ref(q, k, v, **kw), dtype, tol,
                          f"flash_attention {dtype} dh={dh} S={S} {kw}")
    now = _routes(flash_attention)
    expect(all(now[r] > routes.get(r, 0) for r in now),
           f"flash_attention edges: not every route ran: {now}")
    print("[kernels] flash_attention [BH,S,dh] S in (192,50,257) dh in "
          "(32,64,128), causal/window/softcap/non-causal: fp32 tol 2e-5, "
          "bf16 tol 4e-2 ok (routes fma, wmma at dh 32, wgmma at 64/128)")
    # model layout + GQA, the KV head indexed in the kernel: dh 32 (wmma),
    # dh 128 (wgmma), and dh 128 from an unaligned base (wmma)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 4e-2)):
        for dh, B, S, H, KVH in ((32, 2, 192, 8, 2), (128, 2, 300, 8, 2),
                                 (64, 1, 1000, 4, 1)):
            q = rnd((B, S, H, dh), dtype)
            k, v = rnd((B, S, KVH, dh), dtype), rnd((B, S, KVH, dh), dtype)
            got = mha_flash(q, k, v, window=40)
            ref = mha_flash(q.cpu(), k.cpu(), v.cpu(), window=40).to(DEV)
            check(got, ref, dtype, tol, f"mha_flash GQA {dtype} dh={dh}")
    q = _unaligned((1, 130, 4, 128), torch.bfloat16, gen)
    k = rnd((1, 130, 2, 128), torch.bfloat16)
    routes = _routes(flash_attention)
    got = mha_flash(q, k, k)
    _took(flash_attention, routes, "wmma", "flash_attention unaligned q")
    check(got, mha_flash(q.cpu(), k.cpu(), k.cpu()).to(DEV), torch.bfloat16,
          4e-2, "mha_flash unaligned q")
    try:
        flash_attention(rnd((1, 8, 48), torch.float32),
                        rnd((1, 8, 48), torch.float32),
                        rnd((1, 8, 48), torch.float32))
    except ValueError:
        pass
    else:
        raise Failed("flash_attention took a head dim it has no kernel for")
    print("[kernels] mha_flash [B,S,H,dh] GQA (dh 32/128/64, window 40, "
          "unaligned base on wmma) ok; unsupported head dim raises")
    # main-path shape: qwen3 heads, bf16
    full = get_config(ARCH)
    worst = 0.0
    routes = _routes(flash_attention)
    for (B, S) in ((1, 256), (2, 1024)):
        q = rnd((B, S, full.num_heads, full.head_dim), torch.bfloat16)
        k = rnd((B, S, full.num_kv_heads, full.head_dim), torch.bfloat16)
        v = rnd((B, S, full.num_kv_heads, full.head_dim), torch.bfloat16)
        err = check(mha_flash(q, k, v), _mha_plain(q, k, v), torch.bfloat16,
                    4e-2, f"mha_flash bf16 main B={B} S={S}")
        worst = max(worst, err)
    _took(flash_attention, routes, "wgmma", "mha_flash main-path shapes")
    print(f"[kernels] mha_flash bf16 main-path shape H={full.num_heads} "
          f"KVH={full.num_kv_heads} dh={full.head_dim}: max err {worst:.2e} "
          f"(tol 4e-2) ok")
    check_flash_wide_heads(gen, check)
    print(f"[kernels] flash_attention worst row relative error over every "
          f"case above: fp32 {rel[torch.float32]:.2e} (tol "
          f"{ROW_REL_TOL[torch.float32]:.0e}), bf16 "
          f"{rel[torch.bfloat16]:.2e} (tol {ROW_REL_TOL[torch.bfloat16]:.0e})")
    return worst


def check_flash_wide_heads(gen, check):
    """Head dims 192 and 256 (deepseek_v32's and gemma3's heads, GQA in
    model layout) against the plain version on expanded heads, on the card:
    bf16 on wgmma (the wide-head kernel; tol 4e-2) and fp32 on fma (tol
    2e-5), causal, window 512 and 16, softcap, S 192 and 2047; each bf16
    case twice (torch.equal) and once more with its log-sum-exp (o the same
    bits, lse within LSE_TOL of attention_fwd_ref's); then unaligned bases
    on wmma.  `check` is check_flash_attention's (absolute and row-relative
    bounds)."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_launch
    from repro_torch.kernels.flash_attention.ref import attention_fwd_ref

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)

    n, worst_lse = 0, 0.0
    for dtype, tol, route in ((torch.float32, 2e-5, "fma"),
                              (torch.bfloat16, 4e-2, "wgmma")):
        for B, H, KVH, dh in ((1, 128, 8, 192), (2, 4, 1, 256)):
            for S in (192, 2047):
                q = rnd((B, S, H, dh), dtype)
                k, v = rnd((B, S, KVH, dh), dtype), rnd((B, S, KVH, dh), dtype)
                for window, cap in ((None, None), (512, None), (16, None),
                                    (None, 30.0)):
                    what = (f"mha_flash {dtype} B={B} H={H} KVH={KVH} "
                            f"dh={dh} S={S} window={window} softcap={cap}")
                    routes = _routes(flash_attention)
                    got = mha_flash(q, k, v, window=window, softcap=cap)
                    _took(flash_attention, routes, route, what)
                    check(got, _mha_plain(q, k, v, window, cap), dtype, tol,
                          what)
                    n += 1
                    if dtype == torch.bfloat16:
                        again = mha_flash(q, k, v, window=window, softcap=cap)
                        expect(torch.equal(got, again),
                               f"{what}: two calls differ")
                        o, lse = flash_launch(q, k, v, causal=True,
                                              window=window, softcap=cap,
                                              with_lse=True)
                        expect(torch.equal(o, got),
                               f"{what}: o with its lse differs")
                        lse_ref = attention_fwd_ref(
                            q.float(), k.float(), v.float(), window=window,
                            softcap=cap)[1]
                        err = max_err(lse, lse_ref)
                        expect(err <= LSE_TOL,
                               f"{what}: lse err {err} (tol {LSE_TOL})")
                        worst_lse = max(worst_lse, err)
                        del again, o, lse, lse_ref
                    del got
                del q, k, v
    for dh, H, KVH in ((192, 16, 8), (256, 4, 1)):
        q = _unaligned((1, 300, H, dh), torch.bfloat16, gen)
        k = rnd((1, 300, KVH, dh), torch.bfloat16)
        routes = _routes(flash_attention)
        got = mha_flash(q, k, k, window=16)
        _took(flash_attention, routes, "wmma", f"unaligned q dh={dh}")
        check(got, _mha_plain(q, k, k, 16), torch.bfloat16, 4e-2,
              f"mha_flash unaligned q dh={dh}")
        n += 1
    for dtype in (torch.float32, torch.bfloat16):
        x = rnd((1, 8, 2, 96), dtype)
        try:
            mha_flash(x, x, x)
        except ValueError:
            pass
        else:
            raise Failed(f"flash_attention took head dim 96 ({dtype}): no "
                         f"kernel is instantiated for it")
    print(f"[kernels] mha_flash at head dims 192 (H=128 KVH=8) and 256 (H=4 "
          f"KVH=1), S 192/2047, causal / window 512 / window 16 / softcap "
          f"30, unaligned bases: {n} cases, bf16 aligned all on wgmma (tol "
          f"4e-2; two calls torch.equal; lse max err {worst_lse:.1e}, tol "
          f"{LSE_TOL:.0e}), unaligned on wmma, fp32 all on fma (tol 2e-5) "
          f"ok; head dim 96 raises")


def _mha_plain(q, k, v, window=None, softcap=None):
    """The plain version of mha_flash (causal), run on the card."""
    B, S, H, dh = q.shape

    def to_bh(x):
        return _expand_kv(x, H).permute(0, 2, 1, 3).reshape(B * H, S, dh)

    o = attention_ref(to_bh(q), to_bh(k), to_bh(v), window=window,
                      softcap=softcap)
    return o.reshape(B, H, S, dh).permute(0, 2, 1, 3)


def _pairs(gen, T, E, K, C):
    """(token_of, slot) int32 of a real routing: K distinct experts per token
    (top-K of random scores), sorted and cut at capacity C on the card."""
    from repro_torch.models.moe import dispatch_slots
    idx = torch.topk(torch.rand((T, E), generator=gen, device=DEV), K,
                     -1).indices.to(torch.int32)
    perm, slot, _, _ = dispatch_slots(idx, E, C)
    return (perm // K).to(torch.int32), slot.to(torch.int32), idx


def _unaligned(shape, dtype, gen):
    """A contiguous tensor whose base is one element past a 16-byte
    boundary: the kernels' scalar path."""
    n = int(np.prod(shape))
    flat = torch.empty(n + 1, dtype=dtype, device=DEV)[1:]
    flat.copy_(torch.randn(n, generator=gen, device=DEV).to(dtype))
    return flat.view(shape)


def check_dispatch_combine(gen) -> float:
    """dispatch_scatter / combine_gather's TPU-signature routes against their
    plain versions, bit for bit: the decode MoE layer's shape in bf16, then
    fp32 and bf16 edges.  Returns 0.0, the max abs error of an exact copy."""
    from repro_torch.kernels.dispatch_combine.dispatch_combine import (
        combine_gather, dispatch_scatter)
    from repro_torch.kernels.dispatch_combine.ref import (combine_gather_ref,
                                                          dispatch_scatter_ref)

    def both(token_of, slot, x, rows_out, what):
        got = dispatch_scatter(token_of, slot, x, rows_out=rows_out)
        want = dispatch_scatter_ref(token_of, slot, x, rows_out)
        expect(torch.equal(got, want), f"dispatch_scatter {what}")
        yb = torch.randn((rows_out, x.shape[1]), generator=gen,
                         device=DEV).to(x.dtype)
        yb[-1] = 0
        got = combine_gather(slot, yb)
        expect(torch.equal(got, combine_gather_ref(slot, yb)),
               f"combine_gather {what}")

    routes = (_routes(dispatch_scatter), _routes(combine_gather))
    full = get_config(ARCH)
    T, E, K, d = 8, full.num_experts, full.top_k, full.d_model
    C = 8  # expert_capacity(8) at these widths: every decode step dropless
    token_of, slot, _ = _pairs(gen, T, E, K, C)
    x = torch.randn((T, d), generator=gen, device=DEV).bfloat16()
    both(token_of, slot, x, E * C + 1, "decode shape bf16")
    print(f"[kernels] dispatch_scatter/combine_gather bf16 T={T} K={K} "
          f"N={T * K} E={E} C={C} rows_out={E * C + 1} d={d}: "
          f"array_equal ok")
    for dtype in (torch.float32, torch.bfloat16):
        for dd in (16, 4100):
            for (T, E, K, C) in ((64, 8, 2, 8), (1, 4, 1, 8), (33, 16, 4, 8)):
                token_of, slot, _ = _pairs(gen, T, E, K, C)
                x = torch.randn((T, dd), generator=gen, device=DEV).to(dtype)
                both(token_of, slot, x, E * C + 1, f"{dtype} d={dd} T={T}")
                both(token_of, slot, _unaligned((T, dd), dtype, gen),
                     E * C + 1, f"{dtype} d={dd} T={T} unaligned base")
            x = torch.randn((5, dd), generator=gen, device=DEV).to(dtype)
            empty = torch.zeros(0, dtype=torch.int32, device=DEV)
            both(empty, empty, x, 17, f"{dtype} d={dd} N=0")
            one = torch.tensor([3], dtype=torch.int32, device=DEV)
            last = torch.tensor([15], dtype=torch.int32, device=DEV)
            both(one, last, x, 17, f"{dtype} d={dd} N=1 at row E*C-1")
            trash = torch.full((12,), 16, dtype=torch.int32, device=DEV)
            tok = torch.arange(12, dtype=torch.int32, device=DEV) % 5
            both(tok, trash, x, 17, f"{dtype} d={dd} every pair dropped")
            expect(float(dispatch_scatter(tok, trash, x, rows_out=17)
                         .abs().max()) == 0.0, "trash row written")
    _took(dispatch_scatter, routes[0], "scatter", "dispatch_scatter edges")
    _took(combine_gather, routes[1], "gather", "combine_gather edges")
    print("[kernels] dispatch_scatter/combine_gather fp32 and bf16 edges (d "
          "16/4100, unaligned bases, N=0, N=1 at row E*C-1, every pair "
          "dropped): array_equal ok")
    return 0.0


def _moe_cfg(E: int, K: int):
    return get_config(ARCH).smoke().replace(num_experts=E, top_k=K)


def _whole_cases(gen):
    """(what, x of a dtype -> [T, d], idx [T, K] int32, E, C) of the whole
    dispatch's checks; x keeps its strides in either dtype."""
    from repro_torch.kernels.dispatch_combine.ref import RANK_CHUNK
    from repro_torch.models.moe import expert_capacity
    full = get_config(ARCH)
    d, E, K = full.d_model, full.num_experts, full.top_k

    def routed(T, E, K, d):
        _, _, idx = _pairs(gen, T, E, K, 8)
        x = torch.randn((T, d), generator=gen, device=DEV)
        return (lambda dtype: x.to(dtype)), idx

    x, idx = routed(8, E, K, d)
    yield "decode shape T=8 K=8 E=128 C=8", x, idx, E, 8
    x, idx = routed(1, E, K, d)
    yield "T=1", x, idx, E, 8
    x, _ = routed(64, E, K, d)
    one = torch.full((64, K), 5, dtype=torch.int32, device=DEV)
    yield "all 512 pairs to one expert, C=8 (504 dropped)", x, one, E, 8
    for n in (RANK_CHUNK - 1, RANK_CHUNK, RANK_CHUNK + 1):
        x, idx = routed(n, 16, 1, 64)
        yield f"N={n} at the rank chunk's edge (E=16 K=1)", x, idx, 16, \
            expert_capacity(n, _moe_cfg(16, 1))
    x, idx = routed(640, E, K, 256)
    yield "N=5120 > 4096 (T=640 K=8)", x, idx, E, \
        expert_capacity(640, _moe_cfg(E, K))
    # two experts of 2560 pairs each at C = 2000: the rows blocks fill
    # capacity rows 1024 at a time, so the second pass resumes mid-chunk
    x, _ = routed(640, 16, K, 64)
    two = torch.tensor([3, 11], dtype=torch.int32,
                       device=DEV)[torch.arange(K, device=DEV) % 2]
    yield "C=2000 > the kernel's 1024-row window (2 x 2560 pairs, E=16)", x, \
        two.expand(640, K).contiguous(), 16, 2000
    x, idx = routed(64, 256, K, d)
    yield "E=256 K=8 (deepseek_v32's experts)", x, idx, 256, \
        expert_capacity(64, _moe_cfg(256, K))
    big, idx = routed(8, E, K, d + 64)
    yield "non-contiguous x (row stride d+64)", \
        (lambda dtype: big(dtype)[:, 64:]), idx, E, 8
    yield "x one element off 16 bytes (scalar copy)", \
        (lambda dtype: big(dtype)[:, 1:d + 1]), idx, E, 8


def check_whole_dispatch(gen):
    """The "whole" route of dispatch_scatter (one launch) torch.equal to
    moe_dispatch on every output (xb, perm, slot, valid, group_sizes; and
    pair_slot to moe_dispatch's slots in pair order) and to its plain
    version, fp32 and bf16, xb written into a NaN-filled block."""
    from repro_torch.kernels.dispatch_combine.dispatch_combine import (
        dispatch_scatter, dispatch_whole)
    from repro_torch.kernels.dispatch_combine.ref import dispatch_whole_ref
    from repro_torch.models.moe import moe_dispatch
    routes = _routes(dispatch_scatter)
    names = ("xb", "perm", "slot", "valid", "group_sizes", "pair_slot")
    cases = []
    for what, x, idx, E, C in _whole_cases(gen):
        for dtype in (torch.float32, torch.bfloat16):
            xt = x(dtype)
            # the allocator hands xb the block just freed, full of NaN
            torch.full((E * C, xt.shape[1]), float("nan"), dtype=dtype,
                       device=DEV)
            got = dispatch_whole(xt, idx, E, C)
            xb, info = moe_dispatch(xt, idx, _moe_cfg(E, idx.shape[1]), C)
            pair_slot = torch.empty_like(info["slot"]).scatter_(
                0, info["perm"], info["slot"])
            want = (xb.reshape(E * C, -1), info["perm"], info["slot"],
                    info["valid"], info["group_sizes"], pair_slot)
            plain = dispatch_whole_ref(xt, idx, E, C)
            for name, g, w, p in zip(names, got, want, plain):
                expect(g.dtype == w.dtype and torch.equal(g, w),
                       f"dispatch whole {what} {dtype}: {name} != "
                       f"moe_dispatch's")
                expect(torch.equal(g, p), f"dispatch whole {what} {dtype}: "
                       f"{name} != its plain version")
        cases.append(what)
    _took(dispatch_scatter, routes, "whole", "dispatch whole checks")
    print(f"[kernels] dispatch_scatter 'whole' route == moe_dispatch and == "
          f"its plain version (torch.equal on xb, perm, slot, valid, "
          f"group_sizes, pair_slot), fp32 and bf16, xb into a NaN-filled "
          f"block: {'; '.join(cases)}")


def check_wide_dispatch(gen):
    """kernel_moe_dispatch beyond the "whole" route's bound (E =
    WHOLE_MAX_EXPERTS + 1): the "scatter" route, torch.equal to moe_dispatch
    on every output (pair_slot to its slots in pair order), fp32 and bf16,
    xb into a NaN-filled block, at the config's capacity and at C=1."""
    from repro_torch.kernels.dispatch_combine.dispatch_combine import (
        WHOLE_MAX_EXPERTS, dispatch_scatter)
    from repro_torch.kernels.dispatch_combine.ops import (dispatch_route,
                                                          kernel_moe_dispatch,
                                                          pair_slots)
    from repro_torch.models.moe import expert_capacity, moe_dispatch
    E, K, T, d = WHOLE_MAX_EXPERTS + 1, 8, 64, get_config(ARCH).d_model
    expect(dispatch_route(E) == "scatter"
           and dispatch_route(WHOLE_MAX_EXPERTS) == "whole",
           f"dispatch route rule at E={E}")
    cfg = _moe_cfg(E, K)
    _, _, idx = _pairs(gen, T, E, K, 8)
    x = torch.randn((T, d), generator=gen, device=DEV)
    routes = _routes(dispatch_scatter)
    for C in (None, 1):
        for dtype in (torch.float32, torch.bfloat16):
            xt = x.to(dtype)
            # the allocator hands xb the block just freed, full of NaN
            torch.full((E * (C or expert_capacity(T, cfg)) + 1, d),
                       float("nan"), dtype=dtype, device=DEV)
            xb, info = kernel_moe_dispatch(xt, idx, cfg, C)
            wxb, winfo = moe_dispatch(xt, idx, cfg, C)
            expect(torch.equal(xb, wxb), f"dispatch E={E} C={C} {dtype}: xb "
                   f"!= moe_dispatch's")
            for k in ("perm", "slot", "valid", "group_sizes"):
                expect(torch.equal(info[k], winfo[k]), f"dispatch E={E} "
                       f"C={C} {dtype}: {k} != moe_dispatch's")
            expect(torch.equal(info["pair_slot"],
                               pair_slots(winfo["perm"], winfo["slot"])),
                   f"dispatch E={E} C={C} {dtype}: pair_slot")
    _took(dispatch_scatter, routes, "scatter", f"dispatch at E={E}")
    print(f"[kernels] kernel_moe_dispatch at E={E} (> WHOLE_MAX_EXPERTS = "
          f"{WHOLE_MAX_EXPERTS}) T={T} K={K} d={d}: every launch on the "
          f"'scatter' route, torch.equal to moe_dispatch (xb, perm, slot, "
          f"valid, group_sizes, pair_slot), fp32 and bf16, xb into a "
          f"NaN-filled block, at the config's capacity and at C=1")


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst |got - want| in bf16 ulps of the larger magnitude."""
    big = torch.maximum(got.double().abs(), want.double().abs())
    _, e = torch.frexp(big)
    ulp = torch.ldexp(torch.ones_like(big), e - 8)
    return float(((got.double() - want.double()).abs() / ulp).max())


def check_weighted_combine(gen):
    """The "weighted" route of combine_gather (one launch) bitwise equal to
    its plain version, and against moe_combine within 1 bf16 ulp / 1e-6 in
    fp32, for both via_gather values and an info from either dispatch; then
    the order of the sum over k."""
    from repro_torch.kernels.dispatch_combine.dispatch_combine import (
        combine_gather, combine_weighted)
    from repro_torch.kernels.dispatch_combine.ops import (kernel_moe_combine,
                                                          kernel_moe_dispatch)
    from repro_torch.kernels.dispatch_combine.ref import combine_weighted_ref
    from repro_torch.models.moe import moe_combine, moe_dispatch
    full = get_config(ARCH)
    d = full.d_model
    routes = _routes(combine_gather)
    worst_ulp = worst_f32 = 0.0
    for what, T, E, K, C in (("decode shape", 8, 128, 8, 8),
                             ("T=1", 1, 128, 8, 8),
                             ("C=2, pairs dropped", 64, 128, 8, 2),
                             ("E=256", 64, 256, 8, 8)):
        cfg = _moe_cfg(E, K)
        _, _, idx = _pairs(gen, T, E, K, C)
        w = torch.rand((T, K), generator=gen, device=DEV)
        w = w / w.sum(-1, keepdim=True)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((T, d), generator=gen, device=DEV).to(dtype)
            yb = torch.randn((E, C, d), generator=gen, device=DEV).to(dtype)
            _, info = kernel_moe_dispatch(x, idx, cfg, C)
            _, info_p = moe_dispatch(x, idx, cfg, C)
            plain = combine_weighted_ref(yb.reshape(E * C, d),
                                         info["pair_slot"], w)
            for inf in (info, info_p):
                for via_gather in (False, True):
                    got = kernel_moe_combine(yb, inf, w, T,
                                             via_gather=via_gather)
                    expect(torch.equal(got, plain),
                           f"combine weighted {what} {dtype}: != plain")
                    want = moe_combine(yb, info_p, w, T,
                                       via_gather=via_gather)
                    if dtype == torch.bfloat16:
                        u = _bf16_ulps(got, want)
                        worst_ulp = max(worst_ulp, u)
                        expect(u <= 1.0, f"combine weighted {what}: {u} "
                               f"bf16 ulps from moe_combine")
                    else:
                        err = float(((got - want).abs()
                                     - 1e-6 * want.abs()).max())
                        worst_f32 = max(worst_f32, max_err(got, want))
                        expect(err <= 1e-6, f"combine weighted {what}: fp32 "
                               f"err {max_err(got, want)} vs moe_combine")
    # the sum runs over k in order: (1 + 1e8) - 1e8 is 0 in fp32
    yb = torch.tensor([[1.0] * 8, [1e8] * 8, [-1e8] * 8], device=DEV)
    ps = torch.tensor([0, 1, 2], dtype=torch.long, device=DEV)
    got = combine_weighted(yb, ps, torch.ones((1, 3), device=DEV))
    expect(float(got.abs().max()) == 0.0,
           f"combine weighted: k order, 1 + 1e8 - 1e8 gave {got[0, 0]}")
    _took(combine_gather, routes, "weighted", "combine weighted checks")
    print(f"[kernels] combine_gather 'weighted' route == its plain version "
          f"(torch.equal) for an info from either dispatch and both "
          f"via_gather values, fp32 and bf16 (decode shape, T=1, C=2 with "
          f"drops, E=256); vs moe_combine: bf16 worst {worst_ulp:.2f} ulp "
          f"(tol 1), fp32 worst {worst_f32:.2e} (tol 1e-6 + 1e-6 rel); "
          f"k order: 1 + 1e8 - 1e8 = 0 ok")


def check_moe_path_no_sync(gen):
    """The wired-up dispatch/combine on CUDA tensors: equal to the plain
    oracles, and not one host sync (the sync debug mode raises on one)."""
    from repro_torch.kernels.dispatch_combine.ops import (kernel_moe_combine,
                                                          kernel_moe_dispatch)
    from repro_torch.models.moe import moe_combine, moe_dispatch
    T, E, K = 64, 8, 2
    cfg = _moe_cfg(E, K)
    _, _, idx = _pairs(gen, T, E, K, 8)
    x = torch.randn((T, cfg.d_model), generator=gen, device=DEV)
    w = torch.rand((T, K), generator=gen, device=DEV)
    for cap in (None, 8):  # 8 < the hottest expert's count: pairs drop
        syncs = _launch.host_syncs
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            xb, info = kernel_moe_dispatch(x, idx, cfg, cap)
            y = kernel_moe_combine(xb * 2.0, info, w, T)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        expect(_launch.host_syncs == syncs, "kernel_moe_dispatch host sync")
        xb_p, info_p = moe_dispatch(x, idx, cfg, cap)
        expect(torch.equal(xb, xb_p), f"kernel_moe_dispatch capacity {cap}")
        for k in ("perm", "slot", "valid", "group_sizes"):
            expect(torch.equal(info[k], info_p[k]), f"dispatch info {k}")
        err = max_err(y, moe_combine(xb_p * 2.0, info_p, w, T))
        expect(err <= 1e-6, f"kernel_moe_combine: err {err}")
    print("[kernels] kernel_moe_dispatch == moe_dispatch (xb, perm, slot, "
          "valid, group_sizes) and kernel_moe_combine vs moe_combine (tol "
          "1e-6) on CUDA tensors, dropless and dropping, no host sync")


def phase_kernels(gen) -> dict:
    errs = {"super_gmm": check_super_gmm(gen),
            "flash_attention": check_flash_attention(gen),
            "dispatch_scatter": check_dispatch_combine(gen)}
    errs["combine_gather"] = errs["dispatch_scatter"]
    check_whole_dispatch(gen)
    check_wide_dispatch(gen)
    check_weighted_combine(gen)
    check_moe_path_no_sync(gen)
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


def _executor_vs_oracle(cfg, params, B, S, **kw):
    """Run 2 jobs through DisaggregatedExecutor(D=2, E=4, **kw) and the
    port's own dense oracle; returns (max abs err, relative Frobenius err,
    the executor's results)."""
    from repro_torch.core.executor import BatchJob, DisaggregatedExecutor
    from repro_torch.models.lm import lm_backbone
    rng = np.random.RandomState(0)
    jobs = [BatchJob(tokens=rng.randint(0, cfg.vocab_size, (B, S)), bid=i)
            for i in range(2)]
    ex = DisaggregatedExecutor(params, cfg, D=2, E=4, device=DEV, **kw)
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
    return worst, (num / den) ** 0.5, [j.result for j in done]


def phase_executor(cfg, params):
    """Executor vs the port's own dense oracle on the card: exactly, in fp32
    at the small config (both kernels' fp32 paths); then one small batch at
    full width in bf16."""
    from repro_torch.models.lm import init_lm_params
    small = get_config(ARCH).smoke().replace(num_layers=3)
    gen = torch.Generator(device=DEV).manual_seed(1)
    worst, rel, _ = _executor_vs_oracle(small,
                                        init_lm_params(gen, small, DEV), 2, 48)
    # fp32 end to end; the two paths sum the same terms in another order
    expect(worst <= 2e-4, f"executor vs dense oracle (fp32): err {worst}")
    print(f"[executor] fp32 {small.num_layers}L x {small.num_experts}e "
          f"d_model={small.d_model}: D=2 E=4 vs lm_backbone(moe_mode="
          f"'dense'): max err {worst:.2e} (tol 2e-4)")
    worst, rel, _ = _executor_vs_oracle(cfg, params, 2, 64)
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
    kernels = _pd_kernels()
    torch.cuda.synchronize()
    for k in kernels.values():
        _launch.reset_launches(k)
    _launch.reset_host_syncs()
    torch.cuda.reset_peak_memory_stats()
    ms = torch.cuda.memory_stats()
    alloc0 = (ms["num_device_alloc"], ms["num_device_free"],
              ms["num_alloc_retries"])
    out = serve_requests(cfg, params, lengths=lengths, verbose=True, **kw)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    by_route = {"super_gmm": _routes(super_gmm),
                "flash_attention": _routes(flash_attention)}
    by_tile = dict(super_gmm.launches_by_tile)
    syncs = _launch.reset_host_syncs()
    results, st = out["results"], out["stats"]
    expect(len(results) == 8 and all(r.ok for r in results),
           "serve: not every request ok")
    expect(all(r.first_token is not None
               and 0 <= r.first_token < cfg.vocab_size for r in results),
           "serve: bad first token")
    expect(launches["super_gmm"] > 0 and launches["flash_attention"] > 0,
           f"serve: a kernel was never launched: {launches}")
    for name in by_route:  # the main path is the Hopper route
        n = launches[name]
        expect(by_route[name]["wgmma"] == n,
               f"serve: {name} launches by route {by_route[name]}")
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
    print(f"[serve] launches {launches}, by route {by_route}; host syncs "
          f"{syncs} over "
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
    ttft = [r.ttft for r in results]
    return {"launches": launches, "by_route": by_route, "by_tile": by_tile,
            "wall_s": out["wall"], "ttft_mean_s": float(np.mean(ttft)),
            "ttft_max_s": float(np.max(ttft)),
            "shapes": out["shapes"], "buckets": out["buckets"],
            "counts": out["counts"], "lengths": lengths, "kw": kw}


def _pd_kernels():
    from repro_torch.kernels.dispatch_combine.dispatch_combine import (
        combine_gather, dispatch_scatter)
    return {"super_gmm": super_gmm, "flash_attention": flash_attention,
            "dispatch_scatter": dispatch_scatter,
            "combine_gather": combine_gather}


def check_teacher_forced(seed: int):
    """fp32, the small config (3 layers, 8 experts top-2, d_model 128): a PD
    run on the card, then every generated token against the argmax of the
    port's own dense lm_forward over the prompt plus the tokens so far
    (dropless: 4 decode slots <= C = 8).  Where the oracle's top-2 gap is
    under 1e-3 the token need only be within 1e-4 of the oracle's max."""
    from repro_torch.launch.serve import pd_requests, serve_pd
    from repro_torch.models.lm import init_lm_params, lm_forward
    cfg = get_config(ARCH).smoke().replace(num_layers=3, num_experts=8,
                                           top_k=2)
    gen = torch.Generator(device=DEV).manual_seed(seed + 7)
    params = init_lm_params(gen, cfg, DEV)
    rng = np.random.default_rng(seed)
    lengths = [int(x) for x in rng.integers(8, 48, size=6)]
    reqs = pd_requests(lengths, [int(x) for x in rng.integers(2, 9, size=6)],
                       rps=50.0, seed=seed)
    prompts = {q.rid: rng.integers(0, cfg.vocab_size, q.length) for q in reqs}
    out = serve_pd(cfg, params, reqs, prompts=prompts, device=DEV, slots=4,
                   max_len=128, max_batch_tokens=128)
    results = out["results"]
    expect(len(results) == 6 and all(r.ok for r in results),
           "teacher-forced PD run: not every request ok")
    out_len = {q.rid: q.out_len for q in reqs}
    checked = near = 0
    with torch.inference_mode():
        for r in results:
            expect(r.tokens_out == len(r.output_tokens) == out_len[r.rid],
                   "teacher-forced: token count")
            seq = list(prompts[r.rid])
            for tok in r.output_tokens:
                logits, _ = lm_forward(
                    params, cfg, torch.tensor([seq], device=DEV),
                    moe_mode="dense")
                last = logits[0, -1].float()
                top2 = torch.topk(last, 2).values
                if float(top2[0] - top2[1]) > 1e-3:
                    expect(tok == int(torch.argmax(last)),
                           f"teacher-forced: rid {r.rid} token {len(seq)}: "
                           f"{tok} != oracle {int(torch.argmax(last))}")
                else:
                    near += 1
                    expect(float(last.max() - last[tok]) <= 1e-4,
                           f"teacher-forced near-tie rid {r.rid}")
                checked += 1
                seq.append(tok)
    print(f"[pd] teacher-forced fp32 {cfg.num_layers}L x {cfg.num_experts}e "
          f"d_model={cfg.d_model}: {checked} tokens of 6 PD requests (first "
          f"tokens from the prefill executor, the rest from the decode "
          f"runtime) == argmax of the dense lm_forward over prompt + tokens "
          f"so far ({near} near-ties checked at 1e-4)")
    del params, out
    gc.collect()
    torch.cuda.empty_cache()


def _hop_latency_us(reps: int = 200):
    """A small (4 KiB) device-to-device copy: its device time by the
    profiler, and its time as issued back to back (CUDA events around
    `reps` copies, so the host's issue rate shows)."""
    src = torch.zeros(1024, dtype=torch.float32, device=DEV)
    dst = torch.empty_like(src)
    issued = 1e3 * cuda_ms(lambda: dst.copy_(src), iters=reps, warmup=10)
    device, _ = _device_ms(lambda: dst.copy_(src), reps)
    return 1e3 * device, issued


def phase_pd(cfg, params, serve: dict, seed: int) -> dict:
    """A prefill->decode wave at full width through the serve phase's
    long-lived executor (switched to emit_kv): 8 requests of the serve
    phase's lengths, out_len lognormal mean 16 cv 0.5 capped at 64, decode
    width 8 over a 2112-token cache, PDOrchestrator(hw=H100),
    disaggregated.  The launch counts of all four kernels are set to 0 just
    before and read just after."""
    from repro_torch.core.trace import TraceConfig, sample_out_len
    from repro_torch.launch.serve import pd_requests, serve_pd
    check_teacher_forced(seed)
    hop_us, issued_us = _hop_latency_us()
    print(f"[pd] hop latency: a 4 KiB device-to-device copy takes "
          f"{hop_us:.3f} us of device time (mean of 200; {issued_us:.2f} us "
          f"each as issued back to back)")
    tc = TraceConfig(out_len_mean=16.0, out_len_cv=0.5, seed=seed)
    lengths = serve["lengths"]
    out_lens = [min(sample_out_len(i, tc), 64) for i in range(len(lengths))]
    reqs = pd_requests(lengths, out_lens, rps=8.0, seed=seed)
    kernels = _pd_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        _launch.reset_launches(k)
    _launch.reset_host_syncs()
    out = serve_pd(cfg, params, reqs, device=DEV, slots=8, max_len=2112,
                   executor=serve["kw"]["executor"], max_batch_tokens=4096,
                   verbose=True)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    by_route = {n: _routes(kernels[n])
                for n in ("dispatch_scatter", "combine_gather")}
    results, rt, kv_log = out["results"], out["runtime"], out["kv_log"]
    by_rid = {r.rid: r for r in results}
    expect(len(results) == 8 and all(r.ok for r in results),
           "pd: not every request ok")
    expect(all(by_rid[q.rid].tokens_out == q.out_len for q in reqs),
           "pd: tokens_out != out_len")
    handoffs = sum(1 for q in reqs if q.out_len > 1)
    expect(kv_log.count == handoffs,
           f"pd: {kv_log.count} KV handoffs, expected {handoffs}")
    L, steps = cfg.num_layers, rt.steps
    for name, route in (("dispatch_scatter", "whole"),
                        ("combine_gather", "weighted")):
        expect(launches[name] == L * steps,
               f"pd: {name} launched {launches[name]} times, expected "
               f"{L} layers x {steps} steps")
        expect(by_route[name][route] == launches[name],
               f"pd: {name} launches by route {by_route[name]}, expected "
               f"all {route}")
    expect(launches["super_gmm"] > 0 and launches["flash_attention"] > 0,
           f"pd: a prefill kernel was never launched: {launches}")
    expect(rt.host_syncs == steps, f"pd: {rt.host_syncs} host syncs over "
           f"{steps} decode steps")
    expect(rt.trace_counts["decode_step"] == 1,
           f"pd: {rt.trace_counts['decode_step']} step signatures")
    expect(not out["executor"].errors, "pd: executor worker failed")
    copy_ms, n_copies = rt.enroll_copy_ms()
    expect(n_copies == handoffs, f"pd: {n_copies} enrollment copies")
    ttft = [r.ttft for r in results]
    tpot = [r.tpot for r in results if r.tpot is not None]
    alloc, reserved = (torch.cuda.max_memory_allocated(),
                       torch.cuda.memory_stats()["reserved_bytes.all.peak"])
    print(f"[pd] 8 requests, lengths {lengths}, out_lens {out_lens}: all ok "
          f"with tokens_out == out_len in {out['wall']:.2f}s wall; TTFT mean "
          f"{np.mean(ttft):.3f}s max {np.max(ttft):.3f}s; TPOT mean "
          f"{1e3 * np.mean(tpot):.1f} ms median {1e3 * np.median(tpot):.1f} "
          f"ms max {1e3 * np.max(tpot):.1f} ms")
    print(f"[pd] decode steps {steps} (width 8), host syncs {rt.host_syncs} "
          f"= {rt.host_syncs / max(steps, 1):.2f} per step, step signatures "
          f"{rt.trace_counts['decode_step']}; launches {launches}; "
          f"decode launches by route {by_route} (all whole / weighted)")
    print(f"[pd] KV handoffs {kv_log.count}, {kv_log.bytes / 1e6:.1f} MB, "
          f"priced {1e3 * kv_log.seconds:.3f} ms on the H100 link "
          f"(datasheet NVLink rate); enrollment copies measured on the card "
          f"{copy_ms:.3f} ms in all, {copy_ms / n_copies:.3f} ms mean "
          f"-> {kv_log.bytes / 1e9 / (copy_ms / 1e3):.0f} GB/s")
    print(f"[pd] peak memory allocated {alloc / 1e9:.1f} GB, reserved "
          f"{reserved / 1e9:.1f} GB")
    # the step body itself reads nothing back: one more step (all slots
    # idle, after the counts were read) with the sync debug mode raising
    with torch.inference_mode():
        torch.cuda.set_sync_debug_mode("error")
        try:
            rt._step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    print("[pd] the decode step body runs with the CUDA sync debug mode "
          "raising: no hidden host sync besides the token read")
    step = _decode_breakdown(rt)
    print(f"[pd] launches per decode step: {step['launches']}")
    return {"launches": launches, "by_route": by_route, "steps": steps,
            "hop_us": hop_us, "T": rt.slots, "decode_step": step}


# ------------------------------------------------ batching and lm gmm --


# kernels on the wgmma route: ptxas must spill nothing in them
WGMMA_KERNELS = ("super_gmm_wgmma_kernel", "flash_wgmma_kernel",
                 "flash_wgmma_wide_kernel", "flash_bwd_dkdv_wgmma_kernel",
                 "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wide_kernel",
                 "flash_bwd_dq_wide_kernel")


def _demangle(name: str) -> str:
    """A readable key for an Itanium-mangled kernel name: its namespaces
    and base name, and its integer template arguments
    (`_ZN2wg18flash_wgmma_kernelILi128EEEv...` -> `wg::flash_wgmma_kernel<128>`;
    anonymous namespaces dropped)."""
    if not name.startswith("_Z"):
        return name
    nested = name.startswith("_ZN")
    rest, i, parts = name[2 + nested:], 0, []
    while i < len(rest) and rest[i].isdigit():
        j = i
        while j < len(rest) and rest[j].isdigit():
            j += 1
        parts.append(rest[j:j + int(rest[i:j])])
        i = j + int(rest[i:j])
        if not nested:
            break
    ints = re.findall(r"L[ijlb](\d+)E", rest[i:].split("EEv")[0] + "E")
    parts = [p for p in parts if not p.startswith("_GLOBAL__N")]
    return "::".join(parts) + (f"<{', '.join(ints)}>" if ints else "")


def ptxas_kernels(report: str) -> dict:
    """Registers and spill bytes (stores + loads) of every entry function
    in ptxas's `-v` report, by demangled name."""
    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = _demangle(m.group(1))
            out.setdefault(fn, {})
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            fn = _demangle(m.group(1))
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def phase_analysis_static() -> dict:
    """The card-side checks that need no model: the port's static pass on
    this checkout, the launch functions' ABI against the built library,
    and ptxas's registers and spills."""
    from repro_torch.analysis import run_static
    from repro_torch.analysis.kernelcheck import (C_TO_CTYPES, parse_declare,
                                                  parse_externs)
    from repro_torch.analysis.model import build_models, collect_files
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                       "repro_torch")
    t0 = time.time()
    res = run_static([src], strict_suppressions=True)
    lint_s = time.time() - t0
    for f in res.unsuppressed:
        print(f"[analysis] {f.format()}")
    expect(res.unsuppressed == [], f"analysis: {len(res.unsuppressed)} "
           f"unsuppressed finding(s) in {src}")
    print(f"[analysis] asaplint over {len(res.files)} files of {src}: "
          f"{len(res.findings)} findings, all suppressed with a reason "
          f"({collections.Counter(f.rule for f in res.suppressed)}), "
          f"{len(res.lock_edges)} static lock-order edges, {lint_s:.1f}s")
    # (b) every extern "C" the pass parsed is a symbol of the built library
    models = build_models(collect_files([src]))
    externs = [s for fm in models.values() if fm.lang == "cu"
               for s in parse_externs(fm)]
    n_declared = sum(len(parse_declare(fm)) for fm in models.values()
                     if fm.lang == "py")
    expect(len(externs) == n_declared == 8,
           f"analysis: {len(externs)} extern \"C\" functions, "
           f"{n_declared} _declare entries (8 expected)")
    lib = _build.load()
    for sig in externs:
        fn = getattr(lib, sig.name, None)  # ctypes: None if no such symbol
        expect(fn is not None, f"analysis: {sig.name} is no symbol of "
               f"{_build.library_path()}")
        got = list(fn.argtypes or ())
        expect(len(got) == len(sig.params),
               f"analysis: {sig.name} argtypes {len(got)} != C arity "
               f"{len(sig.params)}")
        # by identity: c_longlong is c_long where both are 8 bytes
        want = [getattr(ctypes, C_TO_CTYPES.get(p, ""), None)
                for p in sig.params]
        expect(all(g is w for g, w in zip(got, want)),
               f"analysis: {sig.name} argtypes {got} vs C {sig.params}")
        expect(fn.restype is ctypes.c_int,
               f"analysis: {sig.name} restype {fn.restype}")
    print(f"[analysis] ABI: {len(externs)} extern \"C\" launch functions "
          f"of csrc/*.cu are symbols of {_build.library_path().name}, each "
          f"with its C arity and types in argtypes and restype c_int: "
          + ", ".join(f"{s.name}({len(s.params)})" for s in externs))
    # (c) ptxas: registers and spills of every kernel; no serialized wgmma
    report = _build.ptxas_report()
    expect(report != "", "analysis: no ptxas report beside the library")
    kernels = ptxas_kernels(report)
    for name, k in sorted(kernels.items()):
        print(f"[analysis] ptxas {name}: {k.get('registers')} registers, "
              f"{k.get('spill')} spill bytes")
    expect("C7520" not in report, "analysis: ptxas serialized a wgmma "
           "(C7520):\n" + "\n".join(line for line in report.splitlines()
                                     if "C7520" in line))
    wg = {n: k for n, k in kernels.items()
          if any(base in n for base in WGMMA_KERNELS)}
    expect({base for base in WGMMA_KERNELS if any(base in n for n in wg)}
           == set(WGMMA_KERNELS), f"analysis: wgmma kernels missing from "
           f"the ptxas report: {sorted(wg)}")
    spilled = {n: k for n, k in wg.items() if k.get("spill") != 0}
    expect(not spilled, f"analysis: wgmma kernels spill: {spilled}")
    print(f"[analysis] ptxas: {len(kernels)} entry functions, no C7520, "
          f"0 spill bytes in all {len(wg)} wgmma kernels (registers "
          + ", ".join(f"{n} {k['registers']}" for n, k in sorted(wg.items()))
          + ")")
    return {"findings": len(res.findings), "files": len(res.files),
            "lint_s": lint_s, "externs": [s.name for s in externs],
            "ptxas": kernels}


def phase_analysis_wave(cfg, params, seed: int, serve=None) -> dict:
    """The serve phase's wave (model, requests, set-up wave) with the
    port's lockdep installed before the executor and engine are built,
    raising at the offending acquire or wait."""
    from repro_torch.analysis import lockdep
    from repro_torch.launch.serve import serve_requests
    rng = np.random.default_rng(seed)
    lengths = [int(x) for x in rng.integers(256, 2049, size=8)]
    kw = dict(rps=8.0, time_scale=1.0, seed=seed, device=DEV,
              max_batch_tokens=4096)
    kernels = _pd_kernels()
    lockdep.reset()
    with lockdep.lockdep_active(raise_on_violation=True):
        # set-up, as in the serve phase: the executor built and warmed by
        # one wave, every worker's first calls made on its own stream
        ex = serve_requests(cfg, params,
                            lengths=[1900, 1500, 700, 900, 300, 400],
                            **kw)["executor"]
        kw["executor"] = ex
        torch.cuda.synchronize()
        for k in kernels.values():
            _launch.reset_launches(k)
        out = serve_requests(cfg, params, lengths=lengths, **kw)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in kernels.items()}
        by_route = {"super_gmm": _routes(super_gmm),
                    "flash_attention": _routes(flash_attention)}
        violations = lockdep.violations()
        edges = lockdep.learned_edges()
        covered = sorted(lockdep.instrumented_sites())
        expect(not ex.errors, f"analysis: executor worker failed: "
               f"{ex.errors}")
    lockdep.reset()
    kw.pop("executor")
    del ex
    _free()
    results = out["results"]
    expect(len(results) == 8 and all(r.ok for r in results),
           "analysis: not every request of the sanitized wave served")
    expect(violations == [], f"analysis: lockdep violations {violations}")
    expect(launches["super_gmm"] > 0 and launches["flash_attention"] > 0,
           f"analysis: a kernel was never launched in the sanitized wave: "
           f"{launches}")
    for name in by_route:
        expect(by_route[name]["wgmma"] == launches[name],
               f"analysis: {name} launches by route {by_route[name]}")
    sites = sorted({s for pair in edges for s in pair})
    expect(len(covered) > 0, "analysis: lockdep instrumented no lock")
    print(f"[analysis] serve wave under the port's lockdep: 8/8 served in "
          f"{out['wall']:.2f}s wall, mean TTFT "
          f"{np.mean([r.ttft for r in results]):.3f}s (the unsanitized serve "
          "phase: " + (f"{serve['wall_s']:.2f}s, {serve['ttft_mean_s']:.3f}s"
                       if serve else "not run")
          + f"), 0 violations; {len(covered)} lock creation sites "
          f"instrumented, {len(edges)} learned lock-order edges over "
          f"{len(sites)} of them; launches {launches}, by route {by_route}")
    print("[analysis] instrumented sites: " + ", ".join(covered))
    for (a, b), wit in sorted(edges.items()):
        print(f"[analysis]   {a} -> {b}   ({wit})")
    return {"wall_s": out["wall"],
            "serve_wall_s": serve["wall_s"] if serve else None,
            "edges": len(edges), "edge_sites": len(sites),
            "instrumented_sites": len(covered),
            "violations": 0, "launches": launches, "by_route": by_route,
            "ttft_mean_s": float(np.mean([r.ttft for r in results]))}


def _pinned(tokens, D):
    """Fresh jobs of `tokens`, job i pinned to attention group i % D."""
    from repro_torch.core.executor import BatchJob
    return [[BatchJob(tokens=tokens[i], bid=i)
             for i in range(g, len(tokens), D)] for g in range(D)]


def _wave(ex, tokens, D) -> tuple:
    """One pinned wave through `ex` (workers started and stopped by
    `run`), the launch and host-sync counts set to 0 just before it and read
    just after.  Returns (results by bid, readings)."""
    ex.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = _pd_kernels()
    for k in kernels.values():
        _launch.reset_launches(k)
    _launch.reset_host_syncs()
    t0 = time.perf_counter()
    done = ex.run(_pinned(tokens, D))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = _launch.reset_host_syncs()
    expect(not ex.errors and len(done) == len(tokens), "wave: a job failed")
    with ex._log_lock:
        batch_layers = sum(1 for ev in ex.log if ev[0] == "combine")
    launches = float(ex.moe_launches.sum())
    return {j.bid: j.result for j in done}, {
        "wall_s": wall,
        "tokens_per_s": sum(int(np.prod(t.shape)) for t in tokens) / wall,
        "host_syncs": syncs, "batch_layers": batch_layers,
        "host_syncs_per_batch_layer": syncs / max(batch_layers, 1),
        "super_kernel_launches": int(launches),
        "regions_per_launch": float(ex.moe_launch_regions.sum())
        / max(launches, 1.0),
        "occupancy": float(ex.moe_launch_rows.sum())
        / max(float(ex.moe_launch_slots.sum()), 1.0),
        "bucket_misses": int(ex.bucket_misses.sum()),
        "launches": {n: k.launches for n, k in kernels.items()},
        "super_gmm": super_gmm.launches,
        "super_gmm_by_route": _routes(super_gmm),
        "flash_attention": flash_attention.launches,
        "flash_attention_by_route": _routes(flash_attention),
        "peak_reserved_gb":
            torch.cuda.memory_stats()["reserved_bytes.all.peak"] / 1e9}


def _fmt_wave(r: dict) -> str:
    return (f"{r['tokens_per_s']:.0f} tokens/s ({r['wall_s']:.3f}s wall), "
            f"host syncs {r['host_syncs_per_batch_layer']:.2f} per "
            f"batch-layer ({r['host_syncs']} / {r['batch_layers']}), Super "
            f"Kernel launches {r['super_kernel_launches']}, "
            f"{r['regions_per_launch']:.2f} regions/launch, occupancy "
            f"{r['occupancy']:.3f}, bucket misses {r['bucket_misses']}, peak "
            f"reserved {r['peak_reserved_gb']:.1f} GB")


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def phase_batching(cfg, params, seed: int) -> dict:
    """Cross-region continuous batching and the executor's baselines, at
    the serve phase's full width (built after the serve and pd executors
    were released): (1) the same pinned jobs through a per-region and a
    batched executor, torch.equal; (2) the reference's light-load arm, D=8
    groups of short prompts feeding E=2 MoE devices, per-region and batched
    in interleaved turns, best of 3 each; (3) the eager and host-combine
    arms against the dense oracle in fp32 at the small config, host
    combine == device combine, and fused vs eager at full width."""
    from repro_torch.core.executor import DisaggregatedExecutor
    from repro_torch.models.lm import init_lm_params
    rng = np.random.RandomState(seed)
    out = {}
    # (1) bitwise: 8 jobs of 256 tokens over D=4 groups, E=4 devices; a
    # token picks an expert at most once, so rows per expert <= S per
    # region and <= D*S merged
    D, E, S = 4, 4, 256
    tokens = [rng.randint(0, cfg.vocab_size, (1, S)) for _ in range(2 * D)]
    ex0 = DisaggregatedExecutor(params, cfg, D=D, E=E, device=DEV)
    ex0.prewarm_buckets(S)
    ex1 = DisaggregatedExecutor(params, cfg, D=D, E=E, moe_batch_window=0.01,
                                device=DEV)
    ex1.prewarm_buckets(D * S)
    res0, r0 = _wave(ex0, tokens, D)
    res1, r1 = _wave(ex1, tokens, D)
    for i in res0:
        expect(torch.equal(res0[i], res1[i]),
               f"batching: job {i} batched != per-region")
        expect(bool(torch.isfinite(res1[i].float()).all()),
               "batching: output not finite")
    expect(r1["regions_per_launch"] > 1,
           f"batching: nothing merged ({r1['regions_per_launch']:.2f} "
           f"regions/launch)")
    for name, r in (("per-region", r0), ("batched", r1)):
        expect(r["super_gmm"] > 0 and r["super_gmm_by_route"]["wgmma"]
               == r["super_gmm"], f"batching {name}: super_gmm launches by "
               f"route {r['super_gmm_by_route']}")
        expect(r["bucket_misses"] == 0,
               f"batching {name}: {r['bucket_misses']} new buckets after "
               f"prewarm")
    print(f"[batching] D={D} E={E}, {2 * D} jobs of [1, {S}], window 10 ms: "
          f"batched torch.equal per-region on every job; every super_gmm "
          f"launch on wgmma, 0 bucket misses after prewarm")
    print(f"[batching] per-region: {_fmt_wave(r0)}")
    print(f"[batching] batched:    {_fmt_wave(r1)}")
    out["bitwise"] = {"per_region": r0, "batched": r1, "D": D, "E": E,
                      "S": S, "window_s": 0.01}
    del ex0, ex1, res0, res1
    _free()
    # (2) light load: short prompts, many groups, few MoE devices
    D, E, window = 8, 2, 0.002
    lengths = [int(n) for n in rng.choice([64, 128, 256], size=2 * D)]
    tokens = [rng.randint(0, cfg.vocab_size, (1, n)) for n in lengths]
    arms = {"per_region": DisaggregatedExecutor(params, cfg, D=D, E=E,
                                                device=DEV),
            "batched": DisaggregatedExecutor(params, cfg, D=D, E=E,
                                             moe_batch_window=window,
                                             device=DEV)}
    arms["per_region"].prewarm_buckets(max(lengths))
    arms["batched"].prewarm_buckets(D * max(lengths))
    for ex in arms.values():
        _wave(ex, tokens, D)  # warm-up, not counted
    best, turns = {}, []
    for turn in range(3):  # interleaved: jitter hits both arms alike
        order = ("per_region", "batched") if turn % 2 == 0 \
            else ("batched", "per_region")
        for name in order:
            _, r = _wave(arms[name], tokens, D)
            turns.append((name, r["tokens_per_s"]))
            if name not in best \
                    or r["tokens_per_s"] > best[name]["tokens_per_s"]:
                best[name] = r
    ratio = best["batched"]["tokens_per_s"] \
        / best["per_region"]["tokens_per_s"]
    print(f"[batching] light load: D={D} groups, E={E} MoE devices, "
          f"{len(lengths)} prompts of {lengths} tokens, window "
          f"{window * 1e3:g} ms, best of 3 interleaved turns "
          f"({', '.join(f'{n} {v:.0f}' for n, v in turns)} tokens/s)")
    for name in ("per_region", "batched"):
        print(f"[batching]   {name}: {_fmt_wave(best[name])}")
    print(f"[batching]   batched / per-region tokens/s = {ratio:.3f} "
          f"(the reference's floor 0.95: "
          f"{'met' if ratio >= 0.95 else 'NOT met'}; reported, not gated)")
    out["light_load"] = {"best": best, "turns": turns, "ratio": ratio,
                         "D": D, "E": E, "lengths": lengths,
                         "window_s": window}
    del arms
    _free()
    # (3) the baselines.  fp32 at the small config: every arm against the
    # dense oracle, and the host combine == the device combine
    small = get_config(ARCH).smoke().replace(num_layers=3)
    sp = init_lm_params(torch.Generator(device=DEV).manual_seed(1), small,
                        DEV)
    errs, res = {}, {}
    for name, kw in (("fused", {}), ("fused+host", {"combine_path": "host"}),
                     ("eager", {"moe_path": "eager"}),
                     ("eager+host", {"moe_path": "eager",
                                     "combine_path": "host"})):
        errs[name], _, res[name] = _executor_vs_oracle(small, sp, 2, 48, **kw)
        expect(errs[name] <= 2e-4, f"{name} vs dense oracle (fp32): err "
               f"{errs[name]}")
    for a, b in (("fused", "fused+host"), ("eager", "eager+host")):
        expect(all(torch.equal(x, y) for x, y in zip(res[a], res[b])),
               f"{b}: host combine != device combine")
    print(f"[batching] baselines fp32 {small.num_layers}L x "
          f"{small.num_experts}e vs lm_backbone(moe_mode='dense'): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + " (tol 2e-4); host combine torch.equal device combine, fused "
          "and eager")
    out["baselines_fp32_err"] = errs
    del sp, res
    # full width: host == device combine, then fused vs eager tokens/s
    D, E = 2, 4
    tokens = [rng.randint(0, cfg.vocab_size, (1, 512)) for _ in range(2)]
    exs = {"fused": DisaggregatedExecutor(params, cfg, D=D, E=E, device=DEV),
           "host": DisaggregatedExecutor(params, cfg, D=D, E=E,
                                         combine_path="host", device=DEV),
           "eager": DisaggregatedExecutor(params, cfg, D=D, E=E,
                                          moe_path="eager", device=DEV)}
    exs["fused"].prewarm_buckets(512)
    exs["host"].prewarm_buckets(512)
    got = {n: _wave(ex, tokens, D) for n, ex in exs.items()}  # warm-up too
    expect(all(torch.equal(got["fused"][0][i], got["host"][0][i])
               for i in range(2)), "full width: host combine != device")
    expect(got["eager"][1]["super_gmm"] == 0
           and got["eager"][1]["flash_attention"] == 0,
           "the eager arm launched a kernel of the port")
    rel = float(max((got["eager"][0][i].float() - got["fused"][0][i].float())
                    .norm() / got["fused"][0][i].float().norm()
                    for i in range(2)))
    expect(rel <= 0.1, f"full width: eager vs fused rel err {rel}")
    best = {}
    for name in ("fused", "eager", "eager", "fused"):
        _, r = _wave(exs[name], tokens, D)
        if name not in best or r["tokens_per_s"] > best[name]["tokens_per_s"]:
            best[name] = r
    fe = best["fused"]["tokens_per_s"] / best["eager"]["tokens_per_s"]
    print(f"[batching] full width, 2 jobs of [1, 512], D={D} E={E}: host "
          f"combine torch.equal device combine; eager vs fused relative "
          f"Frobenius err {rel:.3e} (tol 1e-1); best of 2 in turns fused, "
          f"eager, eager, fused:")
    for name in ("fused", "eager"):
        print(f"[batching]   {name}: {_fmt_wave(best[name])}")
    print(f"[batching]   fused / eager tokens/s = {fe:.2f} (the reference's "
          f"target >= 3)")
    out["fused_vs_eager"] = {"best": best, "ratio": fe, "rel_err": rel}
    del exs, got
    _free()
    return out


def _fault_arm(name, ex, tokens, D, plan=None, ref=None) -> tuple:
    """One pinned wave through a fresh executor (built and prewarmed by the
    caller), `plan` armed just before `run`; the launch counts set to 0
    just before the wave and read just after.  Results torch.equal to
    `ref` where given.  Returns (results by bid, readings)."""
    kernels = _pd_kernels()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_allocated()
    ms0 = torch.cuda.memory_stats()
    for k in kernels.values():
        _launch.reset_launches(k)
    if plan is not None:
        ex.arm_faults(plan)
    t0 = time.perf_counter()
    done = ex.run(_pinned(tokens, D), timeout=300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect(not ex.errors and len(done) == len(tokens)
           and all(j.failed is None for j in done), f"faults {name}: a job "
           f"failed")
    res = {j.bid: j.result for j in done}
    for i, r in res.items():
        expect(bool(torch.isfinite(r.float()).all()),
               f"faults {name}: output not finite")
        if ref is not None:
            expect(torch.equal(r, ref[i]),
                   f"faults {name}: job {i} != the fault-free wave "
                   f"(max abs err {max_err(r, ref[i]):.3e})")
    launches = {n: k.launches for n, k in kernels.items()}
    for kname in ("super_gmm", "flash_attention"):
        n, by = launches[kname], _routes(kernels[kname])
        expect(n > 0 and by["wgmma"] == n,
               f"faults {name}: {kname} launches by route {by}")
    with ex._log_lock:
        log = list(ex.log)
    ms = torch.cuda.memory_stats()
    return res, {
        "wall_s": wall, "launches": launches,
        "failovers": ex.failovers, "dead": list(ex.placement.dead),
        "retries": [j.retries for j in sorted(done, key=lambda j: j.bid)],
        "bucket_misses": int(ex.bucket_misses.sum()),
        "super_kernel_launches": int(ex.moe_launches.sum()),
        "orphans_served": sum(1 for ev in log if ev[0] == "moe-failover"),
        "supervisor_launches": sum(1 for ev in log
                                   if ev[0] == "moe-failover" and ev[5]),
        "failover_wall_s": [end[4] - begin[3] for begin, end in zip(
            [ev for ev in log if ev[0] == "failover-begin"],
            [ev for ev in log if ev[0] == "failover"])],
        "migrations": [dict(r, devices=list(r["devices"]))
                       for r in ex.migrations],
        "fired": [ev.to_dict() for ev in ex.fault_injector.fired_events()]
        if ex.fault_injector is not None else [],
        "allocated_before_gb": alloc0 / 1e9,
        "peak_allocated_gb": ms["allocated_bytes.all.peak"] / 1e9,
        "peak_reserved_gb": ms["reserved_bytes.all.peak"] / 1e9,
        "allocated_after_gb": torch.cuda.memory_allocated() / 1e9,
        # the caching allocator during the wave: a swap's new stacks are
        # fresh multi-GB blocks
        "cuda_malloc": ms["num_device_alloc"] - ms0["num_device_alloc"],
        "cuda_free": ms["num_device_free"] - ms0["num_device_free"],
        "alloc_retries": ms["num_alloc_retries"] - ms0["num_alloc_retries"]}


def _fmt_failover(r: dict) -> str:
    m = [x for x in r["migrations"] if x["kind"] == "failover"]
    out = (f"failovers {r['failovers']} (dead {r['dead']}), wall "
           f"{r['wall_s']:.3f}s, orphans served by the supervisor "
           f"{r['orphans_served']} in {r['supervisor_launches']} Super "
           f"Kernel launches, failover "
           f"{', '.join(f'{1e3 * s:.1f}' for s in r['failover_wall_s'])} ms "
           f"(failover-begin to failover)")
    for x in m:
        rate = 2 * x["copy_bytes"] / max(x["copy_seconds"], 1e-12)
        out += (f"; swap {1e3 * x['seconds']:.1f} ms, gained "
                f"{x['bytes'] / 1e9:.3f} GB, gathers wrote "
                f"{x['copy_bytes'] / 1e9:.2f} GB and read as much in "
                f"{1e3 * x['copy_seconds']:.1f} ms = {rate / 1e12:.2f} TB/s "
                f"({rate / HBM_BYTES_PER_S:.0%} of the HBM bound, bound "
                f"{1e3 * 2 * x['copy_bytes'] / HBM_BYTES_PER_S:.1f} ms)")
    return out + (f"; new bucket misses {r['bucket_misses']}; memory "
                  f"allocated {r['allocated_before_gb']:.1f} GB before, "
                  f"{r['allocated_after_gb']:.1f} GB after, peak allocated "
                  f"{r['peak_allocated_gb']:.1f} GB, peak reserved "
                  f"{r['peak_reserved_gb']:.1f} GB; cudaMalloc "
                  f"{r['cuda_malloc']}, cudaFree {r['cuda_free']}, "
                  f"allocation retries {r['alloc_retries']} in the wave")


def phase_faults(cfg, params, seed: int, serve=None) -> dict:
    """Supervised failover at the serve phase's full width (after the
    serve executor is released): 8 pinned jobs of [1, 512] tokens through
    DisaggregatedExecutor(D=2, E=4), round-robin, each arm on a fresh
    executor released after it ran.  (1) fault-free, its wall W; (2) MoE
    device 1 crashed at 0.3 W; (3) the same, continuous batching (window
    2 ms, 4096 rows); (4) device 0 drops a combine (region_timeout 2 s);
    (5) device 0 stalls (stall_timeout 0.5 s).  Arms 2-5 torch.equal to
    arm 1, every Super Kernel and flash launch on wgmma, the kernel
    library not rebuilt.  (6) the serve phase's 8-request wave through
    ExecutorEngine with device 1 crashed at 0.5 s of trace: 8/8 ok, one
    failover."""
    from repro_torch.core.executor import DisaggregatedExecutor
    from repro_torch.core.faults import FaultEvent, FaultPlan
    from repro_torch.launch.serve import prewarm_rows, serve_requests
    D, E, S = 2, 4, 512
    rng = np.random.RandomState(seed + 17)
    tokens = [rng.randint(0, cfg.vocab_size, (1, S)) for _ in range(8)]
    lib, lib_path = _build.load(), _build.library_path()
    lib_mtime = lib_path.stat().st_mtime_ns
    # one expert's three projections, one layer (bf16 at full width)
    copy_unit = 3 * cfg.d_model * cfg.expert_d_ff * torch.empty(
        (), dtype=cfg.dtype).element_size()
    launches = collections.Counter()
    out = {}

    def arm(name, plan=None, ref=None, prewarm=S, **kw):
        ex = DisaggregatedExecutor(params, cfg, D=D, E=E, device=DEV, **kw)
        # built and warmed before a plan arms: the buckets, then one wave
        # (not counted) that makes every thread's first calls on its stream
        ex.prewarm_buckets(prewarm)
        ex.run(_pinned(tokens, D), timeout=300)
        ex.reset_stats()
        res, r = _fault_arm(name, ex, tokens, D, plan, ref)
        launches.update(r["launches"])
        out[name] = r
        del ex
        _free()
        return res, r

    ref, r1 = arm("fault_free")
    W = r1["wall_s"]
    print(f"[faults] fault-free: 8 jobs of [1, {S}] tokens, D={D} E={E} "
          f"round-robin: {W:.3f}s wall, Super Kernel launches "
          f"{r1['super_kernel_launches']}, peak allocated "
          f"{r1['peak_allocated_gb']:.1f} GB")
    crash = FaultPlan([FaultEvent(t=0.3 * W, kind="crash_moe", device=1)])
    for name, kw in (("crash", {}),
                     ("batched_crash", {"moe_batch_window": 0.002,
                                        "moe_batch_max_tokens": 4096})):
        _, r = arm(name, crash, ref, prewarm=D * S if kw else S, **kw)
        fo = [m for m in r["migrations"] if m["kind"] == "failover"]
        expect(r["failovers"] == 1 and r["dead"] == [1] and len(fo) == 1,
               f"faults {name}: failovers {r['failovers']}, dead "
               f"{r['dead']}, migrations {r['migrations']}")
        expect(fo[0]["bytes"] == 32 * cfg.num_layers * copy_unit,
               f"faults {name}: failover bytes {fo[0]['bytes']}")
        print(f"[faults] {name} (device 1 at t={0.3 * W:.3f}s"
              + (", window 2 ms, 4096 rows" if kw else "") + "): every job "
              f"torch.equal to the fault-free wave; " + _fmt_failover(r))
    _, r = arm("drop", FaultPlan([FaultEvent(t=0.0, kind="drop_combine",
                                             device=0)]), ref,
               region_timeout=2.0)
    expect(max(r["retries"]) >= 1 and r["fired"] == [FaultEvent(
        t=0.0, kind="drop_combine", device=0).to_dict()],
        f"faults drop: retries {r['retries']}, fired {r['fired']}")
    print(f"[faults] drop_combine on device 0 (region_timeout 2 s): every "
          f"job torch.equal to the fault-free wave, retries {r['retries']}, "
          f"wall {r['wall_s']:.3f}s")
    _, r = arm("stall", FaultPlan([FaultEvent(t=0.0, kind="stall_moe",
                                              device=0, duration=1e9)]),
               ref, stall_timeout=0.5)
    expect(r["failovers"] == 1 and 0 in r["dead"],
           f"faults stall: failovers {r['failovers']}, dead {r['dead']}")
    print(f"[faults] stall_moe on device 0 (stall_timeout 0.5 s): every job "
          f"torch.equal to the fault-free wave; " + _fmt_failover(r))
    # (6) the engine: the serve phase's wave with device 1 crashed
    lengths = serve["lengths"] if serve is not None else [
        int(x) for x in np.random.default_rng(seed).integers(256, 2049,
                                                            size=8)]
    ex = DisaggregatedExecutor(params, cfg, D=D, E=E, device=DEV)
    ex.prewarm_buckets(prewarm_rows(4096, D, 0.0, None))
    kernels = _pd_kernels()
    for k in kernels.values():
        _launch.reset_launches(k)
    eng = serve_requests(cfg, params, lengths=lengths, rps=8.0,
                         time_scale=1.0, seed=seed, device=DEV,
                         max_batch_tokens=4096, executor=ex,
                         fault_plan=FaultPlan(
                             [FaultEvent(t=0.5, kind="crash_moe",
                                         device=1)]))
    torch.cuda.synchronize()
    launches.update({n: k.launches for n, k in kernels.items()})
    results, st = eng["results"], eng["stats"]
    expect(len(results) == 8 and all(r.status == "ok" for r in results)
           and st.failovers == 1, f"faults engine: statuses "
           f"{st.statuses}, failovers {st.failovers}")
    ttft = [r.ttft for r in results]
    out["engine"] = {"lengths": lengths, "statuses": st.statuses,
                     "failovers": st.failovers, "wall_s": eng["wall"],
                     "ttft_mean_s": float(np.mean(ttft)),
                     "ttft_max_s": float(np.max(ttft)),
                     "bucket_misses": st.bucket_misses}
    base = (f"serve phase (fault-free) mean {serve['ttft_mean_s']:.3f}s, max "
            f"{serve['ttft_max_s']:.3f}s" if serve is not None
            else "serve phase not run")
    print(f"[faults] engine: the serve wave ({lengths} tokens, 8 req/s) "
          f"with device 1 crashed at 0.5 s of trace: 8/8 ok, failovers "
          f"{st.failovers}, TTFT mean {np.mean(ttft):.3f}s, max "
          f"{np.max(ttft):.3f}s ({base}); new bucket misses "
          f"{st.bucket_misses}")
    del eng, ex
    _free()
    expect(_build.load() is lib and _build.library_path() == lib_path
           and lib_path.stat().st_mtime_ns == lib_mtime,
           "faults: the kernel library was rebuilt")
    for name in ("dispatch_scatter", "combine_gather"):
        expect(launches[name] == 0, f"faults: {name} launched "
               f"{launches[name]} times on the prefill path")
    out["launches"] = dict(launches)
    out["library"] = lib_path.name
    return out


# -------------------------------------------- placement control (live) --


def _skew_router(params, alpha: float = 2.0, ep: int = 4):
    """A shallow copy of `params` whose router leaf ([L, d, E] fp32) is a
    copy with its logit columns scaled by zipf(`alpha`)-ranked factors, so
    the REAL router concentrates traffic on a few hot experts.  The hottest
    ranks go to the experts that share device 0 under round-robin (e % ep),
    the straggler the control plane exists for (the reference's
    `fig_rebalance._skew_router`).  `params` itself is left as it was."""
    ffn = params["stages"][0]["ffn"]
    r = ffn["router"]
    n = r.shape[-1]
    f = np.arange(1, n + 1, dtype=np.float64) ** (-alpha)
    f = f / f.mean()
    order = sorted(range(n), key=lambda e: (e % ep, e // ep))
    scale = np.empty(n)
    scale[order] = f
    out = dict(params)
    out["stages"] = [dict(st) for st in params["stages"]]
    out["stages"][0]["ffn"] = dict(ffn, router=r * torch.as_tensor(
        scale, dtype=r.dtype, device=r.device))
    return out


def measure_h100_fields(cfg) -> dict:
    """The fields of `core.cost_model.H100` taken on this card: hop_latency
    (a 4 KiB device-to-device copy issued back to back, CUDA events),
    base_latency (its device time, profiler), host_dispatch (the host's
    time to issue one `super_gmm` wrapper call at a decode-size shape:
    8 experts, 8 rows each), p2p_handshake (an event recorded on one
    stream, waited on by another, then a host sync), flop_efficiency (dense
    `super_gmm` at the serve wave's gate/up shape, TFLOP/s over the 989
    peak; device time by the profiler, as the timing phase reads it).
    Seconds, except flop_efficiency."""
    base_us, hop_us = _hop_latency_us()
    bf = torch.bfloat16
    d, f = cfg.d_model, cfg.expert_d_ff
    layer = torch.zeros(1, dtype=torch.int32, device=DEV)
    w = torch.randn((1, 8, d, f), dtype=bf, device=DEV) * 0.02
    xb = torch.randn((8, 8, d), dtype=bf, device=DEV)
    counts = torch.full((8,), 8, dtype=torch.int32, device=DEV)
    host_us = _host_us(lambda: super_gmm(layer, w, xb, counts))
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    ev = torch.cuda.Event()

    def rendezvous():
        ev.record(s1)
        s2.wait_event(ev)
        s2.synchronize()
    p2p_us = _host_us(rendezvous, reps=500)
    n_e, C = 32, 512
    w = torch.randn((1, n_e, d, f), dtype=bf, device=DEV) * 0.02
    xb = torch.randn((n_e, C, d), dtype=bf, device=DEV)
    ms, _ = _device_ms(lambda: super_gmm(layer, w, xb, None), 20)
    tflops = 2.0 * n_e * C * d * f / (ms / 1e3) / 1e12
    del w, xb
    return {"hop_latency": hop_us * 1e-6, "base_latency": base_us * 1e-6,
            "host_dispatch": host_us * 1e-6, "p2p_handshake": p2p_us * 1e-6,
            "flop_efficiency": tflops / (PEAK_FLOPS[bf] / 1e12),
            "dense_super_gmm_tflops": tflops}


def _engine_wave(eng, rids, slen: int) -> tuple:
    """Submit requests `rids` of `slen` tokens, all arriving at 0, and drain
    them: (results by rid, wall seconds, whether any rid came back twice)."""
    from repro_torch.core.trace import Request
    t0 = time.perf_counter()
    eng.submit_all([Request(rid=i, arrival=0.0, length=slen) for i in rids])
    res = eng.drain(timeout=300)
    wall = time.perf_counter() - t0
    by_rid = {r.rid: r for r in res}
    expect(len(by_rid) == len(res) == len(rids) and set(by_rid) == set(rids)
           and all(r.status == "ok" for r in res),
           f"rebalance: wave {rids[0]}.. statuses "
           f"{[(r.rid, r.status) for r in res]}")
    return by_rid, wall


def phase_rebalance(cfg, params, seed: int) -> dict:
    """Live re-placement under skewed routing at the serve phase's full
    width (the reference's `fig_rebalance.executor_panel`): the router of a
    shallow copy of the model is zipf(2.0)-skewed onto device 0's
    round-robin experts; two arms, each on a fresh
    DisaggregatedExecutor(D=2, E=4) released after it: frozen round-robin,
    and live -- ExecutorEngine(rebalance_interval=0.25,
    rebalance_threshold=1.02, rebalance_target=replicated(2)) on
    TraceClock(speed=1000) -- in turns frozen, live, live, frozen.  Each
    turn serves two warm waves of 4 x 512 tokens and a measured wave of
    10 x 512, all arriving at 0; then 8 pinned jobs of [1, 512] through its
    executor.  Gated: the live arm migrates (>= 1, placement
    "replicated"), every request of every wave ends ok exactly once, the
    live table equals the one ExpertLoadModel gives for the executor's
    measured fractions and every host holds its experts, the measured
    wave's first tokens are equal rid by rid across the turns, the pinned
    jobs are torch.equal across the turns, every
    super_gmm / flash_attention launch takes wgmma, and the kernel library
    is not rebuilt.  Also prints the fields of `cost_model.H100` measured on
    this card beside the preset."""
    from repro_torch.core.cost_model import (H100, ExpertLoadModel,
                                             Placement)
    from repro_torch.core.engine import ExecutorEngine
    from repro_torch.core.executor import DisaggregatedExecutor
    from repro_torch.core.scheduler import LengthAwareBatcher
    from repro_torch.core.trace import TraceClock
    t_phase = time.perf_counter()
    D, E, S = 2, 4, 512
    speed = 1000.0  # trace seconds per wall second: the executor's clock
    lib, lib_path = _build.load(), _build.library_path()
    lib_mtime = lib_path.stat().st_mtime_ns
    measured = measure_h100_fields(cfg)
    print("[rebalance] cost_model.H100 fields, the preset vs measured on "
          "this card: " + ", ".join(
              f"{k} {getattr(H100, k):.4g} vs {measured[k]:.4g}"
              for k in ("hop_latency", "base_latency", "host_dispatch",
                        "p2p_handshake", "flop_efficiency"))
          + f" (dense super_gmm {measured['dense_super_gmm_tflops']:.1f} "
          f"TFLOP/s at n_e=32 C=512 K={cfg.d_model} N={cfg.expert_d_ff})")
    skewed = _skew_router(params)
    rng = np.random.RandomState(seed + 23)
    tokens = [rng.randint(0, cfg.vocab_size, (1, S)) for _ in range(8)]
    target = Placement("replicated", replicate_hot=2)
    kernels = _pd_kernels()
    launches = collections.Counter()
    out = {"h100_measured": measured, "turns": []}
    first, pinned = None, None
    # in turns, so neither arm is always the first on a cold allocator
    for arm in ("frozen", "live", "live", "frozen"):
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated()
        reserved0 = torch.cuda.memory_reserved()
        for k in kernels.values():
            _launch.reset_launches(k)
        ex = DisaggregatedExecutor(skewed, cfg, D=D, E=E, device=DEV)
        kw = dict(rebalance_interval=0.25, rebalance_threshold=1.02,
                  rebalance_target=target) if arm == "live" else {}
        eng = ExecutorEngine(
            ex, clock=TraceClock(speed=speed), token_seed=seed,
            batcher=LengthAwareBatcher(inflection=64, max_tokens=2 * S,
                                       exclusive_cutoff=1 << 30,
                                       max_wait=0.02), **kw)
        misses = []  # new capacity shapes met in each wave
        for wave in range(2):
            _engine_wave(eng, [10_000 + 100 * wave + i for i in range(4)], S)
            misses.append(int(ex.bucket_misses.sum()) - sum(misses))
        busy0 = ex.moe_busy.copy()
        res, wall = _engine_wave(eng, list(range(10)), S)
        torch.cuda.synchronize()
        busy = ex.moe_busy - busy0
        misses.append(int(ex.bucket_misses.sum()) - sum(misses))
        st = eng.stats()
        tokens_first = {rid: r.first_token for rid, r in res.items()}
        windows = [{"t": float(t), "busy": [float(x) for x in w],
                    "imbalance": float(i)} for t, w, i in eng.rebalance_windows]
        eng.close()
        launches.update({n: k.launches for n, k in kernels.items()})
        for kname in ("super_gmm", "flash_attention"):
            n, by = kernels[kname].launches, _routes(kernels[kname])
            expect(n > 0 and by["wgmma"] == n,
                   f"rebalance {arm}: {kname} launches by route {by}")
        migs = [m for m in ex.migrations if m["kind"] == "rebalance"]
        if arm == "live":
            expect(len(migs) >= 1 and ex.placement.policy == "replicated",
                   f"rebalance live: {len(migs)} migrations, placement "
                   f"{ex.placement.policy}")
            lm = ExpertLoadModel(num_experts=cfg.num_experts,
                                 top_k=cfg.top_k, ep=E, mode="measured",
                                 measured=ex.expert_fractions,
                                 placement=target)
            expect(ex.table == lm.placement_table(0),
                   "rebalance live: the executor's table != "
                   "ExpertLoadModel's under the target placement")
            expect(all(e in ex.dev_experts[d]
                       for e, hosts in enumerate(ex.table) for d in hosts),
                   "rebalance live: a host does not hold its expert")
        else:
            expect(not migs and ex.placement == Placement(),
                   f"rebalance frozen: migrations {migs}")
        # the pinned jobs, after the engine released the workers
        ex.clock = time.monotonic
        got, r = _wave(ex, tokens, D)
        launches.update(r["launches"])
        for kname in ("super_gmm", "flash_attention"):
            expect(r[kname] > 0 and r[f"{kname}_by_route"]["wgmma"]
                   == r[kname], f"rebalance {arm} pinned: {kname} launches "
                   f"by route {r[f'{kname}_by_route']}")
        torch.cuda.synchronize()
        alloc1, reserved1 = (torch.cuda.memory_allocated(),
                             torch.cuda.memory_reserved())
        out["turns"].append({
            "arm": arm, "tokens_per_s": 10 * S / wall, "wall_s": wall,
            "migrations": len(migs),
            "migrated_bytes": float(sum(m["bytes"] for m in migs)),
            # the records are in the executor's clock (trace seconds)
            "swaps": [{"seconds": m["seconds"] / speed,
                       "copy_bytes": m.get("copy_bytes", 0.0),
                       "copy_seconds": m.get("copy_seconds", 0.0) / speed,
                       "devices": list(m["devices"]),
                       "moved_copies": m["moved_copies"]} for m in migs],
            "windows_fired": windows,
            "placement": ex.placement.policy,
            "moe_imbalance": st.moe_imbalance(),
            "measured_wave_busy_imbalance": float(busy.max() / busy.mean())
            if busy.mean() > 0 else 1.0,
            "bucket_misses_by_wave": misses,
            "hot_fractions": [float(x) for x in sorted(
                st.expert_fractions, reverse=True)[:4]],
            # the measured routing under the placement the arm ended on
            "device_fractions": [float(x) for x in ex.placement.
                                 device_fractions(tuple(
                                     float(v) for v in st.expert_fractions),
                                     E)],
            "pinned_tokens_per_s": r["tokens_per_s"],
            "allocated_before_gb": alloc0 / 1e9,
            "reserved_before_gb": reserved0 / 1e9,
            "allocated_after_gb": alloc1 / 1e9,
            "reserved_after_gb": reserved1 / 1e9})
        a = out["turns"][-1]
        print(f"[rebalance] {arm}: measured wave 10 x {S} tokens "
              f"{a['tokens_per_s']:.0f} tokens/s ({wall:.3f}s wall), MoE "
              f"busy imbalance in the wave {a['measured_wave_busy_imbalance']:.3f}"
              f", engine moe_imbalance {a['moe_imbalance']:.3f}, placement "
              f"{a['placement']}, device shares "
              f"{np.round(a['device_fractions'], 3).tolist()}, hottest "
              f"expert fractions {np.round(a['hot_fractions'], 4).tolist()}")
        for w in windows:
            print(f"[rebalance] {arm}: the controller fired at t="
                  f"{w['t']:.4f} s of trace on the window busy "
                  f"{np.round(w['busy'], 4).tolist()} trace s (imbalance "
                  f"{w['imbalance']:.3f})")
        for m in a["swaps"]:
            rate = 2 * m["copy_bytes"] / max(m["copy_seconds"], 1e-12)
            print(f"[rebalance] {arm}: swap {1e3 * m['seconds']:.1f} ms onto "
                  f"devices {m['devices']} ({m['moved_copies']} expert "
                  f"copies gained, {a['migrated_bytes'] / 1e9:.3f} GB); "
                  f"gathers wrote {m['copy_bytes'] / 1e9:.2f} GB and read as "
                  f"much in {1e3 * m['copy_seconds']:.1f} ms = "
                  f"{rate / 1e12:.2f} TB/s ({rate / HBM_BYTES_PER_S:.0%} of "
                  f"the HBM bound, bound "
                  f"{1e3 * 2 * m['copy_bytes'] / HBM_BYTES_PER_S:.1f} ms)")
        print(f"[rebalance] {arm}: new bucket misses by wave (warm, warm, "
              f"measured) {misses}; memory allocated "
              f"{a['allocated_before_gb']:.1f} -> "
              f"{a['allocated_after_gb']:.1f} GB, reserved "
              f"{a['reserved_before_gb']:.1f} -> "
              f"{a['reserved_after_gb']:.1f} GB; pinned wave "
              f"{a['pinned_tokens_per_s']:.0f} tokens/s")
        if first is None:
            first, pinned = tokens_first, got
        else:
            expect(tokens_first == first,
                   f"rebalance {arm}: first tokens differ from the first "
                   f"frozen turn's: {tokens_first} vs {first}")
            for i in range(len(tokens)):
                expect(torch.equal(got[i], pinned[i]),
                       f"rebalance {arm}: pinned job {i} differs from the "
                       f"first frozen turn's (max abs err "
                       f"{max_err(got[i], pinned[i]):.3e})")
        del eng, ex, got
        _free()
    del pinned, skewed
    _free()
    expect(_build.load() is lib and _build.library_path() == lib_path
           and lib_path.stat().st_mtime_ns == lib_mtime,
           "rebalance: the kernel library was rebuilt")
    best = {arm: max(t["tokens_per_s"] for t in out["turns"]
                     if t["arm"] == arm) for arm in ("frozen", "live")}
    out["best_tokens_per_s"] = best
    out["speedup"] = best["live"] / best["frozen"]
    out["launches"] = dict(launches)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[rebalance] best of 2 turns (frozen, live, live, frozen): live "
          f"{best['live']:.0f} / frozen {best['frozen']:.0f} tokens/s = "
          f"{out['speedup']:.3f}; first tokens equal rid by rid and the "
          f"pinned jobs torch.equal across all four turns; phase wall "
          f"{out['wall_s']:.1f}s")
    return out


def _tile_counts(serve, gen, n_e: int) -> list:
    """Per-expert row counts for the tile checks: the serve wave's median
    launch (wave_shapes) where the serve phase ran, else seeded ones."""
    if serve is not None:
        return wave_shapes(serve)["super_gmm"]["counts"]
    return [int(v) for v in torch.randint(0, 700, (n_e,), generator=gen,
                                          device=DEV).tolist()]


def _rotating_table(key: str, buckets) -> tuning.TuningTable:
    """A table whose every bucket names non-default tiles in turn: up and
    down never the same tile, and the default never both."""
    t = tuning.TuningTable()
    tiles = list(TILES)
    for i, C in enumerate(buckets):
        up = tiles[1 + i % (len(tiles) - 1)]
        down = tiles[(2 + i) % len(tiles)]
        t.put(key, C, (*up, 64), (*down, 64))
    return t


def _tile_launches(ex, table: tuning.TuningTable, key: str) -> dict:
    """The super_gmm launches by tile that `table` gives the launches in
    `ex`'s log: two at the up tile and one at the down tile per
    super_moe_ffn, the default tile where the table has no entry."""
    want = collections.Counter()
    with ex._log_lock:
        buckets = [ev[3] for ev in ex.log if ev[0] == "launch"]
    for C in buckets:
        hit = table.lookup(key, C)
        up, down = (DEFAULT_TILE, DEFAULT_TILE) if hit is None \
            else (tuple(hit[0][:2]), tuple(hit[1][:2]))
        want[tile_name(up)] += 2
        want[tile_name(down)] += 1
    return dict(want)


def phase_tuning(cfg, params, seed: int, gen, serve=None) -> dict:
    """The Super Kernel's tiles and the tuning table at the serve
    configuration (one MoE device of qwen3: 32 experts, d 4096, f 1536,
    bf16, L = 4): (a) every tile torch.equal to the default tile and within
    2e-3 of the plain version, gate/up and down, with counts and dense, at
    C 8 and 512; (b) the quick sweep's table round trip, and the full sweep
    (its per-tile times per bucket are a reading); (c) the serve wave's
    prompts as pinned jobs through one executor untuned and under a table
    whose buckets name non-default tiles: torch.equal, and the launches by
    tile what the table gives; (d) merged == per-region torch.equal under a
    table giving the per-region buckets and the merged bucket different
    tiles; (e) untuned vs tuned (the sweep's winners) tokens/s of the serve
    wave as a burst, in interleaved turns, best of 3 (a reading)."""
    import tempfile

    from repro_torch.core.executor import DisaggregatedExecutor
    from repro_torch.launch import tune_superkernel
    from repro_torch.launch.serve import serve_requests
    tiles = list(TILES)
    expect(len(tiles) > 1 and tiles[0] == DEFAULT_TILE,
           f"tuning: tiles {tiles}")
    out = {"tiles": [tile_name(t) for t in tiles]}
    tuning.set_table(None)
    g = tune_superkernel.geometry()
    n_e, d, f, L = g["n_experts"], g["d_model"], g["d_ff"], g["num_layers"]
    lid = torch.tensor([1], dtype=torch.int32, device=DEV)
    counts = _tile_counts(serve, gen, n_e)
    # (a) every tile == the default tile, bit for bit
    worst = 0.0
    for proj, (K, N) in (("gate_up", (d, f)), ("down", (f, d))):
        for C in (8, 512):
            w, x = _gmm_inputs(gen, L, n_e, C, K, N, torch.bfloat16)
            cnt = torch.tensor(counts, dtype=torch.int32, device=DEV)
            for c in (cnt, None):
                base = super_gmm(lid, w, x, c)
                ref = super_gmm_ref(lid, w, x, c)
                for t in tiles:
                    routes = _routes(super_gmm)
                    got = super_gmm(lid, w, x, c, tile=t)
                    _took(super_gmm, routes, "wgmma", f"tile {t}")
                    what = (f"{proj} C={C} "
                            f"{'dense' if c is None else 'counts'} tile "
                            f"{tile_name(t)}")
                    expect(torch.equal(got, base),
                           f"tuning: {what} != the default tile (max abs "
                           f"err {max_err(got, base):.3e})")
                    err = max_err(got, ref)
                    expect(err <= 2e-3, f"tuning: {what} vs plain: err "
                           f"{err}")
                    worst = max(worst, err)
            del w, x
    out["max_abs_err"] = worst
    print(f"[tuning] tiles {out['tiles']} (BK 64): gate/up K/N {d}/{f} and "
          f"down {f}/{d}, n_e={n_e} L={L}, C 8 and 512, counts {counts} "
          f"and dense: every tile torch.equal to the default "
          f"{tile_name(DEFAULT_TILE)}; vs plain max err {worst:.2e} "
          f"(tol 2e-3)")
    # (b) the sweep: the quick one's round trip, then the full one
    with tempfile.TemporaryDirectory() as tmp:
        quick = tune_superkernel.run(quick=True,
                                     out=os.path.join(tmp, "quick.json"))
        loaded = tuning.TuningTable.load(quick["out"])
        for key, C, up, _, down, _ in quick["rows"]:
            got = loaded.lookup(key, int(C))
            expect(got is not None and (str(got[0]), str(got[1]))
                   == (up, down), f"tuning: quick sweep round trip at {key} "
                   f"C={C}")
        sweep = tune_superkernel.run(out=os.path.join(tmp, "full.json"))
        table = tuning.TuningTable.load(sweep["out"])
    key = tuning.config_key(n_e, d, f, torch.bfloat16)
    out["quick_rows"] = quick["rows"]
    out["sweep"] = {"rows": sweep["rows"], "us_by_tile": sweep["timings"],
                    "card": table.meta["card"]}
    print(f"[tuning] quick sweep {tune_superkernel.QUICK_BUCKETS}: table "
          f"saved, reloaded, every winner looked up again: "
          f"{[(r[1], r[2], r[4]) for r in quick['rows']]}")
    for key_, C, up, up_us, down, down_us in sweep["rows"]:
        t = sweep["timings"][str(C)]
        print(f"[tuning] sweep C={C:<4d} up {up} {up_us} us (default "
              f"{t['up'][tile_name(DEFAULT_TILE)]:.1f}; "
              + ", ".join(f"{k} {v:.1f}" for k, v in t["up"].items())
              + f") | down {down} {down_us} us (default "
              f"{t['down'][tile_name(DEFAULT_TILE)]:.1f}; "
              + ", ".join(f"{k} {v:.1f}" for k, v in t["down"].items())
              + ")")
    # (c) the serve wave's prompts, untuned and under the rotating table
    rng = np.random.RandomState(seed)
    lengths = serve["lengths"] if serve is not None else \
        [int(v) for v in rng.randint(256, 2049, size=8)]
    tokens = [rng.randint(0, cfg.vocab_size, (1, n)) for n in lengths]
    D, E = 2, 4
    rot = _rotating_table(key, tune_superkernel.BUCKETS + [1024, 2048, 4096])
    ex = DisaggregatedExecutor(params, cfg, D=D, E=E, device=DEV)
    try:
        ex.prewarm_buckets(4096)
        ref, r0 = _wave(ex, tokens, D)
        tuning.set_table(rot)
        ex.prewarm_buckets(4096)  # the table's tiles, touched once
        got, r1 = _wave(ex, tokens, D)
        by_tile = dict(super_gmm.launches_by_tile)
        want = _tile_launches(ex, rot, key)
        tuning.set_table(None)
        for i in ref:
            expect(torch.equal(got[i], ref[i]),
                   f"tuning: job {i} under the table != untuned (max abs "
                   f"err {max_err(got[i], ref[i]):.3e})")
        expect({k: v for k, v in by_tile.items() if v} == want,
               f"tuning: launches by tile {by_tile}, the table gives {want}")
        expect(by_tile[tile_name(DEFAULT_TILE)] < r1["super_gmm"],
               "tuning: the table's wave ran only the default tile")
        out["tuned_wave"] = {"launches_by_tile": by_tile,
                             "untuned": r0, "tuned": r1}
        print(f"[tuning] the serve wave's {len(tokens)} prompts {lengths} "
              f"as pinned jobs (D={D} E={E}): under a table naming "
              f"non-default tiles per bucket every output torch.equal to "
              f"the untuned wave; launches by tile {by_tile} == what the "
              f"table gives the wave's buckets")
        # (e) untuned vs the sweep's winners, the serve wave as a burst
        kw = dict(rps=1e6, time_scale=1.0, seed=seed, device=DEV,
                  max_batch_tokens=4096, executor=ex)
        turns = []
        for arm in ("untuned", "tuned", "tuned", "untuned", "untuned",
                    "tuned"):
            tuning.set_table(table if arm == "tuned" else None)
            _launch.reset_launches(super_gmm)
            r = serve_requests(cfg, params, lengths=lengths, **kw)
            tuning.set_table(None)
            expect(len(r["results"]) == len(lengths)
                   and all(x.ok for x in r["results"]),
                   f"tuning: {arm} serve wave: not every request ok")
            turns.append((arm, sum(lengths) / r["wall"],
                          dict(super_gmm.launches_by_tile)))
    finally:
        tuning.set_table(None)
        del ex
        _free()
    best = {a: max(t for arm, t, _ in turns if arm == a)
            for a in ("untuned", "tuned")}
    out["tokens_per_s"] = {"turns": [(a, t) for a, t, _ in turns],
                           "best": best,
                           "tuned_by_tile": turns[1][2]}
    print(f"[tuning] serve wave as a burst ({sum(lengths)} tokens), "
          f"untuned vs the sweep's table in turns "
          + ", ".join(f"{a} {t:.0f}" for a, t, _ in turns)
          + f" tokens/s: best of 3 untuned {best['untuned']:.0f}, tuned "
          f"{best['tuned']:.0f} (a reading, not gated); tuned launches by "
          f"tile {turns[1][2]}")
    # (d) merged == per-region under a table splitting the buckets
    experts = {k: v[:, 0::E] for k, v in
               params["stages"][0]["ffn"]["experts"].items()}
    sizes = [300, 40, 700, 9]
    toks = [torch.randn((n, d), generator=gen, device=DEV).bfloat16()
            for n in sizes]
    eids = [torch.randint(0, n_e, (n,), generator=gen, device=DEV)
            for n in sizes]
    xb, order, slots, C, bounds = pack_capacity_multi(toks, eids, n_e)
    per = sorted({pack_capacity(t, e, n_e)[3] for t, e in zip(toks, eids)})
    expect(C not in per, f"tuning: merged bucket {C} is a per-region one")
    split = tuning.TuningTable()
    for b in per:
        split.put(key, b, (*tiles[3], 64), (*tiles[1], 64))
    split.put(key, C, (*tiles[2], 64), (*tiles[0], 64))
    tuning.set_table(split)
    try:
        _launch.reset_launches(super_gmm)
        lidv = torch.tensor([L - 1], dtype=torch.int32, device=DEV)
        merged = unpack_capacity_multi(
            super_moe_ffn(lidv, experts, xb, cfg), order, slots, bounds)
        for r, (t, e) in enumerate(zip(toks, eids)):
            xb1, o1, s1, _ = pack_capacity(t, e, n_e)
            one = unpack_capacity(super_moe_ffn(lidv, experts, xb1, cfg),
                                  o1, s1, len(t))
            expect(torch.equal(merged[r], one),
                   f"tuning: merged != per-region under the split table "
                   f"(region {r}, max abs err "
                   f"{max_err(merged[r], one):.3e})")
        split_tiles = dict(super_gmm.launches_by_tile)
    finally:
        tuning.set_table(None)
    expect(all(split_tiles[tile_name(t)] > 0 for t in tiles),
           f"tuning: the split table did not run every tile: {split_tiles}")
    out["split"] = {"per_region_buckets": per, "merged_bucket": C,
                    "launches_by_tile": split_tiles}
    print(f"[tuning] merged (bucket {C}: up {tile_name(tiles[2])}, down "
          f"{tile_name(tiles[0])}) == per-region (buckets {per}: up "
          f"{tile_name(tiles[3])}, down {tile_name(tiles[1])}) torch.equal "
          f"at the serve geometry; launches by tile {split_tiles}")
    return out


def _launch_line(text: str):
    """The {"launches": ...} line a twin prints last, or None."""
    for line in reversed(text.splitlines()):
        if line.startswith("kernel launches: "):
            return json.loads(line[len("kernel launches: "):])
    return None


TRAIN_MOE_STEPS = 50  # the train twin's run: its failure at step 25


def phase_examples(seed: int) -> dict:
    """The examples' twins on the card, each in its own process: exit 0;
    quickstart's super-kernel vs einsum max err within 2e-3; serve_asap
    10/10 completed; train_moe (TRAIN_MOE_STEPS steps, a failure at half
    of them) recovers, its loss improves and its backward kernels launch.
    Each twin's kernel launches by route are a reading."""
    import re
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = {}
    extra = {"torch_train_moe": ["--steps", str(TRAIN_MOE_STEPS)]}
    for name in ("torch_quickstart", "torch_serve_asap",
                 "torch_imbalance_demo", "torch_train_moe"):
        t0 = time.time()
        p = subprocess.run(
            [sys.executable, os.path.join(root, "examples", f"{name}.py"),
             "--device", DEV, "--seed", str(seed), *extra.get(name, [])],
            capture_output=True, text=True, env=env, timeout=600)
        wall = time.time() - t0
        for line in p.stdout.splitlines():
            print(f"[examples] {name}: {line}")
        expect(p.returncode == 0, f"examples: {name} exited "
               f"{p.returncode}: {p.stderr[-2000:]}")
        rec = {"wall_s": wall, "launches": _launch_line(p.stdout)}
        if name == "torch_quickstart":
            m = re.search(r"super-kernel vs einsum max err: (\S+)", p.stdout)
            expect(m is not None, "examples: quickstart printed no error")
            rec["max_err"] = float(m.group(1))
            expect(rec["max_err"] <= 2e-3, f"examples: quickstart "
                   f"super-kernel vs einsum max err {rec['max_err']}")
        if name == "torch_serve_asap":
            m = re.search(r"engine completed (\d+)/(\d+) requests", p.stdout)
            expect(m is not None and int(m.group(1)) == int(m.group(2))
                   == 10, "examples: serve_asap did not complete 10/10")
        if name == "torch_train_moe":
            m = re.search(r"loss: (\S+) -> (\S+) \(improved\)", p.stdout)
            expect(m is not None and "recovered at step" in p.stdout,
                   "examples: train_moe did not improve and recover")
            rec["loss"] = [float(m.group(1)), float(m.group(2))]
            launches = rec["launches"] or {}
            expect(all(launches.get(k, {}).get("launches", 0) > 0 for k in (
                "flash_attention_bwd", "combine_weighted_bwd")),
                "examples: train_moe's backward kernels never launched")
        out[name] = rec
    print(f"[examples] all four twins exit 0 on the card: "
          + ", ".join(f"{k} {v['wall_s']:.1f}s" for k, v in out.items()))
    return out


# ------------------------------------------------------------------ train --

# flash_attention_bwd's bar on the relative Frobenius error of dq, dk and dv
# against attention_bwd_ref in fp32 on the same inputs and the kernel's own
# o and lse: fp32 ~60x the 1.7e-7 a sound kernel gave on an H100 (sums in
# another order); bf16 ~4x the 2.4e-3 it gave -- bf16 keeps 8 bits, and the
# outputs and the P, dS operands of its products are rounded to it, as the
# forward rounds P.  A lost tile or a wrong scale reads ~1.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# |lse - plain lse|: fp32 log-sum-exp of scores of size ~10, ~3e-6 seen
LSE_TOL = 1e-4
# the forward's o against the plain forward's: the kernels phase's absolute
# bars (beside ROW_REL_TOL), here at the train shapes
FWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 4e-2}
# combine_weighted_bwd's dw (fp32 dot products over d) against float64:
# within 5e-5 of the sum of |terms| (fp32 over 4096 terms in another order
# gives ~1e-6 of it); dyb is held bit for bit
DW_TOL = 5e-5
# the card's train step against the CPU's, fp32: every leaf's gradient
# within 1e-4 relative Frobenius error (other sums on the card: cuBLAS, the
# kernels; the CPU tests hold the CPU against the reference at the same bar)
STEP_GRAD_TOL = 1e-4
TRAIN_LAYERS = 1  # the full-width step's one cut: depth 94 -> 1
TRAIN_STEPS = 4
TRAIN_S = 2048
# gemma3_1b trains at published width and all 26 layers, uncut: S 4096 is
# over its attn_chunk (1024), so every layer takes the flash kernels, and 8x
# its 512 window
GEMMA_ARCH = "gemma3_1b"
GEMMA_S = 4096

BF, F32 = torch.bfloat16, torch.float32
# name, dtype, B, S, H, KVH, dh, causal, window, softcap, layout
FLASH_BWD_CASES = [
    ("main", BF, 1, 2048, 64, 4, 128, True, None, None, "model"),
    ("fp32", F32, 1, 512, 8, 2, 128, True, None, None, "model"),
    ("S192", BF, 2, 192, 8, 2, 128, True, None, None, "model"),
    ("window512", BF, 1, 2048, 8, 2, 128, True, 512, None, "model"),
    ("window16", BF, 1, 300, 8, 2, 128, True, 16, None, "model"),
    ("softcap", BF, 1, 512, 8, 2, 128, True, None, 30.0, "model"),
    ("dh64", BF, 2, 1024, 8, 2, 64, True, None, None, "model"),
    ("noncausal", BF, 1, 320, 8, 2, 64, False, None, None, "model"),
    ("unaligned", BF, 1, 256, 8, 2, 128, True, None, None, "unaligned"),
    ("strided", BF, 1, 256, 8, 2, 128, True, None, None, "strided"),
    ("fp32_dh32", F32, 2, 100, 4, 4, 32, True, 16, 20.0, "model"),
    # gemma3_1b's local layer (head dim 256, window 512) and its global
    # layer (no window), dh 256 ragged, deepseek_v32's geometry (head dim
    # 192, H 128, KVH 8), fp32 at both, and no GQA on the wgmma route
    ("gemma3_dh256", BF, 1, 4096, 4, 1, 256, True, 512, None, "model"),
    ("gemma3_global", BF, 1, 4096, 4, 1, 256, True, None, None, "model"),
    ("dh256_S1000", BF, 1, 1000, 4, 1, 256, True, None, None, "model"),
    ("deepseek_dh192", BF, 1, 2048, 128, 8, 192, True, None, None, "model"),
    ("fp32_dh192", F32, 1, 256, 4, 2, 192, True, None, None, "model"),
    ("fp32_dh256", F32, 1, 200, 4, 1, 256, True, 64, 30.0, "model"),
    ("nogqa", BF, 1, 2048, 8, 8, 128, True, None, None, "model"),
    # the wide-head wgmma backward's edges: unaligned bases (the wmma
    # kernels at 32 x 32 tiles, still held against plain), fused-projection
    # slices, softcap with a window, S 129 (a dQ block of 128 reads lse2 / D
    # rows up to 255: the PAD edge), non-causal with a window
    ("dh192_unaligned", BF, 1, 256, 4, 2, 192, True, None, None,
     "unaligned"),
    ("dh256_unaligned", BF, 1, 256, 4, 1, 256, True, 64, None, "unaligned"),
    ("dh192_strided", BF, 1, 512, 8, 2, 192, True, None, None, "strided"),
    ("dh256_softcap_window", BF, 1, 1024, 4, 1, 256, True, 256, 30.0,
     "model"),
    ("dh192_S129", BF, 2, 129, 8, 2, 192, True, None, None, "model"),
    ("dh192_full_w128", BF, 1, 700, 4, 2, 192, False, 128, None, "model"),
]


def _bwd_route_of(dt, dh, layout) -> str:
    """The route a FLASH_BWD_CASES case must take: bf16 at head dim 64, 128,
    192 or 256 in model layout (strided slices included) on wgmma, other
    bf16 (an unaligned base, head dim 32) on wmma, fp32 on fma."""
    if dt == F32:
        return "fma"
    return "wgmma" if dh in (64, 128, 192, 256) and layout != "unaligned" \
        else "wmma"


def _bwd_wrappers():
    from repro_torch.kernels import wrappers
    return wrappers()


def _reset_counts():
    for w in _bwd_wrappers():
        _launch.reset_launches(w)
    _launch.reset_host_syncs()


def _read_counts() -> dict:
    return {w.__name__: w.launches for w in _bwd_wrappers()}


def _flash_inputs(gen, dtype, B, S, H, KVH, dh, layout):
    def rnd(shape):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)

    if layout == "unaligned":  # bases one element past 16 bytes: no vectors
        q, k, v, do = (_unaligned(s, dtype, gen) for s in (
            (B, S, H, dh), (B, S, KVH, dh), (B, S, KVH, dh), (B, S, H, dh)))
    elif layout == "strided":  # q, k, v slices of one fused projection
        qkv = rnd((B, S, H + 2 * KVH, dh))
        q, k, v = qkv.split((H, KVH, KVH), dim=2)
        do = rnd((B, S, H, dh))
    else:
        q, k, v, do = rnd((B, S, H, dh)), rnd((B, S, KVH, dh)), \
            rnd((B, S, KVH, dh)), rnd((B, S, H, dh))
    return q, k, v, do


def _current_context():
    """The CUDA driver's current context on the calling thread (None for
    none), asked of libcuda without making one current."""
    import ctypes
    ctx = ctypes.c_void_p()
    rc = ctypes.CDLL("libcuda.so.1").cuCtxGetCurrent(ctypes.byref(ctx))
    expect(rc == 0, f"cuCtxGetCurrent returned {rc}")
    return ctx.value


def _on_fresh_thread(fn) -> dict:
    """fn() on a new thread: {"ctx": its current context when it began,
    "out": fn's result}; an exception re-raised here."""
    box = {}

    def run():
        box["ctx"] = _current_context()
        try:
            box["out"] = fn()
            torch.cuda.synchronize()
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            box["err"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "err" in box:
        raise box["err"]
    return box


def check_fresh_threads(gen) -> dict:
    """The wgmma launches encode tensor maps, which needs a current CUDA
    context, on threads that have none: (a) a remat recompute of the wgmma
    flash forward (torch.utils.checkpoint over mha_flash at bf16 dh 256 --
    the wide-head kernel, recomputed first -- and then dh 128) as the first
    op of the process's autograd thread -- this must be the run's first
    backward -- its gradients (both backwards on "wgmma") torch.equal to the
    same without remat; (b) the flash forward at dh 128 and 256, the
    backward at dh 128 and 256 and super_gmm, each on "wgmma", alone on a
    new Python thread, torch.equal to the main thread's.  Each thread must
    have begun with no context, or the check shows nothing."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_launch)
    seen = []

    class Probe(torch.autograd.Function):  # the backward's first node
        @staticmethod
        def forward(ctx, x, y):
            return x.view_as(x), y.view_as(y)

        @staticmethod
        def backward(ctx, gx, gy):
            seen.append(_current_context())
            return gx, gy

    def both(q2, k2, v2, q, k, v):  # the wide head first, then the main one
        return mha_flash(q2, k2, v2), mha_flash(q, k, v)

    q, k, v, do = _flash_inputs(gen, BF, 1, 1024, 8, 2, 128, "model")
    q2, k2, v2, do2 = _flash_inputs(gen, BF, 1, 1024, 4, 1, 256, "model")
    fwd, bwd = _routes(flash_attention), _routes(flash_attention_bwd)
    qkv = [t.detach().requires_grad_(True) for t in (q2, k2, v2, q, k, v)]
    out = Probe.apply(*torch.utils.checkpoint.checkpoint(
        both, *qkv, use_reentrant=False))
    remat = torch.autograd.grad(out, qkv, (do2, do))
    expect(seen == [None], f"train fresh threads: the autograd thread's "
           f"context at its first node was {seen}, not none: this check "
           f"must run the process's first backward")
    _took(flash_attention, fwd, "wgmma", "the remat forward and recompute")
    expect(flash_attention.launches_by_route["wgmma"] - fwd["wgmma"] == 4,
           "train fresh threads: the forward was not recomputed")
    now = _routes(flash_attention_bwd)
    expect({r: now[r] - bwd.get(r, 0) for r in now if now[r] != bwd.get(r)}
           == {"wgmma": 2}, f"train fresh threads: the remat backward's "
           f"routes {now} (before {bwd}): want dh 256 and 128 on wgmma")
    qkv = [t.detach().requires_grad_(True) for t in (q2, k2, v2, q, k, v)]
    plain = torch.autograd.grad(both(*qkv), qkv, (do2, do))
    expect(all(torch.equal(a, b) for a, b in zip(remat, plain)),
           "train fresh threads: the remat gradients differ")
    opts = dict(causal=True, window=None, softcap=None)
    o, lse = flash_launch(q, k, v, with_lse=True, **opts)
    o2, lse2 = flash_launch(q2, k2, v2, with_lse=True, **opts)
    lid = torch.tensor([0], dtype=torch.int32, device=DEV)
    w, x = _gmm_inputs(gen, 1, 8, 64, 1024, 512, BF)
    calls = [("flash_attention", flash_attention,
              lambda: flash_launch(q, k, v, with_lse=True, **opts)),
             ("flash_attention dh256", flash_attention,
              lambda: flash_launch(q2, k2, v2, with_lse=True, **opts)),
             ("flash_attention_bwd", flash_attention_bwd,
              lambda: flash_attention_bwd(q, k, v, o, lse, do, **opts)),
             ("flash_attention_bwd dh256", flash_attention_bwd,
              lambda: flash_attention_bwd(q2, k2, v2, o2, lse2, do2,
                                          **opts)),
             ("super_gmm", super_gmm, lambda: super_gmm(lid, w, x))]
    fresh = {}
    for name, wrapper, fn in calls:
        before = _routes(wrapper)
        box = _on_fresh_thread(fn)
        _took(wrapper, before, "wgmma", f"{name} on a fresh thread")
        expect(box["ctx"] is None, f"train fresh threads: {name}'s thread "
               f"began with a context")
        want = fn()
        got = box["out"]
        got, want = (got, want) if isinstance(got, tuple) else \
            ((got,), (want,))
        expect(all(torch.equal(a, b) for a, b in zip(got, want)),
               f"train fresh threads: {name} on a fresh thread differs")
        fresh[name] = "wgmma"
    print("[train] tensor maps on context-less threads: a remat recompute "
          "of the wgmma forward (dh 256, then 128) as the autograd thread's "
          "first op, and " + ", ".join(fresh) + " each alone on a new "
          "thread, torch.equal")
    return {"remat_first_op": True, "fresh_thread": fresh}


def check_flash_bwd(gen) -> dict:
    """flash_attention_bwd against attention_bwd_ref on every case: the
    forward's o torch.equal with and without its lse, o and the lse against
    the plain forward's (o within FWD_TOL and ROW_REL_TOL, the kernels
    phase's bars), dq, dk, dv within BWD_TOL, two runs torch.equal, each on
    the route `_bwd_route_of` names; the main case once more through
    FlashAttention (autograd) torch.equal to the wrapper; a head dim without
    a backward kernel raises."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_launch)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_fwd_ref)
    out = {}
    for name, dt, B, S, H, KVH, dh, causal, win, cap, layout in \
            FLASH_BWD_CASES:
        q, k, v, do = _flash_inputs(gen, dt, B, S, H, KVH, dh, layout)
        opts = dict(causal=causal, window=win, softcap=cap)
        o0 = flash_launch(q, k, v, **opts)
        o, lse = flash_launch(q, k, v, with_lse=True, **opts)
        expect(torch.equal(o0, o), f"train {name}: o with lse differs")
        o_ref, lse_ref = attention_fwd_ref(q.float(), k.float(), v.float(),
                                           **opts)
        o_err, o_rel = max_err(o, o_ref), row_rel_err(o, o_ref)
        expect(o_err <= FWD_TOL[dt] and o_rel <= ROW_REL_TOL[dt],
               f"train {name}: forward o err {o_err} (tol {FWD_TOL[dt]}), "
               f"row rel err {o_rel} (tol {ROW_REL_TOL[dt]})")
        lse_err = max_err(lse, lse_ref)
        expect(lse_err <= LSE_TOL, f"train {name}: lse err {lse_err}")
        del o_ref, lse_ref
        before = dict(flash_attention_bwd.launches_by_route)
        got = flash_attention_bwd(q, k, v, o, lse, do, **opts)
        again = flash_attention_bwd(q, k, v, o, lse, do, **opts)
        took = [r for r, n in flash_attention_bwd.launches_by_route.items()
                if n != before[r]]
        want_route = _bwd_route_of(dt, dh, layout)
        expect(took == [want_route], f"train {name}: backward took {took}, "
               f"not {want_route}")
        want = attention_bwd_ref(q.float(), k.float(), v.float(), o.float(),
                                 lse, do.float(), **opts)
        torch.cuda.synchronize()
        det = all(torch.equal(a, b) for a, b in zip(got, again))
        rel = [_rel_fro(a, b) for a, b in zip(got, want)]
        rec = {"dtype": str(dt).split(".")[-1], "B": B, "S": S, "H": H,
               "KVH": KVH, "dh": dh, "causal": causal, "window": win,
               "softcap": cap, "layout": layout, "o_err": o_err,
               "o_row_rel_err": o_rel, "lse_err": lse_err,
               "rel_dq": rel[0], "rel_dk": rel[1], "rel_dv": rel[2],
               "max_abs_err": max(max_err(a, b) for a, b in zip(got, want)),
               "tol": BWD_TOL[dt], "deterministic": det,
               "route": want_route}
        expect(det, f"train {name}: two backward runs differ")
        expect(max(rel) <= BWD_TOL[dt], f"train {name}: dq/dk/dv rel err "
               f"{rel} > {BWD_TOL[dt]}")
        if name == "main":  # the Function carries the kernel's gradient
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            fn = mha_flash(*qkv, **opts)
            expect(torch.equal(fn, o), "train main: FlashAttention's o")
            for a, b in zip(torch.autograd.grad(fn, qkv, do), got):
                expect(torch.equal(a, b), "train main: FlashAttention's "
                       "backward is not the kernel's")
        out[name] = rec
        print(f"[train] flash_bwd {name} ({want_route}): rel dq "
              f"{rel[0]:.2e} dk "
              f"{rel[1]:.2e} dv {rel[2]:.2e} (tol {BWD_TOL[dt]:.0e}), o "
              f"err {o_err:.1e} row rel {o_rel:.1e}, lse err "
              f"{lse_err:.1e}, deterministic {det}")
        del q, k, v, do, o0, o, lse, got, again, want
    q = torch.zeros((1, 64, 2, 16), dtype=BF, device=DEV)
    lse = torch.zeros((1, 2, 64), device=DEV)
    try:
        flash_attention_bwd(q, q[:, :, :1], q[:, :, :1], q, lse, q)
        raise Failed("train: flash_attention_bwd took head dim 16")
    except NotImplementedError as e:
        print(f"[train] head dim 16 raises: {e}")
    return out


def _skewed_routing(gen, T, E, K):
    """Router-like (weights, ids) of T tokens: top-K of a softmax whose
    first 4 experts are favoured, so some pairs overflow capacity."""
    logits = torch.randn((T, E), generator=gen, device=DEV)
    logits[:, :4] += 2.0
    w, idx = torch.topk(torch.softmax(logits, -1), K, -1)
    return w / w.sum(-1, keepdim=True), idx.to(torch.int32)


def check_combine_bwd(gen) -> dict:
    """combine_weighted_bwd at the full-width step's shape (T 2048, K 8, E
    128, C 160, d 4096) in bf16 and fp32, on a routing that drops pairs:
    dyb torch.equal to the plain version, dw within DW_TOL of float64, two
    runs torch.equal.  Then the dispatch's backward (the weighted combine
    with unit weights) at E = 128 ("whole") and E = 1117 ("scatter")
    torch.equal to the plain version."""
    from repro_torch.kernels.dispatch_combine.dispatch_combine import (
        combine_gather, combine_weighted_bwd, dispatch_scatter,
        dispatch_whole)
    from repro_torch.kernels.dispatch_combine.ops import kernel_moe_dispatch
    from repro_torch.kernels.dispatch_combine.ref import (
        combine_weighted_bwd_ref, combine_weighted_ref)
    from repro_torch.models.moe import expert_capacity
    cfg = get_config(ARCH)
    T, K, E, d = TRAIN_S, cfg.top_k, cfg.num_experts, cfg.d_model
    C = expert_capacity(T, cfg)
    out = {}
    w, idx = _skewed_routing(gen, T, E, K)
    for dt in (BF, F32):
        x = torch.randn((T, d), generator=gen, device=DEV).to(dt)
        _, _, _, valid, _, ps = dispatch_whole(x, idx, E, C)
        yb = torch.randn((E * C, d), generator=gen, device=DEV).to(dt)
        dout = torch.randn((T, d), generator=gen, device=DEV).to(dt)
        dyb, dw = combine_weighted_bwd(dout, yb, ps, w)
        dyb2, dw2 = combine_weighted_bwd(dout, yb, ps, w)
        rdyb, _ = combine_weighted_bwd_ref(dout, yb, ps, w)
        kept = ps < E * C
        terms = yb.double()[ps.clamp(max=E * C - 1)] \
            * dout.double().repeat_interleave(K, 0)
        exact = torch.where(kept, terms.sum(-1), 0.0).reshape(T, K)
        scale = torch.where(kept, terms.abs().sum(-1), 1.0).reshape(T, K)
        dw_err = float(((dw.double() - exact).abs() / scale).max())
        name = str(dt).split(".")[-1]
        rec = {"dyb_equal": torch.equal(dyb, rdyb), "dw_err": dw_err,
               "dw_tol": DW_TOL, "dropped": int((~valid).sum()),
               "deterministic": torch.equal(dyb, dyb2)
               and torch.equal(dw, dw2),
               "max_abs_err": max(max_err(dyb, rdyb),
                                  float((dw.double() - exact).abs().max()))}
        expect(rec["dropped"] > 0, "train: the combine check drops no pair")
        expect(rec["dyb_equal"], f"train combine_bwd {name}: dyb differs")
        expect(dw_err <= DW_TOL, f"train combine_bwd {name}: dw err "
               f"{dw_err}")
        expect(rec["deterministic"], f"train combine_bwd {name}: runs "
               f"differ")
        out[name] = rec
        print(f"[train] combine_weighted_bwd {name}: dyb bitwise, dw err "
              f"{dw_err:.1e} of sum|terms| (tol {DW_TOL:.0e}), "
              f"{rec['dropped']} pairs dropped")
    for E2, route, T2 in ((E, "whole", T), (1117, "scatter", 512)):
        cfg2 = cfg.replace(num_experts=E2)
        _, idx2 = _skewed_routing(gen, T2, E2, K)
        x = torch.randn((T2, d), generator=gen, device=DEV).to(BF) \
            .requires_grad_(True)
        d0, c0 = _routes(dispatch_scatter), _routes(combine_gather)
        xb, info = kernel_moe_dispatch(x, idx2, cfg2)
        dxb = torch.randn(xb.shape, generator=gen, device=DEV).to(BF)
        dx, = torch.autograd.grad(xb, x, dxb)
        _took(dispatch_scatter, d0, route, f"train dispatch E={E2}")
        _took(combine_gather, c0, "weighted", f"train dispatch bwd E={E2}")
        C2 = info["capacity"]
        want = combine_weighted_ref(dxb.reshape(E2 * C2, d),
                                    info["pair_slot"],
                                    torch.ones((T2, K), device=DEV))
        expect(torch.equal(dx, want), f"train: dispatch backward at "
               f"E={E2} differs from the plain version")
        out[f"dispatch_E{E2}"] = {"route": route, "equal": True,
                                  "dropped": int((~info["valid"]).sum())}
        print(f"[train] dispatch backward E={E2} ({route}): torch.equal to "
              f"the plain version, {out[f'dispatch_E{E2}']['dropped']} "
              f"pairs dropped")
    return out


def _small_train_cfg():
    return get_config(ARCH).smoke().replace(num_layers=2, num_experts=4,
                                            top_k=2)


def _to(tree, device):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().to(device, copy=True), tree)


def check_card_vs_cpu_step(seed: int) -> dict:
    """One train step at the small fp32 config (qwen3 smoke, 2 layers, 4
    experts top-2, S 64 > attn_chunk 32, head dim 32) on the card and on
    the CPU from the same params and batch: every floating leaf gets a
    gradient that is neither None nor zero on the card, every kernel of the
    path launches, the loss agrees within 1e-5 and every leaf's gradient
    within STEP_GRAD_TOL; then build_train_step on both: the loss, and the
    params within 2 lr."""
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.launch.steps import (TrainState, build_train_step,
                                          value_and_grad)
    from repro_torch.models.api import build_api
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import leaves
    cfg = _small_train_cfg()
    api = build_api(cfg)
    params_c = api.init(torch.Generator().manual_seed(seed))
    params_g = _to(params_c, DEV)
    nb = pipeline_for(cfg, 64, 2, seed, device="cpu").numpy_batch(0)
    bc = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          nb.items()}
    bg = {k: v.to(DEV) for k, v in bc.items()}
    ps = leaves(params_g)
    for p in ps:
        p.requires_grad_(True)
    _reset_counts()
    loss, _ = api.loss(params_g, bg)
    raw = torch.autograd.grad(loss, ps, allow_unused=True)
    torch.cuda.synchronize()
    counts = _read_counts()
    for p in ps:
        p.requires_grad_(False)
    missing = [i for i, g in enumerate(raw)
               if g is None or float(g.abs().max()) == 0.0]
    expect(not missing, f"train: leaves {missing} of {len(ps)} got no "
           f"gradient on the card")
    for name in ("flash_attention", "flash_attention_bwd", "dispatch_scatter",
                 "combine_gather", "combine_weighted_bwd"):
        expect(counts[name] > 0, f"train small step: {name} never launched "
               f"({counts})")
    del raw
    (lg, _), gg = value_and_grad(api.loss, params_g, bg)
    (lc, _), gc_ = value_and_grad(api.loss, params_c, bc)
    rel = [_rel_fro(a.cpu(), b) for a, b in zip(leaves(gg), leaves(gc_))]
    loss_err = abs(float(lg) - float(lc))
    expect(loss_err <= 1e-5 * max(1.0, float(lc)),
           f"train: card loss {float(lg)} vs CPU {float(lc)}")
    expect(max(rel) <= STEP_GRAD_TOL, f"train: card vs CPU gradient rel err "
           f"{max(rel)} (leaf {int(np.argmax(rel))})")
    lr = 1e-3
    opt = AdamW(lr=lr)
    sg, mg = build_train_step(api, opt)(
        TrainState(params_g, opt.init(params_g)), bg)
    sc, mc = build_train_step(api, opt)(
        TrainState(params_c, opt.init(params_c)), bc)
    step_err = max(max_err(a.cpu(), b) for a, b in zip(leaves(sg.params),
                                                       leaves(sc.params)))
    expect(step_err <= 2 * lr, f"train: params after a step differ by "
           f"{step_err} > 2 lr")
    expect(abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-5
           * max(1.0, float(mc["loss"])), "train: build_train_step's loss")
    rec = {"leaves": len(ps), "loss_card": float(lg), "loss_cpu": float(lc),
           "max_grad_rel_err": max(rel), "tol": STEP_GRAD_TOL,
           "params_max_err_after_step": step_err, "launches": counts}
    print(f"[train] small fp32 step, card vs CPU: loss {float(lg):.6f} vs "
          f"{float(lc):.6f}, {len(ps)} leaves all with a gradient, worst "
          f"leaf rel err {max(rel):.1e} (tol {STEP_GRAD_TOL:.0e}), params "
          f"after the step within {step_err:.1e}; launches {counts}")
    return rec


def check_resume(seed: int) -> dict:
    """ResilientTrainer on the card at the small config: 6 steps, a
    checkpoint every 2, a failure injected at step 3 and recovered from by
    CheckpointManager's restore; the final params and moments torch.equal
    to an uninterrupted run's."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.launch.steps import TrainState, build_train_step
    from repro_torch.models.api import build_api
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.fault_tolerance import ResilientTrainer
    from repro_torch.tree import leaves
    cfg = _small_train_cfg()
    api = build_api(cfg)
    params0 = api.init(torch.Generator(device=DEV).manual_seed(seed + 1))
    opt = AdamW(lr=1e-3, warmup_steps=2)
    pipe = pipeline_for(cfg, 64, 2, seed, device=DEV)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    runs = {}
    try:
        for name, fail in (("resumed", 3), ("uninterrupted", None)):
            p = _to(params0, DEV)
            trainer = ResilientTrainer(
                build_train_step(api, opt), pipe,
                CheckpointManager(os.path.join(root, name)), ckpt_every=2)
            state, step, _ = trainer.run(TrainState(p, opt.init(p)), 6,
                                         inject_failure_at=fail)
            expect(step == 6, f"train resume: {name} ended at step {step}")
            runs[name] = state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    a, b = runs["resumed"], runs["uninterrupted"]
    equal = all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    expect(equal, "train resume: the resumed run's params differ from the "
           "uninterrupted run's")
    print("[train] resume: failure at step 3 of 6, restored from step 2's "
          "checkpoint; final params and moments torch.equal to the "
          "uninterrupted run")
    return {"equal": equal, "steps": 6, "failure_at": 3, "ckpt_every": 2}


def _attn_pairs(S: int, window=None) -> float:
    """The (query, key) pairs a causal mask (cut to `window` keys) lets
    through at sequence length S."""
    if window is None or window >= S:
        return S * (S + 1) / 2
    return window * (window + 1) / 2 + (S - window) * window


def _layer_windows(cfg) -> list:
    """Each attention layer's window (None: global), in model order."""
    from repro_torch.models.lm import lm_stages
    out = []
    for kind, n, opts in lm_stages(cfg):
        if kind == "gemma":
            out += ([cfg.window_size] * opts["lpg"] + [None]) * n
        elif kind == "decoder":
            out += [opts["window"]] * n
    return out


def _model_flops(cfg, params, tokens: int, S: int) -> float:
    """A step's model FLOPs: 6 x the matmul params each token meets (the
    attention projections, the router, top_k experts, the LM head -- the
    embedding once more where it is tied) x tokens, plus attention's 3 x 4
    B H dh per visible (query, key) pair of each layer (forward and
    backward; causal, windows counted)."""
    from repro_torch.tree import leaves_with_paths
    n = 0
    for path, t in leaves_with_paths(params):
        if path[0] == "embed" or any("norm" in str(k) for k in path):
            continue
        size = t.numel()
        if "experts" in path:
            size = size * cfg.top_k // cfg.num_experts
        n += size
    if cfg.tie_embeddings:
        n += params["embed"].numel()
    B = tokens // S
    attn = sum(3 * 4.0 * B * cfg.num_heads * cfg.head_dim * _attn_pairs(S, w)
               for w in _layer_windows(cfg))
    return 6.0 * n * tokens + attn


def full_width_train(seed: int, arch: str = ARCH, layers=TRAIN_LAYERS,
                     S: int = TRAIN_S, bwd_route: str = "wgmma",
                     kernels=("flash_attention_bwd", "combine_weighted_bwd",
                              "flash_attention", "dispatch_scatter",
                              "combine_gather"),
                     record=("flash_attention_bwd", "combine_weighted_bwd"),
                     no_sync: bool = False) -> dict:
    """`arch` at published width (depth cut to `layers`, None for all),
    bf16: TRAIN_STEPS build_train_step steps (AdamW lr 3e-4) on one repeated
    [1, S] batch of pipeline_for.  Each step: the launches of every kernel
    (counts set to 0 just before, read just after) and the backward's by
    route, host syncs, forward / backward / optimizer ms by CUDA events,
    tokens/s, peak memory.  Gated: the loss falls and stays finite, every
    leaf gets a non-zero gradient, every kernel of `kernels` launches, every
    step runs one flash_attention_bwd per attention layer and all on
    `bwd_route`, every flash forward (the recompute under remat included)
    on "wgmma", and with `no_sync` no host sync.  The inputs of the last
    step's last call of each wrapper in `record` are kept for the timing
    rows."""
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.kernels.dispatch_combine import ops as dc_ops
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.steps import TrainState, build_train_step
    from repro_torch.models.api import build_api
    from repro_torch.models.lm import init_lm_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import leaves
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    t0 = time.time()
    params = init_lm_params(torch.Generator(device=DEV).manual_seed(seed),
                            cfg, DEV)
    n_params = sum(t.numel() for t in leaves(params))
    ev = {k: torch.cuda.Event(enable_timing=True)
          for k in ("start", "fwd", "opt0", "opt1", "end")}

    class TimedAdamW(AdamW):
        def update(self, grads, state, params):
            ev["opt0"].record()
            out = AdamW.update(self, grads, state, params)
            ev["opt1"].record()
            return out

    api = build_api(cfg)

    def loss(p, batch):
        out = api.loss(p, batch)
        ev["fwd"].record()
        return out

    opt = TimedAdamW(lr=3e-4)
    state = TrainState(params, opt.init(params))
    torch.cuda.synchronize()
    print(f"[train] {cfg.name} full width, {cfg.num_layers} layers, bf16: "
          f"{n_params / 1e9:.2f} B params, params + fp32 moments "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB in "
          f"{time.time() - t0:.1f}s")
    step_fn = build_train_step(api._replace(loss=loss), opt)
    batch = pipeline_for(cfg, S, 1, seed, device=DEV).batch(0)
    tokens = batch["tokens"].numel()
    flops = _model_flops(cfg, params, tokens, S)
    n_attn = len(_layer_windows(cfg))
    modules = {"flash_attention_bwd": fa, "combine_weighted_bwd": dc_ops}
    steps, total, recorded = [], collections.Counter(), {}
    for i in range(TRAIN_STEPS):
        last = i == TRAIN_STEPS - 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        with contextlib.ExitStack() as stack:
            grads = stack.enter_context(_recording(torch.autograd, "grad")) \
                if i == 0 else None
            if last:
                recorded = {name: stack.enter_context(
                    _recording(modules[name], name)) for name in record}
            t0 = time.time()
            ev["start"].record()
            state, m = step_fn(state, batch)
            ev["end"].record()
            torch.cuda.synchronize()
            wall = time.time() - t0
        counts = _read_counts()
        routes = dict(fa.flash_attention_bwd.launches_by_route)
        fwd_routes = dict(fa.flash_attention.launches_by_route)
        syncs = _launch.reset_host_syncs()
        total.update(counts)
        if grads is not None:
            got = grads[0][2]
            expect(len(got) == len(leaves(params)) and all(
                g is not None and float(g.abs().max()) > 0 for g in got),
                f"train {cfg.name}: a leaf got no gradient")
            del got
            grads.clear()
        expect(routes == {**dict.fromkeys(routes, 0), bwd_route: n_attn},
               f"train {cfg.name}: flash_attention_bwd launches by route "
               f"{routes}, not {n_attn} on {bwd_route}")
        expect(fwd_routes["wgmma"] == counts["flash_attention"] > 0,
               f"train {cfg.name}: flash_attention launches by route "
               f"{fwd_routes}, not all {counts['flash_attention']} on "
               f"wgmma")
        expect(not no_sync or syncs == 0,
               f"train {cfg.name}: {syncs} host syncs in a step")
        rec = {"step": i + 1, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]),
               "dropped_fraction": float(m.get("dropped_fraction", 0.0)),
               "fwd_ms": ev["start"].elapsed_time(ev["fwd"]),
               "bwd_ms": ev["fwd"].elapsed_time(ev["opt0"]),
               "opt_ms": ev["opt0"].elapsed_time(ev["opt1"]),
               "step_ms": ev["start"].elapsed_time(ev["end"]),
               "wall_s": wall, "tokens_per_s": tokens / wall,
               "host_syncs": syncs, "launches": counts,
               "flash_bwd_by_route": routes,
               "flash_fwd_by_route": fwd_routes,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        rec["model_flops_share"] = flops / (rec["step_ms"] / 1e3) \
            / PEAK_FLOPS[torch.bfloat16]
        steps.append(rec)
        print(f"[train] {cfg.name} step {i + 1}: loss {rec['loss']:.4f}, fwd "
              f"{rec['fwd_ms']:.1f} bwd {rec['bwd_ms']:.1f} opt "
              f"{rec['opt_ms']:.1f} ms (step {rec['step_ms']:.1f} ms), "
              f"{rec['tokens_per_s']:.0f} tokens/s, {syncs} host syncs, "
              f"peak {rec['peak_gb']:.1f} GB, model FLOPs share "
              f"{rec['model_flops_share']:.3f}, launches {counts}, "
              f"flash_attention by route {fwd_routes}, "
              f"flash_attention_bwd by route {routes}")
    losses = [s["loss"] for s in steps]
    expect(all(np.isfinite(losses)) and all(np.isfinite(
        [s["grad_norm"] for s in steps])),
        f"train {cfg.name}: non-finite {losses}")
    expect(losses[-1] < losses[0],
           f"train {cfg.name}: loss did not fall: {losses}")
    expect(all(torch.isfinite(t).all() for t in leaves(state.params)),
           f"train {cfg.name}: non-finite params")
    for name in kernels:
        expect(total[name] > 0, f"train {cfg.name}: {name} never launched "
               f"at full width ({dict(total)})")
    inputs = {name: (tuple(t.detach() for t in calls[-1][0]), calls[-1][1])
              for name, calls in recorded.items()}
    del state, params, m, recorded
    _free()
    return {"arch": cfg.name, "layers": cfg.num_layers, "S": S,
            "params": n_params, "tokens_per_step": tokens,
            "model_flops_per_step": flops, "losses": losses, "steps": steps,
            "launches": dict(total), "inputs": inputs}


def _time_bwd(kern, plain, lib, nbytes, ops, dtype, shape, match):
    """A backward kernel at the main path's inputs: ms (wrapper calls back
    to back, CUDA events), device ms (profiler, kernels whose name holds
    `match`), the plain version's ms, one library call's, the bound from
    this run's bytes and operations, max abs error against the plain
    version."""
    got, want = kern(), plain()
    err = max(max_err(a, b) for a, b in zip(got, want))
    del got, want
    ms = cuda_ms(kern, iters=20, warmup=3)
    dev, rows = _device_ms(kern, 10, match=match)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return {"case": "train", "ms": ms, "device_ms": dev,
            "plain_ms": cuda_ms(plain, iters=3, warmup=1),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cuda_ms(lib, iters=20, warmup=3),
            "device_ms_by": "profiler" if rows else "cuda_events",
            "device_ms_by_kernel": {n: t for n, t, _ in rows},
            "max_abs_err": err, "shape": shape}


def _sdpa_bwd(q, k, v, do, kw):
    """The yardstick of flash_attention_bwd: scaled_dot_product_attention's
    backward on expanded heads through autograd (the window as a boolean
    mask), on the first backend that takes the call -- cuDNN (PyTorch's own
    first choice on an H100), flash, efficient, then math.  Returns (the
    call, the backend's name)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    B, S, H, dh = q.shape
    qh, kh, vh = (_expand_kv(t, H).permute(0, 2, 1, 3).detach().clone()
                  .requires_grad_(True) for t in (q, k, v))
    doh = do.permute(0, 2, 1, 3)
    mask = None
    if kw.get("window"):
        pos = torch.arange(S, device=q.device)
        mask = (pos[None, :] > pos[:, None] - kw["window"]) & (
            pos[None, :] <= pos[:, None] if kw["causal"] else True)
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # "... not used because"
                lo = F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask,
                    is_causal=mask is None and kw["causal"])
            torch.autograd.grad(lo, (qh, kh, vh), doh, retain_graph=True)
        except RuntimeError:
            continue
        return (lambda: torch.autograd.grad(lo, (qh, kh, vh), doh,
                                            retain_graph=True),
                backend.name)
    raise Failed("no scaled_dot_product_attention backend took the call")


def _time_flash_bwd(label: str, q, k, v, o, lse, do, kw) -> dict:
    """flash_attention_bwd on these inputs (the route `route` gives them),
    timed beside its plain version, SDPA's backward and the bound
    from this call's bytes and the operations of its visible pairs."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, route)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    B, S, H, dh = q.shape
    KVH = k.shape[2]
    pairs = _attn_pairs(S, kw.get("window")) if kw["causal"] else \
        float(S * min(S, 2 * (kw.get("window") or S)))
    nbytes = 2 * B * S * dh * (4 * H + 4 * KVH) + 4 * B * H * S
    ops = 5 * 2.0 * B * H * dh * pairs  # S, dV, dP, dQ, dK
    lib, backend = _sdpa_bwd(q, k, v, do, kw)
    row = _time_bwd(
        lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw),
        lambda: attention_bwd_ref(q, k, v, o, lse, do, **kw), lib,
        nbytes, ops, q.dtype,
        {"B": B, "S": S, "H": H, "KVH": KVH, "dh": dh,
         "dtype": str(q.dtype).split(".")[-1], "causal": kw["causal"],
         "window": kw.get("window")}, "flash_bwd")
    row["case"] = label
    row["route"] = route(q.dtype, dh, [t.data_ptr() for t in (q, k, v, do)],
                         [t.stride()[:3] for t in (q, k, v, do)])
    row["library_call"] = (f"scaled_dot_product_attention backward "
                           f"(expanded heads, autograd, {backend} backend)")
    return row


def time_bwd_kernels(inputs: dict, gemma_inputs: dict, gen) -> dict:
    """flash_attention_bwd at the inputs the full-width qwen3 step's last
    backward gave it (the main shape, wgmma), at gemma3_1b's last-step
    inputs (head dim 256, its local layer: window 512), at gemma3_1b's
    global-layer shape (B 1, S 4096, H 4, KVH 1, causal, no window) and at
    deepseek_v32's attention geometry (B 1, S 2048, H 128, KVH 8, head dim
    192, causal) -- the last two made here, all three on the wide-head
    wgmma kernels; and
    combine_weighted_bwd at the qwen3 step's inputs.  Library yardsticks
    (timed here, used nowhere in the port): SDPA's backward (`_sdpa_bwd`),
    and embedding_bag(mode="sum", per_sample_weights) -- the weighted
    combine's own function -- through autograd."""
    import torch.nn.functional as F
    from repro_torch.kernels.dispatch_combine.dispatch_combine import \
        combine_weighted_bwd
    from repro_torch.kernels.dispatch_combine.ref import \
        combine_weighted_bwd_ref
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_launch
    rows = {}
    (q, k, v, o, lse, do), kw = inputs["flash_attention_bwd"]
    cases = [_time_flash_bwd("train qwen3 (main)", q, k, v, o, lse, do, kw)]
    (q, k, v, o, lse, do), kw = gemma_inputs["flash_attention_bwd"]
    cases.append(_time_flash_bwd("train gemma3_1b", q, k, v, o, lse, do, kw))
    q, k, v, do = _flash_inputs(gen, BF, 1, GEMMA_S, 4, 1, 256, "model")
    kw = dict(causal=True, window=None, softcap=None)
    o, lse = flash_launch(q, k, v, with_lse=True, **kw)
    cases.append(_time_flash_bwd("gemma3_1b global layer", q, k, v, o, lse,
                                 do, kw))
    q, k, v, do = _flash_inputs(gen, BF, 1, 2048, 128, 8, 192, "model")
    kw = dict(causal=True, window=None, softcap=None)
    o, lse = flash_launch(q, k, v, with_lse=True, **kw)
    cases.append(_time_flash_bwd("deepseek_v32 geometry", q, k, v, o, lse,
                                 do, kw))
    del q, k, v, o, lse, do
    rows["flash_attention_bwd"] = {**cases[0], "cases": cases}
    (dout, yb, ps, w), _ = inputs["combine_weighted_bwd"]
    T, K = w.shape
    R, d = yb.shape
    kept = int((ps < R).sum())
    # fp32 copies: CUDA's embedding_bag has no bf16 backward for
    # per_sample_weights (the yardstick reads twice the kernel's bytes)
    ypad = torch.cat([yb, yb.new_zeros((1, d))]).float() \
        .requires_grad_(True)
    wl = w.to(yb.dtype).float().requires_grad_(True)
    lo = F.embedding_bag(ps.clamp(max=R).reshape(T, K), ypad,
                         per_sample_weights=wl, mode="sum", padding_idx=R)
    dout32 = dout.float()
    es = yb.element_size()
    nbytes = es * (T * d + kept * d + R * d) + 8 * T * K + 4 * T * K \
        + 4 * T * K
    rows["combine_weighted_bwd"] = _time_bwd(
        lambda: combine_weighted_bwd(dout, yb, ps, w),
        lambda: combine_weighted_bwd_ref(dout, yb, ps, w),
        lambda: torch.autograd.grad(lo, (ypad, wl), dout32,
                                    retain_graph=True),
        nbytes, 3.0 * kept * d, yb.dtype,
        {"T": T, "K": K, "rows": R, "d": d, "kept": kept, "dtype": "bf16"},
        "combine_weighted_bwd")
    rows["combine_weighted_bwd"]["library_call"] = \
        "embedding_bag(mode=sum, per_sample_weights) backward (autograd), " \
        "fp32 (no bf16 backward on CUDA)"
    for r in cases + [rows["combine_weighted_bwd"]]:
        print(f"[train] {r.get('route', 'cuda')} {r['case']} {r['shape']}: "
              f"{r['ms']:.3f} ms (device {r['device_ms']:.3f}), bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms "
              f"({r['library_call']})")
    return rows


def phase_train(seed: int, gen) -> dict:
    """(a) tensor maps on context-less threads, the backward kernels
    against their plain versions, (b) the
    small fp32 step on the card against the CPU's, (c) the full-width qwen3
    step, then gemma3_1b at published width and depth, and the backward
    kernels timed at their inputs, (d) a resumed run against an
    uninterrupted one."""
    t0 = time.time()
    out = {"fresh_threads": check_fresh_threads(gen),
           "flash_bwd": check_flash_bwd(gen),
           "combine_bwd": check_combine_bwd(gen),
           "small_step": check_card_vs_cpu_step(seed)}
    _free()
    full = full_width_train(seed)
    inputs = full.pop("inputs")
    out["full_width"] = full
    # gemma3's head dim 256: the forward and the backward on the wide-head
    # wgmma kernels
    gemma = full_width_train(seed, GEMMA_ARCH, None, GEMMA_S, "wgmma",
                             kernels=("flash_attention",
                                      "flash_attention_bwd"),
                             record=("flash_attention_bwd",), no_sync=True)
    gemma_inputs = gemma.pop("inputs")
    out["gemma3"] = gemma
    out["timing"] = time_bwd_kernels(inputs, gemma_inputs, gen)
    del inputs, gemma_inputs
    _free()
    out["resume"] = check_resume(seed)
    out["wall_s"] = time.time() - t0
    print(f"[train] phase done in {out['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# spmd: the mesh steps on a (1, 1) mesh over one NCCL rank
# ---------------------------------------------------------------------------

SPMD_STEPS = 2
COMPRESSED_STEPS = 3
# qwen3 at published width: depth 1 holds one state (params + fp32 moments,
# 58-62 GB peak with a step's temporaries); the plain step's result waits on
# the host while the sharded step runs
SPMD_QWEN_LAYERS = 1


def _spmd_step(step_fn, state, batch, i: int):
    """One call of step_fn(state, batch): (state, its record) -- ms (CUDA
    events), tokens/s, peak and cumulative allocated bytes, launches
    (counts set to 0 just before, read just after), flash routes, host
    syncs, and the bytes of the params the step's per-layer gathers made
    and of the gradient shards their backwards made (pshard.GATHER_BYTES,
    also set to 0 just before)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import pshard
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
    _reset_counts()
    pshard.reset_gather_bytes()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    e0.record()
    state, m = step_fn(state, batch)
    e1.record()
    torch.cuda.synchronize()
    wall = time.time() - t0
    return state, {
        "step": i + 1, "loss": float(m["loss"]),
        "grad_norm": float(m["grad_norm"]),
        "step_ms": e0.elapsed_time(e1), "wall_s": wall,
        "tokens_per_s": batch["labels"].numel() / wall,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "allocated_gb": (torch.cuda.memory_stats()[
            "allocated_bytes.all.allocated"] - alloc0) / 1e9,
        "launches": _read_counts(),
        "flash_fwd_by_route": dict(fa.flash_attention.launches_by_route),
        "flash_bwd_by_route": dict(fa.flash_attention_bwd.launches_by_route),
        "host_syncs": _launch.reset_host_syncs(),
        "gathers": pshard.reset_gather_bytes()}


def _spmd_sharded_vs_plain(arch: str, layers, S: int, seed: int, mesh,
                           kernels, interleave: bool) -> dict:
    """`arch` at published width (depth `layers`, None for all), bf16,
    AdamW lr 3e-4, one [1, S] batch: SPMD_STEPS plain build_train_step steps
    and as many build_sharded_train_step steps from the same init on
    `mesh` -- in turns plain, sharded, sharded, plain where both states fit
    (`interleave`), else all plain steps first --; params and moments
    torch.equal.  Every kernel of `kernels` launches in the sharded steps,
    every flash launch on "wgmma"."""
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import (TrainState,
                                          build_sharded_train_step,
                                          build_train_step, state_specs)
    from repro_torch.models.api import build_api
    from repro_torch.models.lm import init_lm_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.tree import leaves, tree_map
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    api = build_api(cfg)
    opt = AdamW(lr=3e-4)
    batch = pipeline_for(cfg, S, 1, seed, device=DEV).batch(0)

    def fresh():
        params = init_lm_params(torch.Generator(device=DEV).manual_seed(seed),
                                cfg, DEV)
        return TrainState(params, opt.init(params))

    def sharded_state():
        state = fresh()
        pspecs = SH.param_specs(state.params, cfg, mesh)
        return SH.distribute_tree(state, mesh, state_specs(pspecs)), pspecs

    plain_fn = build_train_step(api, opt)
    plain, sharded = [], []
    if interleave:  # in turns: plain, sharded, sharded, plain
        p_state, (state, pspecs) = fresh(), sharded_state()
        sharded_fn = build_sharded_train_step(api, opt, mesh, pspecs)
        for arm in ["plain", "sharded", "sharded", "plain"]:
            if arm == "plain":
                p_state, rec = _spmd_step(plain_fn, p_state, batch,
                                          len(plain))
                plain.append(rec)
            else:
                state, rec = _spmd_step(sharded_fn, state, batch,
                                        len(sharded))
                sharded.append(rec)
    else:  # one state at a time: the plain one waits on the host
        p_state = fresh()
        for i in range(SPMD_STEPS):
            p_state, rec = _spmd_step(plain_fn, p_state, batch, i)
            plain.append(rec)
        p_state = tree_map(lambda t: t.to("cpu", copy=True), p_state)
        _free()
        state, pspecs = sharded_state()
        sharded_fn = build_sharded_train_step(api, opt, mesh, pspecs)
        for i in range(SPMD_STEPS):
            state, rec = _spmd_step(sharded_fn, state, batch, i)
            sharded.append(rec)
    want = leaves(p_state)
    got = leaves(SH.full_tree(state))
    diff = [i for i, (g, w) in enumerate(zip(got, want))
            if not torch.equal(g, w.to(g.device))]
    n_leaves = len(want)
    del got, want
    expect(not diff, f"spmd {cfg.name}: {len(diff)} of {n_leaves} params / "
           f"moments differ from the plain step's (leaves {diff[:8]})")
    total = collections.Counter()
    for rec in sharded:
        total.update(rec["launches"])
        fwd, bwd = rec["flash_fwd_by_route"], rec["flash_bwd_by_route"]
        expect(fwd.get("wgmma", 0) == rec["launches"]["flash_attention"]
               and bwd.get("wgmma", 0) == rec["launches"][
                   "flash_attention_bwd"],
               f"spmd {cfg.name}: flash launches off wgmma: {fwd} {bwd}")
    for name in kernels:
        expect(total[name] > 0, f"spmd {cfg.name}: {name} never launched "
               f"in the sharded steps ({dict(total)})")
    expect([r["loss"] for r in sharded] == [r["loss"] for r in plain],
           f"spmd {cfg.name}: losses {[r['loss'] for r in sharded]} vs "
           f"{[r['loss'] for r in plain]}")
    out = {"arch": cfg.name, "layers": cfg.num_layers, "S": S,
           "leaves": n_leaves, "plain": plain, "sharded": sharded,
           "launches": dict(total), "state": state}
    p, s = plain[-1], sharded[-1]
    print(f"[spmd] {cfg.name} ({cfg.num_layers} layers, [1, {S}]): sharded "
          f"== plain after {SPMD_STEPS} steps ({n_leaves} leaves "
          f"torch.equal); step {SPMD_STEPS}: plain {p['step_ms']:.1f} ms, "
          f"sharded {s['step_ms']:.1f} ms; {p['tokens_per_s']:.0f} / "
          f"{s['tokens_per_s']:.0f} tokens/s; peak {p['peak_gb']:.1f} / "
          f"{s['peak_gb']:.1f} GB; allocated in the step "
          f"{p['allocated_gb']:.2f} / {s['allocated_gb']:.2f} GB (extra "
          f"{s['allocated_gb'] - p['allocated_gb']:.2f} GB; the per-layer "
          f"gathers made {s['gathers']['gather'] / 1e9:.2f} GB of params and "
          f"{s['gathers']['reduce'] / 1e9:.2f} GB of gradient shards); "
          f"launches "
          f"{s['launches']}; host syncs {p['host_syncs']} / "
          f"{s['host_syncs']}", flush=True)
    return out


def _spmd_compressed(seed: int, mesh) -> dict:
    """build_compressed_dp_step at gemma3_1b's published width and depth,
    COMPRESSED_STEPS steps on one [1, GEMMA_S] batch, against the same steps
    composed in one process (compress_with_feedback, the dequantized
    values / 1, AdamW.update): params, moments, residuals and losses
    torch.equal; one all-reduce per leaf and step (and one for the loss);
    the loss falls, the residuals are finite."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.launch.steps import (TrainState,
                                          build_compressed_dp_step,
                                          value_and_grad)
    from repro_torch.models.api import build_api
    from repro_torch.models.lm import init_lm_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.compress import (compress_with_feedback,
                                            dequantize_int8, init_residuals)
    from repro_torch.tree import leaves, unflatten
    cfg = get_config(GEMMA_ARCH)
    api = build_api(cfg)
    opt = AdamW(lr=3e-4)
    batch = pipeline_for(cfg, GEMMA_S, 1, seed, device=DEV).batch(0)

    def fresh():
        params = init_lm_params(torch.Generator(device=DEV).manual_seed(seed),
                                cfg, DEV)
        return TrainState(params, opt.init(params)), init_residuals(params)

    calls = [0]
    real = dist.all_reduce

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    step = build_compressed_dp_step(api, opt, mesh, "data")
    state, res = fresh()
    losses, per_step, ms = [], [], []
    dist.all_reduce = counted
    try:
        for _ in range(COMPRESSED_STEPS):
            calls[0] = 0
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, res, loss = step(state, res, batch)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
            losses.append(float(loss))
            per_step.append(calls[0])
    finally:
        dist.all_reduce = real
    n = len(leaves(state.params))
    expect(per_step == [n + 1] * COMPRESSED_STEPS,
           f"spmd compressed: all-reduces per step {per_step}, not "
           f"{n} leaves + the loss")
    expect(losses[-1] < losses[0] and all(np.isfinite(losses)),
           f"spmd compressed: loss did not fall: {losses}")
    expect(all(bool(torch.isfinite(r).all()) for r in leaves(res)),
           "spmd compressed: non-finite residuals")
    # the same steps composed in one process
    state2, res2 = fresh()
    losses2 = []
    for _ in range(COMPRESSED_STEPS):
        (loss, _), grads = value_and_grad(api.loss, state2.params, batch)
        red, new = [], []
        for g, r in zip(leaves(grads), leaves(res2)):
            q, scale, nr = compress_with_feedback(g, r)
            red.append((dequantize_int8(q, scale) / 1.0).to(g.dtype))
            new.append(nr)
        del grads
        opt.update(unflatten(state2.params, red), state2.opt, state2.params)
        res2 = unflatten(res2, new)
        losses2.append(float(loss))
    torch.cuda.synchronize()
    diff = [i for i, (a, b) in enumerate(zip(leaves((state, res)),
                                             leaves((state2, res2))))
            if not torch.equal(a, b)]
    expect(not diff and losses == losses2,
           f"spmd compressed: {len(diff)} leaves differ from the composed "
           f"steps (leaves {diff[:8]}); losses {losses} vs {losses2}")
    del state, res, state2, res2
    _free()
    print(f"[spmd] compressed DP step, {GEMMA_ARCH} ({cfg.num_layers} "
          f"layers, [1, {GEMMA_S}]): torch.equal to the composed steps over "
          f"{COMPRESSED_STEPS} steps; losses {losses}; {per_step[0]} "
          f"all-reduces a step ({n} leaves + the loss); step ms {ms}",
          flush=True)
    return {"losses": losses, "all_reduces_per_step": per_step,
            "leaves": n, "step_ms": ms}


def _spmd_restore(state, cfg_name: str, mesh) -> dict:
    """CheckpointManager.save of a sharded params tree and restore(mesh=,
    specs=) onto the mesh: torch.equal leaf by leaf."""
    import shutil
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config as cfg_of
    from repro_torch.launch import sharding as SH
    from repro_torch.tree import leaves
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "spmd_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.time()
    ckpt = CheckpointManager(d)
    ckpt.save(1, state.params, {"step": 1})
    specs = SH.param_specs(state.params, cfg_of(cfg_name), mesh)
    back = ckpt.restore(state.params, 1, mesh=mesh, specs=specs)
    same = all(torch.equal(a, b) for a, b in zip(
        leaves(SH.full_tree(back)), leaves(SH.full_tree(state.params))))
    wall = time.time() - t0
    nbytes = sum(t.numel() * t.element_size() for t in leaves(back))
    del back
    shutil.rmtree(d, ignore_errors=True)
    expect(same, f"spmd restore(mesh=, specs=): {cfg_name} params differ "
           f"from the saved ones")
    print(f"[spmd] CheckpointManager.restore(mesh=, specs=): {cfg_name} "
          f"params ({nbytes / 1e9:.2f} GB) torch.equal to the saved ones; "
          f"save + restore {wall:.1f}s", flush=True)
    return {"equal": same, "gb": nbytes / 1e9, "wall_s": wall}


def phase_spmd(seed: int, card: str) -> dict:
    """The mesh steps on one card: a one-rank NCCL process group (a
    FileStore under build/), the (1, 1) mesh, the param specs.  (a)
    build_sharded_train_step == build_train_step (params and moments
    torch.equal) at gemma3_1b's published width and depth, [1, 4096], the
    flash kernels on wgmma inside it (52 forward and 26 backward launches a
    step), the arms in turns; (b) the same gate at qwen3's published width,
    depth 1, [1, 2048] (the dispatch / combine kernels; the plain arm first,
    its state then waiting on the host); (c) build_compressed_dp_step
    against its one-process composition; (d) restore(mesh=, specs=)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.time()
    store = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "spmd_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(0)  # before the mesh: its NCCL groups bind to it
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1, device_id=torch.device(DEV, 0))
    try:
        mesh = make_host_mesh(1, 1)
        gemma = _spmd_sharded_vs_plain(
            GEMMA_ARCH, None, GEMMA_S, seed, mesh,
            ("flash_attention", "flash_attention_bwd"), interleave=True)
        for rec in gemma["sharded"]:
            expect(rec["launches"]["flash_attention"] == 52
                   and rec["launches"]["flash_attention_bwd"] == 26,
                   f"spmd gemma3: flash launches {rec['launches']}, not 52 "
                   f"forward (remat's recompute included) and 26 backward")
        restore = _spmd_restore(gemma.pop("state"), GEMMA_ARCH, mesh)
        _free()
        qwen = _spmd_sharded_vs_plain(
            ARCH, SPMD_QWEN_LAYERS, TRAIN_S, seed, mesh,
            ("flash_attention", "flash_attention_bwd", "dispatch_scatter",
             "combine_gather", "combine_weighted_bwd"), interleave=False)
        del qwen["state"]
        _free()
        compressed = _spmd_compressed(seed, mesh)
    finally:
        dist.destroy_process_group()
        os.remove(store)
        _free()
    launches = collections.Counter()
    for run in (gemma, qwen):
        launches.update(run["launches"])
    out = {"gemma3": gemma, "qwen3": qwen, "compressed": compressed,
           "restore": restore, "launches": dict(launches),
           "card": card, "wall_s": time.time() - t0}
    print(f"[spmd] phase done in {out['wall_s']:.1f}s on {card}")
    return out


# ---------------------------------------------------------------------------
# tp: tensor / expert parallel over "model", two ranks on one card
# ---------------------------------------------------------------------------

TP_STEPS = 2
# the fp32 run: gemma3_1b at published width, its first superblock (5
# local layers + 1 global), [1, 2048], TF32 off
TP_FP32_LAYERS = 6
TP_FP32_S = 2048
# |loss - plain loss| / plain loss, each of 2 steps: bf16, where each
# rank's row-parallel output is rounded to bf16 before the sum over
# "model"; fp32 (loss, and each leaf's relative Frobenius error after 2
# steps)
TP_BF16_BAND = 2e-2
TP_FP32_TOL = 1e-4
TP_TIMEOUT = 600  # each process's join timeout: both ranks killed at it
# Serving logits, rank vs plain (relative Frobenius, every step).  qwen3
# (depth 1, bf16) keeps TP_BF16_BAND (worst reading 9.4e-3 on an H100).
# gemma3_1b's 26 bf16 layers read 2.86e-2-3.48e-2 there, as far as its
# plain bf16 run lies from the same run in fp32 (3.2e-2): 5e-2 has room
# above that and lies well below a missing sum over the ranks (p.v, the
# partial outputs of wo, a rank's slots stored by another: 0.24-0.28 on
# the CPU at its widths and 6 layers, tests/_torch_tp_serve_faults.py).
# Subtler faults (a slot off by one, the new token left unwritten, no
# shared max: 1.4e-2-7.5e-2 there in fp32) are held by the fp32 runs at
# TP_FP32_TOL.
TP_BF16_BAND_GEMMA3 = 5e-2
# The recurrent, hybrid and encoder-decoder families over "model" (RWKV
# and Mamba heads, the encoder's, decoder's and cross attention's heads).
# rwkv6's 32 bf16 layers are reported and not gated (None): its random
# weights amplify rounding ~100x (ZOO_FP32_DECODE), so its fp32 run at
# depth 4 holds the gate.  zamba2's 38 bf16 layers read 2.69e-2 on an
# H100, where its plain bf16 run lies 2.62e-2 from the same run in fp32:
# 5e-2 lies above that and well below its faults (the Mamba2 mixer's
# out_proj unsummed over "model" 1.27, its norm's sum of squares left
# local 0.148, its conv ring read and written at its heads' channels
# 1.375, its conv output ungathered 0.500; unbroken 1.60e-2 -- bf16 on the
# CPU at its widths and 6 layers, tests/_torch_tp_serve_faults.py --arch
# zamba2_1p2b).  seamless keeps TP_BF16_BAND (1.50e-2 against a plain bf16
# run 1.49e-2 from fp32).
TP_BF16_BAND_ZAMBA2 = 5e-2
TP_SERVE_BANDS = {"gemma3": TP_BF16_BAND_GEMMA3, "qwen3": TP_BF16_BAND,
                  "gemma3_fp32": TP_FP32_TOL, "qwen3_fp32": TP_FP32_TOL,
                  "zamba2": TP_BF16_BAND_ZAMBA2, "zamba2_fp32": TP_FP32_TOL,
                  "rwkv6": None, "rwkv6_fp32": TP_FP32_TOL,
                  "seamless": TP_BF16_BAND, "seamless_fp32": TP_FP32_TOL}
# The plain process runs each fp32 train run once more from its params
# perturbed by TP_PERTURB relative noise (1-2 ulp) and reports how far that
# moves its losses, grad norms and leaves: the floor under which no program
# whose rounding differs from the plain one's can be held.  The fp32 runs'
# AdamW eps is TP_FP32_EPS, as tests/test_torch_tp.py's: Adam divides each
# element by its own gradient, so with 1e-8 an element whose gradient sits
# at fp32's floor (zero-initialised biases: conv_b, dt_bias, ln_*_b) moves
# by a good part of lr on any change of summation order.  rwkv6 at depth 4,
# [1, 2048], is gated on its loss alone (its grad norms and leaves are
# reported, TP_FP32_REPORTED): a 1e-7 perturbation of its random params
# moves its fp32 grad norm and leaves past 1e-3 there (the line of its run
# prints by how much) -- its random time mix amplifies rounding
# (ZOO_FP32_DECODE) --, so its depth-1 run holds the TP_FP32_TOL gates on
# them.
TP_PERTURB = 1e-7
TP_FP32_EPS = 1e-6
TP_FP32_REPORTED = ("rwkv6_fp32_d4",)
ZAMBA_ARCH, RWKV_ARCH = "zamba2_1p2b", "rwkv6_7b"
SEAMLESS_ARCH = "seamless_m4t_large_v2"
# seamless: [1, 4096] frame embeddings and 2048 decoder tokens (more than
# attn_chunk, 1024, so its decoder's self attention runs the flash kernel;
# decoder_len(4096) = 512 would take the dense path, the reference's rule)
TP_FRAMES, TP_DEC_S = 4096, 2048
# the fp32 cuts: zamba2's first superblock (6 Mamba2 layers and the
# shared block), rwkv6 at depth 4 (5.6 GB of weights; its gated train run
# at depth 1), seamless at 2 + 2
TP_ZAMBA_FP32_LAYERS, TP_RWKV_FP32_LAYERS, TP_SEAMLESS_FP32_LAYERS = 6, 4, 2
TP_RWKV_FP32_TRAIN_LAYERS = 1


def _tp_runs():
    """(name, arch, layers (None: all), S, dtype) of the tp phase's train
    runs (seamless: S frames and TP_DEC_S decoder tokens; its layers those
    of the encoder and of the decoder each)."""
    return [("gemma3", GEMMA_ARCH, None, GEMMA_S, BF),
            ("qwen3", ARCH, SPMD_QWEN_LAYERS, TRAIN_S, BF),
            ("gemma3_fp32", GEMMA_ARCH, TP_FP32_LAYERS, TP_FP32_S, F32),
            ("zamba2", ZAMBA_ARCH, None, GEMMA_S, BF),
            ("zamba2_fp32", ZAMBA_ARCH, TP_ZAMBA_FP32_LAYERS, TP_FP32_S,
             F32),
            ("rwkv6_fp32", RWKV_ARCH, TP_RWKV_FP32_TRAIN_LAYERS, TP_FP32_S,
             F32),
            ("rwkv6_fp32_d4", RWKV_ARCH, TP_RWKV_FP32_LAYERS, TP_FP32_S,
             F32),
            ("seamless", SEAMLESS_ARCH, None, TP_FRAMES, BF),
            ("seamless_fp32", SEAMLESS_ARCH, TP_SEAMLESS_FP32_LAYERS,
             TP_FRAMES, F32)]


def _tp_serve_runs():
    """(name, arch, layers (None: all), S, decode steps, dtype) of the tp
    phase's serving runs: the prompt [1, S] prefilled into caches of
    S + steps slots, then `steps` decode steps (seamless: S frames, its
    TP_DEC_S decoder tokens the prompt).  gemma3_1b's one kv head puts its
    caches over the sequence (split-K decode); qwen3's 4 split over heads
    (2 kv and 32 q heads a rank); zamba2's SSD heads (32 of 64 a rank),
    conv rings (2112 of 4224 channels) and shared block's kv heads split,
    rwkv6's wkv heads (32 of 64), seamless's kv heads (8 of 16)."""
    return [("gemma3", GEMMA_ARCH, None, GEMMA_S, 32, BF),
            ("qwen3", ARCH, SPMD_QWEN_LAYERS, TRAIN_S, 16, BF),
            ("gemma3_fp32", GEMMA_ARCH, TP_FP32_LAYERS, TP_FP32_S, 8, F32),
            ("qwen3_fp32", ARCH, SPMD_QWEN_LAYERS, TRAIN_S, 8, F32),
            ("zamba2", ZAMBA_ARCH, None, GEMMA_S, 16, BF),
            ("zamba2_fp32", ZAMBA_ARCH, TP_ZAMBA_FP32_LAYERS, TP_FP32_S, 8,
             F32),
            ("rwkv6", RWKV_ARCH, None, TP_FP32_S, 8, BF),
            ("rwkv6_fp32", RWKV_ARCH, TP_RWKV_FP32_LAYERS, TP_FP32_S, 8,
             F32),
            ("seamless", SEAMLESS_ARCH, None, TP_FRAMES, 8, BF),
            ("seamless_fp32", SEAMLESS_ARCH, TP_SEAMLESS_FP32_LAYERS,
             TP_FRAMES, 8, F32)]


def _tp_cfg(arch, layers, dtype):
    """`arch` at published width in `dtype`, depth cut to `layers` (the
    encoder-decoder: `layers` in the encoder and in the decoder)."""
    cfg = get_config(arch).replace(dtype=dtype)
    if layers is None:
        return cfg
    if cfg.family == "encdec":
        return cfg.replace(num_layers=2 * layers, encoder_layers=layers,
                           decoder_layers=layers)
    return cfg.replace(num_layers=layers)


def _tp_setup(name, arch, layers, S, dtype, seed):
    """(cfg, api, params, AdamW, the [1, S] train batch): the tokens of
    `pipeline_for` (the encoder-decoder: S frame embeddings from the seed
    and TP_DEC_S decoder tokens and labels from the pipeline)."""
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.models.api import build_api
    from repro_torch.models.frontends import synthetic_embeddings
    from repro_torch.optim.adamw import AdamW
    cfg = _tp_cfg(arch, layers, dtype)
    api = build_api(cfg)
    params = api.init(torch.Generator(device=DEV).manual_seed(seed))
    if cfg.family == "encdec":
        batch = pipeline_for(cfg, TP_DEC_S, 1, seed, device=DEV).batch(0)
        enc = synthetic_embeddings(
            torch.Generator(device=DEV).manual_seed(seed + 3), cfg, 1, S)
        batch = {"enc_embeddings": enc, "dec_tokens": batch["tokens"],
                 "labels": batch["labels"]}
    else:
        batch = pipeline_for(cfg, S, 1, seed, device=DEV).batch(0)
    opt = AdamW(lr=3e-4, eps=TP_FP32_EPS) if dtype == F32 \
        else AdamW(lr=3e-4)
    return cfg, api, params, opt, batch


def _tp_prompt(cfg, batch) -> tuple:
    """(the serving batch: the train batch without its labels, the
    prompt's length)."""
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    return prompt, prompt[_prompt_key(cfg)].shape[1]


def _tp_windows(cfg) -> set:
    """The windows of the causal self-attention layers (None: global)."""
    if cfg.family in ("dense", "moe"):
        return set(_layer_windows(cfg))
    return {None}


def _tp_moe_layer(seed: int):
    """qwen3's MoE layer at published width in fp32 (128 experts, d 4096,
    expert d_ff 1536), its input x and an output cotangent dy, each
    [2048, 4096], from the seed."""
    from repro_torch.models.moe import init_moe_params
    cfg = get_config(ARCH).replace(dtype=F32)
    gen = torch.Generator(device=DEV).manual_seed(seed + 7)
    p = init_moe_params(gen, cfg)
    x = torch.randn((TRAIN_S, cfg.d_model), generator=gen, device=DEV)
    dy = torch.randn((TRAIN_S, cfg.d_model), generator=gen, device=DEV)
    return cfg, p, x, dy


def _tp_moe_grads(p, x, dy, cfg):
    """The capacity MoE layer's output y and the gradients of
    sum(y * dy) + its load-balance loss with respect to x, the router and
    the experts' weights (those `p` holds: all, or one rank's)."""
    from repro_torch.models.moe import moe_forward_capacity
    ins = {"x": x, "router": p["router"],
           **{f"experts/{k}": v for k, v in p["experts"].items()}}
    ins = {k: v.detach().requires_grad_(True) for k, v in ins.items()}
    q = dict(p, router=ins["router"],
             experts={k: ins[f"experts/{k}"] for k in p["experts"]})
    y, aux = moe_forward_capacity(q, ins["x"], cfg)
    g = torch.autograd.grad((y * dy).sum() + aux.load_balance_loss,
                            list(ins.values()))
    return y.detach(), dict(zip(ins, g))


class _FirstOfEach(list):
    """A `_recording` list that keeps only the first call of each distinct
    (tensor shapes and strides, keyword options), its tensors detached."""

    def __init__(self):
        super().__init__()
        self.keys = set()

    def append(self, call):
        args, kw, out = call
        key = (tuple((tuple(a.shape), a.stride()) for a in args
                     if torch.is_tensor(a)), tuple(sorted(kw.items())))
        if key not in self.keys:
            self.keys.add(key)
            super().append((tuple(a.detach() if torch.is_tensor(a) else a
                                  for a in args), kw, out.detach()))


def _tp_check_flash(calls, gen) -> list:
    """Each distinct mha_flash call a rank's bf16 steps made (its local
    heads: the q, k, v the main path gave the kernel, window, softcap),
    again on the card: the forward against attention_fwd_ref (o within
    FWD_TOL and ROW_REL_TOL, the lse within LSE_TOL) and the backward, with
    a dO from the seed, against attention_bwd_ref (dq, dk, dv within
    BWD_TOL, relative Frobenius); the routes each direction took."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_launch)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_fwd_ref)

    def took(wrapper, before):
        now = _routes(wrapper)
        return {r: now[r] - before.get(r, 0) for r in now
                if now[r] != before.get(r, 0)}

    out = []
    for (q, k, v), kw, _ in calls:
        opts = dict(causal=kw.get("causal", True), window=kw.get("window"),
                    softcap=kw.get("softcap"))
        do = torch.randn(q.shape, generator=gen, device=DEV).to(q.dtype)
        fwd, bwd = _routes(flash_attention), _routes(flash_attention_bwd)
        o, lse = flash_launch(q, k, v, with_lse=True, **opts)
        fwd = took(flash_attention, fwd)
        got = flash_attention_bwd(q, k, v, o, lse, do, **opts)
        bwd = took(flash_attention_bwd, bwd)
        o_ref, lse_ref = attention_fwd_ref(q.float(), k.float(), v.float(),
                                           **opts)
        want = attention_bwd_ref(q.float(), k.float(), v.float(), o.float(),
                                 lse, do.float(), **opts)
        rel = [_rel_fro(a, b) for a, b in zip(got, want)]
        out.append({"q": list(q.shape), "k": list(k.shape),
                    "window": opts["window"], "softcap": opts["softcap"],
                    "fwd_routes": fwd, "bwd_routes": bwd,
                    "o_err": max_err(o, o_ref),
                    "o_row_rel_err": row_rel_err(o, o_ref),
                    "lse_err": max_err(lse, lse_ref), "rel_dq": rel[0],
                    "rel_dk": rel[1], "rel_dv": rel[2]})
        del o, lse, got, o_ref, lse_ref, want, do
    return out


def _timed(fn):
    """(fn(), its ms between CUDA events around it, after a sync)."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def _tp_serve(prefill, decode, batch, steps: int, tokens=None) -> dict:
    """prefill(batch), then `steps` decode(caches, {"token": t}) steps fed
    `tokens` (the plain run's greedy tokens) or, where None, the run's own
    greedy tokens: the logits of every step (on the host, fp32), the
    tokens fed, prefill ms and each decode step's ms (CUDA events), the
    launches of the prefill and of the decode steps (counts set to 0 just
    before each, read just after), the host syncs counted in the decode
    steps, the peak allocated; whether every decode step wrote the caches
    in place (the same objects back, every leaf at its own storage: the
    KV caches and the recurrent states)."""
    from repro_torch.tree import leaves
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    (logits, caches), pre_ms = _timed(lambda: prefill(batch))
    rec = {"prefill_launches": _read_counts(), "prefill_ms": pre_ms,
           "prefill_flash_routes": dict(flash_attention.launches_by_route),
           "decode_ms": [], "logits": [logits.float().cpu()], "tokens": []}
    ptrs = [t.data_ptr() for t in leaves(caches)]
    in_place = True
    _reset_counts()
    for i in range(steps):
        tok = tokens[i].to(DEV) if tokens is not None \
            else logits.argmax(-1).to(torch.int32)
        (logits, again), ms = _timed(lambda: decode(caches, {"token": tok}))
        in_place &= again is caches and \
            [t.data_ptr() for t in leaves(again)] == ptrs
        rec["decode_ms"].append(ms)
        rec["logits"].append(logits.float().cpu())
        rec["tokens"].append(tok.cpu())
    rec["in_place"] = in_place
    rec["decode_launches"] = _read_counts()
    rec["decode_host_syncs"] = _launch.reset_host_syncs()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del caches, logits
    return rec


@contextlib.contextmanager
def _routing(forced=None):
    """moe.router_topk recording each call's expert choices (idx [T, K],
    kept on the card), or, given `forced` (such a record), taking its
    choices call by call, weighted by this run's own probabilities: a run
    routed as another was.  Yields the record."""
    import repro_torch.models.moe as moe_mod
    fn, calls, it = moe_mod.router_topk, [], iter(forced or ())

    def route(p, x, cfg):
        w, idx, probs = fn(p, x, cfg)
        if forced is None:
            calls.append(idx.clone())
            return w, idx, probs
        idx = next(it)
        w = probs.gather(-1, idx.long())
        if cfg.router_renorm:
            w = w / torch.sum(w, dim=-1, keepdim=True)
        return w, idx, probs

    moe_mod.router_topk = route
    try:
        yield calls
    finally:
        moe_mod.router_topk = fn


def _route_flips(a: list, b: list) -> float:
    """The share of the (token, choice) pairs of record `a` (`_routing`)
    whose expert record `b` did not choose for that token, every call."""
    moved = total = 0
    for x, y in zip(a, b):
        hit = (x.long()[:, :, None] == y.long()[:, None, :]).any(-1)
        moved += int((~hit).sum())
        total += hit.numel()
    return moved / total


def _tp_serve_plain(seed: int) -> dict:
    """The plain one-device serving runs (`api.prefill`, `api.decode` on
    their own greedy tokens); a bf16 run again in fp32 on its params cast
    up, fed the same tokens: its logits ("fp32_logits") measure how far
    bf16's own rounding moves the plain run's ("rel_err_fp32").  An MoE
    run once more in fp32 routed as the bf16 run was ("rel_err_fp32_routed")
    beside the share of expert choices fp32 makes otherwise ("route_flips"):
    how much of that distance the routing makes."""
    from repro_torch.models.api import build_api
    from repro_torch.tree import tree_map
    out = {}
    for name, arch, layers, S, steps, dtype in _tp_serve_runs():
        cfg, api, params, _, batch = _tp_setup(name, arch, layers, S, dtype,
                                               seed)
        batch, P = _tp_prompt(cfg, batch)
        moe = dtype == BF and bool(cfg.num_experts)
        with torch.no_grad():
            with _routing() if moe else contextlib.nullcontext() as routes:
                rec = _tp_serve(
                    lambda b, a=api, p=params: a.prefill(p, dict(
                        b, max_len=P + steps)),
                    lambda c, t, a=api, p=params: a.decode(p, c, t),
                    batch, steps)
            if dtype == BF:
                api32 = build_api(cfg.replace(dtype=F32))
                params = tree_map(lambda t: t.float()
                                  if t.is_floating_point() else t, params)
                _free()

                def up():
                    return _tp_serve(
                        lambda b: api32.prefill(params, dict(
                            b, max_len=P + steps)),
                        lambda c, t: api32.decode(params, c, t), batch,
                        steps, rec["tokens"])["logits"]

                with _routing() if moe else contextlib.nullcontext() as r32:
                    rec["fp32_logits"] = up()
                rec["rel_err_fp32"] = [_rel_fro(g, w) for g, w in zip(
                    rec["logits"], rec["fp32_logits"])]
                if moe:
                    rec["route_flips"] = _route_flips(routes, r32)
                    with _routing(routes):
                        routed = up()
                    rec["rel_err_fp32_routed"] = [_rel_fro(g, w) for g, w in
                                                  zip(rec["logits"], routed)]
                    del routes, r32, routed
        out[name] = rec
        del params
        _free()
    return out


def _tp_serve_rank(mesh, seed: int, plain: dict) -> dict:
    """This rank's mesh serving runs: build_sharded_prefill_step, then
    build_sharded_decode_step fed the plain run's greedy tokens; each
    step's logits against the plain run's (relative Frobenius), the greedy
    tokens that agree; in bf16 each distinct flash call of the prefill
    (its local heads) against the plain versions (`_tp_check_flash`)."""
    import repro_torch.models.attention as attn_mod
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import (build_sharded_decode_step,
                                          build_sharded_prefill_step,
                                          prefill_cache_specs)
    out = {}
    for name, arch, layers, S, steps, dtype in _tp_serve_runs():
        cfg, api, params, _, batch = _tp_setup(name, arch, layers, S, dtype,
                                               seed)
        batch, P = _tp_prompt(cfg, batch)
        pspecs = SH.param_specs(params, cfg, mesh)
        dparams = SH.distribute_tree(params, mesh, pspecs)
        del params
        _free()
        prefill = build_sharded_prefill_step(api, mesh, pspecs, P + steps)
        decode = build_sharded_decode_step(
            api, mesh, pspecs, prefill_cache_specs(api, mesh, batch,
                                                   P + steps))
        want = plain[name]
        calls = _FirstOfEach()
        with contextlib.ExitStack() as stack:
            if dtype == BF:  # the kernel's inputs at the local shapes
                stack.enter_context(_recording(attn_mod, "mha_flash", calls))
            rec = _tp_serve(lambda b: prefill(dparams, b),
                            lambda c, t: decode(dparams, c, t), batch, steps,
                            want["tokens"])
        rec["rel_err"] = [_rel_fro(g, w) for g, w in zip(rec["logits"],
                                                          want["logits"])]
        if want["fp32_logits"] is not None:
            rec["rel_err_fp32"] = [_rel_fro(g, w) for g, w in zip(
                rec["logits"], want["fp32_logits"])]
        rec["greedy_agree"] = sum(
            int(torch.equal(g.argmax(-1), w.argmax(-1)))
            for g, w in zip(rec["logits"][1:], want["logits"][1:]))
        del rec["logits"], rec["tokens"], dparams
        _free()
        if dtype == BF:
            rec["flash_checks"] = _tp_check_flash(
                calls, torch.Generator(device=DEV).manual_seed(seed + 13))
        del calls
        _free()
        out[name] = rec
    return out


def _leaf_rel_errs(got: list, want: list) -> list:
    """Each leaf's relative Frobenius error (float64 norms)."""
    return [float(torch.linalg.vector_norm((g - w).double()) / max(float(
        torch.linalg.vector_norm(w.double())), 1e-30))
        for g, w in zip(got, want)]


def _tp_plain_steps(name, arch, layers, S, dtype, seed, perturb=0.0):
    """TP_STEPS plain build_train_step steps of one tp run: (records, the
    params after them); `perturb`: every floating leaf first multiplied by
    1 + perturb * N(0, 1) (a generator from the seed)."""
    from repro_torch.launch.steps import TrainState, build_train_step
    from repro_torch.tree import leaves
    cfg, api, params, opt, batch = _tp_setup(name, arch, layers, S, dtype,
                                             seed)
    if perturb:
        gen = torch.Generator(device=DEV).manual_seed(seed + 29)
        with torch.no_grad():
            for p in leaves(params):
                if p.is_floating_point():
                    p.mul_(1 + perturb * torch.randn(
                        p.shape, generator=gen, device=DEV, dtype=p.dtype))
    state = TrainState(params, opt.init(params))
    step = build_train_step(api, opt)
    recs = []
    for i in range(TP_STEPS):
        state, rec = _spmd_step(step, state, batch, i)
        recs.append(rec)
    return recs, state.params


def _tp_plain(seed: int, out_dir: str):
    """The plain one-device steps of the tp phase's runs, in a process of
    their own: their records and the fp32 runs' params kept on the host
    (torch.save), then freed.  Each fp32 run once more from its params
    perturbed by TP_PERTURB relative noise: how far rounding-sized changes
    move its losses, grad norms and leaves (`recs["conditioning"]`)."""
    from repro_torch.tree import leaves
    recs, keep, cond = {}, {}, {}
    for name, arch, layers, S, dtype in _tp_runs():
        recs[name], params = _tp_plain_steps(name, arch, layers, S, dtype,
                                             seed)
        if dtype == F32:
            keep[name] = [p.cpu() for p in leaves(params)]
            del params
            _free()
            moved, params = _tp_plain_steps(name, arch, layers, S, dtype,
                                            seed, TP_PERTURB)
            cond[name] = {
                "param_rel_err": _leaf_rel_errs(
                    [p.cpu() for p in leaves(params)], keep[name]),
                **{f"{k}_rel_err": [abs(m[k] - r[k]) / abs(r[k]) for m, r
                                    in zip(moved, recs[name])]
                   for k in ("loss", "grad_norm")}}
        del params
        _free()
    recs["conditioning"] = cond
    serve = _tp_serve_plain(seed)
    keep["serve"] = {k: {"logits": r.pop("logits"), "tokens": r.pop("tokens"),
                         "fp32_logits": r.pop("fp32_logits", None)}
                     for k, r in serve.items()}
    recs["serve"] = serve
    torch.save(keep, os.path.join(out_dir, "plain.pt"))
    del keep
    # written last, whole: the ranks wait for this file
    tmp = os.path.join(out_dir, "plain.json.tmp")
    with open(tmp, "w") as f:
        json.dump(recs, f)
    os.replace(tmp, os.path.join(out_dir, "plain.json"))


def _tp_state(params, opt, mesh, pspecs):
    """The train state over `mesh`: the params placed by their specs (the
    whole tree freed), the moments made on the local shards alone."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import OptState
    from repro_torch.tree import tree_map
    dparams = SH.distribute_tree(params, mesh, pspecs)
    local = opt.init(tree_map(lambda t: t.to_local(), dparams))

    def wrap(t, s):
        return DTensor.from_local(t, mesh, SH.placements(s, mesh),
                                  run_check=False)

    return TrainState(dparams, OptState(local.step,
                                        tree_map(wrap, local.m, pspecs),
                                        tree_map(wrap, local.v, pspecs)))


def _tp_rank(rank: int, seed: int, out_dir: str):
    """One of the two ranks: a gloo group over a FileStore (two ranks on
    one card: NCCL refuses them), the (1, 2) mesh, each run's
    build_sharded_train_step steps (on the local heads, FFN columns,
    experts and vocab rows), the fp32 run's local shards against the plain
    step's, the bf16 runs' flash calls at their local shapes against the
    plain versions (`_tp_check_flash`), the fp32 MoE layer's output and
    gradients on this rank's 64 experts against the one-device layer's."""
    import torch.distributed as dist
    import repro_torch.models.attention as attn_mod
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_sharded_train_step
    from repro_torch.models import pshard
    from repro_torch.tree import leaves
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(out_dir, "store"), 2), rank=rank, world_size=2)
    # started beside the plain process: the card is its until it is done
    done = os.path.join(out_dir, "plain.json")
    while not os.path.exists(done):
        time.sleep(0.1)
    plain = torch.load(os.path.join(out_dir, "plain.pt"))
    out = {"rank": rank}
    try:
        mesh = make_host_mesh(1, 2, device_type=DEV)
        for name, arch, layers, S, dtype in _tp_runs():
            cfg, api, params, opt, batch = _tp_setup(name, arch, layers, S,
                                                     dtype, seed)
            pspecs = SH.param_specs(params, cfg, mesh)
            cspecs = SH.compute_specs(params, cfg, mesh)
            state = _tp_state(params, opt, mesh, pspecs)
            del params
            _free()
            step = build_sharded_train_step(api, opt, mesh, pspecs)
            recs, flash_calls = [], _FirstOfEach()
            with contextlib.ExitStack() as stack:
                if dtype == BF:  # the kernel's inputs at the local shapes
                    stack.enter_context(_recording(attn_mod, "mha_flash",
                                                   flash_calls))
                for i in range(TP_STEPS):
                    state, rec = _spmd_step(step, state, batch, i)
                    recs.append(rec)
            local = [p.to_local() for p in leaves(state.params)]
            run = {"steps": recs, "layers": cfg.num_layers,
                   "finite": all(bool(torch.isfinite(p).all())
                                 for p in local),
                   "leaves": len(local),
                   "model_sharded_leaves": sum(
                       any(e is not None for e in c)
                       for c in leaves(cspecs))}
            if name in plain:
                run["param_rel_err"] = _leaf_rel_errs(local, [
                    SH.local_shard(w, s, mesh).to(DEV)
                    for w, s in zip(plain[name], leaves(pspecs))])
            out[name] = run
            del state, local
            _free()
            if dtype == BF:
                run["flash_checks"] = _tp_check_flash(
                    flash_calls, torch.Generator(device=DEV).manual_seed(
                        seed + 11))
            del flash_calls
            _free()
        # the MoE layer: one device (all 128 experts) first, this rank's
        # share of its gradients kept, then this rank's 64 experts
        cfg, p, x, dy = _tp_moe_layer(seed)
        E = cfg.num_experts // 2
        mine = slice(rank * E, (rank + 1) * E)
        y_one, g_one = _tp_moe_grads(p, x, dy, cfg)
        g_one = {k: (g[mine] if k.startswith("experts/") else g).clone()
                 for k, g in g_one.items()}
        p["experts"] = {k: v[mine].contiguous()
                        for k, v in p["experts"].items()}
        _free()
        group = mesh.get_group(mesh.mesh_dim_names.index("model"))
        with pshard.model_parallel(group, 2, rank):
            y, g = _tp_moe_grads(p, x, dy, cfg)
        out["moe_equal"] = bool(torch.equal(y, y_one))
        out["moe_grad_rel_err"] = {k: _rel_fro(g[k], w)
                                   for k, w in g_one.items()}
        out["moe_grad_equal"] = {k: bool(torch.equal(g[k], w))
                                 for k, w in g_one.items()}
        out["moe_local_experts"] = E
        del p, x, dy, y, y_one, g, g_one
        _free()
        out["serve"] = _tp_serve_rank(mesh, seed, plain["serve"])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _tp_spawn(args: list, out_dir: str, tag: str):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)] + args
        + ["--tp-dir", out_dir],
        stdout=open(os.path.join(out_dir, f"{tag}.log"), "w"),
        stderr=subprocess.STDOUT)


def _tp_join(procs: dict, out_dir: str):
    """Wait for every process (TP_TIMEOUT each from now); at the timeout,
    or when one fails, kill them all and fail with their logs' tails."""
    end = time.time() + TP_TIMEOUT
    bad = []
    for tag, p in procs.items():
        try:
            rc = p.wait(timeout=max(1.0, end - time.time()))
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            bad.append((tag, rc))
            for q in procs.values():
                q.kill()
    for p in procs.values():
        p.wait()
    if bad:
        tails = []
        for tag, rc in bad:
            with open(os.path.join(out_dir, f"{tag}.log")) as f:
                tails.append(f"{tag} rc={rc}:\n{f.read()[-3000:]}")
        expect(False, "tp: " + "\n".join(tails))


def _tp_gate_flash(name: str, rank: int, checks: list, cfg):
    """The gates on `_tp_check_flash`'s records of one rank's bf16 run:
    every call on the local heads (H / 2 q heads), each of the model's
    windows seen, both directions on "wgmma" and within the bf16 bars."""
    what = f"tp {name} rank {rank}"
    windows = {c["window"] for c in checks}
    expect(windows == _tp_windows(cfg), f"{what}: flash calls at "
           f"windows {windows}, the model's are {_tp_windows(cfg)}")
    for c in checks:
        at = f"{what}: flash q {c['q']} k {c['k']} window {c['window']}"
        expect(c["q"][2] == cfg.num_heads // 2, f"{at}: not the local "
               f"{cfg.num_heads // 2} q heads")
        expect(c["fwd_routes"] == {"wgmma": 1} and c["bwd_routes"] ==
               {"wgmma": 1}, f"{at}: routes {c['fwd_routes']} / "
               f"{c['bwd_routes']}, not one launch each on wgmma")
        expect(c["o_err"] <= FWD_TOL[BF] and c["o_row_rel_err"] <=
               ROW_REL_TOL[BF] and c["lse_err"] <= LSE_TOL,
               f"{at}: forward o err {c['o_err']} (tol {FWD_TOL[BF]}), row "
               f"rel {c['o_row_rel_err']} (tol {ROW_REL_TOL[BF]}), lse err "
               f"{c['lse_err']} (tol {LSE_TOL})")
        rel = [c["rel_dq"], c["rel_dk"], c["rel_dv"]]
        expect(max(rel) <= BWD_TOL[BF], f"{at}: dq / dk / dv rel err {rel} "
               f"> {BWD_TOL[BF]}")


def _tp_gate_serve(plain: dict, ranks: list):
    """The lines of the mesh serving runs, then their gates: every step's
    logits within the run's band of TP_SERVE_BANDS of the plain run's,
    relative Frobenius (a band of None: reported only); in bf16 every
    flash launch of the prefill on "wgmma", one a causal self-attention
    layer, each distinct call at the local heads against the plain
    versions (`_tp_gate_flash`); qwen3's dispatch and combine launched in
    the prefill and in every decode step; no host sync counted in the
    decode steps; every cache written in place."""
    gates = []
    for name, arch, layers, S, steps, dtype in _tp_serve_runs():
        cfg = _tp_cfg(arch, layers, dtype)
        P = TP_DEC_S if cfg.family == "encdec" else S
        band = TP_SERVE_BANDS[name]
        p = plain[name]
        runs = [rr["serve"][name] for rr in ranks]
        dec_ms = [sorted(r["decode_ms"])[steps // 2] for r in runs]
        fp32 = "" if "rel_err_fp32" not in p else (
            f"; bf16 against the same run in fp32 (worst step): plain "
            f"{max(p['rel_err_fp32']):.4g}, ranks "
            f"{[round(max(r['rel_err_fp32']), 4) for r in runs]}") + (
            "" if "route_flips" not in p else
            f"; the plain run in fp32 routed as the bf16 run: "
            f"{max(p['rel_err_fp32_routed']):.4g} (expert choices that "
            f"differ in fp32: {p['route_flips']:.4%})")
        print(f"[tp] serve {name} ({cfg.num_layers} layers, prefill [1, {P}]"
              + (f" on [1, {S}] frames" if P != S else "") +
              f" into {P + steps} slots, {steps} decode steps, "
              f"{str(dtype).replace('torch.', '')}, mesh (1, 2)): logits rel "
              f"err vs plain, worst step a rank "
              f"{[max(r['rel_err']) for r in runs]} (prefill "
              f"{[r['rel_err'][0] for r in runs]}; band {band}){fp32}; "
              f"greedy tokens agreeing with plain "
              f"{[r['greedy_agree'] for r in runs]} of {steps}; prefill ms "
              f"plain {p['prefill_ms']:.2f}, ranks "
              f"{[round(r['prefill_ms'], 2) for r in runs]}; decode ms a "
              f"step (median) plain {sorted(p['decode_ms'])[steps // 2]:.2f}"
              f", ranks {[round(x, 2) for x in dec_ms]}; peak allocated "
              f"plain {p['peak_gb']:.2f} GB, ranks "
              f"{[round(r['peak_gb'], 2) for r in runs]} GB; launches a "
              f"rank, prefill {runs[0]['prefill_launches']}, decode "
              f"{runs[0]['decode_launches']}; host syncs in the decode "
              f"steps {[r['decode_host_syncs'] for r in runs]}", flush=True)
        for c in runs[0].get("flash_checks", []):
            print(f"[tp] serve {name} flash at the local shapes q {c['q']} k "
                  f"{c['k']} window {c['window']}: forward "
                  f"{c['fwd_routes']} o err {c['o_err']:.2e} row rel "
                  f"{c['o_row_rel_err']:.2e} lse err {c['lse_err']:.2e}",
                  flush=True)
        gates.append((name, cfg, steps, dtype, band))
    for name, cfg, steps, dtype, band in gates:
        for rr in ranks:
            rec, what = rr["serve"][name], f"tp serve {name} rank {rr['rank']}"
            expect(len(rec["rel_err"]) == steps + 1 and all(
                math.isfinite(x) for x in rec["rel_err"]) and (
                band is None or max(rec["rel_err"]) <= band),
                f"{what}: logits vs plain rel {rec['rel_err']} (band "
                f"{band})")
            expect(rec["decode_host_syncs"] == 0, f"{what}: "
                   f"{rec['decode_host_syncs']} host syncs in the decode "
                   f"steps")
            expect(rec["in_place"], f"{what}: a decode step did not write "
                   f"its caches in place")
            pre, dec = rec["prefill_launches"], rec["decode_launches"]
            n_flash = _zoo_flash_layers(cfg)
            if dtype == BF and n_flash:
                routes = {k: n for k, n in
                          rec["prefill_flash_routes"].items() if n}
                expect(routes == {"wgmma": pre["flash_attention"]} and
                       pre["flash_attention"] == n_flash,
                       f"{what}: flash launches {pre['flash_attention']} by "
                       f"route {routes}, not one a causal self-attention "
                       f"layer ({n_flash}) on wgmma")
                _tp_gate_flash(f"serve {name}", rr["rank"],
                               rec["flash_checks"], cfg)
            if cfg.num_experts:
                for k in ("dispatch_scatter", "combine_gather"):
                    expect(pre[k] >= cfg.num_layers and
                           dec[k] >= steps * cfg.num_layers,
                           f"{what}: {k} launches prefill {pre[k]}, decode "
                           f"{dec[k]} (< one a layer and step)")


def phase_tp(seed: int, card: str) -> dict:
    """Tensor / expert parallel over "model" on one card: the plain steps
    in a process of their own first (their records and the fp32 run's
    params kept on the host, then freed), then two ranks of a gloo group
    on the same card (spawned beside it, waiting for its results; all
    three killed at the join timeout), the (1, 2) mesh.  gemma3_1b whole,
    bf16, [1, 4096] (2 local heads, K / V whole, FFN and vocab halves): 52
    flash forward and 26 backward launches a step on "wgmma"; qwen3 at
    depth 1, bf16, [1, 2048] (64 experts and 32 heads a rank): the
    dispatch / combine kernels and the combine's backward launched; both
    runs' losses and grad norms within TP_BF16_BAND of the plain step's,
    every leaf finite, their flash calls at the local shapes against the
    plain versions (`_tp_gate_flash`).  gemma3_1b's first superblock in
    fp32: loss, grad norm and each leaf within TP_FP32_TOL; qwen3's MoE
    layer in fp32 on each rank's 64 experts: output torch.equal to the
    one-device layer's, gradients within TP_FP32_TOL.  Then the serving
    runs (`_tp_serve_runs`, gated by `_tp_gate_serve`): the mesh prefill
    and decode steps against the plain api.prefill / api.decode."""
    import shutil
    t0 = time.time()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "tp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    # the ranks start beside the plain process and wait for its results
    # before they touch the card beyond their context
    procs = {"plain": _tp_spawn(["--tp-child", "plain", "--seed",
                                 str(seed)], out_dir, "plain")}
    procs.update({f"rank{r}": _tp_spawn(["--tp-child", str(r), "--seed",
                                         str(seed)], out_dir, f"rank{r}")
                  for r in range(2)})
    _tp_join(procs, out_dir)
    t_plain = os.path.getmtime(os.path.join(out_dir, "plain.json")) - t0
    with open(os.path.join(out_dir, "plain.json")) as f:
        plain = json.load(f)
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    launches = collections.Counter()
    for rr in ranks:
        for name, *_ in _tp_runs():
            for rec in rr[name]["steps"]:
                launches.update(rec["launches"])
        for rec in rr["serve"].values():
            launches.update(rec["prefill_launches"])
            launches.update(rec["decode_launches"])
    out = {"plain": plain, "ranks": ranks, "launches": dict(launches),
           "card": card}
    for name, arch, layers, S, dtype in _tp_runs():
        band = TP_BF16_BAND if dtype == BF else TP_FP32_TOL
        for rr in ranks:
            run = rr[name]
            expect(run["finite"], f"tp {name} rank {rr['rank']}: a "
                   f"non-finite leaf")
            for key in ("loss", "grad_norm"):
                want = [rec[key] for rec in plain[name]]
                got = [rec[key] for rec in run["steps"]]
                rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
                run[f"{key}_rel_err"] = rel
                if key == "grad_norm" and name in TP_FP32_REPORTED:
                    continue
                expect(max(rel) <= band, f"tp {name} rank {rr['rank']}: "
                       f"{key} {got} vs plain {want} (rel {rel} > {band})")
            if dtype == BF:
                _tp_gate_flash(name, rr["rank"], run["flash_checks"],
                               get_config(arch))
            if "param_rel_err" in run and name not in TP_FP32_REPORTED:
                worst = max(run["param_rel_err"])
                expect(worst <= TP_FP32_TOL, f"tp {name} rank "
                       f"{rr['rank']}: a leaf {worst:.3g} from the plain "
                       f"step's (> {TP_FP32_TOL}; the plain step perturbed "
                       f"by {TP_PERTURB}: "
                       f"{max(plain['conditioning'][name]['param_rel_err']):.3g})")
            for rec in run["steps"]:
                fwd, bwd = rec["flash_fwd_by_route"], \
                    rec["flash_bwd_by_route"]
                if dtype == BF:
                    expect(fwd.get("wgmma", 0) == rec["launches"][
                        "flash_attention"] and bwd.get("wgmma", 0) ==
                        rec["launches"]["flash_attention_bwd"],
                        f"tp {name}: flash launches off wgmma: {fwd} {bwd}")
                if name == "gemma3":
                    expect(rec["launches"]["flash_attention"] == 52
                           and rec["launches"]["flash_attention_bwd"] == 26,
                           f"tp gemma3: flash launches {rec['launches']}, "
                           f"not 52 forward (remat's recompute included) "
                           f"and 26 backward")
                if name in ("zamba2", "seamless"):
                    n = _zoo_flash_layers(_tp_cfg(arch, layers, dtype))
                    expect(rec["launches"]["flash_attention"] == 2 * n
                           and rec["launches"]["flash_attention_bwd"] == n,
                           f"tp {name}: flash launches {rec['launches']}, "
                           f"not {2 * n} forward (remat's recompute "
                           f"included) and {n} backward")
            if name == "qwen3":
                total = collections.Counter()
                for rec in run["steps"]:
                    total.update(rec["launches"])
                for k in ("flash_attention", "flash_attention_bwd",
                          "dispatch_scatter", "combine_gather",
                          "combine_weighted_bwd"):
                    expect(total[k] > 0, f"tp qwen3 rank {rr['rank']}: {k} "
                           f"never launched ({dict(total)})")
        p, s = plain[name][-1], ranks[0][name]["steps"][-1]
        cond = plain["conditioning"]
        print(f"[tp] {name} ({ranks[0][name]['layers']} layers, [1, {S}], "
              f"{str(dtype).replace('torch.', '')}, mesh (1, 2), "
              f"{ranks[0][name]['model_sharded_leaves']} of "
              f"{ranks[0][name]['leaves']} leaves computed over \"model\"): "
              f"losses plain {[r['loss'] for r in plain[name]]}, ranks "
              f"{[[r['loss'] for r in rr[name]['steps']] for rr in ranks]} "
              f"(rel {[rr[name]['loss_rel_err'] for rr in ranks]}); step "
              f"{TP_STEPS}: plain {p['step_ms']:.1f} ms, ranks "
              f"{[round(rr[name]['steps'][-1]['step_ms'], 1) for rr in ranks]}"
              f" ms; peak plain {p['peak_gb']:.2f} GB, ranks "
              f"{[round(rr[name]['steps'][-1]['peak_gb'], 2) for rr in ranks]}"
              f" GB; grad norm rel {[rr[name]['grad_norm_rel_err'] for rr in ranks]}"
              f"; the per-layer gathers made {s['gathers']['gather'] / 1e9:.2f}"
              f" GB of params and {s['gathers']['reduce'] / 1e9:.2f} GB of "
              f"gradient shards a rank; launches a rank {s['launches']}"
              + (f"; worst leaf {max(max(rr[name]['param_rel_err']) for rr in ranks):.3g}"
                 if "param_rel_err" in ranks[0][name] else "")
              + (f"; the plain step from params perturbed by {TP_PERTURB}: "
                 f"loss rel {max(cond[name]['loss_rel_err']):.3g}, grad norm"
                 f" rel {max(cond[name]['grad_norm_rel_err']):.3g}, worst "
                 f"leaf {max(cond[name]['param_rel_err']):.3g}"
                 if name in cond else ""), flush=True)
        for c in ranks[0][name].get("flash_checks", []):
            print(f"[tp] {name} flash at the local shapes q {c['q']} k "
                  f"{c['k']} window {c['window']} softcap {c['softcap']}: "
                  f"forward {c['fwd_routes']} o err {c['o_err']:.2e} row rel "
                  f"{c['o_row_rel_err']:.2e} lse err {c['lse_err']:.2e}; "
                  f"backward {c['bwd_routes']} rel dq {c['rel_dq']:.2e} dk "
                  f"{c['rel_dk']:.2e} dv {c['rel_dv']:.2e} (tols "
                  f"{FWD_TOL[BF]}, {ROW_REL_TOL[BF]}, {LSE_TOL}, "
                  f"{BWD_TOL[BF]})", flush=True)
    for rr in ranks:
        expect(rr["moe_equal"], f"tp: qwen3's fp32 MoE layer on rank "
               f"{rr['rank']}'s {rr['moe_local_experts']} experts differs "
               f"from the one-device layer")
        worst = max(rr["moe_grad_rel_err"].values())
        expect(worst <= TP_FP32_TOL, f"tp: qwen3's fp32 MoE layer's "
               f"gradients on rank {rr['rank']} vs the one-device layer's: "
               f"{rr['moe_grad_rel_err']} (> {TP_FP32_TOL})")
    print(f"[tp] qwen3 MoE layer, fp32, [{TRAIN_S}, "
          f"{get_config(ARCH).d_model}], {ranks[0]['moe_local_experts']} "
          f"experts a rank: output torch.equal to the one-device layer on "
          f"both ranks; gradients of sum(y * dy) + the load-balance loss "
          f"(x, router, the rank's experts) rel err "
          f"{[rr['moe_grad_rel_err'] for rr in ranks]} (tol {TP_FP32_TOL}), "
          f"torch.equal {[rr['moe_grad_equal'] for rr in ranks]}", flush=True)
    _tp_gate_serve(plain["serve"], ranks)
    out["wall_s"] = time.time() - t0
    out["plain_s"] = t_plain
    print(f"[tp] phase done in {out['wall_s']:.1f}s (the plain process's "
          f"results after {t_plain:.1f}s) on {card}")
    return out


def phase_gmm(cfg, params, seed: int, gen) -> dict:
    """lm_forward with the Super Kernel as its gmm (make_super_kernel_gmm):
    in fp32 at the reference's test config against the einsum path (tol
    2e-4), then at full width on one prefill batch of [1, 2048] (N = 16384
    pairs) against lm_forward on default_gmm (relative Frobenius error of
    the logits, tol 1e-1), the launch counts of all four kernels set to 0
    just before and read just after; then the "whole" dispatch at this N
    against the TPU-signature zero fill + "scatter"."""
    from repro_torch.kernels.dispatch_combine.dispatch_combine import \
        dispatch_scatter
    from repro_torch.kernels.dispatch_combine.ops import kernel_moe_dispatch
    from repro_torch.kernels.dispatch_combine.ref import (
        dispatch_scatter_ref, dispatch_whole_ref)
    from repro_torch.kernels.super_gmm.ops import make_super_kernel_gmm
    from repro_torch.models.lm import init_lm_params, lm_forward
    from repro_torch.models.moe import expert_capacity
    small = get_config(ARCH).smoke().replace(num_layers=3, num_experts=4,
                                             top_k=2, capacity_factor=8.0)
    sp = init_lm_params(torch.Generator(device=DEV).manual_seed(seed + 3),
                        small, DEV)
    tok = torch.as_tensor(np.random.RandomState(seed).randint(
        0, small.vocab_size, (2, 16)), device=DEV)
    with torch.inference_mode():
        got, _ = lm_forward(sp, small, tok, gmm=make_super_kernel_gmm(
            sp["stages"][0]["ffn"]["experts"], small))
        want, _ = lm_forward(sp, small, tok)
    err32 = max_err(got, want)
    expect(err32 <= 2e-4, f"gmm fp32: lm_forward on the Super Kernel vs "
           f"einsum: err {err32}")
    print(f"[gmm] fp32 {small.num_layers}L x {small.num_experts}e top-2: "
          f"lm_forward(gmm=make_super_kernel_gmm(...)) vs the einsum path: "
          f"max err {err32:.2e} (tol 2e-4)")
    del sp
    kernels = _pd_kernels()
    B, S, L = 1, 2048, cfg.num_layers
    tok = torch.as_tensor(np.random.RandomState(seed + 1).randint(
        0, cfg.vocab_size, (B, S)), device=DEV)
    gmm = make_super_kernel_gmm(params["stages"][0]["ffn"]["experts"], cfg)
    with torch.inference_mode():
        lm_forward(params, cfg, tok, gmm=gmm)  # warm-up, not counted
        torch.cuda.synchronize()
        for k in kernels.values():
            _launch.reset_launches(k)
        _launch.reset_host_syncs()
        t0 = time.perf_counter()
        got, aux = lm_forward(params, cfg, tok, gmm=gmm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        by_route = {n: _routes(k) for n, k in kernels.items()}
        syncs = _launch.reset_host_syncs()
        t0 = time.perf_counter()
        want, aux_e = lm_forward(params, cfg, tok)
        torch.cuda.synchronize()
        wall_e = time.perf_counter() - t0
    expect(tuple(got.shape) == (B, S, cfg.vocab_size)
           and bool(torch.isfinite(got.float()).all()),
           "gmm: logits of the wrong shape or not finite")
    for name, route, n in (("super_gmm", "wgmma", 3 * L),
                           ("dispatch_scatter", "whole", L),
                           ("combine_gather", "weighted", L)):
        expect(launches[name] == n and by_route[name][route] == n,
               f"gmm: {name} launched {launches[name]} times, by route "
               f"{by_route[name]}; expected {n} on {route}")
    diff = (got.float() - want.float()).norm()
    rel = float(diff / want.float().norm())
    del diff
    expect(rel <= 0.1, f"gmm bf16: rel err {rel}")
    drop, drop_e = float(aux.dropped_fraction), float(aux_e.dropped_fraction)
    print(f"[gmm] full width {L}L bf16, tokens [{B}, {S}] (N = "
          f"{B * S * cfg.top_k} pairs per layer): lm_forward on the Super "
          f"Kernel vs on default_gmm: relative Frobenius err {rel:.3e} (tol "
          f"1e-1), max abs err {max_err(got, want):.3e}; dropped pairs "
          f"{drop:.4f} / {drop_e:.4f}; launches {launches} (super_gmm 3 per "
          f"layer on wgmma, dispatch 'whole' and combine 'weighted' 1 per "
          f"layer), host syncs {syncs}; wall {wall * 1e3:.1f} ms (default_gmm "
          f"{wall_e * 1e3:.1f} ms)")
    del got, want
    _free()
    # the "whole" dispatch at this N against the TPU-signature pair
    T, E, K, d = B * S, cfg.num_experts, cfg.top_k, cfg.d_model
    C = expert_capacity(T, cfg)
    token_of, slot, idx = _pairs(gen, T, E, K, C)
    x = torch.randn((T, d), generator=gen, device=DEV).bfloat16()
    N, rows, el = T * K, E * C + 1, 2
    kept = int((slot < E * C).sum())
    slot64, tok64 = slot.long(), token_of.long()
    shape = {"T": T, "K": K, "N": N, "E": E, "C": C, "rows_out": rows,
             "d": d, "dtype": "bf16", "pairs_kept": kept}
    cases = [
        _call_case(
            "prefill_path", "dispatch_whole",
            lambda: kernel_moe_dispatch(x, idx, cfg, C),
            el * d * (E * C + T) + 4 * N + 8 * (3 * N + E) + N,
            {**shape, "route": "whole"},
            plain=lambda: dispatch_whole_ref(x, idx, E, C),
            err=max_err(kernel_moe_dispatch(x, idx, cfg, C)[0].reshape(
                E * C, d), dispatch_whole_ref(x, idx, E, C)[0])),
        _call_case(
            "prefill_tpu_signature", "dispatch_scatter_kernel",
            lambda: dispatch_scatter(token_of, slot, x, rows_out=rows),
            el * d * (2 * kept + rows), {**shape, "route": "scatter"},
            plain=lambda: dispatch_scatter_ref(token_of, slot, x, rows),
            lib=lambda: torch.zeros((rows, d), dtype=x.dtype, device=DEV)
            .index_copy_(0, slot64, x.index_select(0, tok64)),
            lib_name="torch.zeros((E*C+1, d)).index_copy_(0, slot, "
                     "x.index_select(0, token_of))",
            err=max_err(dispatch_scatter(token_of, slot, x, rows_out=rows),
                        dispatch_scatter_ref(token_of, slot, x, rows)))]
    w, p = cases[0]["device_ms"], cases[1]["device_ms"]
    print(f"[gmm] dispatch at prefill N={N} (E={E} C={C} d={d}, {kept} pairs "
          f"kept): 'whole' {1e3 * w:.2f} us device in "
          f"{cases[0]['launches_per_call']} launch(es), bound "
          f"{1e3 * cases[0]['bound_ms']:.2f} us; TPU-signature zero fill + "
          f"scatter {1e3 * p:.2f} us (bound {1e3 * cases[1]['bound_ms']:.2f} "
          f"us; library {1e3 * cases[1]['library_device_ms']:.2f} us): whole "
          f"/ scatter = {_ratio(w, p):.2f} "
          f"({'whole wins' if w < p else 'whole LOSES'}); max abs err {cases[0]['max_abs_err']} / "
          f"{cases[1]['max_abs_err']}")
    return {"launches": launches, "by_route": by_route, "rel_err": rel,
            "fp32_err": err32, "wall_ms": 1e3 * wall,
            "default_gmm_wall_ms": 1e3 * wall_e, "dispatch_cases": cases}


# --------------------------------------------------------------- zoo --

# The model families behind build_api at published width, bf16: (arch,
# layers run -- None for full depth --, greedy decode steps after the
# prefill).  rwkv6 decodes 32 steps: its recurrent state must not drift.
ZOO = (("gemma3_1b", None, 32), ("qwen2_1p5b", None, 8), ("olmo_1b", None, 8),
       ("deepseek_coder_33b", 8, 8), ("chameleon_34b", 8, 8),
       ("rwkv6_7b", None, 32), ("zamba2_1p2b", None, 8),
       ("seamless_m4t_large_v2", None, 8))
ZOO_B, ZOO_S = 2, 2048  # prompt tokens per model: S > attn_chunk (1024)
# the encoder-decoder's input: frame embeddings, decoder_len(16384) = 2048
# decoder tokens, so its decoder's self attention runs the flash kernel
ZOO_FRAMES = {"seamless_m4t_large_v2": 16384}
ZOO_TOL = 0.1  # relative Frobenius error of bf16 logits, as the gmm phase
# Families whose random-weight model amplifies rounding far past ZOO_TOL in
# bf16: rwkv6's time mix is cubic in its input (r, k, v all projections of
# it).  On an NVIDIA H100 80GB HBM3 at 700 W, _zoo_fp32_decode measured a
# rounding gain of 98.9 at published width and depth (a 1e-3 relative
# perturbation of the embedded prompt moved the fp32 logits by 9.9e-2), and
# bf16 decode vs api.forward read up to 2.0e-1 while fp32 read 1.7e-4.
# Their decode is held to api.forward in fp32 at the same width and depth;
# the bf16 errors are reported beside it.
ZOO_FP32_DECODE = ("rwkv6_7b",)


def _zoo_flash_layers(cfg) -> int:
    """The causal self-attention layers of one prefill, each a flash launch
    when its sequence is longer than attn_chunk: none in rwkv6, one per
    application of zamba2's shared block, the decoder's layers of the
    encoder-decoder (its encoder and cross attention are plain, as in the
    reference), every layer of a decoder-only transformer."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    if cfg.family == "encdec":
        return cfg.decoder_layers
    return cfg.num_layers


def _prompt_key(cfg) -> str:
    """The batch entry that holds the tokens a decode continues."""
    return "dec_tokens" if cfg.family == "encdec" else "tokens"


def _dense_prefill(params, cfg, batch, max_len):
    """The prefill's logits with every causal attention on the dense oracle
    (use_dense=True) in place of the flash kernel."""
    if cfg.family == "encdec":
        from repro_torch.models.encdec import encdec_prefill
        return encdec_prefill(params, batch["enc_embeddings"],
                              batch["dec_tokens"], cfg, max_len=max_len,
                              use_dense=True)[0]
    from repro_torch.models.lm import lm_prefill
    return lm_prefill(params, cfg, batch["tokens"], max_len=max_len,
                      use_dense=True)[0]


def _param_gb(tree) -> float:
    """Bytes of a nested dict / list of tensors, in GB."""
    if isinstance(tree, dict):
        return sum(_param_gb(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_param_gb(v) for v in tree)
    return 0.0 if tree is None else tree.numel() * tree.element_size() / 1e9


def _rel_fro(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


class _Recorder:
    """Calls `fn` unchanged and keeps each call's (args, kwargs, result).
    Every other attribute is `fn`'s, read and written through: a wrapper
    that counts its launches on itself (`_launch.count_launch`) still counts
    on the real function while its module's name points here."""

    def __init__(self, fn, calls: list):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_calls", calls)

    def __call__(self, *args, **kwargs):
        out = self._fn(*args, **kwargs)
        self._calls.append((args, kwargs, out))
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextlib.contextmanager
def _recording(module, name: str, calls=None):
    """Replaces module.name by a `_Recorder` of it: the main path's own
    inputs and outputs of a kernel's wrapper, held against the plain
    version after the counted run.  Yields the list of calls (`calls`, a
    new list if None); restores module.name on exit."""
    fn = getattr(module, name)
    calls = [] if calls is None else calls
    setattr(module, name, _Recorder(fn, calls))
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def _zoo_check_flash(calls, what: str) -> dict:
    """Each recorded mha_flash call of a main path (bf16, causal) against
    _mha_plain on the same q, k, v: max abs error within 4e-2 and row
    relative error within ROW_REL_TOL, the kernels phase's bf16 bars."""
    worst = {"max_abs_err": 0.0, "row_rel_err": 0.0, "calls": len(calls)}
    for i, ((q, k, v), kw, got) in enumerate(calls):
        expect(kw.get("causal", True), f"{what}: flash call {i} not causal")
        ref = _mha_plain(q, k, v, kw.get("window"), kw.get("softcap"))
        err, rel = max_err(got, ref), row_rel_err(got, ref)
        expect(err <= 4e-2 and rel <= ROW_REL_TOL[torch.bfloat16],
               f"{what}: flash call {i} (q {tuple(q.shape)}, k "
               f"{tuple(k.shape)}, window {kw.get('window')}) vs plain: err "
               f"{err} (tol 4e-2), row rel err {rel} (tol "
               f"{ROW_REL_TOL[torch.bfloat16]})")
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        worst["row_rel_err"] = max(worst["row_rel_err"], rel)
        del ref
    return worst


def zoo_teacher_forced(seed: int) -> dict:
    """fp32 on the card at each family's smoke config (attn_chunk 32, window
    16): api.prefill of [2, 40] tokens (the encoder-decoder: 40 frames and
    64 decoder tokens) -- the attention through the flash kernel's fma
    route, rwkv6's and zamba2's chunked scans --, then 20 greedy api.decode
    steps (gemma's rings wrap; the recurrent states are carried); every
    token == the argmax of api.forward over the prompt plus the tokens so
    far, where the oracle's top-2 gap is under 1e-3 within 1e-4 of its
    max."""
    from repro_torch.models.api import build_api
    out = {}
    for arch, _, _ in ZOO:
        cfg = get_config(arch).smoke()
        api = build_api(cfg)
        gen = torch.Generator(device=DEV).manual_seed(seed + 11)
        params = api.init(gen)
        batch = api.make_batch(gen, 40, 2, "prefill", device=DEV)
        key = _prompt_key(cfg)
        seq = batch[key]
        checked = near = 0
        with torch.inference_mode():
            logits, caches = api.prefill(params, {
                **batch, "max_len": seq.shape[1] + 20})
            for _ in range(20):
                tok = torch.argmax(logits, -1)
                ref = api.forward(params, {**batch, key: seq})[0][:, -1] \
                    .float()
                top2 = torch.topk(ref, 2, dim=-1).values
                for b in range(2):
                    t_b, r = int(tok[b]), ref[b]
                    if float(top2[b, 0] - top2[b, 1]) > 1e-3:
                        expect(t_b == int(torch.argmax(r)),
                               f"zoo teacher-forced {arch} row {b} position "
                               f"{seq.shape[1]}: {t_b} != oracle "
                               f"{int(torch.argmax(r))}")
                    else:
                        near += 1
                        expect(float(r.max() - r[t_b]) <= 1e-4,
                               f"zoo teacher-forced near-tie {arch}")
                    checked += 1
                seq = torch.cat([seq, tok[:, None]], 1)
                logits, caches = api.decode(params, caches, {"token": tok})
        out[arch] = {"tokens": checked, "near_ties": near}
        del params, caches
    _free()
    print(f"[zoo] teacher-forced fp32 at the smoke configs: "
          f"{sum(v['tokens'] for v in out.values())} greedy tokens of "
          f"{len(out)} families == argmax of api.forward over prompt + "
          f"tokens so far ({sum(v['near_ties'] for v in out.values())} "
          f"near-ties checked at 1e-4)")
    return out


def _zoo_model(arch: str, layers, steps: int, seed: int) -> dict:
    """One config at published width in bf16, random weights from `seed`:
    api.prefill of [2, 2048] tokens (the encoder-decoder: [2, 16384] frame
    embeddings and 2048 decoder tokens), every causal attention layer on the
    flash kernel, then `steps` greedy api.decode steps; the counts of all
    four kernels set to 0 just before the counted prefill and read after
    the last step.  Gated: finite logits; flash launches ==
    _zoo_flash_layers, all on the route its head dim takes; each of those
    launches' outputs against the plain version on the same q, k, v
    (_zoo_check_flash); the prefill's logits within ZOO_TOL of the same
    prefill on the dense attention oracle (rwkv6 has no attention: there it
    is the same path); no host sync in the decode steps (the CUDA sync
    debug mode counts them); each step's logits within ZOO_TOL of
    api.forward over the prompt plus the tokens so far."""
    import repro_torch.models.attention as attn_mod
    from repro_torch.kernels.flash_attention.flash_attention import \
        WGMMA_HEAD_DIMS
    from repro_torch.models.api import build_api
    full = get_config(arch)
    cfg = full if layers is None else full.replace(num_layers=layers)
    L, B = cfg.num_layers, ZOO_B
    n_flash, key = _zoo_flash_layers(cfg), _prompt_key(cfg)
    api = build_api(cfg)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    _free()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9  # earlier phases' leftovers
    params = api.init(gen)
    torch.cuda.synchronize()
    weights_gb = _param_gb(params)
    route = "wgmma" if cfg.head_dim in WGMMA_HEAD_DIMS else "wmma"
    batch = api.make_batch(gen, ZOO_FRAMES.get(arch, ZOO_S), B, "prefill",
                           device=DEV)
    S = batch[key].shape[1]
    batch["max_len"] = S + steps
    kernels = _pd_kernels()
    with torch.inference_mode():
        # warm-up: a prefill and one step on its own caches, not counted
        lg, c = api.prefill(params, batch)
        api.decode(params, c, {"token": torch.argmax(lg, -1)})
        del lg, c
        torch.cuda.synchronize()
        for k in kernels.values():
            _launch.reset_launches(k)
        with _recording(attn_mod, "mha_flash") as flash_calls:
            t0 = time.perf_counter()
            logits, caches = api.prefill(params, batch)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        prefill_by_route = _routes(flash_attention)
        expect(flash_attention.launches == n_flash
               and prefill_by_route[route] == n_flash,
               f"zoo {arch}: prefill launched flash {prefill_by_route}, "
               f"expected {n_flash} on {route}")
        if cfg.local_per_global:
            # 2048 prompt tokens fill every ring: each step overwrites a slot
            rings = [c["local"] for c in caches if isinstance(c, dict)] + [
                c for c in caches if not isinstance(c, dict)]
            expect(all(int(r.length.min()) >= r.k.shape[-3] for r in rings),
                   f"zoo {arch}: a ring is not full after the prefill")
        steps_logits, tokens = [logits], []
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                ev[0].record()
                for i in range(steps):
                    tok = torch.argmax(steps_logits[-1], -1)
                    tokens.append(tok)
                    lg, caches = api.decode(params, caches, {"token": tok})
                    steps_logits.append(lg)
                    ev[i + 1].record()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        # the sync debug mode's own warning; its once-per-process notice
        # ("...is a prototype feature...") is not a sync
        hits = [w for w in caught
                if "called a synchronizing CUDA operation" in str(w.message)]
        sync_at = sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                          for w in hits})
        syncs = len(hits)
        step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
        launches = {n: k.launches for n, k in kernels.items()}
        by_route = _routes(flash_attention)
        expect(launches == {"super_gmm": 0, "flash_attention": n_flash,
                            "dispatch_scatter": 0, "combine_gather": 0}
               and by_route == prefill_by_route,
               f"zoo {arch}: launches {launches}, flash by route "
               f"{by_route}: the decode steps launch no kernel")
        expect(syncs == 0, f"zoo {arch}: {syncs} host syncs in {steps} "
               f"decode steps, at {sync_at}")
        peak_alloc = torch.cuda.max_memory_allocated() / 1e9
        peak_res = torch.cuda.max_memory_reserved() / 1e9
        prompt = batch[key]
        for i, lg in enumerate(steps_logits):
            expect(bool(torch.isfinite(lg.float()).all()),
                   f"zoo {arch}: step {i} logits not finite")
        expect(len(flash_calls) == n_flash, f"zoo {arch}: {len(flash_calls)}"
               f" mha_flash calls recorded in the prefill, expected "
               f"{n_flash}")
        flash = _zoo_check_flash(flash_calls, f"zoo {arch}")
        del flash_calls
        dense = _dense_prefill(params, cfg, batch, S + steps)
        errs = [_rel_fro(logits, dense)]  # the prefill: vs the dense oracle
        del dense
        for i in range(1, steps + 1):
            seq = torch.cat([prompt] + [t[:, None] for t in tokens[:i]], 1)
            ref = api.forward(params, {**batch, key: seq})[0][:, -1]
            errs.append(_rel_fro(steps_logits[i], ref))
            del ref
        expect(errs[0] <= ZOO_TOL,
               f"zoo {arch}: prefill logits vs the dense attention oracle rel "
               f"err {errs[0]} (tol {ZOO_TOL})")
        expect(arch in ZOO_FP32_DECODE or max(errs[1:]) <= ZOO_TOL,
               f"zoo {arch}: decode logits vs api.forward rel err "
               f"{max(errs[1:])} (tol {ZOO_TOL})")
    toks = torch.stack(tokens, 1).cpu().tolist()
    r = {"arch": arch, "layers": L, "published_layers": full.num_layers,
         "cut": None if layers is None else
         f"depth {full.num_layers} -> {L}", "B": B, "S": S,
         "encoder_frames": ZOO_FRAMES.get(arch), "flash_layers": n_flash,
         "weights_gb": weights_gb, "prefill_ms": 1e3 * prefill_s,
         "prefill_tokens_per_s": B * S / prefill_s, "decode_steps": steps,
         "decode_ms_per_step": 1e3 * decode_s / steps,
         "decode_step_ms_events": step_ms,
         "host_syncs_per_step": syncs / steps, "launches": launches,
         "flash_by_route": by_route, "flash_vs_plain": flash,
         "rel_err_prefill_vs_dense": errs[0],
         "rel_err_decode": errs[1:], "rel_err_max": max(errs),
         "decode_gated_in": "fp32" if arch in ZOO_FP32_DECODE else "bf16",
         "tokens": toks, "allocated_before_gb": before_gb,
         "peak_allocated_gb": peak_alloc, "peak_reserved_gb": peak_res}
    print(f"[zoo] {arch} {L}/{full.num_layers} layers, d_model "
          f"{cfg.d_model}, H {cfg.num_heads} KVH {cfg.num_kv_heads} dh "
          f"{cfg.head_dim}, bf16, {weights_gb:.1f} GB of weights: prefill "
          f"[{B}, {S}]"
          + (f" over [{B}, {ZOO_FRAMES[arch]}] encoder frames"
             if arch in ZOO_FRAMES else "")
          + f" {r['prefill_ms']:.1f} ms ({r['prefill_tokens_per_s']:.0f}"
          f" tokens/s), flash {by_route} ({n_flash} on {route}); {steps} "
          f"decode steps {r['decode_ms_per_step']:.2f} ms/step (events: "
          f"median {sorted(step_ms)[steps // 2]:.2f}), host syncs per step "
          f"{r['host_syncs_per_step']:.2f}; the prefill's {n_flash} flash "
          f"outputs "
          f"vs plain on their own q, k, v: max abs err "
          f"{flash['max_abs_err']:.2e} (tol 4e-2), row rel err "
          f"{flash['row_rel_err']:.2e} (tol {ROW_REL_TOL[torch.bfloat16]}); "
          f"prefill logits vs the dense oracle rel err {errs[0]:.2e}, decode "
          f"logits vs api.forward {', '.join(f'{e:.2e}' for e in errs[1:])}"
          + (f" (not gated in bf16: held in fp32 below)"
             if arch in ZOO_FP32_DECODE else f" (tol {ZOO_TOL})")
          + f"; peak allocated {peak_alloc:.1f} GB ("
          f"{before_gb:.1f} GB allocated before), reserved {peak_res:.1f} GB")
    del params, caches, logits, steps_logits
    _free()
    if arch in ZOO_FP32_DECODE:
        r["fp32_decode"] = _zoo_fp32_decode(arch, steps, seed)
    return r


def _zoo_fp32_decode(arch: str, steps: int, seed: int) -> dict:
    """The decode check of a ZOO_FP32_DECODE family in fp32 at published
    width and full depth, random weights from `seed`: api.prefill of [2,
    2048] tokens, then `steps` greedy api.decode steps, each step's logits
    within ZOO_TOL of api.forward over the prompt plus the tokens so far
    (gated).  Also measured: the model's rounding gain, the relative change
    of the last logits when the embedded prompt is perturbed by 1e-3 of its
    standard deviation, divided by 1e-3."""
    from repro_torch.models.api import build_api
    from repro_torch.models.lm import embed_tokens, lm_forward
    cfg = get_config(arch).replace(dtype=torch.float32)
    api = build_api(cfg)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    _free()
    torch.cuda.reset_peak_memory_stats()
    params = api.init(gen)
    weights_gb = _param_gb(params)
    batch = api.make_batch(gen, ZOO_S, ZOO_B, "prefill", device=DEV)
    prompt = batch["tokens"]
    S = prompt.shape[1]
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, caches = api.prefill(params, {**batch, "max_len": S + steps})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        seq, errs = prompt, []
        for _ in range(steps):
            tok = torch.argmax(logits, -1)
            seq = torch.cat([seq, tok[:, None]], 1)
            logits, caches = api.decode(params, caches, {"token": tok})
            ref = api.forward(params, {"tokens": seq})[0][:, -1]
            errs.append(_rel_fro(logits, ref))
            del ref
        emb = embed_tokens(params, prompt, None, cfg)
        noise = torch.randn(emb.shape, generator=gen, device=DEV) \
            * float(emb.std()) * 1e-3
        base = lm_forward(params, cfg, embeddings=emb)[0][:, -1]
        moved = lm_forward(params, cfg, embeddings=emb + noise)[0][:, -1]
        gain = _rel_fro(moved, base) / 1e-3
        del emb, noise, base, moved
    expect(max(errs) <= ZOO_TOL, f"zoo {arch} fp32: decode logits vs "
           f"api.forward rel err {max(errs)} (tol {ZOO_TOL})")
    r = {"dtype": "fp32", "layers": cfg.num_layers, "B": ZOO_B, "S": S,
         "weights_gb": weights_gb, "prefill_ms": 1e3 * prefill_s,
         "decode_steps": steps, "rel_err_decode": errs,
         "rel_err_max": max(errs), "rounding_gain": gain,
         "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[zoo] {arch} in fp32 at published width, {cfg.num_layers} "
          f"layers, {weights_gb:.1f} GB: prefill [{ZOO_B}, {S}] "
          f"{r['prefill_ms']:.1f} ms; {steps} greedy decode steps, logits vs "
          f"api.forward rel err max {max(errs):.2e} (tol {ZOO_TOL}; "
          f"{', '.join(f'{e:.1e}' for e in errs)}); rounding gain "
          f"{gain:.1f} (relative logit change per relative change of the "
          f"embedded prompt, 1e-3 of its std); peak allocated "
          f"{r['peak_allocated_gb']:.1f} GB")
    del params, caches, logits
    _free()
    return r


# super_gmm's gated FFN on deepseek_v32's dispatched buffer against its
# plain version: relative Frobenius error of the bf16 outputs.  ~4.5x what a
# sound kernel read on an H100 (8.8e-4); losing one expert of 256 (its
# share of the rows zeroed) would read about 6e-2.
ZOO_GMM_TOL = 4e-3


def _super_moe_ffn_plain(layer_id, experts: dict, xb, act, chunk: int = 32):
    """super_moe_ffn_ref over `chunk` experts at a time: its fp32 copy of a
    whole layer of deepseek_v32's experts would be 45 GB."""
    return torch.cat([
        super_moe_ffn_ref(layer_id, {n: w[:, e:e + chunk]
                                     for n, w in experts.items()},
                          xb[e:e + chunk], act)
        for e in range(0, xb.shape[0], chunk)])


def _zoo_check_moe(cfg, experts: dict, gmm_calls, dispatch_calls,
                   combine_calls) -> dict:
    """deepseek_v32's MoE kernels on the main path's own inputs and outputs
    against their plain versions: the dispatch torch.equal to
    dispatch_whole_ref on every output; the combine torch.equal to
    combine_weighted_ref and within 1 bf16 ulp of moe_combine (the kernels
    phase's bars); super_gmm's gated FFN within ZOO_GMM_TOL of
    super_moe_ffn_ref."""
    from repro_torch.kernels.dispatch_combine.ref import (combine_weighted_ref,
                                                          dispatch_whole_ref)
    from repro_torch.models.moe import moe_combine
    E = cfg.num_experts
    names = ("xb", "perm", "slot", "valid", "group_sizes", "pair_slot")
    for (x, idx, _, C), _, (xb, info) in dispatch_calls:
        got = (xb.reshape(E * C, -1),) + tuple(info[n] for n in names[1:])
        for name, g, p in zip(names, got, dispatch_whole_ref(x, idx, E, C)):
            expect(torch.equal(g, p), f"zoo deepseek_v32: dispatch {name} at "
                   f"T={x.shape[0]} E={E} C={C} != its plain version")
    ulps = 0.0
    for (yb, info, w, T), kw, got in combine_calls:
        plain = combine_weighted_ref(yb.reshape(-1, yb.shape[-1]),
                                     info["pair_slot"], w)
        expect(torch.equal(got, plain), f"zoo deepseek_v32: combine at T={T}"
               f" E={E} != its plain version")
        ulps = max(ulps, _bf16_ulps(got, moe_combine(yb, info, w, T, **kw)))
    expect(ulps <= 1.0, f"zoo deepseek_v32: combine {ulps} bf16 ulps from "
           f"moe_combine")
    gmm_err = 0.0
    for (xb, _, cfg_inner, layer_id), got in gmm_calls:
        plain = _super_moe_ffn_plain(layer_id, experts, xb,
                                     act_fn(cfg_inner.act)).to(got.dtype)
        gmm_err = max(gmm_err, _rel_fro(got, plain))
        del plain
    expect(gmm_err <= ZOO_GMM_TOL, f"zoo deepseek_v32: super_gmm's FFN vs "
           f"super_moe_ffn_ref rel err {gmm_err} (tol {ZOO_GMM_TOL})")
    return {"dispatch_calls": len(dispatch_calls), "dispatch_equal": True,
            "combine_calls": len(combine_calls), "combine_equal": True,
            "combine_ulps_vs_moe_combine": ulps, "gmm_calls": len(gmm_calls),
            "gmm_rel_err_vs_plain": gmm_err}


def _zoo_deepseek_v32(seed: int) -> dict:
    """deepseek_v32 at published width (d_model 7168, 128 x 192 heads, 8 KV
    heads, 256 experts top-8, one shared expert), depth 61 -> 1 (a layer of
    experts is 22.5 GB in bf16): lm_forward(gmm=make_super_kernel_gmm(...))
    on tokens [1, 2048] against lm_forward on default_gmm, relative
    Frobenius error of the logits within ZOO_TOL; flash at dh 192 on wgmma,
    super_gmm 3 launches on wgmma with E = 256, dispatch "whole" and combine
    "weighted" 1 each -- counts set to 0 just before the counted call.  The
    counted call's flash, dispatch, gmm and combine calls are recorded and
    each held against its plain version on the same inputs
    (_zoo_check_flash, _zoo_check_moe)."""
    import repro_torch.models.attention as attn_mod
    import repro_torch.models.moe as moe_mod
    from repro_torch.kernels.super_gmm.ops import make_super_kernel_gmm
    from repro_torch.models.lm import init_lm_params, lm_forward
    full = get_config("deepseek_v32")
    cfg = full.replace(num_layers=1)
    _free()
    torch.cuda.reset_peak_memory_stats()
    before_gb = torch.cuda.memory_allocated() / 1e9  # earlier phases' leftovers
    params = init_lm_params(torch.Generator(device=DEV).manual_seed(seed + 5),
                            cfg, DEV)
    torch.cuda.synchronize()
    weights_gb = _param_gb(params)
    tok = torch.as_tensor(np.random.RandomState(seed + 6).randint(
        0, cfg.vocab_size, (1, ZOO_S)), device=DEV)
    experts = params["stages"][0]["ffn"]["experts"]
    gmm, gmm_calls = make_super_kernel_gmm(experts, cfg), []

    def gmm_recorded(*args):  # the gmm, its calls kept as _recording does
        out = gmm(*args)
        gmm_calls.append((args, out))
        return out

    kernels = _pd_kernels()
    with torch.inference_mode():
        lm_forward(params, cfg, tok, gmm=gmm)  # warm-up, not counted
        torch.cuda.synchronize()
        for k in kernels.values():
            _launch.reset_launches(k)
        with _recording(attn_mod, "mha_flash") as flash_calls, \
                _recording(moe_mod, "kernel_moe_dispatch") as dispatch_calls, \
                _recording(moe_mod, "kernel_moe_combine") as combine_calls:
            t0 = time.perf_counter()
            got, aux = lm_forward(params, cfg, tok, gmm=gmm_recorded)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        by_route = {n: _routes(k) for n, k in kernels.items()}
        want, _ = lm_forward(params, cfg, tok)
        expect(tuple(got.shape) == (1, ZOO_S, cfg.vocab_size)
               and bool(torch.isfinite(got.float()).all()),
               "zoo deepseek_v32: logits of the wrong shape or not finite")
        for name, route, n in (("flash_attention", "wgmma", 1),
                               ("super_gmm", "wgmma", 3),
                               ("dispatch_scatter", "whole", 1),
                               ("combine_gather", "weighted", 1)):
            expect(launches[name] == n and by_route[name][route] == n,
                   f"zoo deepseek_v32: {name} launched {launches[name]} "
                   f"times, by route {by_route[name]}; expected {n} on "
                   f"{route}")
        expect(len(flash_calls) == len(gmm_calls) == len(dispatch_calls)
               == len(combine_calls) == 1, "zoo deepseek_v32: expected one "
               "recorded call of each kernel's wrapper")
        rel = _rel_fro(got, want)
        expect(rel <= ZOO_TOL, f"zoo deepseek_v32: rel err {rel}")
        del want
        flash = _zoo_check_flash(flash_calls, "zoo deepseek_v32")
        moe = _zoo_check_moe(cfg, experts, gmm_calls, dispatch_calls,
                             combine_calls)
        del flash_calls, gmm_calls, dispatch_calls, combine_calls
    r = {"arch": "deepseek_v32", "layers": 1,
         "published_layers": full.num_layers,
         "cut": f"depth {full.num_layers} -> 1", "B": 1, "S": ZOO_S,
         "weights_gb": weights_gb, "forward_ms": 1e3 * wall,
         "tokens_per_s": ZOO_S / wall, "launches": launches,
         "by_route": by_route, "rel_err_vs_default_gmm": rel,
         "flash_vs_plain": flash, "moe_vs_plain": moe,
         "dropped_fraction": float(aux.dropped_fraction),
         "allocated_before_gb": before_gb,
         "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
         "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
    print(f"[zoo] deepseek_v32 1/{full.num_layers} layers at published "
          f"width (d_model {cfg.d_model}, H {cfg.num_heads} x {cfg.head_dim}, "
          f"KVH {cfg.num_kv_heads}, {cfg.num_experts} experts top-"
          f"{cfg.top_k} + {cfg.num_shared_experts} shared), bf16, "
          f"{weights_gb:.1f} GB: lm_forward on the Super Kernel, tokens [1, "
          f"{ZOO_S}], {r['forward_ms']:.1f} ms; vs default_gmm relative "
          f"Frobenius err {rel:.3e} (tol {ZOO_TOL}); launches {launches} "
          f"(flash on wgmma at dh 192, super_gmm on wgmma at E=256); on the "
          f"path's own inputs vs plain: flash max abs err "
          f"{flash['max_abs_err']:.2e} (tol 4e-2), row rel err "
          f"{flash['row_rel_err']:.2e} (tol {ROW_REL_TOL[torch.bfloat16]}); "
          f"dispatch and combine torch.equal, combine "
          f"{moe['combine_ulps_vs_moe_combine']:.2f} bf16 ulp from "
          f"moe_combine (tol 1); super_gmm's FFN rel err "
          f"{moe['gmm_rel_err_vs_plain']:.3e} (tol {ZOO_GMM_TOL}); peak "
          f"allocated {r['peak_allocated_gb']:.1f} GB ({before_gb:.1f} GB "
          f"allocated before), reserved {r['peak_reserved_gb']:.1f} GB")
    del params, got
    _free()
    return r


def phase_zoo(seed: int, card: str) -> dict:
    """The model families behind build_api (the dense decoders, rwkv6,
    zamba2, seamless_m4t), then deepseek_v32 at depth 1; each model built,
    run and released before the next."""
    tf = zoo_teacher_forced(seed)
    models = [_zoo_model(arch, layers, steps, seed + i)
              for i, (arch, layers, steps) in enumerate(ZOO)]
    ds = _zoo_deepseek_v32(seed)
    launches = {n: sum(m["launches"][n] for m in models + [ds])
                for n in _pd_kernels()}
    return {"card": card, "teacher_forced": tf, "models": models,
            "deepseek_v32": ds, "launches": launches}


def _ratio(a: float, b: float) -> float:
    """a / b for a printed comparison; nan where b is 0."""
    return a / b if b else float("nan")


def _device_ms(fn, reps: int, match=None, tries: int = 3):
    """Device time per call by torch.profiler over `reps` calls: summed over
    every kernel, or over the kernels whose name contains `match`.  Returns
    (ms per call, [(name, ms per call, launches per call)] by device time).
    One warm-up step turns the device tracing on before the recorded calls,
    one cycle only (a second would clear the recorded one).  The profiler
    still loses events (up to 18 % of a kernel's, and once every one of a
    profile's), so a kernel's time per call is its mean per event seen
    times its launches per call, which is a whole number: every call
    launches the same kernels.  A profile that saw none of the kernels is
    taken again; after `tries` such, the time is CUDA events around `reps`
    calls and the rows are empty."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        # the device's own events (kernels, copies), not again the host ops
        # that launched them, nor the step's span the schedule draws over them
        rows = [(e.key, e.device_time_total / 1e3 / e.count * n, n)
                for e in prof.key_averages()
                if e.count
                for n in [max(1, round(e.count / reps))]
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("ProfilerStep")
                and (match is None or match in e.key)]
        if sum(r[1] for r in rows) > 0:
            rows.sort(key=lambda r: -r[1])
            return sum(r[1] for r in rows), rows
    print(f"[timing] the profiler saw no device time in {tries} profiles "
          f"of {reps} calls{f' (kernels {match!r})' if match else ''}: "
          f"CUDA events around the calls instead")
    return cuda_ms(fn, iters=reps, warmup=1), []


def _decode_breakdown(rt) -> dict:
    """Decode steps with all 8 slots active and no prefill on the card
    (after the counted wave): wall time per step against the device time
    the profiler sums over its kernels, and where that device time goes."""
    with torch.inference_mode():
        rt._active_dev.fill_(True)
    rt.step_once()
    walls = []
    for _ in range(20):  # each step ends in its token read: a host sync
        t0 = time.perf_counter()
        rt.step_once()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = float(np.median(walls))
    dev, rows = _device_ms(rt.step_once, 5)
    launches = sum(r[2] for r in rows) if rows else None
    print(f"[pd] decode step alone (8 slots active, no prefill): wall "
          f"{wall:.2f} ms per step (median of 20; min {min(walls):.2f}), "
          f"device time summed over its kernels and copies {dev:.2f} ms "
          f"({dev / wall:.0%} of the wall), {launches} of them per step")
    for name, ms, n in rows[:8]:
        print(f"[pd]   {ms:8.3f} ms {n:6.1f}x  {name[:80]}")
    return {"wall_ms": wall, "wall_min_ms": min(walls), "device_ms": dev,
            "launches": launches}


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


def _host_us(fn, reps: int = 200) -> float:
    """The host's time to issue one call, in us (perf_counter around `reps`
    calls issued back to back, the device drained after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return 1e6 * t


def _call_case(name, match, kern, nbytes, shape, plain=None, lib=None,
               lib_name=None, err=None) -> dict:
    """One timed wrapper call at the decode shape: `ms` as the host issues
    calls back to back (CUDA events), `device_ms` every kernel of one call
    and `kernel_device_ms` those whose name holds `match` (profiler),
    `host_us` the host's issue time; the bound from this run's bytes.
    Where the profiler saw nothing, both device times are the whole call's
    by CUDA events and the launches are not known."""
    call_dev, rows = _device_ms(kern, 50)
    return {"case": name, "ms": cuda_ms(kern, iters=200, warmup=10),
            "device_ms": call_dev,
            "kernel_device_ms": sum(r[1] for r in rows if match in r[0])
            if rows else call_dev,
            "launches_per_call": sum(r[2] for r in rows) if rows else None,
            "device_ms_by": "profiler" if rows else "cuda_events",
            "host_us": _host_us(kern),
            "plain_ms": None if plain is None
            else cuda_ms(plain, iters=20, warmup=2),
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
            "library_ms": None if lib is None
            else cuda_ms(lib, iters=200, warmup=10),
            "library_device_ms": None if lib is None else _device_ms(lib,
                                                                     50)[0],
            "library_call": lib_name, "max_abs_err": err, "shape": shape,
            "kernels": [[r[0][:60], r[1], r[2]] for r in rows]}


def _decode_inputs(gen, T: int):
    """The decode MoE layer's inputs at width T: a dropless routing of T
    tokens (top-8 of 128 experts, C = 8), x, expert outputs yb and router
    weights, bf16 payloads."""
    from repro_torch.models.moe import expert_capacity
    full = get_config(ARCH)
    E, K, d = full.num_experts, full.top_k, full.d_model
    C = expert_capacity(T, full)
    _, _, idx = _pairs(gen, T, E, K, C)
    x = torch.randn((T, d), generator=gen, device=DEV).bfloat16()
    yb = torch.randn((E, C, d), generator=gen, device=DEV).bfloat16()
    w = torch.rand((T, K), generator=gen, device=DEV)
    w = w / w.sum(-1, keepdim=True)
    return full, idx, x, yb, w, C


def time_moe_path(gen, T: int) -> dict:
    """kernel_moe_dispatch and kernel_moe_combine, each one whole call as
    the decode MoE layer makes it: device time over all its kernels, the
    launches of one call, host-issued ms and the host's us.  Only the ops
    API, so that it runs in any tree of the port (the --shapes-from
    turns)."""
    from repro_torch.kernels.dispatch_combine.ops import (kernel_moe_combine,
                                                          kernel_moe_dispatch)
    full, idx, x, yb, w, C = _decode_inputs(gen, T)
    _, info = kernel_moe_dispatch(x, idx, full, C)
    out = {}
    for name, fn in (("kernel_moe_dispatch",
                      lambda: kernel_moe_dispatch(x, idx, full, C)),
                     ("kernel_moe_combine",
                      lambda: kernel_moe_combine(yb, info, w, T))):
        dev, rows = _device_ms(fn, 50)
        out[name] = {"device_ms": dev,
                     "launches": sum(r[2] for r in rows) if rows else None,
                     "ms": cuda_ms(fn, iters=200, warmup=10),
                     "host_us": _host_us(fn),
                     "kernels": [[r[0][:60], r[1], r[2]] for r in rows]}
    return out


def _moe_rows(gen, pd: dict, errs: dict, extra_dispatch=()) -> list:
    """Rows 3-4 at the shape of every decode step of the pd wave (T slots
    x top-8 pairs, 128 experts, C = 8, d = 4096, bf16) on a dropless
    routing, two cases each.  "path": the route the decode MoE layer takes
    (kernel_moe_dispatch / kernel_moe_combine, whole calls; bound: xb
    written once, x and the index vectors read once / the kept rows, weights
    and slots read once, out written once; library: embedding_bag for the
    combine, none for the dispatch, whose yardstick is the parent's path in
    the --shapes-from turns).  "tpu_signature": dispatch_scatter /
    combine_gather as the TPU kernels' signatures call them (bound: 2N rows
    + the (E*C+1)-row zero fill / 2N rows; the scatter's yardstick does the
    zero fill its wrapper does).  `extra_dispatch`: more timed cases of the
    dispatch (the gmm phase's, at prefill-size N)."""
    from repro_torch.kernels.dispatch_combine.dispatch_combine import (
        combine_gather, dispatch_scatter)
    from repro_torch.kernels.dispatch_combine.ops import (kernel_moe_combine,
                                                          kernel_moe_dispatch)
    from repro_torch.kernels.dispatch_combine.ref import (combine_gather_ref,
                                                          combine_weighted_ref,
                                                          dispatch_scatter_ref,
                                                          dispatch_whole_ref)
    from repro_torch.models.moe import dispatch_slots
    T = pd["T"]
    full, idx, x, yb, w, C = _decode_inputs(gen, T)
    E, K, d = full.num_experts, full.top_k, full.d_model
    N, rows, el = T * K, E * C + 1, 2
    perm, slot64, _, _ = dispatch_slots(idx, E, C)
    kept = int((slot64 < E * C).sum())
    slot, tok64 = slot64.to(torch.int32), perm // K
    token_of = tok64.to(torch.int32)
    shape = {"T": T, "K": K, "N": N, "E": E, "C": C, "rows_out": rows,
             "d": d, "dtype": "bf16", "pairs_kept": kept}
    xb, info = kernel_moe_dispatch(x, idx, full, C)
    yb_flat = yb.reshape(E * C, d)
    yb_trash = torch.cat([yb_flat, yb_flat.new_zeros((1, d))])
    w_bf = w.bfloat16()
    ps2 = info["pair_slot"].reshape(T, K)
    dispatch = [
        _call_case(
            "path", "dispatch_whole",
            lambda: kernel_moe_dispatch(x, idx, full, C),
            el * d * (E * C + T) + 4 * N + 8 * (3 * N + E) + N,
            {**shape, "route": "whole"},
            plain=lambda: dispatch_whole_ref(x, idx, E, C),
            err=max_err(xb.reshape(E * C, d),
                        dispatch_whole_ref(x, idx, E, C)[0])),
        _call_case(
            "tpu_signature", "dispatch_scatter_kernel",
            lambda: dispatch_scatter(token_of, slot, x, rows_out=rows),
            el * d * (2 * kept + rows), {**shape, "route": "scatter"},
            plain=lambda: dispatch_scatter_ref(token_of, slot, x, rows),
            lib=lambda: torch.zeros((rows, d), dtype=x.dtype, device=DEV)
            .index_copy_(0, slot64, x.index_select(0, tok64)),
            lib_name="torch.zeros((E*C+1, d)).index_copy_(0, slot, "
                     "x.index_select(0, token_of))",
            err=errs["dispatch_scatter"])]
    combine = [
        _call_case(
            "path", "combine_weighted",
            lambda: kernel_moe_combine(yb, info, w, T),
            el * d * (kept + T) + 8 * N + 4 * N,
            {**shape, "route": "weighted"},
            plain=lambda: combine_weighted_ref(yb_flat, info["pair_slot"], w),
            lib=lambda: torch.nn.functional.embedding_bag(
                ps2, yb_flat, per_sample_weights=w_bf, mode="sum"),
            lib_name="embedding_bag(pair_slot [T, K], yb, "
                     "per_sample_weights=w, mode='sum')",
            err=max_err(kernel_moe_combine(yb, info, w, T),
                        combine_weighted_ref(yb_flat, info["pair_slot"], w))),
        _call_case(
            "tpu_signature", "combine_gather_kernel",
            lambda: combine_gather(slot, yb_trash), el * d * 2 * N,
            {**shape, "route": "gather"},
            plain=lambda: combine_gather_ref(slot, yb_trash),
            lib=lambda: torch.index_select(yb_trash, 0, slot64),
            lib_name="torch.index_select(yb, 0, slot)",
            err=errs["combine_gather"])]
    out = []
    for name, line, cases in (("dispatch_scatter", 46,
                               dispatch + list(extra_dispatch)),
                              ("combine_gather", 75, combine)):
        first = cases[0]
        # the first case with a library call: for the dispatch, whose path
        # has none, the TPU-signature case's zero fill + index_copy_
        lib = next(c for c in cases if c["library_ms"] is not None)
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/dispatch_combine.cu",
            "replaces": "src/repro/kernels/dispatch_combine/"
                        f"dispatch_combine.py:{line}",
            "launches": pd["launches"][name],
            "launches_by_route": pd["by_route"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{k: first[k] for k in ("ms", "device_ms", "kernel_device_ms",
                                     "host_us", "plain_ms", "bound_ms",
                                     "bound_by", "shape")},
            **{k: lib[k] for k in ("library_ms", "library_device_ms",
                                   "library_call")},
            "cases": cases})
    g, p = combine[0]["device_ms"], combine[1]["kernel_device_ms"]
    print(f"[timing] combine 'weighted' {1e3 * g:.2f} us device vs the "
          f"TPU-signature gather kernel {1e3 * p:.2f} us ({_ratio(g, p):.2f}x, "
          f"target <= 1.5x) and embedding_bag "
          f"{1e3 * combine[0]['library_device_ms']:.2f} us")
    d_path, d_sig = dispatch[0]["device_ms"], dispatch[1]["device_ms"]
    print(f"[timing] dispatch 'whole' {1e3 * d_path:.2f} us device over "
          f"{dispatch[0]['launches_per_call']} launches vs the "
          f"TPU-signature scatter + its zero fill {1e3 * d_sig:.2f} us; "
          f"{_ratio(dispatch[0]['bound_ms'], d_path):.0%} of the bound")
    return out


def wrapper_host_costs(gen, T: int):
    """The host's cost of each step of a dispatch_whole call at the decode
    shape, in us per call (perf_counter over many calls): the checks, the
    allocations, the stream handle (new and old way), the ctypes call
    refused before launching and launching, the launch count, the views;
    then the whole calls of both routes and of the ops above them."""
    from repro_torch.kernels.dispatch_combine import dispatch_combine as dc
    from repro_torch.kernels.dispatch_combine.ops import (kernel_moe_combine,
                                                          kernel_moe_dispatch)
    full, idx, x, yb, w, C = _decode_inputs(gen, T)
    E, K, d = full.num_experts, full.top_k, full.d_model
    N = T * K
    lib = _build.load()
    dev = x.device
    xb = torch.empty((E * C, d), dtype=x.dtype, device=DEV)
    meta = torch.empty(3 * N + E, dtype=torch.long, device=DEV)
    valid = torch.empty(N, dtype=torch.bool, device=DEV)
    stream = _launch.stream_ptr(dev)
    _, info = kernel_moe_dispatch(x, idx, full, C)

    def launch(elem):
        return lib.dispatch_whole_launch(
            idx.data_ptr(), x.data_ptr(), xb.data_ptr(), meta.data_ptr(),
            valid.data_ptr(), N, K, E, C, d, x.stride(0), elem, stream)

    expect(launch(3) == -1, "dispatch_whole_launch took an element size 3")
    steps = {
        "dispatch_whole's checks on CUDA tensors (_whole_args)":
            lambda: dc._whole_args(x, idx),
        "three torch.empty (xb, meta, valid)": lambda: (
            torch.empty((E * C, d), dtype=x.dtype, device=dev),
            torch.empty(3 * N + E, dtype=torch.long, device=dev),
            torch.empty(N, dtype=torch.bool, device=dev)),
        "torch.cuda.current_stream(dev).cuda_stream (before)":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_launch.stream_ptr(dev)": lambda: _launch.stream_ptr(dev),
        "_build.load()": _build.load,
        "ctypes dispatch_whole_launch, refused before launching":
            lambda: launch(3),
        "ctypes dispatch_whole_launch, launching": lambda: launch(2),
        "_launch.count_launch": lambda: _launch.count_launch(
            dc.dispatch_scatter, "whole"),
        "meta.split into four views": lambda: meta.split((N, N, N, E)),
        "dispatch_whole, whole call": lambda: dc.dispatch_whole(x, idx, E, C),
        "kernel_moe_dispatch, whole call":
            lambda: kernel_moe_dispatch(x, idx, full, C),
        "combine_weighted, whole call": lambda: dc.combine_weighted(
            yb.reshape(E * C, d), info["pair_slot"], w),
        "kernel_moe_combine, whole call":
            lambda: kernel_moe_combine(yb, info, w, T)}
    costs = {k: _host_us(f, reps=500) for k, f in steps.items()}
    for k, us in costs.items():
        print(f"[timing] host {us:8.2f} us  {k}")
    return costs


def decode_step_alone(seed: int, lengths) -> dict:
    """A DecodeExecutor of width len(lengths) over a 2112-token cache at
    full width (the serve phase's model), every slot active at the given
    lengths, no prefill: `_decode_breakdown`'s readings.  Only the API the
    port has had since its decode slice, so that it runs in any tree."""
    from repro_torch.core.decode import DecodeExecutor
    cfg, params = build_model(SERVE_LAYERS, seed)
    rt = DecodeExecutor(params, cfg, slots=len(lengths), max_len=2112)
    with torch.inference_mode():
        rt._lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    out = _decode_breakdown(rt)
    del rt, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def gemma3_step_profile(seed: int) -> dict:
    """gemma3_1b at published width and all 26 layers, bf16, AdamW, one
    repeated [1, GEMMA_S] batch (the train phase's run): two steps to warm
    up, a third timed (host wall around the synchronised step, CUDA events
    around it), a fourth under torch.profiler -- the device time summed over
    its kernels and copies, the flash forward's and backward's share (the
    kernels named flash, "flash_bwd" for the backward's), and the largest
    kernels.  Only the API the port has had since its training slice, so
    that it runs in any tree (the `--shapes-from` turns)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.launch.steps import TrainState, build_train_step
    from repro_torch.models.api import build_api
    from repro_torch.models.lm import init_lm_params
    from repro_torch.optim.adamw import AdamW
    cfg = get_config(GEMMA_ARCH)
    params = init_lm_params(torch.Generator(device=DEV).manual_seed(seed),
                            cfg, DEV)
    opt = AdamW(lr=3e-4)
    state = TrainState(params, opt.init(params))
    step_fn = build_train_step(build_api(cfg), opt)
    batch = pipeline_for(cfg, GEMMA_S, 1, seed, device=DEV).batch(0)
    for _ in range(2):
        state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    state, _ = step_fn(state, batch)
    e1.record()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.device_time_total > 0), key=lambda r: -r[1])
    dev = sum(r[1] for r in rows)
    bwd = sum(r[1] for r in rows if "flash_bwd" in r[0])
    fwd = sum(r[1] for r in rows if "flash" in r[0]) - bwd
    out = {"arch": cfg.name, "S": GEMMA_S, "step_wall_ms": wall,
           "step_event_ms": e0.elapsed_time(e1), "device_ms": dev,
           "device_share_of_wall": dev / wall if wall else None,
           "flash_fwd_device_ms": fwd, "flash_bwd_device_ms": bwd,
           "top": [[n[:70], ms, c] for n, ms, c in rows[:8]]}
    print(f"[timing] {cfg.name} train step [1, {GEMMA_S}]: wall {wall:.1f} "
          f"ms (events {out['step_event_ms']:.1f}), device time summed over "
          f"its kernels {dev:.1f} ms, flash forward {fwd:.2f} ms, flash "
          f"backward {bwd:.2f} ms (profiled step)")
    for n, ms, c in rows[:8]:
        print(f"[timing]   {ms:8.2f} ms {c:5d}x  {n[:80]}")
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def wave_shapes(serve: dict) -> dict:
    """What the timing phase times, from the serve wave: super_gmm at the
    modal capacity bucket (n_e, C) and, of the launches in it, the one with
    the median row total (its counts); flash_attention at the modal (B, S)
    and at the (B, S) with the largest share of launches * B * S^2."""
    (n_e, C), _ = collections.Counter(serve["buckets"]).most_common(1)[0]
    same = sorted((c for b, c in zip(serve["buckets"], serve["counts"])
                   if b == (n_e, C)), key=sum)
    seen = collections.Counter(tuple(s) for s in serve["shapes"])
    modal = seen.most_common(1)[0][0]
    heaviest = max(seen, key=lambda bs: seen[bs] * bs[0] * bs[1] ** 2)
    return {"super_gmm": {"n_e": n_e, "C": C,
                          "counts": [int(c) for c in same[len(same) // 2]]},
            "flash_attention": [list(modal)] + (
                [list(heaviest)] if heaviest != modal else [])}


def _case(name, match, kern, plain, lib, lib_name, nbytes, ops, dtype,
          shape):
    """One timed shape: the kernel, its plain version on the same inputs
    (also the max abs error between the two), one library call; the bound
    from this run's bytes and operations.  `ms` is a wrapper call as the host
    issues them back to back; `device_ms` the kernel alone (profiler, the
    kernels whose name holds `match`), `library_device_ms` every kernel of
    the library call; tflops are the real work over `device_ms`."""
    got = kern()
    want = plain()
    err = max_err(got, want)
    del got, want
    ms = cuda_ms(kern, iters=50, warmup=5)
    dev, rows = _device_ms(kern, 20, match=match)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return {"case": name, "ms": ms, "device_ms": dev,
            "plain_ms": cuda_ms(plain, iters=3, warmup=1),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cuda_ms(lib, iters=50, warmup=5),
            "library_device_ms": _device_ms(lib, 20)[0],
            "library_call": lib_name, "tflops": ops / dev / 1e9,
            "device_ms_by": "profiler" if rows else "cuda_events",
            "max_abs_err": err, "shape": shape}


def time_super_gmm(shapes: dict, gen) -> list:
    """gate/up (K = d_model, N = d_ff) and down (K = d_ff, N = d_model) at
    the wave's median launch (counts), then both dense (no counts).  What a
    launch's data needs: the rows that exist, the weights of the experts
    that have any, the whole output written once; the operations on the
    real rows."""
    full = get_config(ARCH)
    bf = torch.bfloat16
    n_e, C, cnt = shapes["n_e"], shapes["C"], shapes["counts"]
    lid = torch.tensor([1], dtype=torch.int32, device=DEV)
    cases = []
    for proj, (K, N) in (("gate_up", (full.d_model, full.expert_d_ff)),
                         ("down", (full.expert_d_ff, full.d_model))):
        w, x = _gmm_inputs(gen, SERVE_LAYERS, n_e, C, K, N, bf)
        counts = torch.tensor(cnt, dtype=torch.int32, device=DEV)
        x = x * (torch.arange(C, device=DEV)[None, :, None]
                 < counts[:, None, None])  # as pack_capacity leaves it
        for c in (counts, None):
            real = n_e * C if c is None else sum(min(v, C) for v in cnt)
            used = n_e if c is None else sum(1 for v in cnt if v > 0)
            cases.append(_case(
                f"{proj}_{'dense' if c is None else 'counts'}", "super_gmm",
                lambda c=c: super_gmm(lid, w, x, c),
                lambda c=c: super_gmm_ref(lid, w, x, c),
                lambda: torch.bmm(x, w[1]), "torch.bmm(x, w[layer]) (dense)",
                2 * (used * K * N + real * K) + 4 * n_e * C * N,
                2.0 * real * K * N, bf,
                {"n_e": n_e, "C": C, "K": K, "N": N, "dtype": "bf16",
                 "real_rows": real, "experts_with_rows": used,
                 "counts": None if c is None else cnt}))
        del w, x
    return cases


def time_super_gmm_tiles(shapes: dict, gen) -> dict:
    """super_gmm's device ms per tile (profiler) at the serve wave's median
    launch: gate/up and down, with its counts and dense -- the shapes
    time_super_gmm times at the default tile."""
    full = get_config(ARCH)
    n_e, C, cnt = shapes["n_e"], shapes["C"], shapes["counts"]
    lid = torch.tensor([1], dtype=torch.int32, device=DEV)
    out = {}
    for proj, (K, N) in (("gate_up", (full.d_model, full.expert_d_ff)),
                         ("down", (full.expert_d_ff, full.d_model))):
        w, x = _gmm_inputs(gen, SERVE_LAYERS, n_e, C, K, N, torch.bfloat16)
        counts = torch.tensor(cnt, dtype=torch.int32, device=DEV)
        for c in (counts, None):
            case = f"{proj}_{'dense' if c is None else 'counts'}"
            out[case] = {tile_name(t): _device_ms(
                lambda c=c, t=t: super_gmm(lid, w, x, c, tile=t), 20,
                match="super_gmm")[0] for t in TILES}
            print(f"[timing] super_gmm {case} n_e={n_e} C={C} K={K} N={N} "
                  f"device ms by tile: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in out[case].items()))
        del w, x
    return out


# flash_attention at the zoo's head dims and gemma3_1b's train shapes, timed
# beside the serve wave's shapes: (case, config whose heads it takes, B, S,
# window); causal
ZOO_FLASH = (("dh192", "deepseek_v32", 1, ZOO_S, None),
             ("dh256", "gemma3_1b", 2, ZOO_S, None),
             ("dh64_zamba", "zamba2_1p2b", 2, ZOO_S, None),
             ("dh64_seamless", "seamless_m4t_large_v2", 2, ZOO_S, None),
             ("dh256_train_local", "gemma3_1b", 1, GEMMA_S, 512),
             ("dh256_train_global", "gemma3_1b", 1, GEMMA_S, None))


def time_flash_attention(shapes: list, gen) -> list:
    """The serve wave's (B, S) at qwen3's heads ("modal", "heaviest"), then
    the zoo's head dims 192, 256 and 64 (zamba2's shared attention,
    seamless's decoder) and gemma3_1b's train step's local (window 512) and
    global layers at [1, 4096] (ZOO_FLASH) -- each causal, in bf16, each
    with the route it took.  The bound counts the visible pairs; the
    library call is SDPA on expanded heads (a boolean mask for a
    window)."""
    bf = torch.bfloat16
    specs = [("modal" if i == 0 else "heaviest", B, S, None, get_config(ARCH))
             for i, (B, S) in enumerate(shapes)]
    specs += [(name, B, S, window, get_config(arch))
              for name, arch, B, S, window in ZOO_FLASH]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    for name, B, S, window, c in specs:
        H, KVH, dh = c.num_heads, c.num_kv_heads, c.head_dim
        q = torch.randn((B, S, H, dh), generator=gen, device=DEV).to(bf)
        k = torch.randn((B, S, KVH, dh), generator=gen, device=DEV).to(bf)
        v = torch.randn((B, S, KVH, dh), generator=gen, device=DEV).to(bf)
        qh, kh, vh = (_expand_kv(t, H).permute(0, 2, 1, 3).contiguous()
                      for t in (q, k, v))
        mask = None
        if window is not None:
            pos = torch.arange(S, device=DEV)
            mask = (pos[None, :] <= pos[:, None]) & (
                pos[None, :] > pos[:, None] - window)
        pairs = S * S / 2 if window is None else _attn_pairs(S, window)
        before = _routes(flash_attention)
        mha_flash(q, k, v, window=window)
        took = [r for r, n in _routes(flash_attention).items()
                if n != before.get(r, 0)]
        cases.append(_case(
            name, "flash",
            lambda: mha_flash(q, k, v, window=window),
            lambda: _mha_plain(q, k, v, window),
            lambda: sdpa(qh, kh, vh, is_causal=True) if mask is None
            else sdpa(qh, kh, vh, attn_mask=mask),
            "scaled_dot_product_attention (expanded heads"
            + (", boolean window mask)" if mask is not None else ")"),
            2 * (2 * B * S * H * dh + 2 * B * S * KVH * dh),
            4.0 * B * H * pairs * dh, bf,
            {"B": B, "S": S, "H": H, "KVH": KVH, "dh": dh, "dtype": "bf16",
             "causal": True, "window": window}))
        cases[-1]["route"] = took[0] if len(took) == 1 else took
        del q, k, v, qh, kh, vh, mask
    return cases


def _row(name, line, cases, serve, errs):
    """A kernel's row of the {"kernels": ...} line: the first case's
    numbers, the serve wave's launches, and every case timed."""
    first = cases[0]
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}/{name}.py:{line}",
            "launches": serve["launches"][name],
            "launches_by_route": serve["by_route"][name],
            "max_abs_err": errs[name],
            **{k: first[k] for k in ("ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "library_device_ms", "tflops",
                                     "shape")},
            "cases": cases}


def shapes_from(kernels_line: dict) -> dict:
    """The shapes a full run's {"kernels": ...} line timed, as wave_shapes
    gives them."""
    rows = {r["name"]: r for r in kernels_line["kernels"]}
    g = rows["super_gmm"]["cases"][0]["shape"]
    return {"super_gmm": {k: g[k] for k in ("n_e", "C", "counts")},
            "flash_attention": [[c["shape"]["B"], c["shape"]["S"]]
                                for c in rows["flash_attention"]["cases"]
                                if c["case"] in ("modal", "heaviest")],
            "decode_T": rows["dispatch_scatter"]["shape"]["T"],
            "flash_attention_bwd": [
                c["shape"] for c in rows["flash_attention_bwd"]["cases"]]
            if "flash_attention_bwd" in rows else []}


def time_flash_bwd_alone(shapes: list, gen) -> list:
    """flash_attention_bwd of the repro_torch beside this script at each
    shape (made here from `gen`, its forward's o and lse first): ms (CUDA
    events) and device ms (the kernels named flash_bwd) -- the parent-vs-
    change turns of `--shapes-from`."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_launch)
    out = []
    for sh in shapes:
        # an older tree names the backward's own head dims
        if sh["dh"] not in getattr(fa, "BWD_HEAD_DIMS", fa.HEAD_DIMS):
            out.append({"shape": sh, "ms": None, "device_ms": None,
                        "note": f"no backward at head dim {sh['dh']} here"})
            continue
        dt = getattr(torch, sh["dtype"])
        q, k, v, do = _flash_inputs(gen, dt, sh["B"], sh["S"], sh["H"],
                                    sh["KVH"], sh["dh"], "model")
        kw = dict(causal=sh["causal"], window=sh["window"], softcap=None)
        o, lse = flash_launch(q, k, v, with_lse=True, **kw)

        def call():
            return flash_attention_bwd(q, k, v, o, lse, do, **kw)

        dev, rows = _device_ms(call, 10, match="flash_bwd")
        out.append({"shape": sh, "ms": cuda_ms(call, iters=20, warmup=3),
                    "device_ms": dev,
                    "device_ms_by_kernel": {n: t for n, t, _ in rows}})
        print(f"[timing] flash_attention_bwd {sh}: {out[-1]['ms']:.3f} ms "
              f"(device {dev:.3f})")
        del q, k, v, do, o, lse
    return out


def phase_timing(serve: dict, pd: dict, errs: dict, gen,
                 batching=None, gmm=None, faults=None,
                 rebalance=None, zoo=None, tuned=None,
                 examples=None, train=None, analysis=None,
                 spmd=None, tp=None) -> dict:
    """Each kernel at the shapes its path launched it with: super_gmm and
    flash_attention from the serve phase, dispatch_scatter and
    combine_gather from the pd phase (and the dispatch at the gmm phase's
    prefill N).  `launches_by_path`: each path's launches, read just after
    it ran with the counts set to 0 just before."""
    shapes = wave_shapes(serve)
    wrapper_host_costs(gen, pd["T"])
    rows = [
        _row("super_gmm", 68, time_super_gmm(shapes["super_gmm"], gen),
             serve, errs),
        _row("flash_attention", 97,
             time_flash_attention(shapes["flash_attention"], gen), serve,
             errs)] + _moe_rows(gen, pd, errs,
                                gmm["dispatch_cases"] if gmm else ())
    if train:
        rows += [_bwd_row(name, line, train)
                 for name, line in (("flash_attention_bwd", 97),
                                    ("combine_weighted_bwd", 75))]
    by_path = {"serve": serve["launches"], "pd": pd["launches"]}
    if batching:
        by_path["batching"] = batching["bitwise"]["batched"]["launches"]
    if gmm:
        by_path["gmm"] = gmm["launches"]
    if analysis:
        by_path["analysis"] = analysis["launches"]
    if faults:
        by_path["faults"] = faults["launches"]
    if rebalance:
        by_path["rebalance"] = rebalance["launches"]
    if zoo:
        by_path["zoo"] = zoo["launches"]
    if tuned:
        by_path["tuning"] = tuned["tuned_wave"]["tuned"]["launches"]
    if examples:
        for name, rec in examples.items():
            if rec["launches"] is not None:
                by_path[name] = {k: v["launches"]
                                 for k, v in rec["launches"].items()}
    if train:
        by_path["train"] = train["full_width"]["launches"]
        by_path["train_gemma3"] = train["gemma3"]["launches"]
    if spmd:
        by_path["spmd"] = spmd["launches"]
    if tp:
        by_path["tp"] = tp["launches"]
    rows[0]["launches_by_tile"] = serve["by_tile"]
    rows[0]["device_ms_by_tile"] = time_super_gmm_tiles(
        shapes["super_gmm"], gen)
    for row in rows:  # the paths that read this kernel's count
        row["launches_by_path"] = {p: n[row["name"]]
                                   for p, n in by_path.items()
                                   if row["name"] in n}
    return {"kernels": rows}


def _bwd_row(name, line, train) -> dict:
    """A backward kernel's row: the full-width train step's launches (its
    main path) and the times at that step's inputs.  It is the gradient of
    the TPU kernel `replaces` names, which has no backward of its own."""
    t = train["timing"][name]
    src = "flash_attention" if name.startswith("flash") else \
        "dispatch_combine"
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/{src}/{src}.py:{line}",
            "gradient_of": "flash_attention" if src == "flash_attention"
            else "combine_gather",
            "launches": train["full_width"]["launches"][name]
            + train["gemma3"]["launches"].get(name, 0),
            **{k: t[k] for k in ("max_abs_err", "ms", "device_ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "library_call", "shape")},
            "cases": t.get("cases", [t]),
            **({"launches_by_route": _bwd_routes(train)}
               if name.startswith("flash") else {})}


def _bwd_routes(train) -> dict:
    """flash_attention_bwd's launches by route over both full-width steps'
    runs."""
    total = collections.Counter()
    for run in (train["full_width"], train["gemma3"]):
        for step in run["steps"]:
            total.update(step["flash_bwd_by_route"])
    return dict(total)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="device,build,kernels,executor,"
                    "serve,pd,analysis,batching,gmm,faults,rebalance,tuning,"
                    "examples,train,spmd,tp,zoo,timing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="profile phase: also write the chrome trace here")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print ptxas's registers, shared memory and spills "
                    "of every kernel")
    ap.add_argument("--shapes-from", default=None, metavar="PATH",
                    help="a file holding the {\"kernels\": ...} line of a "
                    "full run: time super_gmm and flash_attention alone at "
                    "its shapes, the decode MoE layer's dispatch and "
                    "combine calls, a decode step alone and a profiled "
                    "gemma3_1b train step (--phases device,build,timing)")
    ap.add_argument("--tp-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device -- this script measures on the "
              "card and does not fall back to the CPU", file=sys.stderr)
        return 1
    phases = args.phases.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.tp_child is not None:  # a process of the tp phase
        if args.tp_child == "plain":
            _tp_plain(args.seed, args.tp_dir)
        else:
            _tp_rank(int(args.tp_child), args.seed, args.tp_dir)
        return 0
    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    card = phase_device()
    if "build" in phases:
        phase_build(args.verbose_build)
    if args.shapes_from:
        expect(phases == ["device", "build", "timing"],
               "--shapes-from times the kernels alone: --phases "
               "device,build,timing")
        with open(args.shapes_from) as f:
            shapes = shapes_from(json.loads(f.read()))
        T = shapes["decode_T"]
        # the serve phase's prompt lengths, as decode contexts
        lengths = np.random.default_rng(args.seed).integers(256, 2049,
                                                            size=T)
        print(json.dumps({"timing": {
            "src": os.path.dirname(os.path.abspath(__file__)),
            "super_gmm": time_super_gmm(shapes["super_gmm"], gen),
            "flash_attention": time_flash_attention(
                shapes["flash_attention"], gen),
            "flash_attention_bwd": time_flash_bwd_alone(
                shapes["flash_attention_bwd"], gen),
            "moe_path": time_moe_path(gen, T),
            "decode_step": decode_step_alone(args.seed,
                                             [int(v) for v in lengths]),
            "gemma3_step": gemma3_step_profile(args.seed)}}))
        print(card)
        return 0
    errs = phase_kernels(gen) if "kernels" in phases else None
    serve = pd = batching = gmm = faults = rebalance = zoo = None
    tuned = examples = train = analysis = spmd = tp = None
    if "analysis" in phases:
        analysis = phase_analysis_static()
    if {"executor", "serve", "batching", "gmm", "faults",
            "rebalance", "tuning", "analysis"} & set(phases):
        cfg, params = build_model(SERVE_LAYERS, args.seed)
        if "executor" in phases:
            phase_executor(cfg, params)
            _free()  # the executors' resident stacks go before serving
        if "serve" in phases:
            serve = phase_serve(cfg, params, args.seed)
        if "profile" in phases:
            expect(serve is not None, "profile needs the serve phase")
            phase_profile(cfg, params, serve, args.trace_out)
        if "pd" in phases:
            expect(serve is not None, "pd needs the serve phase")
            pd = phase_pd(cfg, params, serve, args.seed)
        if serve is not None:
            # the long-lived executor and its streams' pools go: memory is
            # near the card's limit
            serve["kw"].pop("executor")
            _free()
        if "analysis" in phases:
            analysis.update(phase_analysis_wave(cfg, params, args.seed,
                                                serve))
            print(json.dumps({"analysis": analysis}))
        if "batching" in phases:
            batching = phase_batching(cfg, params, args.seed)
            print(json.dumps({"batching": batching}))
        if "gmm" in phases:
            gmm = phase_gmm(cfg, params, args.seed, gen)
        if "faults" in phases:
            faults = phase_faults(cfg, params, args.seed, serve)
            print(json.dumps({"faults": faults}))
        if "rebalance" in phases:
            rebalance = phase_rebalance(cfg, params, args.seed)
            print(json.dumps({"rebalance": rebalance}))
        if "tuning" in phases:
            tuned = phase_tuning(cfg, params, args.seed, gen, serve)
            print(json.dumps({"tuning": tuned}))
        del params
        _free()
    if "examples" in phases:  # each twin in its own process
        examples = phase_examples(args.seed)
        print(json.dumps({"examples": examples}))
    if "train" in phases:  # after the serving model is released
        train = phase_train(args.seed, gen)
        print(json.dumps({"train": train}))
    if "spmd" in phases:  # one NCCL rank; freed before the zoo
        spmd = phase_spmd(args.seed, card)
        print(json.dumps({"spmd": spmd}))
    if "tp" in phases:  # two ranks on the card, each a process of its own
        tp = phase_tp(args.seed, card)
        print(json.dumps({"tp": tp}))
    if "zoo" in phases:  # after the qwen3 model is released
        zoo = phase_zoo(args.seed, card)
        print(json.dumps({"zoo": zoo}))
    if "timing" in phases:
        expect(serve is not None and pd is not None and errs is not None,
               "timing needs the kernels, serve and pd phases")
        print(json.dumps(phase_timing(serve, pd, errs, gen, batching, gmm,
                                      faults, rebalance, zoo, tuned,
                                      examples, train, analysis, spmd,
                                      tp)))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
