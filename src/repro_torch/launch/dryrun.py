"""Multi-pod dry-run of the port: build every (architecture x shape x mesh)
cell on the production mesh (16x16 single-pod, 2x16x16 multi-pod) and read
the roofline terms off the step of rank 0 -- the counterpart of the
reference's `repro.launch.dryrun`, same CLI and same record keys.

There is no compiler to ask: the process joins a fake process group of 256
or 512 ranks (`torch.testing._internal.distributed.fake_pg`: every
collective completes at once, this process is rank 0), the state, batch
and caches are fake tensors (`FakeTensorMode`: shapes, no data), and
`launch.op_analysis` records every op the step dispatches -- the port's
own program.  On fake
CPU tensors the kernels' wrappers take their plain versions, as the
reference's host-mesh lowering takes its jnp path.  The fake group is
process-global: run this module as its own process (the tests do).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3_1b \\
      --shape train_4k [--single-pod | --multi-pod] [--out results.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out F]

The record's keys are the reference's; what the port fills them with:
  lower_s / compile_s    seconds to build the fake state and batch / to run
                         the step under the analysis
  xla_cost_flops         `torch.utils.flop_counter`'s count of the same run
                         (the library's figure beside op_analysis's)
  xla_bytes_accessed     None: torch has no counterpart
  mem                    argument_mb: rank 0's local shards of state, batch
                         and caches; alias_mb: the part the step consumes
                         in place (the train state, decode's caches);
                         output_mb: the step's results; temp_mb: the peak
                         live bytes of what the step allocated;
                         peak_hbm_gb = argument + temp (new results are
                         inside temp, aliased ones are arguments)
The roofline constants are one H100 SXM's, from its data sheet
(`core.cost_model.H100`): dense bf16 peak, HBM rate, NVLink 4 one way.
The train cells lower `build_sharded_train_step`, the prefill cells
`build_sharded_prefill_step` and the decode cells
`build_sharded_decode_step`: every family computes over "model" (attention
heads, RWKV and Mamba heads and channels, FFN columns, experts, vocab) and
gathers each layer over the batch axes inside the layer.  The params are
stored under their param specs and the decode caches under `cache_specs`
(a KV cache split over heads, or over the sequence where the kv heads are
fewer than "model" or the batch does not shard: flash-decoding split-K; a
recurrent state over its heads, a conv ring over its channels);
argument_mb counts those shards.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import SHAPES, cell_supported, cells, get_config
from repro_torch.core.cost_model import H100
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.launch.steps import (TrainState,
                                      build_sharded_decode_step,
                                      build_sharded_prefill_step,
                                      build_sharded_train_step, state_specs)
from repro_torch.models.api import build_api
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import leaves, leaves_with_paths

# One H100 SXM, data-sheet peaks (core/cost_model.py H100)
PEAK_FLOPS = H100.peak_flops
HBM_BW = H100.hbm_bw
LINK_BW = H100.ici_bw

FAKE_PG = "torch.testing._internal.distributed.fake_pg"


def fake_world(world: int) -> str:
    """Make this process rank 0 of a fake process group of `world` ranks
    (replacing any group it had).  Returns the fake group's module."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return FAKE_PG


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def estimate_params(cfg: ModelConfig) -> tuple:
    """(total, active) parameter counts from a fake init."""
    api = build_api(cfg)
    with _fake_mode():
        tree = api.init(torch.Generator())
    total = active = 0
    for path, leaf in leaves_with_paths(tree):
        names = "/".join(SH._path_names(path))
        size = leaf.numel()
        total += size
        if "experts" in names and cfg.num_experts:
            size = size * cfg.top_k // cfg.num_experts
        active += size
    return total, active


def _apply_opts(cfg: ModelConfig, opts: dict, mesh) -> ModelConfig:
    """Perf knobs: config flags + the pshard logical-axis rules they need."""
    from repro_torch.models import pshard
    pshard.clear_rules()
    if not opts:
        return cfg
    cfg = cfg.replace(**opts)
    rules = {}
    if cfg.attn_dp_constraint:
        rules["batch"] = batch_axes(mesh)
    if cfg.moe_shard_constraints:
        rules.update(moe_group="data", experts="model", moe_rows="data",
                     moe_tokens=("data",))
    if rules:
        pshard.set_rules(**rules)
    return cfg


def _nbytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in leaves(tree))


def build_cell(arch: str, shape_name: str, mesh, opts: Optional[dict] = None,
               smoke: bool = False):
    """(cfg, fn, args, meta): `fn(*args)` is rank 0's step on fake tensors.
    `smoke`: the architecture's reduced config (the tests' size)."""
    opts = dict(opts or {})
    accum = int(opts.pop("accum_steps", 1))  # launcher knob, not a cfg field
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    if cfg.num_experts:
        tokens = (B // accum) * S if shape.kind == "train" else B
        cfg = cfg.replace(dispatch_groups=SH.dispatch_groups_for(mesh,
                                                                 tokens))
    cfg = _apply_opts(cfg, opts, mesh)
    return (cfg,) + build_step(cfg, shape.kind, B, S, mesh, accum)


def build_step(cfg: ModelConfig, kind: str, B: int, S: int, mesh,
               accum: int = 1):
    """(fn, args, meta) of a [B, S] step of `kind` on `mesh`, its state,
    batch and caches made and placed here (under the caller's
    FakeTensorMode, fake)."""
    api = build_api(cfg)
    gen = torch.Generator()
    params = api.init(gen)
    pspecs = SH.param_specs(params, cfg, mesh)
    batch = api.make_batch(gen, S, B, kind, device="cpu")
    batch = SH.distribute_tree(batch, mesh, SH.batch_specs(batch, mesh))
    if kind == "train":
        opt = AdamW()
        state = SH.distribute_tree(TrainState(params, opt.init(params)),
                                   mesh, state_specs(pspecs))
        fn = build_sharded_train_step(api, opt, mesh, pspecs,
                                      accum_steps=accum)
        args, alias, toks = (state, batch), state, B * S
    elif kind == "prefill":
        params = SH.distribute_tree(params, mesh, pspecs)
        fn = build_sharded_prefill_step(api, mesh, pspecs)
        args, alias, toks = (params, batch), None, B * S
    else:  # decode
        params = SH.distribute_tree(params, mesh, pspecs)
        caches = api.make_caches(B, S, S - 1, device="cpu")
        cspecs = SH.cache_specs(caches, cfg, B, mesh)
        caches = SH.distribute_tree(caches, mesh, cspecs)
        fn = build_sharded_decode_step(api, mesh, pspecs, cspecs)
        args, alias, toks = (params, caches, batch), caches, B
    meta = dict(tokens=toks, kind=kind, argument_bytes=_nbytes(args),
                alias_bytes=_nbytes(alias) if alias is not None else 0)
    return fn, args, meta


def measure_cell(arch: str, shape_name: str, multi_pod: bool,
                 opts: Optional[dict] = None, smoke: bool = False,
                 breakdown: bool = False, top_k: int = 20):
    """(record, HLOCosts or None) of one cell, on a fresh fake group."""
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.time()
    chips = 512 if multi_pod else 256
    rec = dict(arch=arch, shape=shape_name,
               mesh="2x16x16" if multi_pod else "16x16", chips=chips,
               opts=opts or {})
    ok, why = cell_supported(arch, shape_name)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec, None
    hc = None
    try:
        rec["fake_pg"] = fake_world(chips)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        with _fake_mode():
            cfg, fn, args, meta = build_cell(arch, shape_name, mesh, opts,
                                             smoke)
            t_lower = time.time() - t0
            fc = FlopCounterMode(display=False)
            with fc, OpAnalysis(breakdown=breakdown, top_k=top_k) as oa:
                out = fn(*args)
            hc = oa.costs()
            t_compile = time.time() - t0 - t_lower
            out_bytes = _nbytes(out)
        flops = hc.dot_flops
        compute_s = flops / PEAK_FLOPS
        memory_s = hc.memory_bytes / HBM_BW
        collective_s = hc.collective_bytes / LINK_BW
        total, active = estimate_params(cfg)
        mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[meta["kind"]]
        mflops = mult * active * meta["tokens"] / chips
        arg_b, alias_b = meta["argument_bytes"], meta["alias_bytes"]
        rec.update(
            status="ok",
            kind=meta["kind"],
            lower_s=round(t_lower, 2), compile_s=round(t_compile, 2),
            flops_per_device=flops, bytes_per_device=hc.memory_bytes,
            collective_bytes_per_device=hc.collective_bytes,
            collective_by_op=hc.collective_by_op,
            collective_counts=hc.collective_counts,
            xla_cost_flops=float(fc.get_total_flops()),
            xla_bytes_accessed=None,
            compute_s=compute_s, memory_s=memory_s,
            collective_s=collective_s,
            dominant=max([("compute", compute_s), ("memory", memory_s),
                          ("collective", collective_s)],
                         key=lambda kv: kv[1])[0],
            model_flops_per_device=mflops,
            useful_flops_ratio=(mflops / flops) if flops else None,
            params_total=total, params_active=active,
            mem=dict(argument_mb=arg_b / 1e6,
                     output_mb=out_bytes / 1e6,
                     temp_mb=hc.peak_live_bytes / 1e6,
                     alias_mb=alias_b / 1e6,
                     peak_hbm_gb=(arg_b + hc.peak_live_bytes) / 1e9),
        )
    except Exception as e:  # record failures -- they are bugs to fix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    finally:
        from repro_torch.models import pshard
        pshard.clear_rules()
    rec["wall_s"] = round(time.time() - t0, 1)
    return rec, hc


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opts: Optional[dict] = None, smoke: bool = False) -> dict:
    return measure_cell(arch, shape_name, multi_pod, opts, smoke)[0]


def parse_opts(text: str) -> dict:
    """"a,b=1,c=true" -> {"a": True, "b": 1, "c": True}."""
    opts = {}
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" in item:
            k, v = item.split("=", 1)
            if v.lower() in ("true", "false"):
                opts[k] = v.lower() == "true"
            else:
                try:
                    opts[k] = int(v)
                except ValueError:
                    opts[k] = v
        else:
            opts[item] = True
    return opts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-extra", action="store_true",
                    help="also run the paper's deepseek_v32 config")
    ap.add_argument("--opts", default="",
                    help="comma list of perf knobs, e.g. "
                         "attn_dp_constraint,inner_remat,moe_shard_constraints"
                         ",gqa_grouped or key=value (remat_policy=...)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    opts = parse_opts(args.opts)

    if args.all:
        todo = [(a, s, mp) for (a, s) in cells(include_extra=args.include_extra)
                for mp in (False, True)]
    else:
        meshes = [True] if args.multi_pod else ([False] if args.single_pod
                                                else [False, True])
        todo = [(args.arch, args.shape, mp) for mp in meshes]

    for arch, shape, mp in todo:
        rec = run_cell(arch, shape, mp, opts=opts)
        line = json.dumps(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        brief = {k: rec.get(k) for k in
                 ("arch", "shape", "mesh", "status", "dominant", "compile_s",
                  "wall_s")}
        if rec.get("status") == "ok":
            brief["peak_hbm_gb"] = round(rec["mem"]["peak_hbm_gb"], 2)
        else:
            brief["error"] = rec.get("error", rec.get("reason"))
        print(json.dumps(brief), flush=True)


if __name__ == "__main__":
    main()
