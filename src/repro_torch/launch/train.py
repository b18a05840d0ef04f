"""Training launcher -- the twin of `repro.launch.train`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_moe_235b_a22b \
      --smoke --steps 20 --batch 8 --seq 128 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 ...

The reference's flags, plus `--device` (the card by default; `cpu` runs
the kernels' plain versions), `--mesh DATAxMODEL` and `--init-method`.
With `--mesh` the process joins a process group (NCCL on the card, gloo on
`--device cpu`; `env://` as torchrun sets it, or `--init-method
file:///path` with RANK and WORLD_SIZE in the environment), builds the
reference's (data, model) mesh over its ranks, shards the state by
`param_specs` and runs `build_sharded_train_step`; a MoE config's dispatch
groups are set by `dispatch_groups_for`, as the reference's dry-run sets
them (one rank must hold whole groups).  Without a process group it keeps
the one-device path: one H100 is the reference's 1-device mesh, on which
every partition spec places the whole tree on the one device.  The loop is
`ResilientTrainer` when `--ckpt-dir` is given.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import pipeline_for
from repro_torch.launch import sharding as SH
from repro_torch.launch.steps import (TrainState, build_sharded_train_step,
                                      build_train_step, state_specs)
from repro_torch.models.api import build_api
from repro_torch.models.common import param_count
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.fault_tolerance import ResilientTrainer


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_moe_235b_a22b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions (use with --smoke)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="train over a (data, model) mesh of this shape "
                         "(one process per rank)")
    ap.add_argument("--init-method", default="env://",
                    help="process-group rendezvous with --mesh")
    return ap


def _join_mesh(args, dev: torch.device):
    """(mesh, device of this rank) for `--mesh DATAxMODEL`."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    data, model = (int(x) for x in args.mesh.lower().split("x"))
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if world != data * model:
        raise SystemExit(f"--mesh {args.mesh} needs {data * model} ranks, "
                         f"got WORLD_SIZE={world}")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=args.init_method, rank=rank,
                            world_size=world)
    return make_host_mesh(data, model, device_type=dev.type), dev


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = torch.device(args.device)
    mesh = None
    if args.mesh:
        mesh, dev = _join_mesh(args, dev)
        if cfg.num_experts:
            cfg = cfg.replace(dispatch_groups=SH.dispatch_groups_for(
                mesh, args.batch * args.seq))
        print(f"arch={cfg.name} device={dev} "
              f"mesh={SH.mesh_shape(mesh)}")
    else:
        print(f"arch={cfg.name} device={dev} (one device: no mesh)")
    api = build_api(cfg)

    opt = AdamW(lr=args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = api.init(gen)
    print(f"params: {param_count(params) / 1e6:.2f}M")
    state = TrainState(params, opt.init(params))
    if mesh is None:
        step_fn = build_train_step(api, opt)
    else:
        pspecs = SH.param_specs(params, cfg, mesh)
        state = SH.distribute_tree(state, mesh, state_specs(pspecs))
        step_fn = build_sharded_train_step(api, opt, mesh, pspecs)
    pipe = pipeline_for(cfg, args.seq, args.batch, args.seed, device=dev)

    class _Pipe:  # the model's own inputs where it takes no token stream
        def batch(self, step):
            if cfg.family == "encdec" or cfg.frontend == "audio":
                g = torch.Generator(device=dev).manual_seed(step)
                return api.make_batch(g, args.seq, args.batch, "train",
                                      device=dev)
            return pipe.batch(step)

    def on_step(step, metrics):
        if step % 5 == 0 or step == 1:
            loss = float(metrics["loss"])
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({time.strftime('%H:%M:%S')})", flush=True)

    metrics = {}
    if args.ckpt_dir:
        trainer = ResilientTrainer(step_fn, _Pipe(),
                                   CheckpointManager(args.ckpt_dir),
                                   ckpt_every=args.ckpt_every)
        state, step, metrics = trainer.run(
            state, args.steps, inject_failure_at=args.inject_failure_at,
            on_step=on_step)
    else:
        for step in range(args.steps):
            state, metrics = step_fn(state, _Pipe().batch(step))
            on_step(step + 1, metrics)
    print("final loss:", float(metrics["loss"]))
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
