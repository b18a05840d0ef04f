"""Train a reduced MoE model with atomic checkpointing and failure recovery
on the PyTorch/CUDA port (the twin of examples/train_moe.py on repro_torch).

  PYTHONPATH=src python examples/torch_train_moe.py [--steps 300]        # card
  PYTHONPATH=src python examples/torch_train_moe.py --device cpu         # CPU

The reference's reduced config, optimizer (AdamW, lr 1e-3, 20 warmup
steps), data (`pipeline_for`, seq 64, batch 8) and one injected failure at
half the steps, recovered by `ResilientTrainer`.  Params come from the
port's own init under --seed.  On the card the gradients run through the
flash attention and dispatch/combine kernels' backward; on the CPU their
plain versions.  Checkpoints go to a fresh temporary directory unless
--ckpt-dir names one.
"""
import argparse
import json
import shutil
import sys
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import pipeline_for
from repro_torch.kernels import launch_counts
from repro_torch.launch.steps import TrainState, build_train_step
from repro_torch.models.api import build_api
from repro_torch.models.common import param_count
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.fault_tolerance import ResilientTrainer


def model_config():
    """The reference example's reduction of the assigned architecture."""
    return get_config("qwen3-moe-235b-a22b").smoke().replace(
        num_layers=2, num_experts=4, top_k=2, d_model=64, d_ff=128,
        moe_d_ff=64, vocab_size=256)


def optimizer() -> AdamW:
    return AdamW(lr=1e-3, warmup_steps=20)


def train(cfg, params, steps: int, ckpt_dir: str, device,
          verbose: bool = True) -> dict:
    """The reference example's loop on given params: `steps` steps, one
    failure injected at steps // 2, checkpoints every 50 steps.  Returns
    the loss of every step run (a replayed step counted again), the final
    step and the wall time."""
    opt = optimizer()
    state = TrainState(params, opt.init(params))
    pipe = pipeline_for(cfg, seq_len=64, global_batch=8, device=device)
    losses = []

    def on_step(step, metrics):
        losses.append(float(metrics["loss"]))
        if verbose and step % 25 == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"dropped {float(metrics['dropped_fraction'])*100:.1f}%")

    trainer = ResilientTrainer(build_train_step(build_api(cfg), opt), pipe,
                               CheckpointManager(ckpt_dir), ckpt_every=50)
    t0 = time.time()
    state, step, _ = trainer.run(state, steps, inject_failure_at=steps // 2,
                                 on_step=on_step)
    return {"losses": losses, "step": step, "seconds": time.time() - t0,
            "state": state}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = model_config()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = build_api(cfg).init(gen)
    print(f"training {cfg.name} (reduced, {param_count(params)/1e6:.2f}M "
          f"params) for {args.steps} steps  [{device}]")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="torch_train_moe_")
    try:
        r = train(cfg, params, args.steps, ckpt_dir, device)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = r["losses"]
    print(f"\ndone in {r['seconds']:.0f}s (one failure injected + recovered "
          f"at step {args.steps // 2})")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'improved' if losses[-1] < losses[0] else 'NOT improved'})")
    print("kernel launches: " + json.dumps(launch_counts()))
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    sys.exit(main())
