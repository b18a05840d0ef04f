"""Quickstart on the PyTorch/CUDA port: build an MoE model, run it through
the ASAP components (the twin of examples/quickstart.py on repro_torch).

  PYTHONPATH=src python examples/torch_quickstart.py                # card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # CPU

Params and batches come from the port's own init under --seed.  On the card
the kernels run (the Super Kernel, and the capacity MoE layer's dispatch and
combine inside `api.loss`); on the CPU their plain versions.  Step 5 is the
reference's analytic cost model on its TPU v5e preset, not a measurement.
"""
import argparse
import json
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.core.cost_model import V5E, CostModel, Deployment
from repro_torch.kernels import launch_counts
from repro_torch.kernels.super_gmm.ops import make_super_kernel_gmm
from repro_torch.models.api import build_api
from repro_torch.models.lm import lm_forward

ANALYTIC = ("  [analytic: the reference's TPU v5e preset, not measured on "
            "this card]")


def model_config(dtype=torch.float32):
    """The assigned architecture's CPU-runnable reduction, as the
    reference's quickstart cuts it."""
    return get_config("qwen3-moe-235b-a22b").smoke().replace(
        num_layers=3, num_experts=8, top_k=2, dtype=dtype)


def param_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_count(v) for v in tree)
    return tree.numel()


def steps(cfg, params, batch: dict, prefill_batch: dict,
          decode_steps: int = 4) -> dict:
    """Steps 2-4 of the quickstart on given params and batches: the loss,
    the Super Kernel against the einsum path, prefill and greedy decode."""
    api = build_api(cfg)
    with torch.inference_mode():
        loss, metrics = api.loss(params, batch)
        gmm = make_super_kernel_gmm(params["stages"][0]["ffn"]["experts"],
                                    cfg)
        logits_kernel, _ = lm_forward(params, cfg, batch["tokens"], gmm=gmm)
        logits_ref, _ = lm_forward(params, cfg, batch["tokens"])
        err = float((logits_kernel.float() - logits_ref.float()).abs().max())
        logits, caches = api.prefill(params, prefill_batch)
        toks = torch.argmax(logits, -1)
        out = [toks]
        for _ in range(decode_steps):
            logits, caches = api.decode(params, caches, {"token": toks})
            toks = torch.argmax(logits, -1)
            out.append(toks)
    return {"loss": loss, "metrics": metrics, "logits_kernel": logits_kernel,
            "logits_ref": logits_ref, "err": err,
            "greedy": torch.stack(out, 1)}


def analytic_line() -> str:
    """Step 5: what this would cost at production scale, by the analytic
    model on the reference's TPU v5e preset."""
    full = get_config("qwen3-moe-235b-a22b")
    cm = CostModel(full, hw=V5E, dep=Deployment(D=4, T=4, E=16))
    return (f"full-size qwen3-moe on 32 v5e chips: attention(8k prompt) "
            f"{cm.attention_layer_latency([8192])*1e3:.2f} ms/layer, "
            f"MoE inflection {cm.moe_inflection_tokens()} tokens")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: pass --device cpu", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1) pick an assigned architecture; .smoke() gives the CPU-runnable
    #    reduction
    cfg = model_config()
    api = build_api(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        params = api.init(gen)
    print(f"model: {cfg.name} (reduced) — {param_count(params)/1e6:.1f}M "
          f"params, {cfg.num_experts} experts top-{cfg.top_k}  [{device}]")

    # 2) forward pass + loss, 3) the MoE Super Kernel: same math, layer id
    #    resolved on the device, 4) prefill + decode a few tokens
    batch = api.make_batch(gen, seq_len=64, batch_size=2, kind="train",
                           device=device)
    pb = api.make_batch(gen, seq_len=32, batch_size=2, kind="prefill",
                        device=device)
    r = steps(cfg, params, batch, pb)
    print(f"loss: {float(r['loss']):.3f}   dropped tokens: "
          f"{float(r['metrics']['dropped_fraction'])*100:.1f}%")
    print(f"super-kernel vs einsum max err: {r['err']:.2e}")
    print("greedy decode:", r["greedy"].cpu().numpy())

    # 5) what would this cost at production scale? (the analytic model)
    print(analytic_line() + ANALYTIC)
    print("kernel launches: " + json.dumps(launch_counts()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
