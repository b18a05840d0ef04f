"""Step builders: train_step / prefill_step / decode_step -- the reference's
`repro.launch.steps`, on one device.

`train_step` CONSUMES its state, as the optimizer does: the params and the
moments are updated in place and the same objects come back (the
reference's step is functional).  The reference's `build_compressed_dp_step`
(a shard_map data-parallel step with an int8-compressed all-reduce) belongs
to the multi-device slice.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models.api import ModelAPI
from repro_torch.optim.adamw import AdamW, OptState, global_norm
from repro_torch.tree import leaves, tree_map, unflatten


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(api: ModelAPI, gen: torch.Generator,
                     optimizer: AdamW) -> TrainState:
    params = api.init(gen)
    return TrainState(params, optimizer.init(params))


def value_and_grad(loss_fn: Callable, params, batch):
    """((loss, metrics), grads) of `loss_fn(params, batch)`: grads a tree of
    params' structure and dtypes, zeros for a leaf the loss does not reach
    (as jax gives them).  The params need no `requires_grad` of their own:
    it is set for the call and taken off after."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    try:
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
    finally:
        for p in ps:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), unflatten(params, grads)


def build_train_step(api: ModelAPI, optimizer: AdamW,
                     accum_steps: int = 1) -> Callable:
    """accum_steps > 1: gradient accumulation over microbatches, as the
    reference's `scan` -- the batch's leading axis split into
    `accum_steps` microbatches, fp32 gradient sums, loss and gradients
    averaged over them, metrics averaged."""

    def train_step(state: TrainState, batch):
        if accum_steps == 1:
            (loss, metrics), grads = value_and_grad(api.loss, state.params,
                                                    batch)
        else:
            micro = [{k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                     for i in range(accum_steps)]
            g_acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = torch.zeros((), device=leaves(state.params)[0].device)
            mstack = []
            for mb in micro:
                (l_mb, m_mb), g_mb = value_and_grad(api.loss, state.params,
                                                    mb)
                for a, g in zip(leaves(g_acc), leaves(g_mb)):
                    a.add_(g.float())
                loss = loss + l_mb
                mstack.append(m_mb)
                del g_mb
            loss = loss / accum_steps
            grads = tree_map(lambda g: g / accum_steps, g_acc)
            metrics = {k: torch.mean(torch.stack([m[k] for m in mstack]), 0)
                       for k in mstack[0]}
        optimizer.update(grads, state.opt, state.params)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = global_norm(grads)
        return state, metrics

    return train_step


def build_prefill_step(api: ModelAPI) -> Callable:
    def prefill_step(params, batch):
        return api.prefill(params, batch)

    return prefill_step


def build_decode_step(api: ModelAPI) -> Callable:
    def decode_step(params, caches, batch):
        return api.decode(params, caches, batch)

    return decode_step
