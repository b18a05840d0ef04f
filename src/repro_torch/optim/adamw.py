"""AdamW with global-norm gradient clipping (fp32 moments, bf16-safe): the
reference's optimizer (`repro.optim.adamw`), same fields and math.

State is (step, m, v): `step` an int32 scalar on the params' device, the
moments fp32 trees matching the params whatever their dtype (no fp32
master weights: the params keep their dtype, as in the reference).

Unlike the reference's functional update, `update` CONSUMES its inputs: the
moments and the params are updated in place, leaf by leaf under
`torch.no_grad`, and the same objects come back.  A tree-wide chain of
copies (one per step of the formula, as `jax.tree.map` writes it) would
hold several fp32 copies of every leaf at once; here at most two fp32
temporaries of the leaf being updated live at a time.  The global norm is
taken over every leaf before any leaf is updated, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.tree import leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 0

    def init(self, params) -> OptState:
        device = leaves(params)[0].device

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return OptState(torch.zeros((), dtype=torch.int32, device=device),
                        tree_map(zeros, params), tree_map(zeros, params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        lr = torch.tensor(self.lr, dtype=torch.float32, device=step.device)
        if self.warmup_steps:
            lr = lr * torch.clamp((step + 1) / self.warmup_steps, max=1.0)
        return lr

    @torch.no_grad()
    def update(self, grads, state: OptState, params, grad_norm=None):
        """(params, OptState) after one step, both updated in place.  grads:
        a tree of params' structure (unused leaves' gradients as zeros, as
        jax gives them).  `grad_norm`: the global norm to clip by when the
        leaves are shards of a larger gradient (the sharded step); taken
        over `grads` otherwise."""
        if self.clip_norm is not None:
            gn = global_norm(grads) if grad_norm is None else grad_norm
            scale = torch.clamp(self.clip_norm / (gn + 1e-12), max=1.0)
        step = state.step + 1
        t = step.float()
        b1, b2 = self.b1, self.b2
        bc1 = 1 - torch.pow(torch.tensor(b1, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=t.device), t)
        lr = self._lr(step)
        for g, m, v, p in zip(leaves(grads), leaves(state.m),
                              leaves(state.v), leaves(params)):
            g32 = g.to(torch.float32, copy=True)
            if self.clip_norm is not None:
                g32.mul_(scale)
            m.mul_(b1).add_(g32, alpha=1 - b1)
            v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            # u = (m / bc1) / (sqrt(v / bc2) + eps), the denominator in g32
            torch.div(v, bc2, out=g32)
            g32.sqrt_().add_(self.eps)
            u = torch.div(m, bc1).div_(g32)
            del g32
            p32 = p.float()  # p itself when p is fp32
            if self.weight_decay:
                u.add_(p32, alpha=self.weight_decay)
            p.copy_(p32.sub_(u.mul_(lr)))
        state.step.copy_(step)
        return params, state


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum over leaves of sum(x^2)) in fp32 (None leaves skipped)."""
    total = None
    for x in leaves(tree):
        if x is None:
            continue
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)
