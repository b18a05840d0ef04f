"""Checkpoint/restart training loop -- the reference's `ResilientTrainer`
(`repro.runtime.fault_tolerance`).

Periodic atomic checkpoints, and on a node failure: restore the latest
checkpoint and fast-forward the data pipeline (a pure function of the step,
so a restart loses at most `ckpt_every` steps and never replays data
wrongly).

One deliberate difference: the reference treats every `RuntimeError` as a
node failure; here only `NodeFailure` is one.  On the card a CUDA error or
a kernel that fails to build or launch is a `RuntimeError` too, and a
restore would hide it: it propagates.

`elastic_mesh` rebuilds a (data, model) mesh over the ranks still alive and
`reshard_onto` re-places a (restored) tree onto it: the elastic path
(launch on fewer or more cards, same checkpoint).  The alive set is
injectable for tests, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

from repro_torch.checkpoint.manager import CheckpointManager


class NodeFailure(RuntimeError):
    """A lost worker: what a failure detector raises (and what the
    injected failure is)."""


@dataclasses.dataclass
class ResilientTrainer:
    train_step: Callable  # (state, batch) -> (state, metrics)
    pipeline: Any  # step -> batch (repro_torch.data.pipeline.TokenPipeline)
    ckpt: CheckpointManager
    ckpt_every: int = 50
    max_failures: int = 10

    def run(self, state, num_steps: int, start_step: int = 0,
            inject_failure_at: Optional[int] = None,
            on_step: Optional[Callable] = None):
        """Run to `num_steps`, surviving node failures by restore.  Returns
        (state, step, last metrics)."""
        step = start_step
        failures = 0
        metrics = {}
        while step < num_steps:
            try:
                if inject_failure_at is not None and step == inject_failure_at:
                    inject_failure_at = None  # fail once
                    raise NodeFailure("injected node failure")
                batch = self.pipeline.batch(step)
                state, metrics = self.train_step(state, batch)
                step += 1
                if on_step:
                    on_step(step, metrics)
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state, {"step": step})
            except NodeFailure:
                failures += 1
                if failures > self.max_failures:
                    raise
                restored_step = self.ckpt.latest_step()
                if restored_step is None:
                    step = start_step  # no checkpoint yet: restart from scratch
                    continue
                state = self.ckpt.restore(state, restored_step)
                step = self.ckpt.metadata(restored_step)["step"]
        return state, step, metrics


# ---------------------------------------------------------------------------
# Elastic mesh
# ---------------------------------------------------------------------------


def elastic_mesh(alive_ranks: Optional[List[int]] = None,
                 model_axis: int = 2, device_type: str = "cuda"):
    """Largest (data x model) mesh over the alive ranks (every rank of the
    default group by default), a DeviceMesh whose process groups hold only
    those ranks: only they call this."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import _device_mesh
    ranks = list(alive_ranks) if alive_ranks is not None \
        else list(range(dist.get_world_size()))
    n = len(ranks)
    model = 1
    for m in range(min(model_axis, n), 0, -1):
        if n % m == 0:
            model = m
            break
    data = n // model
    return _device_mesh(device_type, (data, model), ("data", "model"),
                        ranks[:data * model])


def reshard_onto(tree, mesh, specs):
    """Re-place a tree onto `mesh` under `specs`: each leaf gathered whole
    (a DTensor on a live mesh) or taken as it is, then sliced."""
    from repro_torch.launch.sharding import distribute_tree, full_tree
    return distribute_tree(full_tree(tree), mesh, specs)
