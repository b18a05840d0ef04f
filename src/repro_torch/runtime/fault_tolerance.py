"""Checkpoint/restart training loop -- the reference's `ResilientTrainer`
(`repro.runtime.fault_tolerance`).

Periodic atomic checkpoints, and on a node failure: restore the latest
checkpoint and fast-forward the data pipeline (a pure function of the step,
so a restart loses at most `ckpt_every` steps and never replays data
wrongly).

One deliberate difference: the reference treats every `RuntimeError` as a
node failure; here only `NodeFailure` is one.  On the card a CUDA error or
a kernel that fails to build or launch is a `RuntimeError` too, and a
restore would hide it: it propagates.  The reference's `elastic_mesh` and
`reshard_onto` belong to the multi-device slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

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
