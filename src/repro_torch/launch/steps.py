"""Step builders: train_step / prefill_step / decode_step -- the reference's
`repro.launch.steps`, on one device and over a mesh.

`train_step` CONSUMES its state, as the optimizer does: the params and the
moments are updated in place and the same objects come back (the
reference's step is functional).  The train and decode steps over a mesh
consume theirs the same way:

  * `build_sharded_train_step` -- the counterpart of the reference's
    `jax.jit(build_train_step(...), in_shardings=...)`.  The state is
    stored as DTensors placed by the param specs (`state_specs`); each
    rank computes on its batch shard and, over "model", on the shards
    GSPMD would partition by those specs (`launch.sharding.
    compute_specs`): its attention heads (self, encoder and cross), RWKV
    and Mamba heads and channels, FFN hidden columns, experts and vocab
    rows, on plain local tensors through the same kernels, the ranks
    exchanging what the math needs (`pshard`'s operators).  Each param is
    gathered over the batch axes (and over "model" where the compute spec
    drops it) by a `pshard.LeafGather` -- a stacked layer's inside the
    layer's (rematerialized) body, the rest at the step's start --, whose
    backward leaves the gradient already reduced to the rank's stored
    shard (reduce-scatter where the spec shards a batch axis, all-reduce
    otherwise, divided by the batch axes' size).  The step clips by the
    norm of the whole gradient and updates the local shards.
  * `build_sharded_prefill_step` / `build_sharded_decode_step` -- the
    counterparts of the reference's `jax.jit(api.prefill / api.decode,
    in_shardings=...)` with `cache_specs`: the same compute over "model"
    in inference, a layer gathered at a time; each cache stored as its
    spec shards it (a KV cache's kv heads, or its sequence: split-K
    decode; a recurrent state's heads; a conv ring's channels).  The
    decode step consumes its caches.
  * `build_compressed_dp_step` -- the reference's shard_map step:
    replicated state, a per-rank error-feedback residual, the gradients
    all-reduced int8-compressed (`optim.compress.compressed_psum`), the
    loss averaged over the axis.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.launch.mesh import (axis_names, batch_axes, dp_size,
                                     mesh_shape, sum_over)
from repro_torch.launch.sharding import (P, _axes, batch_specs,
                                         cache_specs, compute_specs_of,
                                         kv_seq_shard, local_shard)
from repro_torch.models import pshard
from repro_torch.models.api import ModelAPI
from repro_torch.optim.adamw import AdamW, OptState, global_norm
from repro_torch.optim.compress import compressed_psum
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


def _loss_and_grads(loss_fn: Callable, params, batch, accum_steps: int):
    """(loss, metrics, grads) of `loss_fn` on `batch`.  accum_steps > 1:
    gradient accumulation over microbatches, as the reference's `scan` --
    the batch's leading axis split into `accum_steps` microbatches, fp32
    gradient sums, loss and gradients averaged over them, metrics
    averaged."""
    if accum_steps == 1:
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        return loss, dict(metrics), grads
    micro = [{k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                           + tuple(v.shape[1:]))[i]
              for k, v in batch.items()}
             for i in range(accum_steps)]
    g_acc = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    loss = torch.zeros((), device=leaves(params)[0].device)
    mstack = []
    for mb in micro:
        (l_mb, m_mb), g_mb = value_and_grad(loss_fn, params, mb)
        for a, g in zip(leaves(g_acc), leaves(g_mb)):
            a.add_(g.float())
        loss = loss + l_mb
        mstack.append(m_mb)
        del g_mb
    loss = loss / accum_steps
    grads = tree_map(lambda g: g / accum_steps, g_acc)
    metrics = {k: torch.mean(torch.stack([m[k] for m in mstack]), 0)
               for k in mstack[0]}
    return loss, metrics, grads


def build_train_step(api: ModelAPI, optimizer: AdamW,
                     accum_steps: int = 1) -> Callable:
    """accum_steps > 1: gradient accumulation over microbatches
    (`_loss_and_grads`)."""

    def train_step(state: TrainState, batch):
        loss, metrics, grads = _loss_and_grads(api.loss, state.params, batch,
                                               accum_steps)
        optimizer.update(grads, state.opt, state.params)
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


# ---------------------------------------------------------------------------
# Steps over a mesh
# ---------------------------------------------------------------------------


def state_specs(pspecs) -> TrainState:
    """Specs of a TrainState: the moments shard like their params, the step
    count is replicated."""
    return TrainState(pspecs, OptState(P(), pspecs, pspecs))


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _batch_shard(batch: dict, mesh, specs: dict) -> dict:
    """This rank's shard of a batch of whole tensors (or of DTensors)."""
    from torch.distributed.tensor import DTensor
    return {k: v.to_local() if isinstance(v, DTensor)
            else local_shard(v, specs[k], mesh) for k, v in batch.items()}


def sharded_global_norm(grads: list, specs: list, mesh) -> torch.Tensor:
    """The norm of the whole gradient from its local shards: each rank adds
    the squares of the leaves it owns a distinct shard of (coordinate 0 on
    every mesh dim the leaf is replicated over), then one sum over the
    mesh, so no replicated copy counts twice."""
    names = axis_names(mesh)
    coord = mesh.get_coordinate()
    total = None
    for g, spec in zip(grads, specs):
        sharded = {names.index(a) for e in spec if e is not None
                   for a in _axes(e)}
        sq = torch.sum(torch.square(g.float()))
        if any(c for i, c in enumerate(coord) if i not in sharded):
            sq = torch.zeros_like(sq)
        total = sq if total is None else total + sq
    return torch.sqrt(sum_over(total, mesh))


def leaf_gather(stored: P, computed: P, mesh) -> pshard.LeafGather:
    """The LeafGather from a leaf's shard under `stored` to its shard under
    `computed`: an all-gather over every mesh axis of `stored` that
    `computed` drops (a dim's minor axis first; none over an axis of size
    1), and in the backward an all-reduce over the batch axes that shard
    no dim of `stored`."""
    names, sizes = axis_names(mesh), mesh_shape(mesh)
    coord = mesh.get_coordinate()
    ba = batch_axes(mesh)
    steps, sharding = [], set()
    for dim, e in enumerate(stored):
        kept = set(_axes(computed[dim])) if computed[dim] is not None \
            else set()
        for a in reversed(_axes(e) if e is not None else ()):
            sharding.add(a)
            if a in kept or sizes[a] == 1:
                continue
            i = names.index(a)
            steps.append((dim, mesh.get_group(i), sizes[a], coord[i],
                          a in ba))
    reduce = [mesh.get_group(names.index(a)) for a in ba
              if a not in sharding and sizes[a] > 1]
    return pshard.LeafGather(steps, reduce, dp_size(mesh),
                             any(e is not None for e in computed))


def gather_plan(specs, cfg, mesh):
    """A tree of `leaf_gather`s shaped like the params: from each leaf's
    stored shard (`specs`, the param specs) to its computed one
    (`compute_specs_of`)."""
    return unflatten(specs, [
        leaf_gather(s, c, mesh) for s, c in
        zip(leaves(specs), leaves(compute_specs_of(specs, cfg, mesh)))])


def _metrics_over_batch(metrics: dict, mesh, ba_dims, dp: int) -> dict:
    """The global batch's metrics: the mean over equal shards."""
    if dp == 1:
        return metrics
    keys = list(metrics)
    vals = torch.stack([metrics[k].float() for k in keys])
    vals = sum_over(vals, mesh, ba_dims) / dp
    return dict(zip(keys, vals.unbind()))


def _split_plan(api: ModelAPI, plan) -> tuple:
    """(top, stacked) of a `gather_plan`: the LeafGathers of the top-level
    leaves (embedding, head, norms, zamba's shared block), gathered at the
    step's start, and those of the layers stacked on leading axes, which
    `pshard.gathered` hands the model to gather a layer at a time (the
    LM's list of stages; the encoder-decoder's dict of its two stacks)."""
    if api.cfg.family == "encdec":
        keys = ("encoder", "decoder")
        stacked = {k: plan[k] for k in keys}
    else:
        keys, stacked = ("stages",), plan["stages"]
    return {k: v for k, v in plan.items() if k not in keys}, stacked


def _top_gathered(params, top: dict) -> dict:
    """The params with every top-level leaf through its LeafGather; the
    stacked layers as stored (gathered per layer)."""
    return {k: pshard.gather_tree(v, top[k]) if k in top else v
            for k, v in params.items()}


def build_sharded_train_step(api: ModelAPI, optimizer: AdamW, mesh, specs,
                             accum_steps: int = 1) -> Callable:
    """`specs`: the param specs (`launch.sharding.param_specs`).  The state
    is `distribute_tree(state, mesh, state_specs(specs))`; the batch holds
    whole tensors (the same on every rank) or DTensors, sharded over the
    batch axes by `batch_specs` and replicated over "model".  Returns
    (state, metrics), the metrics those of the global batch; the program
    each rank runs is `sharded_value_and_grad`'s."""
    names = axis_names(mesh)
    dp = dp_size(mesh)
    ba_dims = [names.index(a) for a in batch_axes(mesh)]
    spec_list = leaves(specs)
    grads_of = sharded_value_and_grad(api, mesh, specs, accum_steps)

    def train_step(state: TrainState, batch):
        with torch.no_grad():
            local = tree_map(_local, state)
        loss, metrics, grads = grads_of(local.params, batch)
        with torch.no_grad():
            gn = sharded_global_norm(leaves(grads), spec_list, mesh)
            optimizer.update(grads, local.opt, local.params, grad_norm=gn)
        metrics["loss"] = loss
        metrics = _metrics_over_batch(metrics, mesh, ba_dims, dp)
        metrics["grad_norm"] = gn
        return state, metrics

    return train_step


def sharded_value_and_grad(api: ModelAPI, mesh, specs,
                           accum_steps: int = 1) -> Callable:
    """fn(local params, batch) -> (loss, metrics, grads) of the mesh step's
    tensor- and expert-parallel program, this rank's: `local params` the
    plain local shards of the params stored under `specs`, the batch as
    `build_sharded_train_step` takes it, the loss and metrics this rank's
    batch shard's, each gradient this rank's stored shard of the global
    batch's gradient (already reduced by the LeafGathers' backward:
    accumulation reduces once per microbatch)."""
    names = axis_names(mesh)
    dp = dp_size(mesh)
    ba_dims = [names.index(a) for a in batch_axes(mesh)]
    groups = [mesh.get_group(i) for i in ba_dims]
    model = mesh_shape(mesh).get("model", 1)
    top, stacked = _split_plan(api, gather_plan(specs, api.cfg, mesh))

    def loss_fn(params, batch):
        return api.loss(_top_gathered(params, top), batch)

    def grads_of(params, batch):
        local_batch = _batch_shard(batch, mesh, batch_specs(batch, mesh))
        with contextlib.ExitStack() as stack:
            if dp > 1:
                stack.enter_context(pshard.data_parallel(groups, dp))
            if model > 1:
                i = names.index("model")
                stack.enter_context(pshard.model_parallel(
                    mesh.get_group(i), model, mesh.get_coordinate()[i]))
            stack.enter_context(pshard.gathered(stacked))
            return _loss_and_grads(loss_fn, params, local_batch, accum_steps)

    return grads_of


# ---------------------------------------------------------------------------
# Serving steps over a mesh
# ---------------------------------------------------------------------------


def _batch_size(batch: dict) -> int:
    return next(iter(batch.values())).shape[0]


def _data_parallel(mesh, B: int):
    """`pshard.data_parallel` over the batch axes where a batch of B rows
    shards over them (`batch_specs`, `cache_specs`; a rank then holds whole
    dispatch groups, `dispatch_groups_for`); else none: every rank
    computes the whole batch."""
    names, dp = axis_names(mesh), dp_size(mesh)
    if dp == 1 or B % dp or B < dp:
        return contextlib.nullcontext()
    return pshard.data_parallel(
        [mesh.get_group(names.index(a)) for a in batch_axes(mesh)], dp)


def prefill_caches_like(api: ModelAPI, batch: dict,
                        max_len: Optional[int] = None):
    """Zero-size stand-ins ("meta" tensors) of the caches `api.prefill`
    makes of `batch` (whole tensors or DTensors): their shapes alone."""
    from repro_torch.models.encdec import init_encdec_caches
    from repro_torch.models.lm import init_caches
    cfg, B = api.cfg, _batch_size(batch)
    if cfg.family == "encdec":
        S, S_enc = batch["dec_tokens"].shape[1], \
            batch["enc_embeddings"].shape[1]
        return init_encdec_caches(cfg, B, max_len or S, S_enc,
                                  device="meta")
    S = (batch["tokens"] if "tokens" in batch
         else batch["embeddings"]).shape[1]
    return init_caches(cfg, B, max_len or S, device="meta", ring="window")


def prefill_cache_specs(api: ModelAPI, mesh, batch: dict,
                        max_len: Optional[int] = None):
    """`cache_specs` of the caches `api.prefill` makes of `batch`: what the
    mesh prefill step stores and the decode step consumes."""
    return cache_specs(prefill_caches_like(api, batch, max_len), api.cfg,
                       _batch_size(batch), mesh)


def _seq_plans(caches, cspecs, mesh, whole_shapes: bool):
    """The caches' tree with a `pshard.SeqShard` (or None where the
    sequence is whole) in place of each KVCache, read off its spec
    (`kv_seq_shard`), and None in place of any other leaf or recurrent
    state: per stage for the LM, `(memory, decoder)` for the
    encoder-decoder.  `caches` has the whole shapes (`whole_shapes`) or
    the rank's."""
    from repro_torch.models.attention import KVCache

    def walk(node, spec):
        if isinstance(node, KVCache):
            return kv_seq_shard(spec.k, mesh, node.k.shape[-3], whole_shapes)
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, list) or (isinstance(node, tuple)
                                      and not hasattr(node, "_fields")):
            return type(node)(walk(v, sp) for v, sp in zip(node, spec))
        return None

    return walk(caches, cspecs)


@contextlib.contextmanager
def _serving(mesh, B: int, stacked, seq_plans):
    """The contexts of a mesh serving step of a B-row batch: the batch
    axes' (`_data_parallel`), the model group's, the per-layer gathers and
    the caches' sequence shards."""
    names = axis_names(mesh)
    model = mesh_shape(mesh).get("model", 1)
    with contextlib.ExitStack() as stack:
        stack.enter_context(_data_parallel(mesh, B))
        if model > 1:
            i = names.index("model")
            stack.enter_context(pshard.model_parallel(
                mesh.get_group(i), model, mesh.get_coordinate()[i]))
        stack.enter_context(pshard.gathered(stacked))
        stack.enter_context(pshard.sequence_plans(seq_plans))
        yield


def build_sharded_prefill_step(api: ModelAPI, mesh, specs,
                               max_len: Optional[int] = None) -> Callable:
    """The prefill step over `mesh`: prefill_step(params, batch) ->
    (logits, caches).  `params`: `distribute_tree(params, mesh, specs)`
    (`specs` the param specs); the batch whole tensors or DTensors under
    `batch_specs`.  Returns this rank's batch shard of the last position's
    logits (the whole vocab) and its shards of the caches under
    `prefill_cache_specs` -- plain tensors, what
    `build_sharded_decode_step` consumes.  Computes as the train step does
    (heads, channels, FFN columns, experts and vocab rows over "model",
    each layer gathered over the batch axes inside the layer) and stores
    each cache as its spec shards it: a KV cache's kv heads and its slots
    of the sequence (`pshard.sequence_parallel`), a recurrent state's
    heads, a conv ring's stored channels."""
    top, stacked = _split_plan(api, gather_plan(specs, api.cfg, mesh))

    def prefill_step(params, batch):
        with torch.no_grad():
            B = _batch_size(batch)
            like = prefill_caches_like(api, batch, max_len)
            seq = _seq_plans(like, cache_specs(like, api.cfg, B, mesh), mesh,
                             whole_shapes=True)
            local_batch = _batch_shard(batch, mesh, batch_specs(batch, mesh))
            local_batch["max_len"] = max_len
            local = tree_map(_local, params)
            with _serving(mesh, B, stacked, seq):
                return api.prefill(_top_gathered(local, top), local_batch)

    return prefill_step


def build_sharded_decode_step(api: ModelAPI, mesh, specs,
                              cspecs) -> Callable:
    """The decode step over `mesh`: decode_step(params, caches, batch) ->
    (logits, caches).  `params` as `build_sharded_prefill_step` takes them;
    `caches` this rank's shards under `cspecs` (`cache_specs`; plain
    tensors, as the prefill step returns them, or DTensors); `batch`
    {"token": [B]}, whole or a DTensor.  The caches are CONSUMED, as on
    one device: written and advanced in place, the same objects returned
    (a recurrent state's shard overwritten, never gathered); the logits
    are this rank's batch shard's.  Where a KV cache is split over the
    sequence, the rank owning the new token's slot writes it and the
    attention merges the ranks' partial softmaxes (flash-decoding split-K,
    `models.attention.attention_decode`)."""
    top, stacked = _split_plan(api, gather_plan(specs, api.cfg, mesh))

    def decode_step(params, caches, batch):
        with torch.no_grad():
            B = _batch_size(batch)
            local_caches = tree_map(_local, caches)
            seq = _seq_plans(local_caches, cspecs, mesh, whole_shapes=False)
            local_batch = _batch_shard(batch, mesh, batch_specs(batch, mesh))
            local = tree_map(_local, params)
            with _serving(mesh, B, stacked, seq):
                logits, _ = api.decode(_top_gathered(local, top),
                                       local_caches, local_batch)
        return logits, caches

    return decode_step


def build_compressed_dp_step(api: ModelAPI, optimizer: AdamW, mesh,
                             axis: str = "data") -> Callable:
    """Explicit-collective data-parallel train step: per-shard backward,
    int8 + error-feedback all-reduce of the gradients over `axis`,
    replicated update.  step(state, residuals, batch) -> (state, residuals,
    loss): the state plain tensors, the same on every rank (consumed in
    place); `residuals` this rank's own error-feedback tree
    (`optim.compress.init_residuals`; the reference stacks the ranks'
    residuals on a leading axis sharded over `axis`); the batch whole, its
    leading axis sharded over `axis`; the loss averaged over `axis`."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)

    def step(state: TrainState, residuals, batch):
        local_batch = _batch_shard(batch, mesh, {
            k: P(axis, *((None,) * (v.dim() - 1))) for k, v in batch.items()})
        (loss, _), grads = value_and_grad(api.loss, state.params,
                                          local_batch)
        reduced, new_res = [], []
        for g, r in zip(leaves(grads), leaves(residuals)):
            m, nr = compressed_psum(g, r, group)
            reduced.append(m.to(g.dtype))
            new_res.append(nr)
        del grads
        optimizer.update(unflatten(state.params, reduced), state.opt,
                         state.params)
        dist.all_reduce(loss, group=group)
        return state, unflatten(residuals, new_res), loss / n

    return step
