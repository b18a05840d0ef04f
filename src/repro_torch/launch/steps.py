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
    compute_specs`): its attention heads, FFN hidden columns, experts and
    vocab rows, on plain local tensors through the same kernels, the ranks
    exchanging what the math needs (`pshard`'s four TP operators).  Each
    param is gathered over the batch axes (and over "model" where the
    compute spec drops it) by a `pshard.LeafGather` -- a stacked layer's
    inside the layer's (rematerialized) body, the rest at the step's start
    --, whose backward leaves the gradient already reduced to the rank's
    stored shard (reduce-scatter where the spec shards a batch axis,
    all-reduce otherwise, divided by the batch axes' size).  The step
    clips by the norm of the whole gradient and updates the local shards.
    The recurrent and encoder-decoder families keep the gather-everything
    program: every param gathered whole at the start, the one-device loss
    and backward on the batch shard, each gradient then reduced to its
    shard; the ranks of a data row compute the same shard there.
  * `build_sharded_prefill_step` / `build_sharded_decode_step` -- the
    counterparts of the reference's `jax.jit(api.prefill / api.decode,
    in_shardings=...)` with `cache_specs`: the same compute over "model"
    in inference, a layer gathered at a time; each KV cache stored as its
    spec shards it (kv heads, or the sequence: split-K decode).  The
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
from repro_torch.launch.sharding import (TP_FAMILIES, P, _axes, batch_only,
                                         batch_specs, cache_specs,
                                         compute_specs_of, full_tree,
                                         kv_seq_shard, local_shard,
                                         placements)
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


def reduce_to_shard(g: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """This rank's shard (under `spec`) of the sum of `g` over the batch
    axes: reduce-scatter where `spec` shards a dim over a batch axis,
    all-reduce otherwise, then the local slice over "model"."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    ba = batch_axes(mesh)
    src = [Partial() if a in ba else Replicate() for a in axis_names(mesh)]
    d = DTensor.from_local(g, mesh, src, run_check=False)
    return d.redistribute(mesh, placements(spec, mesh)).to_local()


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


def build_sharded_train_step(api: ModelAPI, optimizer: AdamW, mesh, specs,
                             accum_steps: int = 1) -> Callable:
    """`specs`: the param specs (`launch.sharding.param_specs`).  The state
    is `distribute_tree(state, mesh, state_specs(specs))`; the batch holds
    whole tensors (the same on every rank) or DTensors, sharded over the
    batch axes by `batch_specs` and replicated over "model".  Returns
    (state, metrics), the metrics those of the global batch.  The dense and
    MoE families compute over "model" (`sharded_value_and_grad`), the
    others gather every param whole (`_gather_all_train_step`)."""
    if api.cfg.family not in TP_FAMILIES:
        return _gather_all_train_step(api, optimizer, mesh, specs,
                                      accum_steps)
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
    plan = gather_plan(specs, api.cfg, mesh)
    top = {k: v for k, v in plan.items() if k != "stages"}

    def loss_fn(params, batch):
        full = {k: pshard.gather_tree(params[k], p) for k, p in top.items()}
        full["stages"] = params["stages"]
        return api.loss(full, batch)

    def grads_of(params, batch):
        local_batch = _batch_shard(batch, mesh, batch_specs(batch, mesh))
        with contextlib.ExitStack() as stack:
            if dp > 1:
                stack.enter_context(pshard.data_parallel(groups, dp))
            if model > 1:
                i = names.index("model")
                stack.enter_context(pshard.model_parallel(
                    mesh.get_group(i), model, mesh.get_coordinate()[i]))
            stack.enter_context(pshard.gathered(plan["stages"]))
            return _loss_and_grads(loss_fn, params, local_batch, accum_steps)

    return grads_of


def _gather_all_train_step(api: ModelAPI, optimizer: AdamW, mesh, specs,
                           accum_steps: int = 1) -> Callable:
    """The gather-everything mesh step (the recurrent and encoder-decoder
    families): every param gathered whole, the one-device loss and
    backward on the batch shard, each gradient reduced to its shard
    (`reduce_to_shard`) and divided by the batch axes' size."""
    names = axis_names(mesh)
    dp = dp_size(mesh)
    ba_dims = [names.index(a) for a in batch_axes(mesh)]
    groups = [mesh.get_group(i) for i in ba_dims]
    spec_list = leaves(specs)

    def mean_shard(g, spec):
        out = reduce_to_shard(g, mesh, spec)
        return out if dp == 1 else out.div_(dp)

    def train_step(state: TrainState, batch):
        local_batch = _batch_shard(batch, mesh, batch_specs(batch, mesh))
        with torch.no_grad():
            full = full_tree(state.params)
        ctx = pshard.data_parallel(groups, dp) if dp > 1 \
            else contextlib.nullcontext()
        with ctx:
            loss, metrics, grads = _loss_and_grads(api.loss, full,
                                                   local_batch, accum_steps)
        del full
        with torch.no_grad():
            g_local = [mean_shard(g, s)
                       for g, s in zip(leaves(grads), spec_list)]
            del grads
            gn = sharded_global_norm(g_local, spec_list, mesh)
            local = tree_map(_local, state)
            optimizer.update(unflatten(state.params, g_local), local.opt,
                             local.params, grad_norm=gn)
        metrics["loss"] = loss
        metrics = _metrics_over_batch(metrics, mesh, ba_dims, dp)
        metrics["grad_norm"] = gn
        return state, metrics

    return train_step


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


def _seq_plans(caches, cspecs, mesh, whole_shapes: bool) -> list:
    """Per stage, the stage's caches' tree with a `pshard.SeqShard` (or
    None where the sequence is whole) in place of each KVCache, read off
    its spec (`kv_seq_shard`); `caches` has the whole shapes
    (`whole_shapes`) or the rank's."""
    from repro_torch.models.attention import KVCache

    def walk(node, spec):
        if isinstance(node, KVCache):
            return kv_seq_shard(spec.k, mesh, node.k.shape[-3], whole_shapes)
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, sp) for v, sp in zip(node, spec)]
        return None

    return walk(caches, cspecs)


@contextlib.contextmanager
def _serving(mesh, B: int, stage_plans, seq_plans):
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
        stack.enter_context(pshard.gathered(stage_plans))
        stack.enter_context(pshard.sequence_plans(seq_plans))
        yield


def _top_gathered(params, top: dict) -> dict:
    """The params with every top-level leaf (embedding, head, final norm)
    through its LeafGather; the stages as stored (gathered per layer)."""
    full = {k: pshard.gather_tree(params[k], p) for k, p in top.items()}
    full["stages"] = params["stages"]
    return full


def build_sharded_prefill_step(api: ModelAPI, mesh, specs,
                               max_len: Optional[int] = None) -> Callable:
    """The prefill step over `mesh`: prefill_step(params, batch) ->
    (logits, caches).  `params`: `distribute_tree(params, mesh, specs)`
    (`specs` the param specs); the batch whole tensors or DTensors under
    `batch_specs`.  Returns this rank's batch shard of the last position's
    logits (the whole vocab) and its shards of the caches under
    `prefill_cache_specs` -- plain tensors, what
    `build_sharded_decode_step` consumes.  The dense and MoE families
    compute as the TP train step does (heads, FFN columns, experts and
    vocab rows over "model", each layer gathered over the batch axes
    inside the layer) and store each KV cache as its spec shards it: the
    rank's kv heads, and its slots of the sequence (`pshard.
    sequence_parallel`).  The others gather every param whole
    (`_gather_all_prefill_step`)."""
    if api.cfg.family not in TP_FAMILIES:
        return _gather_all_prefill_step(api, mesh, max_len)
    plan = gather_plan(specs, api.cfg, mesh)
    top = {k: v for k, v in plan.items() if k != "stages"}

    def prefill_step(params, batch):
        with torch.no_grad():
            B = _batch_size(batch)
            like = prefill_caches_like(api, batch, max_len)
            seq = _seq_plans(like, cache_specs(like, api.cfg, B, mesh), mesh,
                             whole_shapes=True)
            local_batch = _batch_shard(batch, mesh, batch_specs(batch, mesh))
            local_batch["max_len"] = max_len
            local = tree_map(_local, params)
            with _serving(mesh, B, plan["stages"], seq):
                return api.prefill(_top_gathered(local, top), local_batch)

    return prefill_step


def build_sharded_decode_step(api: ModelAPI, mesh, specs,
                              cspecs) -> Callable:
    """The decode step over `mesh`: decode_step(params, caches, batch) ->
    (logits, caches).  `params` as `build_sharded_prefill_step` takes them;
    `caches` this rank's shards under `cspecs` (`cache_specs`; plain
    tensors, as the prefill step returns them, or DTensors); `batch`
    {"token": [B]}, whole or a DTensor.  The caches are CONSUMED, as on
    one device: written and advanced in place, the same objects returned;
    the logits are this rank's batch shard's.  Where a KV cache is split
    over the sequence, the rank owning the new token's slot writes it and
    the attention merges the ranks' partial softmaxes (flash-decoding
    split-K, `models.attention.attention_decode`).  The families outside
    `TP_FAMILIES` take `_gather_all_decode_step`."""
    if api.cfg.family not in TP_FAMILIES:
        return _gather_all_decode_step(api, mesh, cspecs)
    plan = gather_plan(specs, api.cfg, mesh)
    top = {k: v for k, v in plan.items() if k != "stages"}

    def decode_step(params, caches, batch):
        with torch.no_grad():
            B = _batch_size(batch)
            local_caches = tree_map(_local, caches)
            seq = _seq_plans(local_caches, cspecs, mesh, whole_shapes=False)
            local_batch = _batch_shard(batch, mesh, batch_specs(batch, mesh))
            local = tree_map(_local, params)
            with _serving(mesh, B, plan["stages"], seq):
                logits, _ = api.decode(_top_gathered(local, top),
                                       local_caches, local_batch)
        return logits, caches

    return decode_step


def _gather_leaf(t: torch.Tensor, stored: P, computed: P, mesh):
    """`t`, a shard under `stored`, all-gathered to its shard under
    `computed` (plain collectives: no autograd)."""
    for dim, group, size, _, _ in leaf_gather(stored, computed, mesh).steps:
        t = pshard._all_gather(t, dim, group, size)
    return t


def _within_batch_shard(t: torch.Tensor, spec: P, batch_dim, mesh):
    """This rank's shard under `spec` of `t`, which holds the rank's batch
    shard whole in every other dim (a copy, so `t` can go)."""
    return local_shard(t, P(*(None if i == batch_dim else e
                              for i, e in enumerate(spec))), mesh).clone(
        memory_format=torch.contiguous_format)


def _gather_all_prefill_step(api: ModelAPI, mesh,
                             max_len: Optional[int] = None) -> Callable:
    """The gather-everything prefill (the recurrent, hybrid and
    encoder-decoder families): every param gathered whole, the one-device
    prefill on the batch shard, then each cache leaf cut to the rank's
    shard under `prefill_cache_specs`."""
    def prefill_step(params, batch):
        with torch.no_grad():
            B = _batch_size(batch)
            like = prefill_caches_like(api, batch, max_len)
            cspecs, dims = cache_specs(like, api.cfg, B, mesh,
                                       with_batch_dims=True)
            local_batch = _batch_shard(batch, mesh, batch_specs(batch, mesh))
            local_batch["max_len"] = max_len
            full = full_tree(params)
            with _data_parallel(mesh, B):
                logits, caches = api.prefill(full, local_batch)
            del full
            caches = tree_map(
                lambda t, s, d: _within_batch_shard(t, s, d, mesh), caches,
                cspecs, dims)
        return logits, caches

    return prefill_step


def _gather_all_decode_step(api: ModelAPI, mesh, cspecs) -> Callable:
    """The gather-everything decode: every param gathered whole, each cache
    leaf gathered over every axis but its batch dim's batch axes, the
    one-device decode on the batch shard, then the rank's shards written
    back into the stored caches (consumed, as on one device)."""
    def decode_step(params, caches, batch):
        with torch.no_grad():
            B = _batch_size(batch)
            stored = tree_map(_local, caches)
            _, dims = cache_specs(stored, api.cfg, B, mesh,
                                  with_batch_dims=True)
            work = tree_map(lambda t, s, d: _gather_leaf(
                t, s, batch_only(s, d), mesh), stored, cspecs, dims)
            local_batch = _batch_shard(batch, mesh, batch_specs(batch, mesh))
            full = full_tree(params)
            with _data_parallel(mesh, B):
                logits, _ = api.decode(full, work, local_batch)
            del full
            tree_map(lambda t, w, s, d: w is t or t.copy_(
                _within_batch_shard(w, s, d, mesh)), stored, work, cspecs,
                dims)
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
