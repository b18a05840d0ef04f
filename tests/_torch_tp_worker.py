"""One rank of the port's tensor- and expert-parallel checks on a gloo
process group (CPU).

  python tests/_torch_tp_worker.py RANK WORLD STORE_FILE INPUTS OUT_DIR

Rendezvous through a `FileStore` at STORE_FILE.  INPUTS is the pickle of
cases `test_torch_tp.py` makes; each rank writes what it saw to
OUT_DIR/rank{RANK}.npz (WORLD 1: the (1, 1) mesh's steps against the
one-device step, `torch.equal`, to OUT_DIR/single.npz).  On each mesh of
the pickle, for each case: 2
`build_sharded_train_step` steps (metrics, the params gathered whole); one
`sharded_value_and_grad` against the one-device gradient on the global
batch (each leaf's stored shard, and the gradients of the leaves replicated
over "model" for the test to compare across ranks); the dot FLOPs of the
matmuls on the leaves computed over "model" against the one-device
program's on the same batch shard; the peak live bytes of the step against
the one-device step's on the rank's batch shard; what reaches the kernels'
wrappers.  On the 2x2 mesh's model group: the six `pshard` operators
against closed forms and, where the pickle names a MoE case, the MoE layer
at model 2 against model 1 (forward, and the gradients with and without a
shared expert) and a column-parallel projection against the one-device
one; where it names a Mamba case, on the 1x4 mesh's model group, the
mixer's gated norm and out_proj on the rank's heads against one device.
Imports no jax.
"""
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.op_analysis import OpAnalysis  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import pshard  # noqa: E402
from repro_torch.models.api import build_api  # noqa: E402
from repro_torch.models.lm import layer_slice  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

_MM = {"mm", "addmm", "bmm", "baddbmm"}


def _batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _setup(case):
    cfg = get_config(case["arch"]).smoke().replace(**case["replace"])
    return cfg, params_from_numpy(case["params"], cfg, "cpu")


class _WatchedFlops(OpAnalysis):
    """OpAnalysis that also sums the FLOPs of the matmul ops one of whose
    operands lies in a watched storage (`watch`: storage data pointers)."""

    def __init__(self):
        super().__init__()
        self.watch, self.watched_flops = set(), 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func._overloadpacket.__name__ in _MM:
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            if any(t.untyped_storage().data_ptr() in self.watch for t in ts):
                self.watched_flops += float(self._flops[
                    func._overloadpacket](*args, **(kwargs or {}),
                                          out_val=out))
        return out


def _watch_gathers(mode, keep):
    """Puts each LeafGather output of a leaf computed over "model" on the
    mode's watch list (held in `keep`, so no storage is reused)."""
    real = pshard.LeafGather.__call__

    def call(self, t):
        out = real(self, t)
        if self.model_sharded:
            keep.append(out)
            mode.watch.add(out.untyped_storage().data_ptr())
        return out
    return real, call


def _plain_check(calls, bad):
    """A wrapper recorder: every tensor argument a plain contiguous
    torch.Tensor."""
    from torch.distributed.tensor import DTensor

    def wrap(name, fn):
        def inner(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            for a in list(args) + list(kwargs.values()):
                if isinstance(a, torch.Tensor) and (
                        isinstance(a, DTensor) or type(a) is not torch.Tensor
                        or not a.is_contiguous()):
                    bad.append(f"{name}: {type(a).__name__} "
                               f"{tuple(a.shape)} {a.stride()}")
            return fn(*args, **kwargs)
        return inner
    return wrap


def run_case(out, tag, case, mesh, rank):
    cfg, params = _setup(case)
    api = build_api(cfg)
    opt = AdamW(**case["opt"])
    pspecs = SH.param_specs(params, cfg, mesh)
    cspecs = SH.compute_specs(params, cfg, mesh)
    batches = [_batch(b) for b in case["batches"]]

    # what reaches the kernels' wrappers
    calls, bad = {}, []
    wrap = _plain_check(calls, bad)
    real = (A.mha_flash, M.kernel_moe_dispatch, M.kernel_moe_combine)
    A.mha_flash = wrap("flash_attention", real[0])
    M.kernel_moe_dispatch = wrap("dispatch_scatter", real[1])
    M.kernel_moe_combine = wrap("combine_gather", real[2])
    try:
        state = SH.distribute_tree(
            ST.TrainState(params, opt.init(params)), mesh,
            ST.state_specs(pspecs))
        step = ST.build_sharded_train_step(api, opt, mesh, pspecs)
        for i, b in enumerate(batches):
            state, metrics = step(state, b)
            for k, v in metrics.items():
                out[f"{tag}/metrics{i}/{k}"] = v.numpy()
    finally:
        A.mha_flash, M.kernel_moe_dispatch, M.kernel_moe_combine = real
    out[f"{tag}/wrapper_calls"] = np.array(
        [calls.get(k, 0) for k in ("flash_attention", "dispatch_scatter",
                                   "combine_gather")])
    out[f"{tag}/wrapper_bad"] = np.array(bad[:20], dtype=object) \
        if bad else np.array([], dtype=object)
    full = SH.full_tree(state)
    for i, p in enumerate(leaves(full.params)):
        out[f"{tag}/p{i:04d}"] = p.numpy()

    # gradients: this rank's stored shards against the one-device gradient
    cfg, params = _setup(case)
    dstate = SH.distribute_tree(params, mesh, pspecs)
    local = tree_map(lambda t: t.to_local(), dstate)
    grads_of = ST.sharded_value_and_grad(api, mesh, pspecs)
    _, _, grads = grads_of(local, batches[0])
    (_, _), one = ST.value_and_grad(api.loss, params, batches[0])
    errs = []
    for i, (g, w, s) in enumerate(zip(leaves(grads), leaves(one),
                                      leaves(pspecs))):
        want = SH.local_shard(w, s, mesh)
        scale = max(float(want.abs().max()), 1e-30)
        errs.append(float((g - want).abs().max()) / scale)
        if "model" not in [a for e in s if e is not None
                           for a in SH._axes(e)]:
            out[f"{tag}/grad_replicated{i:04d}"] = g.numpy()
    out[f"{tag}/grad_rel_err"] = np.array(errs)
    out[f"{tag}/grad_model_sharded"] = np.array(
        [any(e is not None for e in c) for c in leaves(cspecs)])

    # dot FLOPs on the leaves computed over "model": the mesh step's
    # program against the one-device program on the same batch shard
    shard = ST._batch_shard(batches[0], mesh,
                            SH.batch_specs(batches[0], mesh))
    mode, keep = _WatchedFlops(), []
    real, call = _watch_gathers(mode, keep)
    pshard.LeafGather.__call__ = call
    try:
        with mode:
            grads_of(local, batches[0])
    finally:
        pshard.LeafGather.__call__ = real
    del keep
    one_mode = _WatchedFlops()
    for p, c in zip(leaves(params), leaves(cspecs)):
        if any(e is not None for e in c):
            one_mode.watch.add(p.untyped_storage().data_ptr())
    with one_mode:
        ST.value_and_grad(api.loss, params, shard)
    out[f"{tag}/flops"] = np.array([mode.watched_flops,
                                    one_mode.watched_flops])

    # peak live bytes of a step: this one against the one-device step on
    # the rank's batch shard
    cfg, params = _setup(case)
    st = SH.distribute_tree(ST.TrainState(params, opt.init(params)), mesh,
                            ST.state_specs(pspecs))
    fn = ST.build_sharded_train_step(api, opt, mesh, pspecs)
    with OpAnalysis() as oa:
        fn(st, batches[0])
    peaks = [oa.costs().peak_live_bytes]
    cfg, params = _setup(case)
    one = ST.build_train_step(api, opt)
    st = ST.TrainState(params, opt.init(params))
    with OpAnalysis() as oa:
        one(st, shard)
    peaks.append(oa.costs().peak_live_bytes)
    out[f"{tag}/peak_live_bytes"] = np.array(peaks)


def check_operators(out, mesh):
    """The four operators on the model group (2 ranks) against closed
    forms: x_r = (r + 1) * base, a loss weighting each output element."""
    group = mesh.get_group(mesh.mesh_dim_names.index("model"))
    r, n = dist.get_rank(group), dist.get_world_size(group)
    base = torch.arange(12.0).reshape(4, 3)
    wts = torch.linspace(0.5, 2.0, 12).reshape(4, 3)
    res = {}
    with pshard.model_parallel(group, n, r):
        x = ((r + 1) * base).requires_grad_(True)
        y = pshard.copy_to_model(x)
        (y * wts).sum().backward()
        res["copy"] = torch.equal(y, x) and torch.equal(x.grad, n * wts)

        x = ((r + 1) * base).requires_grad_(True)
        y = pshard.reduce_from_model(x)
        (y * wts).sum().backward()
        total = sum(range(1, n + 1)) * base
        res["reduce"] = torch.equal(y, total) and torch.equal(x.grad, wts)

        x = base.clone().requires_grad_(True)  # replicated
        y = pshard.scatter_to_model(x, 0)
        rows = base.shape[0] // n
        w_local = wts[r * rows:(r + 1) * rows]
        (y * w_local).sum().backward()
        res["scatter"] = torch.equal(y, base[r * rows:(r + 1) * rows]) \
            and torch.equal(x.grad, wts)

        x = ((r + 1) * base).requires_grad_(True)
        y = pshard.gather_from_model(x, 1)
        wide = torch.linspace(0.5, 2.0, 4 * 3 * n).reshape(4, 3 * n)
        (y * wide).sum().backward()
        res["gather"] = torch.equal(
            y, torch.cat([(i + 1) * base for i in range(n)], 1)) \
            and torch.equal(x.grad, wide[:, r * 3:(r + 1) * 3])

        # each rank reads its own column of the gathered whole: the
        # gradient of every rank's chunk is the sum of the ranks' reads
        x = ((r + 1) * base).requires_grad_(True)
        y = pshard.gather_to_model(x, 1)
        (y[:, r] * wts[:, 0]).sum().backward()
        want = torch.zeros_like(base)
        for j in range(n):  # rank j reads column j: rank j // 3's chunk
            if j // 3 == r:
                want[:, j % 3] += wts[:, 0]
        res["gather_to"] = torch.equal(
            y, torch.cat([(i + 1) * base for i in range(n)], 1)) \
            and torch.equal(x.grad, want)

        # a sum every rank uses with its own weight: the gradient is the
        # sum of the weights
        x = ((r + 1) * base).requires_grad_(True)
        y = pshard.sum_over_model(x)
        (y * (r + 1) * wts).sum().backward()
        res["sum"] = torch.equal(y, total) and torch.equal(
            x.grad, sum(range(1, n + 1)) * wts)
    for k, v in res.items():
        out[f"operators/{k}"] = np.array(v)


def check_local_layers(out, case, mesh):
    """fp32, on the model group (2 ranks): the capacity MoE layer on this
    rank's experts == the one-device layer (torch.equal: each capacity row
    is its own chain of dots), and this rank's column-parallel q
    projection == its heads of the one-device projection."""
    group = mesh.get_group(mesh.mesh_dim_names.index("model"))
    r, n = dist.get_rank(group), dist.get_world_size(group)
    cfg, params = _setup(case)
    layer = layer_slice(params["stages"][0], 0)
    moe_p = layer["ffn"]
    x = torch.randn(64, cfg.d_model, generator=torch.Generator().manual_seed(3))
    want, want_aux = M.moe_forward_capacity(moe_p, x, cfg)
    E = cfg.num_experts // n
    local_p = dict(moe_p, experts={k: v[r * E:(r + 1) * E].contiguous()
                                   for k, v in moe_p["experts"].items()})
    with pshard.model_parallel(group, n, r):
        got, got_aux = M.moe_forward_capacity(local_p, x, cfg)
    out["local/moe_equal"] = np.array(
        torch.equal(got, want) and all(torch.equal(a, b)
                                       for a, b in zip(got_aux, want_aux)))
    attn = layer["attn"]
    H, hd = cfg.num_heads // n, cfg.head_dim
    local_attn = dict(attn, wq=attn["wq"][:, r * H * hd:(r + 1) * H * hd]
                      .contiguous())
    xa = torch.randn(2, 16, cfg.d_model,
                     generator=torch.Generator().manual_seed(4))
    pos = torch.arange(16).expand(2, 16)
    q_one, _, _ = A._project_qkv(attn, xa, xa, cfg, pos, pos)
    with pshard.model_parallel(group, n, r):
        q_loc, _, _ = A._project_qkv(local_attn, xa, xa, cfg, pos, pos)
    out["local/q_equal"] = np.array(torch.equal(q_loc,
                                                q_one[:, :, r * H:(r + 1) * H]))


def _flat(tree, path=""):
    """A nested dict of tensors as {"a/b": tensor}."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{path}{k}/").items()}
    return {path[:-1]: tree}


def _nested(flat):
    tree = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _moe_grads(flat, x, dy, cfg):
    """The capacity MoE layer's output and the gradients of sum(y * dy) +
    its load-balance loss with respect to x and each of its params (`flat`,
    by path)."""
    ins = {k: v.detach().requires_grad_(True)
           for k, v in dict(flat, x=x).items()}
    y, aux = M.moe_forward_capacity(
        _nested({k: v for k, v in ins.items() if k != "x"}), ins["x"], cfg)
    g = torch.autograd.grad((y * dy).sum() + aux.load_balance_loss,
                            list(ins.values()))
    return y.detach(), dict(zip(ins, g))


def _local_moe(flat, r, n, E):
    """This rank's share of a MoE layer's params or of their gradients (by
    path): its experts, its shared expert's gate / up columns and down
    rows; the router and x whole."""
    def cut(k, v):
        if k.startswith("experts/"):
            return v[r * E:(r + 1) * E]
        if k.startswith("shared/"):
            dim = 0 if k.endswith("w_down") else 1
            w = v.shape[dim] // n
            return v.narrow(dim, r * w, w)
        return v
    return {k: cut(k, v).contiguous() for k, v in flat.items()}


def check_moe_backward(out, case, mesh):
    """fp32, on the model group (2 ranks): the capacity MoE layer's output
    and gradients (x's, the router's, this rank's experts' and, with one
    shared expert of expert width, this rank's share of it) against the
    one-device layer's, for the loss sum(y * dy) + the load-balance loss;
    max abs error over each tensor's max magnitude."""
    group = mesh.get_group(mesh.mesh_dim_names.index("model"))
    r, n = dist.get_rank(group), dist.get_world_size(group)
    cfg0, _ = _setup(case)
    for shared in (0, 1):
        cfg = cfg0.replace(num_shared_experts=shared)
        gen = torch.Generator().manual_seed(5 + shared)
        p = _flat(M.init_moe_params(gen, cfg))
        x = torch.randn(64, cfg.d_model, generator=gen)
        dy = torch.randn(64, cfg.d_model, generator=gen)
        y_one, g_one = _moe_grads(p, x, dy, cfg)
        E = cfg.num_experts // n
        with pshard.model_parallel(group, n, r):
            y, g = _moe_grads(_local_moe(p, r, n, E), x, dy, cfg)
        errs = {k: float((g[k] - w).abs().max())
                / max(float(w.abs().max()), 1e-30)
                for k, w in _local_moe(g_one, r, n, E).items()}
        errs["y"] = float((y - y_one).abs().max()) \
            / float(y_one.abs().max())
        out[f"local/moe_bwd_rel_err/shared{shared}"] = np.array(
            [errs[k] for k in sorted(errs)])
        out[f"local/moe_bwd_names/shared{shared}"] = np.array(
            sorted(errs), dtype=object)


def check_mamba_norm(out, case, mesh):
    """fp32, on the model group: the Mamba2 mixer's gated RMS norm and
    out_proj on the rank's SSD heads (the sum of squares over the whole
    d_inner summed over "model") against the one-device layer: the output
    and the gradients of y, z, out_norm and out_proj, each the rank's
    share; max abs error over each tensor's max magnitude."""
    from repro_torch.models import mamba2 as MB
    group = mesh.get_group(mesh.mesh_dim_names.index("model"))
    r, n = dist.get_rank(group), dist.get_world_size(group)
    cfg, _ = _setup(case)
    d_inner, H, P, _ = MB._dims(cfg)
    gen = torch.Generator().manual_seed(7)
    b, S, d = 2, 8, cfg.d_model
    t = {"y": torch.randn(b, S, d_inner, generator=gen),
         "z": torch.randn(b, S, d_inner, generator=gen),
         "out_norm": 1 + 0.1 * torch.randn(d_inner, generator=gen),
         "out_proj": torch.randn(d_inner, d, generator=gen) / 8}
    u = torch.zeros(b, S, d)
    dy = torch.randn(b, S, d, generator=gen)

    def run(ts, sp):
        ins = {k: v.detach().clone().requires_grad_(True)
               for k, v in ts.items()}
        o = MB._gated_out(ins, ins["y"], ins["z"], u, cfg, sp)
        g = torch.autograd.grad((o * dy).sum(), list(ins.values()))
        return o.detach(), dict(zip(ins, g))

    o_one, g_one = run(t, MB._Split(False, 0, H, 0, 0))
    w = d_inner // n
    local = {k: (v.narrow(0, r * w, w) if k == "out_proj"
                 else v.narrow(-1, r * w, w)).contiguous()
             for k, v in t.items()}
    with pshard.model_parallel(group, n, r):
        o, g = run(local, MB._Split(True, r * H // n, H // n, 0, 0))
    errs = {k: float((g[k] - (v.narrow(0, r * w, w) if k == "out_proj"
                               else v.narrow(-1, r * w, w))).abs().max())
            / float(v.abs().max()) for k, v in g_one.items()}
    errs["out"] = float((o - o_one).abs().max()) / float(o_one.abs().max())
    out["local/mamba_norm_rel_err"] = np.array([errs[k]
                                                for k in sorted(errs)])
    out["local/mamba_norm_names"] = np.array(sorted(errs), dtype=object)


def run_single(out, inp):
    """Each case's 2 `build_sharded_train_step` steps on the (1, 1) mesh
    against the one-device `build_train_step` on the same batches:
    `torch.equal` of every metric and every leaf after each step."""
    mesh = make_host_mesh(1, 1, device_type="cpu")
    for name, case in inp["cases"].items():
        cfg, params = _setup(case)
        api, opt = build_api(cfg), AdamW(**case["opt"])
        pspecs = SH.param_specs(params, cfg, mesh)
        state = SH.distribute_tree(ST.TrainState(params, opt.init(params)),
                                   mesh, ST.state_specs(pspecs))
        step = ST.build_sharded_train_step(api, opt, mesh, pspecs)
        _, params1 = _setup(case)
        one_state = ST.TrainState(params1, opt.init(params1))
        one = ST.build_train_step(api, opt)
        equal = []
        for b in case["batches"]:
            state, m = step(state, _batch(b))
            one_state, m1 = one(one_state, _batch(b))
            equal += [torch.equal(m[k], m1[k]) for k in sorted(m1)]
            equal += [torch.equal(p.to_local(), q) for p, q in
                      zip(leaves(state.params), leaves(one_state.params))]
        out[f"single/{name}"] = np.array(equal)


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, inputs, out_dir = sys.argv[3], sys.argv[4], sys.argv[5]
    torch.set_num_threads(2)
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = {}
    if world == 1:  # the (1, 1) mesh against the one-device step
        # one thread: a multi-threaded CPU backward sums some gradients in
        # an order that varies from run to run (seamless's tied embedding
        # differed by 7.5e-9 between two one-device runs on 8 threads)
        torch.set_num_threads(1)
        run_single(out, inp)
        np.savez(os.path.join(out_dir, "single.npz"), **out)
        dist.destroy_process_group()
        return
    meshes = {}
    for data, model in inp["meshes"]:
        mesh = make_host_mesh(data, model, device_type="cpu")
        meshes[(data, model)] = mesh
        for name, case in inp["cases"].items():
            run_case(out, f"{data}x{model}/{name}", case, mesh, rank)
    check_operators(out, meshes[(2, 2)])
    if inp.get("moe_case"):
        moe = inp["cases"][inp["moe_case"]]
        check_local_layers(out, moe, meshes[(2, 2)])
        check_moe_backward(out, moe, meshes[(2, 2)])
    if inp.get("mamba_case"):
        check_mamba_norm(out, inp["cases"][inp["mamba_case"]],
                         meshes[(1, 4)])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
