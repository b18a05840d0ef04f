"""One rank of the port's mesh serving checks on a gloo process group (CPU).

  python tests/_torch_tp_serve_worker.py RANK WORLD STORE_FILE INPUTS OUT_DIR

Rendezvous through a `FileStore` at STORE_FILE.  INPUTS is the pickle of
runs `test_torch_tp_serve.py` makes.  With WORLD 4, for each run on its
(data, model) mesh: `build_sharded_prefill_step` on the run's batch, then
`build_sharded_decode_step` for each of its tokens; the rank writes its
logits of every step, its cache shards after the prefill and after the
last step with the slices of the whole caches they are, the global KV
slots each decode step changed in its shards, the q heads each flash call
got, and what reached the kernels' wrappers, to OUT_DIR/rank{RANK}.npz.
With WORLD 1, on the (1, 1) mesh: the two steps against the one-device
`api.prefill` / `api.decode` (`torch.equal`), to OUT_DIR/single.npz.
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
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.api import build_api  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402


def _setup(case, mesh):
    cfg = get_config(case["arch"]).smoke().replace(**case["replace"])
    params = params_from_numpy(case["params"], cfg, "cpu")
    api = build_api(cfg)
    pspecs = SH.param_specs(params, cfg, mesh)
    return cfg, api, params, pspecs


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


class _Wrappers:
    """Records the calls of the kernels' wrappers: their count, the q heads
    of each flash call, and any argument that is not a plain contiguous
    tensor."""

    def __init__(self):
        self.calls, self.bad, self.flash_heads = {}, [], set()

    def wrap(self, name, fn):
        from torch.distributed.tensor import DTensor

        def inner(*args, **kwargs):
            self.calls[name] = self.calls.get(name, 0) + 1
            if name == "flash_attention":
                self.flash_heads.add(int(args[0].shape[2]))
            for a in list(args) + list(kwargs.values()):
                if isinstance(a, torch.Tensor) and (
                        isinstance(a, DTensor) or type(a) is not torch.Tensor
                        or not a.is_contiguous()):
                    self.bad.append(f"{name}: {type(a).__name__} "
                                    f"{tuple(a.shape)} {a.stride()}")
            return fn(*args, **kwargs)
        return inner

    def __enter__(self):
        self.real = (A.mha_flash, M.kernel_moe_dispatch, M.kernel_moe_combine)
        A.mha_flash = self.wrap("flash_attention", self.real[0])
        M.kernel_moe_dispatch = self.wrap("dispatch_scatter", self.real[1])
        M.kernel_moe_combine = self.wrap("combine_gather", self.real[2])
        return self

    def __exit__(self, *exc):
        A.mha_flash, M.kernel_moe_dispatch, M.kernel_moe_combine = self.real


def _changed_slots(before, after, sl) -> list:
    """The global slots (dim -3) of a KV shard whose rows changed."""
    seq_dim = after.dim() - 3
    start = {d: s for d, s, _ in sl}.get(seq_dim, 0)
    diff = (after != before).movedim(seq_dim, 0).reshape(after.shape[seq_dim],
                                                         -1).any(1)
    return [start + int(i) for i in torch.nonzero(diff).flatten()]


def run_mesh(out, tag, run, case, mesh, max_len):
    cfg, api, params, pspecs = _setup(case, mesh)
    dparams = SH.distribute_tree(params, mesh, pspecs)
    batch = _torch(run["batch"])
    coord = mesh.get_coordinate()
    with _Wrappers() as rec:
        logits, caches = ST.build_sharded_prefill_step(
            api, mesh, pspecs, max_len)(dparams, batch)
        out[f"{tag}/logits0"] = logits.numpy()
        like = ST.prefill_caches_like(api, batch, max_len)
        cspecs = ST.prefill_cache_specs(api, mesh, batch, max_len)
        paths = [p for p, _ in leaves_with_paths(caches)]
        for i, (c, s, w) in enumerate(zip(leaves(caches), leaves(cspecs),
                                          leaves(like))):
            out[f"{tag}/prefill/c{i:03d}"] = c.numpy().copy()
            sl = SH.shard_slices(s, tuple(w.shape), mesh, coord)
            out[f"{tag}/slices/c{i:03d}"] = np.array(sl, dtype=np.int64) \
                .reshape(-1, 3)
        kv = [i for i, p in enumerate(paths) if p[-1] in ("k", "v")]
        out[f"{tag}/kv_leaves"] = np.array(kv, dtype=np.int64)
        decode = ST.build_sharded_decode_step(api, mesh, pspecs, cspecs)
        for s, t in enumerate(run["tokens"]):
            before = [c.clone() for c in leaves(caches)]
            logits, again = decode(dparams, caches,
                                   {"token": torch.from_numpy(np.array(t))})
            assert again is caches, "the decode step returned new caches"
            out[f"{tag}/logits{s + 1}"] = logits.numpy()
            for i in kv:
                out[f"{tag}/written{s}/c{i:03d}"] = np.array(_changed_slots(
                    before[i], leaves(caches)[i],
                    out[f"{tag}/slices/c{i:03d}"]), dtype=np.int64)
        for i, c in enumerate(leaves(caches)):
            out[f"{tag}/final/c{i:03d}"] = c.numpy().copy()
    out[f"{tag}/wrapper_calls"] = np.array(
        [rec.calls.get(k, 0) for k in ("flash_attention", "dispatch_scatter",
                                       "combine_gather")])
    out[f"{tag}/wrapper_bad"] = np.array(rec.bad[:20], dtype=object)
    out[f"{tag}/flash_heads"] = np.array(sorted(rec.flash_heads))


def run_single(out, inp, max_len):
    """The (1, 1) mesh's steps against the one-device API, torch.equal."""
    mesh = make_host_mesh(1, 1, device_type="cpu")
    for name, case in inp["cases"].items():
        run = inp["runs"][inp["single"][name]]
        cfg, api, params, pspecs = _setup(case, mesh)
        dparams = SH.distribute_tree(params, mesh, pspecs)
        batch = _torch(run["batch"])
        logits, caches = ST.build_sharded_prefill_step(
            api, mesh, pspecs, max_len)(dparams, batch)
        with torch.no_grad():
            want, ref = api.prefill(params, dict(batch, max_len=max_len))
        equal = [torch.equal(logits, want)] + [
            torch.equal(a, b) for a, b in zip(leaves(caches), leaves(ref))]
        decode = ST.build_sharded_decode_step(
            api, mesh, pspecs, ST.prefill_cache_specs(api, mesh, batch,
                                                      max_len))
        for t in run["tokens"]:
            tok = {"token": torch.from_numpy(np.array(t))}
            logits, caches = decode(dparams, caches, tok)
            with torch.no_grad():
                want, ref = api.decode(params, ref, tok)
            equal += [torch.equal(logits, want)] + [
                torch.equal(a, b) for a, b in zip(leaves(caches),
                                                   leaves(ref))]
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
    if world == 1:
        run_single(out, inp, inp["max_len"])
        name = "single.npz"
    else:
        meshes = {}
        for tag, run in inp["runs"].items():
            shape = tuple(run["mesh"])
            if shape not in meshes:  # every rank builds each mesh once
                meshes[shape] = make_host_mesh(*shape, device_type="cpu")
            run_mesh(out, tag, run, inp["cases"][run["case"]],
                     meshes[shape], inp["max_len"])
        name = f"rank{rank}.npz"
    np.savez(os.path.join(out_dir, name), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
