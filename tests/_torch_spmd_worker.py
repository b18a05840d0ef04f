"""One rank of the port's SPMD checks on a gloo process group (CPU).

  python tests/_torch_spmd_worker.py RANK WORLD STORE_FILE INPUTS OUT_DIR

Rendezvous through a `FileStore` at STORE_FILE.  INPUTS is a pickle of the
cases (`test_torch_spmd_train.py` makes it); each rank writes what it saw
to OUT_DIR/rank{RANK}.npz.  Imports no jax.
"""
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import (TrainState,  # noqa: E402
                                      build_compressed_dp_step,
                                      build_sharded_train_step, state_specs)
from repro_torch.models.api import build_api  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.optim.compress import init_residuals  # noqa: E402
from repro_torch.runtime.fault_tolerance import (elastic_mesh,  # noqa: E402
                                                 reshard_onto)
from repro_torch.tree import leaves  # noqa: E402


def _batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _setup(case):
    cfg = get_config(case["arch"]).smoke().replace(**case["replace"])
    api = build_api(cfg)
    params = params_from_numpy(case["params"], cfg, "cpu")
    opt = AdamW(**case["opt"])
    return cfg, api, params, opt


def _equal_trees(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, inputs, out_dir = sys.argv[3], sys.argv[4], sys.argv[5]
    torch.set_num_threads(2)
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = {}
    mesh = make_host_mesh(2, 2, device_type="cpu")
    saved = None
    for name, case in inp["sharded"].items():
        cfg, api, params, opt = _setup(case)
        pspecs = SH.param_specs(params, cfg, mesh)
        state = SH.distribute_tree(TrainState(params, opt.init(params)), mesh,
                                   state_specs(pspecs))
        step = build_sharded_train_step(api, opt, mesh, pspecs)
        for i, b in enumerate(case["batches"]):
            state, metrics = step(state, _batch(b))
            for k, v in metrics.items():
                out[f"{name}/metrics{i}/{k}"] = v.numpy()
        full = SH.full_tree(state)
        for i, p in enumerate(leaves(full.params)):
            out[f"{name}/p{i:04d}"] = p.numpy()
        out[f"{name}/local_numel"] = np.array(
            sum(p.to_local().numel() for p in leaves(state.params)))
        if name == inp["elastic"]:
            ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"))
            ckpt.save(2, state, {"step": 2})
            saved = (cfg, full)

    # compressed data-parallel step on a (4, 1) mesh
    case = inp["compressed"]
    cfg, api, params, opt = _setup(case)
    mesh4 = make_host_mesh(4, 1, device_type="cpu")
    state = TrainState(params, opt.init(params))
    res = init_residuals(params)
    step = build_compressed_dp_step(api, opt, mesh4, "data")
    for i, b in enumerate(case["batches"]):
        state, res, loss = step(state, res, _batch(b))
        out[f"compressed/loss{i}"] = loss.numpy()
    for i, (p, r) in enumerate(zip(leaves(state.params), leaves(res))):
        out[f"compressed/p{i:04d}"] = p.numpy()
        out[f"compressed/r{i:04d}"] = r.numpy()

    # elastic: rank 3 drops out, the others restore onto a 3x1 mesh
    if rank != 3:
        cfg, full = saved
        mesh3 = elastic_mesh([0, 1, 2], device_type="cpu")
        out["elastic/mesh"] = np.array(mesh3.shape)
        specs3 = state_specs(SH.param_specs(full.params, cfg, mesh3))
        ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"))
        restored = ckpt.restore(full, mesh=mesh3, specs=specs3)
        out["elastic/restore_equal"] = np.array(
            _equal_trees(SH.full_tree(restored), full))
        out["elastic/sharded_leaves"] = np.array(sum(
            any(e is not None for e in s) for s in leaves(specs3)))
        again = reshard_onto(restored, mesh3, specs3)
        out["elastic/reshard_equal"] = np.array(
            _equal_trees(SH.full_tree(again), full))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
