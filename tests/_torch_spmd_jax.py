"""The reference's multi-device train steps on forced host devices, for the
port's SPMD checks.

  python tests/_torch_spmd_jax.py INPUTS OUT.npz

INPUTS is the pickle of cases `test_torch_spmd_train.py` makes.  Runs
`jax.jit(build_train_step, in_shardings=...)` on a 2x2 (data, model) mesh
and `build_compressed_dp_step` (shard_map) on a 4x1 mesh over 4 forced host
devices; the flag must precede the jax import, hence a process of its own.
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.launch import sharding as SH  # noqa: E402
from repro.launch.mesh import (_axis_type_kwargs, jit_shardings,  # noqa: E402
                               mesh_context)
from repro.launch.steps import (TrainState, build_compressed_dp_step,  # noqa
                                build_train_step)
from repro.models.api import build_api  # noqa: E402
from repro.optim.adamw import AdamW  # noqa: E402


def _setup(case):
    cfg = get_config(case["arch"]).smoke().replace(**case["replace"])
    params = jax.tree.map(jnp.asarray, case["params"])
    return cfg, build_api(cfg), params, AdamW(**case["opt"])


def main():
    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    out = {}
    mesh = jax.make_mesh((2, 2), ("data", "model"), **_axis_type_kwargs(2))
    for name, case in inp["sharded"].items():
        cfg, api, params, opt = _setup(case)
        state = TrainState(params, opt.init(params))
        pspecs = SH.param_specs(params, cfg, mesh)
        sspecs = TrainState(pspecs, type(state.opt)(P(), pspecs, pspecs))
        bspecs = SH.batch_specs(case["batches"][0], mesh)
        with mesh_context(mesh):
            step = jax.jit(build_train_step(api, opt), in_shardings=(
                jit_shardings(mesh, (sspecs, bspecs))))
            for i, b in enumerate(case["batches"]):
                state, metrics = step(state, jax.tree.map(jnp.asarray, b))
                # uncommitted again: jit's output shardings are its own
                state = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                                     state)
                for k, v in metrics.items():
                    out[f"{name}/metrics{i}/{k}"] = np.asarray(v)
        for i, p in enumerate(jax.tree.leaves(state.params)):
            out[f"{name}/p{i:04d}"] = np.asarray(p)

    case = inp["compressed"]
    cfg, api, params, opt = _setup(case)
    mesh4 = jax.make_mesh((4, 1), ("data", "model"), **_axis_type_kwargs(2))
    state = TrainState(params, opt.init(params))
    res = jax.tree.map(lambda p: jnp.zeros((4,) + p.shape, jnp.float32),
                       params)
    step = jax.jit(build_compressed_dp_step(api, opt, mesh4, "data"))
    for i, b in enumerate(case["batches"]):
        state, res, loss = step(state, res, jax.tree.map(jnp.asarray, b))
        out[f"compressed/loss{i}"] = np.asarray(loss)
    for i, (p, r) in enumerate(zip(jax.tree.leaves(state.params),
                                   jax.tree.leaves(res))):
        out[f"compressed/p{i:04d}"] = np.asarray(p)
        out[f"compressed/r{i:04d}"] = np.asarray(r)
    np.savez(sys.argv[2], **out)


if __name__ == "__main__":
    main()
