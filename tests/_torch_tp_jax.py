"""The reference's GSPMD train step on forced host devices, for the port's
tensor- and expert-parallel checks.

  python tests/_torch_tp_jax.py INPUTS OUT.npz

INPUTS is the pickle of cases `test_torch_tp.py` makes.  Runs
`jax.jit(build_train_step, in_shardings=...)` with the reference's param
specs on each (data, model) mesh of the pickle over 4 forced host devices;
the flag must precede the jax import, hence a process of its own.
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
from repro.launch.steps import TrainState, build_train_step  # noqa: E402
from repro.models.api import build_api  # noqa: E402
from repro.optim.adamw import AdamW  # noqa: E402


def main():
    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    out = {}
    for data, model in inp["meshes"]:
        mesh = jax.make_mesh((data, model), ("data", "model"),
                             **_axis_type_kwargs(2))
        for name, case in inp["cases"].items():
            tag = f"{data}x{model}/{name}"
            cfg = get_config(case["arch"]).smoke().replace(**case["replace"])
            api, opt = build_api(cfg), AdamW(**case["opt"])
            params = jax.tree.map(jnp.asarray, case["params"])
            state = TrainState(params, opt.init(params))
            pspecs = SH.param_specs(params, cfg, mesh)
            sspecs = TrainState(pspecs, type(state.opt)(P(), pspecs, pspecs))
            bspecs = SH.batch_specs(case["batches"][0], mesh)
            with mesh_context(mesh):
                step = jax.jit(build_train_step(api, opt), in_shardings=(
                    jit_shardings(mesh, (sspecs, bspecs))))
                for i, b in enumerate(case["batches"]):
                    state, metrics = step(state,
                                          jax.tree.map(jnp.asarray, b))
                    # uncommitted again: jit's output shardings are its own
                    state = jax.tree.map(
                        lambda x: jnp.asarray(np.asarray(x)), state)
                    for k, v in metrics.items():
                        out[f"{tag}/metrics{i}/{k}"] = np.asarray(v)
            for i, p in enumerate(jax.tree.leaves(state.params)):
                out[f"{tag}/p{i:04d}"] = np.asarray(p)
    np.savez(sys.argv[2], **out)


if __name__ == "__main__":
    main()
