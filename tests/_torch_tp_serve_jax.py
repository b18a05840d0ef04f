"""The reference's prefill and decode steps on forced host devices, for the
port's mesh serving checks.

  python tests/_torch_tp_serve_jax.py INPUTS OUT.npz

INPUTS is the pickle of runs `test_torch_tp_serve.py` makes.  For each run
on its (data, model) mesh over 4 forced host devices: `jax.jit(api.prefill)`
with `max_len` closed over, under `in_shardings` (the param specs and the
batch specs), then `jax.jit(api.decode, in_shardings=(param specs, cache
specs, batch specs))` for each of the run's decode tokens, the caches made
uncommitted before each call (jit's output shardings are its own).  Writes
the logits of every step and every cache leaf after the prefill and after
the last decode step.  The flag must precede the jax import, hence a process
of its own.
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.launch import sharding as SH  # noqa: E402
from repro.launch.mesh import (_axis_type_kwargs, jit_shardings,  # noqa: E402
                               mesh_context)
from repro.models.api import build_api  # noqa: E402


def _uncommitted(tree):
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), tree)


def main():
    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    out = {}
    for tag, run in inp["runs"].items():
        case = inp["cases"][run["case"]]
        data, model = run["mesh"]
        mesh = jax.make_mesh((data, model), ("data", "model"),
                             **_axis_type_kwargs(2))
        cfg = get_config(case["arch"]).smoke().replace(**case["replace"])
        api = build_api(cfg)
        params = jax.tree.map(jnp.asarray, case["params"])
        batch = jax.tree.map(jnp.asarray, run["batch"])
        B = run["tokens"].shape[1]
        max_len = inp["max_len"]
        pspecs = SH.param_specs(params, cfg, mesh)
        with mesh_context(mesh):
            prefill = jax.jit(
                lambda p, b: api.prefill(p, dict(b, max_len=max_len)),
                in_shardings=jit_shardings(
                    mesh, (pspecs, SH.batch_specs(batch, mesh))))
            logits, caches = prefill(params, batch)
            caches = _uncommitted(caches)
            out[f"{tag}/logits0"] = np.asarray(logits)
            for i, c in enumerate(jax.tree.leaves(caches)):
                out[f"{tag}/prefill/c{i:03d}"] = np.asarray(c)
            tok = {"token": jnp.asarray(run["tokens"][0])}
            decode = jax.jit(api.decode, in_shardings=jit_shardings(
                mesh, (pspecs, SH.cache_specs(caches, cfg, B, mesh),
                       SH.batch_specs(tok, mesh))))
            for s, t in enumerate(run["tokens"]):
                logits, caches = decode(params, caches,
                                        {"token": jnp.asarray(t)})
                caches = _uncommitted(caches)
                out[f"{tag}/logits{s + 1}"] = np.asarray(logits)
            for i, c in enumerate(jax.tree.leaves(caches)):
                out[f"{tag}/final/c{i:03d}"] = np.asarray(c)
    np.savez(sys.argv[2], **out)


if __name__ == "__main__":
    main()
