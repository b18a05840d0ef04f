"""Helpers shared by the tests of the PyTorch port: JAX-side parameters made
once, handed to both packages through numpy."""
import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models.lm import init_lm_params as jax_init_lm_params
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config


def smoke_setup(num_layers=3, num_experts=4, top_k=2, shared=0, seed=0,
                **extra):
    """(jax cfg, jax params, port cfg, port params on the CPU) for the qwen3
    smoke config cut to size (`extra`: more config fields to replace); the
    port's params are the bridged JAX ones."""
    kw = dict(num_layers=num_layers, num_experts=num_experts, top_k=top_k,
              num_shared_experts=shared, **extra)
    jcfg = jax_get_config("qwen3_moe_235b_a22b").smoke().replace(**kw)
    cfg = get_config("qwen3_moe_235b_a22b").smoke().replace(**kw)
    jparams = jax_init_lm_params(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)
