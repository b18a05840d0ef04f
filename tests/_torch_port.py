"""Helpers shared by the tests of the PyTorch port: JAX-side parameters made
once, handed to both packages through numpy."""
import functools

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models.encdec import init_encdec_params as jax_init_encdec_params
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


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed, replace):
    jcfg = jax_get_config(arch).smoke().replace(**dict(replace))
    if jcfg.family in ("dense", "moe"):
        return jcfg, jax_init_lm_params(jax.random.PRNGKey(seed), jcfg)
    # the recurrent, hybrid and encoder-decoder inits, compiled: eager,
    # their nested vmaps dispatch op by op (6 s for zamba2's smoke config)
    init = jax_init_encdec_params if jcfg.family == "encdec" \
        else jax_init_lm_params
    return jcfg, jit(init, cfg=jcfg)(jax.random.PRNGKey(seed))


def jit(fn, **static):
    """The JAX function compiled once with `static` bound: un-jitted, every
    new shape compiles op by op, which dominates a port test's time."""
    return jax.jit(functools.partial(fn, **static))


def family_setup(arch, seed=0, **replace):
    """(jax cfg, jax params, port cfg, port params on the CPU) for `arch`'s
    smoke config (`replace`: more config fields); the port's params are the
    JAX ones, made numpy and bridged."""
    jcfg, jparams = _jax_params(arch, seed, tuple(sorted(replace.items())))
    cfg = get_config(arch).smoke().replace(**replace)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def tree_leaves(tree):
    """Leaves of nested dicts / lists / NamedTuples, dict keys in sorted
    order, so the port's and the reference's caches line up."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def close_trees(got, want, tol):
    """Leaf by leaf (tree_leaves order): same shapes, within `tol`."""
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        close(a, b, tol)


def noisy_constants(params, seed):
    """`params` (a numpy tree) with seeded noise (0.05 N(0, 1)) added to
    each leaf whose elements are all equal, dtype kept."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        t = np.asarray(t)
        if t.size > 1 and np.all(t == t.flat[0]):
            t = (t + 0.05 * rng.standard_normal(t.shape)).astype(t.dtype)
        return t
    return walk(params)
