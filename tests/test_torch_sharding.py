"""The port's sharding rules (`launch.sharding`, `launch.mesh`,
`models.pshard`, `configs.SHAPES` / `cells`) held to the reference's, leaf
for leaf, on the production meshes (16x16, 2x8x16) and the contracts' 2x4;
the spec -> DTensor placements step on a 4-rank gloo mesh; and the
`moe_shard_constraints` / `attn_dp_constraint` hints, which change no
output.

The meshes here are descriptions (axis names and sizes, as the reference's
own tests describe them); the params, caches and batches are the
reference's `jax.eval_shape` beside the port's fake tensors, so full-size
configs cost no memory.
"""
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_port import close, smoke_setup, t

from repro import configs as jconfigs
from repro.launch import sharding as JSH
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import pshard as jpshard
from repro.models.api import build_api as jbuild_api
from repro_torch import configs
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import attention, moe, pshard
from repro_torch.models.api import build_api
from repro_torch.tree import leaves

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
ALL = configs.ARCHS + configs.EXTRA_ARCHS


class _Mesh:
    """The reference's mesh description: axis names and a shape dict."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x8x16": (("pod", "data", "model"), (2, 8, 16)),
    "2x4": (("data", "model"), (2, 4)),
}


def _meshes(name):
    names, sizes = MESHES[name]
    return _Mesh(names, sizes), AbstractMesh(names, sizes)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(reference param shapes, port fake params) of the full-size arch."""
    jtree = jax.eval_shape(
        lambda: jbuild_api(jconfigs.get_config(arch)).init(
            jax.random.PRNGKey(0)))
    with FakeTensorMode():
        tree = build_api(configs.get_config(arch)).init(torch.Generator())
    return jtree, tree


def _jleaves(specs):
    return jax.tree_util.tree_leaves(specs,
                                     is_leaf=lambda x: isinstance(x, JP))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL)
def test_param_specs_equal_the_reference(arch, mesh):
    jm, m = _meshes(mesh)
    jtree, tree = _trees(arch)
    want = _jleaves(JSH.param_specs(jtree, jconfigs.get_config(arch), jm))
    got = leaves(SH.param_specs(tree, configs.get_config(arch), m))
    assert [tuple(x.shape) for x in leaves(tree)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jtree)]
    assert len(got) == len(want)
    assert all(g == w for g, w in zip(got, want)), \
        [(g, w) for g, w in zip(got, want) if g != w][:5]
    assert any(any(e is not None for e in g) for g in got)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "gemma3_1b",
                                  "zamba2_1p2b", "rwkv6_7b",
                                  "seamless_m4t_large_v2"])
def test_cache_specs_equal_the_reference(arch, mesh):
    jm, m = _meshes(mesh)
    for batch in (16, 1):  # batch over data, and the long-context layout
        jc = jax.eval_shape(lambda: jbuild_api(
            jconfigs.get_config(arch)).make_caches(batch, 64, 63))
        with FakeTensorMode():
            c = build_api(configs.get_config(arch)).make_caches(
                batch, 64, 63, device="cpu")
        want = _jleaves(JSH.cache_specs(jc, jconfigs.get_config(arch),
                                        batch, jm))
        got = leaves(SH.cache_specs(c, configs.get_config(arch), batch, m))
        assert len(got) == len(want) > 0
        assert all(g == w for g, w in zip(got, want)), (batch, got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_equal_the_reference(mesh):
    jm, m = _meshes(mesh)
    for B in (1, 4, 16, 32, 48):
        shapes = {"tokens": (B, 64), "labels": (B, 64),
                  "embeddings": (B, 64, 32), "token": (B,)}
        want = JSH.batch_specs(
            {k: jax.ShapeDtypeStruct(s, jnp.int32)
             for k, s in shapes.items()}, jm)
        got = SH.batch_specs({k: torch.empty(s) for k, s in shapes.items()},
                             m)
        assert got.keys() == want.keys()
        assert all(got[k] == want[k] for k in got), (B, got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dispatch_groups_equal_the_reference(mesh):
    jm, m = _meshes(mesh)
    for tokens in (1, 2, 3, 8, 24, 1024, 256 * 4096, 7):
        assert SH.dispatch_groups_for(m, tokens) == \
            JSH.dispatch_groups_for(jm, tokens)


def test_shapes_and_cells_equal_the_reference():
    assert {k: tuple(vars(v).values()) for k, v in configs.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in jconfigs.SHAPES.items()}
    assert configs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    for extra in (False, True):
        assert configs.cells(extra) == jconfigs.cells(extra)
    for arch in ALL:
        for shape in configs.SHAPES:
            assert configs.cell_supported(arch, shape) == \
                jconfigs.cell_supported(arch, shape)
    assert SH.FSDP_ARCHS == JSH.FSDP_ARCHS


def test_partition_spec_compares_like_the_reference():
    assert SH.P(("data",), None) == JP(("data",), None) == ("data", None)
    assert SH.P(("pod", "data"), "model") == JP(("pod", "data"), "model")
    assert SH.P("data") != JP("model")
    assert len(SH.P(None, "model")) == 2 and SH.P(None, "model")[1] == "model"


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    m = AbstractMesh(("pod", "data", "model"), (2, 8, 16))
    assert SH.placements(SH.P(("pod", "data"), None, "model"), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert SH.placements(SH.P(None), m) == [Replicate()] * 3
    with pytest.raises(ValueError):
        SH.placements(SH.P(("data", "pod")), m)
    # shard (pod 1, data 3) of a dim over ("pod", "data") is chunk 1*8 + 3
    assert SH.shard_slices(SH.P(("pod", "data"), None), (64, 4), m,
                           (1, 3, 5)) == [(0, 44, 4)]


# ---------------------------------------------------------------------------
# pshard
# ---------------------------------------------------------------------------


def test_set_rules_raises_on_an_unknown_axis():
    with pytest.raises(ValueError, match="unknown logical axis"):
        pshard.set_rules(batch="data", sequence="model")
    assert pshard.get_rules() == {}
    with pshard.rules(batch=("data",), experts="model"):
        assert pshard.get_rules() == {"batch": ("data",),
                                      "experts": "model"}
        x = torch.ones(4, 8)
        assert pshard.constrain(x, "batch", None) is x  # a plain tensor
    assert pshard.get_rules() == {}
    assert pshard.KNOWN_LOGICAL_AXES == jpshard.KNOWN_LOGICAL_AXES


MOE_RULES = dict(moe_group="data", experts="model", moe_rows="data",
                 moe_tokens=("data",))


@pytest.mark.parametrize("groups", [1, 2])
def test_moe_shard_constraints_change_no_output(groups):
    jcfg, jparams, cfg, params = smoke_setup(num_experts=8)
    kw = dict(dispatch_groups=groups, capacity_factor=0.5)
    jl = jax.tree.map(lambda a: a[0], jparams["stages"][0])["ffn"]
    from repro_torch.models import lm
    pl = lm.layer_slice(params["stages"][0], 0)["ffn"]
    x = np.random.RandomState(21).randn(48, cfg.d_model).astype(np.float32)
    off, aux_off = moe.moe_forward_capacity(pl, t(x), cfg.replace(**kw))
    with pshard.rules(**MOE_RULES):
        on, aux_on = moe.moe_forward_capacity(
            pl, t(x), cfg.replace(moe_shard_constraints=True, **kw))
    assert torch.equal(on, off)
    for a, b in zip(aux_on, aux_off):
        assert torch.equal(a, b)
    jy, _ = jmoe.moe_forward_capacity(
        jl, jnp.asarray(x), jcfg.replace(moe_shard_constraints=True, **kw))
    close(on, jy, 5e-5)


@pytest.mark.parametrize("grouped", [False, True])
def test_attn_dp_constraint_changes_no_output(grouped):
    _, _, cfg, _ = smoke_setup()
    cfg = cfg.replace(gqa_grouped=grouped, num_kv_heads=2)
    jcfg = jconfigs.get_config("qwen3_moe_235b_a22b").smoke().replace(
        gqa_grouped=grouped, num_kv_heads=2)
    rng = np.random.RandomState(5)
    B, S, hd = 2, 48, cfg.head_dim
    q = rng.randn(B, S, cfg.num_heads, hd).astype(np.float32)
    k = rng.randn(B, S, 2, hd).astype(np.float32)
    v = rng.randn(B, S, 2, hd).astype(np.float32)
    off = attention.chunked_causal_attention(t(q), t(k), t(v), cfg, None, 16)
    with pshard.rules(batch=("data",), heads="model"):
        on = attention.chunked_causal_attention(
            t(q), t(k), t(v), cfg.replace(attn_dp_constraint=True), None, 16)
    assert torch.equal(on, off)
    want = jattn.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jcfg.replace(attn_dp_constraint=True), None, 16)
    close(on, want, 5e-5)


# ---------------------------------------------------------------------------
# placements on a 4-rank gloo mesh
# ---------------------------------------------------------------------------

_GLOO = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import pshard
    from repro_torch.tree import leaves

    rank, store = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    mesh = make_host_mesh(2, 2, device_type="cpu")
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(8, 6, generator=g),
            "b": [torch.randn(4, 4, 2, generator=g),
                  torch.randn(5, generator=g)],
            "c": torch.arange(24.0).reshape(4, 6)}
    specs = {"a": SH.P("data", "model"),
             "b": [SH.P(None, ("data", "model")), SH.P(None)],
             "c": SH.P(("data", "model"), None)}
    dt = SH.distribute_tree(tree, mesh, specs)
    for x, d, s in zip(leaves(tree), leaves(dt), leaves(specs)):
        assert torch.equal(d.full_tensor(), x), s
        ref = distribute_tensor(x, mesh, SH.placements(s, mesh),
                                src_data_rank=None)
        assert torch.equal(d.to_local(), ref.to_local()), s
        assert d.to_local().numel() < x.numel() or all(
            e is None for e in s), s
    with pshard.rules(batch="data", heads="model"):
        h = SH.distribute(torch.randn(4, 3, 8, generator=g), mesh, SH.P())
        c = pshard.constrain(h, "batch", None, "heads")
        assert tuple(c.to_local().shape) == (2, 3, 4)
        assert torch.equal(c.full_tensor(), h.full_tensor())
    print("ok", rank)
    dist.destroy_process_group()
""")


def test_distribute_tree_round_trip_on_four_gloo_ranks(tmp_path):
    script = tmp_path / "gloo_rank.py"
    script.write_text(_GLOO)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp_path / "store")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    assert sorted(o.split()[-1] for o in outs) == ["0", "1", "2", "3"]
