"""The port's training substrates against the reference's: AdamW, int8
compression, the data pipeline, checkpointing and the resilient trainer
(mirrors tests/test_substrates.py, plus parity with `repro.*` on shared
inputs)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.compress import compress_with_feedback as j_compress
from repro.optim.compress import quantize_int8 as j_quantize
from repro_torch.bridge import opt_state_from_numpy, opt_state_to_numpy
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, TokenPipeline, pipeline_for
from repro_torch.optim.adamw import AdamW, global_norm
from repro_torch.optim.compress import (compress_with_feedback,
                                        dequantize_int8, init_residuals,
                                        quantize_int8)
from repro_torch.runtime.fault_tolerance import NodeFailure, ResilientTrainer
from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten

# ------------------------------------------------------------------- adamw


def test_adamw_optimizes_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 1e-2
    assert int(state.step) == 200


def test_grad_clipping_bounds_update():
    opt = AdamW(lr=1.0, clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    new_params, _ = opt.update({"w": torch.full((4,), 1e6)}, state, params)
    assert float(new_params["w"].abs().max()) < 100.0


def test_adamw_moments_fp32_params_keep_dtype():
    opt = AdamW()
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state.m["w"].dtype == state.v["w"].dtype == torch.float32
    opt.update({"w": torch.ones(4, dtype=torch.bfloat16)}, state, params)
    assert params["w"].dtype == torch.bfloat16


def _tree_grads(rng, scale):
    return {"a": rng.standard_normal((6, 5)).astype(np.float32) * scale,
            "b": [rng.standard_normal((7,)).astype(np.float32) * scale,
                  rng.standard_normal((3, 2)).astype(np.float32) * scale]}


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2),                                        # clip bites
    dict(lr=3e-3, warmup_steps=3, weight_decay=0.1, clip_norm=None),
    dict(lr=1e-3, warmup_steps=10, weight_decay=0.01, clip_norm=0.5),
])
def test_adamw_update_matches_the_reference(kw):
    """Five steps of AdamW.update on the same gradients (numpy, shared), the
    state carried by each side: params, m and v within 1e-6 relative (fp32
    rounding: the port updates in place, in the reference's order, with the
    clip norm summed leaf by leaf), step exact.  Held on shared gradients,
    not through a train step: at step 1 the update is lr * sign(g), which a
    gradient near 0 may flip across frameworks."""
    rng = np.random.default_rng(0)
    p0 = _tree_grads(rng, 1.0)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    p = tree_map(torch.from_numpy, jax.tree.map(np.copy, p0))
    s = opt.init(p)
    for _ in range(5):
        g = _tree_grads(rng, 3.0)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        p, s = opt.update(tree_map(torch.from_numpy, g), s, p)
    got = (p, *opt_state_to_numpy(s)[1:])
    want = (jp, js.m, js.v)
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert int(s.step) == int(js.step) == 5


def test_opt_state_bridge_round_trip():
    """The reference's (step, m, v) into the port's OptState and back,
    exact; the moments fp32 whatever the params' dtype."""
    rng = np.random.default_rng(1)
    state = (np.int32(7), _tree_grads(rng, 1.0), _tree_grads(rng, 2.0))
    s = opt_state_from_numpy(state, "cpu")
    assert s.step.dtype == torch.int32 and int(s.step) == 7
    assert all(x.dtype == torch.float32 for x in leaves(s.m) + leaves(s.v))
    back = opt_state_to_numpy(s)
    assert int(back[0]) == 7
    for a, b in zip(jax.tree.leaves(back[1:]), jax.tree.leaves(state[1:])):
        np.testing.assert_array_equal(a, b)


def test_global_norm_matches_the_reference():
    from repro.optim.adamw import global_norm as j_global_norm
    g = _tree_grads(np.random.default_rng(2), 1.0)
    np.testing.assert_allclose(
        float(global_norm(tree_map(torch.from_numpy, g))),
        float(j_global_norm(jax.tree.map(jnp.asarray, g))), rtol=1e-6)


# ------------------------------------------------------------- compression


def test_int8_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(128)
                         .astype(np.float32))
    q, s = quantize_int8(x)
    assert q.dtype == torch.int8
    assert float((dequantize_int8(q, s) - x).abs().max()) <= \
        float(s) * 0.51 + 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_functions_bit_equal_the_reference(seed):
    """quantize_int8 and compress_with_feedback give the reference's bits:
    q, scale and the new residual (the same fp32 ops, round half to even)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((33, 17)).astype(np.float32) * 0.01
    r = rng.standard_normal((33, 17)).astype(np.float32) * 1e-4
    q, s = quantize_int8(torch.from_numpy(g))
    jq, js = j_quantize(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    q, s, nr = compress_with_feedback(torch.from_numpy(g), torch.from_numpy(r))
    jq, js, jnr = j_compress(jnp.asarray(g), jnp.asarray(r))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(nr.numpy(), np.asarray(jnr))


def test_error_feedback_preserves_signal():
    """Sum of dequantized updates + final residual == sum of raw grads."""
    grads = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (20, 64)).astype(np.float32) * 0.01)
    residual = init_residuals({"g": grads[0]})["g"]
    total = torch.zeros(64)
    for g in grads:
        q, s, residual = compress_with_feedback(g, residual)
        total = total + dequantize_int8(q, s)
    np.testing.assert_allclose((total + residual).numpy(),
                               grads.sum(0).numpy(), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ data pipeline


def test_pipeline_deterministic():
    p = TokenPipeline(DataConfig(seq_len=32, global_batch=4, vocab_size=100),
                      device="cpu")
    b1, b2 = p.batch(7), p.batch(7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], p.batch(8)["tokens"])


def test_pipeline_labels_are_next_tokens():
    p = TokenPipeline(DataConfig(seq_len=32, global_batch=4, vocab_size=100,
                                 copy_fraction=0.0), device="cpu")
    b = p.batch(0)
    assert b["tokens"].shape == b["labels"].shape == (4, 32)
    assert b["tokens"].dtype == torch.int32
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_shards_partition_batch():
    p = TokenPipeline(DataConfig(seq_len=16, global_batch=8, vocab_size=50),
                      device="cpu")
    shards = [p.batch(3, shard=i, num_shards=4) for i in range(4)]
    assert all(s["tokens"].shape == (2, 16) for s in shards)
    assert not torch.equal(shards[0]["tokens"], shards[1]["tokens"])


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_pipeline_bit_equal_to_the_reference(num_shards):
    """Every shard of several steps: the reference's numpy tokens and
    labels, bit for bit (the same generator streams)."""
    dc = dict(seq_len=24, global_batch=8, vocab_size=300, seed=5)
    mine = TokenPipeline(DataConfig(**dc), device="cpu")
    ref = JTokenPipeline(JDataConfig(**dc))
    for step in (0, 1, 7, 1000):
        for shard in range(num_shards):
            got = mine.batch(step, shard, num_shards)
            want = ref.batch(step, shard, num_shards)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_pipeline_for_matches_the_reference():
    from repro.configs import get_config as jget
    from repro.data.pipeline import pipeline_for as jpipeline_for
    from repro_torch.configs import get_config
    cfg = get_config("qwen3_moe_235b_a22b").smoke()
    got = pipeline_for(cfg, 32, 4, seed=3, device="cpu").batch(2)
    want = jpipeline_for(jget("qwen3_moe_235b_a22b").smoke(), 32, 4,
                         seed=3).batch(2)
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])


# ------------------------------------------------------------- checkpoints


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 4), generator=g),
            "b": {"c": torch.arange(6, dtype=torch.int32),
                  "s": torch.tensor(7, dtype=torch.int32),  # 0-d: a step
                  "d": torch.randn((3,), generator=g).to(torch.bfloat16)},
            "e": [torch.randn((2,), generator=g), None]}


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(10, tree, {"step": 10})
    restored = mgr.restore(_zeros_like(tree))
    for a, b in zip(leaves(tree), leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert restored["e"][1] is None
    assert mgr.metadata() == {"step": 10}


def test_checkpoint_bf16_is_lossless_and_manifest_names_it(tmp_path):
    import json
    mgr = CheckpointManager(str(tmp_path))
    t = {"w": torch.randn(64, dtype=torch.float32).to(torch.bfloat16)}
    path = mgr.save(1, t)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["dtypes"] == ["bfloat16"]
    assert manifest["shapes"] == [[64]]
    assert torch.equal(mgr.restore(_zeros_like(t))["w"], t["w"])


def test_checkpoint_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_no_tmp_left_behind(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    bad = _zeros_like(_tree())
    bad["a"] = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(bad)


def test_tree_helpers_round_trip():
    tree = _tree()
    paths = [p for p, _ in leaves_with_paths(tree)]
    assert paths == [("a",), ("b", "c"), ("b", "d"), ("b", "s"), ("e", 0)]
    back = unflatten(tree, leaves(tree))
    assert back["e"][1] is None and back["b"]["c"] is tree["b"]["c"]


# --------------------------------------------------------- fault tolerance


class _Pipe:
    def batch(self, step):
        return {"step": step}


def test_resilient_trainer_recovers_from_failure(tmp_path):
    calls = []

    def train_step(state, batch):
        calls.append(batch["step"])
        return {"x": state["x"] + 1}, {"loss": state["x"]}

    trainer = ResilientTrainer(train_step, _Pipe(),
                               CheckpointManager(str(tmp_path)), ckpt_every=5)
    state, step, _ = trainer.run({"x": torch.zeros(())}, num_steps=20,
                                 inject_failure_at=12)
    assert step == 20
    assert float(state["x"]) == 20  # steps 10..12 replayed after restore
    assert calls[:12] == list(range(12)) and calls[12:15] == [10, 11, 12]


def test_resilient_trainer_lets_other_errors_through(tmp_path):
    """A RuntimeError that is not a NodeFailure (a CUDA error, a kernel that
    fails to build or launch) propagates: no restore hides it."""
    def train_step(state, batch):
        if batch["step"] == 3:
            raise RuntimeError("flash_attention: kernel launch failed")
        return state, {}

    trainer = ResilientTrainer(train_step, _Pipe(),
                               CheckpointManager(str(tmp_path)), ckpt_every=1)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        trainer.run({"x": torch.zeros(())}, num_steps=6)
    assert issubclass(NodeFailure, RuntimeError)
