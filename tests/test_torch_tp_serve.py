"""The port's prefill and decode steps over a mesh
(`launch.steps.build_sharded_prefill_step` / `build_sharded_decode_step`)
on 4 gloo ranks, held against the reference's jitted `api.prefill` and
`api.decode` under `in_shardings` (`_torch_tp_serve_jax.py`) on 4 forced
host devices.

Runs (smoke configs, fp32): prefill [4, 64] with max_len 96, then 8 decode
steps on tokens from a seed, at (data, model) 2x2 and 1x4:
  * qwen3 (MoE, 4 experts top-2, dispatch groups 2; 4 kv heads: the cache
    split over heads at both meshes);
  * gemma3 (1 kv head: the cache split over the sequence, split-K decode,
    on its window-16 ring buffers and its global caches);
  * qwen2 (2 kv heads: over heads at 2x2, over the sequence at 1x4);
  * gemma3 at batch 1 on 2x2 (the batch does not shard: the sequence over
    data and model);
  * zamba2, rwkv6 and seamless at 2x2 and 1x4, over "model" like the
    others: zamba2's 16 SSD heads and its shared block's 4 heads split, its
    conv rings in chunks of 144 / 72 channels that are not its heads' (8
    decode steps outlast the W-1 = 3 slots of a ring); rwkv6's 2 wkv heads
    split at 2x2 and whole at 1x4 (its time mix gathered there, its channel
    mix split), and with 32-wide heads (rwkv6_h4: 4 heads) split at 1x4
    too; seamless's encoder, decoder and cross attention heads.  Their
    constant leaves (zero biases, unit scales, decay and bonus vectors)
    get seeded noise first, so a leaf read at the wrong channels shows.
One module fixture starts the reference, the 4 ranks of
`_torch_tp_serve_worker.py` and a rank of a world of 1 (the (1, 1) mesh)
at once, rendezvous through `FileStore`s under tmp_path, with a join
timeout that kills them all.

Tolerances: 5e-5, relative and absolute, on every step's logits (the
rank's batch shard) and on each rank's cache shards after the prefill and
after the last step (the reference's caches sliced as the rank's spec
shards them); lengths exact; the (1, 1) mesh `torch.equal` to one device.
The split-K merge is also held in one process against one softmax over the
whole sequence, and the owner-rank write against the one-device write.
"""
import os
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from _torch_port import close, family_setup, noisy_constants

from repro_torch.configs import get_config
from repro_torch.models import attention as A

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
TOL = 5e-5
TIMEOUT = 300
WORLD = 4
MAX_LEN, S, STEPS = 96, 64, 8
CASES = {
    "qwen3": ("qwen3_moe_235b_a22b", 0, dict(num_layers=2, num_experts=4,
                                             top_k=2, dispatch_groups=2)),
    "gemma3": ("gemma3_1b", 1, {}),
    "qwen2": ("qwen2_1p5b", 2, {}),
    "zamba2": ("zamba2_1p2b", 3, {}),
    "rwkv6": ("rwkv6_7b", 4, {}),
    "seamless": ("seamless_m4t_large_v2", 5, {}),
    "rwkv6_h4": ("rwkv6_7b", 6, dict(ssm_head_dim=32)),
}
FAMILIES = ("zamba2", "rwkv6", "seamless")
# tag: (mesh, case, batch)
RUNS = {f"{d}x{m}/{c}": ((d, m), c, 4) for d, m in ((2, 2), (1, 4))
        for c in ("qwen3", "gemma3", "qwen2")}
RUNS.update({"2x2/gemma3_b1": ((2, 2), "gemma3", 1)})
RUNS.update({f"{d}x{m}/{c}": ((d, m), c, 4) for d, m in ((2, 2), (1, 4))
             for c in FAMILIES})
RUNS.update({"1x4/rwkv6_h4": ((1, 4), "rwkv6_h4", 4)})
TP_RUNS = [t for t, (_, c, _) in RUNS.items() if not c.startswith("rwkv6")]
# the runs whose caches split over the sequence (kv heads < model, or a
# batch that does not shard)
SEQ_RUNS = ["2x2/gemma3", "1x4/gemma3", "1x4/qwen2", "2x2/gemma3_b1"]


def _batch(arch, seed, B):
    rng = np.random.default_rng(seed)
    cfg = get_config(arch).smoke()
    if cfg.family == "encdec":
        return {"enc_embeddings": rng.standard_normal(
                    (B, S, cfg.d_model)).astype(np.float32),
                "dec_tokens": rng.integers(0, cfg.vocab_size,
                                           (B, S)).astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   (B, S)).astype(np.int32)}


def _inputs():
    cases = {}
    for name, (arch, seed, replace) in CASES.items():
        _, jparams, _, _ = family_setup(arch, seed=seed, **replace)
        params = jax.tree.map(np.asarray, jparams)
        if name not in ("qwen3", "gemma3", "qwen2"):
            params = noisy_constants(params, seed + 100)
        cases[name] = dict(arch=arch, replace=replace, params=params)
    runs = {}
    for tag, (mesh, case, B) in RUNS.items():
        arch, seed, _ = CASES[case]
        rng = np.random.default_rng(seed + 20 + B)
        runs[tag] = dict(mesh=mesh, case=case,
                         batch=_batch(arch, seed + 10 + B, B),
                         tokens=rng.integers(0, 512, (STEPS, B)).astype(
                             np.int32))
    # the (1, 1) mesh runs each case on its first run's inputs
    single = {c: next(t for t, (_, case, _) in RUNS.items() if case == c)
              for c in CASES}
    return dict(cases=cases, runs=runs, max_len=MAX_LEN, single=single)


def _wait_all(procs, timeout):
    """(returncode, output) of each process; all killed at the timeout."""
    end = time.time() + timeout
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, end - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            outs.append((None, out))
            continue
        outs.append((p.returncode, out))
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.distributed as dist
    if not dist.is_available():
        pytest.fail("torch.distributed is not available")
    d = tmp_path_factory.mktemp("tp_serve")
    inp = _inputs()
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)

    def spawn(args):
        return subprocess.Popen([sys.executable] + args, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    worker = os.path.join(HERE, "_torch_tp_serve_worker.py")
    procs = [spawn([os.path.join(HERE, "_torch_tp_serve_jax.py"),
                    str(d / "inputs.pkl"), str(d / "ref.npz")])]
    procs += [spawn([worker, str(r), str(WORLD), str(d / "store"),
                     str(d / "inputs.pkl"), str(d)]) for r in range(WORLD)]
    procs.append(spawn([worker, "0", "1", str(d / "store1"),
                        str(d / "inputs.pkl"), str(d)]))
    results = _wait_all(procs, TIMEOUT)
    bad = [(i, rc, out[-3000:]) for i, (rc, out) in enumerate(results)
           if rc != 0]
    assert not bad, "\n\n".join(f"process {i} rc={rc}:\n{out}"
                                for i, rc, out in bad)
    return dict(inp=inp, ref=dict(np.load(d / "ref.npz")),
                single=dict(np.load(d / "single.npz")),
                ranks=[dict(np.load(d / f"rank{r}.npz", allow_pickle=True))
                       for r in range(WORLD)])


def _rank_slice(whole, sl):
    """The shard of `whole` at the worker's (dim, start, size) slices."""
    for dim, start, size in sl:
        whole = np.take(whole, np.arange(start, start + size), axis=dim)
    return whole


def _batch_rows(tag, rank):
    """This rank's rows of the run's batch (rank = data * model + m)."""
    (data, model), _, B = RUNS[tag]
    if B % data:
        return np.arange(B)
    n = B // data
    return np.arange(n) + (rank // model) * n


@pytest.mark.parametrize("tag", list(RUNS))
def test_logits_of_every_step_match_the_reference(runs, tag):
    ref = runs["ref"]
    for r, rr in enumerate(runs["ranks"]):
        rows = _batch_rows(tag, r)
        for s in range(STEPS + 1):
            close(rr[f"{tag}/logits{s}"], ref[f"{tag}/logits{s}"][rows], TOL)


@pytest.mark.parametrize("tag", list(RUNS))
def test_cache_shards_match_the_reference(runs, tag):
    """Each rank's shard of every cache leaf after the prefill and after
    the last decode step is its slice of the reference's cache; the
    lengths exact."""
    ref = runs["ref"]
    n = len([k for k in ref if k.startswith(f"{tag}/final/")])
    assert n > 0
    for rr in runs["ranks"]:
        for when in ("prefill", "final"):
            for i in range(n):
                key = f"{tag}/{when}/c{i:03d}"
                want = _rank_slice(ref[key], rr[f"{tag}/slices/c{i:03d}"])
                got = rr[key]
                assert got.shape == want.shape, (key, got.shape, want.shape)
                if np.issubdtype(want.dtype, np.integer):
                    np.testing.assert_array_equal(got, want)
                else:
                    close(got, want, TOL)


@pytest.mark.parametrize("tag", SEQ_RUNS)
def test_sequence_split_decode_writes_each_token_on_one_rank(runs, tag):
    """Where a KV cache is split over the sequence, each decode step's new
    token lands in exactly one rank's shard among the ranks holding the
    same batch rows and heads, at the reference's slot: a ring's
    `length % size`, a full layer's `min(length, size - 1)`."""
    ref, ranks = runs["ref"], runs["ranks"]
    kv = list(ranks[0][f"{tag}/kv_leaves"])
    split = 0
    for i in kv:
        size = ref[f"{tag}/final/c{i:03d}"].shape[-3]
        ring = size == get_config("gemma3_1b").smoke().window_size
        seq_dim = ref[f"{tag}/final/c{i:03d}"].ndim - 3
        groups = {}
        for r, rr in enumerate(ranks):
            other = tuple(tuple(x) for x in rr[f"{tag}/slices/c{i:03d}"]
                          if x[0] != seq_dim)
            groups.setdefault(other, []).append(r)
        split += any(len(g) > 1 for g in groups.values())
        for s in range(STEPS):
            length = S + s
            want = length % size if ring else min(length, size - 1)
            for group in groups.values():
                wrote = {r: list(ranks[r][f"{tag}/written{s}/c{i:03d}"])
                         for r in group}
                assert sorted(x for w in wrote.values() for x in w) \
                    == [want], (i, s, wrote)
    assert split, "no KV cache split over the sequence"


@pytest.mark.parametrize("tag", TP_RUNS)
def test_flash_runs_on_the_local_heads(runs, tag):
    """The prefill's flash calls get the rank's q heads (H / model: zamba2's
    shared block, seamless's decoder self attention too), and no DTensor
    nor non-contiguous view reaches a kernel wrapper; qwen3's MoE layers go
    through the dispatch and combine wrappers."""
    (_, model), case, _ = RUNS[tag]
    H = get_config(CASES[case][0]).smoke().num_heads
    for rr in runs["ranks"]:
        assert list(rr[f"{tag}/wrapper_bad"]) == []
        assert list(rr[f"{tag}/flash_heads"]) == [H // model]
        flash, dispatch, combine = rr[f"{tag}/wrapper_calls"]
        assert flash > 0
        if case == "qwen3":
            assert dispatch > 0 and combine > 0


@pytest.mark.parametrize("case", list(CASES))
def test_single_rank_mesh_equals_one_device(runs, case):
    equal = runs["single"][f"single/{case}"]
    assert len(equal) > 2 and equal.all(), equal


# ---------------------------------------------------------------------------
# In one process: the split-K merge and the owner-rank write
# ---------------------------------------------------------------------------


def _stacked():
    """Elementwise reductions over the shards stacked on dim 0."""
    return (lambda t: t.amax(0, keepdim=True).expand_as(t),
            lambda t: t.sum(0, keepdim=True).expand_as(t))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("softcap", [None, 5.0])
def test_split_k_merge_matches_one_softmax(n, softcap):
    """Scores of grouped queries against a sequence split into n shards
    (the keys of shard i its slots [i S/n, (i + 1) S/n)), masked, merged
    by `_merge_split_k`, against one softmax over the whole sequence: the
    one-device decode's arithmetic."""
    cfg = get_config("gemma3_1b").smoke().replace(logit_softcap=softcap)
    g = torch.Generator().manual_seed(n)
    B, KVH, G, Sk, hd = 2, 2, 3, 24, cfg.head_dim
    q = torch.randn(B, KVH, G, hd, generator=g)
    k = torch.randn(B, Sk, KVH, hd, generator=g) * 3
    v = torch.randn(B, Sk, KVH, hd, generator=g)
    valid = torch.arange(Sk) < 17  # shard n - 1 holds no valid slot
    s = A._decode_scores(q, k, valid, cfg)
    want = torch.einsum("bhgs,bshd->bhgd",
                        torch.softmax(s, -1).to(v.dtype), v)
    ks = torch.stack(k.chunk(n, 1))
    vs = torch.stack(v.chunk(n, 1))
    got = A._merge_split_k(A._decode_scores(q, ks, torch.stack(
        valid.chunk(n)), cfg), vs, *_stacked())
    for i in range(n):
        close(got[i], want, 1e-6)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("slot", [0, 5, 11, 23])
def test_owner_write_lands_in_one_shard(n, slot):
    """`_owner_write` on each of n shards of a [2, 24, 1, 4] buffer with
    the global slot less the shard's offset: the shards put together equal
    the one-device `index_copy_`, and exactly one shard changed."""
    g = torch.Generator().manual_seed(slot)
    whole = torch.randn(2, 24, 1, 4, generator=g)
    new = torch.randn(2, 1, 1, 4, generator=g)
    want = whole.clone()
    want.index_copy_(1, torch.tensor([slot]), new)
    shards = [c.clone() for c in whole.chunk(n, 1)]
    local = 24 // n
    for i, sh in enumerate(shards):
        A._owner_write(sh, new, torch.tensor(slot - i * local))
    assert torch.equal(torch.cat(shards, 1), want)
    changed = [i for i, (a, b) in enumerate(zip(shards, whole.chunk(n, 1)))
               if not torch.equal(a, b)]
    assert changed == [slot // local]
