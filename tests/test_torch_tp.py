"""The port's tensor- and expert-parallel mesh step
(`launch.steps.build_sharded_train_step` on the dense and MoE families:
attention heads, FFN hidden columns, experts and vocab rows computed over
"model", each layer's params gathered over the batch axes inside the layer)
on 4 gloo ranks, held against the reference's GSPMD step
(`jax.jit(build_train_step, in_shardings=...)`) on 4 forced host devices
and against the port's one-device step, on (data, model) meshes 2x2 and
1x4.

Models (smoke configs, fp32): qwen3 (4 experts top-2, dispatch groups 2,
aux 0.01), gemma3 (H 4, KVH 1: K / V computed whole at both meshes, the
local q heads reading their group's kv head; qk norm) and qwen2 (QKV bias;
KVH 2: kv heads split at 2x2, whole at 1x4); [4, 64] tokens, so the
attention takes the flash wrapper (its plain version on the CPU).

One module fixture starts the reference (`_torch_tp_jax.py`, its own
process: the forced-device flag must precede its jax import) and the 4
ranks of `_torch_tp_worker.py` at once, rendezvous through a `FileStore`
under tmp_path, with a join timeout that kills them all.

Tolerances: 5e-5 (relative and absolute) on the params after 2 steps and on
the metrics; each gradient shard within 5e-5 of the one-device gradient's,
relative to the leaf's largest element.  The optimizer's eps is 1e-6 (the
default 1e-8 sits inside the clipped gradients' range): Adam divides each
element by its own gradient's size, so where an element's gradient is at
fp32's rounding floor (an embedding row of a token seen once: -3.5e-7
against a leaf maximum of 0.28, 2e-9 after the clip), any change of
summation order moves its update by a good part of lr -- the reference's
1x4 step moves it 2.0e-5 from the one-device step's, the port's 4.5e-5 the
other way.  Exact where the math is: the MoE layer at model 2 against
model 1, a rank's column-parallel q against the one-device q's heads, the
replicated leaves' gradients across the model ranks, the FLOPs ratio.
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

from _torch_port import close, family_setup

from repro_torch.configs import get_config
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.steps import TrainState, build_train_step
from repro_torch.models.api import build_api
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import leaves, leaves_with_paths

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
TOL = 5e-5
TIMEOUT = 300
WORLD = 4
MESHES = [(2, 2), (1, 4)]
# clip_norm low enough that clipping engages on both steps
OPT = dict(lr=1e-3, clip_norm=0.05, eps=1e-6)
CASES = ["qwen3", "gemma3", "qwen2"]
RUNS = [(f"{d}x{m}", name) for d, m in MESHES for name in CASES]
IDS = [f"{mesh}-{name}" for mesh, name in RUNS]


def _batches(seed, n=2, B=4, S=64, vocab=512):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
            for _ in range(n)]


def _case(arch, seed, **replace):
    _, jparams, _, _ = family_setup(arch, seed=seed, **replace)
    return dict(arch=arch, replace=replace, opt=OPT,
                params=jax.tree.map(np.asarray, jparams),
                batches=_batches(seed + 10))


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
    d = tmp_path_factory.mktemp("tp")
    inp = {"cases": {
        "qwen3": _case("qwen3_moe_235b_a22b", 0, num_layers=2, num_experts=4,
                       top_k=2, dispatch_groups=2),
        "gemma3": _case("gemma3_1b", 1),
        "qwen2": _case("qwen2_1p5b", 2)},
        "meshes": MESHES, "moe_case": "qwen3"}
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)

    def spawn(args):
        return subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    ref = spawn([sys.executable, os.path.join(HERE, "_torch_tp_jax.py"),
                 str(d / "inputs.pkl"), str(d / "ref.npz")])
    workers = [spawn([sys.executable,
                      os.path.join(HERE, "_torch_tp_worker.py"), str(r),
                      str(WORLD), str(d / "store"), str(d / "inputs.pkl"),
                      str(d)]) for r in range(WORLD)]
    results = _wait_all([ref] + workers, TIMEOUT)
    bad = [(i, rc, out[-3000:]) for i, (rc, out) in enumerate(results)
           if rc != 0]
    assert not bad, "\n\n".join(f"process {i} rc={rc}:\n{out}"
                                for i, rc, out in bad)
    return dict(inp=inp, ref=dict(np.load(d / "ref.npz")),
                ranks=[dict(np.load(d / f"rank{r}.npz", allow_pickle=True))
                       for r in range(WORLD)])


def _one_device(case):
    """The port's one-device build_train_step on the case's global batches."""
    from repro_torch.bridge import params_from_numpy
    cfg = get_config(case["arch"]).smoke().replace(**case["replace"])
    params = params_from_numpy(case["params"], cfg, "cpu")
    opt = AdamW(**case["opt"])
    state = TrainState(params, opt.init(params))
    step = build_train_step(build_api(cfg), opt)
    ms = []
    for b in case["batches"]:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        ms.append(m)
    return state, ms


def _param_keys(d: dict, tag: str) -> list:
    return sorted(k for k in d if k.startswith(f"{tag}/p")
                  and k[len(tag) + 2:].isdigit())


def _model_groups(mesh):
    """The ranks of each data row (rank = data * model + model index)."""
    data, model = (int(x) for x in mesh.split("x"))
    return [list(range(i * model, (i + 1) * model)) for i in range(data)]


@pytest.mark.parametrize("mesh,name", RUNS, ids=IDS)
def test_tp_step_matches_reference(runs, mesh, name):
    tag = f"{mesh}/{name}"
    ref = runs["ref"]
    n = len(_param_keys(ref, tag))
    for rr in runs["ranks"]:
        assert n == len(_param_keys(rr, tag)) > 0
        for i in range(n):
            close(rr[f"{tag}/p{i:04d}"], ref[f"{tag}/p{i:04d}"], TOL)
        for s in range(2):
            keys = [k for k in ref if k.startswith(f"{tag}/metrics{s}/")]
            assert {k.split("/")[-1] for k in keys} == {
                "loss", "ce", "load_balance", "grad_norm",
                "dropped_fraction"}
            for k in keys:
                close(rr[k], ref[k], TOL)
            assert float(ref[f"{tag}/metrics{s}/grad_norm"]) \
                > OPT["clip_norm"]
    if name == "qwen3":  # the aux loss is on and routed through the group
        assert float(ref[f"{tag}/metrics0/load_balance"]) > 0


@pytest.mark.parametrize("mesh,name", RUNS, ids=IDS)
def test_tp_step_matches_one_device_step(runs, mesh, name):
    tag = f"{mesh}/{name}"
    state, ms = _one_device(runs["inp"]["cases"][name])
    for rr in runs["ranks"]:
        for i, p in enumerate(leaves(state.params)):
            close(rr[f"{tag}/p{i:04d}"], p.numpy(), TOL)
        for s, m in enumerate(ms):
            for k, v in m.items():
                close(rr[f"{tag}/metrics{s}/{k}"], v.numpy(), TOL)


@pytest.mark.parametrize("mesh,name", RUNS, ids=IDS)
def test_tp_gradients_are_the_one_device_shards(runs, mesh, name):
    """Each rank's gradient of each leaf (what the LeafGathers' backward
    leaves: reduced over the batch axes, divided by their size) is its
    stored shard of the one-device gradient on the global batch."""
    for rr in runs["ranks"]:
        err = rr[f"{mesh}/{name}/grad_rel_err"]
        assert len(err) > 0 and float(err.max()) < TOL, err.max()


@pytest.mark.parametrize("mesh,name", RUNS, ids=IDS)
def test_replicated_leaves_agree_across_model_ranks(runs, mesh, name):
    """The leaves stored whole over "model" (norms, the router, biases,
    a K / V projection that does not split) get the same gradient on every
    rank of a data row -- a reduction's backward that scaled by the
    group's size, or a partial sum left unreduced, would not -- and the
    params gathered after the steps are the same on every rank."""
    tag = f"{mesh}/{name}"
    r = runs["ranks"]
    reps = [k for k in r[0] if k.startswith(f"{tag}/grad_replicated")]
    assert reps
    for group in _model_groups(mesh):
        for k in reps:
            for other in group[1:]:
                np.testing.assert_array_equal(r[other][k], r[group[0]][k])
    for other in r[1:]:
        for k in _param_keys(r[0], tag):
            np.testing.assert_array_equal(other[k], r[0][k])


@pytest.mark.parametrize("mesh,name", RUNS, ids=IDS)
def test_sharded_leaves_matmul_flops_are_one_over_model(runs, mesh, name):
    """The dot FLOPs (launch/op_analysis.py's pricing) of the matmuls on
    the leaves computed over "model" -- forward and input gradient of the
    q / k / v / o projections, the FFN, the experts, the vocab --, on each
    rank, are 1/model of the one-device program's on the same batch
    shard."""
    model = int(mesh.split("x")[1])
    for rr in runs["ranks"]:
        mine, one = rr[f"{mesh}/{name}/flops"]
        assert one > 0 and mine * model == one, (mine, one)
    assert runs["ranks"][0][f"{mesh}/{name}/grad_model_sharded"].any()


@pytest.mark.parametrize("mesh,name", RUNS, ids=IDS)
def test_peak_live_bytes_below_the_gather_everything_step(runs, mesh, name):
    """The step's peak live bytes a rank, below those of the one-device
    step on the rank's batch shard: the program that holds every param
    whole (the mesh steps' gather-everything program was that, plus its
    collectives)."""
    for rr in runs["ranks"]:
        tp, gather_all = rr[f"{mesh}/{name}/peak_live_bytes"]
        assert 0 < tp < gather_all, (tp, gather_all)


@pytest.mark.parametrize("mesh,name", RUNS, ids=IDS)
def test_only_plain_contiguous_tensors_reach_the_wrappers(runs, mesh, name):
    """No DTensor (nor any non-contiguous view) reaches a kernel wrapper;
    the attention runs through the flash wrapper, the MoE layer through
    the dispatch and combine wrappers."""
    for rr in runs["ranks"]:
        assert list(rr[f"{mesh}/{name}/wrapper_bad"]) == []
        flash, dispatch, combine = rr[f"{mesh}/{name}/wrapper_calls"]
        assert flash > 0
        if name == "qwen3":
            assert dispatch > 0 and combine > 0


@pytest.mark.parametrize("op", ["copy", "reduce", "scatter", "gather"])
def test_pshard_operator_matches_its_closed_form(runs, op):
    for rr in runs["ranks"]:
        assert bool(rr[f"operators/{op}"])


def test_moe_layer_at_model_2_equals_model_1(runs):
    for rr in runs["ranks"]:
        assert bool(rr["local/moe_equal"])


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_layer_gradients_at_model_2_match_model_1(runs, shared):
    """fp32: x's, the router's, the rank's experts' and (with a shared
    expert) the rank's share of the shared expert's gradients, and the
    output (the shared expert's row-parallel sum reorders it), within TOL
    of the one-device layer's."""
    for rr in runs["ranks"]:
        names = list(rr[f"local/moe_bwd_names/shared{shared}"])
        errs = rr[f"local/moe_bwd_rel_err/shared{shared}"]
        assert "router" in names and "experts/w_down" in names
        assert ("shared/w_gate" in names) == bool(shared)
        assert float(errs.max()) < TOL, dict(zip(names, errs))


def test_column_parallel_q_is_a_slice_of_the_one_device_q(runs):
    for rr in runs["ranks"]:
        assert bool(rr["local/q_equal"])


# ---------------------------------------------------------------------------
# compute_specs on the production mesh (no process group)
# ---------------------------------------------------------------------------

ARCHS = ["qwen3_moe_235b_a22b", "dbrx_132b", "deepseek_v32", "gemma3_1b",
         "qwen2_1p5b", "olmo_1b", "deepseek_coder_33b", "chameleon_34b",
         "rwkv6_7b", "zamba2_1p2b", "seamless_m4t_large_v2"]
# leaves each family must compute over "model" at 16x16, and leaves it
# must gather there (path suffixes)
KEPT = {"rwkv6_7b": ["time_mix/wr", "time_mix/wk", "time_mix/wv",
                     "time_mix/wg", "time_mix/wo", "time_mix/w_lora_b",
                     "channel_mix/wk", "channel_mix/wv"],
        "zamba2_1p2b": ["mamba/in_proj", "mamba/conv_w", "mamba/out_norm",
                        "mamba/out_proj", "shared_attn/attn/wq",
                        "shared_attn/ffn/w_down"],
        "seamless_m4t_large_v2": ["encoder/attn/wq", "encoder/attn/wo",
                                  "encoder/ffn/w_up", "decoder/attn/wk",
                                  "decoder/cross/wq", "decoder/cross/wv",
                                  "decoder/cross/wo", "decoder/ffn/w_gate"]}
GATHERED = {"zamba2_1p2b": ["shared_attn/in_proj"],
            "seamless_m4t_large_v2": ["embed"]}  # 256206 rows: not by 16
_TIME_MIX = ("wr", "wk", "wv", "wg", "wo", "w_lora_b")
_MAMBA = ("in_proj", "conv_w", "conv_b", "out_norm", "out_proj")


def _fake_params(cfg):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return build_api(cfg).init(torch.Generator())


@pytest.mark.parametrize("arch", ARCHS)
def test_compute_specs_on_the_production_mesh(arch):
    """16x16: no batch axis left; "model" kept where the leaf's spec has it
    and the code computes whole units there -- attention heads (self,
    encoder, cross), RWKV and Mamba heads and channels, FFN columns,
    experts, vocab rows -- else gathered."""
    mesh = AbstractMesh(("data", "model"), (16, 16))
    cfg = get_config(arch)
    params = _fake_params(cfg)
    pspecs = leaves(SH.param_specs(params, cfg, mesh))
    got = {"/".join(SH._path_names(p)): s for (p, _), s in zip(
        leaves_with_paths(params), leaves(SH.compute_specs(params, cfg,
                                                           mesh)))}
    stored = dict(zip(got, pspecs))
    for s, (path, c) in zip(pspecs, got.items()):
        assert len(s) == len(c)
        for e, ce in zip(s, c):
            assert ce in (None, "model")
            if ce is not None:
                assert "model" in SH._axes(e), (path, s, c)
    heads = cfg.num_heads % 16 == 0
    kv = heads and cfg.num_kv_heads % 16 == 0
    for path, c in got.items():
        name = path.split("/")[-1]
        sharded = any(e is not None for e in c)
        has_model = any(e is not None and "model" in SH._axes(e)
                        for e in stored[path])
        if "/time_mix/" in path:
            assert sharded == (name in _TIME_MIX
                               and SH.rwkv_splits(cfg, 16)), (path, c)
        elif "/channel_mix/" in path:
            assert sharded == (name in ("wk", "wv")), (path, c)
        elif "/mamba/" in path:
            assert sharded == (name in _MAMBA
                               and SH.mamba_splits(cfg, 16)), (path, c)
        elif ("/attn/" in path or "/cross/" in path) \
                and name in ("wq", "wo", "bq"):
            assert sharded == heads, (path, c)
        elif ("/attn/" in path or "/cross/" in path) \
                and name in ("wk", "wv", "bk", "bv"):
            assert sharded == kv, (path, c)
        elif name in ("embed", "lm_head") or "experts" in path \
                or name in ("w_gate", "w_up", "w_down"):
            assert sharded == has_model, (path, c)
        else:  # norms, mus, biases, routers, zamba's shared in_proj
            assert not sharded, (path, c)
    for suffix in KEPT.get(arch, []):
        hits = [p for p in got if p.endswith(suffix)]
        assert hits and all(any(e is not None for e in got[p])
                            for p in hits), suffix
    for suffix in GATHERED.get(arch, []):
        hits = [p for p in got if p.endswith(suffix)]
        assert hits and not any(e is not None for p in hits
                                for e in got[p]), suffix
