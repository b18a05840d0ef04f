"""The port's tensor-parallel mesh train step for the recurrent, hybrid and
encoder-decoder families (`launch.steps.build_sharded_train_step`: RWKV's
time-mix heads and channel-mix columns, Mamba2's SSD heads and conv
channels, the encoder's, decoder's and cross attention's heads and FFN
columns computed over "model", each layer gathered over the batch axes
inside the layer) on 4 gloo ranks, held against the reference's GSPMD step
(`jax.jit(build_train_step, in_shardings=...)`, `_torch_tp_jax.py`) on 4
forced host devices and against the port's one-device step, on (data,
model) meshes 2x2 and 1x4.

Models (smoke configs, fp32), [4, 64] tokens (seamless: 64 frames and 64
decoder tokens), so the causal attention takes the flash wrapper:
  * rwkv6 with 32-wide heads (4 wkv heads: 2 a rank at 2x2, 1 at 1x4; its
    FSDP spec shards the projections over "data" too);
  * zamba2 (16 SSD heads, in_proj's 560 columns in chunks of 280 / 140
    that do not fall on its parts' borders, conv channels in chunks of
    144 / 72 against 128 / 64 x channels a rank's heads own; the shared
    attention block's 4 heads, its in_proj gathered);
  * seamless (4 heads in the encoder, decoder and cross attention; the
    tied 512-row vocab split over "model").
The leaves the inits make constant (zero biases, unit scales, rwkv's
decay base, bonus and zero `w_lora_b`, Mamba's `dt_bias` and `D`) get
seeded noise first, so a leaf sliced to the wrong channels, or a LoRA
gradient left partial, shows.

One module fixture starts the reference, the 4 ranks of
`_torch_tp_worker.py` and a rank of a world of 1 (the (1, 1) mesh against
the one-device step, `torch.equal`) at once (as `test_torch_tp.py` does,
its own file so that the two run side by side), rendezvous through
`FileStore`s under tmp_path, with a join timeout that kills them all.

Tolerances as `test_torch_tp.py`: 5e-5 (relative and absolute) on the
params after 2 steps and on the metrics (AdamW eps 1e-6); each gradient
shard within 5e-5 of the one-device gradient's, relative to the leaf's
largest element; the Mamba gated norm's output and gradients on the rank's
heads within 5e-5 of one device's.  Exact: the replicated leaves' gradients
across the model ranks, the FLOPs ratio, the operators' closed forms.
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from _torch_port import close, family_setup, noisy_constants
from repro_torch.configs import get_config
from test_torch_tp import (OPT, TIMEOUT, TOL, WORLD, _model_groups,
                           _one_device, _param_keys, _wait_all)

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
MESHES = [(2, 2), (1, 4)]
CASES = {"rwkv6": ("rwkv6_7b", 0, dict(ssm_head_dim=32)),
         "zamba2": ("zamba2_1p2b", 1, {}),
         "seamless": ("seamless_m4t_large_v2", 2, {})}
RUNS = [(f"{d}x{m}", name) for d, m in MESHES for name in CASES]
IDS = [f"{mesh}-{name}" for mesh, name in RUNS]
B, S, VOCAB = 4, 64, 512


def _batches(arch, seed, n=2):
    rng = np.random.default_rng(seed)

    def ids():
        return rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    if arch.startswith("seamless"):
        d = get_config(arch).smoke().d_model
        return [{"enc_embeddings": rng.standard_normal((B, S, d)).astype(
                    np.float32), "dec_tokens": ids(), "labels": ids()}
                for _ in range(n)]
    return [{"tokens": ids(), "labels": ids()} for _ in range(n)]


def _case(arch, seed, replace):
    _, jparams, _, _ = family_setup(arch, seed=seed, **replace)
    return dict(arch=arch, replace=replace, opt=OPT,
                params=noisy_constants(jax.tree.map(np.asarray, jparams),
                                       seed + 100),
                batches=_batches(arch, seed + 10))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.distributed as dist
    if not dist.is_available():
        pytest.fail("torch.distributed is not available")
    d = tmp_path_factory.mktemp("tp_families")
    inp = {"cases": {name: _case(*c) for name, c in CASES.items()},
           "meshes": MESHES, "mamba_case": "zamba2"}
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
    worker = os.path.join(HERE, "_torch_tp_worker.py")
    workers = [spawn([sys.executable, worker, str(r), str(WORLD),
                      str(d / "store"), str(d / "inputs.pkl"), str(d)])
               for r in range(WORLD)]
    workers.append(spawn([sys.executable, worker, "0", "1",
                          str(d / "store1"), str(d / "inputs.pkl"), str(d)]))
    results = _wait_all([ref] + workers, TIMEOUT)
    bad = [(i, rc, out[-3000:]) for i, (rc, out) in enumerate(results)
           if rc != 0]
    assert not bad, "\n\n".join(f"process {i} rc={rc}:\n{out}"
                                for i, rc, out in bad)
    return dict(inp=inp, ref=dict(np.load(d / "ref.npz")),
                single=dict(np.load(d / "single.npz")),
                ranks=[dict(np.load(d / f"rank{r}.npz", allow_pickle=True))
                       for r in range(WORLD)])


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
            assert "loss" in {k.split("/")[-1] for k in keys}
            for k in keys:
                close(rr[k], ref[k], TOL)
            assert float(ref[f"{tag}/metrics{s}/grad_norm"]) \
                > OPT["clip_norm"]


@pytest.mark.parametrize("mesh,name", RUNS, ids=IDS)
def test_tp_step_matches_one_device_step(runs, mesh, name):
    tag = f"{mesh}/{name}"
    state, ms = _one_device(runs["inp"]["cases"][name])
    from repro_torch.tree import leaves
    for rr in runs["ranks"]:
        for i, p in enumerate(leaves(state.params)):
            close(rr[f"{tag}/p{i:04d}"], p.numpy(), TOL)
        for s, m in enumerate(ms):
            for k, v in m.items():
                close(rr[f"{tag}/metrics{s}/{k}"], v.numpy(), TOL)


@pytest.mark.parametrize("mesh,name", RUNS, ids=IDS)
def test_tp_gradients_are_the_one_device_shards(runs, mesh, name):
    """Each rank's gradient of each leaf (reduced over the batch axes,
    divided by their size, summed over "model" where a whole tensor fed
    the rank's channels) is its stored shard of the one-device gradient on
    the global batch."""
    for rr in runs["ranks"]:
        err = rr[f"{mesh}/{name}/grad_rel_err"]
        assert len(err) > 0 and float(err.max()) < TOL, err.max()


@pytest.mark.parametrize("mesh,name", RUNS, ids=IDS)
def test_replicated_leaves_agree_across_model_ranks(runs, mesh, name):
    """The leaves stored whole over "model" (norms, mus, rwkv's w_lora_a,
    w_base, u, ln_w and channel-mix wr, Mamba's A_log, dt_bias and D) get
    the same gradient on every rank of a data row, and the params
    gathered after the steps are the same on every rank."""
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
    """The dot FLOPs of the matmuls on the leaves computed over "model"
    (time / channel mix projections and the LoRA's second factor, Mamba's
    in_proj and out_proj, attention projections, FFN, vocab), forward and
    input gradient, on each rank, are 1/model of the one-device
    program's on the same batch shard."""
    model = int(mesh.split("x")[1])
    for rr in runs["ranks"]:
        mine, one = rr[f"{mesh}/{name}/flops"]
        assert one > 0 and mine * model == one, (mine, one)
    assert runs["ranks"][0][f"{mesh}/{name}/grad_model_sharded"].any()


@pytest.mark.parametrize("mesh,name", RUNS, ids=IDS)
def test_peak_live_bytes_below_the_one_device_step(runs, mesh, name):
    for rr in runs["ranks"]:
        tp, one = rr[f"{mesh}/{name}/peak_live_bytes"]
        assert 0 < tp < one, (tp, one)


@pytest.mark.parametrize("mesh,name", RUNS, ids=IDS)
def test_only_plain_contiguous_tensors_reach_the_wrappers(runs, mesh, name):
    """No DTensor (nor any non-contiguous view) reaches a kernel wrapper;
    zamba2's shared block and seamless's decoder self attention run
    through the flash wrapper."""
    for rr in runs["ranks"]:
        assert list(rr[f"{mesh}/{name}/wrapper_bad"]) == []
        flash = rr[f"{mesh}/{name}/wrapper_calls"][0]
        assert (flash > 0) == (name != "rwkv6")


@pytest.mark.parametrize("name", list(CASES))
def test_single_rank_mesh_equals_one_device(runs, name):
    """The (1, 1) mesh's 2 steps `torch.equal` to the one-device step:
    every metric and every leaf after each step."""
    equal = runs["single"][f"single/{name}"]
    assert len(equal) > 2 and equal.all(), equal


@pytest.mark.parametrize("op", ["gather_to", "sum"])
def test_pshard_operator_matches_its_closed_form(runs, op):
    for rr in runs["ranks"]:
        assert bool(rr[f"operators/{op}"])


def test_mamba_gated_norm_on_local_heads_matches_one_device(runs):
    """The sum of squares over the whole d_inner summed over "model" (and
    in the backward too): the output and the rank's share of each
    gradient within TOL of one device's, at model 4."""
    for rr in runs["ranks"]:
        names = list(rr["local/mamba_norm_names"])
        errs = rr["local/mamba_norm_rel_err"]
        assert set(names) == {"out", "y", "z", "out_norm", "out_proj"}
        assert float(errs.max()) < TOL, dict(zip(names, errs))
