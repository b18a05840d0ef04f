"""The port's SPMD training (`launch.steps.build_sharded_train_step`,
`build_compressed_dp_step`, `runtime.fault_tolerance.elastic_mesh` /
`reshard_onto`, `CheckpointManager.restore(mesh=, specs=)`, the train
CLI's `--mesh`) on 4 gloo ranks, held against the reference's
multi-device steps on 4 forced host devices and against the port's
one-device step.

One module fixture starts everything at once: the JAX reference in a
process of its own (`_torch_spmd_jax.py`: the forced-device flag must
precede its jax import), the 4 ranks of `_torch_spmd_worker.py`
(rendezvous through a `FileStore` under tmp_path, never a fixed port) and
the 4 ranks of the train CLI.  Each has a join timeout: at the timeout
every process is killed and the fixture fails with their output, so a hang
costs this file and not the suite.

Tolerances: 5e-5 (relative and absolute) on the fp32 params and metrics of
the sharded step, the reference's and the port's one-device step alike;
the compressed step's params and residuals at 5e-5 too, its int8 codes
differing at most by one quantum where fp32 rounding puts a value on a
half step (`test_compressed_dp_step_matches_reference` states the share).
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
from repro_torch.launch.steps import TrainState, build_train_step
from repro_torch.models.api import build_api
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import leaves

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
TOL = 5e-5
TIMEOUT = 300
WORLD = 4

QWEN = dict(num_layers=2, num_experts=4, top_k=2, dispatch_groups=2)
# clip_norm low enough that clipping engages on both steps
OPT = dict(lr=1e-3, clip_norm=0.05)


def _batches(seed, n=2, B=4, S=32, vocab=512):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
            for _ in range(n)]


def _case(arch, seed, **replace):
    _, jparams, _, _ = family_setup(arch, seed=seed, **replace)
    return dict(arch=arch, replace=replace, opt=OPT,
                params=jax.tree.map(np.asarray, jparams),
                batches=_batches(seed + 10))


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


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


def _spawn(args, env, **kw):
    return subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spmd")
    inp = {"sharded": {"qwen3": _case("qwen3_moe_235b_a22b", 0, **QWEN),
                       "gemma3": _case("gemma3_1b", 1)},
           "compressed": _case("qwen3_moe_235b_a22b", 2, num_layers=2,
                               num_experts=4, top_k=2),
           "elastic": "qwen3"}
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = _env()
    ref = _spawn([sys.executable, os.path.join(HERE, "_torch_spmd_jax.py"),
                  str(d / "inputs.pkl"), str(d / "ref.npz")], env)
    workers = [_spawn([sys.executable,
                       os.path.join(HERE, "_torch_spmd_worker.py"),
                       str(r), str(WORLD), str(d / "store"),
                       str(d / "inputs.pkl"), str(d)], env)
               for r in range(WORLD)]
    cli = [_spawn([sys.executable, "-m", "repro_torch.launch.train",
                   "--arch", "qwen3_moe_235b_a22b", "--smoke", "--steps",
                   "3", "--batch", "4", "--seq", "16", "--device", "cpu",
                   "--mesh", "2x2", "--init-method",
                   f"file://{d / 'cli_store'}"],
                  dict(env, RANK=str(r), WORLD_SIZE=str(WORLD)))
           for r in range(WORLD)]
    results = _wait_all([ref] + workers + cli, TIMEOUT)
    bad = [(i, rc, out[-3000:]) for i, (rc, out) in enumerate(results)
           if rc != 0]
    assert not bad, "\n\n".join(f"process {i} rc={rc}:\n{out}"
                                for i, rc, out in bad)
    return dict(inp=inp, ref=dict(np.load(d / "ref.npz")),
                ranks=[dict(np.load(d / f"rank{r}.npz"))
                       for r in range(WORLD)],
                cli=[out for _, out in results[1 + WORLD:]])


def _one_device(case):
    """The port's one-device build_train_step on the case's global batches."""
    from repro_torch.bridge import params_from_numpy
    cfg = get_config(case["arch"]).smoke().replace(**case["replace"])
    api = build_api(cfg)
    params = params_from_numpy(case["params"], cfg, "cpu")
    opt = AdamW(**case["opt"])
    state = TrainState(params, opt.init(params))
    step = build_train_step(api, opt)
    ms = []
    for b in case["batches"]:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        ms.append(m)
    return state, ms


@pytest.mark.parametrize("name", ["qwen3", "gemma3"])
def test_sharded_step_matches_reference(runs, name):
    ref, r0 = runs["ref"], runs["ranks"][0]
    n = len([k for k in ref if k.startswith(f"{name}/p")])
    assert n == len([k for k in r0 if k.startswith(f"{name}/p")]) > 0
    for i in range(n):
        close(r0[f"{name}/p{i:04d}"], ref[f"{name}/p{i:04d}"], TOL)
    for s in range(2):
        keys = [k for k in ref if k.startswith(f"{name}/metrics{s}/")]
        assert {k.split("/")[-1] for k in keys} >= {
            "loss", "ce", "load_balance", "grad_norm"}
        for k in keys:
            close(r0[k], ref[k], TOL)
        assert float(ref[f"{name}/metrics{s}/grad_norm"]) > OPT["clip_norm"]
    if name == "qwen3":  # the aux loss is on and routed through the group
        assert float(ref["qwen3/metrics0/load_balance"]) > 0


@pytest.mark.parametrize("name", ["qwen3", "gemma3"])
def test_sharded_step_matches_one_device_step(runs, name):
    state, ms = _one_device(runs["inp"]["sharded"][name])
    r0 = runs["ranks"][0]
    for i, p in enumerate(leaves(state.params)):
        close(r0[f"{name}/p{i:04d}"], p.numpy(), TOL)
    for s, m in enumerate(ms):
        for k, v in m.items():
            close(r0[f"{name}/metrics{s}/{k}"], v.numpy(), TOL)


@pytest.mark.parametrize("name", ["qwen3", "gemma3"])
def test_sharded_step_ranks_agree_and_shard_storage(runs, name):
    """Every rank gathers the same state; each stores only its shards (the
    ZeRO layout over both axes: less than the whole on every rank)."""
    r = runs["ranks"]
    keys = [k for k in r[0] if k.startswith(f"{name}/")
            and not k.endswith("local_numel")]
    for other in r[1:]:
        for k in keys:
            np.testing.assert_array_equal(other[k], r[0][k])
    whole = sum(v.size for k, v in r[0].items()
                if k.startswith(f"{name}/p"))
    for rr in r:
        assert int(rr[f"{name}/local_numel"]) < whole


def test_compressed_dp_step_matches_reference(runs):
    """Loss, params and per-rank residuals after 2 steps at 5e-5.  An int8
    code may differ by one quantum q where g + residual sits on a half
    step, which fp32 rounding decides one way in jax and the other in
    torch; the residual there differs by at most q (the largest residual
    of the leaf is q/2), and what it moves in the next step (the averaged
    gradient, the params) differs a little beyond 5e-5, the params by at
    most two Adam steps (2 lr).  Elements beyond 5e-5 are held to at most
    1e-4 of all (42 of 3.7M over the 4 ranks seen)."""
    ref = runs["ref"]
    n = len([k for k in ref if k.startswith("compressed/p")])
    assert n > 0
    total = off = 0
    for rank, rr in enumerate(runs["ranks"]):
        for s in range(2):
            close(rr[f"compressed/loss{s}"], ref[f"compressed/loss{s}"], TOL)
        for i in range(n):
            got_r = rr[f"compressed/r{i:04d}"]
            want_r = ref[f"compressed/r{i:04d}"][rank]
            quantum = 2 * np.abs(want_r).max()
            assert np.abs(got_r - want_r).max() <= 1.01 * quantum + TOL
            got_p = rr[f"compressed/p{i:04d}"]
            want_p = ref[f"compressed/p{i:04d}"]
            assert np.abs(got_p - want_p).max() <= 2 * OPT["lr"]
            total += got_r.size + got_p.size
            off += int((~np.isclose(got_r, want_r, rtol=TOL, atol=TOL)).sum())
            off += int((~np.isclose(got_p, want_p, rtol=TOL, atol=TOL)).sum())
    assert off <= 1e-4 * total, (off, total)


def test_elastic_restore_onto_fewer_ranks(runs):
    for rr in runs["ranks"][:3]:
        assert tuple(rr["elastic/mesh"]) == (3, 1)
        assert bool(rr["elastic/restore_equal"])
        assert bool(rr["elastic/reshard_equal"])
    assert "elastic/mesh" not in runs["ranks"][3]


def test_train_cli_on_a_2x2_mesh(runs):
    finals = []
    for out in runs["cli"]:
        assert "mesh={'data': 2, 'model': 2}" in out, out[-2000:]
        line = [ln for ln in out.splitlines()
                if ln.startswith("final loss:")]
        assert line, out[-2000:]
        finals.append(float(line[-1].split(":")[1]))
    assert np.isfinite(finals).all() and len(set(finals)) == 1, finals


def test_elastic_mesh_and_reshard_one_rank(tmp_path):
    """The one-rank mirror of the reference's
    test_substrates.py::test_elastic_mesh_and_reshard."""
    import torch.distributed as dist
    from repro_torch.launch.sharding import P, full_tree
    from repro_torch.runtime.fault_tolerance import (elastic_mesh,
                                                     reshard_onto)
    if not dist.is_available():
        pytest.fail("torch.distributed is not available")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = elastic_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
        out = reshard_onto({"w": torch.arange(8.0)}, mesh, {"w": P()})
        assert torch.equal(full_tree(out)["w"], torch.arange(8.0))
    finally:
        dist.destroy_process_group()
