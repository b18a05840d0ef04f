"""The serving examples' twins on repro_torch (`examples/torch_*.py`) against
the reference's examples, on the CPU: each twin runs with `--device cpu` in
its own process, the reference's example beside it; the printed analytic
lines are `==` the reference's, quickstart's loss and logits agree with the
reference's on bridged params, and serve_asap's first tokens by rid are the
reference's."""
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import close, family_setup, t
from repro.kernels.super_gmm.ops import \
    make_super_kernel_gmm as jax_make_super_kernel_gmm
from repro.models.api import build_api as jax_build_api
from repro.models.lm import lm_forward as jax_lm_forward

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
ARCH = "qwen3_moe_235b_a22b"
TIMEOUT = 240


def _env():
    src = str(ROOT / "src")
    old = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=src + (os.pathsep + old if old else ""),
                JAX_PLATFORMS="cpu")


def _start(script: str, *args: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(EXAMPLES / script), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(), cwd=str(ROOT))


@pytest.fixture(scope="module")
def runs():
    """Every twin (`--device cpu`) and every reference example, started
    together, each in its own process; (returncode, stdout, stderr) by
    script name."""
    names = ["torch_quickstart.py", "torch_serve_asap.py",
             "torch_imbalance_demo.py", "quickstart.py", "serve_asap.py",
             "imbalance_demo.py"]
    procs = {n: _start(n, *(["--device", "cpu"] if n.startswith("torch_")
                            else [])) for n in names}
    out = {}
    try:
        for n, p in procs.items():
            so, se = p.communicate(timeout=TIMEOUT)
            out[n] = (p.returncode, so, se)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _ok(runs, name) -> str:
    rc, so, se = runs[name]
    assert rc == 0, f"{name} exited {rc}:\n{se[-3000:]}"
    return so


def _twin(name):
    """The twin's module, imported from its file (its work is under
    main())."""
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _strip(stdout: str, tag: str) -> list:
    """The twin's lines with its analytic tag taken off."""
    return [line[:-len(tag)].rstrip() if line.endswith(tag) else line
            for line in stdout.splitlines()]


# ---------------------------------------------------------- imbalance demo --

def test_imbalance_demo_twin_prints_the_reference_lines(runs):
    """Every line `==` the reference's, once the twin's tag (this is the
    analytic model of the reference's preset) is taken off; every line
    with a number carries the tag."""
    mod = _twin("torch_imbalance_demo")
    got = _ok(runs, "torch_imbalance_demo.py")
    want = _ok(runs, "imbalance_demo.py").splitlines()
    assert _strip(got, "  " + mod.ANALYTIC) == want
    for line in got.splitlines():
        if any(c.isdigit() for c in line):
            assert line.endswith(mod.ANALYTIC)


# ------------------------------------------------------------- quickstart --

def _quickstart_setup():
    """The reference quickstart's model, params (PRNGKey(0)) and batches
    (PRNGKey(1), PRNGKey(2)), and the port's cfg and bridged params."""
    jcfg, jparams, cfg, params = family_setup(ARCH, num_layers=3,
                                              num_experts=8, top_k=2)
    japi = jax_build_api(jcfg)
    batch = japi.make_batch(jax.random.PRNGKey(1), seq_len=64, batch_size=2,
                            kind="train")
    pb = japi.make_batch(jax.random.PRNGKey(2), seq_len=32, batch_size=2,
                         kind="prefill")
    return jcfg, jparams, cfg, params, japi, batch, pb


def test_quickstart_twin_matches_the_reference_on_bridged_params():
    """Steps 2-4 of the twin on the reference's params and batches: the loss
    and metrics at the port's lm_loss tolerance (1e-5), the Super Kernel's
    and the einsum path's logits at the lm_forward-on-the-Super-Kernel
    tolerance (2e-5), and the same greedy tokens."""
    mod = _twin("torch_quickstart")
    jcfg, jparams, cfg, params, japi, batch, pb = _quickstart_setup()
    assert cfg == mod.model_config()
    got = mod.steps(cfg, params, {k: t(v) for k, v in batch.items()},
                    {k: t(v) for k, v in pb.items()})
    jloss, jm = jax.jit(japi.loss)(jparams, batch)
    close(got["loss"], jloss, 1e-5)
    assert sorted(got["metrics"]) == sorted(jm)
    for k in jm:
        close(got["metrics"][k], jm[k], 1e-5)
    jgmm = jax_make_super_kernel_gmm(jparams["stages"][0]["ffn"]["experts"],
                                     jcfg)
    want_kernel, _ = jax_lm_forward(jparams, jcfg, batch["tokens"], gmm=jgmm)
    want_ref, _ = jax.jit(lambda p, x: jax_lm_forward(p, jcfg, x))(
        jparams, batch["tokens"])
    close(got["logits_kernel"], want_kernel, 2e-5)
    close(got["logits_ref"], want_ref, 2e-5)
    assert got["err"] <= 2e-5
    # greedy decode: prefill, then four steps
    logits, caches = jax.jit(japi.prefill)(jparams, pb)
    toks = jnp.argmax(logits, -1)
    want = [toks]
    step = jax.jit(japi.decode)
    for _ in range(4):
        logits, caches = step(jparams, caches, {"token": toks})
        toks = jnp.argmax(logits, -1)
        want.append(toks)
    np.testing.assert_array_equal(got["greedy"].numpy(),
                                  np.stack(want, 1))


def test_quickstart_twin_runs_and_prints_the_reference_analytic_line(runs):
    mod = _twin("torch_quickstart")
    got = _ok(runs, "torch_quickstart.py")
    want = _ok(runs, "quickstart.py").splitlines()
    lines = _strip(got, mod.ANALYTIC)
    assert want[-1] in lines  # step 5, the reference's preset
    tagged = [line for line in got.splitlines() if "v5e" in line]
    assert len(tagged) == 1 and tagged[0].endswith(mod.ANALYTIC)
    assert "super-kernel vs einsum max err: 0.00e+00" in lines
    assert any(line.startswith("loss: ") for line in lines)
    assert lines[-1].startswith("kernel launches: ")
    assert lines[0].startswith(want[0].split(" — ")[0])  # the model line


# ------------------------------------------------------------ serve_asap --

def _first_tokens(stdout: str) -> dict:
    out = {}
    for line in stdout.splitlines():
        if "done rid=" in line and "first_token=" in line:
            rid = int(line.split("rid=")[1].split()[0])
            out[rid] = int(line.split("first_token=")[1].split()[0])
    return out


def test_serve_asap_twin_completes_every_request(runs):
    got = _ok(runs, "torch_serve_asap.py")
    assert "engine completed 10/10 requests" in got
    assert len(_first_tokens(got)) == 10
    assert got.splitlines()[-1].startswith("kernel launches: ")


def test_serve_asap_twin_first_tokens_equal_the_reference(runs):
    """On the reference example's params (its init under PRNGKey(0),
    bridged) the twin's live engine gives every rid the first token the
    reference's example printed: the executor's output does not depend on
    how requests were batched."""
    mod = _twin("torch_serve_asap")
    _, _, cfg, params = family_setup(ARCH, num_layers=4, num_experts=8,
                                     top_k=2)
    assert cfg == mod.model_config()
    reqs = mod.requests()
    out = mod.serve(cfg, params, reqs, "cpu", verbose=False)
    got = {r.rid: r.first_token for r in out["results"]}
    assert sorted(got) == list(range(10))
    want = _first_tokens(_ok(runs, "serve_asap.py"))
    assert got == want


def test_twins_default_to_the_card(monkeypatch, capsys):
    """Each twin defaults to --device cuda and, where there is no card,
    exits 2 (never a silent fall back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("torch_quickstart", "torch_serve_asap"):
        assert _twin(name).main([]) == 2
        assert "--device cpu" in capsys.readouterr().err


# ------------------------------------------------------------- train_moe --

TRAIN_STEPS = 50  # failure at 25, before the first checkpoint (every 50)


def _printed_losses(stdout: str) -> list:
    """The `step N  loss X` lines, in order: (step, loss)."""
    return [(int(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"^step\s+(\d+)\s+loss\s+(\S+)", stdout, re.M)]


def test_train_moe_twin_matches_the_reference(tmp_path):
    """examples/train_moe.py and its twin as subprocesses, `--steps 50`
    (one failure injected at 25 and recovered from, as in the reference):
    both exit 0 and print an improved loss.  Their printed losses are then
    held against each other on the same params: the twin's `train()` on the
    reference example's params (its init under PRNGKey(0), bridged) prints
    the reference's loss at every printed step within 2e-3 (the reference
    prints 4 decimals; fp32 sums in another order drift by ~1e-5 over the
    75 steps run)."""
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, str(EXAMPLES / "train_moe.py"), "--steps",
             str(TRAIN_STEPS), "--ckpt-dir", str(tmp_path / "ref")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(), cwd=str(ROOT)),
        "twin": subprocess.Popen(
            [sys.executable, str(EXAMPLES / "torch_train_moe.py"), "--steps",
             str(TRAIN_STEPS), "--device", "cpu", "--ckpt-dir",
             str(tmp_path / "twin")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(_env(), OMP_NUM_THREADS="1"), cwd=str(ROOT))}
    mod = _twin("torch_train_moe")
    cfg = mod.model_config()
    _, _, _, params = family_setup(
        ARCH, **{k: getattr(cfg, k) for k in (
            "num_layers", "num_experts", "top_k", "d_model", "d_ff",
            "moe_d_ff", "vocab_size")})
    # one thread: the model is tiny, and a thread pool beside the two
    # subprocesses' spins on the cores they hold
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = mod.train(cfg, params, TRAIN_STEPS, str(tmp_path / "bridged"),
                        "cpu", verbose=False)
    finally:
        torch.set_num_threads(threads)
    out = {}
    try:
        for n, p in procs.items():
            so, se = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"{n} exited {p.returncode}:\n{se}"
            out[n] = so
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for so in out.values():
        assert "(improved)" in so and "recovered at step 25" in so
    want = _printed_losses(out["ref"])
    assert [s for s, _ in want] == [25, 25, 50]  # 25 replayed from scratch
    assert [s for s, _ in _printed_losses(out["twin"])] == [25, 25, 50]
    # losses[i] is step (i % 25) + 1 of its run: 25 before the failure, then
    # a restart from step 0 (no checkpoint yet) for 50 more
    assert len(got["losses"]) == 75 and got["step"] == TRAIN_STEPS
    for (step, loss), i in zip(want, (24, 49, 74)):
        assert abs(got["losses"][i] - loss) <= 2e-3, (step, i)
    first = float(re.search(r"loss: (\S+) ->", out["ref"]).group(1))
    assert abs(got["losses"][0] - first) <= 2e-3
