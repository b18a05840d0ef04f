"""Training on the port against the reference: the loss and every leaf's
gradient of `api.loss` against `jax.value_and_grad` of the reference's (fp32
smoke configs, bridged params, remat on and off), the kernels' backward
plain versions against autograd and gradcheck, the train step (one step,
gradient accumulation, falling loss), remat policies and the train CLI.

The reference runs under `jax.jit`; TF32 stays off on the port's side (it
runs on the CPU here, where the kernels' plain versions and their backward
plain versions carry the gradient)."""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import family_setup, t
from repro.launch.steps import TrainState as JTrainState
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.models.api import build_api as jbuild_api
from repro.optim.adamw import AdamW as JAdamW
from repro_torch.kernels.dispatch_combine import ops as dc_ops
from repro_torch.kernels.dispatch_combine.dispatch_combine import (
    combine_weighted, combine_weighted_bwd)
from repro_torch.kernels.dispatch_combine.ref import combine_weighted_ref
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import mha_flash
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref)
from repro_torch.launch.steps import (TrainState, build_train_step,
                                      init_train_state, value_and_grad)
from repro_torch.models.api import build_api
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import leaves

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "qwen3_moe_235b_a22b"

# The loss and gradients against the reference's, in fp32: the port's
# blocked attention, capacity MoE and CE sum in other orders than XLA's, so
# the relative Frobenius error of a leaf's gradient stays under 4e-6 (seen
# over these cases); 1e-4 is the bar (a lost term or a wrong scale reads ~1).
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4

# (arch, config fields): qwen3 MoE at dispatch groups 1 and 2, olmo (dense),
# gemma3 (local windows, and a logit softcap through the backward); the
# backward's wide head dims: gemma3 at its published 256 (windows kept) and
# qwen3 at deepseek_v32's 192
CASES = {
    "qwen3_g1": (ARCH, dict(num_layers=2, num_experts=4, top_k=2)),
    "qwen3_g2": (ARCH, dict(num_layers=2, num_experts=4, top_k=2,
                            dispatch_groups=2)),
    "olmo": ("olmo_1b", dict(num_layers=2)),
    "gemma3": ("gemma3_1b", dict(logit_softcap=30.0)),
    "gemma3_dh256": ("gemma3_1b", dict(head_dim=256)),
    "qwen3_dh192": (ARCH, dict(num_layers=2, num_experts=4, top_k=2,
                               head_dim=192)),
}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.fixture(scope="module")
def reference():
    """Per case: (jax cfg, jax params, port cfg, port params, the batch as
    numpy, the reference's (loss, metrics) and grads)."""
    out = {}
    for name, (arch, kw) in CASES.items():
        jcfg, jparams, cfg, params = family_setup(arch, **kw)
        japi = jbuild_api(jcfg)
        batch = japi.make_batch(jax.random.PRNGKey(1), 64, 2, "train")
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            japi.loss, has_aux=True))(jparams, batch)
        out[name] = (jcfg, jparams, cfg, params,
                     jax.tree.map(np.asarray, batch), float(loss),
                     jax.tree.map(np.asarray, metrics),
                     jax.tree.leaves(jax.tree.map(np.asarray, grads)))
    return out


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_match_the_reference(reference, case, remat):
    """S = 64 > attn_chunk = 32: attention runs through `FlashAttention`
    (its backward `attention_bwd_ref` on the CPU), the MoE layer through
    the dispatch/combine Functions."""
    _, _, cfg, params, batch, jloss, jmetrics, jgrads = reference[case]
    api = build_api(cfg, remat=remat)
    (loss, metrics), grads = value_and_grad(
        api.loss, params, {k: t(v) for k, v in batch.items()})
    assert abs(float(loss) - jloss) <= LOSS_TOL * max(1.0, abs(jloss))
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    got = leaves(grads)
    assert len(got) == len(jgrads)
    for i, (g, w) in enumerate(zip(got, jgrads)):
        assert tuple(g.shape) == w.shape
        assert _rel(g.detach().numpy(), w) <= GRAD_TOL, (case, i)


def test_every_leaf_gets_a_nonzero_gradient(reference):
    """What a cut in the graph would show as a None (or all-zero) leaf: the
    attention projections and every expert weight reach the loss."""
    _, _, cfg, params, batch, *_ = reference["qwen3_g1"]
    api = build_api(cfg)
    params = {k: v for k, v in params.items()}
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    try:
        loss, _ = api.loss(params, {k: t(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
    finally:
        for p in ps:
            p.requires_grad_(False)
    assert all(g is not None and float(g.abs().max()) > 0 for g in grads)


def test_remat_policies_give_the_same_gradients(reference):
    """Every policy is full recompute in torch: the same numbers as no
    remat, bit for bit; an unknown policy raises."""
    _, _, cfg, params, batch, *_ = reference["qwen3_g1"]
    b = {k: t(v) for k, v in batch.items()}
    _, want = value_and_grad(build_api(cfg, remat=False).loss, params, b)
    for policy in ("nothing_saveable", "dots_saveable",
                   "dots_with_no_batch_dims_saveable", "none"):
        api = build_api(cfg.replace(remat_policy=policy), remat=True)
        _, got = value_and_grad(api.loss, params, b)
        assert all(torch.equal(a, w) for a, w in zip(leaves(got),
                                                     leaves(want)))
    with pytest.raises(ValueError, match="remat_policy"):
        build_api(cfg.replace(remat_policy="everything"),
                  remat=True).loss(params, b)


def test_encdec_loss_is_differentiable():
    """The encoder-decoder branch of the API: loss and every gradient
    against the reference's, remat on (its default)."""
    jcfg, jparams, cfg, params = family_setup("seamless_m4t_large_v2")
    japi = jbuild_api(jcfg)
    batch = japi.make_batch(jax.random.PRNGKey(1), 64, 2, "train")
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        japi.loss, has_aux=True))(jparams, batch)
    (loss, _), grads = value_and_grad(
        build_api(cfg).loss, params,
        {k: t(np.asarray(v)) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * float(jloss)
    for g, w in zip(leaves(grads), jax.tree.leaves(jgrads)):
        assert _rel(g.numpy(), np.asarray(w)) <= GRAD_TOL


# ------------------------------------------- the kernels' backward, plainly


@pytest.mark.parametrize("S,H,KVH,window,softcap,causal", [
    (40, 4, 2, None, None, True),     # GQA, S not a multiple of 32
    (64, 4, 1, 16, None, True),       # window
    (50, 2, 2, None, 20.0, True),     # softcap
    (33, 4, 2, 8, 10.0, True),        # both, ragged
    (24, 2, 1, None, None, False),    # non-causal
])
def test_attention_bwd_ref_matches_autograd(S, H, KVH, window, softcap,
                                            causal):
    """The recompute-from-lse formulas against autograd of the plain
    forward, in float64 (1e-10: the same math, other sums)."""
    g = torch.Generator().manual_seed(S)
    dh = 16
    q = torch.randn((2, S, H, dh), generator=g, dtype=torch.float64)
    k = torch.randn((2, S, KVH, dh), generator=g, dtype=torch.float64)
    v = torch.randn((2, S, KVH, dh), generator=g, dtype=torch.float64)
    do = torch.randn((2, S, H, dh), generator=g, dtype=torch.float64)
    opts = dict(causal=causal, window=window, softcap=softcap)
    qk = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o, lse = attention_fwd_ref(*qk, **opts)
    want = torch.autograd.grad(o, qk, do)
    got = attention_bwd_ref(q, k, v, o.detach(), lse.detach(), do, **opts)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-10)
    # the Function: its forward is the plain forward, its backward this
    qk = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o2 = mha_flash(*qk, **opts)
    assert torch.equal(o2.detach(), o.detach())
    for a, b in zip(torch.autograd.grad(o2, qk, do), got):
        assert torch.equal(a, b)


def test_functions_only_where_autograd_records():
    """Serving never goes through the autograd Functions (so the card's
    flash forward writes no lse there): under no_grad / inference_mode, or
    with inputs that need no gradient, the outputs carry no grad_fn; with
    grad recording they carry the Functions' backward nodes."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn((1, 40, 4, 16), generator=g)
    k = torch.randn((1, 40, 2, 16), generator=g)
    x, idx = _routed(12, 2, 4, 4, 3, 1, torch.float32)
    cfg = _cfg(4)
    w = torch.rand((12, 2), generator=g)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            assert mha_flash(q.requires_grad_(True), k, k).grad_fn is None
            xb, info = dc_ops.kernel_moe_dispatch(x.requires_grad_(True),
                                                  idx, cfg, capacity=4)
            assert xb.grad_fn is None
            assert dc_ops.kernel_moe_combine(xb, info, w, 12).grad_fn is None
    assert mha_flash(q.detach(), k, k).grad_fn is None
    o = mha_flash(q.requires_grad_(True), k, k)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    xb, info = dc_ops.kernel_moe_dispatch(x.requires_grad_(True), idx, cfg,
                                          capacity=4)
    view_of = xb.grad_fn.next_functions[0][0]  # xb is [E*C, d] reshaped
    assert type(view_of).__name__ == "MoEDispatchBackward"
    y = dc_ops.kernel_moe_combine(xb, info, w.requires_grad_(True), 12)
    assert type(y.grad_fn).__name__ == "MoECombineBackward"


def test_flash_wrapper_bh_layout_is_differentiable():
    """`flash_attention` ([BH, S, dh], the TPU kernel's signature) goes
    through the same Function."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 20, 8), generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, window=9), (q, k, v))


def test_bwd_head_dims_match_the_cu():
    """The forward's HEAD_DIMS == what flash_attention_bwd_launch
    instantiates on the fp32 fma and bf16 wmma routes, and WGMMA_HEAD_DIMS
    == its wgmma route's (`wgb` at 64 and 128, `wgbw` at 192 and 256: the
    backward routes by the forward's rule), and BWD_PAD == the .cu's
    PAD."""
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "src",
                        "repro_torch", "csrc", "flash_attention.cu")
    src = open(path).read()
    body = src[src.index('extern "C" int flash_attention_bwd_launch('):]
    for dt in ("float", "bf16"):
        dims = tuple(int(a) for a, b in re.findall(
            r"if \(dh == (\d+)\) return bwd::launch<" + dt + r", (\d+),",
            body) if a == b)
        assert dims == fa.HEAD_DIMS == (32, 64, 128, 192, 256)
    wg = tuple(int(a) for a, b in re.findall(
        r"if \(dh == (\d+)\) return wgbw?::launch<(\d+)>", body) if a == b)
    assert wg == fa.WGMMA_HEAD_DIMS == (64, 128, 192, 256)
    assert re.findall(r"return (wgbw?)::launch<", body) == [
        "wgb", "wgb", "wgbw", "wgbw"]
    assert re.search(r"constexpr int PAD = (\d+);", src).group(1) == str(
        fa.BWD_PAD) == "384"


@pytest.mark.parametrize("dh", [16, 48, 320])
def test_flash_bwd_refuses_other_head_dims(dh):
    """Off the CPU, a head dim without a backward kernel raises
    NotImplementedError naming it, before anything is launched or built
    (meta tensors stand in for the card's: no fallback is taken)."""
    q = torch.empty((1, 64, 2, dh), device="meta")
    k = torch.empty((1, 64, 1, dh), device="meta")
    lse = torch.empty((1, 2, 64), device="meta")
    with pytest.raises(NotImplementedError, match=f"head dim {dh}"):
        fa.flash_attention_bwd(q, k, k, q, lse, q)


def _routed(T, K, E, C, d, seed, dtype=torch.float64):
    """x [T, d] and router ids [T, K] (distinct experts per token) with some
    pairs past capacity C, so some are dropped."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((T, d), generator=g, dtype=dtype)
    idx = torch.stack([torch.randperm(E, generator=g)[:K] for _ in range(T)])
    idx[: T // 2, 0] = 0  # a hot expert overflows C
    return x, idx.to(torch.int32)


@pytest.mark.parametrize("E", [4, 1117], ids=["whole", "scatter"])
def test_dispatch_function_gradcheck(E):
    """MoEDispatch's backward (combine_weighted with unit weights) against
    gradcheck in float64, dropped pairs included, on both routes."""
    cfg = build_api(_cfg(E)).cfg
    x, idx = _routed(12, 2, E, 4, 3, E)
    _, info = dc_ops.kernel_moe_dispatch(x, idx, cfg, capacity=4)
    assert not bool(info["valid"].all())  # some pairs dropped

    def f(x_):
        return dc_ops.kernel_moe_dispatch(x_, idx, cfg, capacity=4)[0]

    assert torch.autograd.gradcheck(f, (x.requires_grad_(True),))


def _cfg(E):
    from repro_torch.configs import get_config
    return get_config(ARCH).smoke().replace(num_experts=E, top_k=2)


def test_combine_function_gradcheck():
    """MoECombine's backward (combine_weighted_bwd) against gradcheck in
    float64, through yb and the router weights, dropped pairs included."""
    cfg = _cfg(4)
    x, idx = _routed(10, 2, 4, 4, 3, 1)
    xb, info = dc_ops.kernel_moe_dispatch(x, idx, cfg, capacity=4)
    assert not bool(info["valid"].all())
    w = torch.rand((10, 2), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(2))

    def f(yb, w_):
        return dc_ops.kernel_moe_combine(yb, info, w_, 10)

    assert torch.autograd.gradcheck(
        f, (torch.randn_like(xb).requires_grad_(True),
            w.requires_grad_(True)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_bwd_plain_version_is_autograd_of_the_forward(dtype):
    """combine_weighted_bwd's dyb is autograd's of the plain forward bit
    for bit (round the weight to yb's type, multiply, round); dw is the
    fp32 dot product (autograd would round it through the weight's cast:
    held at 1e-6 in fp32, and against float64 in bf16)."""
    x, idx = _routed(16, 2, 4, 6, 8, 4, dtype)
    xb, info = dc_ops.kernel_moe_dispatch(x, idx, _cfg(4), capacity=6)
    yb = torch.randn(xb.reshape(-1, 8).shape, dtype=torch.float32,
                     generator=torch.Generator().manual_seed(5)).to(dtype)
    w = torch.rand((16, 2), generator=torch.Generator().manual_seed(6))
    dout = torch.randn((16, 8), generator=torch.Generator().manual_seed(7)
                       ).to(dtype)
    ps = info["pair_slot"]
    yb_ = yb.clone().requires_grad_(True)
    w_ = w.clone().requires_grad_(True)
    out = combine_weighted_ref(yb_, ps, w_)
    assert torch.equal(out, combine_weighted(yb, ps, w))
    want_dyb, want_dw = torch.autograd.grad(out, (yb_, w_), dout)
    dyb, dw = combine_weighted_bwd(dout, yb, ps, w)
    assert torch.equal(dyb, want_dyb)
    exact = (yb.double().index_select(0, ps.clamp(max=yb.shape[0] - 1))
             * dout.double().repeat_interleave(2, 0)).sum(-1).reshape(16, 2)
    exact = torch.where((ps < yb.shape[0]).reshape(16, 2), exact, 0.0)
    assert torch.allclose(dw.double(), exact, rtol=1e-6, atol=1e-6)
    assert float(dw.reshape(-1)[ps >= yb.shape[0]].abs().max()) == 0.0


# ---------------------------------------------------------------- the step


def _bridged_step_setup():
    jcfg, jparams, cfg, params = family_setup(
        ARCH, num_layers=2, num_experts=4, top_k=2)
    return jcfg, jparams, cfg, params


def test_train_step_matches_the_reference():
    """One build_train_step on bridged params and the same batch: the loss
    (1e-5) and every param after the update within 2 lr of the reference's
    (Adam's first step moves each weight by about lr * sign(g): a gradient
    near zero may flip sign across frameworks, nothing else may differ by
    more)."""
    from repro_torch.data.pipeline import pipeline_for
    jcfg, jparams, cfg, params = _bridged_step_setup()
    lr = 1e-3
    jopt, opt = JAdamW(lr=lr), AdamW(lr=lr)
    batch = pipeline_for(cfg, 64, 2, device="cpu").numpy_batch(0)
    js, jm = jax.jit(jbuild_train_step(jbuild_api(jcfg), jopt))(
        JTrainState(jparams, jopt.init(jparams)), batch)
    state, m = build_train_step(build_api(cfg), opt)(
        TrainState(params, opt.init(params)),
        {k: t(v) for k, v in batch.items()})
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL * float(
        jm["loss"])
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    for a, b in zip(leaves(state.params), jax.tree.leaves(js.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2 * lr)
    assert int(state.opt.step) == 1


def test_gradient_accumulation_matches_monolithic():
    """build_train_step(accum_steps=4) == the monolithic batch (mirrors the
    reference's test, its tolerances)."""
    from repro_torch.configs import get_config
    cfg = get_config("olmo_1b").smoke().replace(num_layers=2)
    api = build_api(cfg)
    opt = AdamW(lr=1e-3)
    gen = torch.Generator().manual_seed(0)
    s1 = init_train_state(api, gen, opt)
    s4 = TrainState({k: v for k, v in _clone(s1.params).items()},
                    opt.init(s1.params))
    batch = api.make_batch(torch.Generator().manual_seed(1), 32, 8, "train",
                           device="cpu")
    s1, m1 = build_train_step(api, opt)(s1, batch)
    s4, m4 = build_train_step(api, opt, accum_steps=4)(s4, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-4)
    for a, b in zip(leaves(s1.params), leaves(s4.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-4)


def _clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(torch.clone, tree)


def test_train_step_decreases_loss_smoke():
    """A few steps of real training on the copy task reduce loss (MoE arch;
    mirrors tests/test_arch_smoke.py)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import pipeline_for
    cfg = get_config(ARCH).smoke().replace(num_layers=2, num_experts=4,
                                           top_k=2)
    api = build_api(cfg)
    opt = AdamW(lr=1e-3)
    state = init_train_state(api, torch.Generator().manual_seed(0), opt)
    step_fn = build_train_step(api, opt)
    pipe = pipeline_for(cfg, 32, 4, device="cpu")
    losses = []
    for s in range(8):
        state, metrics = step_fn(state, pipe.batch(s))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert all(math.isfinite(x) for x in losses)


def test_resumed_run_equals_the_uninterrupted_run(tmp_path):
    """ResilientTrainer over build_train_step at the small config: 6 steps,
    a checkpoint every 2, a failure at step 3 restored from step 2's
    checkpoint -- params, moments and the step counter torch.equal (dtype
    and shape too) to an uninterrupted run's (the card holds the same in
    chip_smoke.py's train phase)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.runtime.fault_tolerance import ResilientTrainer
    from repro_torch.configs import get_config
    cfg = get_config(ARCH).smoke().replace(num_layers=2, num_experts=4,
                                           top_k=2)
    api = build_api(cfg)
    params0 = api.init(torch.Generator().manual_seed(1))
    opt = AdamW(lr=1e-3, warmup_steps=2)
    pipe = pipeline_for(cfg, 48, 2, device="cpu")
    runs = {}
    for name, fail in (("resumed", 3), ("uninterrupted", None)):
        p = _clone(params0)
        trainer = ResilientTrainer(build_train_step(api, opt), pipe,
                                   CheckpointManager(str(tmp_path / name)),
                                   ckpt_every=2)
        state, step, _ = trainer.run(TrainState(p, opt.init(p)), 6,
                                     inject_failure_at=fail)
        assert step == 6
        runs[name] = state
    for a, b in zip(leaves(runs["resumed"]), leaves(runs["uninterrupted"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_train_cli_runs_on_one_device_without_a_mesh(tmp_path, capsys):
    """The train CLI on the CPU with a checkpoint directory and an injected
    failure: it recovers and finishes.  A deliberate difference from the
    reference's CLI: no mesh and no shardings (one device is the
    reference's 1-device mesh) -- it says so, and takes --device."""
    from repro_torch.launch import train
    assert "--device" in train.parser().format_help()
    train.main(["--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
                "--seq", "40", "--ckpt-dir", str(tmp_path),
                "--ckpt-every", "2", "--inject-failure-at", "3"])
    out = capsys.readouterr().out
    assert "(one device: no mesh)" in out
    assert re.search(r"final loss: \d", out)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000000002", "step_000000000004"]
