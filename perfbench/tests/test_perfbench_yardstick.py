"""The yardstick's arithmetic on hand-worked shapes."""
import json
import pathlib

import pytest

from perfbench import yardstick as Y

ROOT = pathlib.Path(__file__).resolve().parents[2]
PK = {"bf16_flops": 1e12, "hbm_bytes_s": 1e9}


def _model(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())["model"]


def test_qwen3_layer_flops_per_token():
    m = _model("qwen3_moe_235b_a22b.d8")
    proj = 2 * 4096 * (8192 + 2 * 512) + 2 * 8192 * 4096
    router = 2 * 4096 * 128
    experts = 8 * 3 * 2 * 4096 * 1536
    assert Y.layer_flops_per_token(m) == proj + router + experts == 445644800
    # causal attention at a 4096-token prompt, per token: 67.1 MFLOP
    attn = 4 * (4096 * 4097 / 2) * 64 * 128 / 4096
    assert attn == pytest.approx(67.125248e6)
    per_tok = Y.prompt_flops(m, 4096) / 4096
    head = 2 * 4096 * 151936 / 4096
    assert per_tok == pytest.approx(8 * (445644800 + attn) + head)


def test_deepseek_layer_flops_per_token():
    m = _model("deepseek_v32.d2")
    q, kv = 128 * 192, 8 * 192
    proj = 2 * 7168 * (q + 2 * kv) + 2 * q * 7168
    expected = proj + 2 * 7168 * 256 + (8 + 1) * 3 * 2 * 7168 * 2048
    assert Y.layer_flops_per_token(m) == expected
    attn = 4 * (4096 * 4097 / 2) * 128 * 192 / 4096
    assert (expected + attn) / 1e9 == pytest.approx(1.746, abs=1e-3)


def test_mfu_pct():
    m = {"num_layers": 1, "d_model": 2, "num_heads": 1, "num_kv_heads": 1,
         "head_dim": 2, "num_experts": 2, "top_k": 1, "moe_d_ff": 3,
         "num_shared_experts": 0, "vocab_size": 5}
    # per token: proj 2*2*(2+4) + 2*2*2 = 32, router 8, expert 3*2*2*3 = 36
    assert Y.layer_flops_per_token(m) == 76
    # prompt of 3: 3*76 + attention 4*6*1*2 = 48, head 2*2*5 = 20
    assert Y.prompt_flops(m, 3) == 228 + 48 + 20
    assert Y.mfu_pct(m, [3, 3], 2.0, PK) == pytest.approx(
        100 * 2 * 296 / (2.0 * 1e12))


def test_super_gmm_work_counts_routed_rows_and_used_experts():
    # 3 rows on expert 0, none on 1, 1 on 2: n = 4, two experts' weights
    work = Y.super_gmm_launch_work([3, 0, 1], d=4, f=2)
    w = 2 * 2 * 4 * 2
    assert work[0] == (2 * 4 * 4 * 2, 2 * 4 * 4 + w + 4 * 4 * 2)
    assert work[1] == work[0]
    assert work[2] == (2 * 4 * 2 * 4, 2 * 4 * 2 + w + 4 * 4 * 4)
    t = Y.super_gmm_min_time_s([[3, 0, 1]], 4, 2, PK)
    assert t == pytest.approx(sum(max(f / 1e12, b / 1e9) for f, b in work))


def test_flash_work_over_visible_pairs():
    flops, nbytes = Y.flash_work([1, 2], heads=2, kv_heads=1, head_dim=4)
    assert flops == 4 * (1 + 3) * 2 * 4
    assert nbytes == 2 * 3 * 4 * (2 * 2 + 2 * 1)
    t = Y.flash_min_time_s([[1, 2]], 2, 1, 4, PK)
    assert t == max(flops / 1e12, nbytes / 1e9)


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::wg::super_gmm_wgmma_kernel<128, 256>",
     "super_gmm"),
    ("void flash_wgmma_wide_kernel<192>(CUtensorMap)", "flash"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "cublas"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "cublas"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "glue"),
    ("Memcpy DtoD (Device -> Device)", "glue"),
])
def test_kernel_classes(name, cls):
    assert Y.kernel_class(name) == cls
