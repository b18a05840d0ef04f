"""The reference against the port on the CPU at a small size (the test may
import the port; the reference does not)."""
import json

import pytest
import torch

from perfbench import cell, manifest, weights
from perfbench.reference import model as ref
from perfbench.tests import smoke


CONFIGS = sorted((manifest.ROOT / "perfbench" / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_reference_matches_the_port(path):
    """Every configuration file (qk-norm, the shared expert), small."""
    from repro_torch.models.lm import lm_backbone, lm_head
    m = {**json.loads(path.read_text())["model"], **smoke.SMALL}
    cfg = cell.port_config(m, exact=False)
    params = weights.make_params(m, 5, "cpu")
    tokens = torch.randint(0, m["vocab_size"], (2, 48),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        h_port, _ = lm_backbone(params, cfg, tokens, moe_mode="dense",
                                use_dense=True)
        logits_port = lm_head(params, h_port[:, -1], cfg)
    h_ref = ref.final_hidden(m, params, list(tokens))
    for b in range(2):
        assert torch.allclose(h_ref[b], h_port[b].float(), atol=2e-5,
                              rtol=2e-5)
    lg = ref.logits(params, torch.stack([h[-1] for h in h_ref]))
    assert torch.allclose(lg, logits_port.float(), atol=1e-4, rtol=1e-4)


def test_shared_expert_and_qk_norm_are_in_the_reference():
    """A reference that dropped either would miss the port by far."""
    m = {**json.loads((manifest.ROOT / "perfbench" / "configs" /
                       "deepseek_v32.d2.json").read_text())["model"],
         **smoke.SMALL}
    params = weights.make_params(m, 5, "cpu")
    toks = [torch.arange(16)]
    full = ref.final_hidden(m, params, toks)[0]
    params["stages"][0]["ffn"]["shared"]["w_down"].zero_()
    assert (ref.final_hidden(m, params, toks)[0] - full).norm() \
        > 1e-2 * full.norm()


def test_fp8_control_rounds_every_product():
    a = torch.randn(8, 32, generator=torch.Generator().manual_seed(0))
    b = torch.randn(32, 4, generator=torch.Generator().manual_seed(1))
    exact = ref.mm(a, b, "fp32")
    low = ref.mm(a, b, "fp8")
    rel = ((low - exact).norm() / exact.norm()).item()
    assert 1e-3 < rel < 0.2
