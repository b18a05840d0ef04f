"""Whether the timed path's answers are right: the served requests of the
window against the plain reference.

A sample of the requests served inside the window, drawn from the seed and
holding the longest, is run through the reference (`reference/model.py`,
float32) over the same prompts and weights.  The program's final-normed
hidden row at each prompt's last position (the row the first token is
sampled from) and its served first token are held against the
reference's.  Every layer of the timed path feeds both: attention, the
router's top-k, dispatch and packing, the three expert projections, the
combine, the shared expert, the final norm, and (the token) the LM head.

Readings (each over the sample):
  hidden_rel_err_median  the median of |h - h_ref| / |h_ref|: steady from
                         seed to seed (a few rows move 5-30 % where bf16
                         rounding flips a near-tie in a router's top-k)
  token_gap              the widest gap by which a served token's logit
                         lies below the reference's best logit there
A cell compares the readings its limits file (`perfbench/limits/<cell>.json`)
names, each against its limit; the others are printed beside them.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference import model as ref

def sample(results: Sequence[dict], k: int, seed: int) -> List[int]:
    """k request ids of the served ones, drawn from the seed, the longest
    (the first of them) always in."""
    ok = sorted((r for r in results if r["status"] == "ok"),
                key=lambda r: r["rid"])
    if not ok:
        return []
    longest = max(ok, key=lambda r: r["length"])["rid"]
    rest = [r["rid"] for r in ok if r["rid"] != longest]
    rng = np.random.default_rng([int(seed) % (1 << 63), 4])
    pick = rng.permutation(len(rest))[:max(k - 1, 0)]
    return [longest] + sorted(rest[i] for i in pick)


def reference_rows(m: dict, params: dict, prompts: Sequence[np.ndarray],
                   device, precision: str = "fp32",
                   block: int = 6) -> torch.Tensor:
    """The reference's final hidden row at each prompt's last position
    [n, d] (float32), `block` prompts at a time."""
    out = []
    for i in range(0, len(prompts), block):
        ts = [torch.as_tensor(p, device=device)
              for p in prompts[i:i + block]]
        out += [h[-1] for h in ref.final_hidden(m, params, ts, precision)]
    return torch.stack(out)


def numbers(params: dict, rows: torch.Tensor, tokens: Sequence[int],
            ref_rows: torch.Tensor) -> Dict[str, float]:
    """The compared numbers of hidden rows [n, d] and first tokens against
    the reference's rows."""
    rows, ref_rows = rows.float(), ref_rows.float()
    rel = (rows - ref_rows).norm(dim=-1) / ref_rows.norm(dim=-1)
    lg = ref.logits(params, ref_rows)
    tok = torch.as_tensor(list(tokens), device=lg.device).long()
    gap = lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0]
    return {"hidden_rel_err_median": float(rel.median()),
            "token_gap": float(gap.max()),
            "each": sorted(round(float(x), 5) for x in rel)}


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """Each reading the limits name against its limit (a missing reading
    fails)."""
    checks = {k: {"value": values.get(k), "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def control_numbers(m: dict, params: dict, prompts, ref_rows, device,
                    block: int = 6, rows_per_step: int = 2048):
    """The control in the program's place: the reference in float8 over
    the same prompts.  Its hidden rows at the last positions are read as
    the program's are; its token reading is, at every position of the
    prompts, the gap in the reference's logits of the token the float8
    logits put first (the widest), as a served model's control reads."""
    rows, gaps = [], []
    for i in range(0, len(prompts), block):
        ts = [torch.as_tensor(p, device=device)
              for p in prompts[i:i + block]]
        low = ref.final_hidden(m, params, ts, "fp8")
        high = ref.final_hidden(m, params, ts, "fp32")
        rows += [h[-1] for h in low]
        for lo, hi in zip(low, high):
            for j in range(0, len(lo), rows_per_step):
                first = ref.logits(params, lo[j:j + rows_per_step],
                                   "fp8").argmax(-1)[:, None]
                lg = ref.logits(params, hi[j:j + rows_per_step])
                gaps.append((lg.max(-1).values - lg.gather(-1, first)[:, 0])
                            .max())
    rows = torch.stack(rows)
    out = numbers(params, rows, ref.logits(params, rows, "fp8").argmax(-1)
                  .tolist(), ref_rows)
    out["token_gap"] = float(torch.stack(gaps).max())
    return out
