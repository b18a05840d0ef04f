"""On the card only: the control and the program at the cells' own sizes
(short windows), against the cells' limits.  Skips without a card."""
import json
import subprocess
import sys

import pytest

from perfbench import manifest

ROOT = manifest.ROOT


@pytest.mark.chip
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      manifest.load()["workloads"]])
def test_control_fails_and_program_passes_on_the_card(workload, tmp_path):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = tmp_path / "control.jsonl"
    subprocess.run([sys.executable, str(ROOT / "perfbench" / "control.py"),
                    "--workload", workload, "--seeds", "901,902,903",
                    "--seconds", "6", "--out", str(out)], check=True,
                   cwd=ROOT, timeout=900)
    limits = manifest.plan(workload).limits
    for line in out.read_text().splitlines():
        d = json.loads(line)
        assert d["correct"], d
        assert any(d["control"][k] > lim for k, lim in limits.items()), d
