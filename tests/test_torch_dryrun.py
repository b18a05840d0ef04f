"""The port's dry-run side: `launch.op_analysis` on hand-built programs
(closed forms, and `torch.utils.flop_counter` on the matmuls), the cost
contracts (`analysis.contracts`: the mirror of the reference's
tests/test_contracts.py on the port's own goldens), `launch.dryrun` on a
fake 16x16 mesh, and the mesh rules of the port's shardcheck on seeded
fixtures.

What joins a fake process group (process-global) runs in processes of its
own, started at once by one module fixture, each with a join timeout.
"""
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import analysis as port_analysis
from repro_torch.analysis.contracts import (CONTRACTS, METRICS, RTOL,
                                            diff_metrics, load_golden)
from repro_torch.launch.op_analysis import COLLECTIVE_FACTOR, analyze

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
FIX = os.path.join("tests", "fixtures", "torch_analysis")
TIMEOUT = 240

# the keys of the reference's `repro.launch.dryrun.run_cell` record
REF_KEYS = {"arch", "shape", "mesh", "chips", "opts", "status", "kind",
            "lower_s", "compile_s", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "collective_by_op",
            "collective_counts", "xla_cost_flops", "xla_bytes_accessed",
            "compute_s", "memory_s", "collective_s", "dominant",
            "model_flops_per_device", "useful_flops_ratio", "params_total",
            "params_active", "mem", "wall_s"}
REF_MEM_KEYS = {"argument_mb", "output_mb", "temp_mb", "alias_mb",
                "peak_hbm_gb"}


# ---------------------------------------------------------------------------
# op_analysis on hand-built programs
# ---------------------------------------------------------------------------


def test_matmul_flops_are_2mnk_and_agree_with_flop_counter():
    a, b = torch.randn(16, 32), torch.randn(32, 8)
    x, y = torch.randn(3, 4, 5), torch.randn(3, 5, 6)

    def prog():
        return a @ b, torch.bmm(x, y), torch.einsum("bij,bjk->bik", x, y)

    fc = FlopCounterMode(display=False)
    with fc:
        _, hc = analyze(prog)
    assert hc.dot_flops == 2 * 16 * 8 * 32 + 2 * (2 * 3 * 4 * 6 * 5)
    assert hc.dot_flops == fc.get_total_flops()
    assert hc.trip_counts == {}


def test_memory_bytes_of_a_known_chain_skip_views():
    x = torch.randn(4, 8)  # 128 bytes

    def prog():
        y = x + 1.0  # 128 out + 128 in
        z = y.view(8, 4).t()  # views: nothing
        w = z.reshape(-1)  # not contiguous: a copy, 128 out + 128 in
        return w * 2.0  # 128 out + 128 in

    _, hc = analyze(prog)
    assert hc.memory_bytes == 6 * 128
    assert hc.collective_bytes == 0
    assert hc.peak_live_bytes == 3 * 128  # y, the copy, the result


def test_breakdown_lists_the_top_dot():
    big, small = torch.randn(64, 64), torch.randn(4, 4)

    def prog():
        return small @ small, big @ big

    _, hc = analyze(prog, breakdown=True, top_k=1)
    assert len(hc.top_dots) == 1
    flops, what = hc.top_dots[0]
    assert flops == 2 * 64 ** 3 and "[64, 64]" in what
    assert hc.top_memory and hc.top_memory[0][0] >= 3 * 64 * 64 * 4


def test_collective_factors_are_the_reference():
    from repro.launch.hlo_analysis import COLLECTIVE_FACTOR as REF
    assert COLLECTIVE_FACTOR == REF


# ---------------------------------------------------------------------------
# contracts: the gate logic, pure (the reference's test_contracts mirrored)
# ---------------------------------------------------------------------------

GOLD = {"dot_flops": 1e9, "collective_bytes": 2e7, "memory_bytes": 5e9}


def test_within_band_passes():
    assert diff_metrics(GOLD, {k: v * 1.01 for k, v in GOLD.items()}) == []


def test_inflation_fails():
    v = diff_metrics(GOLD, dict(GOLD,
                                collective_bytes=GOLD["collective_bytes"]
                                * 1.5))
    assert len(v) == 1 and v[0]["metric"] == "collective_bytes"
    assert v[0]["why"] == "inflated" and v[0]["rel"] > 0.4


def test_deflation_fails_too():
    v = diff_metrics(GOLD, dict(GOLD, dot_flops=GOLD["dot_flops"] * 0.5))
    assert len(v) == 1 and v[0]["why"] == "deflated"


def test_missing_metric_fails():
    v = diff_metrics(GOLD, {k: x for k, x in GOLD.items()
                            if k != "memory_bytes"})
    assert len(v) == 1 and v[0]["why"] == "metric missing"


def test_perturbed_checked_in_golden_fails():
    golden = load_golden("moe_train")
    assert golden is not None, \
        "run `python -m repro_torch.analysis --update-contracts`"
    for metric in METRICS:
        bad = dict(golden["metrics"])
        bad[metric] = bad[metric] * (1 + 2 * RTOL)
        v = diff_metrics(golden["metrics"], bad)
        assert [x["metric"] for x in v] == [metric]


def test_goldens_checked_in_and_wellformed():
    for spec in CONTRACTS:
        golden = load_golden(spec.name)
        assert golden is not None, spec.name
        assert golden["arch"] == spec.arch and golden["kind"] == spec.kind
        assert golden["mesh"] == [2, 4]
        for metric in METRICS:
            assert golden["metrics"][metric] > 0, (spec.name, metric)
    # the MoE train cell exercises the gradient collectives
    assert load_golden("moe_train")["metrics"]["collective_bytes"] > 1e6


# ---------------------------------------------------------------------------
# processes on a fake process group
# ---------------------------------------------------------------------------

_FAKE = textwrap.dedent("""
    import json
    import sys
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    from repro_torch.analysis import contracts as C
    from repro_torch.launch.dryrun import fake_world, run_cell
    from repro_torch.launch.op_analysis import analyze

    out = {}
    fake_world(8)
    x = torch.randn(4, 8)  # 128 bytes
    def colls():
        dist.all_reduce(x)
        funcol.wait_tensor(funcol.all_gather_tensor(x, 0, dist.group.WORLD))
    _, hc = analyze(colls)
    out["collectives"] = [hc.collective_bytes, hc.collective_by_op,
                          hc.collective_counts]
    ok, report = C.run_contracts()
    out["contracts"] = [ok, [e["status"] for e in report["contracts"]]]
    out["cell"] = run_cell("qwen3_moe_235b_a22b", "train_4k", False,
                           opts={"num_layers": 1, "top_k": 2}, smoke=True)
    out["skip"] = run_cell("qwen2_1p5b", "long_500k", False)
    print("RESULT " + json.dumps(out))
""")


# the serving cells at smoke size on the fake 16x16 mesh, with `full_tree`
# made to raise: the prefill and decode cells lower the mesh steps, which
# gather no whole tree for any family, and so do the recurrent, hybrid and
# encoder-decoder families' train cells
_SERVE = textwrap.dedent("""
    import json
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.dryrun import (_fake_mode, build_step,
                                           fake_world, run_cell)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.tree import leaves

    def no_full_tree(tree):
        raise AssertionError("full_tree on a serving cell's path")

    SH.full_tree = ST.full_tree = no_full_tree
    MOE = {"num_layers": 1, "top_k": 2}
    out = {}
    for arch, shape, opts in (("qwen3_moe_235b_a22b", "prefill_32k", MOE),
                              ("qwen3_moe_235b_a22b", "decode_32k", MOE),
                              ("gemma3_1b", "decode_32k", {}),
                              ("gemma3_1b", "long_500k", {}),
                              ("rwkv6_7b", "decode_32k", {}),
                              ("zamba2_1p2b", "long_500k", {}),
                              ("seamless_m4t_large_v2", "decode_32k", {}),
                              ("rwkv6_7b", "train_4k", {}),
                              ("zamba2_1p2b", "train_4k", {}),
                              ("seamless_m4t_large_v2", "train_4k", {})):
        out[f"{arch}/{shape}"] = run_cell(arch, shape, False, opts=opts,
                                          smoke=True)
    # the params a rank holds in a decode cell: its stored shards
    fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    for arch in ("qwen3_moe_235b_a22b", "gemma3_1b"):
        cfg = get_config(arch).smoke()
        with _fake_mode():
            _, args, meta = build_step(cfg, "decode", 128, 1024, mesh)
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
        out[f"{arch}/param_bytes"] = [
            nbytes(t.to_local() for t in leaves(args[0])),
            nbytes(leaves(args[0])), meta["argument_bytes"]]
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    (d / "fake.py").write_text(_FAKE)
    (d / "serve.py").write_text(_SERVE)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(args, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for args in (
                 [sys.executable, str(d / "fake.py")],
                 [sys.executable, "-m", "repro_torch.launch.dryrun",
                  "--arch", "gemma3_1b", "--shape", "train_4k",
                  "--single-pod", "--out", str(d / "cell.jsonl")],
                 [sys.executable, str(d / "serve.py")])]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n\n".join(
        o[-3000:] for o in outs)
    res = []
    for out in (outs[0], outs[2]):
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out[-3000:]
        res.append(json.loads(line[-1][len("RESULT "):]))
    with open(d / "cell.jsonl") as f:
        cli = json.loads(f.readlines()[-1])
    return res[0], cli, outs[1], res[1]


def test_collectives_priced_by_the_reference_factors(fake_runs):
    total, by_op, counts = fake_runs[0]["collectives"]
    assert by_op["all-reduce"] == 2.0 * 128
    assert by_op["all-gather"] == 8 * 128  # the gathered result, 8 ranks
    assert total == 2.0 * 128 + 8 * 128
    assert counts["all-reduce"] == 1 and counts["all-gather"] == 1


def test_fresh_measure_matches_the_ports_goldens(fake_runs):
    ok, statuses = fake_runs[0]["contracts"]
    assert ok and statuses == ["ok"] * len(CONTRACTS)


def test_run_cell_on_a_fake_16x16_mesh(fake_runs):
    rec = fake_runs[0]["cell"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) - {"fake_pg"} == REF_KEYS
    assert set(rec["mem"]) == REF_MEM_KEYS
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["flops_per_device"] > 0
    assert rec["flops_per_device"] == rec["xla_cost_flops"]
    # ZeRO over data: the gradients are reduce-scattered there
    assert rec["collective_counts"]["reduce-scatter"] > 0


def test_long_500k_is_skipped_for_a_full_attention_arch(fake_runs):
    rec = fake_runs[0]["skip"]
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]


def test_dryrun_cli_prices_at_the_h100(fake_runs):
    from repro_torch.core.cost_model import H100
    _, rec, printed, _ = fake_runs
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["arch"] == "gemma3_1b" and rec["mesh"] == "16x16"
    assert rec["compute_s"] == rec["flops_per_device"] / H100.peak_flops
    assert rec["memory_s"] == rec["bytes_per_device"] / H100.hbm_bw
    assert rec["collective_s"] == \
        rec["collective_bytes_per_device"] / H100.ici_bw
    assert H100.peak_flops == 989e12  # the data sheet's, not a TPU's
    assert json.loads(printed.splitlines()[-1])["status"] == "ok"


@pytest.mark.parametrize("cell", ["qwen3_moe_235b_a22b/prefill_32k",
                                  "qwen3_moe_235b_a22b/decode_32k",
                                  "gemma3_1b/decode_32k",
                                  "gemma3_1b/long_500k",
                                  "rwkv6_7b/decode_32k",
                                  "zamba2_1p2b/long_500k",
                                  "seamless_m4t_large_v2/decode_32k"])
def test_serving_cells_lower_the_mesh_steps(fake_runs, cell):
    """The prefill and decode cells run `build_sharded_prefill_step` /
    `build_sharded_decode_step` (`full_tree` raises in that process): the
    model's collectives over "model" are there, and a decode cell's
    caches are what the step consumes in place."""
    rec = fake_runs[3][cell]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["flops_per_device"] > 0
    assert rec["collective_counts"]["all-reduce"] > 0
    if rec["kind"] == "decode":
        assert 0 < rec["mem"]["alias_mb"] <= rec["mem"]["argument_mb"]


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_1p2b",
                                  "seamless_m4t_large_v2"])
def test_family_train_cells_lower_the_tp_step(fake_runs, arch):
    """The recurrent, hybrid and encoder-decoder train cells lower
    `build_sharded_train_step` on the fake 16x16 mesh with `full_tree`
    raising: the layers' collectives over "model" are there (all-reduce)
    and the batch axes' gathers too."""
    rec = fake_runs[3][f"{arch}/train_4k"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["kind"] == "train" and rec["flops_per_device"] > 0
    assert rec["collective_counts"]["all-reduce"] > 0


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "gemma3_1b"])
def test_decode_cell_holds_the_stored_param_shards(fake_runs, arch):
    """A rank's params in a decode cell are its shards under the param
    specs: a sixteenth of the tree or less (every matrix splits over
    "model" at 16, qwen3's over "data" too), all counted in argument_mb."""
    local, whole, argument = fake_runs[3][f"{arch}/param_bytes"]
    assert 0 < local * 8 < whole
    assert local < argument


# ---------------------------------------------------------------------------
# shardcheck's mesh rules on seeded fixtures
# ---------------------------------------------------------------------------

MESH_RULES = ["sc-unknown-mesh-axis", "sc-duplicate-mesh-axis",
              "sc-spec-rank", "sc-fsdp-unknown-arch",
              "sc-unknown-logical-axis", "shard-ok-no-reason"]


def _expected(path):
    out = set()
    with open(path) as f:
        for i, line in enumerate(f, 1):
            m = re.search(r"# expect: ([\w\-, ]+)$", line.rstrip())
            if m:
                out |= {(r.strip(), path, i) for r in m.group(1).split(",")}
    return out


def _got(res):
    return {(f.rule, f.path, f.line) for f in res.findings
            if not f.suppressed}


def test_bad_mesh_fixture_findings_are_exactly_the_marked_lines():
    path = os.path.join(FIX, "bad_mesh.py")
    assert _got(port_analysis.run_static([path])) == _expected(path)


@pytest.mark.parametrize("rule", MESH_RULES)
def test_each_mesh_rule_catches_its_seeded_violation(rule):
    path = os.path.join(FIX, "bad_mesh.py")
    want = {k for k in _expected(path) if k[0] == rule}
    assert want, f"no {rule} seeded in {path}"
    got = _got(port_analysis.run_static([path]))
    assert {k for k in got if k[0] == rule} == want


def test_good_mesh_twin_is_clean():
    res = port_analysis.run_static([os.path.join(FIX, "good_mesh.py")],
                                   strict_suppressions=True)
    assert res.unsuppressed == [], [f.format() for f in res.unsuppressed]
    assert res.suppressed and all(f.reason for f in res.suppressed)
