"""The port's asaplint (`repro_torch.analysis`) held against the reference's
(`repro.analysis`) on the same inputs: lockcheck's findings and lock-order
graph on the reference's fixtures and on the port's core, the runtime
lockdep's violations on the same acquisition sequences (both sanitizers),
every new rule of the host-sync, launch-contract and dtype-policy passes on
a seeded fixture (`tests/fixtures/torch_analysis/`, the flagged lines marked
`expect: <rule>`) and its clean twin, the CLI, and the port's whole tree
clean under both analyzers with `--strict-suppressions`.  CPU only: no pass
needs nvcc or a card."""
import json
import os
import re
import subprocess
import sys
import threading
import time

import pytest

import repro.analysis as ref_analysis
import repro_torch.analysis as port_analysis
from repro.analysis import lockdep as ref_lockdep
from repro.analysis.model import build_models as ref_build_models
from repro.analysis.model import collect_files as ref_collect_files
from repro_torch.analysis import lockdep as port_lockdep
from repro_torch.analysis.__main__ import main as port_main
from repro_torch.analysis.kernelcheck import (C_TO_CTYPES, c_type,
                                              parse_declare, parse_externs)
from repro_torch.analysis.model import build_models as port_build_models
from repro_torch.analysis.model import collect_files as port_collect_files

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIX = os.path.join("tests", "fixtures", "analysis")
FIX = os.path.join("tests", "fixtures", "torch_analysis")
PORT = os.path.join("src", "repro_torch")
PORT_CORE = os.path.join(PORT, "core")

SANITIZERS = [pytest.param(ref_lockdep, id="reference"),
              pytest.param(port_lockdep, id="port")]


@pytest.fixture(autouse=True)
def _at_root(monkeypatch):
    """Relative paths, as the CLI and the reference's tests take them."""
    monkeypatch.chdir(ROOT)


def _key(findings):
    return sorted((f.rule, os.path.normpath(f.path), f.line, f.suppressed)
                  for f in findings)


def _ref_models(paths):
    return ref_build_models(ref_collect_files(paths))


def _port_models(paths):
    return port_build_models(port_collect_files(paths))


def _expected(paths):
    """(rule, path, line) of every `expect: <rule>[, <rule>...]` mark."""
    out = set()
    for path in paths:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                m = re.search(r"(?:#|//) expect: ([\w\-, ]+)$", line.rstrip())
                if m:
                    for rule in m.group(1).split(","):
                        out.add((rule.strip(), os.path.normpath(path), i))
    return out


def _got(result):
    """(rule, path, line) of every unsuppressed finding."""
    return {(f.rule, os.path.normpath(f.path), f.line)
            for f in result.unsuppressed}


# ---------------------------------------------------------------------------
# section 0: the port's tree is clean under both analyzers
# ---------------------------------------------------------------------------


def test_reference_analysis_of_port_is_clean_strict():
    """The reference's asaplint over the whole port with stale suppressions
    failing: every guarded access carries its justification on the line the
    pass reports, and no suppression is left over."""
    res = ref_analysis.run_static([PORT], strict_suppressions=True)
    assert res.unsuppressed == [], \
        "\n".join(f.format() for f in res.unsuppressed)
    assert res.suppressed and all(f.reason for f in res.suppressed)


def test_port_analysis_of_port_is_clean_strict():
    res = port_analysis.run_static([PORT], strict_suppressions=True)
    assert res.unsuppressed == [], \
        "\n".join(f.format() for f in res.unsuppressed)
    assert all(f.reason for f in res.suppressed)
    rules = {f.rule for f in res.suppressed}
    # the port's own passes consumed their in-tree justifications
    assert {"unguarded-access", "sync-uncounted"} <= rules
    assert {m.path for m in port_analysis.build_models(
        port_collect_files([PORT])).values() if m.lang == "cu"}


# ---------------------------------------------------------------------------
# lockcheck: the port's pass == the reference's on the same files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", [
    os.path.join(REF_FIX, "bad_locks.py"),
    os.path.join(REF_FIX, "good_locks.py"),
    os.path.join(REF_FIX, "stale_suppress.py"),
    PORT_CORE,
], ids=["bad_locks", "good_locks", "stale_suppress", "port_core"])
def test_check_locks_matches_reference(path):
    want = _key(ref_analysis.check_locks(_ref_models([path])))
    got = _key(port_analysis.check_locks(_port_models([path])))
    assert got == want
    if "bad_locks" in path:
        assert {r for r, *_ in got} >= {
            "unguarded-access", "foreign-access", "naked-wait",
            "acquire-no-release", "lock-order-cycle", "race-ok-no-reason"}


@pytest.mark.parametrize("name", ["bad_locks.py", "good_locks.py",
                                  "stale_suppress.py"])
def test_strict_lock_findings_match_reference(name):
    """The whole strict run over a reference fixture: the same lock
    findings and the same stale race-ok comments."""
    path = os.path.join(REF_FIX, name)
    lock_rules = {"unguarded-access", "foreign-access", "naked-wait",
                  "acquire-no-release", "lock-order-cycle",
                  "race-ok-no-reason", "stale-suppression"}
    want = [k for k in _key(ref_analysis.run_static(
        [path], strict_suppressions=True).findings) if k[0] in lock_rules]
    got = [k for k in _key(port_analysis.run_static(
        [path], strict_suppressions=True).findings) if k[0] in lock_rules]
    assert got == want
    if name == "stale_suppress.py":
        assert [k[0] for k in got] == ["stale-suppression"]


def test_core_lock_order_graph_matches_reference_and_golden():
    """The static lock order of the port's core equals the reference's
    analysis of the same files, and is pinned: a change that nests these
    locks another way round (or adds a cross-class nesting) updates this
    list consciously, as tests/test_analysis.py pins the reference's."""
    edges = set(port_analysis.lock_order_edges(_port_models([PORT_CORE])))
    assert edges == set(ref_analysis.lock_order_edges(
        _ref_models([PORT_CORE])))
    golden = {
        # placement-swap serializer (rebalance and failover) -> gate
        # freeze, migration log, quiesce polls of the buffer flags
        ("DisaggregatedExecutor._swap_lock", "DisaggregatedExecutor._gate_cv"),
        ("DisaggregatedExecutor._swap_lock", "DisaggregatedExecutor._log_lock"),
        ("DisaggregatedExecutor._swap_lock", "MoEDeviceBuffer._cv"),
        ("DisaggregatedExecutor._swap_lock", "Bitmap._cv"),
        # rebalance tick -> apply_placement's serializer and its closure
        ("ExecutorEngine._rebalance_lock", "DisaggregatedExecutor._swap_lock"),
        ("ExecutorEngine._rebalance_lock", "DisaggregatedExecutor._gate_cv"),
        ("ExecutorEngine._rebalance_lock", "DisaggregatedExecutor._log_lock"),
        ("ExecutorEngine._rebalance_lock", "ExecutorEngine._lock"),
        ("ExecutorEngine._rebalance_lock", "MoEDeviceBuffer._cv"),
        ("ExecutorEngine._rebalance_lock", "Bitmap._cv"),
        ("ExecutorEngine._rebalance_lock", "RouterStatsCollector._lock"),
        # any_pending holds the shared cv and re-enters it through
        # Bitmap.any_set: statically two nodes, at runtime one lock
        ("MoEDeviceBuffer._cv", "Bitmap._cv"),
    }
    assert edges == golden, sorted(edges)


def test_cli_order_prints_the_graph(capsys):
    assert port_main([PORT_CORE, "--order"]) == 0
    out = capsys.readouterr().out
    assert "-- static lock-order graph:" in out
    assert "ExecutorEngine._rebalance_lock -> " \
           "DisaggregatedExecutor._swap_lock" in out


# ---------------------------------------------------------------------------
# lockdep: the port's sanitizer gives the reference's violations
# ---------------------------------------------------------------------------


def _abba(ld):
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with a:  # reverse nesting: no deadlock needed to catch it
            pass


def _held_wait():
    lk = threading.Lock()
    cv = threading.Condition()

    def waker():
        time.sleep(0.05)
        with cv:
            cv.notify_all()

    t = threading.Thread(target=waker)
    t.start()
    with lk:  # sleeping with an unrelated lock held
        with cv:
            cv.wait(timeout=2.0)
    t.join(timeout=10)


@pytest.mark.parametrize("ld", SANITIZERS)
def test_lockdep_catches_abba_inversion(ld):
    with ld.lockdep_active(raise_on_violation=False):
        _abba(ld)
        kinds = [v.kind for v in ld.violations()]
    ld.reset()
    assert kinds == ["order-inversion"]


@pytest.mark.parametrize("ld", SANITIZERS)
def test_lockdep_raises_at_the_offending_acquire(ld):
    with ld.lockdep_active(raise_on_violation=True):
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with pytest.raises(ld.LockOrderViolation):
            with b:
                with a:
                    pass
    ld.reset()


@pytest.mark.parametrize("ld", SANITIZERS)
def test_lockdep_catches_held_lock_wait(ld):
    with ld.lockdep_active(raise_on_violation=False):
        _held_wait()
        kinds = [v.kind for v in ld.violations()]
    ld.reset()
    assert kinds == ["held-lock-wait"]


@pytest.mark.parametrize("ld", SANITIZERS)
def test_lockdep_exempts_wait_on_own_lock_alias(ld):
    """The engine's `_done_cv = Condition(self._lock)` pattern: waiting on a
    cv while holding (only) its own underlying lock is the protocol."""
    with ld.lockdep_active(raise_on_violation=True):
        lk = threading.Lock()
        cv = threading.Condition(lk)

        def waker():
            time.sleep(0.02)
            with cv:
                cv.notify_all()

        t = threading.Thread(target=waker)
        t.start()
        with cv:
            cv.wait(timeout=2.0)
        t.join(timeout=10)
        assert ld.violations() == []
    ld.reset()


@pytest.mark.parametrize("ld", SANITIZERS)
def test_lockdep_order_is_global_across_threads(ld):
    """Thread 1 establishes A->B; thread 2 acquiring B->A is flagged even
    though the two threads never contend."""
    with ld.lockdep_active(raise_on_violation=False):
        a = threading.Lock()
        b = threading.Lock()

        def t1():
            with a:
                with b:
                    pass

        def t2():
            with b:
                with a:
                    pass

        for fn in (t1, t2):
            th = threading.Thread(target=fn)
            th.start()
            th.join(timeout=10)
        kinds = [v.kind for v in ld.violations()]
    ld.reset()
    assert kinds == ["order-inversion"]


@pytest.mark.parametrize("ld", SANITIZERS)
def test_lockdep_uninstall_restores_threading(ld):
    already = ld.active()
    before = (threading.Lock, threading.RLock, threading.Condition)
    with ld.lockdep_active():
        if not already:
            assert threading.Condition is not before[2]
        assert ld.active()
    ld.reset()
    assert (threading.Lock, threading.RLock, threading.Condition) == before


def test_lockdep_same_violations_and_edges_as_reference():
    """One sequence -- an order learned, inverted, then a wait under an
    unrelated lock -- under each sanitizer in turn: the same violation
    kinds in the same order, and the same learned creation-site edges
    (sites are file:line, so both sanitizers key the locks alike)."""
    seen = {}
    for name, ld in (("reference", ref_lockdep), ("port", port_lockdep)):
        ld.reset()
        with ld.lockdep_active(raise_on_violation=False):
            _abba(ld)
            _held_wait()
            seen[name] = ([v.kind for v in ld.violations()],
                          sorted(ld.learned_edges()))
        ld.reset()
    assert seen["port"] == seen["reference"]
    assert seen["port"][0] == ["order-inversion", "held-lock-wait"]
    assert all(a.startswith("tests") for a, _b in seen["port"][1])


def test_port_lockdep_keys_sites_from_its_own_root():
    assert port_lockdep.REPO_ROOT == ref_lockdep.REPO_ROOT == ROOT


def test_port_lockdep_records_instrumented_sites():
    """What a clean run covered: the creation site of every lock and
    condition it instrumented, cleared by reset()."""
    port_lockdep.reset()
    with port_lockdep.lockdep_active():
        lk = threading.Lock()
        cv = threading.Condition(lk)
        line = sys._getframe().f_lineno
        with cv:
            pass
        sites = port_lockdep.instrumented_sites()
    here = os.path.join("tests", "test_torch_analysis.py")
    assert {f"{here}:{line - 2}", f"{here}:{line - 1}"} <= sites
    port_lockdep.reset()
    assert port_lockdep.instrumented_sites() == set()


# ---------------------------------------------------------------------------
# passes 6-8: each rule on its seeded fixture, each good twin clean
# ---------------------------------------------------------------------------

BAD = {
    "sync": [os.path.join(FIX, "bad_sync.py")],
    "launch": [os.path.join(FIX, "bad_launch.py"),
               os.path.join(FIX, "bad_launch.cu")],
    "dtype": [os.path.join(FIX, "bad_dtype.py")],
}
GOOD = {
    "sync": [os.path.join(FIX, "good_sync.py")],
    "launch": [os.path.join(FIX, "good_launch.py"),
               os.path.join(FIX, "good_launch.cu")],
    "dtype": [os.path.join(FIX, "good_dtype.py")],
}
NEW_RULES = [
    ("sync", "sync-uncounted"), ("sync", "launch-under-lock"),
    ("sync", "sync-under-lock"), ("sync", "sync-ok-no-reason"),
    ("launch", "kc-abi-arity"), ("launch", "kc-abi-type"),
    ("launch", "kc-abi-undeclared"), ("launch", "kc-abi-unknown"),
    ("launch", "kc-unchecked-launch"), ("launch", "kc-uncounted-launch"),
    ("launch", "kernel-ok-no-reason"),
    ("dtype", "sc-f64-literal"), ("dtype", "sc-bf16-accum"),
    ("dtype", "shard-ok-no-reason"),
]


@pytest.mark.parametrize("fixture", sorted(BAD))
def test_bad_fixture_findings_are_exactly_the_marked_lines(fixture):
    res = port_analysis.run_static(BAD[fixture])
    assert _got(res) == _expected(BAD[fixture])


@pytest.mark.parametrize("fixture,rule", NEW_RULES,
                         ids=[r for _f, r in NEW_RULES])
def test_each_new_rule_catches_its_seeded_violation(fixture, rule):
    res = port_analysis.run_static(BAD[fixture])
    want = {k for k in _expected(BAD[fixture]) if k[0] == rule}
    assert want, f"no {rule} seeded in {BAD[fixture]}"
    assert {k for k in _got(res) if k[0] == rule} == want


@pytest.mark.parametrize("fixture", sorted(GOOD))
def test_good_twin_is_clean(fixture):
    res = port_analysis.run_static(GOOD[fixture], strict_suppressions=True)
    assert res.unsuppressed == [], [f.format() for f in res.unsuppressed]
    # the deliberate suppression is still recorded, with its reason
    assert res.suppressed and all(f.reason for f in res.suppressed)


def test_host_sync_messages_name_what_synced():
    res = port_analysis.run_static(BAD["sync"])
    msgs = " ".join(f.message for f in res.by_rule("sync-uncounted"))
    for what in (".item()", "int() of a tensor", ".cpu()", ".tolist()",
                 "torch.cuda.synchronize()", "CUDA stream or event"):
        assert what in msgs
    assert ".numpy()" not in msgs  # a .cpu() result lies on the host
    locked = res.by_rule("launch-under-lock")
    assert any("_build.load()" in f.message for f in locked)
    assert any("toy_twice()" in f.message for f in locked)  # by closure


def test_abi_messages_name_the_mismatch():
    res = port_analysis.run_static(BAD["launch"])
    types = " ".join(f.message for f in res.by_rule("kc-abi-type"))
    assert "C `long long` (ctypes c_longlong) but argtypes says c_int" in types
    assert "C `double` (no ctypes mapping)" in types
    assert "restype is c_longlong" in types
    arity = res.by_rule("kc-abi-arity")
    assert len(arity) == 1 and "3 entries" in arity[0].message \
        and "takes 4" in arity[0].message


@pytest.mark.parametrize("param,want", [
    ("const void* q", "void*"), ("void* stream", "void*"),
    ("const long long* strides", "void*"), ("int n", "int"),
    ("long long x_stride", "long long"), ("float sm_scale", "float"),
    ("int", "int"), ("double x", "double"), ("unsigned int n", "unsigned int"),
])
def test_c_parameter_types_normalize(param, want):
    assert c_type(param) == want


def test_abi_pass_reads_every_entry_point_of_the_port():
    """Pass 7 sees the port's eight `extern "C"` launch functions and the
    eight `_declare` entries, and they agree position by position."""
    models = _port_models([PORT])
    externs = {s.name: s for fm in models.values() if fm.lang == "cu"
               for s in parse_externs(fm)}
    declared = {d.name: d for fm in models.values() if fm.lang == "py"
                for d in parse_declare(fm)}
    names = {"super_gmm_launch", "flash_attention_launch",
             "flash_attention_bwd_launch", "dispatch_scatter_launch",
             "combine_gather_launch", "dispatch_whole_launch",
             "combine_weighted_launch", "combine_weighted_bwd_launch"}
    assert set(externs) == set(declared) == names
    for name in names:
        assert externs[name].ret == "int"
        assert declared[name].restype == "c_int"
        assert declared[name].argtypes == [C_TO_CTYPES[c] for c in
                                           externs[name].params], name


def test_strict_flags_stale_port_suppressions():
    paths = [os.path.join(FIX, "stale_suppress.py"),
             os.path.join(FIX, "stale_suppress.cu")]
    assert port_analysis.run_static(paths).findings == []
    res = port_analysis.run_static(paths, strict_suppressions=True)
    want = set()
    for path in paths:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if re.search(r"(sync|kernel|shard)-ok: \S", line):
                    want.add(("stale-suppression", os.path.normpath(path), i))
    assert len(want) == 3 and _got(res) == want
    assert any(f.message.startswith("`// kernel-ok:") for f in res.findings)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_exits_zero_on_the_tree(capsys):
    assert port_main([PORT, "--strict-suppressions"]) == 0
    assert "0 unsuppressed" in capsys.readouterr().out


@pytest.mark.parametrize("fixture", sorted(BAD))
def test_cli_exits_one_on_a_bad_fixture(fixture, capsys):
    assert port_main(BAD[fixture]) == 1
    out = capsys.readouterr().out
    assert re.search(r"[1-9]\d* unsuppressed", out)


def test_cli_json_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert port_main(BAD["launch"] + ["--json", str(out)]) == 1
    rep = json.loads(out.read_text())
    assert rep["summary"]["unsuppressed"] == len(_expected(BAD["launch"]))
    assert {f["rule"] for f in rep["findings"]} >= {"kc-abi-arity",
                                                    "kc-unchecked-launch"}
    assert "lock_order" in rep


def test_module_entry_point_defaults_to_core():
    """`python -m repro_torch.analysis` with no path: the port's core."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--strict-suppressions"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n = len(port_collect_files([PORT_CORE]))
    assert f"asaplint: {n} file(s)" in out.stdout
    assert "0 unsuppressed" in out.stdout


# ---------------------------------------------------------------------------
# chip_smoke.py's reading of ptxas's report (the analysis phase's gate)
# ---------------------------------------------------------------------------

PTXAS_SAMPLE = """\
== flash_attention.cu
ptxas info    : Compiling entry function '_ZN2wg18flash_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_NS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN2wg18flash_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_NS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 200000 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN4wgbw26flash_bwd_dkdv_wide_kernelILi192EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4wgbw26flash_bwd_dkdv_wide_kernelILi192EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 194 registers, used 1 barriers, 232024 bytes smem, 400 bytes cmem[0]
== super_gmm.cu
ptxas info    : Compiling entry function '_Z20super_gmm_f32_kernelPKiS0_PKfS2_Pfiiiiiixx' for 'sm_90a'
ptxas info    : Function properties for _Z20super_gmm_f32_kernelPKiS0_PKfS2_Pfiiiiiixx
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, 400 bytes cmem[0]
"""


def test_chip_smoke_reads_ptxas_report():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    got = cs.ptxas_kernels(PTXAS_SAMPLE)
    assert got == {
        "wg::flash_wgmma_kernel<128>": {"registers": 168, "spill": 0},
        "wgbw::flash_bwd_dkdv_wide_kernel<192>": {"registers": 194,
                                                  "spill": 0},
        "super_gmm_f32_kernel": {"registers": 64, "spill": 12}}
    assert cs._demangle("_Z22super_gmm_wgmma_kernelILi128ELi256EEvPKi") \
        == "super_gmm_wgmma_kernel<128, 256>"
    # every wgmma kernel the gate names is a __global__ of the sources
    names = set()
    for cu in ("flash_attention.cu", "super_gmm.cu"):
        with open(os.path.join(PORT, "csrc", cu)) as f:
            names |= set(re.findall(r"\b(\w+_kernel)\(", f.read()))
    assert set(cs.WGMMA_KERNELS) <= names
