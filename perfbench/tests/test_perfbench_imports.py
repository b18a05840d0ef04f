"""What the harness imports, compared by whole top-level names."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _top_imports(path: pathlib.Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_imports(path) & BANNED


def test_whole_names_are_compared():
    # repro_torch begins with repro and is allowed; repro is not
    src = "import repro_torch.core\nfrom repro.models import x\n"
    tmp = ast.parse(src)
    names = {a.name.split(".")[0] for n in ast.walk(tmp)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tmp)
              if isinstance(n, ast.ImportFrom)}
    assert names & BANNED == {"repro"}


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _top_imports(path) <= {"__future__", "math", "typing", "torch"}


def test_harness_process_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "import perfbench.run, perfbench.cell, perfbench.check;"
            "import perfbench.manifest as m;"
            "[m.plan(w['name']) for w in m.load()['workloads']];"
            "import repro_torch.core.engine, repro_torch.core.executor;"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not loaded & BANNED
