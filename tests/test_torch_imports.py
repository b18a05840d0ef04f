"""The port imports torch and numpy, never jax, the JAX package or (at module
level) triton -- and so do the examples' twins (`examples/torch_*.py`) and
`chip_smoke.py`; its entry points import where jax cannot be imported."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(tree, module_level_only):
    nodes = tree.body if module_level_only else list(ast.walk(tree))
    if module_level_only:  # also look inside top-level try/if blocks
        nodes = [n for top in tree.body for n in ast.walk(top)
                 if not isinstance(top, (ast.FunctionDef, ast.ClassDef,
                                         ast.AsyncFunctionDef))]
    for n in nodes:
        if isinstance(n, ast.Import):
            for a in n.names:
                yield a.name.split(".")[0]
        elif isinstance(n, ast.ImportFrom) and n.level == 0 and n.module:
            yield n.module.split(".")[0]


def test_port_has_files():
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py") in FILES
    assert {p.name for p in FILES if p.parent.name == "examples"} == {
        "torch_quickstart.py", "torch_serve_asap.py",
        "torch_imbalance_demo.py", "torch_train_moe.py"}
    src = ROOT / "src" / "repro_torch"
    for sub in ("optim/adamw.py", "optim/compress.py", "data/pipeline.py",
                "checkpoint/manager.py", "runtime/fault_tolerance.py",
                "launch/steps.py", "launch/train.py", "tree.py"):
        assert src / sub in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_no_reference_no_module_level_triton(path):
    tree = ast.parse(path.read_text())
    anywhere = set(_imports(tree, module_level_only=False))
    assert not (anywhere & FORBIDDEN), \
        f"{path} imports {sorted(anywhere & FORBIDDEN)}"
    assert "triton" not in set(_imports(tree, module_level_only=True)), \
        f"{path} imports triton at module level"


def test_serve_imports_where_jax_is_unimportable(tmp_path):
    """A `jax` (and `repro`) that raises on import shadows the real ones."""
    for name in ("jax", "repro"):
        pkg = tmp_path / name
        pkg.mkdir()
        (pkg / "__init__.py").write_text(
            f"raise ImportError('{name} must not be imported by the port')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), str(ROOT / "src")])
    code = ("import repro_torch.launch.serve as s, repro_torch.bridge, "
            "repro_torch.core.engine, repro_torch.launch.tune_superkernel, "
            "repro_torch.launch.train, repro_torch.launch.steps, "
            "repro_torch.optim.adamw, repro_torch.optim.compress, "
            "repro_torch.data.pipeline, repro_torch.checkpoint.manager, "
            "repro_torch.runtime.fault_tolerance, sys; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules; "
            "print('imported', s.ARCH)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "imported qwen3_moe_235b_a22b" in out.stdout


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_asap",
                                  "torch_imbalance_demo", "torch_train_moe"])
def test_example_twins_run_where_jax_is_unimportable(tmp_path, name):
    """Each twin's --help runs with a `jax` and a `repro` that raise on
    import ahead of the real ones: it imports neither."""
    for mod in ("jax", "repro"):
        pkg = tmp_path / mod
        pkg.mkdir()
        (pkg / "__init__.py").write_text(
            f"raise ImportError('{mod} must not be imported by the port')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), str(ROOT / "src")])
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), "--help"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout
