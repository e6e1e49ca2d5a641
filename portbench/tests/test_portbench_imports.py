"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Module names are compared by their
whole top-level name: ``hydragen_torch`` shares its first letters with
``hydragen_tpu``."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "hydragen_tpu"}


def imported_tops(path: Path) -> set:
    """Top-level names of every module a source file imports."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def sources():
    return sorted(p for p in PKG.rglob("*.py") if "tests" not in p.relative_to(PKG).parts)


def test_no_source_imports_jax_or_the_jax_package():
    bad = {str(p.relative_to(ROOT)): sorted(imported_tops(p) & FORBIDDEN) for p in sources()}
    assert not {k: v for k, v in bad.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    for p in sorted((PKG / "reference").rglob("*.py")):
        assert "hydragen_torch" not in imported_tops(p), p
        assert not imported_tops(p) & FORBIDDEN, p
    assert "hydragen_torch" not in imported_tops(PKG / "check.py")


def test_what_a_run_loads_holds_no_jax():
    """Every module of the benchmark and of the program the drivers reach,
    imported in a fresh process (as the command does): no forbidden
    top-level name in ``sys.modules``."""
    code = (
        "import sys, json, importlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import portbench.run, portbench.calibrate, portbench.sweep\n"
        "import hydragen_torch, hydragen_torch.core.batching, hydragen_torch.ops.quant\n"
        "from portbench import run\n"
        "for kind in ('generate', 'serve'):\n"
        "    run.load_module(run.Path(run.__file__).parent / 'drivers' / f'{kind}.py', kind)\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "hydragen_torch" in tops
    assert not tops & FORBIDDEN


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hydragen_tpux", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    for name in FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.delitem(sys.modules, "jax.numpy", raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("cwd", ["repo", "bare"])
def test_the_command_prints_no_result_without_a_card_or_the_program(tmp_path, cwd):
    """Without a CUDA device the command exits nonzero and prints nothing on
    standard output; so it does from a directory that holds only
    ``BENCHMARK.json`` and ``portbench/``."""
    where = ROOT
    if cwd == "bare":
        where = tmp_path
        subprocess.run(["cp", "-r", str(PKG), str(ROOT / "BENCHMARK.json"), str(tmp_path)],
                       check=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cmd = bench["command"] + ["--workload", bench["workloads"][0]["name"], "--seed",
                              "4294967301", "--seconds", "1", "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=where, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
