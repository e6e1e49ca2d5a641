"""The port stands alone: no JAX, nothing of the JAX package, lazy kernels.

Scans every ``.py`` under ``hydragen_torch/`` and ``chip_smoke.py`` for an
import of ``jax`` or of ``hydragen_tpu`` (docstrings and kernel notes may
name the JAX package's files: they say what each piece replaces), and checks
that ``import hydragen_torch`` and ``import chip_smoke`` work in a fresh
interpreter that cannot import ``jax``, ``hydragen_tpu`` or ``triton`` and
has no ``nvcc`` on its path: no kernel is built or loaded at import.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "hydragen_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BAD = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|hydragen_tpu)\b"
    r"|import_module\(\s*[\"'](jax|jaxlib|hydragen_tpu)\b"
    r"|__import__\(\s*[\"'](jax|jaxlib|hydragen_tpu)\b",
    re.M,
)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package(path):
    assert path.exists(), path
    hits = [m.group(0) for m in BAD.finditer(path.read_text())]
    assert not hits, f"{path.relative_to(ROOT)}: {hits}"


def test_import_without_jax_triton_or_nvcc(tmp_path):
    # A meta-path hook makes jax and triton unimportable in the child.
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'triton', 'hydragen_tpu'):\n"
        "            raise ImportError(name + ' blocked')\n"
        "        return None\n"
        "sys.meta_path.insert(0, _Block())\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), str(ROOT)])
    env["PATH"] = "/nonexistent"
    env["CUDA_HOME"] = "/nonexistent"
    code = (
        "import sys, hydragen_torch\n"
        "from hydragen_torch.ops import cuda_lib, gemm, flash, decode\n"
        "from hydragen_torch.core import engine, cache\n"
        "from hydragen_torch.scripts import quality, ubench_gemm, ubench_unique\n"
        "import chip_smoke\n"
        "assert not any(m.split('.')[0] in ('jax', 'triton', 'hydragen_tpu') for m in sys.modules)\n"
        "assert not cuda_lib._LIBS\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
