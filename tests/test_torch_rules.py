"""Package rules of the port: it never imports jax or the JAX package, and
nothing runs quietly on the CPU when a CUDA device was asked for."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis.sproutlint import run_lint
from repro_torch.configs import reduced
from repro_torch.models import model as MD
from repro_torch.serving.engine import InferenceEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_repro(path):
    assert path.exists()
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scheduler_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.serving.scheduler; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_default_device_raises_without_cuda(monkeypatch):
    """A default-constructed model or engine asks for the card; where
    there is none it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced("granite_3_2b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MD.init_model(cfg, torch.Generator())
    params = MD.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(cfg, params, paged=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MD.init_paged_cache(cfg, 4, 16)


def test_sproutlint_stays_clean_with_the_port():
    """The lint's name-matched call graph spans all of src/, so the port's
    names join the reference's hot path; the port must add no finding."""
    res = run_lint(ROOT)
    assert res.new == [] and res.stale == [], res.render()
