"""The port stands alone: no JAX, nothing of the JAX package.

Every module of ``repro_torch`` imports with ``jax`` and ``repro`` blocked,
no source under ``src/repro_torch/`` (nor ``chip_smoke.py``) names either in
an import, and ``chip_smoke.py`` refuses to run without a CUDA card.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_port_module_imports_without_jax_or_repro():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_no_jax_or_repro_import_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        f"{p.relative_to(REPO)}:{line} imports {root}"
        for p in files
        for line, root in _imported_roots(p)
        if root in FORBIDDEN
    ]
    assert bad == []


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card (here: none) it exits nonzero, says why and prints no
    result line; alone in a directory it exits nonzero as well."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
        text=True, env=env, timeout=120, cwd=str(tmp_path),
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert '"ok"' not in proc.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        env=env, timeout=120, cwd=str(alone),
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_entry_points_raise_without_a_card(device):
    """Entry points default to the card and never fall back to the CPU."""
    import torch

    from repro_torch.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(device).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(device)
    assert resolve_device("cpu").type == "cpu"
