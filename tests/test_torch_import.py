"""The port stands alone: it loads neither JAX nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU.

The import checks run in a subprocess, because this test process has JAX
loaded already (``tests/conftest.py``).
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch import kernels
kernels.register_all()
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                or m.startswith("jaxlib.") or m == "repro"
                or m.startswith("repro."))
print(json.dumps({{"modules": names, "loaded": loaded}}))
"""


def _probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=str(SRC), root=str(ROOT))],
        capture_output=True, text=True, env=env, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_importing_the_whole_port_loads_no_jax_and_no_repro():
    out = _probe()
    assert out["loaded"] == []
    mods = set(out["modules"])
    for name in ("repro_torch.serve.engine", "repro_torch.launch.serve",
                 "repro_torch.models.convert", "repro_torch.kernels.build",
                 "repro_torch.kernels.matmul.ops",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.bilinear.ops",
                 "repro_torch.kernels.ssd.ops", "repro_torch.kernels.rglru.ops",
                 "repro_torch.core.autotuner", "repro_torch.core.policy",
                 "repro_torch.core.plans", "repro_torch.launch.measure",
                 "repro_torch.launch.compile_plans"):
        assert name in mods


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_file_imports_jax_or_repro(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_cuda_sources_are_beside_the_port():
    csrc = PORT / "kernels" / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == [
        "bilinear.cu", "flash_attention.cu", "flash_decode.cu", "matmul.cu",
        "rglru.cu", "ssd.cu"]
    from repro_torch.kernels import build
    assert sorted(build.SOURCES.values()) == sorted(
        p.name for p in csrc.glob("*.cu"))
    for p in csrc.glob("*.cu"):
        text = p.read_text()
        assert "Replaces:" in text and 'extern "C"' in text
        assert "torch/extension.h" not in text


def test_entry_points_need_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.models.convert import params_from_jax
    from repro_torch.serve import ServeEngine

    cfg = configs.get_smoke("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.make_serve_state(cfg, 1, 16, torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(cfg, {"segments": []})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])
    params = api.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
    eng = ServeEngine(cfg, params, device="cpu")
    assert eng.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without a card, or without the repository beside it, the smoke script
    exits non-zero and prints no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [subprocess.run([sys.executable, str(lone)], capture_output=True,
                           text=True, env=env, timeout=120, cwd=tmp_path)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
            text=True, env=env, timeout=120, cwd=ROOT))
    for proc in runs:
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
