"""The port stands alone: no module of vibevoice_tpu_torch and no line of
chip_smoke.py or chip_serving.py imports jax, the JAX package vibevoice_tpu
or the JAX package's demo scripts (demo/), nor reads a
file under vibevoice_tpu/, and importing every module of the port leaves
neither in sys.modules."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "vibevoice_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "vibevoice_tpu", "demo")
# a file of the JAX package named as a path: the whole string "vibevoice_tpu"
# (a path component) or a data file under vibevoice_tpu/ (prose that names
# a module, like "port of vibevoice_tpu/ops/quant.py:129", is no read)
DATA_FILE = re.compile(r"(^|[^\w])vibevoice_tpu/[^\s:]*\.(json|npz|npy|pkl|wav|safetensors)\b")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_serving.py"]


def _forbidden_imports(path: Path) -> list:
    """Every import (module level or inside a function) of a forbidden
    top-level package, and every string literal that names a path under
    vibevoice_tpu/, as (line, text)."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__") and node.args:
            arg = node.args[0]
            names = [arg.value] if isinstance(arg, ast.Constant) and isinstance(arg.value, str) else []
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if node.value == "vibevoice_tpu" or DATA_FILE.search(node.value):
                found.append((node.lineno, node.value))
        found += [(node.lineno, n) for n in names if n.split(".")[0] in FORBIDDEN]
    return found


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    assert _forbidden_imports(path) == []


def test_scan_covers_the_streaming_modules():
    """The scan picks up every module of the port by itself, the streaming
    slice's among them."""
    scanned = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"models/streaming.py", "processor/streaming_processor.py",
            "utils/preset_convert.py", "tts.py", "utils/params.py"} <= scanned


def test_scan_covers_the_serving_modules():
    """The serving slice's modules are scanned too: none may import the JAX
    package's demo/serve.py or demo/inference_from_file.py either."""
    scanned = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"serving/__init__.py", "serving/engine.py", "serving/streaming_sessions.py",
            "serving/server.py"} <= scanned


def test_scan_covers_the_checkpoint_modules():
    """The checkpoint slice's modules and its two file CLIs are scanned: the
    CLIs keep their own code, not the JAX package's demo/ scripts."""
    scanned = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"utils/torch_convert.py", "utils/safetensors_io.py", "utils/hf_interop.py",
            "demo/__init__.py", "demo/inference_from_file.py",
            "demo/streaming_inference_from_file.py", "scripts/__init__.py",
            "scripts/convert_checkpoint.py"} <= scanned


def test_scan_covers_the_parallel_modules():
    """The parallel slice's modules are scanned; so is the worker module of
    the gloo tests (tests/torch_workers.py), whose spawned ranks must not
    import JAX either."""
    scanned = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"parallel/mesh.py", "parallel/pipeline.py", "parallel/collectives.py",
            "utils/checkpoint.py"} <= scanned
    assert _forbidden_imports(ROOT / "tests" / "torch_workers.py") == []


def test_scan_catches_local_and_module_imports(tmp_path):
    """The scan itself: imports at module level, inside functions, relative
    to nothing, through importlib, and a read of the JAX package's config."""
    src = tmp_path / "m.py"
    src.write_text("import os\nimport jax.numpy as jnp\n"
                   "def f():\n    from vibevoice_tpu.configs import tiny_config\n"
                   "    import importlib; importlib.import_module('vibevoice_tpu.streamer')\n"
                   "    return open('vibevoice_tpu/configs/qwen2.5_1.5b_64k.json')\n"
                   "from . import sibling\nimport vibevoice_tpu_torch.configs\n"
                   "from demo.inference_from_file import VoiceMapper\n")
    assert [n for _, n in _forbidden_imports(src)] == [
        "jax.numpy", "demo.inference_from_file", "vibevoice_tpu.configs",
        "vibevoice_tpu.streamer", "vibevoice_tpu/configs/qwen2.5_1.5b_64k.json"]


def test_importing_the_port_loads_no_jax():
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    assert len(mods) > 30
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
