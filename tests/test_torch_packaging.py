"""The port's build file (vibevoice_tpu_torch/pyproject.toml) against its
source tree, a wheel built offline from a copy of the package, and where
an installed copy builds its kernels (ops/_cuda.build_root)."""

import os
import shutil
import subprocess
import sys
import tomllib
import zipfile
from pathlib import Path

from vibevoice_tpu_torch.ops import _cuda

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "vibevoice_tpu_torch"


def _pyproject():
    with open(PKG / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def _packages(root: Path) -> set:
    """Every directory with an __init__.py under the package, dotted."""
    return {"vibevoice_tpu_torch" + "".join("." + p for p in d.relative_to(root).parts)
            for d in [root, *root.rglob("*")] if (d / "__init__.py").is_file()
            and "build" not in d.relative_to(root).parts}


def test_package_list_matches_source_tree():
    """The build file maps the package onto its own directory and lists
    every package of the source tree; its data are the CUDA sources and the
    config JSONs."""
    tool = _pyproject()["tool"]["setuptools"]
    assert tool["package-dir"] == {"vibevoice_tpu_torch": "."}
    declared = set(tool["packages"])
    actual = _packages(PKG)
    assert declared == actual, f"missing={actual - declared}, stale={declared - actual}"
    data = tool["package-data"]["vibevoice_tpu_torch"]
    assert set(data) == {"csrc/*.cu", "csrc/*.cuh", "configs/*.json"}
    assert _pyproject()["project"]["name"] == "vibevoice-tpu-torch"
    assert not any("jax" in d for d in _pyproject()["project"]["dependencies"])


def test_wheel_carries_sources_and_configs(tmp_path):
    """pip builds a wheel offline (no index, no build isolation) from a copy
    of the package; it holds every module, every csrc/*.cu and *.cuh and
    every configs/*.json."""
    src = tmp_path / "vibevoice_tpu_torch"
    shutil.copytree(PKG, src, ignore=shutil.ignore_patterns("__pycache__", "build",
                                                            "*.egg-info"))
    want = {"vibevoice_tpu_torch/" + str(p.relative_to(src)) for pattern in
            ("csrc/*.cu", "csrc/*.cuh", "configs/*.json", "**/*.py") for p in src.glob(pattern)}
    res = subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps",
                          "--no-build-isolation", "--no-index", "-q", str(src), "-w",
                          str(tmp_path / "dist")], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PIP_NO_INPUT": "1"})
    assert res.returncode == 0, res.stdout + res.stderr
    (wheel,) = (tmp_path / "dist").glob("vibevoice_tpu_torch-*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    assert len([n for n in want if n.endswith(".cu")]) >= 9
    assert want <= names, sorted(want - names)[:10]


def test_build_root_checkout_and_installed(tmp_path, monkeypatch):
    """In a checkout the kernels build into build/kernels beside the
    package (gitignored); an installed copy (the package under
    site-packages or dist-packages) builds into the user's cache."""
    assert _cuda.build_root() == REPO / "build" / "kernels"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    for site in ("site-packages", "dist-packages"):
        installed = tmp_path / "lib" / site / "vibevoice_tpu_torch"
        assert _cuda.build_root(installed) == tmp_path / "cache" / "vibevoice_tpu_torch" / "kernels"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert (_cuda.build_root(tmp_path / "site-packages" / "vibevoice_tpu_torch")
            == tmp_path / "home" / ".cache" / "vibevoice_tpu_torch" / "kernels")
