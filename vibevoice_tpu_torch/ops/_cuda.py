"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` process, all started together,
and one more ``nvcc`` links the objects into one shared library with a plain
C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c \\
         -Xcompiler -fPIC -o build/kernels/<hash>/<name>.o csrc/<name>.cu   # each
    nvcc -shared -o build/kernels/<hash>/libvibevoice_kernels.so *.o

The build happens at first use, keyed on a hash of the sources and flags,
so a fresh checkout builds everything on the first call: into
``build/kernels/<hash>/`` under a checkout, and for an installed copy (the
package inside ``site-packages``, built from ``vibevoice_tpu_torch/
pyproject.toml``, which ships the sources) into a per-user cache,
``$XDG_CACHE_HOME/vibevoice_tpu_torch/kernels`` (``~/.cache`` without it).
Nothing here runs at import time: this module is imported on hosts with no
CUDA toolkit, where only the plain PyTorch versions of the kernels run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
INSTALL_DIRS = ("site-packages", "dist-packages")


def build_root(package_dir: Path = CSRC.parent) -> Path:
    """Where the kernels are built: ``build/kernels`` beside the package in
    a checkout; a per-user cache for an installed copy, whose directory may
    not be writable."""
    if package_dir.parent.name in INSTALL_DIRS:
        cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(Path.home(), ".cache")
        return Path(cache) / "vibevoice_tpu_torch" / "kernels"
    return package_dir.parent / "build" / "kernels"

LIB_NAME = "libvibevoice_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# dtype codes of the C interface (csrc/common.cuh)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "vv_int8_matmul": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "vv_int8_gemm": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _P],
    "vv_flash_prefill": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "vv_flash_decode": [
        _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ],
    "vv_fused_head_ffn_stack": [
        _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P,
    ],
    "vv_fused_stage_step": [
        _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P,
    ],
    "vv_int8_matmul_t": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vv_flash_train_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "vv_flash_train_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "vv_flash_train_split": [_P, _P, _P, _P, _P, _I, _I, _P],
    "vv_flash_train_walk": [_P, _P, _P, _I, _I, _P],
    "vv_flash_train_fwd_tc": [_P] * 10 + [_I, _I, _I, _I, _I, _F, _P],
    "vv_flash_train_bwd_tc": [_P] * 18 + [_I, _I, _I, _I, _I, _F, _P],
    "vv_flash_ring_block": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ],
}


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, cdll: ctypes.CDLL, path: Path, build_seconds: float, build_log: str):
        self.cdll = cdll
        self.path = path
        self.build_seconds = build_seconds  # wall time of the parallel build; 0.0 if reused
        self.build_log = build_log

    def call(self, name: str, *args) -> None:
        """Run one C entry point; raise if it reports a CUDA error."""
        err = getattr(self.cdll, name)(*args)
        if err != 0:
            msg = self.cdll.vv_error_string(err).decode()
            raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


_lock = threading.Lock()
_lib: KernelLibrary | None = None

# Every kernel's launch counter, (wrapper, attribute) by the name that
# chip_smoke.py reports it under. A wrapper adds one to its attribute where
# it launches its kernel, and nowhere else; kernels A and B count their
# second route, the training attention its CUDA-core route, in a second
# attribute. A graph replay runs no wrapper: the step function that
# replays it adds the counts it recorded at capture (models/inference.py).
LAUNCH_COUNTERS: dict = {}


def count_launches(name: str, fn, attr: str = "launches") -> None:
    """Give ``fn`` the launch counter ``attr``, at 0, listed as ``name``."""
    setattr(fn, attr, 0)
    LAUNCH_COUNTERS[name] = (fn, attr)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (CUDA_HOME)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _build() -> KernelLibrary:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = build_root() / h.hexdigest()[:16]
    so = out_dir / LIB_NAME
    seconds, log = 0.0, ""
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
        t0 = time.perf_counter()
        jobs = []
        for src in cu:
            obj = out_dir / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                failed.append(cmd)
        tmp = out_dir / f"{LIB_NAME}.{tag}"
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}")
            if res.returncode != 0:
                failed.append(cmd)
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed ({' '.join(failed[0])}):\n{log}")
        os.replace(tmp, so)
        (out_dir / "build.log").write_text(log)
    cdll = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    cdll.vv_error_string.argtypes = [ctypes.c_int]
    cdll.vv_error_string.restype = ctypes.c_char_p
    return KernelLibrary(cdll, so, seconds, log)


def library() -> KernelLibrary:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
        return _lib


def dtype_code(t: torch.Tensor) -> int:
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"no CUDA kernel takes dtype {t.dtype}") from None


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def workspace_key(device: torch.device):
    """The key of the kernels' persistent workspaces and arrival counters on
    ``device`` (kernel A's GEMV, C and D: ``quant._gemv_workspace``; B's
    decode: ``flash_attention._counters``): the device for its default
    stream and for CUDA-graph captures (whose replays run there), the
    (device, stream) pair for any other stream. So work on a side stream,
    the serving engine's prefill, never shares them with the default
    stream's launches, which may run at the same time."""
    stream = torch.cuda.current_stream(device)
    if stream == torch.cuda.default_stream(device) or torch.cuda.is_current_stream_capturing():
        return device
    return (device, stream.cuda_stream)


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors on {dev}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"expected a contiguous tensor, got shape {tuple(t.shape)} "
                             f"with strides {t.stride()}")

