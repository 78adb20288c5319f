"""Build and load the port's CUDA kernels: `nvcc`, one shared library.

Each source in ``morfem_tpu_torch/csrc/*.cu`` is compiled by its own
`nvcc`, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
         -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu

and the objects are linked by one more (``nvcc -shared``) into
``morfem_tpu_torch/_build/<hash>/libmorfem_kernels.so``, where the hash
covers the sources and the flags; the library is loaded with `ctypes`.
Each kernel has an ``extern "C"`` launcher taking raw pointers, sizes and
the CUDA stream, returning ``cudaGetLastError()``; each is resolved once,
at load (`KernelLibrary.function`). No PyTorch headers are compiled, so
the build takes seconds, not minutes.

The build happens at first use (never at import: the CPU tests import
every module and this machine may have no `nvcc`). It takes no lock: the
objects and the library are written under unique names and the library
is renamed into place, so concurrent builders cannot leave a half-written
library behind. A failed build raises with `nvcc`'s output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libmorfem_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_c_void_p, _c_int, _c_int64, _c_float = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float,
)
# argtypes of every launcher: pointers and the stream as c_void_p (a plain
# int would be cut to 32 bits), sizes as c_int / c_int64
_SIGNATURES = {
    "morfem_panel_factor": [_c_void_p] * 6 + [_c_int] * 7 + [_c_void_p],
    "morfem_panel_factor_max_clusters": [_c_int] * 6 + [_c_void_p],
    "morfem_split_words": [_c_void_p] * 2 + [_c_int] * 4 + [_c_int64] * 3
    + [_c_void_p],
    "morfem_mm_words": [_c_void_p] * 4 + [_c_int] * 4 + [_c_int64] * 3
    + [_c_float, _c_void_p],
    "morfem_gather_rows": [_c_void_p, _c_void_p, _c_int, _c_void_p]
    + [_c_int] * 4 + [_c_int64] * 4 + [_c_void_p],
    "morfem_gj_sweep_warp": [_c_void_p] * 7 + [_c_int] * 3 + [_c_void_p],
    "morfem_gj_sweep_block": [_c_void_p] * 7 + [_c_int] * 3 + [_c_void_p],
    "morfem_banded_matvec": [_c_void_p, _c_int64, _c_void_p, _c_int,
                             _c_void_p, _c_int] + [_c_int] * 4 + [_c_void_p],
    "morfem_bsr_spmm": [_c_void_p] * 5 + [_c_int] * 2 + [_c_void_p],
    "morfem_tri_inverse": [_c_void_p] * 3 + [_c_int] * 3 + [_c_int64] * 3
    + [_c_void_p],
}


class KernelLibrary:
    """The loaded library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 ptxas_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.ptxas_log = ptxas_log
        self._fns = {}
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._fns[name] = fn

    def function(self, name: str):
        """The ctypes launcher `name`, resolved at load; it returns the
        CUDA error code (pass it to `raise_on_error`)."""
        return self._fns[name]

    def call(self, name: str, *args) -> None:
        """Launch through `name`; raise if the launcher reports an error."""
        raise_on_error(name, self._fns[name](*args))


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {err}")


_LOADED: dict = {}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _source_hash(nvcc: str) -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of morfem_tpu_torch are built at first use on the "
        "machine with the card"
    )


def load() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    if "lib" in _LOADED:
        return _LOADED["lib"]
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / _source_hash(nvcc)
    lib_path = out_dir / LIB_NAME
    log_path = out_dir / "ptxas.log"
    t0 = time.perf_counter()
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}"
        objs, procs = [], []
        for src in _sources():
            obj = out_dir / f".{src.stem}.{tag}.o"
            cmd = [nvcc] + FLAGS + ["-c", "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for cmd, proc in procs:
            out, _ = proc.communicate(timeout=900)
            logs.append(out)
            if proc.returncode != 0:
                for _, other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(
                    "nvcc failed to build the morfem_tpu_torch kernels:\n"
                    + " ".join(cmd) + "\n" + out
                )
        tmp = out_dir / f".{LIB_NAME}.{tag}.tmp"
        cmd = [nvcc] + ARCH_FLAGS + ["-shared", "-o", str(tmp)] + [
            str(o) for o in objs]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed to link the morfem_tpu_torch kernels:\n"
                + " ".join(cmd) + "\n" + proc.stdout + proc.stderr
            )
        for o in objs:
            o.unlink()
        log_path.write_text("".join(logs))
        os.replace(tmp, lib_path)
    build_seconds = time.perf_counter() - t0
    log = log_path.read_text() if log_path.exists() else ""
    lib = KernelLibrary(ctypes.CDLL(str(lib_path)), lib_path, build_seconds,
                        log)
    _LOADED["lib"] = lib
    return lib


def stream_handle(t) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device (the
    raw query, where PyTorch has it, builds no Stream object per call)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_tensor(name: str, t, dtype) -> None:
    """Raise unless `t` is a CUDA tensor of `dtype`."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
