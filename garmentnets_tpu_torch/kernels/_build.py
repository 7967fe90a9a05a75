"""Build and load the port's native libraries at first use.

Every CUDA kernel source `csrc/<name>.cu` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface
(`_build/lib<name>-<hash>.so`) and loaded with ctypes. The host C++
sources `ops/cpp/<name>.cpp` (marching cubes, and the exact mesh
Hausdorff distance of eval) are compiled the same way with `g++`. The
library name carries a hash of the source, the headers it may include
(`csrc/*.cuh`) and the flags, so an edited source or header is rebuilt; a
temp file plus `os.replace` keeps concurrent processes from loading a
half-written library. A failed build raises.

Nothing here runs at import time: the first CUDA launch (or
`build_all()`) triggers the build. torch is imported by the two helpers
that take a tensor, so host-only users (the eval's C++ Hausdorff helper)
do not load it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_DIR / "_build"
CSRC_DIR = PKG_DIR / "csrc"
CUDA_SOURCES = ("fps", "ggm", "sa_tc", "dense_decode_tc", "conv3d_wgrad")
HOST_SOURCES = ("marching", "hausdorff")
# Libraries built from a source above with extra flags, on first use only
# (build_all leaves them out): the ggm's radii 5..8.
VARIANTS = {"ggm_wide": ("ggm", ("-DGGM_WIDE_RADII",))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

# Launch counts of the hand-written kernels. Each wrapper adds one right
# after a successful launch of its kernel, and nowhere else.
LAUNCHES = {name: 0 for name in CUDA_SOURCES}

_LIBS: dict = {}
_LOCK = threading.Lock()
BUILD_LOGS: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = pathlib.Path(cand) / "bin" / "nvcc" if cand else None
        if p is not None and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def _target(name: str) -> tuple:
    """(compiler argv without output path, output .so path)."""
    host = name in HOST_SOURCES
    if host:
        src = PKG_DIR / "ops" / "cpp" / f"{name}.cpp"
        cmd = ["g++", *GXX_FLAGS, str(src)]
    else:
        source, extra = VARIANTS.get(name, (name, ()))
        src = CSRC_DIR / f"{source}.cu"
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, str(src)]
    h = hashlib.sha256(src.read_bytes() + " ".join(cmd[1:]).encode())
    if not host:
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
    return cmd, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start compiling `name` unless its library exists; returns
    (process or None, temp path, final path)."""
    cmd, so = _target(name)
    if so.exists():
        return None, None, so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.Popen(cmd + ["-o", str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    return proc, tmp, so


def _finish_build(name: str, proc, tmp, so) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    BUILD_LOGS[name] = out.decode(errors="replace")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {name} failed:\n{BUILD_LOGS[name]}")
    os.replace(tmp, so)


def build_all(names=CUDA_SOURCES + HOST_SOURCES) -> None:
    """Compile every library in `names` at once (one compiler process per
    source, all started together)."""
    with _LOCK:
        started = [(n, *_start_build(n)) for n in names]
        errors = []
        for n, proc, tmp, so in started:
            try:
                _finish_build(n, proc, tmp, so)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library `name`, building it on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            proc, tmp, so = _start_build(name)
            _finish_build(name, proc, tmp, so)
            lib = ctypes.CDLL(str(so))
            _LIBS[name] = lib
    return lib


def cuda_fn(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """A kernel's C launcher with its argtypes declared; every launcher
    returns the cudaError_t of its launch as an int."""
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise on a refused launch; count a successful one."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError_t {err})")
    LAUNCHES[name] += 1


def stream_handle(t: "torch.Tensor") -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: "torch.Tensor", name: str, dtype=None) -> None:
    """Validate a tensor handed to a CUDA launcher (float32 unless `dtype`
    says otherwise)."""
    import torch
    dtype = torch.float32 if dtype is None else dtype
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
