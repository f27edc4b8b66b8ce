"""Build and load the port's CUDA kernels.

Every `*.cu` under `csrc/` is compiled by its own `nvcc` process, all
started together, for `sm_90a`; the objects are linked into one shared
library with a plain C interface, `_build/librtt_kernels.so`, which is
loaded with ctypes. Sources include no PyTorch header, so a build takes
seconds. It runs at the first kernel launch in a process (or at an explicit
`load_library()`), from the repository's sources only, and is reused while
the sources are unchanged (the library's name carries their hash).

Nothing here catches a failed build: `load_library()` raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes understood by the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None
build_log = ""        # compiler output of the last build (ptxas register/smem report)
build_seconds = None  # wall time of the last build in this process, None if reused


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link the library; returns its path."""
    global build_log, build_seconds
    cu, headers = _sources()
    lib_path = BUILD_DIR / f"librtt_kernels-{_digest(cu + headers)}.so"
    if lib_path.exists():
        build_seconds = None
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in cu:
        obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{build_log}")
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def _declare(lib):
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.rtt_flash_fwd.argtypes = [i, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                                  ll, ll, ll, ll, ll, ll, ll, ll, ll, ll, ll, ll,
                                  f, i, vp]
    lib.rtt_flash_fwd.restype = i
    lib.rtt_flash_bwd_dq.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                                     *[ll] * 15, f, i, vp]
    lib.rtt_flash_bwd_dq.restype = i
    lib.rtt_flash_bwd_dkv.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                                      *[ll] * 18, f, i, vp]
    lib.rtt_flash_bwd_dkv.restype = i
    lib.rtt_paged_decode_split.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                                           i, i, *[ll] * 10, f, vp]
    lib.rtt_paged_decode_split.restype = i
    lib.rtt_paged_decode_combine.argtypes = [i, vp, vp, i, i, i, i, i, ll, ll, vp]
    lib.rtt_paged_decode_combine.restype = i
    lib.rtt_error_string.argtypes = [i]
    lib.rtt_error_string.restype = ctypes.c_char_p


def load_library():
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def check(code: int, what: str):
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = load_library().rtt_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
