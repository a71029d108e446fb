"""Build and bind the port's hand-written CUDA kernels.

Each kernel source `csrc/<name>.cu` exposes a plain C entry point. At
first use it is compiled by `nvcc` for Hopper (`sm_90a`) into
`build/kernels/` at the repository root and loaded with `ctypes`; the
library's file name carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt and a stale
library is never loaded. Nothing is built
or imported when this module is imported: the CPU tests import it on
machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def build(name: str, src: Path | None = None) -> Path:
    """Compile `csrc/<name>.cu` (or `src`) into
    `build/kernels/lib<name>-<hash>.so` (once per source version) and
    return the library's path. The compiler's output, including `-Xptxas
    -v`'s register and spill report, is kept beside it as
    `<library>.log`."""
    src = src or CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                           str(tmp), str(src)],
                          capture_output=True, text=True)
    Path(f"{lib}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, lib)      # atomic: concurrent builders never see half a file
    return lib


@functools.cache
def roi_align_lib() -> ctypes.CDLL:
    """The ROI-pooling kernel library, built on first call."""
    return bind_roi_align(ctypes.CDLL(str(build("roi_align"))))


def bind_roi_align(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from `roi_align.cu`: its
    NHWC entry `roi_align_fwd` and its CHW entry `roi_align_chw_fwd`."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # features, boxes, out, n, r, hf, wf, c, oh, ow, ih, iw, feat_bf16,
    # [out_bf16,] stream
    shape = [p, p, p, i, i, i, i, i, i, i, f, f, i]
    lib.roi_align_fwd.argtypes = [*shape, p]
    lib.roi_align_chw_fwd.argtypes = [*shape, i, p]
    lib.roi_align_fwd.restype = lib.roi_align_chw_fwd.restype = ctypes.c_int
    return lib


def build_all(names) -> dict:
    """Build several sources at once, one nvcc each → {name: library path}."""
    with ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


@functools.cache
def roi_align_bwd_lib() -> ctypes.CDLL:
    """The ROI-pooling backward library, built on first call."""
    return bind_roi_align_bwd(ctypes.CDLL(str(build("roi_align_bwd"))))


def bind_roi_align_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from `roi_align_bwd.cu`:
    `roi_align_bwd_features` and `roi_align_bwd_boxes`."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i, i, i, i, i, i, i, f, f]     # n, r, hf, wf, c, oh, ow, ih, iw
    # grad, boxes, d_features, shape, grad_bf16, grad_chw, out_bf16, stream
    lib.roi_align_bwd_features.argtypes = [p, p, p, *shape, i, i, i, p]
    # features, boxes, grad, d_boxes, shape, feat_bf16, grad_bf16, grad_chw,
    # stream
    lib.roi_align_bwd_boxes.argtypes = [p, p, p, p, *shape, i, i, i, p]
    lib.roi_align_bwd_features.restype = ctypes.c_int
    lib.roi_align_bwd_boxes.restype = ctypes.c_int
    return lib
