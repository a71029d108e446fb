"""Build and bind the native host gather (`fastloader.cpp`) — port of the
JAX package's `native/build.py`.

The library is compiled with g++ at first use, never at import, into
`build/native/` at the repository root; its file name carries a hash of
the source, the flags and the compiler's `-march=native` target, so an
edited source or another host's CPU never loads a stale library. Builds
in several processes at once (the test workers) take a file lock and
publish the library by an atomic rename. A failed build raises with the
compiler's output: there is no silent fallback.

`gather_records` and `gather_images_cropped` take the library for uint8
arrays; for any other dtype they compute their plain numpy versions
(`gather_records_reference`, `gather_images_cropped_reference`), which
the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "fastloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread",
         "-std=c++17")
THREADS = 8


def _target() -> bytes:
    """The compiler's predefined macros under FLAGS: the instruction set
    that `-march=native` picks on this host."""
    proc = subprocess.run([CXX, *FLAGS[:2], "-E", "-dM", "-x", "c++",
                           os.devnull], capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} cannot build the native gather:"
                           f"\n{proc.stderr.decode(errors='replace')}")
    return proc.stdout


def build() -> Path:
    """Compile `fastloader.cpp` into `build/native/libfastloader-<hash>.so`
    (once per source, flags and target) → the library's path."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()
                            + _target()).hexdigest()[:12]
    lib = BUILD_DIR / f"libfastloader-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():            # another process built it meanwhile
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([CXX, *FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{CXX} failed on {SRC.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The gather library, built on first call, its C interface
    declared."""
    lib = ctypes.CDLL(str(build()))
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    # src, num_records, record_bytes, indices, batch, dst, num_threads
    lib.gather_records.argtypes = [p, i64, i64, p, i64, p, i]
    # src, num_records, height, width, channels, indices, crop_h, crop_w,
    # batch, dst, num_threads
    lib.gather_images_cropped.argtypes = [p, i64, i64, i64, i64, p, p, p,
                                          i64, p, i]
    lib.gather_records.restype = lib.gather_images_cropped.restype = i
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _out(out: Optional[np.ndarray], shape, dtype) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype)
    if (out.shape != tuple(shape) or out.dtype != dtype
            or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous {np.dtype(dtype)} "
                         f"array of {tuple(shape)}, not {out.dtype} "
                         f"{out.shape}")
    return out


def gather_records_reference(src: np.ndarray,
                             indices: np.ndarray) -> np.ndarray:
    """The plain version: `src[indices]` over the leading axis."""
    return np.asarray(src)[np.asarray(indices, np.int64)]


def gather_images_cropped_reference(src: np.ndarray, indices: np.ndarray,
                                    crop_h: np.ndarray,
                                    crop_w: np.ndarray) -> np.ndarray:
    """The plain version: each chosen (H, W, C) record's top-left
    (crop_h, crop_w) window, the rest zero."""
    src = np.asarray(src)
    res = np.zeros((len(indices),) + src.shape[1:], src.dtype)
    for b, (j, h, w) in enumerate(zip(indices, crop_h, crop_w)):
        res[b, :h, :w] = src[j, :h, :w]
    return res


def gather_records(src: np.ndarray, indices: np.ndarray,
                   out: Optional[np.ndarray] = None,
                   num_threads: int = THREADS) -> np.ndarray:
    """out[b] = src[indices[b]] over the leading axis, on `num_threads`
    threads for a uint8 `src` (the plain version for another dtype).
    Raises ValueError for an index outside [0, len(src))."""
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
    if src.dtype != np.uint8:
        res = gather_records_reference(src, idx)
        if out is None:
            return res
        _out(out, res.shape, res.dtype)[...] = res
        return out
    out = _out(out, (idx.shape[0],) + src.shape[1:], np.uint8)
    record_bytes = int(np.prod(src.shape[1:], dtype=np.int64))
    rc = library().gather_records(_ptr(src), src.shape[0], record_bytes,
                                  _ptr(idx), idx.shape[0], _ptr(out),
                                  num_threads)
    if rc != 0:
        raise ValueError(f"gather_records: an index outside [0, "
                         f"{src.shape[0]}) or an empty record")
    return out


def gather_images_cropped(src: np.ndarray, indices: np.ndarray,
                          crop_h: np.ndarray, crop_w: np.ndarray,
                          out: Optional[np.ndarray] = None,
                          num_threads: int = THREADS) -> np.ndarray:
    """Gather (N, H, W, C) images, keeping only each record's (crop_h,
    crop_w) window and zeroing the rest; uint8 on `num_threads` threads,
    another dtype by the plain version. Raises ValueError for an index or
    a crop out of range."""
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
    ch = np.ascontiguousarray(crop_h, dtype=np.int64).reshape(-1)
    cw = np.ascontiguousarray(crop_w, dtype=np.int64).reshape(-1)
    if src.ndim != 4 or not ch.shape == cw.shape == idx.shape:
        raise ValueError(f"need (N, H, W, C) images and one crop an index, "
                         f"not {src.shape}, {idx.shape}, {ch.shape}, "
                         f"{cw.shape}")
    if src.dtype != np.uint8:
        res = gather_images_cropped_reference(src, idx, ch, cw)
        if out is None:
            return res
        _out(out, res.shape, res.dtype)[...] = res
        return out
    n, h, w, c = src.shape
    out = _out(out, (idx.shape[0], h, w, c), np.uint8)
    rc = library().gather_images_cropped(_ptr(src), n, h, w, c, _ptr(idx),
                                         _ptr(ch), _ptr(cw), idx.shape[0],
                                         _ptr(out), num_threads)
    if rc != 0:
        raise ValueError(f"gather_images_cropped: an index outside [0, {n})"
                         f" or a crop beyond {h} × {w}")
    return out
