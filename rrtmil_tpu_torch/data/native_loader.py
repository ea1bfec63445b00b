"""ctypes binding of the native bag loader, `native/bag_loader.cpp`.

Counterpart of `rrtmil_tpu/data/native_loader.py:28-167`: C++ threads
read each bag's `.npy` payload, cast it (float16 -> float32, or either ->
bfloat16 with round-to-nearest-even) and zero-pad it straight into the
caller's (B, rows, cols) buffer, beside its mask and true row count.  The
engine hands it a pinned staging buffer (train/engine.py, the native tier).

The library is built at first use with

    g++ -O3 -shared -fPIC -pthread -std=c++17 native/bag_loader.cpp
        -o rrtmil_tpu_torch/build/libbag_loader-<hash>.so

(the build directory is git-ignored; the hash covers the flags and the
source, so an edited source is rebuilt).  It never loads or writes the
`native/libbag_loader_v2.so` that the tree carries: that one was built with
-march=native on another host.  Several processes may race to build it:
each compiles to a temporary name and `os.replace`s it into place.  A
failed build raises with the compiler's output: the JAX package turns one
into a quiet Python route, the port does not, so a missing tier never
hides.

The C++ parser reads only C-order 2-D `<f4` / `<f2` payloads
(bag_loader.cpp:40-83); `eligible` checks that from the header (numpy's
public `read_magic` / `read_array_header_*`), so any other file takes the
engine's Python tier.  bfloat16 batches come back as uint16 arrays of the
bits: numpy has no bfloat16, and the engine views them as torch.bfloat16.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR.parent / "native" / "bag_loader.cpp"
BUILD_DIR = PKG_DIR / "build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
DTYPES = {"float32": np.float32, "bfloat16": np.uint16}
# the payloads bag_loader.cpp parses (little-endian float32 / float16)
NATIVE_DESCR = ("<f4", "<f2")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(Path(source).read_bytes())
    return Path(build_dir) / f"libbag_loader-{h.hexdigest()[:12]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """The library of `source` under `build_dir`, compiled first if it is
    not there; raises RuntimeError with the compiler's output on failure."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.name + ".", suffix=".tmp",
                               dir=out.parent)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, str(source), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"building the native bag loader: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the native bag loader failed: "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        args = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]
        for fn in (lib.bag_fill_batch, lib.bag_fill_batch_bf16):
            fn.argtypes, fn.restype = args, ctypes.c_int
        lib.bag_num_rows.argtypes = [ctypes.c_char_p]
        lib.bag_num_rows.restype = ctypes.c_longlong
        _lib = lib
        return lib


def header(path: str) -> Optional[Tuple[tuple, bool, str]]:
    """(shape, fortran_order, descr) of a `.npy` file's header, None when it
    is not one."""
    try:
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version[0] == 1
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
    except (OSError, ValueError):
        return None
    return tuple(shape), bool(fortran), dtype.str


def eligible(path: str) -> bool:
    """True when bag_loader.cpp reads this file as the Python tier does: a
    C-order 2-D `.npy` of `<f4` or `<f2`."""
    h = path.endswith(".npy") and header(path)
    return bool(h) and len(h[0]) == 2 and not h[1] and h[2] in NATIVE_DESCR


def num_rows(path: str) -> int:
    n = load().bag_num_rows(path.encode())
    if n < 0:
        raise IOError(f"cannot parse the npy header of {path!r}")
    return int(n)


def fill_batch(paths: Sequence[str], rows_out: int, cols: int,
               n_threads: int = 8, out: Optional[np.ndarray] = None,
               dtype: str = "float32", mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load, cast and pad a batch of `.npy` bags in C++ threads into `out`
    (B, rows_out, cols) of DTYPES[dtype] and `mask` (B, rows_out) bool
    (each allocated when None): bfloat16 is written as uint16 bits.
    Returns (x, mask, true_rows (B,) int64); a bag longer than rows_out is
    cut to it."""
    if dtype not in DTYPES:
        raise ValueError(f"fill_batch dtype {dtype!r} is not one of "
                         f"{sorted(DTYPES)}")
    lib = load()
    n = len(paths)
    want = (n, rows_out, cols)
    out = _buffer(out, want, DTYPES[dtype], "out")
    mask = _buffer(mask, want[:2], np.bool_, "mask")
    true_rows = np.empty((n,), np.int64)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    fn = lib.bag_fill_batch_bf16 if dtype == "bfloat16" else \
        lib.bag_fill_batch
    rc = fn(c_paths, n, out.ctypes.data, mask.ctypes.data, rows_out, cols,
            true_rows.ctypes.data, n_threads)
    if rc != 0:
        raise IOError(f"the native loader failed on bag {paths[rc - 1]!r}")
    return out, mask, true_rows


def _buffer(a: Optional[np.ndarray], shape, dtype, what: str) -> np.ndarray:
    if a is None:
        return np.empty(shape, dtype)
    if a.shape != shape or a.dtype != dtype or not a.flags.c_contiguous:
        raise ValueError(f"{what} is {a.dtype} {a.shape}, not a C-order "
                         f"{np.dtype(dtype)} {shape}")
    return a
