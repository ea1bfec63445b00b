"""Build and load the hand-written CUDA kernels (route: nvcc + ctypes).

Each `rrtmil_tpu_torch/csrc/<name>.cu` is compiled on its own, at first
use, by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --split-compile=0 -o build/lib<name>-<hash>.so
         csrc/<name>.cu

into `rrtmil_tpu_torch/build/` (listed in .gitignore).  The file name
carries a hash of the sources, so an edited kernel is rebuilt and a stale
library is never loaded.  `build_all` starts one nvcc per source, all at
once, each splitting its device code's optimisation over the host's cores
(`--split-compile=0`: a file holds many template instances).  The libraries have a plain C interface: pointers and the stream are
passed as c_void_p, and every entry returns cudaGetLastError(), which
`check` turns into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("region_layer", "region_layer_bwd", "crmsa", "crmsa_bwd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--split-compile=0"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes of every C entry; each returns an int error code
SIGNATURES = {
    "region_layer": {
        "rl_ln_mask": [_I, _I, _P, _P, _P, _P, _P, _LL, _I, _F, _LL, _P],
        "rl_gemm": [_I, _I, _I, _I, _P, _I, _LL, _LL, _P, _P, _P, _I, _I, _LL,
                    _LL, _I, _LL, _LL, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                    _I, _I, _LL, _LL, _P],
        "rl_attention": [_I, _I, _I, _P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P,
                         _LL, _LL, _LL, _P, _LL, _LL, _LL, _I, _I, _I, _I, _I,
                         _I, _F, _P, _I, _P, _I, _P],
        "rl_block": [_I, _I, _I, _P, _LL, _LL, _P, _P, _P, _I, _LL, _LL, _I,
                     _LL, _LL, _P, _P, _P, _P, _I, _P, _P, _I, _LL, _LL, _I,
                     _LL, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL,
                     _LL, _LL, _LL, _P],
    },
    "region_layer_bwd": {
        "rb_gemm": [_I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P, _I, _I, _I,
                    _I, _I, _LL, _I, _LL, _P],
        "rb_gemm_tc": [_I, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _LL,
                       _I, _LL, _P],
        "rb_colsum": [_I, _I, _P, _I, _LL, _I, _P, _P, _I, _I, _P, _LL, _P],
        "rb_reduce": [_P, _I, _LL, _P, _I, _P],
        "rb_ln_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _F, _I, _LL,
                      _P],
        "rb_attention_bwd": [_I, _I, _I, *[_P, _LL, _LL, _LL] * 7, _I, _I, _I,
                             _I, _I, _I, _I, _P, _I, _P, _F, _P, _P, _P, _P,
                             _P, _P, _I, _P],
    },
    "crmsa": {
        "cr_compress_grid": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _I, _I, _F, _I, _P],
        "cr_redistribute_ln": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _F, _I, _P],
        "cr_compress": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _P],
        "cr_redistribute": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _P],
    },
    "crmsa_bwd": {
        "cb_compress_grid_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
        "cb_redistribute_ln_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                   _I, _P],
        "cb_redistribute_grid_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                     _I, _I, _I, _I, _I, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_hash(name)}.so"


def build_all(verbose: bool = False) -> Dict[str, dict]:
    """Compile every source whose library is missing, one nvcc per source,
    all started together.  Returns {name: {"seconds", "log", "cached"}};
    `verbose` adds -Xptxas -v so the log lists registers, shared memory and
    spills of each kernel.  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, info = {}, {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = library_path(name)
        if out.exists() and not verbose:
            info[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        info[name] = {"seconds": time.perf_counter() - t0, "log": log,
                      "cached": False}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return info


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype: torch.dtype) -> int:
    try:
        return _CODES[dtype]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"not {dtype}") from None


def ptr(t) -> int:
    return None if t is None else t.data_ptr()


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as an int (the raw-stream
    accessor skips building a torch.cuda.Stream object on every launch)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch "
                           f"(cudaGetLastError)")


def same_device(dev: torch.device, tensors: dict) -> None:
    """Raise unless every tensor given (None skipped) lies on `dev`."""
    for name, t in tensors.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")


def f32_param(t, name: str):
    """t's pointer (None for None) after checking the kernels can read it as
    it is: a contiguous float32 vector or matrix (biases, EPEG taps)."""
    if t is None:
        return None
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise TypeError(f"{name} must be a contiguous float32 tensor, got "
                        f"{t.dtype} with strides {t.stride()}")
    return t.data_ptr()


def require_cuda(streams: dict, params: dict) -> None:
    """Raise unless every tensor lies on the first stream tensor's CUDA
    device and the stream tensors (read in place by the kernels) are
    contiguous; parameters are re-laid out by the wrappers."""
    dev = next(iter(streams.values())).device
    if dev.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {dev}")
    same_device(dev, {**streams, **params})
    for name, t in streams.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
