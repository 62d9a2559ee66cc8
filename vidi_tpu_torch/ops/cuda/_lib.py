"""Build and load the port's CUDA kernels (`vidi_tpu_torch/csrc/*.cu`).

The kernels are plain C entry points compiled by `nvcc` for Hopper
(`sm_90a`), one `nvcc` process per source started together, linked into one
shared library and bound with `ctypes`. The library is built at first use
from the sources in the checkout, into
`vidi_tpu_torch/build/`, under a name that carries a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import time: a CPU-only machine imports the wrappers
and never reaches this module's build.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib = None
build_seconds = None  # wall time of the build in this process, None if loaded


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libvidi_kernels-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sorted(CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True))
            for cmd in ([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(sorted(CSRC.glob("*.cu")), objs))]
    failed = []
    for cmd, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_seconds = time.perf_counter() - t0


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# K1 / K2 forward: the SIMT (fp32) and sm90 (bf16) entries take the same arguments
_K1_ARGS = [_P] * 8 + [_I] * 6 + [_L] * 9 + [_F, _I, _I, _F, _I, _I, _P, _P, _P, _P]
_K2_ARGS = [_P] * 4 + [_I] * 5 + [_L] * 9 + [_F, _P]
_SIGNATURES = {
    "vidi_flash_attention_fwd": _K1_ARGS,
    "vidi_flash_attention_fwd_sm90": _K1_ARGS,
    # K4 backward: SIMT (fp32; dO contiguous) and sm90 (bf16; dO strided)
    "vidi_flash_attention_bwd": [_P] * 13 + [_I] * 6 + [_L] * 9
    + [_F, _I, _I, _F, _I, _I, _P],
    "vidi_flash_attention_bwd_sm90": [_P] * 13 + [_I] * 6 + [_L] * 12
    + [_F, _I, _I, _F, _I, _I, _P],
    "vidi_tower_attention": _K2_ARGS,
    "vidi_tower_attention_sm90": _K2_ARGS,
    "vidi_decode_attention": [_P] * 9 + [_I] * 6 + [_L] * 8
    + [_F, _F, _I, _I, _I, _P],
    "vidi_quant_matmul": [_P] * 6 + [_I] * 4 + [_P],
    "vidi_quant_gated": [_P] * 8 + [_I] * 5 + [_P],
    "vidi_ln_qkv": [_P] * 17 + [_I] * 3 + [_F, _P],
    "vidi_o_residual": [_P] * 8 + [_I] * 3 + [_P],
    "vidi_ln_ffn": [_P] * 15 + [_I] * 5 + [_F, _P],
    "vidi_int8_transpose": [_P, _P, _I, _I, _P],
    "vidi_rms_norm": [_P] * 3 + [_I] * 6 + [_F, _P],
}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.vidi_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vidi_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once per device)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def check_operand(t, name: str, ndim: int, dtype=None) -> None:
    """Raise unless `t` is what the kernels read: a CUDA bf16/fp32 tensor of
    rank `ndim` whose last dim is contiguous and whose element pairs are
    aligned (the kernels load two elements at a time; other dims may be
    strided views)."""
    import torch

    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: kernels take bfloat16 or float32, got {t.dtype}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype} differs from {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if t.stride(-1) != 1 or any(s % 2 for s in t.stride()[:-1]) or t.shape[-1] % 2:
        raise ValueError(f"{name}: last dim must be contiguous with even strides "
                         f"and size, got shape {tuple(t.shape)} strides {t.stride()}")
    if t.data_ptr() % (2 * t.element_size()):
        raise ValueError(f"{name}: data pointer not aligned to an element pair")


def call(name: str, device, *args) -> None:
    """Call the C entry `name` with `args` and, last, `device`'s current
    stream; raise on a non-zero cudaError_t. The device is switched to only
    when it is not the current one (the common case costs no context)."""
    import torch

    fn = getattr(library(), name)
    # torch.cuda.current_stream() spends ~10 us a call on device look-ups;
    # the raw-stream getter is the same answer as an int
    if device.index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err:
        check(err, name)


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        text = library().vidi_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} failed to launch: cudaError_t {err} ({text})")
