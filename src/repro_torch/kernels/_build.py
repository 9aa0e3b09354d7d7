"""Builds and loads the port's CUDA sources (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a plain
C interface and loaded with ``ctypes``; no PyTorch header is involved, so a
build takes seconds.  All sources are built in parallel, at the first launch
of any kernel, into ``build/repro_torch/`` at the repository root; each
library's name carries a hash of its sources and flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.

Every C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`launch` raises on a non-zero value.  Only this module touches the
libraries.  Importing it needs no CUDA toolkit; building does.
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
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

SOURCES = ("int_gemm", "pool_reduce", "ewise", "bitslice_gemm", "attention", "htree_reduce",
           "rglru_scan", "act_quant")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _B = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_char_p

# C entry point → (source, argument types).  Pointers and the stream are
# c_void_p: ctypes would otherwise pass a Python int as a 32-bit int.  Host
# byte arrays (the bit-sliced GEMM's pair list) are passed as bytes.
ENTRY_POINTS: Dict[str, Tuple[str, Tuple[type, ...]]] = {
    # the GEMMs take B's layout after the extents, then their launch plan
    # (conv.gemm_plan: small-M kernel, 16-byte A and B copies, splits, K chunk;
    # conv.gemm_f32_plan: 16-byte B copies, splits, K chunk, after the
    # workspace of the splits' partial tiles)
    "int_gemm_i32": ("int_gemm", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    "int_gemm_f32": ("int_gemm", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    # the pool and ewise kernels take their launch plan (conv.pool_plan,
    # ewise.ewise_plan) after the extents
    "pool_sum_i32": ("pool_reduce", (_P, _P, _L, _I, _I, _I, _I, _P)),
    "pool_sum_f32": ("pool_reduce", (_P, _P, _L, _I, _I, _I, _I, _P)),
    "pool_max_i32": ("pool_reduce", (_P, _P, _L, _I, _I, _I, _I, _P)),
    "pool_max_f32": ("pool_reduce", (_P, _P, _L, _I, _I, _I, _I, _P)),
    "ewise_add_i32": ("ewise", (_P, _P, _P, _L, _I, _I, _P)),
    "ewise_add_f32": ("ewise", (_P, _P, _P, _L, _I, _I, _P)),
    "relu_i32": ("ewise", (_P, _P, _L, _I, _I, _P)),
    "relu_f32": ("ewise", (_P, _P, _L, _I, _I, _P)),
    "bitslice_gemm_i8": ("bitslice_gemm", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _B, _B, _I, _P)),
    # the tensor-core path: staged slices' bases, extents, slice counts,
    # diagonal shifts and its plan (bitslice_matmul.bitslice_plan)
    "bitslice_gemm_mma": ("bitslice_gemm", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                            _P)),
    # the grouped tensor-core path: x, w, the groups' row offsets, out, rows,
    # N, K, groups, then its plan (bitslice_matmul.grouped_plan)
    "bitslice_gemm_grouped": ("bitslice_gemm", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    # both with the dequantizing epilogue: after the output, the row and
    # column scales, then (one pair alone) the bias (NULL for none), then
    # the output's dtype code (bitslice_matmul.DTYPE_CODES), then (one pair
    # alone) the bias's, then as above
    "bitslice_gemm_mma_dequant": ("bitslice_gemm", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    "bitslice_gemm_grouped_dequant": ("bitslice_gemm", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    # the attention kernels take int8 and int32 operands, named by their
    # element size in bytes (1 or 4) after the extents, then their launch
    # plans: q·Kᵀ and the GEMV attention.rowdot_plan's (row dot, lanes,
    # split, warps, unroll, group, blocks); the softmax attention.softmax_plan's
    # (cluster, chunks a block, registers, 16-byte access, blocks); p·V
    # attention.pv_plan's (packed, queries a block, rows a block, blocks,
    # partial words a block)
    "attention_qk": ("attention", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    "softmax_fixedpoint": ("attention", (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    "attention_pv": ("attention", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    "decode_gemv": ("attention", (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    # the KV append takes its plan (attention.kv_plan: 16-byte chunks,
    # blocks) after the element sizes
    "kv_append": ("attention", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)),
    # the H-tree takes its launch plan (htree_reduce.htree_plan) after the extents
    "htree_reduce_f32": ("htree_reduce", (_P, _P, _I, _I, _I, _I, _I, _P)),
    "htree_reduce_bf16": ("htree_reduce", (_P, _P, _I, _I, _I, _I, _I, _P)),
    "htree_reduce_i32": ("htree_reduce", (_P, _P, _I, _I, _I, _I, _I, _P)),
    # the RG-LRU scan takes its launch plan (rglru_scan.rglru_plan: channels
    # a group, 16-byte copies, blocks) after the extents
    "rglru_scan_f32": ("rglru_scan", (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    # its backward: a, hs, h0, g, then ∂a, ∂b and ∂h0 (NULL when not
    # needed), the extents and the same plan
    "rglru_scan_bwd_f32": ("rglru_scan", (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    # the activation quantize: x and its row stride, q, the scales, M, K,
    # qmax and the block (act_quant.act_quant_plan)
    "act_quant_bf16": ("act_quant", (_P, _L, _P, _P, _I, _I, _I, _I, _P)),
    "act_quant_f16": ("act_quant", (_P, _L, _P, _P, _I, _I, _I, _I, _P)),
    "act_quant_f32": ("act_quant", (_P, _L, _P, _P, _I, _I, _I, _I, _P)),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the CUDA "
        "kernels of repro_torch are built at first use and need the CUDA toolkit"
    )


def library_path(source: str) -> Path:
    """Where ``source``'s library lives, keyed on a hash of its source, the
    shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (f"{source}.cu", *HEADERS):
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"{source}-{h.hexdigest()[:16]}.so"


def nvcc_command(source: str, out: Path) -> list:
    return [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(CSRC / f"{source}.cu")]


def build_all() -> Dict[str, Dict[str, object]]:
    """Compile every source whose library is missing, all ``nvcc`` processes
    started together; returns ``{source: {"seconds", "log", "path"}}`` for
    the sources built by this call.  Raises with the compiler's output when a
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for src in SOURCES:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            nvcc_command(src, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[src] = (proc, tmp, out, time.perf_counter())
    built = {}
    failed = []
    for src, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        built[src] = {"seconds": secs, "log": log, "path": str(out)}
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return built


_SUFFIX = {torch.int32: "i32", torch.float32: "f32"}


def entry_suffix(*tensors: torch.Tensor) -> str:
    """Entry-point suffix (``i32`` / ``f32``) for the operands' dtype; raises
    on a dtype or a size the kernels do not take."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _SUFFIX:
        raise TypeError(f"the CUDA kernels take int32 or float32 operands of one dtype, got {dtypes}")
    for t in tensors:
        for d in t.shape:
            if d >= 2**31:
                raise ValueError(f"dimension {d} exceeds the kernels' 32-bit index range")
    return _SUFFIX[tensors[0].dtype]


def _function(name: str) -> ctypes._CFuncPtr:
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _fns:
            source, argtypes = ENTRY_POINTS[name]
            if source not in _libs:
                if not library_path(source).exists():
                    build_all()
                _libs[source] = ctypes.CDLL(str(library_path(source)))
            f = getattr(_libs[source], name)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
            _fns[name] = f
    return _fns[name]


class KernelLaunchError(RuntimeError):
    """A C entry point refused a launch (its CUDA error code is in the
    message)."""


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` with ``args`` and the current stream of
    CUDA ``device`` (building and loading its library on the first call);
    raise if the launch was refused."""
    fn = _function(name)
    index = device.index if device.index is not None else torch.cuda.current_device()
    # the raw stream handle, without building a Stream object, and no device
    # switch when the device is already current: a launch costs the host a
    # few microseconds, and an eager forward makes dozens
    if index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        err = _function_error_string(ENTRY_POINTS[name][0], rc)
        raise KernelLaunchError(f"CUDA kernel {name} failed to launch: error {rc} ({err})")


def _function_error_string(source: str, code: int) -> str:
    f = _libs[source].repro_error_string
    f.argtypes = [ctypes.c_int]
    f.restype = ctypes.c_char_p
    return f(code).decode()
