"""Build and load the port's hand-written CUDA kernels.

The sources under ``csrc/`` (attention, among them the bf16 tensor-core
forward and backward and the f32 (3xTF32) tensor-core forward and backward,
GroupNorm+FiLM+SiLU and the fused GN→SiLU→conv3x3, FMA and bf16 tensor-core)
expose plain C entry points. At first use each is
compiled with ``nvcc`` for Hopper (``sm_90a``), all of them at once in parallel
processes, then linked into one shared library under ``_build/`` and loaded
with :mod:`ctypes`. The library's file name carries a hash of the sources and
flags, so an edited source builds anew and a stale library is never loaded.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

SOURCES = ("attn_fwd_online.cu", "attn_fwd_qblk.cu", "attn_fwd_train.cu", "attn_bwd_rows.cu",
           "attn_bwd_cols.cu", "attn_bwd_pack1_kv.cu", "attn_fwd_tc.cu", "attn_bwd_tc.cu",
           "attn_fwd_tf32.cu", "attn_bwd_tf32.cu", "gn_film_silu.cu", "gn_silu_conv3x3.cu",
           "gn_silu_conv3x3_tc.cu")
HEADERS = ("attn_common.cuh", "attn_direct_fwd.cuh", "attn_tc.cuh", "attn_tf32.cuh",
           "gn_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# argtypes of every C entry point; each returns an int: the launches their
# cudaError_t, the *_max_t functions the largest token count a kernel takes.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ATTN_ARGS = [_P, _P] + [_I] * 5 + [_P]
_ENTRY_POINTS = {
    "vdiff_attn_fwd_online": _ATTN_ARGS,
    "vdiff_attn_fwd_qblk": _ATTN_ARGS,
    "vdiff_attn_fwd_train": _ATTN_ARGS,
    "vdiff_attn_bwd_rows": [_P] * 5 + [_I] * 5 + [_P],
    "vdiff_attn_bwd_rows_max_t": [_I],
    "vdiff_attn_bwd_cols": [_P] * 5 + [_I] * 5 + [_P],
    "vdiff_attn_fwd_pack1_lse": [_P] * 3 + [_I] * 5 + [_P],
    "vdiff_attn_bwd_pack1_kv": [_P] * 6 + [_I] * 5 + [_P],
    # the bf16 tensor-core kernels take no dtype flag; qkv, out, B, T, N, C,
    # q rows per block, stream
    "vdiff_attn_fwd_tc": [_P, _P] + [_I] * 5 + [_P],
    "vdiff_attn_fwd_tc_lse": [_P] * 3 + [_I] * 4 + [_P],
    # the f32 (3xTF32) tensor-core forward, the same arguments
    "vdiff_attn_fwd_tc_f32": [_P, _P] + [_I] * 5 + [_P],
    "vdiff_attn_fwd_tc_f32_lse": [_P] * 3 + [_I] * 4 + [_P],
    "vdiff_attn_bwd_tc": [_P] * 5 + [_I] * 4 + [_P],
    # qkv, out, lse, dout, dqkv, delta, B, T, N, C, stream
    "vdiff_attn_bwd_tc_kv": [_P] * 6 + [_I] * 4 + [_P],
    # the f32 (3xTF32) tensor-core backward: the row kernel (qkv, dout, dqkv,
    # lse, delta), the column kernel (qkv, dout, lse, delta, dqkv), the
    # saved-statistics pair (as vdiff_attn_bwd_tc_kv); B, T, N, C, stream
    "vdiff_attn_bwd_tf32_rows": [_P] * 5 + [_I] * 4 + [_P],
    "vdiff_attn_bwd_tf32_cols": [_P] * 5 + [_I] * 4 + [_P],
    "vdiff_attn_bwd_tf32_kv": [_P] * 6 + [_I] * 4 + [_P],
    # x, gamma, beta, shift, scale, film_stride, film_f32, out, B, HW, C, G, eps, silu, bf16,
    # then ops/groupnorm.py::gn_plan's groups, ranks, pixels, threads; stream
    "vdiff_gn_film_silu": [_P] * 5 + [_I] * 2 + [_P] + [_I] * 4 + [_F] + [_I] * 6 + [_P],
    # x, w, bias, gamma, beta, shift, scale, film_stride, film_f32, skip, out, coef,
    # B, H, W, C, CO, G, eps, bf16, stream
    "vdiff_gn_silu_conv3x3": [_P] * 7 + [_I] * 2 + [_P] * 3 + [_I] * 6 + [_F, _I, _P],
    # x, w, ldw, bias, gamma, beta, shift, scale, film_stride, film_f32, skip, out, coef,
    # B, H, W, C, CO, G, eps, tile_w, stream (bf16 only)
    "vdiff_gn_silu_conv3x3_tc": [_P, _P, _I] + [_P] * 5 + [_I] * 2 + [_P] * 3 + [_I] * 6
                                + [_F, _I, _P],
}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the port's CUDA kernels "
        "are built from vdiff_tpu_torch/csrc at first use and need the CUDA toolkit"
    )


def source_digest() -> str:
    """Hash of the kernel sources, headers and compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _run(cmds):
    """Run the commands in parallel; raise with nvcc's output if any fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build_library() -> str:
    """Compile the sources into ``_build/`` unless a library with the same
    digest exists there; return its path. One nvcc per source, all started
    together, then one link. Raises with nvcc's output on a failed build."""
    digest = source_digest()
    path = os.path.join(BUILD_DIR, f"libvdiff_kernels_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{digest}.{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.splitext(s)[0]}.{tag}.o") for s in SOURCES]
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, src)]
              for src, obj in zip(SOURCES, objs)])
        tmp = f"{path}.{os.getpid()}.tmp"
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return path


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(build_library())
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vdiff_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vdiff_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = library().vdiff_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
