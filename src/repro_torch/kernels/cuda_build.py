"""Build and load the port's hand-written CUDA kernels (nvcc + ctypes).

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, at first use, under
``build/repro_torch/`` at the repository root.  A library's file name
carries a hash of its source and the compiler flags, so an edited source
rebuilds and an unchanged one is loaded as it is.  ``build_all`` starts one
``nvcc`` per source, all together.  Nothing here runs at import time: the
CPU tests import every module on machines without ``nvcc``.

Each C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers pass that code to :func:`check`, which raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch import tracing

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of every entry point, per source stem
SIGNATURES: Dict[str, Dict[str, List]] = {
    "na_kernels": {
        # items, row_ptr, row_src, row_slot, w, h, out, num_items, d, stream
        "na_seg_sum_f32": [_P] * 7 + [_I, _I, _P],
        # items, row_ptr, row_slot, logits, m, s, num_items, stream
        "na_softmax_stats_f32": [_P] * 6 + [_I, _P],
    },
    "spgemm_kernels": {
        # a, b, a_occ, b_occ, bt (B^T scratch), out, out_occ, mt, nt, kt,
        # splits, stream
        "spgemm_bool_u8": [_P] * 7 + [_I] * 4 + [_P],
        # b, b_occ, bt, kt, nt, stream
        "spgemm_transpose_u8": [_P] * 3 + [_I, _I, _P],
        # mt, nt, kt
        "spgemm_split_count": [_I] * 3,
        # info (6 ints: registers, dynamic shared bytes, local bytes, threads,
        # stages, CTAs an SM)
        "spgemm_info": [_P],
    },
    "flash_attention": {
        # q, k, v, o, b, hq, hkv, s_len, t_len, dh, dv, bf16, scale, causal,
        # window, softcap, strides (12 int64), stream
        "fa_forward": [_P] * 4 + [_I] * 8 + [_F, _I, _I, _F, _P, _P],
        # dqk, dv, info (5 ints: registers, dynamic shared bytes, local bytes,
        # threads, keys per K/V tile)
        "fa_wgmma_info": [_I, _I, _P],
    },
    "ssd_scan": {
        # x, a, b, c, y, cum, states, gmat, batch, seq, h, g, p_dim, n_dim,
        # chunk, stream
        "ssd_scan_f32": [_P] * 8 + [_I] * 7 + [_P],
        # batch, seq, h, g, p_dim, n_dim, chunk, sizes (3 int64)
        "ssd_scan_scratch": [_I] * 7 + [_P],
    },
}


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address as a ctypes pointer."""
    return ctypes.c_void_p(t.data_ptr())


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _target(stem: str) -> Path:
    src = CSRC_DIR / f"{stem}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Dict[str, object]]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, one
    ``nvcc`` per source, all started together, in the span
    ``kernels.build`` (with the stems ``built`` and found ``cached``).

    Returns ``{stem: {"path", "seconds", "built", "log"}}``; ``log`` is
    nvcc's output (ptxas register and shared-memory report) for a source
    built in this call.  Raises if any build fails.
    """
    with tracing.span("kernels.build") as sp:
        info = _build_all()
        sp.set(built=sorted(k for k, v in info.items() if v["built"]),
               cached=sorted(k for k, v in info.items() if not v["built"]))
    return info


def _build_all() -> Dict[str, Dict[str, object]]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    info: Dict[str, Dict[str, object]] = {}
    t0 = time.perf_counter()
    for src in sorted(CSRC_DIR.glob("*.cu")):
        target = _target(src.stem)
        if target.exists():
            info[src.stem] = {"path": str(target), "seconds": 0.0,
                              "built": False, "log": ""}
            continue
        nvcc = nvcc or _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, target)
    failed = []
    for stem, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{stem}.cu:\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a reader never sees a partial file
        info[stem] = {"path": str(target),
                      "seconds": time.perf_counter() - t0,
                      "built": True, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return info


@functools.lru_cache(maxsize=None)
def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed,
    with every entry point's argument types declared."""
    target = _target(stem)
    if not target.exists():
        build_all()
    lib = ctypes.CDLL(str(target))
    for name, argtypes in SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
