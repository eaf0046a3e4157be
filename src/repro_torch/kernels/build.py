"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Every ``.cu`` file has a plain C interface, so no PyTorch header is
compiled: each source goes through its own ``nvcc -c`` (all started
together), one more ``nvcc -shared`` links them into one library, and
``ctypes`` loads it.  The library is built at first use, never at import,
into ``build/`` at the repository root; its file name carries a hash of
the sources (``.cu`` and the ``.cuh`` headers they share) and flags, so a
changed source never loads a stale build.
Each source compiles with ``-Xptxas -v``; what ``nvcc`` printed (each
kernel's registers, shared memory and spills) is kept beside the library
as ``<library>.log`` (:func:`build_log`).  Pointers and the stream cross
as ``c_void_p``, sizes as ``c_int64``; every launch entry point returns
the ``cudaError_t`` of its launch (the flash backward's: of the first of
its passes that fails, with the count of passes it launched written
through its last argument), and two queries return which of its kernels
the gather takes at a shape and how many f32 shares of dK and dV the flash
backward sums at a shape.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["CSRC", "DTYPE_CODES", "build_log", "check", "library_path",
           "load_library", "nvcc_path", "open_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = CSRC.parents[3] / "build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The ``dtype`` argument of every entry point: the bank's element type.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # dtype, X, V, G, w, Xo, Vo, Zo, alpha, eta, n, D, stream
    "fused_update_bank_launch": (_I, _P, _P, _P, _P, _P, _P, _P, _F, _F, _I64,
                                 _I64, _P),
    # dtype, P, X, Y, m, n, D, stream (P (m, n): m = n, or a row panel)
    "gossip_matmul_launch": (_I, _P, _P, _P, _I64, _I64, _I64, _P),
    # dtype, idx, wgt, X, Y, m receivers, n source rows, k_max, D, stream
    "gossip_gather_launch": (_I, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
    # dtype, m, n, k_max -> the gather's panel width (0: the row kernel)
    "gossip_gather_panel_cols": (_I, _I64, _I64, _I64),
    # dtype, hd, q, k, v, o, lse (or None), B, H, KV, S, the (b, head, s)
    # strides of q, k, v and o, causal, window, stream
    "flash_attention_launch": (_I, _I, _P, _P, _P, _P, _P, *(_I64,) * 16,
                               _I, _I64, _P),
    # dtype, hd, q, k, v, o, dO, dQ, dK, dV, the forward's lse (or None),
    # the f32 scratch (lse, D and lse2, the dK and dV shares), B, H, KV, S,
    # the (b, head, s) strides of q, k, v, o, dO, dQ, dK and dV, causal,
    # window, stream, the count of passes launched (out)
    "flash_attention_backward_launch": (_I, _I, *(_P,) * 13, *(_I64,) * 28,
                                        _I, _I64, _P, _PI),
    # dtype, hd, B, H, KV, S -> the f32 shares of dK and dV per kv head
    "flash_attention_backward_shares": (_I, _I, _I64, _I64, _I64, _I64),
}

# Entry points that return something else than a cudaError_t.
_RESTYPES = {"gossip_gather_panel_cols": _I64,
             "flash_attention_backward_shares": _I64}

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "repro_torch are built from source at first use"
    )


def _build(sources: list[Path], out: Path, flags: tuple[str, ...]) -> None:
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [
            subprocess.Popen([nvcc, *flags, "-c", str(s), "-o", str(o)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for s, o in zip(sources, objs)
        ]
        logs, errors = [], []
        for s, p in zip(sources, procs):
            log, _ = p.communicate()
            logs.append(f"== {s.name}\n{log}")
            if p.returncode:
                errors.append(f"{s.name}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *flags, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            capture_output=True, text=True,
        )
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
        Path(str(out) + ".log").write_text("\n".join(logs))
        os.replace(tmp_lib, out)  # atomic: a concurrent loader sees all or none


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return (*_FLAGS, *(f"-D{d}" for d in defines))


def library_path(defines: tuple[str, ...] = ()) -> Path:
    """Where the library of the current sources and flags is built."""
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for s in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(s.name.encode() + s.read_bytes())
    return BUILD / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """What ``nvcc -Xptxas -v`` printed when the library was built."""
    log = Path(str(library_path()) + ".log")
    return log.read_text() if log.exists() else ""


def open_library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The library of the sources compiled with ``-D`` each of ``defines``,
    built if it is not there, with its entry points' signatures set."""
    out = library_path(defines)
    if not out.exists():
        _build(sorted(CSRC.glob("*.cu")), out, _flags(defines))
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call and then cached."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = open_library()
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
