"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, and loaded
with ``ctypes``. No PyTorch header is included, so a build takes seconds.
Libraries go to ``build/kernels/`` at the repository root (or to the
directory given to ``utils.enable_compile_cache``), named by a hash of their
sources, so an edited source is rebuilt and an unchanged one is loaded as it
is.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises when that is not 0.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flash", "flash_quant", "decode", "observed_colsum", "decode_headwise")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each library's entry points (ctypes would cut a pointer passed
# without them to 32 bits).
SIGNATURES = {
    "flash": {"kvp_flash_attention":
              (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, F, F, I, P)},
    "flash_quant": {"kvp_flash_attention_quant":
                    (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, F, F, I, P)},
    "decode": {"kvp_decode_attention":
               (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, F, I, P)},
    "observed_colsum": {"kvp_observed_lse": (P, P, P, I, I, I, I, I, F, F, P),
                        "kvp_observed_colsum": (P, P, P, P, I, I, I, I, I, F, F, P)},
    "decode_headwise": {"kvp_decode_attention_headwise":
                        (P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, F, F, P)},
}

_lock = threading.Lock()
_loaded: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_build_dir: Path | None = None      # set by set_build_dir


def build_dir() -> Path:
    return _build_dir or CSRC.parent.parent / "build" / "kernels"


def set_build_dir(path) -> None:
    """Build and load the libraries under ``path`` from now on (None: the
    default ``build/kernels/``). Libraries loaded already stay loaded."""
    global _build_dir
    _build_dir = None if path is None else Path(path).resolve()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the Hopper kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source that has no up-to-date library, one nvcc
    process per source, all started together. Returns {name: seconds}. The
    compiler's register / shared-memory report goes to ``<library>.log``."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            continue
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(lib) + ".tmp", str(CSRC / f"{name}.cu")]
        log = open(lib.with_suffix(".log"), "w")
        jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, lib)
    seconds = {}
    failed = []
    for name, (proc, log, lib) in jobs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n{lib.with_suffix('.log').read_text()}")
        else:
            os.replace(str(lib) + ".tmp", lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def entry(name: str, symbol: str | None = None):
    """The ctypes function ``symbol`` of ``csrc/<name>.cu`` (its only entry
    point when ``symbol`` is None), building the library if needed."""
    if symbol is None:
        (symbol,) = SIGNATURES[name]
    fn = _loaded.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        if (name, symbol) not in _loaded:
            lib = _library_path(name)
            if not lib.exists():
                build((name,))
            cdll = ctypes.CDLL(str(lib))
            for sym, argtypes in SIGNATURES[name].items():
                fn = getattr(cdll, sym)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _loaded[(name, sym)] = fn
    return _loaded[(name, symbol)]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for an absent argument."""
    return None if t is None else t.data_ptr()
