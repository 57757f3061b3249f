# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Build and load the CUDA kernels under ``csrc/`` at first use.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The sources
include no PyTorch header, so a build takes seconds rather than the
minutes a ``torch.utils.cpp_extension`` build of the same code takes; the
wrappers pass ``data_ptr()`` pointers and the current stream.

Libraries land in ``build/torch_kernels/`` at the root of the checkout,
named by a hash of their source, the headers under ``csrc/`` it includes
and that source's own flags, so an edited source or header rebuilds and an
unchanged one is reused. A failed build raises with the compiler's
output; nothing falls back to the plain PyTorch versions.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["NVCC_FLAGS", "SOURCE_FLAGS", "flags", "build_dir", "find_nvcc", "build",
           "local_headers", "wire_library", "flash_library", "flash_sm90_library"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"

NVCC_FLAGS = (
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-Xptxas=-v",
)
# Each source's own flags. The wire kernels' bits are pinned to the JAX
# programs' (no FMA contraction); the flash kernels have no pinned bits.
SOURCE_FLAGS = {
    "wire_kernels": ("-fmad=false",),
    "flash_kernels": (),
    "flash_sm90": (),
}


def flags(name: str) -> Tuple[str, ...]:
    """The ``nvcc`` flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def build_dir() -> Path:
    return _PKG.parent / "build" / "torch_kernels"


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default location."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(str(Path(os.environ[var]) / "bin" / "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels of "
        "bluefog_tpu_torch are built from source at first use"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_headers(source: Path) -> List[Path]:
    """The headers beside ``source`` that it includes with ``#include
    "..."``, directly or through another such header, in the order met."""
    found: List[Path] = []
    pending = [source]
    while pending:
        for name in _INCLUDE.findall(pending.pop(0).read_bytes()):
            header = source.parent / name.decode()
            if header.is_file() and header not in found:
                found.append(header)
                pending.append(header)
    return found


def _library_path(source: Path) -> Path:
    digest = hashlib.sha256()
    for part in [source] + local_headers(source):
        digest.update(part.read_bytes())
    digest.update(" ".join(flags(source.stem)).encode())
    return build_dir() / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def _command(source: Path, out: Path) -> List[str]:
    return [find_nvcc(), *flags(source.stem), "-shared", "-Xcompiler", "-fPIC",
            "-o", str(out), str(source)]


def build(sources: List[str]) -> Dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` in ``sources`` that is not built
    yet, one ``nvcc`` per source, all started together. Returns
    ``{name: library path}``; the compiler's output of each build is kept
    beside its library as ``.log``, ending with a ``# built in <s> s`` line.
    Raises if any build fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    libs = {name: _library_path(_CSRC / f"{name}.cu") for name in sources}
    running = []
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        command = _command(_CSRC / f"{name}.cu", tmp)
        log = lib.with_suffix(".log").open("w")
        proc = subprocess.Popen(command, stdout=log, stderr=subprocess.STDOUT)
        running.append((name, lib, tmp, log, proc, time.perf_counter()))
    failures = []
    while running:
        for job in [j for j in running if j[4].poll() is not None]:
            running.remove(job)
            name, lib, tmp, log, proc, start = job
            log.write(f"# built in {time.perf_counter() - start:.1f} s\n")
            log.close()
            if proc.returncode != 0:
                output = lib.with_suffix(".log").read_text()
                failures.append(f"{name}.cu (exit {proc.returncode}):\n{output}")
            else:
                os.replace(tmp, lib)
        time.sleep(0.05)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return libs


@functools.lru_cache(maxsize=None)
def wire_library() -> ctypes.CDLL:
    """The wire kernels (``csrc/wire_kernels.cu``), built if needed, with
    every entry point's argument and return types declared."""
    lib = ctypes.CDLL(str(build(["wire_kernels"])["wire_kernels"]))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    signatures = {
        "bf_wire_encode": [vp, vp, vp, ll, ci, vp],
        "bf_wire_encode_diff": [vp, vp, vp, vp, ll, ci, vp],
        "bf_wire_decode": [vp, vp, vp, vp, ci, ll, ci, vp],
        "bf_wire_decode_add": [vp, vp, vp, vp, ci, ll, ci, vp],
        "bf_wire_decode_accumulate": [vp, vp, vp, vp, vp, ci, ll, ci, ci, vp],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ci
    return lib


@functools.lru_cache(maxsize=None)
def flash_library() -> ctypes.CDLL:
    """The flash-attention kernels (``csrc/flash_kernels.cu``), built if
    needed. Each entry point takes the address of a ``BfFlashArgs`` block
    and the stream, and returns a ``cudaError_t``."""
    return _flash_entry_points("flash_kernels",
                               ("bf_flash_fwd", "bf_flash_bwd_dkv", "bf_flash_bwd_dq"))


@functools.lru_cache(maxsize=None)
def flash_sm90_library() -> ctypes.CDLL:
    """The wgmma/TMA flash kernels (``csrc/flash_sm90.cu``), built if
    needed, with the entry points of :func:`flash_library` and
    ``bf_flash_split_cotangent`` (x, hi, lo, three strides, b, t, h, d,
    stream)."""
    lib = _flash_entry_points("flash_sm90", ("bf_flash_fwd_sm90", "bf_flash_bwd_dkv_sm90",
                                             "bf_flash_bwd_dq_sm90"))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.bf_flash_split_cotangent.argtypes = [vp, vp, vp, ll, ll, ll, ci, ci, ci, ci, vp]
    lib.bf_flash_split_cotangent.restype = ci
    return lib


def _flash_entry_points(source: str, names) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build([source])[source]))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
