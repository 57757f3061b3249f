# Copyright 2026. Licensed under the Apache License, Version 2.0.
"""Build and load the CUDA kernels and the host library under ``csrc/`` at
first use.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The sources
include no PyTorch header, so a build takes seconds rather than the
minutes a ``torch.utils.cpp_extension`` build of the same code takes; the
wrappers pass ``data_ptr()`` pointers and the current stream. The one
``.cc`` source, the timeline's writer thread (``timeline_writer.cc``), is
compiled by the host's ``g++`` (:func:`timeline_library`).

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
from typing import Dict, List, Optional, Tuple

__all__ = ["NVCC_FLAGS", "CXX_FLAGS", "SOURCE_FLAGS", "flags", "build_dir", "find_nvcc",
           "find_cxx", "build", "local_headers", "wire_library", "flash_library",
           "flash_sm90_library", "batchnorm_library", "timeline_library"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"

NVCC_FLAGS = (
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-Xptxas=-v",
)
# The host compiler's flags for a ``.cc`` source (the JAX package builds
# its timeline writer with the same).
CXX_FLAGS = ("-O2", "-std=c++17", "-pthread")
# Each source's own flags. The wire kernels' bits are pinned to the JAX
# programs' (no FMA contraction); the flash and BatchNorm kernels have no
# pinned bits (the BatchNorm kernels round explicitly where they follow
# the plain version's order of operations).
SOURCE_FLAGS = {
    "wire_kernels": ("-fmad=false",),
    "flash_kernels": (),
    "flash_sm90": (),
    "batchnorm_kernels": (),
    "timeline_writer": (),
}


def _source(name: str) -> Path:
    """``csrc/<name>.cu``, else ``csrc/<name>.cc``."""
    cu = _CSRC / f"{name}.cu"
    return cu if cu.exists() else _CSRC / f"{name}.cc"


def flags(name: str) -> Tuple[str, ...]:
    """The compiler flags of ``csrc/<name>.cu`` (``nvcc``) or
    ``csrc/<name>.cc`` (``g++``)."""
    base = CXX_FLAGS if _source(name).suffix == ".cc" else NVCC_FLAGS
    return base + SOURCE_FLAGS[name]


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


def find_cxx() -> Optional[str]:
    """``g++`` on ``PATH``, or None."""
    return shutil.which("g++")


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
    if source.suffix == ".cc":
        cxx = find_cxx()
        if cxx is None:
            raise RuntimeError(f"g++ not found; {source.name} is built from source at first use")
        return [cxx, *flags(source.stem), "-shared", "-fPIC", "-o", str(out), str(source)]
    return [find_nvcc(), *flags(source.stem), "-shared", "-Xcompiler", "-fPIC",
            "-o", str(out), str(source)]


def build(sources: List[str]) -> Dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` (or ``.cc``) in ``sources`` that is
    not built yet, one compiler per source, all started together. Returns
    ``{name: library path}``; the compiler's output of each build is kept
    beside its library as ``.log``, ending with a ``# built in <s> s`` line.
    Raises if any build fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    libs = {name: _library_path(_source(name)) for name in sources}
    running = []
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        command = _command(_source(name), tmp)
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
                failures.append(f"{_source(name).name} (exit {proc.returncode}):\n{output}")
            else:
                os.replace(tmp, lib)
        time.sleep(0.05)
    if failures:
        raise RuntimeError("the build failed for " + "\n".join(failures))
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


@functools.lru_cache(maxsize=None)
def batchnorm_library() -> ctypes.CDLL:
    """The BatchNorm kernels (``csrc/batchnorm_kernels.cu``), built if
    needed, with every entry point's argument and return types declared.
    Only a model with BatchNorm on the card builds and loads it."""
    lib = ctypes.CDLL(str(build(["batchnorm_kernels"])["batchnorm_kernels"]))
    vp, ll, ci, cf = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    signatures = {
        "bf_bn_forward": [vp] * 9 + [ll, ci, ci, ci, ci, cf, cf, cf, ci, ci, ci, vp],
        "bf_bn_backward": [vp] * 11 + [ll, ci, ci, ci, ci, ci, ci, vp],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ci
    return lib


def _flash_entry_points(source: str, names) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build([source])[source]))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def timeline_library() -> ctypes.CDLL:
    """The timeline's native writer (``csrc/timeline_writer.cc``), built by
    ``g++`` if needed, with the argument and return types of its entry
    points (the JAX package's ``timeline._load_native``)."""
    lib = ctypes.CDLL(str(build(["timeline_writer"])["timeline_writer"]))
    cp, ci, ll = ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong
    lib.bf_timeline_start.argtypes = [cp]
    lib.bf_timeline_start.restype = ci
    lib.bf_timeline_stop.argtypes = []
    lib.bf_timeline_stop.restype = None
    lib.bf_timeline_record.argtypes = [cp, cp, ctypes.c_char, ci, ll]
    lib.bf_timeline_record.restype = None
    lib.bf_timeline_record_complete.argtypes = [cp, cp, ci, ll, ll, ll]
    lib.bf_timeline_record_complete.restype = None
    lib.bf_timeline_record_counter.argtypes = [cp, cp, ci, ll, ctypes.c_double]
    lib.bf_timeline_record_counter.restype = None
    lib.bf_timeline_now_us.argtypes = []
    lib.bf_timeline_now_us.restype = ll
    return lib
