"""Builds and loads the port's CUDA kernels.

The sources under `repro_torch/csrc/*.cu` (and the headers `*.cuh` they
include) are compiled with `nvcc` for `sm_90a` into ONE shared library with
a plain C interface and loaded with `ctypes` -- seconds to build, against
minutes for a build that includes PyTorch's headers.  The library links
against the CUDA runtime only: the driver's tensor-map encoder is found at
run time through the runtime's driver entry point.  It is built at first
use from the sources beside this package and nothing else, into
`build/repro_torch/` at the repository root (override with
`REPRO_TORCH_BUILD_DIR`); its file name carries a hash of every source and
header and of the compile and link flags, so an edited source, header or
flag is rebuilt and a stale library is never loaded.  Each build keeps
`ptxas`'s report (registers, shared memory, spills per kernel) beside the
library.  Nothing here runs at import time: a machine without `nvcc`
imports every module and only fails when a kernel is asked for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # guarded_by: _lock

_VP, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def sources(csrc: pathlib.Path = CSRC) -> list:
    """Every file the library is built from: the `.cu` sources, each
    compiled on its own, and the `.cuh` headers they include."""
    return sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")])


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on the machine with the card")


def _report_path(lib_path: pathlib.Path) -> pathlib.Path:
    return lib_path.with_suffix(".ptxas.txt")


def _compile(lib_path: pathlib.Path, srcs) -> None:
    """One `nvcc -c` per `.cu` source, all started together, then one link;
    ptxas's report of every source goes beside the library."""
    nvcc = _nvcc()
    out = lib_path.parent
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    jobs = []
    for s in srcs:
        if s.suffix != ".cu":
            continue  # a header: compiled where it is included
        obj = out / f"{tag}.{s.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)]
        jobs.append((s, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failed, logs = [], [], []
    for s, obj, proc in jobs:
        log, _ = proc.communicate()
        logs.append(f"== {s.name}\n{log}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {s.name}:\n{log}")
        objs.append(obj)
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out / f"{tag}.so"
        link = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        _report_path(lib_path).write_text("\n".join(logs))
        os.replace(tmp, lib_path)  # atomic: a concurrent build of the same sources loses nothing
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> None:
    lib.super_gmm_launch.restype = _I
    lib.super_gmm_launch.argtypes = [_VP] * 5 + [_I] * 7 + [_LL, _LL, _VP]
    lib.flash_attention_launch.restype = _I
    lib.flash_attention_launch.argtypes = (
        [_VP] * 5 + [_I] * 6 + [_LL] * 12 + [_I, _I, _F, _F, _VP])
    lib.flash_attention_bwd_launch.restype = _I
    lib.flash_attention_bwd_launch.argtypes = (
        [_VP] * 12 + [_I] * 6 + [_VP] + [_I, _I, _F, _F, _VP])
    lib.dispatch_scatter_launch.restype = _I
    lib.dispatch_scatter_launch.argtypes = [_VP] * 4 + [_I] * 5 + [_VP]
    lib.combine_gather_launch.restype = _I
    lib.combine_gather_launch.argtypes = [_VP] * 3 + [_I] * 4 + [_VP]
    lib.dispatch_whole_launch.restype = _I
    lib.dispatch_whole_launch.argtypes = [_VP] * 5 + [_I] * 5 + [_LL, _I,
                                                                 _VP]
    lib.combine_weighted_launch.restype = _I
    lib.combine_weighted_launch.argtypes = [_VP] * 4 + [_I, _I, _LL, _I, _I,
                                                        _VP]
    lib.combine_weighted_bwd_launch.restype = _I
    lib.combine_weighted_bwd_launch.argtypes = [_VP] * 6 + [_I, _I, _LL, _I,
                                                            _I, _VP]


def library_path() -> pathlib.Path:
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return build_dir() / f"libasap_kernels_{_digest(srcs)}.so"


def ptxas_report() -> str:
    """ptxas's report of the build of the current sources ("" if none)."""
    path = _report_path(library_path())
    return path.read_text() if path.exists() else ""


def load() -> ctypes.CDLL:
    """The kernel library, built first if its sources changed.  Raises if it
    cannot be built or loaded -- callers never fall back to a plain version."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path, sources())
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
        return _lib
