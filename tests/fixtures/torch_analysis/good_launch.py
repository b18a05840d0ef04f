"""Launch contracts kept — the port's asaplint kernelcheck must report
nothing unsuppressed for this file with good_launch.cu.  Parsed, never
imported."""
import ctypes

import torch

from repro_torch.kernels import _build, _launch

_VP, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)


def _declare(lib):
    lib.toy_launch.restype = _I
    lib.toy_launch.argtypes = [_VP] * 3 + [_I] * 2 + [_LL, _F, _VP]
    lib.toy_bwd_launch.restype = _I
    lib.toy_bwd_launch.argtypes = ([_VP] * 2 + [_I]) + [_VP]


def toy(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    lib = _build.load()
    code = lib.toy_launch(x.data_ptr(), x.data_ptr(), out.data_ptr(), 1, 2,
                          x.stride(0), 1.0, _launch.stream_ptr(x.device))
    _launch.check(code, "toy")
    _launch.count_launch(toy, "fma")
    return out


def toy_bwd(x: torch.Tensor) -> torch.Tensor:
    _launch.check(_build.load().toy_bwd_launch(
        x.data_ptr(), x.data_ptr(), 1, _launch.stream_ptr(x.device)),
        "toy_bwd")
    _launch.count_launch(toy_bwd)
    return x
