"""Seeded launch-contract violations for the port's asaplint kernelcheck,
read with bad_launch.cu: every rule fires on a line marked `expect:
<rule>`; good_launch.py / good_launch.cu are the clean twins.  Parsed,
never imported."""
import ctypes

import torch

from repro_torch.kernels import _build, _launch

_VP, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)


def _declare(lib):
    lib.good_launch.restype = _I
    lib.good_launch.argtypes = [_VP] * 2 + [_I, _LL, _F, _VP]
    lib.short_launch.restype = _I
    lib.short_launch.argtypes = [_VP] * 2 + [_I]  # expect: kc-abi-arity
    lib.typed_launch.restype = _I
    lib.typed_launch.argtypes = [_VP, _I, _I, _VP]  # expect: kc-abi-type
    lib.wide_launch.restype = _I
    lib.wide_launch.argtypes = [ctypes.c_double, _VP]  # expect: kc-abi-type
    lib.ret_launch.restype = ctypes.c_longlong  # expect: kc-abi-type
    lib.ret_launch.argtypes = [_VP]
    lib.ghost_launch.restype = _I
    lib.ghost_launch.argtypes = [_VP]  # expect: kc-abi-unknown


def unchecked(x: torch.Tensor):
    lib = _build.load()
    lib.good_launch(x.data_ptr(), x.data_ptr(), 1, 2, 1.0,  # expect: kc-unchecked-launch
                    _launch.stream_ptr(x.device))
    _launch.count_launch(unchecked)


def kept_not_checked(x: torch.Tensor):
    code = _build.load().ret_launch(_launch.stream_ptr(x.device))  # expect: kc-unchecked-launch
    _launch.count_launch(kept_not_checked)
    return code


def uncounted(x: torch.Tensor):
    code = _build.load().typed_launch(  # expect: kc-uncounted-launch
        x.data_ptr(), 1, 2, _launch.stream_ptr(x.device))
    _launch.check(code, "uncounted")
