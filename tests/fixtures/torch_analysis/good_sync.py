"""Host syncs done right — the port's asaplint pass 2 must report nothing
unsuppressed here.  Parsed, never imported."""
import threading

import numpy as np
import torch

from repro_torch.kernels import _build, _launch


def counted_read(t: torch.Tensor) -> float:
    if t.is_cuda:
        _launch.note_host_sync()
    return t.sum().item()


def not_tensors(x: torch.Tensor, scale: float, arr: np.ndarray):
    # shapes, Python numbers and numpy arrays are no device reads
    return int(x.shape[0]), float(scale), arr.tolist(), int(x.numel())


def host_bounds(bounds: torch.Tensor):
    # sync-ok: the caller builds bounds on the host from Python lengths
    return bounds.tolist()


def toy_kernel(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    lib = _build.load()
    code = lib.toy_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                          _launch.stream_ptr(x.device))
    _launch.check(code, "toy_kernel")
    _launch.count_launch(toy_kernel)
    return out


class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self.done = 0  # guarded_by: _lock
        self.tokens = []  # guarded_by: _lock

    def launch_then_lock(self, x: torch.Tensor):
        y = toy_kernel(x)  # outside the lock: a first call builds unlocked
        first = torch.argmax(y, -1)
        _launch.note_host_sync()
        first = first.cpu().numpy()
        with self._lock:
            # `first` was read to the host above: no sync here
            self.tokens.append(int(first[0]))
            self.done += 1
        return y
