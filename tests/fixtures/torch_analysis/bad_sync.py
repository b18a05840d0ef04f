"""Seeded host-sync violations for the port's asaplint pass 2: every rule
fires here, on the lines marked `expect: <rule>` (the test reads the marks);
good_sync.py is the clean twin.  Parsed, never imported."""
import threading

import torch

from repro_torch.kernels import _build, _launch


def counted_read(t: torch.Tensor) -> float:
    # the file counts its syncs, so the uncounted ones below are findings
    _launch.note_host_sync()
    return t.sum().item()


def uncounted_item(x: torch.Tensor) -> float:
    s = x.sum()
    return s.item()  # expect: sync-uncounted


def uncounted_int(ids):
    counts = torch.bincount(ids)
    return int(counts.max())  # expect: sync-uncounted


def uncounted_cpu_then_host_reads(x: torch.Tensor):
    host = x.cpu()  # expect: sync-uncounted
    # `host` lies on the host: its numpy() waits on no device
    return host.numpy(), x.tolist()  # expect: sync-uncounted


def uncounted_stream_and_event_syncs(x: torch.Tensor):
    torch.cuda.synchronize()  # expect: sync-uncounted
    ev = torch.cuda.Event()
    ev.record()
    ev.synchronize()  # expect: sync-uncounted
    torch.cuda.current_stream(x.device).synchronize()  # expect: sync-uncounted


def counted_elsewhere(x: torch.Tensor):
    if x.is_cuda:
        _launch.note_host_sync()
    for row in x:
        # counted once above, read once per row here: another block
        print(row.item())  # expect: sync-uncounted


def toy_kernel(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    lib = _build.load()
    code = lib.toy_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                          _launch.stream_ptr(x.device))
    _launch.check(code, "toy_kernel")
    _launch.count_launch(toy_kernel)
    return out


def toy_twice(x: torch.Tensor) -> torch.Tensor:
    return toy_kernel(toy_kernel(x))


_registry_lock = threading.Lock()


def module_locked(x: torch.Tensor) -> torch.Tensor:
    with _registry_lock:
        return toy_twice(x)  # expect: launch-under-lock


class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self._stream = torch.cuda.Stream()
        self.done = 0  # guarded_by: _lock

    def launch_locked(self, x: torch.Tensor):
        with self._lock:
            y = toy_kernel(x)  # expect: launch-under-lock
            self.done += 1
        return y

    def build_locked(self):
        with self._lock:
            _build.load()  # expect: launch-under-lock

    def sync_locked(self, x: torch.Tensor):
        with self._lock:
            _launch.note_host_sync()
            self.done += int(x.sum())  # expect: sync-under-lock

    def stream_sync_locked(self):
        with self._lock:
            _launch.note_host_sync()
            self._stream.synchronize()  # expect: sync-under-lock


def empty_reason(x: torch.Tensor) -> float:
    # sync-ok:
    return x.max().item()  # expect: sync-uncounted, sync-ok-no-reason
