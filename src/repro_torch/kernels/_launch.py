"""Shared plumbing of the kernel wrappers: launch counters, the host-sync
counter and the error check every launch goes through."""
from __future__ import annotations

import threading

import torch

_count_lock = threading.Lock()

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Host syncs (a device-to-host read the host waits on) counted by the code
# that performs them, so a run can print how many a batch-layer costs.
host_syncs = 0  # guarded_by: _count_lock


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches` -- called where, and only where, the
    wrapper launches its kernel."""
    with _count_lock:
        wrapper.launches += 1


def note_host_sync(n: int = 1) -> None:
    global host_syncs
    with _count_lock:
        host_syncs += n


def reset_host_syncs() -> int:
    """Set the host-sync count to zero; returns the count it had."""
    global host_syncs
    with _count_lock:
        old, host_syncs = host_syncs, 0
    return old


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"code {code}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
