"""Shared plumbing of the kernel wrappers: launch counters, the host-sync
counter, the error check every launch goes through and the test that picks
a wrapper's autograd Function."""
from __future__ import annotations

import threading
from typing import Optional

import torch

_count_lock = threading.Lock()

DTYPES = (torch.float32, torch.bfloat16)  # the dtypes the kernels take
# The kernels of a launch function with several routes, indexed by the code
# the wrapper hands it: plain FMA (fp32), wmma (bf16 that TMA cannot
# describe), wgmma on TMA-fed shared memory (the Hopper main path).
ROUTES = ("fma", "wmma", "wgmma")

# Host syncs (a device-to-host read the host waits on) counted by the code
# that performs them, so a run can print how many a batch-layer costs.
host_syncs = 0  # guarded_by: _count_lock


def count_launch(wrapper, route: Optional[str] = None,
                 tile: Optional[str] = None) -> None:
    """Add one to `wrapper.launches` -- called where, and only where, the
    wrapper launches its kernel.  A wrapper with several routes also names
    the one it launched; the launch is counted in
    `wrapper.launches_by_route` too, and a route it does not have raises.
    A wrapper whose kernel has several tiles names the tile too
    (`wrapper.launches_by_tile`), and a tile it does not have raises."""
    with _count_lock:
        if route is not None and route not in wrapper.launches_by_route:
            raise KeyError(f"{wrapper.__name__}: no route {route!r}")
        if tile is not None and tile not in wrapper.launches_by_tile:
            raise KeyError(f"{wrapper.__name__}: no tile {tile!r}")
        if route is not None:
            wrapper.launches_by_route[route] += 1
        if tile is not None:
            wrapper.launches_by_tile[tile] += 1
        wrapper.launches += 1


def reset_launches(wrapper) -> None:
    """Set a wrapper's launch counts (and per-route counts) to zero."""
    with _count_lock:
        wrapper.launches = 0
        if hasattr(wrapper, "launches_by_route"):
            wrapper.launches_by_route = dict.fromkeys(
                wrapper.launches_by_route, 0)
        if hasattr(wrapper, "launches_by_tile"):
            wrapper.launches_by_tile = dict.fromkeys(
                wrapper.launches_by_tile, 0)


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


def needs_grad(*tensors) -> bool:
    """True where autograd records: grad mode on and an input that needs a
    gradient.  Only then do the wrappers go through their autograd
    Functions (and the flash forward keep its log-sum-exp): serving calls
    the kernels directly."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"code {code}")


def stream_ptr(device: torch.device) -> int:
    """The raw handle of the calling thread's current stream on `device` (a
    CUDA tensor's device, which always has an index).  The same handle as
    `torch.cuda.current_stream(device).cuda_stream`, without building a
    Stream object: 0.16 against 3.30 us a call on an H100 machine's host
    (`chip_smoke.py`'s timing phase prints both)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
