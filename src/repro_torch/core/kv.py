"""KV-handoff layer for prefill/decode disaggregation.

A prefill engine finishes a request holding the prompt's per-layer KV cache.
Disaggregated serving moves that state to a DECODE engine before the second
token can be produced -- this module is the currency of that move:

  * `KVSpec`     -- per-layer cache geometry derived from a ModelConfig
                   (layers x kv heads x head_dim x element size), so byte
                   accounting and the real device-buffer move price the same
                   payload.
  * `KVHandle`   -- one request's exported cache: rid, prompt length, spec,
                   and the stacked [L, len, kvh, hd] K/V tensors (on the
                   card in the executor) with the CUDA event after which
                   they are written.
  * `transfer_seconds` -- the link cost of shipping one handle (one hop +
                   bytes over the link rate of a `Hardware`).
  * `KVTransferLog` -- thread-safe handoff accounting the orchestrator
                   reports (count + bytes), so "did a KV handoff actually
                   happen" is checkable in smoke tests.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class KVSpec:
    """Per-layer KV-cache geometry (K + V per token per layer)."""
    num_layers: int
    num_kv_heads: int
    head_dim: int
    bytes_per_el: int = 2  # bf16

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "KVSpec":
        """The cache is kept in the model's type (the reference prices bf16
        whatever the config says)."""
        return cls(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
                   head_dim=cfg.head_dim,
                   bytes_per_el=torch.finfo(cfg.dtype).bits // 8)

    @property
    def token_bytes(self) -> float:
        """Bytes ONE cached token contributes across all layers (K and V)."""
        return 2.0 * self.num_layers * self.num_kv_heads * self.head_dim \
            * self.bytes_per_el

    def layer_shape(self, length: int) -> Tuple[int, int, int]:
        """Shape of one layer's K (or V) cache for a `length`-token prompt."""
        return (length, self.num_kv_heads, self.head_dim)


@dataclasses.dataclass
class KVHandle:
    """One request's exported prefill KV state.

    `payload` is the stacked per-layer (k, v) pair ([L, len, kvh, hd] each),
    tensors on the prefill executor's device; `ready` is the CUDA event
    recorded on the producing stream after they were written (None on the
    CPU).  The decode engine waits on it before its enrollment copy.
    """
    rid: int
    prompt_len: int
    spec: KVSpec
    created_at: float  # engine-time the prefill finished (first token)
    payload: Optional[Any] = None  # (k [L,len,kvh,hd], v [L,len,kvh,hd])
    ready: Optional[Any] = None  # torch.cuda.Event or None

    @property
    def bytes(self) -> float:
        return self.prompt_len * self.spec.token_bytes


def transfer_seconds(handle: KVHandle, hw) -> float:
    """Link time to ship `handle` point-to-point: one hop + the bytes over
    one link (`hw.hop_latency`, `hw.ici_bw`)."""
    return hw.hop_latency + handle.bytes / hw.ici_bw


class KVTransferLog:
    """Thread-safe prefill->decode handoff accounting.

    The orchestrator records one entry per enrollment into a REMOTE decode
    engine (colocated mode transfers nothing); serve.py's pd gate reads the
    totals.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0  # guarded_by: _lock
        self._bytes = 0.0  # guarded_by: _lock
        self._seconds = 0.0  # guarded_by: _lock

    def record(self, handle: KVHandle, seconds: float):
        with self._lock:
            self._count += 1
            self._bytes += handle.bytes
            self._seconds += seconds

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def bytes(self) -> float:
        with self._lock:
            return self._bytes

    @property
    def seconds(self) -> float:
        with self._lock:
            return self._seconds
