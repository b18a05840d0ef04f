"""Suppression comments with nothing left to suppress — only
`--strict-suppressions` flags them (rule: stale-suppression), on the
comments' own lines.  Parsed, never imported."""
import torch


def tidy(x: torch.Tensor) -> torch.Tensor:
    # sync-ok: this read was removed long ago; the comment rotted in place
    return x + 1


def typed(x: torch.Tensor) -> torch.Tensor:
    return x.float()  # shard-ok: the float64 this excused is gone
