"""Seeded dtype-policy violations for the port's asaplint shardcheck: every
rule fires on a line marked `expect: <rule>`; good_dtype.py is the clean
twin.  Parsed, never imported."""
import torch


def f64_attr(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)  # expect: sc-f64-literal


def f64_string(n: int) -> torch.Tensor:
    return torch.zeros(n, dtype="double")  # expect: sc-f64-literal


def f64_method(x: torch.Tensor) -> torch.Tensor:
    return x.double()  # expect: sc-f64-literal


def bf16_accumulator(xs):
    acc = torch.zeros(4, dtype=torch.bfloat16)  # expect: sc-bf16-accum
    for x in xs:
        acc += x
    return acc


def bf16_inplace(xs, like: torch.Tensor):
    acc = torch.zeros_like(like, dtype=torch.bfloat16)  # expect: sc-bf16-accum
    for x in xs:
        acc.add_(x)
    return acc


def blank_reason(x: torch.Tensor) -> torch.Tensor:
    # shard-ok:
    return x.to(torch.double)  # expect: sc-f64-literal, shard-ok-no-reason
