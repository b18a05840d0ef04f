"""The dtype policy kept — the port's asaplint shardcheck must report
nothing unsuppressed here.  Parsed, never imported."""
import numpy as np
import torch


def fp32_accumulator(xs, like: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(like, dtype=torch.float32)
    for x in xs:
        acc += x.float()
    return acc.to(torch.bfloat16)


def host_math(a: np.ndarray) -> np.ndarray:
    return a.astype(np.float64)  # host numpy, not device code


def gradcheck_inputs(x: torch.Tensor) -> torch.Tensor:
    # shard-ok: gradcheck needs float64 inputs; never on the serving path
    return x.to(torch.float64)
