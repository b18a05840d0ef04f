"""Seeded mesh-rule violations for the port's asaplint shardcheck: every
rule fires on a line marked `expect: <rule>`; good_mesh.py is the clean
twin.  Parsed, never imported."""
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.launch.sharding import P, distribute
from repro_torch.models import pshard

ARCHS = ["gemma3_1b", "qwen3_moe_235b_a22b"]
_ALIASES = {"gemma3-1b": "gemma3_1b"}
FSDP_ARCHS = {"qwen3_moe_235b_a22b", "llama-9000"}  # expect: sc-fsdp-unknown-arch
KNOWN_LOGICAL_AXES = frozenset({"batch", "heads"})


def make_mesh():
    axes = ("data", "model")
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=axes)


def unknown_axis():
    return P("data", "tensor")  # expect: sc-unknown-mesh-axis


def duplicate_axis():
    return P(("data", "model"), "model")  # expect: sc-duplicate-mesh-axis


def too_long(mesh):
    return distribute(torch.zeros((4, 8)), mesh,
                      P("data", None, None))  # expect: sc-spec-rank


def too_long_varargs(mesh):
    return distribute(torch.ones(16), mesh, P("data", "model"))  # expect: sc-spec-rank


def unknown_logical(x):
    return pshard.constrain(x, "batch", "sequence")  # expect: sc-unknown-logical-axis


def unexplained():
    # shard-ok:
    return P("data", "tensor2")  # expect: sc-unknown-mesh-axis, shard-ok-no-reason
