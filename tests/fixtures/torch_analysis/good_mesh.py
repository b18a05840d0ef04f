"""The clean twin of bad_mesh.py: the same calls, each spec naming only
declared axes, once each, no longer than its tensor's rank; one deliberate
suppression with its reason.  Parsed, never imported."""
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.launch.sharding import P, distribute
from repro_torch.models import pshard

ARCHS = ["gemma3_1b", "qwen3_moe_235b_a22b"]
_ALIASES = {"gemma3-1b": "gemma3_1b"}
FSDP_ARCHS = {"qwen3_moe_235b_a22b", "gemma3-1b"}
KNOWN_LOGICAL_AXES = frozenset({"batch", "heads"})


def make_mesh():
    axes = ("data", "model")
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=axes)


def known_axis():
    return P("data", "model")


def tuple_axis():
    return P(("data", "model"), None)


def fits(mesh):
    return distribute(torch.zeros((4, 8)), mesh, P("data", None))


def fits_varargs(mesh):
    return distribute(torch.ones(16), mesh, P("data"))


def known_logical(x):
    return pshard.constrain(x, "batch", "heads")


def explained():
    # shard-ok: a spec written for a mesh this fixture does not declare
    return P("pod", "data")
