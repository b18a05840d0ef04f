"""Hand-written Hopper kernels (CUDA C++ under ../csrc) and their wrappers."""


def launch_counts() -> dict:
    """Every kernel wrapper's launch counts so far in this process: the
    total, by route (where it has routes), and (super_gmm) by tile."""
    return {k.__name__: _counts(k) for k in wrappers()}


def wrappers() -> tuple:
    """Every kernel wrapper that counts its launches: the four of the TPU
    kernels, then the two backward kernels."""
    from repro_torch.kernels.dispatch_combine.dispatch_combine import (
        combine_gather, combine_weighted_bwd, dispatch_scatter)
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.super_gmm.super_gmm import super_gmm
    return (super_gmm, flash_attention, dispatch_scatter, combine_gather,
            flash_attention_bwd, combine_weighted_bwd)


def _counts(k) -> dict:
    rec = {"launches": k.launches}
    if hasattr(k, "launches_by_route"):
        rec["by_route"] = dict(k.launches_by_route)
    if hasattr(k, "launches_by_tile"):
        rec["by_tile"] = dict(k.launches_by_tile)
    return rec

