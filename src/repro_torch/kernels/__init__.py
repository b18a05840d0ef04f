"""Hand-written Hopper kernels (CUDA C++ under ../csrc) and their wrappers."""


def launch_counts() -> dict:
    """Every kernel wrapper's launch counts so far in this process: the
    total, by route, and (super_gmm) by tile."""
    from repro_torch.kernels.dispatch_combine.dispatch_combine import (
        combine_gather, dispatch_scatter)
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.super_gmm.super_gmm import super_gmm
    out = {}
    for k in (super_gmm, flash_attention, dispatch_scatter, combine_gather):
        rec = {"launches": k.launches,
               "by_route": dict(k.launches_by_route)}
        if hasattr(k, "launches_by_tile"):
            rec["by_tile"] = dict(k.launches_by_tile)
        out[k.__name__] = rec
    return out
