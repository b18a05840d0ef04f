"""How far a fault in a mesh serving path moves the logits: the size
against which the bf16 serving bands of `chip_smoke.py`'s tp phase are set.

  python tests/_torch_tp_serve_faults.py WORK_DIR [--dtype float32]
      [--arch zamba2_1p2b]

For each fault of the arch below, a copy of `src/repro_torch` is made
under WORK_DIR (a directory outside the checkout; the checkout is never
edited) with one line of the module broken, and two gloo ranks on the CPU,
the (1, 2) mesh, serve the arch at its published widths cut to 6 layers
and a 16384-row vocab: `build_sharded_prefill_step` on a [1, 640] prompt,
then 6 decode steps fed the plain run's greedy tokens.  gemma3_1b (the
default): the split-K path, one superblock, the prompt past its 512-slot
ring.  zamba2_1p2b: its first superblock (6 Mamba2 layers over "model" and
the shared block), the 6 steps outlasting the conv ring's 3 slots.  Prints
one JSON line a fault: each step's logits against the one-device
`api.prefill` / `api.decode` (relative Frobenius), "none" being the
unbroken copy.  Imports no jax.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
S, STEPS = 640, 6

#: fault -> (the line(s) of models/attention.py, what replaces them; the
#: last occurrence where the text recurs)
SPLIT_K_FAULTS = {
    "none": None,
    # the ranks' p.v products left unsummed
    "pv_unsummed": (
        '    return reduce_sum(torch.einsum("...bhgs,...bshd->...bhgd", '
        'pr.float(),',
        '    return (torch.einsum("...bhgs,...bshd->...bhgd", pr.float(),'),
    # each rank's own max in the merge
    "max_local": ("    m = reduce_max(s.amax(-1, keepdim=True))",
                  "    m = s.amax(-1, keepdim=True)"),
    # the new token written on no rank
    "token_unwritten": (
        "        _owner_write(cache.k, k, slot - sp.offset)\n"
        "        _owner_write(cache.v, v, slot - sp.offset)\n",
        "        pass\n"),
    # the valid slots off by one
    "slot_off_by_one": ("        i = i + sp.offset  # global slot indices",
                        "        i = i + sp.offset + 1"),
    # the decode's partial outputs of wo left unsummed over "model"
    "wo_unsummed": (
        '    return _out_proj(o, p["wo"], cfg), cache',
        '    return o.reshape(B, 1, H * hd) @ p["wo"], cache'),
    # every rank stores the first slots of the prefill's cache
    "prefill_slots": (
        "    j = torch.arange(sp.offset, sp.offset + local, device=t.device)",
        "    j = torch.arange(0, local, device=t.device)"),
}

#: zamba2's Mamba2 mixer over "model": fault -> (the line(s) of
#: models/mamba2.py, what replaces them)
MAMBA_FAULTS = {
    "none": None,
    # out_proj's partial outputs left unsummed over "model"
    "out_proj_unsummed": (
        '    return pshard.reduce_from_model(y @ p["out_proj"])',
        '    return y @ p["out_proj"]'),
    # the gated norm's sum of squares over the rank's channels alone
    "norm_sum_local": ("    ss = pshard.sum_over_model(", "    ss = ("),
    # the decode's conv ring read and written at the rank's heads' x
    # channels, not at the channels it stores
    "conv_ring_misaligned": (
        "    xbc = xbc.narrow(-1, sp.c0, sp.C)",
        "    xbc = xbc.narrow(-1, sp.h0 * P, sp.C)"),
    # the conv's output left ungathered: each rank reads its stored
    # channels as if they were the whole (x, B, C)
    "conv_out_local": (
        "        conv = pshard.gather_to_model(conv, -1)",
        "        conv = torch.cat([conv] * pshard.model_parallel_size(), -1)"),
}

#: arch -> (the module its faults break, its faults)
FAULTS = {"gemma3_1b": ("models/attention.py", SPLIT_K_FAULTS),
          "zamba2_1p2b": ("models/mamba2.py", MAMBA_FAULTS)}


def _broken_copy(work: str, arch: str, fault: str) -> str:
    src = os.path.join(work, arch, fault)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "src", "repro_torch"),
                    os.path.join(src, "repro_torch"))
    module, faults = FAULTS[arch]
    if faults[fault] is not None:
        path = os.path.join(src, "repro_torch", module)
        with open(path) as f:
            text = f.read()
        old, new = faults[fault]
        at = text.rfind(old)
        if at < 0:
            raise SystemExit(f"{fault}: its line is no longer in {module}")
        with open(path, "w") as f:
            f.write(text[:at] + new + text[at + len(old):])
    return src


def _rank(rank: int, store: str, out: str, dtype: str, arch: str):
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import build_api
    from repro_torch.models.lm import init_lm_params
    torch.set_num_threads(3)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    cfg = get_config(arch).replace(num_layers=6, vocab_size=16384,
                                   dtype=getattr(torch, dtype))
    params = init_lm_params(torch.Generator().manual_seed(0), cfg, "cpu")
    api = build_api(cfg)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(1),
        dtype=torch.int32)}
    max_len = S + STEPS

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    with torch.no_grad():
        want, caches = api.prefill(params, dict(batch, max_len=max_len))
        wants, tokens = [want], []
        for _ in range(STEPS):
            tokens.append(wants[-1].argmax(-1).to(torch.int32))
            want, caches = api.decode(params, caches, {"token": tokens[-1]})
            wants.append(want)
    mesh = make_host_mesh(1, 2, device_type="cpu")
    pspecs = SH.param_specs(params, cfg, mesh)
    dparams = SH.distribute_tree(params, mesh, pspecs)
    got, caches = ST.build_sharded_prefill_step(api, mesh, pspecs, max_len)(
        dparams, batch)
    errs = [rel(got, wants[0])]
    decode = ST.build_sharded_decode_step(
        api, mesh, pspecs, ST.prefill_cache_specs(api, mesh, batch, max_len))
    for t, want in zip(tokens, wants[1:]):
        got, caches = decode(dparams, caches, {"token": t})
        errs.append(rel(got, want))
    if rank == 0:
        with open(out, "w") as f:
            json.dump(errs, f)
    dist.destroy_process_group()


def _child(src: str, out: str, dtype: str, arch: str):
    sys.path.insert(0, src)
    import torch.multiprocessing as mp
    store = out + ".store"
    if os.path.exists(store):
        os.remove(store)
    mp.spawn(_rank, args=(store, out, dtype, arch), nprocs=2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("work_dir")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--arch", default="gemma3_1b", choices=sorted(FAULTS))
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return _child(*args.child, args.dtype, args.arch)
    work = os.path.abspath(args.work_dir)
    if work.startswith(os.path.abspath(REPO) + os.sep):
        raise SystemExit("WORK_DIR must lie outside the checkout")
    os.makedirs(work, exist_ok=True)
    for fault in FAULTS[args.arch][1]:
        src = _broken_copy(work, args.arch, fault)
        out = os.path.join(work, args.arch, f"{fault}.{args.dtype}.json")
        subprocess.run([sys.executable, os.path.abspath(__file__), work,
                        "--dtype", args.dtype, "--arch", args.arch,
                        "--child", src, out],
                       check=True, stdout=subprocess.DEVNULL)
        with open(out) as f:
            errs = json.load(f)
        print(json.dumps({"arch": args.arch, "fault": fault,
                          "dtype": args.dtype, "worst": max(errs),
                          "rel_err": errs}), flush=True)


if __name__ == "__main__":
    main()
