"""Host-side logic of the port's Hopper kernels, on the CPU: the route rules
by which the wrappers pick a kernel, a plain mirror of the super_gmm
kernel's persistent tile walk, the per-route launch counts, and the kernel
build's digest.  Nothing here needs nvcc or a card."""
import itertools
import re
import shutil
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build, _launch
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.super_gmm import super_gmm as sg
from repro_torch.launch import sweep_bwd_tiles


def cu_tiles() -> List[Tuple[int, int]]:
    """The wgmma kernel's (BM, BN) instantiations, read back out of
    csrc/super_gmm.cu's `if (tile == i) return wg::launch<BM, BN>` lines, in
    the order of their index."""
    src = (_build.CSRC / "super_gmm.cu").read_text()
    found = re.findall(r"if \(tile == (\d+)\) return wg::launch<(\d+), "
                       r"(\d+)>", src)
    assert [int(i) for i, _, _ in found] == list(range(len(found)))
    return [(int(bm), int(bn)) for _, bm, bn in found]


# ------------------------------------------------------ persistent walk --

def persistent_walk(counts: Optional[Sequence[int]], E: int, C: int, N: int,
                    grid: int, BM: int, BN: int
                    ) -> Tuple[List[List[Tuple[int, int, int]]],
                               List[List[Tuple[int, int, int]]]]:
    """Plain mirror of the wgmma kernel's persistent walk, per block of a
    `grid`-block launch: (its real tiles as (expert, m0, n0) in the order it
    takes them, its padding runs as (expert, first element, elements) of
    the expert's [C, N] output that it zeroes).

    Real rows of expert e: min(counts[e], C) (C for every expert with
    `counts` None).  Its real tiles are the BM-row tiles that hold a real
    row, times the BN-column tiles of N, walked experts outermost, then
    n-tiles, then m-tiles; block b takes tiles b, b + grid, ....  The rows
    from the end of an expert's last real tile to C are padding; the
    padding of all experts, laid end to end, is split evenly over the blocks
    in whole 4-element units."""
    rows = [C if counts is None else min(max(int(counts[e]), 0), C)
            for e in range(E)]
    nt = -(-N // BN)
    tiles, pad_pre, firsts = [], [0], []
    for e, r in enumerate(rows):
        mt = -(-r // BM)
        tiles += [(e, m * BM, n * BN) for n in range(nt) for m in range(mt)]
        firsts.append(mt * BM * N)
        pad_pre.append(pad_pre[-1] + max(C - mt * BM, 0) * N)
    walk_tiles = [tiles[b::grid] for b in range(grid)]
    walk_pads: List[List[Tuple[int, int, int]]] = []
    for b in range(grid):
        z0 = pad_pre[-1] // 4 * b // grid * 4
        z1 = pad_pre[-1] // 4 * (b + 1) // grid * 4
        runs = []
        for e in range(E):
            lo, hi = max(z0, pad_pre[e]), min(z1, pad_pre[e + 1])
            if lo < hi:
                runs.append((e, firsts[e] + lo - pad_pre[e], hi - lo))
        walk_pads.append(runs)
    return walk_tiles, walk_pads


def _brute_force(counts, E, C, N, BM, BN):
    """Every real (expert, m0, n0) tile, and every padding element
    (expert, flat offset in its [C, N] output), by enumeration."""
    tiles, pad = set(), set()
    for e in range(E):
        real = C if counts is None else min(max(counts[e], 0), C)
        for m0 in range(0, C, BM):
            if m0 < real:
                tiles |= {(e, m0, n0) for n0 in range(0, N, BN)}
            else:
                pad |= {(e, r * N + c) for r in range(m0, C)
                        for c in range(N)}
    return tiles, pad


# counts 0, 1, 64, 65, 128, 129, C and > C (BM and BM + 1 of every tile),
# E = 1 and E = 128, ragged N
_WALKS = [
    ([0], 1, 200, 64), ([1], 1, 200, 64), ([128], 1, 300, 264),
    ([129], 1, 300, 264), ([300], 1, 300, 264), ([999], 1, 300, 8),
    ([0, 1, 128, 129, 260, 999], 6, 260, 520),
    (None, 3, 130, 256),
    ([(7 * e) % 300 for e in range(128)], 128, 256, 16),
    ([0] * 127 + [1], 128, 8, 24),
    ([64, 65, 63, 127], 4, 200, 392),
]
_TILES = [(128, 256), (128, 128), (64, 256), (64, 128)]
# (grid, BM, BN); the default tile's cases keep their ids ("1", "7", "132")
_GRID_TILES = [(g, bm, bn) for g in (1, 7, 132) for bm, bn in _TILES]
_GRID_TILE_IDS = [str(g) if (bm, bn) == _TILES[0] else f"{g}-{bm}x{bn}"
                  for g, bm, bn in _GRID_TILES]


@pytest.mark.parametrize("grid,BM,BN", _GRID_TILES, ids=_GRID_TILE_IDS)
@pytest.mark.parametrize("counts,E,C,N", _WALKS)
def test_persistent_walk_equals_brute_force(counts, E, C, N, grid, BM, BN):
    walk_tiles, walk_pads = persistent_walk(counts, E, C, N, grid, BM, BN)
    want_tiles, want_pad = _brute_force(counts, E, C, N, BM, BN)
    got_tiles = [t for block in walk_tiles for t in block]
    assert sorted(got_tiles) == sorted(want_tiles)  # each tile exactly once
    got_pad = [(e, first + i) for block in walk_pads
               for (e, first, n) in block for i in range(n)]
    assert len(got_pad) == len(want_pad) and set(got_pad) == want_pad
    # real tiles and padding together cover every output element once
    covered = {(e, r * N + c) for (e, m0, n0) in want_tiles
               for r in range(m0, min(m0 + BM, C))
               for c in range(n0, min(n0 + BN, N))}
    assert not covered & want_pad
    assert len(covered) + len(want_pad) == E * C * N
    # the walk: block b takes tiles b, b + grid, ... of the order experts,
    # n-tiles, m-tiles; padding shares differ by at most one 4-element unit
    order = sorted(want_tiles, key=lambda t: (t[0], t[2], t[1]))
    assert walk_tiles == [order[b::grid] for b in range(grid)]
    shares = [sum(n for _, _, n in block) for block in walk_pads]
    assert max(shares) - min(shares) <= 4


# ------------------------------------------------------------ route rules --

def _model_qkv(B, S, H, KVH, dh):
    """q, k, v as the model hands them to the kernel: projections reshaped
    to [B, S, heads, dh]."""
    q = torch.empty((B, S, H * dh), device="meta").reshape(B, S, H, dh)
    k = torch.empty((B, S, KVH * dh), device="meta").reshape(B, S, KVH, dh)
    return q, k, k


def _fa_route(q, k, v, dtype=torch.bfloat16, ptrs=(0, 0, 0)):
    return fa.route(dtype, q.shape[-1], ptrs,
                    [t.stride()[:3] for t in (q, k, v)])


@pytest.mark.parametrize("B,S", [(1, 256), (1, 512), (2, 1024), (2, 2048),
                                 (4, 300)])
def test_flash_route_main_path_takes_wgmma(B, S):
    cfg = get_config("qwen3_moe_235b_a22b")
    q, k, v = _model_qkv(B, S, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
    assert _fa_route(q, k, v) == "wgmma"
    # the [BH, S, dh] entry point views its inputs as H = 1
    x = torch.empty((B * 8, S, 64), device="meta").unsqueeze(2)
    assert _fa_route(x, x, x) == "wgmma"


_ODD_STRIDES = {  # (batch, position, head) strides, one not 16-byte aligned
    "odd_head_stride": (100 * 8 * 132, 8 * 132, 132),
    "odd_pos_stride": (100 * 8 * 132, 8 * 128 + 4, 128),
    "odd_batch_stride": (100 * 8 * 128 + 4, 8 * 128, 128)}


@pytest.mark.parametrize("case,want", [
    ("fp32", "fma"), ("dh32", "wmma"), ("dh64", "wgmma"),
    ("unaligned_q", "wmma"), ("unaligned_v", "wmma"),
    ("odd_head_stride", "wmma"), ("odd_pos_stride", "wmma"),
    ("odd_batch_stride", "wmma"), ("dh192", "wgmma"), ("dh256", "wgmma"),
    ("unaligned_q_dh192", "wmma"), ("unaligned_v_dh256", "wmma")])
def test_flash_route_edges(case, want):
    """The forward's rule: bf16 at every wgmma head dim (192 and 256 on the
    wide-head kernel) with TMA-describable tensors -> wgmma; an unaligned
    base or stride, or head dim 32 -> wmma; fp32 -> fma."""
    dh = next((d for d in (32, 64, 192, 256) if case.endswith(f"dh{d}")),
              128)
    q, k, v = _model_qkv(2, 100, 8, 2, dh)
    if case in _ODD_STRIDES:
        q = torch.as_strided(torch.empty(10 ** 6, device="meta"),
                             (2, 100, 8, dh), (*_ODD_STRIDES[case], 1))
    ptrs = {"unaligned_q": (2, 0, 0), "unaligned_v": (0, 0, 18),
            "unaligned_q_dh192": (2, 0, 0),
            "unaligned_v_dh256": (0, 0, 18)}.get(case, (0, 0, 0))
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    assert _fa_route(q, k, v, dtype, ptrs) == want


# ------------------------------------------------- backward route rules --

_BWD_ALIGNED = (0, 0, 0, 0)  # q, k, v, dO bases


def _bwd_route(q, k, v, do, dtype=torch.bfloat16, ptrs=_BWD_ALIGNED):
    """The backward's route: the forward's rule asked of q, k, v and dO."""
    return fa.route(dtype, q.shape[-1], ptrs,
                    [t.stride()[:3] for t in (q, k, v, do)])


def _fused_qkv(B, S, H, KVH, dh):
    """q, k, v as slices of one fused projection [B, S, H + 2 KVH, dh]."""
    qkv = torch.empty((B, S, H + 2 * KVH, dh), device="meta")
    return qkv.split((H, KVH, KVH), dim=2)


@pytest.mark.parametrize("dtype,dh,layout,want", [
    *[(torch.float32, dh, "model", "fma") for dh in fa.HEAD_DIMS],
    (torch.bfloat16, 64, "model", "wgmma"),
    (torch.bfloat16, 128, "model", "wgmma"),
    (torch.bfloat16, 64, "fused", "wgmma"),
    (torch.bfloat16, 128, "fused", "wgmma"),
    (torch.bfloat16, 32, "model", "wmma"),
    (torch.bfloat16, 192, "model", "wgmma"),
    (torch.bfloat16, 256, "model", "wgmma"),
    (torch.bfloat16, 192, "fused", "wgmma"),
    (torch.bfloat16, 256, "fused", "wgmma"),
    (torch.bfloat16, 256, "unaligned_q", "wmma"),
    (torch.bfloat16, 128, "unaligned_q", "wmma"),
    (torch.bfloat16, 128, "unaligned_do", "wmma"),
    (torch.bfloat16, 64, "unaligned_k", "wmma"),
    (torch.bfloat16, 128, "odd_pos_stride", "wmma"),
    (torch.bfloat16, 128, "odd_do_stride", "wmma"),
    (torch.float32, 128, "unaligned_q", "fma"),
])
def test_flash_bwd_route(dtype, dh, layout, want):
    """fp32 -> fma; bf16 at head dim 64 / 128 / 192 / 256 with
    16-byte-aligned q, k, v, dO bases and strides of 8 elements -> wgmma
    (slices of a fused projection too); every other bf16 (head dim 32, an
    unaligned base or stride) -> wmma."""
    B, S, H, KVH = 2, 100, 8, 2
    if layout == "fused":
        q, k, v = _fused_qkv(B, S, H, KVH, dh)
    else:
        q, k, v = _model_qkv(B, S, H, KVH, dh)
    do = torch.empty((B, S, H, dh), device="meta")
    if layout == "odd_pos_stride":
        q = torch.as_strided(torch.empty(10 ** 6, device="meta"),
                             (B, S, H, dh), (S * (H * dh + 4), H * dh + 4,
                                             dh, 1))
    if layout == "odd_do_stride":
        do = torch.as_strided(torch.empty(10 ** 6, device="meta"),
                              (B, S, H, dh), (S * H * (dh + 2), H * (dh + 2),
                                              dh + 2, 1))
    ptrs = {"unaligned_q": (2, 0, 0, 0), "unaligned_k": (0, 2, 0, 0),
            "unaligned_do": (0, 0, 0, 8)}.get(layout, _BWD_ALIGNED)
    assert _bwd_route(q, k, v, do, dtype, ptrs) == want


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "gemma3_1b",
                                  "deepseek_v32", "olmo_1b", "zamba2_1p2b"])
def test_flash_bwd_route_of_the_models(arch):
    """Each model's bf16 attention in model layout takes wgmma in both
    directions, gemma3's head dim 256 and deepseek_v32's 192 included."""
    cfg = get_config(arch)
    q, k, v = _model_qkv(1, 4096, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
    assert cfg.head_dim in fa.WGMMA_HEAD_DIMS
    assert _bwd_route(q, k, v, q) == "wgmma"
    assert _fa_route(q, k, v) == "wgmma"


@pytest.mark.parametrize("layout", ["model", "fused", "unaligned_q",
                                    "unaligned_do", "odd_pos_stride"])
@pytest.mark.parametrize("dh", [192, 256])
def test_flash_routes_split_at_the_wide_heads(dh, layout):
    """Where the two directions split at head dims 192 and 256: only where
    dO alone is unaligned.  dO does not enter the forward's rule, so the
    forward takes wgmma and the backward wmma.  Everywhere else they agree:
    TMA-describable bf16 runs both on the wide-head wgmma kernels, and a
    base or stride TMA cannot take sends both to wmma."""
    B, S, H, KVH = 1, 300, 8, 2
    if layout == "fused":
        q, k, v = _fused_qkv(B, S, H, KVH, dh)
    else:
        q, k, v = _model_qkv(B, S, H, KVH, dh)
    if layout == "odd_pos_stride":
        q = torch.as_strided(torch.empty(10 ** 6, device="meta"),
                             (B, S, H, dh), (S * (H * dh + 4), H * dh + 4,
                                             dh, 1))
    do = torch.empty((B, S, H, dh), device="meta")
    ptrs = {"unaligned_q": (2, 0, 0, 0),
            "unaligned_do": (0, 0, 0, 8)}.get(layout, _BWD_ALIGNED)
    fwd = "wmma" if layout in ("unaligned_q", "odd_pos_stride") else "wgmma"
    assert _fa_route(q, k, v, ptrs=ptrs[:3]) == fwd
    assert _bwd_route(q, k, v, do, ptrs=ptrs) == (
        "wmma" if layout == "unaligned_do" else fwd)
    assert fa.route(torch.float32, dh, ptrs[:3],
                    [t.stride()[:3] for t in (q, k, v)]) == "fma"


# --------------------------------------------------- backward tile walks --

def _cu_src() -> str:
    return (_build.CSRC / "flash_attention.cu").read_text()


def _cu_const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def wide_bwd_tiles() -> dict:
    """The wide-head backward's tiles by head dim, read back out of
    csrc/flash_attention.cu (namespace wgbw): the dK/dV kernel's keys per
    block, queries per tile and ring depth, the dQ kernel's queries per
    block, keys per tile and ring depth, and the prep kernel's PAD."""
    src = _cu_src()
    out = {}
    for dh, body in re.findall(r"template <> struct Tiles<(\d+)> \{(.*?)\};",
                               src, re.S):
        t = {n: _cu_const(body, n) for n in ("KV_QT", "KV_ST", "Q_KT",
                                             "Q_ST")}
        out[int(dh)] = {"keys": _cu_const(src, "W_KEYS"), "qt": t["KV_QT"],
                        "kv_stages": t["KV_ST"], "qs": _cu_const(src, "W_QS"),
                        "kt": t["Q_KT"], "q_stages": t["Q_ST"],
                        "pad": _cu_const(src, "PAD")}
    return out


def bwd_tiles() -> dict:
    """The backward's (key-side, query-side) tile shapes by (route, head
    dim), read back out of csrc/flash_attention.cu: the dK/dV kernel's
    (keys per block, queries per tile) and the dQ kernel's (queries per
    block, keys per tile).  The fma and wmma kernels use one (BQ, BKV) for
    both; the wgmma kernels their own constants (`wgb`'s at head dims 64 and
    128, `wgbw`'s Tiles at 192 and 256)."""
    src = _cu_src()
    body = src[src.index('extern "C" int flash_attention_bwd_launch('):]
    out = {}
    for dh, dt, dh2, bq, bkv in re.findall(
            r"if \(dh == (\d+)\) return bwd::launch<(\w+), (\d+), (\d+), "
            r"(\d+)>", body):
        assert dh == dh2
        route = "fma" if dt == "float" else "wmma"
        out[(route, int(dh))] = {"dkdv": (int(bkv), int(bq)),
                                 "dq": (int(bq), int(bkv))}
    const = {n: _cu_const(src, n)
             for n in ("KV_KEYS", "KV_QS", "Q_QS", "Q_KEYS")}
    wide = wide_bwd_tiles()
    for dh in fa.WGMMA_HEAD_DIMS:
        if dh in wide:
            t = wide[dh]
            out[("wgmma", dh)] = {"dkdv": (t["keys"], t["qt"]),
                                  "dq": (t["qs"], t["kt"])}
        else:
            out[("wgmma", dh)] = {"dkdv": (const["KV_KEYS"],
                                           const["KV_QS"]),
                                  "dq": (const["Q_QS"], const["Q_KEYS"])}
    return out


def dkdv_walk(S, KEYS, QS, causal, window):
    """Plain mirror of the dK/dV kernels' walk: per key tile k0 (one block
    each), the query tiles q0 it visits, in order."""
    walk = {}
    for k0 in range(0, S, KEYS):
        qt_lo = k0 // QS if causal else 0
        q_end = min(S, k0 + KEYS - 1 + window) if window else S
        walk[k0] = [qt * QS for qt in range(qt_lo, -(-q_end // QS))]
    return walk


def dq_walk(S, QS, KEYS, causal, window):
    """Plain mirror of the dQ kernels' walk: per query tile q0 (one block
    each), the key tiles k0 it visits, in order (the forward's frontier)."""
    walk = {}
    for q0 in range(0, S, QS):
        kv_hi = min(S, q0 + QS) if causal else S
        kv_lo = max(0, q0 - window + 1) if window else 0
        walk[q0] = [t * KEYS for t in range(kv_lo // KEYS,
                                            -(-kv_hi // KEYS))]
    return walk


def _visible(S, causal, window):
    """[q, k] of every pair the forward's mask lets through, by
    enumeration."""
    qpos = np.arange(S)[:, None]
    kpos = np.arange(S)[None, :]
    vis = np.ones((S, S), bool)
    if causal:
        vis &= kpos <= qpos
    if window:
        vis &= kpos > qpos - window
    return vis


def _tile_counts(vis, q_rows, k_rows):
    """Visible pairs per (query tile, key tile) of the given row counts."""
    S = vis.shape[0]
    nq, nk = -(-S // q_rows), -(-S // k_rows)
    pad = np.zeros((nq * q_rows, nk * k_rows), np.int64)
    pad[:S, :S] = vis
    return pad.reshape(nq, q_rows, nk, k_rows).sum(axis=(1, 3))


@pytest.mark.parametrize("window", [None, 16, 512], ids=["nowin", "w16",
                                                          "w512"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S", [100, 192, 1000, 4096])
def test_bwd_walks_cover_every_visible_pair_once(S, causal, window):
    """At every route's tiles (read from the .cu), each walk visits each
    tile pair at most once and every tile pair holding a visible (q, k)
    pair exactly once, so every visible pair is summed once into dK/dV and
    once into dQ.  Where a wgmma consumer skips the mask (its 64 rows against
    the tile: no causal diagonal, no window edge, no ragged end in the
    dQ kernel), every pair it sums is visible."""
    vis = _visible(S, causal, window)
    tiles = bwd_tiles()
    assert {r for r, _ in tiles} == {"fma", "wmma", "wgmma"}
    for (route, dh), t in tiles.items():
        keys, qs = t["dkdv"]
        counts = _tile_counts(vis, qs, keys)
        seen = np.zeros_like(counts)
        for k0, q0s in dkdv_walk(S, keys, qs, causal, window).items():
            for q0 in q0s:
                seen[q0 // qs, k0 // keys] += 1
        assert seen.max() <= 1, (route, dh, "dkdv")
        assert (seen[counts > 0] == 1).all(), (route, dh, "dkdv")
        q_rows, k_rows = t["dq"]
        counts = _tile_counts(vis, q_rows, k_rows)
        seen = np.zeros_like(counts)
        for q0, k0s in dq_walk(S, q_rows, k_rows, causal, window).items():
            for k0 in k0s:
                seen[q0 // q_rows, k0 // k_rows] += 1
        assert seen.max() <= 1, (route, dh, "dq")
        assert (seen[counts > 0] == 1).all(), (route, dh, "dq")
        if route != "wgmma":
            continue
        # the mask-skip tests of the kernels, per 64-row consumer slice
        for k0, q0s in dkdv_walk(S, keys, qs, causal, window).items():
            for kw in range(k0, min(k0 + keys, S), 64):
                for q0 in q0s:
                    diag = causal and kw + 63 > q0
                    wedge = bool(window) and kw <= q0 + qs - 1 - window
                    if not (diag or wedge):
                        assert vis[q0:q0 + qs, kw:kw + 64].all()
        for q0, k0s in dq_walk(S, q_rows, k_rows, causal, window).items():
            for qw in range(q0, min(q0 + q_rows, S), 64):
                for k0 in k0s:
                    edge = k0 + k_rows > S
                    diag = causal and k0 + k_rows - 1 > qw
                    wedge = bool(window) and k0 <= qw + 63 - window
                    if not (edge or diag or wedge):
                        assert vis[qw:qw + 64, k0:k0 + k_rows].all()


def test_bwd_tiles_of_the_cu():
    """The tiles the walks are held at: 64 x 64 on wmma up to head dim 128,
    32 x 32 at 192 and 256 (and every fma head dim), the wgmma kernels'
    128-key (dK, dV) and 192-query (dQ) blocks over 64-row tiles at head
    dims 64 and 128, and at 192 / 256 64-key (dK, dV) blocks over 64-query
    tiles and 128-query (dQ) blocks over 64 / 32-key tiles, every head dim
    of HEAD_DIMS on fma and wmma and of WGMMA_HEAD_DIMS on wgmma."""
    tiles = bwd_tiles()
    for dh in fa.HEAD_DIMS:
        assert tiles[("fma", dh)]["dq"] == (32, 32)
        assert tiles[("wmma", dh)]["dq"] == ((64, 64) if dh <= 128
                                              else (32, 32))
    for dh in (64, 128):
        assert tiles[("wgmma", dh)] == {"dkdv": (128, 64), "dq": (192, 64)}
    assert tiles[("wgmma", 192)] == {"dkdv": (64, 64), "dq": (128, 64)}
    assert tiles[("wgmma", 256)] == {"dkdv": (64, 64), "dq": (128, 32)}
    assert {dh for r, dh in tiles if r == "wgmma"} == set(fa.WGMMA_HEAD_DIMS)


@pytest.mark.parametrize("variant", list(sweep_bwd_tiles.VARIANTS))
def test_tile_sweep_variants_rewrite_the_cu(variant):
    """The tile sweep's copy of the .cu carries its variant's Tiles and
    nothing else of them changed; its "kept" variant is what the .cu ships;
    the exact-byte layout assert goes, the shared-memory cap stays."""
    src = _cu_src()
    tiles = sweep_bwd_tiles.VARIANTS[variant]
    out = sweep_bwd_tiles.with_tiles(src, tiles)
    got = {int(dh): tuple(_cu_const(body, n)
                          for n in sweep_bwd_tiles.FIELDS)
           for dh, body in re.findall(
               r"template <> struct Tiles<(\d+)> \{(.*?)\};", out, re.S)}
    assert got == tiles
    assert '"wide backward layouts"' in src
    assert '"wide backward layouts"' not in out
    assert '"wide backward shared memory"' in out
    kept = sweep_bwd_tiles.with_tiles(src, sweep_bwd_tiles.VARIANTS["kept"])
    assert out.count("\n") == kept.count("\n")
    assert sweep_bwd_tiles.VARIANTS["kept"] == {
        dh: (t["qt"], t["kv_stages"], t["kt"], t["q_stages"])
        for dh, t in wide_bwd_tiles().items()}


def wide_bwd_walk(S, dh, causal, window):
    """Plain mirror of the wide-head backward's walk at head dim `dh` (tiles
    read from the .cu).  Returns (dkdv, dq, rows): dkdv, per 64-key block
    k0, its query tiles in order, each (role, q0, masked) for the two role
    warpgroups ("dv", "dk") -- both run every tile, `masked` whether the
    mask is applied (the causal diagonal, the window edge); dq, per
    128-query block q0, its key tiles, each (qw, k0, live, masked) for the
    two 64-row warpgroup slices qw -- `live` the slice runs the tile's
    products, `masked` it applies the mask (also the ragged end of S); rows,
    the end of every lse2 / D row range a block reads."""
    t = wide_bwd_tiles()[dh]
    keys, qt, qs, kt = t["keys"], t["qt"], t["qs"], t["kt"]
    dkdv, dq, rows = {}, {}, []
    for k0 in range(0, S, keys):
        qt_lo = k0 // qt if causal else 0
        q_end = min(S, k0 + keys - 1 + window) if window else S
        visits = []
        for q0 in range(qt_lo * qt, -(-q_end // qt) * qt, qt):
            masked = bool((causal and k0 + keys - 1 > q0)
                          or (window and k0 <= q0 + qt - 1 - window))
            visits += [("dv", q0, masked), ("dk", q0, masked)]
            rows.append(q0 + qt)  # the stage's bulk copy of lse2, D
        dkdv[k0] = visits
    for q0 in range(0, S, qs):
        kv_hi = min(S, q0 + qs) if causal else S
        kv_lo = max(0, q0 - window + 1) if window else 0
        visits = []
        for k0 in range(kv_lo // kt * kt, -(-kv_hi // kt) * kt, kt):
            for qw in range(q0, q0 + qs, 64):
                live = (qw < S and not (causal and k0 > qw + 63)
                        and not (window and k0 + kt - 1 <= qw - window))
                masked = bool(k0 + kt > S or (causal and k0 + kt - 1 > qw)
                              or (window and k0 <= qw + 63 - window))
                visits.append((qw, k0, live, masked))
        dq[q0] = visits
        rows.append(q0 + qs)  # each thread's two rows, qw + 0..63
    return dkdv, dq, rows


@pytest.mark.parametrize("window", [None, 16, 512], ids=["nowin", "w16",
                                                          "w512"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S", [100, 129, 1000, 2047, 4096])
def test_wide_bwd_walk_sums_every_visible_pair_once(S, causal, window):
    """At head dims 192 and 256 (the wgbw kernels' tiles, read from the
    .cu): per 64-key block, each role warpgroup sums every visible (q, k)
    pair exactly once -- the dV one into dV, the dK one into dK -- and per
    128-query block, each 64-row slice every visible pair of its rows once
    into dQ; a tile summed without the mask holds only visible pairs (rows
    and keys below S); a tile a dQ slice skips holds none of its visible
    pairs; every lse2 / D row a block reads lies below S_pad (S rounded up
    to PAD)."""
    vis = _visible(S, causal, window)
    assert set(wide_bwd_tiles()) == {192, 256}
    for dh, t in wide_bwd_tiles().items():
        assert t["pad"] == fa.BWD_PAD
        s_pad = -(-S // t["pad"]) * t["pad"]
        dkdv, dq, rows = wide_bwd_walk(S, dh, causal, window)
        assert max(rows) <= s_pad, (dh, max(rows), s_pad)
        summed = {"dv": np.zeros((S, S), np.int64),
                  "dk": np.zeros((S, S), np.int64),
                  "dq": np.zeros((S, S), np.int64)}
        for k0, visits in dkdv.items():
            q0s = [q0 for role, q0, _ in visits if role == "dk"]
            assert q0s == sorted(set(q0s))
            assert q0s == [q0 for role, q0, _ in visits if role == "dv"]
            for role, q0, masked in visits:
                block = vis[q0:q0 + t["qt"], k0:k0 + t["keys"]]
                if not masked:
                    assert block.all(), (dh, role, k0, q0)
                summed[role][q0:q0 + t["qt"], k0:k0 + t["keys"]] += block
        for q0, visits in dq.items():
            for qw, k0, live, masked in visits:
                block = vis[qw:qw + 64, k0:k0 + t["kt"]]
                if not live:
                    assert not block.any(), (dh, qw, k0)
                    continue
                if not masked:
                    assert k0 + t["kt"] <= S and block.all(), (dh, qw, k0)
                summed["dq"][qw:qw + 64, k0:k0 + t["kt"]] += block
        for role, got in summed.items():
            np.testing.assert_array_equal(got, vis.astype(np.int64),
                                          err_msg=f"dh {dh} {role}")


# ----------------------------------------- wide-head forward tile walk --

def wide_tiles() -> Tuple[int, int, dict]:
    """flash_wgmma_wide_kernel's (queries per block, keys per tile) and its
    ring depth by head dim, read back out of csrc/flash_attention.cu."""
    src = _cu_src()
    bq = int(re.search(r"constexpr int BQ = (\d+);", src).group(1))
    bkv = int(re.search(r"constexpr int WIDE_BKV = (\d+);", src).group(1))
    a, b = re.search(r"static constexpr int STAGES = DH == 192 \? (\d+) : "
                     r"(\d+);", src).groups()
    return bq, bkv, {192: int(a), 256: int(b)}


def wide_walk(S, BQ, BKV, causal, window):
    """Plain mirror of flash_wgmma_wide_kernel's walk: per query tile q0 (one
    block each), its key tiles k0 in order, each as (qw, k0, live, masked)
    for the block's two 64-row warpgroup slices qw: `live` the warpgroup
    runs the tile's products (some row of it sees some key), `masked` it
    applies the mask (the ragged end of S, the causal diagonal, the window
    edge)."""
    walk = {}
    for q0 in range(0, S, BQ):
        kv_hi = min(S, q0 + BQ) if causal else S
        kv_lo = max(0, q0 - window + 1) if window else 0
        t_lo = kv_lo // BKV
        visits = []
        for t in range(t_lo, -(-kv_hi // BKV)):
            k0 = t * BKV
            for qw in range(q0, q0 + BQ, 64):
                live = (qw < S and not (causal and k0 > qw + 63)
                        and not (window and k0 + BKV - 1 <= qw - window))
                masked = (k0 + BKV > S or (causal and k0 + BKV - 1 > qw)
                          or bool(window and k0 <= qw + 63 - window))
                visits.append((qw, k0, live, masked))
        walk[q0] = visits
    return walk


@pytest.mark.parametrize("window", [None, 16, 512], ids=["nowin", "w16",
                                                          "w512"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S", [100, 192, 1000, 2047, 4096])
def test_wide_forward_walk_covers_every_visible_pair_once(S, causal,
                                                          window):
    """At the wide-head kernel's tiles (read from the .cu: 128 queries, 64
    keys), each 64-row warpgroup slice runs the products of every key tile
    holding a pair it must see exactly once; a tile it skips holds no
    visible pair of its rows; a tile it runs without the mask holds only
    visible pairs; every block visits its key tiles in order, inside the
    frontier, and at least one of its slices is live on each."""
    BQ, BKV, stages = wide_tiles()
    assert (BQ, BKV) == (128, 64) and stages == {192: 3, 256: 2}
    vis = _visible(S, causal, window)
    live_pairs = 0
    seen = set()
    for q0, visits in wide_walk(S, BQ, BKV, causal, window).items():
        k0s = [k0 for _, k0, _, _ in visits[::BQ // 64]]
        assert k0s == sorted(set(k0s)) and all(0 <= k < S for k in k0s)
        for k0 in k0s:
            assert any(live for _, kk, live, _ in visits if kk == k0)
        for qw, k0, live, masked in visits:
            block = vis[qw:qw + 64, k0:k0 + BKV]
            assert (qw, k0) not in seen
            seen.add((qw, k0))
            if not live:
                assert not block.any(), (qw, k0)
                continue
            live_pairs += int(block.sum())
            if not masked:
                assert k0 + BKV <= S and block.all(), (qw, k0)
    assert live_pairs == int(vis.sum())


def _resident_views(L, n_experts, K, N, D):
    """The MoE devices' resident [L, n_e, K, N] stacks under round-robin
    placement: strided views of the model's stack."""
    full = torch.empty((L, n_experts, K, N), device="meta")
    return [full[:, d::D] for d in range(D)]


def test_super_gmm_route_main_path_takes_wgmma():
    cfg = get_config("qwen3_moe_235b_a22b")
    d, f = cfg.d_model, cfg.expert_d_ff
    for K, N in ((d, f), (f, d)):
        for D in (1, 2, 4):
            for w in _resident_views(4, cfg.num_experts, K, N, D):
                assert sg.route(torch.bfloat16, w.shape[1], K, N, (0, 0),
                                (w.stride(0), w.stride(1))) == "wgmma"


@pytest.mark.parametrize("dtype,E,K,N,ptrs,strides,want", [
    (torch.float32, 4, 128, 64, (0, 0), (512, 128), "fma"),
    (torch.bfloat16, 4, 128, 64, (0, 0), (8192, 8192), "wgmma"),
    (torch.bfloat16, 3, 72, 40, (0, 0), (8640, 2880), "wgmma"),
    (torch.bfloat16, 2, 68, 36, (0, 0), (4896, 2448), "wmma"),   # K % 8
    (torch.bfloat16, 2, 100, 200, (0, 0), (40000, 20000), "wmma"),
    (torch.bfloat16, 2, 64, 36, (0, 0), (4608, 2304), "wmma"),   # N % 8
    (torch.bfloat16, 2, 0, 64, (0, 0), (0, 0), "wmma"),          # K = 0
    (torch.bfloat16, 2, 64, 64, (2, 0), (8192, 4096), "wmma"),   # w base
    (torch.bfloat16, 2, 64, 64, (0, 8), (8192, 4096), "wmma"),   # x base
    (torch.bfloat16, 2, 64, 64, (0, 0), (8196, 4096), "wmma"),   # layer
    (torch.bfloat16, 2, 64, 64, (0, 0), (8192, 4100), "wmma"),   # expert
    (torch.bfloat16, sg.MAX_EXPERTS, 64, 64, (0, 0), (2 ** 22, 4096),
     "wgmma"),
    (torch.bfloat16, sg.MAX_EXPERTS + 1, 64, 64, (0, 0), (2 ** 22, 4096),
     "wmma"),
])
def test_super_gmm_route_edges(dtype, E, K, N, ptrs, strides, want):
    assert sg.route(dtype, E, K, N, ptrs, strides) == want


# ------------------------------------------------- per-route launch counts --

def test_count_launch_by_route_and_disagreement_raises():
    """Each launch counts once overall and once under its route; a route
    the wrapper does not have raises and counts nothing."""
    def kern():
        pass
    kern.launches = 0
    kern.launches_by_route = dict.fromkeys(_launch.ROUTES, 0)
    _launch.count_launch(kern, "wgmma")
    _launch.count_launch(kern, "wmma")
    assert kern.launches == 2
    assert kern.launches_by_route == {"fma": 0, "wmma": 1, "wgmma": 1}
    for bad in ("tma", "", "WGMMA"):
        with pytest.raises(KeyError):
            _launch.count_launch(kern, bad)
    assert kern.launches == 2  # a refused count changes nothing
    _launch.reset_launches(kern)
    assert kern.launches == 0 and set(kern.launches_by_route.values()) == {0}


@pytest.mark.parametrize("wrapper", [sg.super_gmm, fa.flash_attention,
                                     fa.flash_attention_bwd],
                         ids=["super_gmm", "flash_attention",
                              "flash_attention_bwd"])
def test_wrappers_carry_route_counts(wrapper):
    assert set(wrapper.launches_by_route) == {"fma", "wmma", "wgmma"}


# ------------------------------------------------------------ build digest --

def test_build_sources_cover_headers():
    names = {p.name for p in _build.sources()}
    assert {"super_gmm.cu", "flash_attention.cu", "dispatch_combine.cu",
            "hopper.cuh"} <= names


@pytest.mark.parametrize("target", ["hopper.cuh", "super_gmm.cu"])
def test_digest_changes_with_any_source_byte(tmp_path, target):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    before = _build._digest(_build.sources(csrc))
    assert before == _build._digest(_build.sources(csrc))  # deterministic
    path = csrc / target
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    assert _build._digest(_build.sources(csrc)) != before


@pytest.mark.parametrize("flags", ["NVCC_FLAGS", "LINK_FLAGS"])
def test_digest_changes_with_build_flags(monkeypatch, flags):
    srcs = _build.sources()
    before = _build._digest(srcs)
    monkeypatch.setattr(_build, flags, [*getattr(_build, flags), "-DX=1"])
    assert _build._digest(srcs) != before


def test_library_name_follows_the_digest(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    path = _build.library_path()
    assert path.parent == tmp_path
    assert _build._digest(_build.sources()) in path.name
    assert _build.ptxas_report() == ""  # nothing built here


def test_tiles_of_the_cu_equal_the_wrappers_and_the_mirrors():
    """One list of tiles: the `.cu`'s instantiations in index order are the
    wrapper's TILES (the default first), the tuning table's candidates and
    the tiles the walk mirror is parametrized over."""
    assert cu_tiles() == list(sg.TILES) == _TILES
    assert sg.DEFAULT_TILE == sg.TILES[0] == (128, 256)
    assert all(bm in (64, 128) and bn % 64 == 0 for bm, bn in sg.TILES)


def test_walk_and_routes_agree_on_tile_constants():
    """For every tile the `.cu` instantiates (read back from it), the mirror
    walks that tile and every combination of the edge counts lands each
    tile in exactly one block."""
    tiles = cu_tiles()
    assert len(tiles) > 1 and tiles == _TILES
    for BM, BN in tiles:
        for counts in itertools.product((0, 1, BM, BM + 1), repeat=2):
            walk, _ = persistent_walk(list(counts), 2, 2 * BM, BN, 3, BM,
                                      BN)
            flat = [t for block in walk for t in block]
            assert len(flat) == len(set(flat))
            assert {(m0, n0) for _, m0, n0 in flat} <= {
                (m, n) for m in range(0, 2 * BM, BM) for n in (0,)}
