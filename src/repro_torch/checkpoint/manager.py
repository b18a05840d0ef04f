"""Checkpointing: atomic save/restore with retention -- the reference's
`repro.checkpoint.manager.CheckpointManager`, for trees of tensors.

Layout: <dir>/step_<N>/ with one .npy per tree leaf and a manifest.json
(leaf files, shapes, dtypes, metadata).  A bf16 leaf is stored losslessly
as its 16-bit pattern (int16) with "bfloat16" as its dtype in the manifest.
Writes go to a temporary directory that is fsync'd and then atomically
renamed: a killed writer never corrupts the latest checkpoint.

`restore(like)` places each leaf on the device and in the dtype of the
matching leaf of `like`; `restore(like, mesh=, specs=)` places it sharded
onto `mesh` as a DTensor, which may be another mesh than the writer's (the
elastic restart).  A tree of DTensors is saved whole: every rank of their
mesh calls `save` (the gather is a collective) and global rank 0 writes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_paths, unflatten

_BF16 = "bfloat16"


def _leaf_name(path: tuple) -> str:
    return "_".join(str(p) for p in path) or "leaf"


def _to_numpy(t: torch.Tensor):
    """(array, dtype name): bf16 as its bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), _BF16
    return t.numpy(), str(t.numpy().dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))  # a copy, 0-d arrays kept 0-d
    return t.view(torch.bfloat16) if dtype == _BF16 else t


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None):
        final = self._step_dir(step)
        meshes = _meshes(tree)
        if meshes:
            from repro_torch.launch.sharding import full_tree
            tree = full_tree(tree)
            if any(meshes[0].get_coordinate()):  # the origin rank writes
                _barrier(meshes)
                return final
        try:
            return self._write(step, tree, metadata, final)
        finally:
            if meshes:
                _barrier(meshes)

    def _write(self, step: int, tree: Any, metadata: Optional[dict],
               final: str):
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_ckpt_")
        try:
            names, shapes, dtypes = [], [], []
            for i, (path, leaf) in enumerate(leaves_with_paths(tree)):
                arr, dtype = _to_numpy(leaf)
                fname = f"{i:05d}_{_leaf_name(path)[:80]}.npy"
                np.save(os.path.join(tmp, fname), arr)
                names.append(fname)
                shapes.append(list(leaf.shape))
                dtypes.append(dtype)
            manifest = {"step": step, "time": time.time(), "leaves": names,
                        "shapes": shapes, "dtypes": dtypes,
                        "metadata": metadata or {}}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, d, "manifest.json")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    def restore(self, like: Any, step: Optional[int] = None, mesh=None,
                specs=None) -> Any:
        """A tree of `like`'s structure read from `step` (the latest by
        default), each leaf on the device and in the dtype of `like`'s leaf
        (and placed as it, where it is a DTensor); with `mesh` and `specs`
        (a spec tree of `like`'s structure), each leaf a DTensor sharded
        onto `mesh`.  Raises where the leaf count or
        a shape does not match."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        manifest = self._manifest(step)
        protos = leaves(like)
        if len(protos) != len(manifest["leaves"]):
            raise ValueError(f"leaf count mismatch: {len(protos)} vs "
                             f"{len(manifest['leaves'])}")
        out = []
        for fname, dtype, proto in zip(manifest["leaves"],
                                       manifest["dtypes"], protos):
            arr = np.load(os.path.join(self._step_dir(step), fname))
            if tuple(arr.shape) != tuple(proto.shape):
                raise ValueError(f"shape mismatch for {fname}: "
                                 f"{tuple(arr.shape)} vs "
                                 f"{tuple(proto.shape)}")
            t = _from_numpy(arr, dtype).to(device=proto.device,
                                           dtype=proto.dtype)
            out.append(_placed_like(t, proto) if mesh is None else t)
        tree = unflatten(like, out)
        if mesh is not None and specs is not None:
            from repro_torch.launch.sharding import distribute_tree
            tree = distribute_tree(tree, mesh, specs)
        return tree

    def metadata(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        return self._manifest(step)["metadata"]


def _meshes(tree) -> list:
    """The distinct meshes of a tree's DTensor leaves."""
    from torch.distributed.tensor import DTensor
    out = []
    for t in leaves(tree):
        if isinstance(t, DTensor) and all(m is not t.device_mesh
                                          for m in out):
            out.append(t.device_mesh)
    return out


def _placed_like(t: torch.Tensor, proto):
    """`t` (whole) placed as the DTensor `proto` is, by local slicing."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if not isinstance(proto, DTensor):
        return t
    return distribute_tensor(t, proto.device_mesh, proto.placements,
                             src_data_rank=None)


def _barrier(meshes):
    """Every rank of the meshes waits until the writer has published: a sum
    over each mesh (a barrier over the mesh's ranks only, so ranks outside
    it, dead ones included, are not waited for)."""
    from repro_torch.launch.mesh import sum_over
    for mesh in meshes:
        sum_over(torch.zeros(1, device=mesh.device_type), mesh)
