"""Checkpointing: atomic save/restore with retention -- the reference's
`repro.checkpoint.manager.CheckpointManager`, for trees of tensors.

Layout: <dir>/step_<N>/ with one .npy per tree leaf and a manifest.json
(leaf files, shapes, dtypes, metadata).  A bf16 leaf is stored losslessly
as its 16-bit pattern (int16) with "bfloat16" as its dtype in the manifest.
Writes go to a temporary directory that is fsync'd and then atomically
renamed: a killed writer never corrupts the latest checkpoint.

`restore(like)` places each leaf on the device and in the dtype of the
matching leaf of `like`.  The reference's `mesh=`/`specs=` resharding
belongs to the multi-device slice.
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

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """A tree of `like`'s structure read from `step` (the latest by
        default), each leaf on the device and in the dtype of `like`'s leaf.
        Raises where the leaf count or a shape does not match."""
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
            out.append(_from_numpy(arr, dtype).to(device=proto.device,
                                                  dtype=proto.dtype))
        return unflatten(like, out)

    def metadata(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        return self._manifest(step)["metadata"]
