"""Asynchronous, atomic checkpointing in the reference's on-disk layout.

The counterpart of ``src/repro/checkpoint/ckpt.py``. Layout:
    <dir>/step_<k>.tmp/...      (in-flight)
    <dir>/step_<k>/leaf_<i>.npy (one file per tree leaf)
    <dir>/step_<k>/manifest.json  (leaf names, shapes, dtypes, step)
    <dir>/LATEST                  (atomic pointer, written last)
bfloat16 leaves are stored as their uint16 bit patterns, as the reference
stores them.

Fault-tolerance contract:
  * a crash mid-save never corrupts the previous checkpoint (tmp dir + rename
    + LATEST pointer written last);
  * async mode copies every leaf to host memory before ``save`` returns (a
    consistent cut: the port's optimizer updates its tensors in place) and
    writes in a background thread — training continues immediately;
  * ``keep`` bounds the checkpoints on disk, oldest removed first.

A leaf is a tensor, a numpy array or a Python int (step counters). A
checkpoint holds every leaf's full array, as the reference's does, so it does
not depend on the mesh it was saved from: a sharded state is gathered before
``save`` (``train.step.gathered``; the trainer's rank 0 writes it).
``restore(like, shardings=...)`` restores onto any mesh: each rank keeps its
block of each leaf (``models.sharding.NamedSharding.local``).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T


def _flatten_with_names(tree):
    pairs = T.flatten_with_paths(tree)
    return ["/".join(str(k) for k in path) for path, _ in pairs], [leaf for _, leaf in pairs]


def _to_host(leaf):
    """(numpy array, dtype name) of a leaf, copied off the device and out of
    the training state."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


class Checkpointer:
    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._inflight: Optional[Future] = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: Any, *, asynchronous: bool = False) -> Optional[Future]:
        names, leaves = _flatten_with_names(state)
        # Consistent cut: copy to the host before returning control.
        host = [_to_host(l) for l in leaves]
        if asynchronous:
            self.wait()
            self._inflight = self._pool.submit(self._write, step, names, host)
            return self._inflight
        self._write(step, names, host)
        return None

    def wait(self) -> None:
        if self._inflight is not None:
            self._inflight.result()
            self._inflight = None

    def _write(self, step: int, names, host) -> None:
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": [], "time": time.time()}
        for i, (name, (arr, dtype)) in enumerate(zip(names, host)):
            np.save(tmp / f"leaf_{i}.npy", arr)
            manifest["leaves"].append(
                {"i": i, "name": name, "shape": list(arr.shape), "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        latest_tmp = self.dir / "LATEST.tmp"
        latest_tmp.write_text(str(step))
        os.replace(latest_tmp, self.dir / "LATEST")  # atomic commit point
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        f = self.dir / "LATEST"
        if not f.exists():
            return None
        s = int(f.read_text().strip())
        return s if (self.dir / f"step_{s}").exists() else None

    def restore(self, like: Any, *, step: Optional[int] = None,
                shardings: Any = None) -> tuple[Any, int]:
        """Restore into the structure of ``like`` (full shapes): a tensor leaf
        comes back a tensor on its ``like`` leaf's device (a meta leaf: on the
        CPU), an int leaf an int. ``shardings``, a tree of
        ``models.sharding.NamedSharding`` of ``like``'s structure, restores
        onto a mesh: each leaf comes back as this rank's block."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        names_like, leaves_like = _flatten_with_names(like)
        placed = (T.leaves(shardings) if shardings is not None
                  else [None] * len(leaves_like))
        if len(placed) != len(leaves_like):
            raise ValueError(f"{len(placed)} shardings for {len(leaves_like)} leaves")
        by_name = {l["name"]: l for l in manifest["leaves"]}
        out = []
        for name, leaf, sh in zip(names_like, leaves_like, placed):
            meta = by_name.get(name)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = np.load(d / f"leaf_{meta['i']}.npy", mmap_mode="r")
            is_tensor = isinstance(leaf, torch.Tensor)
            shape = tuple(leaf.shape) if is_tensor else tuple(np.shape(leaf))
            if tuple(arr.shape) != shape:
                raise ValueError(f"{name}: shape {arr.shape} != expected {shape}")
            if sh is not None:
                arr = sh.local(arr)
            arr = np.array(arr)
            if is_tensor:
                if meta["dtype"] == "bfloat16":
                    t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                dev = leaf.device if leaf.device.type != "meta" else torch.device("cpu")
                out.append(t.to(dev))
            elif isinstance(leaf, (int, np.integer)):
                out.append(int(arr))
            else:
                out.append(arr)
        return T.unflatten(like, out), step
