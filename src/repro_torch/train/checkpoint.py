"""Fault-tolerant checkpointing: atomic saves, async writer,
manifest-driven auto-resume.

Port of ``repro/train/checkpoint.py`` over dict-of-tensor trees, with the
JAX package's on-disk layout, so a checkpoint written by either package
restores in the other:

    <dir>/step_<N>/shard_<proc>.npz     flattened param+opt leaves
    <dir>/step_<N>/MANIFEST.json        step, leaf count, config hash, done

Leaf keys are the ``"/"``-joined dict keys (``params/layers/attn/wq``,
``opt/step``).  A leaf goes to the host with ``.cpu().numpy()`` when it is
saved (a bf16 leaf as f32, which holds it exactly) and comes back on the
device and in the dtype of the template's leaf.  A checkpoint is valid iff
MANIFEST.json exists and ``done`` is true: it is written last, in a temporary
directory renamed into place, so a crash mid-save never corrupts the restore
path, and ``latest_step`` skips incomplete saves.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .optimizer import tree_paths

__all__ = ["CheckpointManager", "config_hash", "flatten_tree", "unflatten_tree"]


def _host(leaf: Any) -> np.ndarray:
    """A host copy of ``leaf`` that no later write to the tensor reaches
    (``.cpu()`` alone would share a CPU tensor's memory)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def flatten_tree(tree: Any) -> Dict[str, np.ndarray]:
    """Host copies of the leaves, by ``"/"``-joined key."""
    return {key: _host(leaf) for key, leaf in tree_paths(tree)}


def unflatten_tree(template: Any, flat: Dict[str, np.ndarray]) -> Any:
    """``template``'s structure with each leaf read from ``flat``, on the
    template leaf's device, in its dtype and shape."""

    def build(node: Any, prefix: str) -> Any:
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        arr = flat[prefix[:-1]]
        # an array np.load read is ours: take it without a copy
        t = (torch.from_numpy(arr) if isinstance(arr, np.ndarray) and arr.flags.writeable
             and arr.flags.c_contiguous else torch.tensor(np.asarray(arr)))
        return t.to(device=node.device, dtype=node.dtype).reshape(node.shape)

    return build(template, "")


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        config_hash: str = "",
        keep: int = 3,
        async_save: bool = True,
    ) -> None:
        self.dir = directory
        self.config_hash = config_hash
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, block: bool = False) -> None:
        flat = flatten_tree(state)  # the host copy happens here, before returning
        if self.async_save and not block:
            self.wait()  # one in-flight save at a time
            self._thread = threading.Thread(
                target=self._write, args=(step, flat), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, flat)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        t0 = time.perf_counter()  # durations: monotonic, never time.time()
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "shard_0.npz"), **flat)
        manifest = {
            "step": step,
            "n_leaves": len(flat),
            "config_hash": self.config_hash,
            "time": time.time(),  # wall timestamp only, not a duration
            "save_s": round(time.perf_counter() - t0, 6),
            "done": True,
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            mf = os.path.join(self.dir, name, "MANIFEST.json")
            if not os.path.exists(mf):
                continue
            try:
                with open(mf) as f:
                    m = json.load(f)
                if m.get("done"):
                    steps.append(int(m["step"]))
            except (json.JSONDecodeError, KeyError, ValueError):
                continue  # torn manifest -> treat as invalid
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any) -> Any:
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "MANIFEST.json")) as f:
            m = json.load(f)
        if self.config_hash and m.get("config_hash") not in ("", self.config_hash):
            raise ValueError(
                f"checkpoint config hash {m.get('config_hash')!r} != "
                f"current {self.config_hash!r}"
            )
        with np.load(os.path.join(path, "shard_0.npz")) as z:
            flat = dict(z)
        return unflatten_tree(template, flat)

    def restore_latest(self, template: Any) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, template
        return step, self.restore(step, template)


def config_hash(obj: Any) -> str:
    return hashlib.sha1(repr(obj).encode()).hexdigest()[:12]
