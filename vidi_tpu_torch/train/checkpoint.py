"""Training checkpoints with auto-resume (the port's counterpart of
vidi_tpu/train/checkpoint.py).

The semantics are the JAX module's: keep the newest `save_total_limit`
steps, resume from the newest, and fall back to an older step when the
newest is unreadable (a run that died mid-save). The on-disk format is the
port's own, not orbax's (a jax library): one `torch.save` file per step,
`<output_dir>/checkpoints/step_<N>.pt` holding {"step", "params",
"opt_state"}, written to a temporary name and renamed into place.

Under a mesh of several ranks (`parallel.sharding.use_mesh`) `save` is
collective: every sharded leaf and moment is gathered whole, one leaf at a
time, and only rank 0 copies it to its host and writes the tree. `restore`
reads the whole tree (memory-mapped with `mmap`, so the ranks of a host
share its pages); the caller cuts it again (`sharding.shard_params`, `shard_state`).
"""
from __future__ import annotations

import os
import re
from typing import Any, List, Optional, Tuple

import torch

from vidi_tpu_torch.parallel import sharding

_NAME = re.compile(r"step_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, output_dir: str, save_total_limit: int = 2):
        self.dir = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        self.limit = max(save_total_limit, 1)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.dir))
                      if m)

    def save(self, step: int, params: Any, opt_state: Any) -> None:
        mesh = sharding.get_mesh()
        if mesh is not None and mesh.size > 1:
            opt_state = sharding.full_state(opt_state, params)
            params = sharding.full_tree(params)
            if mesh.rank != 0:
                return
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"step": step, "params": params, "opt_state": opt_state}, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.limit]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, map_location=None, mmap: bool = False) -> Tuple[int, Any, Any]:
        """(step, params, opt_state) of the newest readable checkpoint."""
        steps = self.all_steps()[::-1]
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        last_err = None
        for step in steps:
            try:
                state = torch.load(self._path(step), map_location=map_location,
                                   weights_only=True, mmap=mmap)
            except Exception as e:  # noqa: BLE001 -- torn save: try the older one
                last_err = e
                continue
            if step != steps[0]:
                print(f"checkpoint step {steps[0]} unreadable "
                      f"({type(last_err).__name__}); resumed from {step}")
            return state["step"], state["params"], state["opt_state"]
        raise last_err

    def close(self) -> None:
        """Saves are synchronous; nothing is pending."""
