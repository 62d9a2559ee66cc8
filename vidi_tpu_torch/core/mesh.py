"""Device mesh and axis conventions (port of vidi_tpu/core/mesh.py).

JAX holds every device of a host in one process and lays them out as one
(data, seq, model) array. Here each rank is a process (`torchrun`), and the
mesh is a `torch.distributed.device_mesh` over the launched world, ranks
laid out row-major as `init_device_mesh` does:

- "data"  : data parallelism. Parameters are also sharded over ("data",
  "seq"): ZeRO-3 / FSDP storage (parallel/sharding.py).
- "seq"   : sequence parallelism of the modality streams: each rank of a
  seq group holds a contiguous slice of the image / audio tokens, and the
  cross attention runs as "gspmd" (all-gather of partials), "ring" or
  "ulysses" (parallel/ring_attention.py, parallel/ulysses.py).
- "model" : tensor parallelism of the text decoder: each rank holds its
  heads of q / k / v / o and its FFN columns of gate / up / down
  (parallel/sharding.py `_TP_DIM`, their int8 / int4 forms too), the row
  partials summed over the model group, and in training the column-cut
  products' input gradients summed there; "model" must divide the KV
  heads.

`Mesh` also carries the process group of every subset of axes (the ranks
that differ only along those axes), built once for all ranks in the same
order, since `new_group` is collective. A `Mesh` made from a shape alone
(no process groups) serves the pure spec rules and the one-rank run.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)


class Mesh:
    """The (data, seq, model) layout of the ranks. `shape` maps each axis to
    its size, as a JAX mesh's does; `rank` is this process's global rank."""

    def __init__(self, shape: Dict[str, int], device_mesh=None, rank: int = 0):
        self.shape = {a: int(shape.get(a, 1)) for a in AXES}
        self.size = math.prod(self.shape.values())
        self.device_mesh = device_mesh
        self.rank = rank
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def _live(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """`axes` in mesh order without the axes of size one."""
        return tuple(a for a in AXES if a in axes and self.shape[a] > 1)

    def coord(self, axis: str) -> int:
        """This rank's position along `axis`."""
        stride = math.prod(self.shape[a] for a in AXES[AXES.index(axis) + 1:])
        return self.rank // stride % self.shape[axis]

    def count(self, axes: Sequence[str]) -> int:
        """Ranks in a group spanning `axes`."""
        return math.prod(self.shape[a] for a in self._live(axes))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major position within its group spanning `axes`:
        which slice it holds of a dim sharded over `axes` jointly."""
        idx = 0
        for a in self._live(axes):
            idx = idx * self.shape[a] + self.coord(a)
        return idx

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that differ from this one only
        along `axes`; None when it holds this rank alone."""
        live = self._live(axes)
        if not live:
            return None
        if live not in self._groups:
            raise RuntimeError(f"{self} has no process group over {live} "
                               "(a mesh made from a shape has none)")
        return self._groups[live]

    def _build_groups(self) -> None:
        """Every subset of the live axes gets its groups, in one fixed order
        on every rank (`new_group` is collective)."""
        live = self._live(AXES)
        for n in range(1, len(live) + 1):
            for sub in itertools.combinations(live, n):
                if sub == live:
                    self._groups[sub] = dist.group.WORLD
                elif n == 1:
                    self._groups[sub] = self.device_mesh.get_group(sub[0])
                else:
                    self._groups[sub] = dist.new_subgroups_by_enumeration(
                        _partition(self.shape, sub))[0]


def _partition(shape: Dict[str, int], axes: Tuple[str, ...]):
    """The rank lists of the groups spanning `axes` (row-major ranks)."""
    sizes = [shape[a] for a in AXES]
    coords = list(itertools.product(*map(range, sizes)))
    groups: Dict[tuple, list] = {}
    for rank, c in enumerate(coords):
        key = tuple(x for a, x in zip(AXES, c) if a not in axes)
        groups.setdefault(key, []).append(rank)
    return list(groups.values())


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_from_env(device_type: str = "cuda") -> Optional[torch.device]:
    """torchrun's RANK / WORLD_SIZE / LOCAL_RANK (and MASTER_ADDR /
    MASTER_PORT for the rendezvous) -> this rank's device, with the default
    process group initialised: NCCL for `cuda`, gloo for `cpu`, and the
    card LOCAL_RANK made current. None when the process was not launched
    that way (no WORLD_SIZE). A `cuda` rank without a card raises."""
    if "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda rank was launched but "
                               "torch.cuda.is_available() is False")
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"no process group backend for device type {device_type!r}")
    if not dist.is_initialized():
        dist.init_process_group(_backend(device_type), rank=rank, world_size=world)
    return device


def make_mesh(data: Optional[int] = None, seq: int = 1, model: int = 1,
              device_type: str = "cuda") -> Mesh:
    """A (data, seq, model) mesh over the launched world; `data` defaults to
    whatever is left. Initialises the process group from torchrun's
    environment when it is not yet; a process that was not launched by
    torchrun is a world of one (no process group)."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh was requested but "
                           "torch.cuda.is_available() is False")
    if not dist.is_initialized():
        init_from_env(device_type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        if world % (seq * model):
            raise ValueError(f"{world} ranks do not split into seq {seq} x model {model}")
        data = world // (seq * model)
    if data * seq * model != world:
        raise ValueError(f"mesh {data} x {seq} x {model} does not hold {world} ranks")
    shape = dict(zip(AXES, (data, seq, model)))
    if world == 1:
        return Mesh(shape)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = Mesh(shape, init_device_mesh(device_type, (data, seq, model),
                                        mesh_dim_names=AXES), dist.get_rank())
    mesh._build_groups()
    return mesh


def shutdown(mesh: Mesh) -> None:
    """End this rank's part of a launched world: a barrier (no rank tears
    its groups down while another still uses them), every process group
    destroyed, and `mesh`'s handles to its groups dropped. A gloo group's
    worker threads run until its last handle goes, and they must end while
    the interpreter runs: a worker that drops the last reference to a
    tensor after the interpreter has begun to finalize cannot take the GIL,
    and the process aborts ("terminate called without an active
    exception", from `ProcessGroupGloo::runLoop`)."""
    dist.barrier()
    dist.destroy_process_group()
    mesh._groups.clear()  # the gloo groups' destructors join their workers
    mesh.device_mesh = None


def single_device_mesh() -> Mesh:
    """The (1, 1, 1) mesh of one process: no process group."""
    return Mesh(dict(zip(AXES, (1, 1, 1))))
