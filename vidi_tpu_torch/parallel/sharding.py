"""Parameter sharding and the mesh's collectives (port of
vidi_tpu/parallel/sharding.py).

JAX annotates shardings and lets GSPMD insert the collectives. PyTorch has
no GSPMD, so this module states them:

- the spec rules, ported whole: `_fit_spec`, `fsdp_param_spec`, `_TP_DIM`
  / `_text_layer_spec`, `_param_spec_for_path`. A spec is a tuple with one
  entry a dim: None, an axis name, or a tuple of axes sharded jointly (the
  entries of JAX's PartitionSpec);
- ZeRO-3 storage: `shard_params` keeps on each rank only its slice of
  every leaf along the dim its spec shards; small leaves (< 2**14
  elements) and `pos_embed` stay whole. The port's layers are lists of
  per-layer dicts where JAX stacks them [L, ...]: a per-layer leaf takes
  the spec of its stacked leaf with the L entry dropped (it never shards
  L at the shapes of the supported models; if it did, the leaf stays
  whole);
- tensor parallelism on "model" (Megatron): a text layer's q / k / v /
  gate / up keep their "model" slice of the output features and o / down
  of the input features (`_TP_DIM`), their other matmul dim ZeRO-3-cut
  over ("data", "seq"); `model_cut` marks such a leaf. The layer then runs
  on the rank's heads and FFN columns, and the row partials of o / down
  are summed over the model group (`model_sum`). `model` must divide the
  KV heads (`check_model_cut`): JAX's GSPMD would also cut a head;
- gather at use: `gathered(tree)` rebuilds the ZeRO-3-sharded leaves of a
  tree (one layer's dict inside the layer loops of dattn / siglip /
  whisper, the rest of the model once per loss or generate call), so the
  full model never exists on a rank, as XLA gathers one layer per
  iteration of the JAX scan; a "model" slice stays a slice;
- gradients: the gather's backward reduce-scatters the full gradient onto
  the owning slice over the spec's axes, then sums it over the ranks that
  hold the same slice (`_Gather`); a whole leaf's gradient is summed over
  the world (`sync_grads`). The train step seeds each rank's backward with
  its loss / seq (train/train_step.py), which makes these sums the
  gradient of the global loss.

Mechanism: explicit `all_gather_into_tensor` / `reduce_scatter_tensor`
inside a `torch.autograd.Function`, not DTensor. The parameters are a plain
tree of tensors read by functions, not nn.Modules, and each leaf needs its
gather placed inside the (rematerialised) layer it serves and two reduces
chosen by its spec: a dozen lines of collectives, where DTensor would wrap
every leaf and every op that reads one.

Inference reads the seq-cut caches shard by shard: each rank's (out, lse)
partial over its slice, all-gathered over "seq" and merged in shard order
(`seq_merge`, no autograd).

The 20 `constrain(` sites of vidi_tpu (models/dattn.py, models/decoder.py
and train/train_step.py) and what the port does at each:

| site                          | spec                         | port                                   |
|-------------------------------|------------------------------|----------------------------------------|
| dattn.py:175 frames           | (data,seq),-,-,-,-           | cut: each seq rank encodes its frames  |
| dattn.py:261 video tokens     | data,seq,-                   | cut: the rank's frames' tokens         |
| dattn.py:304 audio windows    | (data,seq),-,-               | cut: each seq rank encodes its windows |
| dattn.py:312 audio encoder    | data,seq,-                   | cut: the rank's windows' positions     |
| dattn.py:372 image tiles      | (data,seq),-,-,-,-           | cut + all-gather of tower features     |
| dattn.py:520-522 q / k / v    | data,-,model,-               | cut: the rank's heads (`model_cut`)    |
| dattn.py:566 stream           | data,seq,-                   | no-op: the stream arrives cut          |
| dattn.py:600 int8 caches      | data,model,seq,-             | cut: rank's heads + slice, `seq_merge` |
| dattn.py:608-609 caches       | data,model,seq,-             | cut: rank's heads + slice, `seq_merge` |
| dattn.py:645-646 stream k / v | data,seq,model,-             | cut: the rank's heads of its slice     |
| dattn.py:747 text hidden      | data,-,-                     | no-op: batch rows local                |
| dattn.py:908-909 rope tables  | data,-,-                     | no-op: batch rows local                |
| decoder.py:103-104 gate / up  | data,(-/seq),model           | cut: the rank's columns, `model_sum`   |
| train_step.py:68 input ids    | data,-                       | no-op: the rank reads its data rows    |

The batch is cut on "data" before the step: every rank decodes only its
data rows of the global batch, the seq ranks of a data group the same ones
(train/train.py; `data_rows` cuts a batch, or draws, built whole). The
backward of the "model" cut is ROADMAP Q1.16c: `_Gather`'s gradient sums
and `sync_grads` assume no leaf is cut on "model", and the train step
refuses such a mesh.
"""
from __future__ import annotations

import math
import types
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from vidi_tpu_torch.core.mesh import AXES, MODEL_AXIS as MODEL, Mesh
from vidi_tpu_torch.core.tree import leaves

# one mesh a process, not a thread-local as in JAX: the backward (and
# remat's recompute in it) runs on autograd's device threads, and the
# prefetch thread cuts the batch rows
_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]):
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


class use_mesh:
    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __enter__(self):
        self.prev = get_mesh()
        set_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_mesh(self.prev)


def _fit_spec(dim: int, s, mesh: Mesh):
    """Largest prefix of the axis group that divides `dim` (None if none):
    axes of size one are skipped, and an axis is kept while the product of
    the kept sizes still divides `dim`."""
    axes = s if isinstance(s, tuple) else (s,)
    keep = []
    n = 1
    for a in axes:
        sz = mesh.shape.get(a, 1)
        if sz > 1 and dim % (n * sz) == 0:
            keep.append(a)
            n *= sz
    if not keep:
        return None
    return tuple(keep) if len(keep) > 1 else keep[0]


# ---------------------------------------------------------------------------
# Parameter (FSDP) specs
# ---------------------------------------------------------------------------

def fsdp_param_spec(shape, mesh: Mesh, min_size: int = 2**14) -> tuple:
    """Shard the largest dim divisible by the full mesh size; small tensors
    stay replicated (gather traffic would exceed the memory win)."""
    n = mesh.size
    if n == 1 or math.prod(shape) < min_size:
        return ()
    # the largest divisible dim (ties -> the later dim, for matmul layouts)
    best, best_dim = -1, None
    for i, s in enumerate(shape):
        if s % n == 0 and s >= best:
            best, best_dim = s, i
    if best_dim is None:
        return ()
    spec = [None] * len(shape)
    spec[best_dim] = AXES  # over ("data", "seq", "model") jointly
    return tuple(spec)


# Megatron-style TP dims of the [L, in, out]-stacked text-decoder weights:
# q/k/v/gate/up shard their output features (heads / FFN hidden) on "model";
# o/down shard their contraction dim. The other matmul dim is ZeRO-3-sharded
# over ("data", "seq").
_TP_DIM = {"q_w": 2, "k_w": 2, "v_w": 2, "gate_w": 2, "up_w": 2,
           "o_w": 1, "down_w": 1}


def _text_layer_spec(name: str, shape, mesh: Mesh, min_size: int = 2**14) -> tuple:
    tp_dim = _TP_DIM[name]
    if len(shape) != 3 or math.prod(shape) < min_size:
        return fsdp_param_spec(shape, mesh, min_size)
    n_model = mesh.shape.get("model", 1)
    spec = [None, None, None]
    model_used = n_model > 1 and shape[tp_dim] % n_model == 0
    if model_used:
        spec[tp_dim] = "model"
    fsdp_axes = ("data", "seq") if model_used else ("data", "seq", "model")
    other = 3 - tp_dim  # the non-L, non-TP matmul dim
    spec[other] = _fit_spec(shape[other], fsdp_axes, mesh)
    if spec == [None, None, None]:
        return fsdp_param_spec(shape, mesh, min_size)
    return tuple(spec)


def _param_spec_for_path(path, leaf, mesh: Mesh) -> tuple:
    """TP-aware spec for text-decoder layer weights, largest-dim FSDP
    elsewhere. `path` holds the tree's keys (str names, int list indices);
    `leaf` has the JAX tree's shape (layers stacked [L, ...])."""
    names = [k for k in path if isinstance(k, str)]
    for name in reversed(names):
        # text decoder only: the towers share the q_w / ... names in their
        # own "layers" but never shard activations on "model"
        if name in _TP_DIM and "layers" in names and "text" in names:
            return _text_layer_spec(name, tuple(leaf.shape), mesh)
    if "pos_embed" in names:
        # tower position tables: small, broadcast onto the fanned-out frames
        return ()
    return fsdp_param_spec(tuple(leaf.shape), mesh)


def _stacked_paths(tree, path=(), depth=None):
    """(path, JAX-layout shape, layers count or None) of every leaf: a leaf
    under a `layers` list has the shape [L, *shape] of JAX's stacked leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _stacked_paths(v, path + (k,), depth)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _stacked_paths(v, path + (i,), len(tree))
    else:
        shape = tuple(tree.shape)
        yield path, ((depth,) + shape if depth is not None else shape), depth


class Shard(NamedTuple):
    """How a leaf is stored: its `dim` cut into mesh.count(axes) equal
    slices over `axes`, this rank holding slice mesh.index(axes)."""
    dim: int
    axes: Tuple[str, ...]
    mesh: Mesh


def storage_spec(path, shape, depth, mesh: Mesh) -> Optional[Tuple[int, Tuple[str, ...]]]:
    """(dim, axes) of the port's leaf at `path`, or None (kept whole): the
    JAX spec of its stacked shape, with the L entry dropped for a per-layer
    leaf. Axes of size one are dropped (they cut nothing). This is the
    ZeRO-3 cut of `storage_cuts`."""
    return storage_cuts(path, shape, depth, mesh)[0]


def param_specs(params, mesh: Mesh) -> Dict[str, Optional[Tuple[int, Tuple[str, ...]]]]:
    """'/'-joined leaf key -> `storage_spec` for the port's tree."""
    return {"/".join(map(str, p)): storage_spec(p, shape, depth, mesh)
            for p, shape, depth in _stacked_paths(params)}


def _tp_leaf(path) -> bool:
    """Whether `path` names a text-decoder layer weight of `_TP_DIM`."""
    names = [k for k in path if isinstance(k, str)]
    return bool(names) and names[-1] in _TP_DIM and "layers" in names and "text" in names


def storage_cuts(path, shape, depth, mesh: Mesh) -> Tuple[Optional[Tuple[int, Tuple[str, ...]]],
                                                          Optional[int]]:
    """(ZeRO-3 cut, "model" cut) of the port's leaf at `path` (`shape` the
    JAX stacked shape): the first as `storage_spec`'s (dim, axes), the axes
    gathered at use, or None; the second the dim a text layer weight keeps
    cut on "model" (its TP dim), or None. Under model > 1 every `_TP_DIM`
    leaf is cut on "model", the small ones too, where JAX's spec keeps
    them whole and GSPMD cuts them at use: a layer's q / k / v / o and
    gate / up / down then always hold the same heads and columns."""
    spec = _param_spec_for_path(path, types.SimpleNamespace(shape=shape), mesh)
    tp = mesh.shape[MODEL] > 1 and _tp_leaf(path)
    model = None
    if tp:
        dim = _TP_DIM[[k for k in path if isinstance(k, str)][-1]]
        if shape[dim] % mesh.shape[MODEL]:
            raise ValueError(f"{'/'.join(map(str, path))}: dim {dim} of {tuple(shape)} "
                             f"does not split over model = {mesh.shape[MODEL]}")
        model = dim - (depth is not None)
        spec = tuple(None if s == MODEL else s for s in spec)
    if depth is not None:
        if spec and spec[0] is not None:
            return None, model
        spec = spec[1:]
    zero = None
    for d, s in enumerate(spec):
        if s is None:
            continue
        axes = tuple(a for a in (s if isinstance(s, tuple) else (s,)) if mesh.shape[a] > 1)
        if axes:
            zero = (d, axes)
            break
    return zero, model


def check_model_cut(mesh: Mesh, num_kv_heads: Optional[int]) -> None:
    """Raise ValueError unless the mesh's "model" size divides the KV heads
    (each rank takes whole KV heads, and the GQA query heads that read
    them; JAX's GSPMD would cut a head of the tiny config's k_w at model
    4, ROADMAP Q3.3)."""
    m = mesh.shape[MODEL]
    if m > 1 and (num_kv_heads is None or num_kv_heads % m):
        raise ValueError(f"model = {m} must divide the text decoder's KV heads "
                         f"({num_kv_heads})")


# ---------------------------------------------------------------------------
# ZeRO-3 storage and the gather at use
# ---------------------------------------------------------------------------

class ModelCut(NamedTuple):
    """A text layer weight's tensor-parallel cut: its `dim` cut into
    mesh.shape["model"] slices, this rank holding slice coord("model")."""
    dim: int
    mesh: Mesh


def shard_of(t: torch.Tensor) -> Optional[Shard]:
    return getattr(t, "_vidi_shard", None)


def model_cut(t) -> Optional[ModelCut]:
    """The "model" cut of a leaf (kept by `gather`), or None."""
    return getattr(t, "_vidi_model", None)


def _mark(t: torch.Tensor, shard: Optional[Shard],
          model: Optional[ModelCut] = None) -> torch.Tensor:
    if shard is not None:
        t._vidi_shard = shard
    if model is not None:
        t._vidi_model = model
    return t


def detached(t: torch.Tensor) -> torch.Tensor:
    """t.detach(), still known as the shard it is."""
    return _mark(t.detach(), shard_of(t), model_cut(t))


def _local_slice(t: torch.Tensor, dim: int, axes, mesh: Mesh) -> torch.Tensor:
    n, i = mesh.count(axes), mesh.index(axes)
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


def _map_tree(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _cut_leaf(t: torch.Tensor, cuts, mesh: Mesh, device) -> torch.Tensor:
    """This rank's slice of a whole leaf under `cuts` (`storage_cuts`): a
    contiguous copy on `device`, marked; a leaf kept whole moved there."""
    zero, mdim = cuts
    if zero is None and mdim is None:
        return t.to(device)
    local = t
    if zero is not None:
        local = _local_slice(local, zero[0], zero[1], mesh)
    if mdim is not None:
        local = _local_slice(local, mdim, (MODEL,), mesh)
    return _mark(local.to(device, copy=True).contiguous(),
                 None if zero is None else Shard(zero[0], zero[1], mesh),
                 None if mdim is None else ModelCut(mdim, mesh))


def _is_cut(t: torch.Tensor) -> bool:
    return shard_of(t) is not None or model_cut(t) is not None


def shard_params(params, mesh: Mesh, device=None, kv_heads: Optional[int] = None):
    """A new tree holding this rank's slice of every sharded leaf (a
    contiguous copy on `device`, default the leaf's own, marked with its
    `Shard` and `ModelCut`) and the whole leaves as they are (moved to
    `device`). Leaves already cut (`layer_sharder`) are kept. With
    model > 1, `kv_heads` (the text decoder's) must be a multiple of it
    (`check_model_cut`)."""
    check_model_cut(mesh, kv_heads)
    cuts = {"/".join(map(str, p)): storage_cuts(p, shape, depth, mesh)
            for p, shape, depth in _stacked_paths(params)}

    def one(path, t):
        if _is_cut(t):
            return t
        dev = t.device if device is None else device
        return _cut_leaf(t, cuts["/".join(map(str, path))], mesh, dev)

    return _map_tree(one, params)


def layer_sharder(module: str, n_layers: int, mesh: Mesh, device=None):
    """fn(layer dict) -> the layer with every leaf cut as `shard_params`
    cuts layer i of params[module]["layers"] (n_layers long): the loaders
    cut each layer as it is drawn or read, so the whole model never lies
    on one rank."""
    def fn(lp):
        out = {}
        for name, t in lp.items():
            if isinstance(t, dict):
                raise NotImplementedError(
                    "quantized weights under a mesh of several ranks are ROADMAP Q1.16c")
            path = (module, "layers", 0, name)
            cuts = storage_cuts(path, (n_layers, *t.shape), n_layers, mesh)
            out[name] = _cut_leaf(t, cuts, mesh, t.device if device is None else device)
        return out

    return fn


def _stack(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """[.., n*c, ..] -> [n, .., c, ..]: the n slices along `dim`, stacked."""
    return torch.stack(x.chunk(n, dim=dim)).contiguous()


def _unstack(buf: torch.Tensor, dim: int) -> torch.Tensor:
    """The inverse of `_stack`: [n, .., c, ..] -> [.., n*c, ..]."""
    n = buf.shape[0]
    shape = list(buf.shape[1:])
    shape[dim] *= n
    return buf.movedim(0, dim).reshape(shape)


def all_gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The `n` ranks' `x` concatenated along `dim` in group order."""
    # the concatenated form along dim 0, which every backend takes
    buf = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(buf, x.contiguous(), group=group)
    return _unstack(buf.view(n, *x.shape), dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Sum of the `n` ranks' `x`, of which this rank keeps its slice along
    `dim` (the adjoint of `all_gather_dim`)."""
    shape = list(x.shape)
    shape[dim] //= n
    out = x.new_empty(shape)
    dist.reduce_scatter_tensor(out, _stack(x, dim, n).flatten(0, 1), group=group)
    return out


class _Gather(torch.autograd.Function):
    """Forward: the slices of `group` along `dim` -> the full tensor.
    Backward: the full gradient summed over `group` and cut back to this
    rank's slice (reduce-scatter, in fp32), then summed over the ranks
    that hold the same slice (`replicas`)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, replicas):
        ctx.dim, ctx.group, ctx.n, ctx.replicas = dim, group, n, replicas
        return all_gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        out = reduce_scatter_dim(g.float(), ctx.dim, ctx.group, ctx.n)
        if ctx.replicas is not None:
            dist.all_reduce(out, group=ctx.replicas)
        return out.to(g.dtype), None, None, None, None


def all_gather_grad(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """`all_gather_dim` whose backward reduce-scatters the gradient: the
    adjoint of a tensor that every rank of `group` goes on to use whole."""
    return _Gather.apply(x, dim, group, n, None)


def gather(t: torch.Tensor, shard: Optional[Shard] = None) -> torch.Tensor:
    """The leaf rebuilt along its ZeRO-3 cut (differentiable, see
    `_Gather`): the full leaf, or its "model" slice (still marked) for a
    leaf cut on "model"; a leaf with no ZeRO-3 cut as it is. `shard`
    stands in for t's own mark."""
    shard = shard or shard_of(t)
    if shard is None:
        return t
    mesh = shard.mesh
    rest = [a for a in AXES if a not in shard.axes]
    out = _Gather.apply(t, shard.dim, mesh.group(shard.axes), mesh.count(shard.axes),
                        mesh.group(rest))
    return _mark(out, None, model_cut(t))


def whole(t: torch.Tensor, shard: Optional[Shard] = None) -> torch.Tensor:
    """The whole leaf, on every rank: `gather`, then the "model" slices
    all-gathered (no gradient). Collective over the leaf's groups. `shard`
    stands in for t's own mark."""
    cut = model_cut(t)
    t = gather(t, shard)
    if cut is None:
        return t
    with torch.no_grad():
        return all_gather_dim(t, cut.dim, cut.mesh.group((MODEL,)), cut.mesh.shape[MODEL])


def gathered(tree, skip_layers: bool = False):
    """`tree` with every sharded leaf gathered (`gather`), or `tree` itself
    when none is (at once, without a walk, when no mesh of several ranks is
    active); with `skip_layers` the per-layer lists stay as they are (their
    loops gather one layer at a time)."""
    if _MESH is None or _MESH.size == 1:
        return tree
    return _gathered(tree, skip_layers)


def _gathered(tree, skip_layers: bool):
    if isinstance(tree, dict):
        out = {k: (v if skip_layers and k == "layers" and isinstance(v, list)
                   else _gathered(v, skip_layers)) for k, v in tree.items()}
        same = all(out[k] is v for k, v in tree.items())
    elif isinstance(tree, list):
        out = [_gathered(v, skip_layers) for v in tree]
        same = all(a is b for a, b in zip(out, tree))
    else:
        return gather(tree)
    return tree if same else out  # nothing sharded: the same object (caches key on it)


def is_root() -> bool:
    return _MESH is None or _MESH.rank == 0


def _to_root(t: torch.Tensor, root: bool,
             shard: Optional[Shard] = None) -> Optional[torch.Tensor]:
    """The whole leaf on rank 0's host (`root`), None on the others. Only
    the ranks whose gather group holds rank 0 gather (they differ from it
    only along the shard's axes), and only rank 0 keeps what they gather."""
    shard = shard or shard_of(t)
    cut = model_cut(t)
    if shard is not None or cut is not None:
        mesh = (shard or cut).mesh
        held = (shard.axes if shard is not None else ()) + ((MODEL,) if cut else ())
        if any(mesh.coord(a) for a in AXES if a not in held):
            return None
        t = whole(t, shard)
    return t.cpu() if root else None


def full_tree(tree):
    """Every leaf whole on rank 0's host, gathered leaf by leaf (no
    gradient), and None leaves on the other ranks: what a checkpoint
    stores. Collective: every rank calls it."""
    with torch.no_grad():
        root = is_root()
        return _map_tree(lambda _, t: _to_root(t, root), tree)


def _key_shards(params) -> Dict[str, Optional[Shard]]:
    return {key: shard_of(p) for key, _, p in leaves(params)}


def _map_state(fn, state, keys):
    """Apply fn(key, tensor) to the tensors of every dict in `state` whose
    keys are parameter keys (AdamW's mu / nu, MultiSteps' acc)."""
    if isinstance(state, dict):
        if state and all(k in keys for k in state):
            return {k: fn(k, v) for k, v in state.items()}
        return {k: _map_state(fn, v, keys) for k, v in state.items()}
    return state


def full_state(state, params):
    """An optimizer state with every moment whole on rank 0's host, each
    gathered as its parameter is sharded (None on the other ranks).
    Collective."""
    shards = _key_shards(params)
    with torch.no_grad():
        root = is_root()
        return _map_state(lambda key, t: _to_root(t, root, shards[key]), state, shards)


def shard_state(state, params):
    """A whole optimizer state (from a checkpoint) cut as `params` are,
    onto their device."""
    shards = _key_shards(params)
    dev = next(leaves(params))[2].device

    def one(key, t):
        s = shards[key]
        if s is None:
            return t.to(dev)
        return _local_slice(t, s.dim, s.axes, s.mesh).to(dev, copy=True).contiguous()

    return _map_state(one, state, shards)


# ---------------------------------------------------------------------------
# Gradients and reductions of the train step
# ---------------------------------------------------------------------------

def replicas(t: torch.Tensor, mesh: Mesh) -> int:
    """Ranks that hold the same values of `t` (the whole world for a leaf
    kept whole)."""
    shard = shard_of(t)
    return mesh.size // (mesh.count(shard.axes) if shard is not None else 1)


def sync_grads(pairs, mesh: Optional[Mesh]) -> None:
    """Sum over the world, in place, the gradients of the leaves kept whole
    ((param, grad) pairs; a sharded leaf's gradient was reduced by its
    gather's backward), flattened into one fp32 all-reduce."""
    if mesh is None or mesh.size == 1:
        return
    whole = [g for p, g in pairs if shard_of(p) is None]
    if not whole:
        return
    flat = torch.cat([g.float().reshape(-1) for g in whole])
    dist.all_reduce(flat)
    start = 0
    for g in whole:
        g.copy_(flat[start:start + g.numel()].view_as(g))
        start += g.numel()


def sq_norm(pairs, mesh: Optional[Mesh]) -> torch.Tensor:
    """Squared global norm of the gradients ((param, grad) pairs), each
    element counted once over the ranks that hold it."""
    total = sum(g.float().square().sum() / (replicas(p, mesh) if mesh else 1)
                for p, g in pairs)
    if mesh is not None and mesh.size > 1:
        total = total.clone()
        dist.all_reduce(total)
    return total


def axis_sum(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """x summed over the active mesh's group spanning `axes` (no gradient);
    x itself without one."""
    mesh = get_mesh()
    group = None if mesh is None else mesh.group(axes)
    if group is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def model_sum(x: torch.Tensor, w) -> torch.Tensor:
    """x, this rank's row partial of a product with `w` (o or down), summed
    over the model group when `w` is cut on "model": the partials
    all-gathered and added in rank order in fp32, so that every rank of
    the group holds the same bits (no gradient). x itself otherwise (model
    1, or weights kept whole)."""
    mesh = _MESH
    if mesh is None or mesh.shape[MODEL] == 1 or model_cut(w) is None:
        return x
    with torch.no_grad():
        parts = all_gather_dim(x[None], 0, mesh.group((MODEL,)), mesh.shape[MODEL])
        out = parts[0].float()
        for p in parts[1:]:
            out = out + p.float()
        return out.to(x.dtype)


def seq_merge(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """(out [B,T,H,D], lse [B,T,H] fp32, -inf for a row with no visible
    key) of this rank's slice of a seq-cut cache -> the attention over the
    whole cache: the seq group's partials all-gathered and merged in shard
    order (`ring_attention.merge_gathered`), the same bits on every rank
    (no gradient). out itself without a seq group."""
    mesh = _MESH
    if mesh is None or mesh.shape["seq"] == 1:
        return out
    from vidi_tpu_torch.parallel.ring_attention import merge_gathered
    return merge_gathered(out, lse, mesh.group(("seq",)), mesh.shape["seq"])


def all_ranks(flag: torch.Tensor) -> bool:
    """A bool tensor `flag` AND-ed over every rank of the active mesh: a
    decode loop runs until every data group is done, because each layer's
    ZeRO-3 gather spans the data axis. bool(flag) without a mesh."""
    mesh = _MESH
    if mesh is None or mesh.size == 1:
        return bool(flag)
    pending = (~flag).to(torch.int32).reshape(1)
    dist.all_reduce(pending)
    return int(pending) == 0


def seq_any(x: torch.Tensor) -> torch.Tensor:
    """A bool tensor OR-ed over the seq group (a sample has the modality if
    any rank's slice holds some of it)."""
    return axis_sum(x.to(torch.int32), ("seq",)) > 0


def seq_cut(n: int) -> Tuple[int, int]:
    """(first, length) of this seq rank's contiguous piece of `n` items cut
    into equal pieces of ceil(n / seq); the last ones may be short (padded).
    (0, n) without a mesh."""
    mesh = get_mesh()
    if mesh is None:
        return 0, n
    size = -(-n // mesh.shape["seq"])
    return mesh.coord("seq") * size, size


def take_padded(x: torch.Tensor, dim: int, first: int, size: int) -> torch.Tensor:
    """x[first:first + size] along `dim`, zero-padded where it runs past
    the end (the padding of an uneven cut)."""
    have = max(0, min(size, x.shape[dim] - first))
    piece = x.narrow(dim, min(first, x.shape[dim]), have)
    if have == size:
        return piece
    pad = list(x.shape)
    pad[dim] = size - have
    return torch.cat([piece, x.new_zeros(pad)], dim=dim)


def data_rows(batch: Dict, batch_rows: int, min_ndim: int = 1) -> Dict:
    """This rank's rows of a global batch (a flat dict of tensors or arrays):
    the entries of at least `min_ndim` dims whose first dim is `batch_rows`,
    cut into equal pieces over "data" (every seq rank of a data group takes
    the same rows: row-block i of the global batch on data rank i). Noise
    draws shared by all rows are 1-D: `min_ndim` 2 keeps them whole."""
    mesh = get_mesh()
    if mesh is None or mesh.shape["data"] == 1:
        return batch
    n, i = mesh.shape["data"], mesh.coord("data")
    if batch_rows % n:
        raise ValueError(f"a global batch of {batch_rows} rows does not split over "
                         f"data = {n}")
    rows = slice(i * batch_rows // n, (i + 1) * batch_rows // n)
    return {k: (x[rows] if x.ndim >= min_ndim and x.shape[0] == batch_rows else x)
            for k, x in batch.items()}


def fan_out(fn, x: torch.Tensor) -> torch.Tensor:
    """fn over this seq rank's piece of x's leading dim, the pieces
    all-gathered back in order (differentiable): a tower's frames fanned
    out over the seq group. fn(x) without a seq group."""
    mesh = get_mesh()
    if mesh is None or mesh.shape["seq"] == 1:
        return fn(x)
    n = x.shape[0]
    first, size = seq_cut(n)
    out = fn(take_padded(x, 0, first, size))
    return all_gather_grad(out, 0, mesh.group(("seq",)), mesh.shape["seq"])[:n]
