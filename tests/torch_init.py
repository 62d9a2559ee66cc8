"""Weights that both packages' tests share: the port's init
(`vidi_tpu_torch.models.dattn.init_params`, torch) stacked into
vidi_tpu's layout (layers [L, ...]). It takes a fraction of a second where
vidi_tpu's init, drawn op by op, compiles each draw (seconds a model).
Both packages then run on the same weights, as with vidi_tpu's init.

Importing it also sets torch to one intra-op thread (below)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from vidi_tpu_torch.models import dattn

# One intra-op thread for torch in the test processes. The whole suite runs
# as six pytest-xdist workers on an eight-core host, and each worker's torch
# would start a pool of one thread a core: at these tests' tiny shapes its
# parallel regions then mostly wait on threads that another worker has
# descheduled (the suite took 1273 s with the pools, 598 s without). Every
# worker imports this module while it collects the port's test files, so
# the setting holds for the whole run; the spawned ranks run with
# OMP_NUM_THREADS=1 already.
torch.set_num_threads(1)


def stacked(tree):
    """The port's tree in vidi_tpu's layout, numpy leaves (copies: a jnp
    array made from one may alias it, and a port step may update its
    tensor in place while JAX still reads it)."""
    if isinstance(tree, dict):
        return {k: (jax.tree.map(lambda *xs: np.stack(xs), *map(stacked, v))
                    if k == "layers" and isinstance(v, list) else stacked(v))
                for k, v in tree.items()}
    return tree.detach().numpy().copy()


def port_init(cfg, seed: int = 0):
    """vidi_tpu-layout fp32 parameters (jnp arrays) of `cfg` (either
    package's DattnConfig) from the port's init with `seed`."""
    return jax.tree.map(jnp.asarray, stacked(dattn.init_params(cfg, torch.float32, "cpu", seed)))
