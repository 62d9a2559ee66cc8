"""Walks over parameter trees (nested dicts, and lists of per-layer dicts)."""
from __future__ import annotations

from typing import Iterator, Tuple

import torch


def leaves(tree, path: Tuple = ()) -> Iterator[Tuple[str, Tuple, torch.Tensor]]:
    """(key, path, tensor) of every leaf of a parameter tree (dicts, and
    lists for per-layer params); key is the path joined by '/'."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield "/".join(map(str, path)), path, tree
