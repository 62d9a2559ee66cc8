"""Batch samplers: length-grouped + sequence-parallel replication.

Behavior-identical numpy rebuilds of the reference's samplers
(Vidi1.5_9B/vidi/train/vidi_trainer.py:21-128):

- `length_grouped_indices` — HF transformers' get_length_grouped_indices:
  random megabatches of mega_batch_mult*batch_size, each sorted by length
  descending, with the globally longest sample swapped to the front (so the
  first step surfaces OOM immediately).
- `mm_length_grouped_indices` — the modality-aware variant: positive lengths
  are multimodal samples, negative are language-only; each modality is
  length-grouped separately, megabatches interleaved randomly, the two tail
  megabatches merged last (vidi_trainer.py:48-81).
- `sp_data_indices` — replicates each data-parallel batch across the
  sequence-parallel group: with world = dp*sp ranks reading round-robin, each
  SP rank of a DP group receives the same local batch (vidi_trainer.py:21-45).
  On TPU the same effect usually comes from sharding the batch over the
  "data" axis only (replicated over "seq"); this function exists for
  host-side data loaders that feed per-process shards.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np


def length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    mega_batch_mult: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    rng = rng or np.random.default_rng()
    if mega_batch_mult is None:
        mega_batch_mult = min(len(lengths) // (batch_size * 4), 50)
        if mega_batch_mult == 0:
            mega_batch_mult = 1
    indices = rng.permutation(len(lengths)).tolist()
    megabatch_size = mega_batch_mult * batch_size
    megabatches = [indices[i: i + megabatch_size]
                   for i in range(0, len(lengths), megabatch_size)]
    megabatches = [sorted(m, key=lambda i: lengths[i], reverse=True)
                   for m in megabatches]
    maxes = [lengths[m[0]] for m in megabatches]
    max_idx = int(np.argmax(maxes))
    megabatches[0][0], megabatches[max_idx][0] = (
        megabatches[max_idx][0], megabatches[0][0])
    return [i for m in megabatches for i in m]


def mm_length_grouped_indices(
    lengths: Sequence[int],
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
) -> List[int]:
    rng = rng or np.random.default_rng()
    assert all(l != 0 for l in lengths), "Should not have zero length."

    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        grouped = length_grouped_indices(lengths, batch_size, rng=rng)
    else:
        mm_idx, mm_len = zip(*[(i, l) for i, l in enumerate(lengths) if l > 0])
        lang_idx, lang_len = zip(*[(i, -l) for i, l in enumerate(lengths) if l < 0])

        mult_mm = max(min(len(mm_len) // (batch_size * 4), 50), 1)
        mm_shuffle = [mm_idx[i] for i in
                      length_grouped_indices(mm_len, batch_size, mult_mm, rng)]
        size_mm = mult_mm * batch_size
        mm_mega = [mm_shuffle[i: i + size_mm]
                   for i in range(0, len(mm_shuffle), size_mm)]

        mult_lang = max(min(len(lang_len) // (batch_size * 4), 50), 1)
        lang_shuffle = [lang_idx[i] for i in
                        length_grouped_indices(lang_len, batch_size, mult_lang, rng)]
        size_lang = mult_lang * batch_size
        lang_mega = [lang_shuffle[i: i + size_lang]
                     for i in range(0, len(lang_shuffle), size_lang)]

        additional = mm_mega[-1] + lang_mega[-1]
        megabatches = mm_mega[:-1] + lang_mega[:-1]
        megabatches = [megabatches[i] for i in rng.permutation(len(megabatches))]
        if additional:
            megabatches.append(additional)
        grouped = [i for m in megabatches for i in m]

    batches = [grouped[i: i + batch_size] for i in range(0, len(grouped), batch_size)]
    batches = [batches[i] for i in rng.permutation(len(batches))]
    return [i for b in batches for i in b]


def sp_data_indices(data_idx: Sequence[int], bs_local: int,
                    sp_size: int, dp_size: int) -> List[int]:
    """Per-rank read order with SP replication (vidi_trainer.py:21-45):
    world ranks are laid out [dp0]*sp + [dp1]*sp + ...; every SP rank of a DP
    group reads the same bs_local slice of the global batch."""
    world_size = sp_size * dp_size
    bs_global = world_size * bs_local
    assert bs_global % sp_size == 0
    bs_global //= sp_size

    dp_ranks: List[int] = []
    for dp in range(dp_size):
        dp_ranks.extend([dp] * sp_size)

    out: List[int] = []
    num_batches = math.ceil(len(data_idx) / bs_global)
    for bi in range(num_batches):
        idx_batch = list(data_idx[bi * bs_global: (bi + 1) * bs_global])
        for r in range(world_size):
            out.extend(idx_batch[dp_ranks[r] * bs_local:
                                 (dp_ranks[r] + 1) * bs_local])
    assert len(out) == len(data_idx) * sp_size
    return out


def random_epoch_indices(n: int, bs_local: int, sp_size: int, dp_size: int,
                         seed: int) -> List[int]:
    """SPRandomSampler equivalent (vidi_trainer.py:110-128)."""
    rng = np.random.default_rng(seed)
    return sp_data_indices(rng.permutation(n).tolist(), bs_local, sp_size, dp_size)


def length_grouped_epoch_indices(
    lengths: Sequence[int], bs_local: int, world_size: int, grad_accum: int,
    sp_size: int, dp_size: int, seed: int) -> List[int]:
    """SPLengthGroupedSampler equivalent (vidi_trainer.py:84-108)."""
    rng = np.random.default_rng(seed)
    bs_global = bs_local * world_size * grad_accum // sp_size
    idx = mm_length_grouped_indices(lengths, bs_global, rng)
    return sp_data_indices(idx, bs_local, sp_size, dp_size)
