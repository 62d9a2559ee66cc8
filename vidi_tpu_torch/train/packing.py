"""Sample packing — several text conversations per batch row.

The reference ships an (unused-in-main-path) varlen packing patch that feeds
externally-set per-sequence lengths into flash-attention's unpad machinery
(Vidi1.5_9B/vidi/model/lmm/dattn/utils.py:15-38). The TPU-native form keeps
the batch dense and static-shaped: packed rows carry int32 segment ids, text
self-attention is block-diagonal over segments (ops/attention.py
`q_segment_ids`), and RoPE positions restart at every segment.

Only text-only samples are packed (the Dattn modality streams are per-sample;
a packed row would need per-segment video/audio routing, which the reference
never had either). Multimodal samples pass through one-per-row via `collate`;
`PackedBatcher` streams text-only samples into fixed-shape packed batches.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from vidi_tpu_torch.constants import IGNORE_INDEX


def first_fit_pack(lengths: Sequence[int], capacity: int) -> List[List[int]]:
    """First-fit-decreasing bin packing. Returns bins of sample indices.

    Deterministic given the input order; samples longer than `capacity` get a
    bin of their own (they are truncated at collation, same as the unpacked
    path).
    """
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    bins: List[List[int]] = []
    space: List[int] = []
    for i in order:
        n = min(lengths[i], capacity)
        for b, s in enumerate(space):
            if n <= s:
                bins[b].append(i)
                space[b] -= n
                break
        else:
            bins.append([i])
            space.append(capacity - n)
    for b in bins:  # restore dataset order within each bin
        b.sort()
    return bins


def pack_rows(samples: List[Dict], seq_len: int,
              bins: List[List[int]] | None = None) -> Dict[str, np.ndarray]:
    """Pack text-only samples into one dense row per bin.

    Returns arrays shaped [R, seq_len]:
      input_ids, labels (IGNORE at pads AND at every segment start, so the
      shifted loss never predicts across a segment boundary), text_mask,
      positions (restarting per segment), segment_ids (1-based; 0 = padding).
    """
    if bins is None:
        bins = first_fit_pack([len(s["input_ids"]) for s in samples], seq_len)
    r = len(bins)
    out = {
        "input_ids": np.zeros((r, seq_len), np.int32),
        "labels": np.full((r, seq_len), IGNORE_INDEX, np.int32),
        "text_mask": np.zeros((r, seq_len), bool),
        "positions": np.zeros((r, seq_len), np.int32),
        "segment_ids": np.zeros((r, seq_len), np.int32),
    }
    for row, b in enumerate(bins):
        cur = 0
        for seg, i in enumerate(b, start=1):
            ids = samples[i]["input_ids"]
            lab = samples[i]["labels"]
            n = min(len(ids), seq_len - cur)
            if n <= 0:
                break
            sl = slice(cur, cur + n)
            out["input_ids"][row, sl] = ids[:n]
            out["labels"][row, sl] = lab[:n]
            out["labels"][row, cur] = IGNORE_INDEX  # no cross-segment predict
            out["text_mask"][row, sl] = True
            out["positions"][row, sl] = np.arange(n)
            out["segment_ids"][row, sl] = seg
            cur += n
    return out


def pack_batch(samples: List[Dict], cfg, *, seq_len: int | None = None,
               rows_per_batch: int | None = None,
               bins: List[List[int]] | None = None) -> Dict[str, np.ndarray]:
    """Full packed training batch: packed text rows + zero modality dummies.

    The modality arrays keep the text-only dummy shapes from `collate`
    (2 frames / 1 audio window, all zero, counts 0) so a packed batch runs the
    same jitted train_step as an unpacked one.
    """
    seq_len = seq_len or cfg.model_max_length
    packed = pack_rows(samples, seq_len, bins=bins)
    r = packed["input_ids"].shape[0]
    if rows_per_batch is not None:
        if r > rows_per_batch:
            raise ValueError(
                f"{len(samples)} samples packed into {r} rows > "
                f"rows_per_batch={rows_per_batch}; lower the samples count")
        pad = rows_per_batch - r
        if pad:
            packed = {k: np.concatenate(
                [v, np.full((pad, *v.shape[1:]),
                            IGNORE_INDEX if k == "labels" else 0, v.dtype)])
                for k, v in packed.items()}
        r = rows_per_batch
    s = cfg.vision.image_size
    packed.update({
        "images": np.zeros((r, 2, s, s, 3), np.float32),
        "frame_counts": np.zeros((r,), np.int32),
        "mels": np.zeros((r, 1, cfg.audio.num_mel_bins,
                          cfg.audio.nb_max_frames), np.float32),
        "audio_sizes": np.zeros((r,), np.int32),
    })
    return packed


class PackedBatcher:
    """Online packer producing fixed-shape batches of `rows` packed rows.

    Samples stream in (`add`); each is placed first-fit into one of `rows`
    open bins. When a sample fits nowhere, the open bins are flushed into a
    dense batch (same keys/shapes every time -> one jit compilation) and the
    sample seeds the next batch. Only text-only samples may be packed — a
    sample with a modality raises.
    """

    def __init__(self, cfg, rows: int, seq_len: int | None = None):
        self.cfg = cfg
        self.rows = rows
        self.seq_len = seq_len or cfg.model_max_length
        self._bins: List[List[Dict]] = [[] for _ in range(rows)]
        self._space = [self.seq_len] * rows

    def add(self, sample: Dict) -> Dict[str, np.ndarray] | None:
        """Place `sample`; returns a finished batch when one flushes."""
        if sample.get("has_image"):
            raise ValueError("PackedBatcher packs text-only samples; "
                             "route multimodal samples to collate()")
        n = min(len(sample["input_ids"]), self.seq_len)
        for b in range(self.rows):
            if n <= self._space[b]:
                self._bins[b].append(sample)
                self._space[b] -= n
                return None
        out = self.flush()
        self._bins[0].append(sample)
        self._space[0] -= n
        return out

    def flush(self) -> Dict[str, np.ndarray] | None:
        """Emit the current bins as a batch (None if empty)."""
        flat, bins, k = [], [], 0
        for b in self._bins:
            bins.append(list(range(k, k + len(b))))
            flat.extend(b)
            k += len(b)
        self._bins = [[] for _ in range(self.rows)]
        self._space = [self.seq_len] * self.rows
        if not flat:
            return None
        return pack_batch(flat, self.cfg, seq_len=self.seq_len,
                          rows_per_batch=self.rows, bins=bins)
