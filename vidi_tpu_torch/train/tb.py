"""Tensorboard scalar reporting for the train CLI.

Parity with the reference's `report_to tensorboard` launch flag
(Vidi1.5_9B/scripts/finetune.sh:50-51, consumed by HF Trainer's
TensorBoardCallback): per-step train/loss, train/learning_rate and the
throughput meters land under <output_dir>/runs as standard TB event files.

Uses torch.utils.tensorboard (baked into the image); degrades to a no-op
with a one-line warning when the import is unavailable so headless
environments never fail the run.
"""
from __future__ import annotations

import os
from typing import Dict, Optional


class TBReporter:
    """SummaryWriter wrapper: `report({"loss": ...}, step)` -> train/ scalars."""

    def __init__(self, output_dir: str, enabled: bool = True):
        self._writer = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except Exception as e:  # pragma: no cover - env without torch tb
            print(f"tensorboard reporting disabled ({type(e).__name__}: {e})")
            return
        log_dir = os.path.join(output_dir, "runs")
        os.makedirs(log_dir, exist_ok=True)
        self._writer = SummaryWriter(log_dir=log_dir)

    @property
    def enabled(self) -> bool:
        return self._writer is not None

    def report(self, scalars: Dict[str, Optional[float]], step: int) -> None:
        if self._writer is None:
            return
        for key, val in scalars.items():
            if val is None:
                continue
            self._writer.add_scalar(f"train/{key}", float(val), step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
