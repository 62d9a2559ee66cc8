"""Logging + observability utilities.

- `build_logger`: named logger writing to stdout and a timed-rotating file,
  with stdout/stderr redirection into the log (behavior of the reference's
  build_logger, Vidi1.5_9B/vidi/utils.py:22-95).
- `StepMeter`: step-time / tokens-per-second meter (the reference has only
  HF loss logging; SURVEY.md §5 calls this gap out for the TPU build).
"""
from __future__ import annotations

import logging
import logging.handlers
import os
import sys
import time
from typing import Optional

_handlers = {}


class StreamToLogger:
    """File-like object that redirects writes to a logger (utils.py:60-88)."""

    def __init__(self, logger: logging.Logger, log_level=logging.INFO):
        self.terminal = sys.stdout
        self.logger = logger
        self.log_level = log_level
        self.linebuf = ""

    def __getattr__(self, attr):
        return getattr(self.terminal, attr)

    def write(self, buf):
        temp_linebuf = self.linebuf + buf
        self.linebuf = ""
        for line in temp_linebuf.splitlines(True):
            if line[-1] == "\n":
                self.logger.log(self.log_level, line.rstrip())
            else:
                self.linebuf += line

    def flush(self):
        if self.linebuf != "":
            self.logger.log(self.log_level, self.linebuf.rstrip())
        self.linebuf = ""


def build_logger(logger_name: str, logger_filename: str,
                 log_dir: str = "logs", redirect_std: bool = False
                 ) -> logging.Logger:
    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logging.getLogger().handlers[0].setFormatter(formatter)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if logger_filename not in _handlers:
        os.makedirs(log_dir, exist_ok=True)
        filename = os.path.join(log_dir, logger_filename)
        handler = logging.handlers.TimedRotatingFileHandler(
            filename, when="D", utc=True, encoding="utf-8")
        handler.setFormatter(formatter)
        _handlers[logger_filename] = handler
        for name, item in logging.root.manager.loggerDict.items():
            if isinstance(item, logging.Logger):
                item.addHandler(handler)
    logger.addHandler(_handlers[logger_filename])

    if redirect_std:
        stdout_logger = logging.getLogger(f"{logger_name}.stdout")
        stdout_logger.setLevel(logging.INFO)
        sys.stdout = StreamToLogger(stdout_logger, logging.INFO)
        stderr_logger = logging.getLogger(f"{logger_name}.stderr")
        stderr_logger.setLevel(logging.ERROR)
        sys.stderr = StreamToLogger(stderr_logger, logging.ERROR)
    return logger


class StepMeter:
    """Rolling step-time and token-throughput meter."""

    def __init__(self, window: int = 20):
        self.window = window
        self.times = []
        self.tokens = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, num_tokens: int = 0):
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self.tokens.append(num_tokens)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.tokens.pop(0)
        self._t0 = None
        return dt

    @property
    def step_time(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def tokens_per_sec(self) -> float:
        t = sum(self.times)
        return sum(self.tokens) / t if t > 0 else 0.0

    def summary(self) -> str:
        return f"{self.step_time:.3f}s/step, {self.tokens_per_sec:,.0f} tok/s"

