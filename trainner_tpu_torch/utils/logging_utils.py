"""Loggers: counterpart of ``trainner_tpu/utils/logging_utils.py``
(``mkdir_and_rename:25``, ``mkdirs:34``, ``sorted_nicely:43``,
``get_root_logger:50``, ``ScalarWriter:75``)."""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import time
from datetime import datetime
from typing import Dict, Optional

_FORMAT = "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s"


def mkdir_and_rename(path: str) -> None:
    """Makes ``path``; one that exists already is first moved aside to
    ``path + "_archived_" + a timestamp``."""
    if os.path.exists(path):
        stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
        shutil.move(path, path + "_archived_" + stamp)
    os.makedirs(path, exist_ok=True)


def sorted_nicely(items):
    """Sorted with the numbers in names compared as numbers: 10_G.ckpt
    after 9_G.ckpt."""
    def key(k):
        return [int(t) if t.isdigit() else t for t in re.split(r"([0-9]+)",
                                                              k)]
    return sorted(items, key=key)


def mkdirs(paths) -> None:
    if isinstance(paths, str):
        os.makedirs(paths, exist_ok=True)
        return
    for p in paths:
        if p and isinstance(p, str) and not os.path.splitext(p)[1]:
            os.makedirs(p, exist_ok=True)


def get_root_logger(name: str = "base", root: Optional[str] = None,
                    phase: str = "train", level=logging.INFO,
                    screen: bool = True, tofile: bool = True
                    ) -> logging.Logger:
    """Named logger writing to a file under ``root`` and to the screen."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter(_FORMAT, datefmt="%y-%m-%d %H:%M:%S")
    if tofile and root:
        os.makedirs(root, exist_ok=True)
        ts = time.strftime("%y%m%d-%H%M%S")
        fh = logging.FileHandler(
            os.path.join(root, f"{phase}_{ts}.log"), mode="w")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    logger.propagate = False
    return logger


def close_logger(name: str) -> None:
    """Closes and removes the handlers of a named logger, so that the next
    ``get_root_logger`` of that name writes to a file of its own (a second
    run in one process, such as a resume)."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


class ScalarWriter:
    """Scalars of a run: always to ``scalars.jsonl`` in ``log_dir`` (one
    JSON object per line: tag, value, step, time), and to TensorBoard
    event files as well when ``torch.utils.tensorboard`` imports.
    ``backends`` says which of the two it writes."""

    def __init__(self, log_dir: str, use_tb: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        self.tb_error: Optional[str] = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:  # the tensorboard package is absent
                self.tb_error = f"{type(e).__name__}: {e}"
            else:
                self._tb = SummaryWriter(log_dir=log_dir)
        self.backends = ("jsonl", "tensorboard") if self._tb is not None \
            else ("jsonl",)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, scalars: Dict[str, float], step: int,
                    prefix: str = "") -> None:
        for k, v in scalars.items():
            self.add_scalar(prefix + k, v, step)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
