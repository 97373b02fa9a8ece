"""Loggers: counterpart of ``trainner_tpu/utils/logging_utils.py``
(``mkdirs:34``, ``get_root_logger:50``)."""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

_FORMAT = "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s"


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
