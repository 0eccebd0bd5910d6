"""Process-0 logging (reference utils/misc.py:229-295 used loguru; we use the
stdlib so the framework has zero extra deps).  All hosts may call the logger;
only the lead host emits."""

from __future__ import annotations

import logging
import os
import sys

_LOGGER_NAME = "crog_tpu_torch"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def setup_logger(
    save_dir: str | None = None,
    distributed_rank: int = 0,
    filename: str = "train.log",
    mode: str = "a",
    level: int = logging.INFO,
) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(level)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
    if distributed_rank > 0:  # non-lead hosts stay silent
        logger.addHandler(logging.NullHandler())
        return logger
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)s | %(message)s", datefmt="%Y-%m-%d %H:%M:%S"
    )
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename), mode=mode)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
