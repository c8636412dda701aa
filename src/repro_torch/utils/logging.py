"""Tiny structured logger (stdlib only), counterpart of
`repro/utils/logging.py`: one stderr handler a logger, the reference's
line format."""
from __future__ import annotations

import logging
import sys

_FMT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"


def get_logger(name: str = "repro_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
