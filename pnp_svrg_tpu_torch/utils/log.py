"""Logging setup -- the reference's ``set_logger`` helper (reference
``denoisers/DeepDenoisers/training/utilities/log.py:3-27``): stdlib logging
to a file plus the console, idempotent per logger. A copy of
``pnp_svrg_tpu/utils/log.py``, with the same formats."""

from __future__ import annotations

import logging
from pathlib import Path


def set_logger(log_path: str | Path | None = None, name: str | None = None) -> logging.Logger:
    """Configure (and return) a logger writing to ``log_path`` and stderr.

    Safe to call repeatedly: handlers are only attached once per logger.
    """
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        if log_path is not None:
            Path(log_path).parent.mkdir(parents=True, exist_ok=True)
            fh = logging.FileHandler(log_path)
            fh.setFormatter(
                logging.Formatter("%(asctime)s:%(levelname)s: %(message)s")
            )
            logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(sh)
    return logger
