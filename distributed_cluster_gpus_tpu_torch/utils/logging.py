"""Rotating-file logger: ``project.log`` in a run's output directory.

Counterpart of ``distributed_cluster_gpus_tpu/utils/logging.py`` (a copy):
one logger per directory, DEBUG level, 5 MB x 3 backups.
"""

from __future__ import annotations

import logging
import os
from logging.handlers import RotatingFileHandler

_LOGGER_NAME = "SIMU_DC_TORCH"
_loggers: dict[str, logging.Logger] = {}


def get_logger(log_dir: str | None = None) -> logging.Logger:
    """One rotating-file logger per log_dir (cached per directory)."""
    log_dir = os.path.abspath(log_dir or os.getcwd())
    if log_dir in _loggers:
        return _loggers[log_dir]
    logger = logging.getLogger(f"{_LOGGER_NAME}.{len(_loggers)}")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    os.makedirs(log_dir, exist_ok=True)
    handler = RotatingFileHandler(
        os.path.join(log_dir, "project.log"),
        maxBytes=5 * 1024 * 1024,
        backupCount=3,
        encoding="utf-8",
    )
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    logger.addHandler(handler)
    _loggers[log_dir] = logger
    return logger
