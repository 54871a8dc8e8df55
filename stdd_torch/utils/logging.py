"""Colored console + file logging (the reference's tensorpack-style logger,
``altfreezing/utils/logger.py`` + ``slowfast/utils/logging.py``).

Own copy of ``stdd_tpu/utils/logging.py`` under the ``stdd_torch`` logger:
one package logger, ANSI-colored levels on TTYs, an optional log directory
with a ``log.txt`` file handler, and ``log_json_stats`` for the
machine-readable ``json_stats:`` lines both packages write."""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Any, Dict, Optional

_COLORS = {"WARNING": 33, "ERROR": 31, "CRITICAL": 41, "DEBUG": 36}


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if sys.stdout.isatty() and record.levelname in _COLORS:
            return f"\x1b[{_COLORS[record.levelname]}m{msg}\x1b[0m"
        return msg


_FMT = "[%(asctime)s @%(module)s:%(lineno)d] %(levelname)s %(message)s"
_DATEFMT = "%m%d %H:%M:%S"
_logger: Optional[logging.Logger] = None


def get_logger(name: str = "stdd_torch") -> logging.Logger:
    """Named logger under the configured ``stdd_torch`` root. Any short name
    ('i3d', 'train') becomes a child of it — a bare getLogger(name) would
    have no handlers and root's WARNING level, dropping every info-level
    line from the console and log.txt."""
    global _logger
    if name != "stdd_torch" and not name.startswith("stdd_torch."):
        name = f"stdd_torch.{name}"
    if _logger is not None:
        return logging.getLogger(name)
    logger = logging.getLogger("stdd_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    h = logging.StreamHandler(sys.stdout)
    h.setFormatter(_ColorFormatter(_FMT, datefmt=_DATEFMT))
    logger.addHandler(h)
    _logger = logger
    return logging.getLogger(name)


def set_logger_dir(dirname: str, action: str = "k") -> str:
    """Attach a file handler writing ``log.txt`` under ``dirname``
    (utils/logger.py set_logger_dir; 'k' keeps existing logs). Idempotent
    per path: calling twice (resume re-setup) must not duplicate lines."""
    os.makedirs(dirname, exist_ok=True)
    logger = get_logger()
    path = os.path.abspath(os.path.join(dirname, "log.txt"))
    for h in logger.handlers:
        if isinstance(h, logging.FileHandler) and h.baseFilename == path:
            return path
    fh = logging.FileHandler(path)
    fh.setFormatter(logging.Formatter(_FMT, datefmt=_DATEFMT))
    logger.addHandler(fh)
    return path


def log_json_stats(stats: Dict[str, Any], logger: Optional[logging.Logger] = None) -> None:
    """``json_stats: {...}`` lines (slowfast/utils/logging.py:81) — greppable
    machine-readable training telemetry."""
    (logger or get_logger()).info("json_stats: %s", json.dumps(stats, sort_keys=True, default=float))
