"""Two-handler logger: DEBUG → file, INFO → stdout.

Same observable contract as the reference singleton LOG
(utils/Logger.py:5-36) but created on demand instead of at import, and
parameterized by log path.
"""

from __future__ import annotations

import logging
import sys

_LOGGERS = {}


def get_logger(name: str = "dcase_tpu", log_file: str | None = None, terminal_level=logging.INFO):
    key = (name, log_file)
    if key in _LOGGERS:
        return _LOGGERS[key]
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
        sh = logging.StreamHandler(sys.stdout)
        sh.setLevel(terminal_level)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_file is not None:
            fh = logging.FileHandler(log_file)
            fh.setLevel(logging.DEBUG)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    _LOGGERS[key] = logger
    return logger
