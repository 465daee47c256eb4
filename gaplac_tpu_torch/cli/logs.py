"""Logging setup: console level flags and tee-to-file (port of
``gaplac_tpu/cli/logs.py``; default Warn, -v Info, -q Error, --debug Debug)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def setup_logs(verbose: bool, quiet: bool, debug: bool, log_path: Optional[str]) -> logging.Logger:
    if debug:
        level = logging.DEBUG
    elif verbose:
        level = logging.INFO
    elif quiet:
        level = logging.ERROR
    else:
        level = logging.WARNING

    logger = logging.getLogger("gaplac")
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()

    console = logging.StreamHandler(sys.stderr)
    console.setLevel(level)
    console.setFormatter(logging.Formatter("[ %(levelname)s: %(message)s"))
    logger.addHandler(console)

    if log_path:
        fh = logging.FileHandler(os.path.abspath(os.path.expanduser(log_path)))
        fh.setLevel(level)
        fh.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(message)s"))
        logger.addHandler(fh)

    return logger
