"""Logging subsystem: custom levels + compressed rotating file logs.

Reference: stp_core/common/log.py:29 (Singleton Logger, TRACE(5) and
DISPLAY(25) custom levels) + stp_core/common/logging/
CompressingFileHandler.py (rotating file handler that gzips rotated
segments). An operator running `start_plenum_tpu_node` for weeks needs
bounded, greppable, per-node log files; TRACE gives message-level wire
debugging below DEBUG, DISPLAY sits between INFO and WARNING for
operator-facing progress lines that must survive a quieter-than-INFO
configuration.
"""
from __future__ import annotations

import gzip
import logging
import logging.handlers
import os
import shutil
from typing import Optional

TRACE = 5
DISPLAY = 25

logging.addLevelName(TRACE, "TRACE")
logging.addLevelName(DISPLAY, "DISPLAY")


def _trace(self, msg, *args, **kwargs):
    if self.isEnabledFor(TRACE):
        self._log(TRACE, msg, args, **kwargs)


def _display(self, msg, *args, **kwargs):
    if self.isEnabledFor(DISPLAY):
        self._log(DISPLAY, msg, args, **kwargs)


# reference log.py injects the level methods on Logger once, globally
if not hasattr(logging.Logger, "trace"):
    logging.Logger.trace = _trace
if not hasattr(logging.Logger, "display"):
    logging.Logger.display = _display


class CompressingFileHandler(logging.handlers.RotatingFileHandler):
    """RotatingFileHandler whose rotated segments are gzip-compressed —
    node logs compress ~20x, so backupCount segments cover weeks instead
    of hours for the same disk budget (reference
    CompressingFileHandler.py)."""

    def __init__(self, filename, maxBytes: int = 50 * 1024 * 1024,
                 backupCount: int = 10, encoding=None, delay=False):
        super().__init__(filename, maxBytes=maxBytes,
                         backupCount=backupCount, encoding=encoding,
                         delay=delay)

    def rotation_filename(self, default_name: str) -> str:  # noqa: N802
        return default_name + ".gz"

    def rotate(self, source: str, dest: str) -> None:
        try:
            with open(source, "rb") as f_in, \
                    gzip.open(dest, "wb") as f_out:
                shutil.copyfileobj(f_in, f_out)
            os.remove(source)
        except OSError:  # rotation must never kill the node
            logging.getLogger(__name__).warning(
                "log rotation %s -> %s failed", source, dest, exc_info=True)


DEFAULT_FORMAT = ("%(asctime)s | %(levelname)-8s | %(name)s "
                  "(%(filename)s:%(lineno)d) | %(message)s")


class Logger:
    """Process-wide logging configurator (reference log.py Singleton).

    Usage:
        Logger().enableFileLogging("/var/log/plenum_tpu/Alpha.log")
        Logger().enableStdLogging()
        Logger().setLevel(TRACE)
    """

    _instance = None

    def __new__(cls, *args, **kwargs):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._file_handler = None
            cls._instance._console_handler = None
            cls._instance._format = DEFAULT_FORMAT
        return cls._instance

    @property
    def _root(self) -> logging.Logger:
        return logging.getLogger()

    def setLevel(self, level) -> None:  # noqa: N802
        self._root.setLevel(level)

    def apply_config(self, config) -> None:
        """Pick up logging_level / logging_format from a node Config."""
        fmt = getattr(config, "LOG_FORMAT", None)
        if fmt:
            self._format = fmt
            for h in (self._file_handler, self._console_handler):
                if h is not None:
                    h.setFormatter(logging.Formatter(fmt))
        level = getattr(config, "LOG_LEVEL", None)
        if level is not None:
            self.setLevel(level)

    def enableStdLogging(self) -> None:  # noqa: N802
        if self._console_handler is None:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter(self._format))
            self._console_handler = h
            self._root.addHandler(h)

    def enableFileLogging(self, file_path: str,
                          max_bytes: int = 50 * 1024 * 1024,
                          backup_count: int = 10) -> None:  # noqa: N802
        if self._file_handler is not None:
            return
        os.makedirs(os.path.dirname(os.path.abspath(file_path)),
                    exist_ok=True)
        h = CompressingFileHandler(file_path, maxBytes=max_bytes,
                                   backupCount=backup_count)
        h.setFormatter(logging.Formatter(self._format))
        self._file_handler = h
        self._root.addHandler(h)

    def disableFileLogging(self) -> None:  # noqa: N802
        if self._file_handler is not None:
            self._root.removeHandler(self._file_handler)
            self._file_handler.close()
            self._file_handler = None

    @property
    def log_file(self) -> Optional[str]:
        return (self._file_handler.baseFilename
                if self._file_handler else None)


def getlogger(name: Optional[str] = None) -> logging.Logger:
    """Reference-parity accessor (stp_core getlogger)."""
    return logging.getLogger(name)
