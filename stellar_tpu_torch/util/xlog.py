"""Partitioned logging (reference: src/util/Logging.{h,cpp} over easylogging++).

Partitions (Logging.h:17-27): Fs, SCP, Bucket, Database, History, Process,
Ledger, Overlay, Herder, Tx — each with a runtime-adjustable level, settable
globally or per-partition (the admin ``/ll`` endpoint uses this).
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

PARTITIONS = (
    "Fs",
    "SCP",
    "Bucket",
    "Database",
    "History",
    "Process",
    "Ledger",
    "Overlay",
    "Herder",
    "Tx",
)

_LEVELS = {
    "trace": logging.DEBUG - 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
    "none": logging.CRITICAL + 10,
}

_initialized = False


def init(level: str = "info", stream=None) -> None:
    global _initialized
    root = logging.getLogger("stellar_tpu")
    if not _initialized:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(name)s [%(levelname)s] %(message)s", "%H:%M:%S"
            )
        )
        root.addHandler(handler)
        root.propagate = False
        _initialized = True
    set_log_level(level)


_file_handler = None
_file_path = ""


def add_file(path: str) -> None:
    """Attach a log file (Config LOG_FILE_PATH).  Reopenable via rotate()."""
    global _file_handler, _file_path
    if not path:
        return
    root = logging.getLogger("stellar_tpu")
    if _file_handler is not None:
        root.removeHandler(_file_handler)
        _file_handler.close()
    _file_path = path
    _file_handler = logging.FileHandler(path)
    _file_handler.setFormatter(
        logging.Formatter(
            "%(asctime)s %(name)s [%(levelname)s] %(message)s", "%H:%M:%S"
        )
    )
    root.addHandler(_file_handler)


def rotate() -> bool:
    """Close and reopen the log file so an external rotator can move it
    (the /logrotate admin command; the reference's handler is a stub —
    CommandHandler.cpp:444 — this one actually reopens)."""
    if not _file_path:
        return False
    add_file(_file_path)
    return True


def logger(partition: str) -> logging.Logger:
    return logging.getLogger(f"stellar_tpu.{partition}")


def set_log_level(level: str, partition: Optional[str] = None) -> bool:
    """Set global or per-partition level; returns False on unknown names
    (admin /ll contract, CommandHandler.cpp:75)."""
    lv = _LEVELS.get(level.lower())
    if lv is None:
        return False
    if partition is None:
        logging.getLogger("stellar_tpu").setLevel(lv)
        for p in PARTITIONS:
            logger(p).setLevel(lv)
        return True
    if partition not in PARTITIONS:
        return False
    logger(partition).setLevel(lv)
    return True


def get_log_levels() -> dict:
    return {
        p: logging.getLevelName(logger(p).getEffectiveLevel()) for p in PARTITIONS
    }
