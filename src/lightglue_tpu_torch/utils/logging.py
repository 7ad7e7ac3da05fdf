"""Severity-filtered logging + error recording (copy of
lightglue_tpu/utils/logging.py; SURVEY.md §2.1, §5).

The reference vendors NVIDIA's TensorRT sample logger — a severity-filtered
``ILogger`` with per-severity streams (demo/3rdparty/tensorrtbuffer/include/
logging.h:1-477) — plus mutex-guarded plugin log streams and an
``ErrorRecorder`` (error_recorder.h, registered but effectively unused by the
demo). The port keeps the same observable surface with the standard library:

- ``get_logger(name)``: a stdlib logger under the ``lightglue_tpu_torch`` root with
  TRT-style severity names; level set once from ``LGTPU_LOG_LEVEL``
  (VERBOSE | INFO | WARNING | ERROR | INTERNAL_ERROR) or programmatically via
  ``set_level``.
- ``ErrorRecorder``: thread-safe error accumulation with the
  ``IErrorRecorder``-shaped API (num_errors / error_desc / clear / has_
  overflowed), used by the session to aggregate validation failures instead
  of dying on the first one.
- ``check(cond, msg)``: the PLUGIN_ASSERT analog
  (lightglue_attention_plugin/common/checkMacrosPlugin.h) — logs through the
  root logger then raises, so failures are visible even when exceptions are
  swallowed by a driver loop.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import List, Optional

_ROOT = "lightglue_tpu_torch"

# TRT ILogger::Severity names -> stdlib levels (logging.h Severity enum).
_SEVERITIES = {
    "VERBOSE": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "INTERNAL_ERROR": logging.CRITICAL,
}

_configured = False
_lock = threading.Lock()


def _configure_once() -> None:
    global _configured
    with _lock:
        if _configured:
            return
        root = logging.getLogger(_ROOT)
        if not root.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(
                logging.Formatter("[%(levelname)s] [%(name)s] %(message)s")
            )
            root.addHandler(handler)
        level_name = os.environ.get("LGTPU_LOG_LEVEL", "WARNING").upper()
        root.setLevel(_SEVERITIES.get(level_name, logging.WARNING))
        root.propagate = False
        _configured = True


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Severity-filtered logger; child of the package root."""
    _configure_once()
    return logging.getLogger(_ROOT if not name else f"{_ROOT}.{name}")


def set_level(severity: str) -> None:
    """Set the root severity by TRT-style name (VERBOSE..INTERNAL_ERROR)."""
    _configure_once()
    if severity.upper() not in _SEVERITIES:
        raise ValueError(
            f"unknown severity {severity!r}; expected one of {sorted(_SEVERITIES)}"
        )
    logging.getLogger(_ROOT).setLevel(_SEVERITIES[severity.upper()])


class ErrorRecorder:
    """Thread-safe bounded error accumulator.

    Shape of the reference's ``IErrorRecorder`` implementation
    (demo/3rdparty/tensorrtbuffer/include/error_recorder.h): fixed capacity,
    overflow flag instead of unbounded growth, explicit clear.
    """

    def __init__(self, capacity: int = 256) -> None:
        self._capacity = int(capacity)
        self._errors: List[str] = []
        self._overflowed = False
        self._lock = threading.Lock()

    def record(self, desc: str) -> None:
        with self._lock:
            if len(self._errors) >= self._capacity:
                self._overflowed = True
                return
            self._errors.append(str(desc))

    @property
    def num_errors(self) -> int:
        with self._lock:
            return len(self._errors)

    def error_desc(self, index: int) -> str:
        with self._lock:
            return self._errors[index]

    @property
    def has_overflowed(self) -> bool:
        with self._lock:
            return self._overflowed

    def clear(self) -> None:
        with self._lock:
            self._errors.clear()
            self._overflowed = False

    def raise_if_any(
        self, prefix: str = "recorded errors", exc: type = RuntimeError
    ) -> None:
        with self._lock:
            if not self._errors:
                return
            detail = "; ".join(self._errors)
            if self._overflowed:
                detail += "; ... (overflowed)"
        raise exc(f"{prefix}: {detail}")


def check(cond: bool, msg: str) -> None:
    """PLUGIN_ASSERT analog: log at ERROR through the package logger, then
    raise — visible even if the caller swallows the exception."""
    if not cond:
        get_logger("check").error(msg)
        raise AssertionError(msg)
