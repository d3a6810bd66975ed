"""Host tracing flags (``PORTFFT_LOG_TRACES`` and ``PORTFFT_LOG_WARNINGS``,
as in ``portfft_tpu.utils.logging``): ``trace`` and ``warn`` write to the
``portfft_tpu_torch`` logger when their flag is on."""

from __future__ import annotations

import logging
import os
import sys

logger = logging.getLogger("portfft_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[portfft_tpu_torch] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() not in ("", "0", "false", "off")


TRACES_ENABLED = _env_flag("PORTFFT_LOG_TRACES")
WARNINGS_ENABLED = _env_flag("PORTFFT_LOG_WARNINGS") or TRACES_ENABLED

if TRACES_ENABLED:
    logger.setLevel(logging.DEBUG)


def trace(*parts) -> None:
    """Trace message, emitted when ``PORTFFT_LOG_TRACES`` is set."""
    if TRACES_ENABLED:
        logger.debug(" ".join(str(p) for p in parts))


def warn(*parts) -> None:
    """Warning, emitted when ``PORTFFT_LOG_WARNINGS`` (or traces) is set."""
    if WARNINGS_ENABLED:
        logger.warning(" ".join(str(p) for p in parts))
