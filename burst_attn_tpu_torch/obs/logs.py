"""Obs logger: the one logging setup instrumented code goes through (a
copy of burst_attn_tpu/obs/logs.py).

Same handler/format contract as the original utils/log_helper.get_logger
(which now delegates here), plus:

  * every emitted record advances the registry counter
    `log.events{level=...}` — noisy subsystems show up in `python -m
    burst_attn_tpu_torch.obs` without grepping stderr;
  * `safe_warn(logger, msg, *args)` — a warning that can NEVER raise, for
    `__del__`/interpreter-teardown paths where the logging machinery itself
    may already be torn down.  Failed emissions are kept in `_DROPPED`
    (inspectable, bounded) instead of being silently lost, which is what
    lets data/loader.py drop its last `silent-except` burstlint
    suppression.

Deliberately standalone (imports nothing from the rest of the package) so
obs can be imported from anywhere — including utils/log_helper and the
data-loader teardown path — without a cycle.
"""

import logging
import sys
from typing import List, Optional

from .registry import default_registry

_FMT = "%(asctime)s %(name)s %(levelname)s: %(message)s"

# messages whose emission failed in safe_warn (teardown); newest last
_DROPPED: List[str] = []
_MAX_DROPPED = 256


class _CountingFilter(logging.Filter):
    """Counts records through the obs registry; never blocks a record."""

    def filter(self, record: logging.LogRecord) -> bool:
        try:
            default_registry().counter("log.events").inc(
                level=record.levelname)
        except Exception:  # noqa: BLE001 — logging must never raise
            _drop(record.getMessage() if record.args is None else record.msg)
        return True


def _drop(msg) -> None:
    if len(_DROPPED) >= _MAX_DROPPED:
        del _DROPPED[: _MAX_DROPPED // 2]
    _DROPPED.append(str(msg))


def get_logger(name: str, level=logging.INFO,
               file: Optional[str] = None) -> logging.Logger:
    """Per-name logger with stream (and optional file) handlers, configured
    once; every record is counted in `log.events{level=...}`."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.setLevel(level)
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(sh)
        if file:
            fh = logging.FileHandler(file)
            fh.setFormatter(logging.Formatter(_FMT))
            logger.addHandler(fh)
        logger.propagate = False
    if not any(isinstance(f, _CountingFilter) for f in logger.filters):
        logger.addFilter(_CountingFilter())
    return logger


def safe_warn(logger: logging.Logger, msg: str, *args) -> None:
    """logger.warning that cannot raise.  For teardown paths only — normal
    code should call the logger directly so failures surface."""
    try:
        logger.warning(msg, *args)
    except Exception:  # noqa: BLE001 — teardown: logging may be half-gone
        _drop(msg)


def dropped_messages() -> List[str]:
    """Messages safe_warn/counting failed to emit (tests, postmortems)."""
    return list(_DROPPED)
