"""Rank-aware logging helpers (port of burst_attn_tpu/utils/log_helper.py).

The port runs one process on one card, so the process is always the
primary one; the helpers keep the JAX package's call sites."""

import logging


def get_logger(name: str, level=logging.INFO) -> logging.Logger:
    """A named logger with one stream handler, configured once."""
    log = logging.getLogger(name)
    if not log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        log.addHandler(h)
        log.setLevel(level)
    return log


def is_primary() -> bool:
    """True on the process that should emit logs (the only one here)."""
    return True


def print_rank0(*args, **kwargs):
    if is_primary():
        print(*args, **kwargs)
