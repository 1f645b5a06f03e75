"""Rank-aware logging helpers (port of burst_attn_tpu/utils/log_helper.py).

`get_logger` delegates to the obs logger (obs/logs.py), so every record
is counted in the registry (`log.events{level=...}`).  In a run across
processes (utils/multihost.py) the primary process is rank 0; without a
process group, the only process."""

import logging
from typing import Optional


def get_logger(name: str, level=logging.INFO, file: Optional[str] = None):
    """Per-name logger with stream (and optional file) handlers, configured
    once; imported lazily so utils stays importable while obs
    initializes."""
    from ..obs.logs import get_logger as _obs_get_logger

    return _obs_get_logger(name, level=level, file=file)


def is_primary() -> bool:
    """True on the process that should emit logs: rank 0 of the process
    group, or the only process when no group is up."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def print_rank0(*args, **kwargs):
    if is_primary():
        print(*args, **kwargs)


def log_rank0(logger, msg, level=logging.INFO):
    if is_primary():
        logger.log(level, msg)
