"""Checkpoint / resume for the trainer (port of
burst_attn_tpu/utils/checkpoint.py, which wraps Orbax).

One file per step, `ckpt_<step>.pt` in the run directory: `torch.save` of
{params, optimizer state_dict, step}, written to a temporary file, fsynced,
then renamed into place, so a crash never leaves a torn checkpoint under
the final name.  Restore is exact: the same bits, placed on the device the
caller names.

    ckpt = Checkpointer(dir)
    ckpt.save(step, state)                         # state = (params, opt)
    state, step = ckpt.restore_latest(cfg, tcfg)   # (None, None) if empty
"""

import os
import re
from pathlib import Path
from typing import Any, List, Optional, Tuple

import torch

from ..device import resolve_device

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class Checkpointer:
    """Keeps the newest `max_to_keep` checkpoints of one run directory."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.dir = Path(directory).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}.pt"

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.dir)) if m)

    def save(self, step: int, state) -> None:
        """Write (params, optimizer) at `step` durably, then drop the
        oldest checkpoints beyond `max_to_keep`."""
        params, opt = state
        payload = {"params": _detach(params), "opt": opt.state_dict(),
                   "step": int(step)}
        final = self._path(step)
        tmp = final.with_suffix(f".tmp.{os.getpid()}")
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        fd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(fd)  # the rename itself is durable
        finally:
            os.close(fd)
        for old in self.steps()[:-self.max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, cfg, tcfg, mesh=None, *,
                device=None) -> Tuple[Any, int]:
        """The state saved at `step` as (params, optimizer) on `device`
        (default: the card)."""
        from ..models.train import _optimizer, _world
        from ..models.transformer import param_leaves

        _world(cfg, mesh)
        dev = resolve_device(device)
        payload = torch.load(self._path(step), map_location=dev,
                             weights_only=True)
        params = payload["params"]
        layers = params["layers"]
        # stacked (pp) layers: the leading dim of any leaf
        n = (next(iter(layers.values())).shape[0]
             if isinstance(layers, dict) else len(layers))
        if n != cfg.n_layers:
            raise ValueError(f"checkpoint has {n} layers, the config "
                             f"{cfg.n_layers}")
        for t in param_leaves(params):
            t.requires_grad_(True)
        opt = _optimizer(params, tcfg)
        opt.load_state_dict(payload["opt"])
        return (params, opt), int(payload["step"])

    def restore_latest(self, cfg, tcfg, mesh=None, *, device=None
                       ) -> Tuple[Any, Optional[int]]:
        """The newest checkpoint, or (None, None) when there is none."""
        step = self.latest_step()
        if step is None:
            return None, None
        return self.restore(step, cfg, tcfg, mesh, device=device)

    def close(self) -> None:
        """Saves are synchronous; nothing is left to flush."""


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detach(v) for v in tree]
    return tree.detach()

