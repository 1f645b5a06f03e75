"""Checkpoint / resume for the trainer (port of
burst_attn_tpu/utils/checkpoint.py, which wraps Orbax).

One file per step, `ckpt_<step>.pt` in the run directory: `torch.save` of
{params, optimizer state_dict, step}, written to a temporary file, fsynced,
then renamed into place, so a crash never leaves a torn checkpoint under
the final name.  Restore is exact: the same bits, placed on the device the
caller names.  Parameters split over a tp axis (transformer.ShardedParams)
and their AdamW moments are saved whole (each split leaf's shards
joined), so a checkpoint holds the same tensors whatever the tp size it
was written at, and `restore` splits them again for the mesh it is given:
a tp=2 run restores at tp=1 and back.  In a run across processes
(utils/multihost.py) every process first joins the whole tensors (a tp
axis that spans processes gathers its shards and their moments from
them), then the primary process writes and every process waits at a
barrier after it (parallel/collectives.synchronize on a
`wait_group` of `write_timeout_s`, so that a write longer than the run's
group timeout does not fail the waiting processes); every process reads,
so a resumed run continues exactly on each.

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
    """Keeps the newest `max_to_keep` checkpoints of one run directory.
    `write_timeout_s`: how long the other processes of a run wait for the
    primary's write."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 write_timeout_s: float = 3600.0):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.dir = Path(directory).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.write_timeout_s = write_timeout_s

    def _path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}.pt"

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.dir)) if m)

    def save(self, step: int, state) -> None:
        """Write (params, optimizer) at `step` durably, then drop the
        oldest checkpoints beyond `max_to_keep`: on the primary process,
        every process then waiting for it (the state is the same on
        each: replicated over the processes' dp groups)."""
        from ..parallel.collectives import synchronize, wait_group
        from .log_helper import is_primary

        from ..models.transformer import unshard_params

        group = wait_group(self.write_timeout_s)  # made before the write
        params, opt = state
        # on every process: the gathers of shards other processes hold
        payload = {"params": _detach(unshard_params(params)),
                   "opt": _whole_opt_state(params, opt.state_dict()),
                   "step": int(step)}
        if is_primary():
            self._write(step, payload)
        synchronize(group)

    def _write(self, step: int, payload) -> None:
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
        (default: the card), split over `mesh`'s tp axis when it has one
        of size > 1."""
        from ..models.train import _optimizer, _world, place_params

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
        params = place_params(params, cfg, mesh)
        opt = _optimizer(params, tcfg)
        opt.load_state_dict(_split_opt_state(params, payload["opt"]))
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


def _leaf_splits(params):
    """(dim, shards held, the Shards or None) of every leaf in
    tree_leaves' order: (None, 1, None) for a whole tensor, (the split
    dim, its shards here, it) for a Shards."""
    from ..models.transformer import Shards, tree_leaves

    return [(x.dim, len(x), x) if isinstance(x, Shards) else (None, 1, None)
            for x in tree_leaves(params)]


def _whole_opt_state(params, sd):
    """An optimizer state_dict over split parameters as the one over the
    whole tree: each split leaf's per-shard moments joined along its dim
    (the scalar `step` kept once); shards other processes hold gathered
    from them (every process calls it)."""
    from ..parallel.mesh import _gathered

    splits = _leaf_splits(params)
    if all(x is None for _, _, x in splits):
        return sd
    state, i = {}, 0
    for j, (dim, n, x) in enumerate(splits):
        got = [sd["state"].get(i + k) for k in range(n)]
        i += n
        if got[0] is None:
            continue
        whole = {}
        for key in got[0]:
            if dim is None or got[0][key].dim() == 0:
                whole[key] = got[0][key]
                continue
            parts = [g[key] for g in got]
            if x.total > n:
                parts = _gathered(parts, x.axis, x.mesh)[0]
            whole[key] = torch.cat(parts, dim=dim)
        state[j] = whole
    groups = [dict(g, params=list(range(len(splits))))
              for g in sd["param_groups"]]
    return {"state": state, "param_groups": groups}


def _split_opt_state(params, sd):
    """The inverse of _whole_opt_state for `params`' splits (the shards
    this process holds)."""
    splits = _leaf_splits(params)
    if all(x is None for _, _, x in splits):
        return sd
    state, i = {}, 0
    for j, (dim, n, x) in enumerate(splits):
        got = sd["state"].get(j)
        if got is not None:
            for k in range(n):
                state[i + k] = {
                    key: (v.chunk(x.total, dim=dim)[x.first + k].contiguous()
                          if dim is not None and v.dim() > 0 else v.clone())
                    for key, v in got.items()}
        i += n
    groups = [dict(g, params=list(range(i))) for g in sd["param_groups"]]
    return {"state": state, "param_groups": groups}
