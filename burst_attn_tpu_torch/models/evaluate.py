"""Held-out evaluation: mean next-token cross entropy / perplexity over a
token file, with the training forward and no optimizer (port of
burst_attn_tpu/models/evaluate.py).  In a run across processes each
process reads its shard of the file (the loader's shard_id / num_shards,
train.data_shard, as the JAX evaluator) and the token-weighted loss is
taken over the sums of the processes that hold distinct tokens
(parallel/collectives.gather_obj): each row, and each part of a sequence
split between processes, counts once, whatever other axis (tp, an expert
axis of its own, a pipeline's stages: its last) replicates it; the same
on each process."""

import math

import torch

from ..data import DataLoader
from ..device import resolve_device
from ..parallel.collectives import gather_obj
from ..parallel.mesh import Mesh
from .train import _loss_parts, batch_from_host, data_shard
from .transformer import ModelConfig


def make_eval_step(cfg: ModelConfig, mesh=None):
    """(params, batch) -> (nll sum, valid-token count), without autograd:
    the caller adds sum and count across batches, so the eval loss is the
    same token-weighted objective as the train loss (packed batches
    included: their `segment_ids` reach the attention)."""

    def step(params, batch):
        with torch.no_grad():
            nll_sum, _ = _loss_parts(params, batch["tokens"],
                                     batch["positions"], batch["labels"],
                                     cfg, mesh,
                                     segment_ids=batch.get("segment_ids"))
        return nll_sum, (batch["labels"] >= 0).sum()

    return step


class Evaluator:
    """Reusable held-out eval: the (sequential, unshuffled) loader stays
    open across rounds and each call rewinds it, so every eval sees the
    same batches.  A packed run (`packed_eos_id`) is evaluated packed, or
    eval_loss would measure another objective (cross-document attention,
    unmasked boundaries) than the train loss."""

    def __init__(self, cfg: ModelConfig, mesh, data_path, *, batch: int,
                 seq_len: int, max_batches: int = 32, packed_eos_id=None,
                 device=None):
        self._step = make_eval_step(cfg, mesh)
        self._cfg, self._mesh = cfg, mesh
        self._packed_eos_id = packed_eos_id
        self._device = resolve_device(device)
        shard_id, num_shards = data_shard(cfg, mesh)
        # the one process that counts these tokens among those that hold
        # them alike: the first along a replicating axis, the last along
        # a pipeline's stages (the one with the logits)
        data = (cfg.batch_axis, *cfg.seq_axes)
        coords = mesh.process_coords if isinstance(mesh, Mesh) else {}
        self._first_replica = all(
            i == (len(mesh.axis_ranks(a)) - 1 if a == cfg.pp_axis else 0)
            for a, i in coords.items() if a not in data)
        self._loader = DataLoader(data_path, batch, seq_len,
                                  shard_id=shard_id, num_shards=num_shards,
                                  shuffle=False)
        self._n = min(max_batches,
                      max(1, self._loader.windows_per_epoch // batch))

    def __call__(self, params) -> dict:
        self._loader.seek(0)
        nll_total, n_total = 0.0, 0
        for _ in range(self._n):
            x, y = self._loader.next()
            nll, n = self._step(params, batch_from_host(
                x, y, self._cfg, self._mesh,
                packed_eos_id=self._packed_eos_id, device=self._device))
            nll_total += float(nll)
            n_total += int(n)
        sums = gather_obj((nll_total, n_total, self._first_replica))
        nll_total = sum(x for x, _, first in sums if first)
        n_total = sum(n for _, n, first in sums if first)
        loss = nll_total / max(n_total, 1)
        return {"eval_loss": loss, "ppl": math.exp(min(loss, 50.0))}

    def close(self):
        self._loader.close()


def evaluate(params, cfg: ModelConfig, mesh, data_path, *, batch: int,
             seq_len: int, max_batches: int = 32, device=None):
    """One-shot convenience wrapper around Evaluator."""
    ev = Evaluator(cfg, mesh, data_path, batch=batch, seq_len=seq_len,
                   max_batches=max_batches, device=device)
    try:
        return ev(params)
    finally:
        ev.close()
