"""Sampling and prompt attention for inference (port of the parts of
burst_attn_tpu/models/decode.py the serving path uses)."""

from typing import Optional

import torch

from ..ops.flash import flash_attention
from ..ops.tile import single_device_attention


def _flash_prompt_attention(q, k, v):
    """Causal self-attention over a fresh prompt, q [B, N, T, D], k/v
    [B, Nkv, T, D] -> o [B, N, T, D].  A CUDA tensor takes the flash
    kernel, which masks the ragged tail itself (no padding to a tile
    multiple); a CPU tensor takes the plain single_device_attention."""
    if q.device.type == "cuda":
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), None, True)
    return single_device_attention(q, k, v, causal=True)


def sample_logits(logits, generator: Optional[torch.Generator] = None, *,
                  temperature: float = 0.0, top_k=None, top_p=None,
                  nan_sentinel: bool = False):
    """[B, V] logits -> [B] sampled token ids (int64, on logits' device).

    temperature == 0 is greedy (top_k/top_p ignored; ties go to the first
    index, as in JAX).  Otherwise softmax sampling at `temperature`, after
    optional top-k truncation and/or top-p (nucleus) truncation — the kept
    set is the smallest prefix of the sorted distribution whose probability
    reaches top_p.  Random draws come from `generator` (a torch.Generator
    on logits' device): they are not jax.random's bits, so sampled paths
    are held to JAX by distribution, not token by token.

    nan_sentinel=True makes rows containing NaN sample -1: the paged
    decode step poisons a slot's logits with NaN when a live slot was
    stepped without capacity, and the engine raises on the sentinel."""
    bad = torch.isnan(logits).any(dim=-1) if nan_sentinel else None
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1)
        return tok if bad is None else torch.where(bad, -1, tok)
    if bad is not None:
        # keep the sampler's input finite for the poisoned rows
        logits = torch.where(bad[:, None], 0.0, logits)
    logits = logits.float() / temperature
    if top_k is not None:
        k_eff = min(int(top_k), logits.shape[-1])  # top_k > vocab = keep all
        kth = torch.sort(logits, dim=-1).values[:, -k_eff][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum_before = torch.cumsum(probs, dim=-1) - probs
        keep = cum_before < top_p  # always keeps the argmax
        thresh = torch.where(keep, sorted_desc, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < thresh, float("-inf"))
    tok = torch.multinomial(torch.softmax(logits, dim=-1), 1,
                            generator=generator)[:, 0]
    return tok if bad is None else torch.where(bad, -1, tok)
