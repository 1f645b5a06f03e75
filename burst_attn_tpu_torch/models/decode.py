"""Autoregressive inference with a dense KV cache, sampling, and the
prompt attention the serving paths share (port of
burst_attn_tpu/models/decode.py).

  * The cache is a pair of preallocated [B, Nkv, max_seq, D] buffers per
    layer; each forward writes its tokens' K/V at the current length IN
    PLACE (the JAX function returns a new cache; here the same buffers are
    returned, so call sites keep the JAX shape `logits, cache = ...`).
  * `prefill` absorbs a prompt in one pass through the flash kernel (a
    CUDA tensor) or the plain tile (a CPU one); later tokens attend the
    cache in plain torch with the grouped query axis, as the JAX path does
    outside its kernels.  A sliding `cfg.window` bands both.
  * `generate` is a Python loop over single-token forwards (JAX's
    lax.scan); greedy or sampled through `sample_logits`.
  * models/speculative.py decodes speculatively over this cache: its
    verify is one multi-token `forward_cached`, its rollback a shorter
    `Cache.length`.
  * Parameters split over tp (transformer.shard_params; the tree carries
    its mesh, so the signatures take none, as JAX's take sharded arrays)
    run each tp position on its heads: the cache is split over kv heads
    (each buffer stacked [tp, B, Nkv / tp, max_seq, D]), a prompt runs
    the flash kernel once a position, the row-parallel sums meet in
    all_reduce and the logits are all_gathered.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from ..ops.flash import flash_attention
from ..ops.tile import single_device_attention
from .transformer import (
    ModelConfig, ShardedParams, _attn_out, _embed, _logits, _mlp,
    _qkv_from_h, _rms_norm, check_serving, params_device, tp_parts, tp_sum,
)


class LayerCache(NamedTuple):
    k: torch.Tensor  # [B, Nkv, max_seq, D] (tp: [tp, B, Nkv / tp, ...])
    v: torch.Tensor  # [B, Nkv, max_seq, D]


class Cache(NamedTuple):
    layers: Tuple[LayerCache, ...]
    length: int  # valid cache positions (a host int: no device read)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None, tp: int = 1) -> Cache:
    """Zeroed [batch, Nkv, max_seq, D] K/V buffers per layer in cfg.dtype,
    length 0; with `tp` > 1 each stacked [tp, batch, Nkv / tp, max_seq,
    D], tp position t's kv heads the contiguous [t]."""
    dev = resolve_device(device)
    shape = (batch, cfg.n_kv_heads, max_seq, cfg.d_head)
    if tp > 1:
        shape = (tp, batch, cfg.n_kv_heads // tp, max_seq, cfg.d_head)
    layers = tuple(
        LayerCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev))
        for _ in range(cfg.n_layers))
    return Cache(layers, 0)


def _flash_prompt_attention(q, k, v, window=None):
    """Causal self-attention over a fresh prompt, q [B, N, T, D], k/v
    [B, Nkv, T, D] -> o [B, N, T, D]; `window` bands it.  A CUDA tensor
    takes the flash kernel, which masks the ragged tail itself (no padding
    to a tile multiple) and skips the tiles below the band; a CPU tensor
    takes the plain single_device_attention."""
    if q.device.type == "cuda":
        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), None, True, window=window)
    return single_device_attention(q, k, v, causal=True, window=window)


def _cached_attention(p, x, positions, lc: LayerCache, cache_len: int,
                      cfg: ModelConfig, fresh: bool = False):
    """Attend the T new tokens against cache positions [0, cache_len + T),
    writing their K/V at cache_len IN PLACE; returns the block's attention
    output [B, T, d].  `fresh` marks an empty cache: the prompt attends
    only to itself, through the flash path.  A layer split over tp runs
    each position on its heads and its shard of the cache, and
    all_reduces the wo partial sums."""
    t = x.shape[1]
    h = _rms_norm(x, p["attn_norm"])
    parts = tp_parts(p)
    outs = []
    for i, pt in enumerate(parts):
        kc, vc = (lc.k, lc.v) if len(parts) == 1 else (lc.k[i], lc.v[i])
        q, k, v = _qkv_from_h(pt, h, positions, cfg)
        kc[:, :, cache_len:cache_len + t] = k.to(kc.dtype)
        vc[:, :, cache_len:cache_len + t] = v.to(vc.dtype)
        if fresh:
            o = _flash_prompt_attention(q, k.to(kc.dtype), v.to(vc.dtype),
                                        window=cfg.window)
        else:
            o = _grouped_cache_attention(q, kc, vc, cache_len, cfg)
        outs.append(_attn_out(pt, o))
    return tp_sum(outs, cfg.head_axis)


def _grouped_cache_attention(q, kc, vc, cache_len: int, cfg: ModelConfig):
    """q [B, N, T, D] over the cache kc, vc [B, Nkv, max_seq, D] (rows at
    positions cache_len ..): GQA via a grouped query axis, the cache
    never repeated; plain torch, as the JAX path outside its kernels."""
    b, n, t, d = q.shape
    n_kv = kc.shape[1]
    qg = q.reshape(b, n_kv, n // n_kv, t, d)
    s = torch.einsum("bngih,bnjh->bngij", qg.float(),
                     kc.float()) * (cfg.d_head ** -0.5)
    rows = torch.arange(t, device=q.device)[:, None]
    cols = torch.arange(kc.shape[2], device=q.device)[None, :]
    visible = cols <= cache_len + rows
    if cfg.window is not None:
        # the query at position cache_len + row sees its last `window`
        visible = visible & (cols > cache_len + rows - cfg.window)
    s = s.masked_fill(~visible, float("-inf"))
    prob = torch.softmax(s, dim=-1).to(vc.dtype)
    o = torch.einsum("bngij,bnjh->bngih", prob, vc)
    return o.reshape(b, n, t, d)


def _forward_cached_impl(params, tokens, positions, cache: Cache,
                         cfg: ModelConfig, *, fresh: bool):
    """`fresh` asserts the cache is EMPTY (only `prefill` passes it): the
    prompt then takes the O(T)-memory flash path, which ignores cache
    contents."""
    x = _embed(params, tokens, cfg)
    for p, lc in zip(params["layers"], cache.layers):
        x = x + _cached_attention(p, x, positions, lc, cache.length, cfg,
                                  fresh=fresh)
        x = x + _mlp(p, x, cfg, inference=True)[0]
    logits = _logits(_rms_norm(x, params["final_norm"]), params["lm_head"])
    return logits, Cache(cache.layers, cache.length + tokens.shape[1])


def forward_cached(params, tokens, positions, cache: Cache,
                   cfg: ModelConfig):
    """One cached forward over T new tokens: tokens, positions [B, T] int
    (natural order) -> (fp32 logits [B, T, vocab], the cache with length
    += T; its buffers were written in place)."""
    check_serving(cfg)
    if cache.length + tokens.shape[1] > cache.layers[0].k.shape[-2]:
        raise ValueError(f"{tokens.shape[1]} tokens at length "
                         f"{cache.length} exceed max_seq "
                         f"{cache.layers[0].k.shape[-2]}")
    return _forward_cached_impl(params, tokens, positions, cache, cfg,
                                fresh=False)


def prefill(params, tokens, cfg: ModelConfig, max_seq: int):
    """Absorb a [B, T] prompt in one pass into a fresh cache on the
    tokens' device.  Returns (fp32 logits [B, T, vocab], cache)."""
    check_serving(cfg)
    b, t = tokens.shape
    if t > max_seq:
        raise ValueError(f"prompt length {t} exceeds max_seq {max_seq}")
    cache = init_cache(cfg, b, max_seq, device=tokens.device,
                       tp=params.tp if isinstance(params, ShardedParams)
                       else 1)
    positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
    return _forward_cached_impl(params, tokens, positions, cache, cfg,
                                fresh=True)


def generate(params, prompt, cfg: ModelConfig, *, steps: int, max_seq: int,
             temperature: float = 0.0, top_k=None, top_p=None,
             rng: Optional[torch.Generator] = None):
    """Greedy (temperature=0) or sampled generation: prompt [B, T] int on
    the params' device -> [B, steps] int64 tokens.  The first token comes
    from the prefill's last logits, each later one from a single-token
    cached forward (JAX's scan body); sampled draws come from `rng`."""
    check_serving(cfg)
    prompt = torch.as_tensor(prompt, device=params_device(params)).long()
    b = prompt.shape[0]
    if prompt.shape[1] + steps > max_seq:
        raise ValueError("prompt + steps exceeds max_seq")
    if steps < 1:
        return prompt.new_zeros((b, 0))

    def pick(logits_last):
        return sample_logits(logits_last, rng, temperature=temperature,
                             top_k=top_k, top_p=top_p)

    with torch.no_grad():
        logits, cache = prefill(params, prompt, cfg, max_seq)
        toks = [pick(logits[:, -1])]
        for _ in range(steps - 1):
            positions = torch.full((b, 1), cache.length,
                                   device=prompt.device)
            logits, cache = forward_cached(params, toks[-1][:, None],
                                           positions, cache, cfg)
            toks.append(pick(logits[:, -1]))
    return torch.stack(toks, dim=1)


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
    stepped without capacity, and the engine raises on the sentinel.

    The draw is torch.multinomial's own one-sample algorithm written out
    (argmax of p / q, q ~ Exp(1) from `generator`): the same tokens from
    the same generator state, without multinomial's host-side checks of
    p, so a sampled tick never waits on the device and can be captured
    in a CUDA graph."""
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
    probs = torch.softmax(logits, dim=-1)
    noise = torch.empty_like(probs).exponential_(1, generator=generator)
    tok = torch.argmax(probs / noise, dim=-1)
    return tok if bad is None else torch.where(bad, -1, tok)


def skip_draws(generator, shape, n: int, device) -> None:
    """Advance `generator` past n of sample_logits' draws for [B, V]
    logits of `shape` (temperature > 0), sampling nothing: the same noise
    draws, discarded.  The pipelined engine rewinds a fused launch cut at
    an EOS this way: restore the state from before the launch, then skip
    the ticks it keeps."""
    if generator is None:
        return
    for _ in range(n):
        torch.empty(shape, dtype=torch.float32, device=device).exponential_(
            1, generator=generator)
