"""Speculative decoding (draft-verify) over the dense KV cache (port of
burst_attn_tpu/models/speculative.py).

A small DRAFT model proposes k tokens autoregressively; the TARGET model
scores all k+1 positions in ONE cached forward pass (`forward_cached`
takes multi-token appends) and keeps the longest prefix of proposals that
matches its own greedy choice, plus one token of its own (the correction
at the first mismatch, or the bonus after k acceptances).  Greedy output
is token-exact with plain greedy decoding of the target: the draft only
changes how many target passes are needed.

`Cache.length` is a host int and the only rollback state: K/V written
past it are invisible (the visibility mask keys on length) and are
overwritten in place by the next append, so rejecting proposals costs a
new `Cache` tuple over the same buffers, not a copy.

Two acceptance rules share the cache machinery:

* greedy (`temperature == 0`): accept while the proposal equals the
  target's argmax.
* sampled (`temperature > 0`): Leviathan-style rejection sampling —
  accept proposal x with probability min(1, p(x)/q(x)) (p = target, q =
  draft distribution at that position); on rejection, sample the residual
  normalize(max(p - q, 0)).  The output distribution equals sampling the
  target directly, for any draft.  The draws come from a torch.Generator,
  not jax.random, so sampled runs match the JAX package by distribution.

On a CUDA device both prompts go through the flash kernel (`prefill`);
the draft steps and the verify are plain torch over the dense cache, as
the JAX package computes them outside any kernel.
"""

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .decode import Cache, forward_cached, prefill, sample_logits
from .transformer import ModelConfig


class SpecStats(NamedTuple):
    proposed: int       # draft tokens proposed
    accepted: int       # draft tokens accepted by the target
    target_passes: int  # target forward passes (vs `steps` for plain decode)


def _feed(params, cache: Cache, tokens, cfg: ModelConfig):
    """Append T tokens (1-D tensor) to the cache at positions length ..
    length + T - 1; returns ([T, vocab] fp32 logits, cache)."""
    positions = cache.length + torch.arange(tokens.shape[0],
                                            device=tokens.device)
    logits, cache = forward_cached(params, tokens[None], positions[None],
                                   cache, cfg)
    return logits[0], cache


def _draft_propose(params, cache: Cache, last, cfg: ModelConfig, kk: int,
                   temperature: float, rng: Optional[torch.Generator]):
    """kk single-token draft steps from `last` ([1] tensor), with nothing
    read back to the host.  temperature == 0: greedy, q is None.  Else
    each token is sampled at `temperature` by sample_logits and q holds
    its fp32 distribution softmax(row / temperature), from the same fp32
    row the draw saw (the acceptance rule needs p/q ratios computed in
    fp32 on both sides).  Returns (tokens [kk], q [kk, V] or None,
    cache)."""
    toks: List[torch.Tensor] = []
    qs: List[torch.Tensor] = []
    tok = last
    for _ in range(kk):
        logits, cache = _feed(params, cache, tok, cfg)
        row = logits[-1].float()
        if temperature > 0.0:
            tok = sample_logits(row[None], rng, temperature=temperature)
            qs.append(torch.softmax(row / temperature, dim=-1))
        else:
            tok = torch.argmax(row)[None]
        toks.append(tok)
    return torch.cat(toks), (torch.stack(qs) if qs else None), cache


def _residual_accept(p_rows, q_rows, drafts, rng: Optional[torch.Generator]
                     ) -> Tuple[int, int]:
    """Leviathan acceptance on the host side of the round boundary.

    p_rows [kk+1, V] target probs, q_rows [kk, V] draft probs, drafts
    [kk] proposed tokens.  Returns (n_acc, next_token): proposals accept
    while u < p(x)/q(x); the first rejection samples the residual
    normalize(max(p - q, 0)); after kk acceptances the bonus token
    samples p_rows[kk].  Each position's token is distributed exactly as
    the target's.

    The kk+1 uniforms (one per accept test plus one for the residual or
    bonus draw) come from `rng` in ONE call, each row block reaches the
    host in ONE transfer, and the per-token loop is float64 numpy."""
    kk = len(drafts)
    dev = p_rows.device if rng is None else rng.device
    u = torch.rand(kk + 1, generator=rng, device=dev,
                   dtype=torch.float64).cpu().numpy()
    p = p_rows.cpu().numpy().astype(np.float64)
    q = q_rows.cpu().numpy().astype(np.float64)

    def inv_cdf(probs, x):  # one uniform -> one sample
        c = np.cumsum(probs)
        return int(np.searchsorted(c, x * c[-1], side="right").clip(
            0, len(probs) - 1))

    for i in range(kk):
        x = int(drafts[i])
        if u[i] < p[i, x] / max(q[i, x], 1e-30):
            continue
        resid = np.maximum(p[i] - q[i], 0.0)
        if resid.sum() <= 0.0:
            # p <= q everywhere yet x rejected: numerically degenerate
            # (p == q); sample the target row directly
            resid = p[i]
        return i, inv_cdf(resid, u[kk])
    return kk, inv_cdf(p[kk], u[kk])


def speculative_generate(params_target, params_draft, prompt,
                         cfg_target: ModelConfig, cfg_draft: ModelConfig,
                         *, steps: int, k: int = 4, max_seq: int,
                         temperature: float = 0.0,
                         rng: Optional[torch.Generator] = None,
                         return_stats: bool = False):
    """Speculative decode.  prompt [1, T] int (on the target params'
    device); returns [steps] generated tokens as an int32 numpy array (and
    SpecStats with return_stats=True).  temperature == 0 is greedy
    (token-exact with generate()); temperature > 0 samples with the
    Leviathan acceptance rule, drawing from `rng` (a torch.Generator on
    the params' device; seed 0 when None).

    The draft and target must share a vocabulary; everything else (depth,
    width, GQA) may differ."""
    if cfg_target.vocab != cfg_draft.vocab:
        raise ValueError("draft and target must share a vocabulary")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    dev = params_target["embed"].device
    prompt = torch.as_tensor(prompt, device=dev).long()
    if prompt.dim() != 2 or prompt.shape[0] != 1:
        raise ValueError("speculative decode is single-sequence (B=1)")
    if prompt.shape[1] + steps + k + 1 > max_seq:
        raise ValueError("prompt + steps + k + 1 exceeds max_seq")
    sampled = temperature > 0.0
    if sampled and rng is None:
        rng = torch.Generator(device=dev)
        rng.manual_seed(0)

    proposed = accepted = target_passes = 0
    with torch.no_grad():
        logits_t, cache_t = prefill(params_target, prompt, cfg_target,
                                    max_seq)
        _, cache_d = prefill(params_draft, prompt, cfg_draft, max_seq)
        out = [int(sample_logits(logits_t[:, -1], rng,
                                 temperature=temperature)[0])]
        # invariant: each cache holds K/V for prompt + out[:-1]; out[-1]
        # is the newest token, not yet fed to either model
        while len(out) < steps:
            kk = min(k, steps - len(out))
            base = cache_t.length
            last = torch.tensor([out[-1]], device=dev)
            draft_toks, q_rows, cache_d = _draft_propose(
                params_draft, cache_d, last, cfg_draft, kk, temperature, rng)
            proposed += kk
            # the target scores all kk+1 positions in one pass
            lg_t, cache_t = _feed(params_target, cache_t,
                                  torch.cat([last, draft_toks]), cfg_target)
            target_passes += 1
            if sampled:
                drafts = draft_toks.tolist()
                p_rows = torch.softmax(lg_t.float() / temperature, dim=-1)
                n_acc, nxt = _residual_accept(p_rows, q_rows, drafts, rng)
            else:
                # the round's one host read: proposals + target choices
                both = torch.cat([draft_toks, torch.argmax(lg_t, dim=-1)])
                both = both.tolist()
                drafts, choice = both[:kk], both[kk:]
                n_acc = 0
                while n_acc < kk and drafts[n_acc] == choice[n_acc]:
                    n_acc += 1
                nxt = choice[n_acc]  # correction or bonus
            accepted += n_acc
            out += drafts[:n_acc]
            out.append(int(nxt))
            # roll both caches back to prompt + out[:-1]: the same buffers
            # at a shorter length (K/V past it are overwritten unread)
            new_len = base + n_acc + 1
            cache_t = Cache(cache_t.layers, new_len)
            if n_acc == kk:
                # all accepted: the draft (which fed out[-2] + drafts[:-1])
                # is one token BEHIND the invariant: feed the last proposal
                _, cache_d = _feed(params_draft, cache_d, draft_toks[-1:],
                                   cfg_draft)
            else:
                # rejected tail: the draft ran ahead; a length rollback
                # discards it
                cache_d = Cache(cache_d.layers, new_len)
    tokens = np.asarray(out[:steps], np.int32)
    if return_stats:
        return tokens, SpecStats(proposed, accepted, target_passes)
    return tokens
