"""The draft side of speculative serving, shared by ServeEngine
(models/serve.py) and RaggedServeEngine (serving/engine.py).

`Draft` is an engine's draft model: its params and config, its own paged
state and pool (the target's slot geometry and pool dtype), spec_k and
the round accounting.  A round for every live slot is

  1. `Draft.propose`: k greedy proposals by single paged decode steps
     (kernel 6 on the card), then the catch-up step feeding the last
     proposal; nothing is read back;
  2. the engine's verify of [last | proposals] at QT = k+1 on the target
     (kernel 7 on the card);
  3. `Draft.accept`: ONE host read, per-slot prefix acceptance with budget
     and EOS trims, the draft's lengths rolled back; the engine rolls its
     target back by the same counts.

`SpecCounters` gives an engine the JAX engines' counters (`spec_k`,
`spec_proposed`, `spec_accepted`, `spec_rounds`, `acceptance_rate`).
"""

from typing import Optional

import numpy as np
import torch

from .paged_decode import (
    init_paged_state, paged_decode_step, paged_prefill, provision_capacity,
    retire_slot,
)
from .transformer import ModelConfig


class Draft:
    """A draft model attached to a serving engine.  Validates it as the
    JAX engines do; a draft sharing the target's lm_head (a self-draft, an
    early exit) shares the engine's fp32 copy of it (`engine_params`)."""

    def __init__(self, engine_params, params, draft_params,
                 cfg: ModelConfig, draft_cfg: Optional[ModelConfig], *,
                 temperature: float, spec_k: int, slots: int, n_pages: int,
                 page: int, max_pages_per_seq: int, quantize, device):
        if draft_cfg is None:
            raise ValueError("draft_params needs draft_cfg")
        if temperature != 0.0:
            raise ValueError("speculative serving requires temperature == 0")
        if draft_cfg.vocab != cfg.vocab:
            raise ValueError("draft and target must share a vocabulary")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        head = draft_params["lm_head"]
        head = (engine_params["lm_head"] if head is params["lm_head"]
                else head.float())
        self.params = dict(draft_params, lm_head=head)
        self.cfg = draft_cfg
        self.k = spec_k
        self.state, self.pool = init_paged_state(
            draft_cfg, slots=slots, n_pages=n_pages, page=page,
            max_pages_per_seq=max_pages_per_seq, quantize=quantize,
            device=device)
        # proposed counts every draft token the target scored, accepted
        # those its argmax MATCHED (before budget and EOS trims)
        self.proposed = self.accepted = self.rounds = 0

    @property
    def slack(self) -> int:
        """Tokens a verify appends past a request's budget before its
        rollback: both pools' capacity must cover them."""
        return self.k + 1

    @property
    def acceptance_rate(self) -> Optional[float]:
        if self.proposed == 0:
            return None
        return self.accepted / self.proposed

    def prefill(self, prompt, slot: int, max_new: int) -> None:
        """The draft's whole prompt into `slot`, with capacity for the
        request's budget plus the slack."""
        paged_prefill(self.params, prompt, self.state, self.pool, slot,
                      self.cfg)
        provision_capacity(self.state, self.pool, slot, max_new + self.slack)

    def retire(self, slot: int) -> None:
        retire_slot(self.state, self.pool, slot)

    def propose(self, first):
        """k greedy proposals for every live slot from `first` ([slots]
        next tokens, on the device), then the catch-up step, so the draft
        holds [first | proposals] as the target will after its verify.
        Returns ([slots, k] proposals, [slots] NaN flags of the proposal
        steps)."""
        cur, toks = first, []
        bad = torch.zeros(first.shape, dtype=torch.bool, device=first.device)
        for _ in range(self.k):
            lg, _ = paged_decode_step(self.params, cur, self.state, self.cfg)
            bad |= torch.isnan(lg).any(dim=-1)
            cur = torch.argmax(lg, dim=-1)
            toks.append(cur)
        paged_decode_step(self.params, cur, self.state, self.cfg)
        return torch.stack(toks, dim=1), bad

    def accept(self, slots, d_toks, logits, bad, eos_id: Optional[int],
               next_tok: np.ndarray, journal=None) -> np.ndarray:
        """The host half of a round: ONE read of the proposals d_toks
        [slots, k], the target's choices (argmax of the verify logits
        [slots, k+1, vocab]) and the NaN flags (`bad` or NaN verify
        logits).  Each live request (slots[s] not None) keeps its longest
        prefix of proposals matching the target plus one target token,
        trimmed to its budget and its first EOS; next_tok[s] becomes its
        last kept token.  The draft's lengths go down by what was not kept
        (a live slot keeps >= 1 token); returns those counts, [slots], for
        the target's rollback.  `journal` (a TokenJournal or None) gets each
        request's kept tokens as they are appended, in slot order."""
        k = self.k
        bad = bad | torch.isnan(logits).any(dim=2).any(dim=1)
        host = torch.cat([d_toks, torch.argmax(logits, dim=-1),
                          bad[:, None].long()], dim=1).cpu().numpy()
        undo = np.zeros(len(slots), np.int32)
        for slot, req in enumerate(slots):
            if req is None:
                continue
            drafts, choice = host[slot, :k], host[slot, k:2 * k + 1]
            if host[slot, -1]:
                raise RuntimeError(
                    f"slot {slot} (rid {req.rid}) speculative logits are "
                    "NaN-poisoned: stepped without provisioned capacity")
            n_acc = 0
            while n_acc < k and drafts[n_acc] == choice[n_acc]:
                n_acc += 1
            self.proposed += k
            self.accepted += n_acc
            new = [int(x) for x in drafts[:n_acc]] + [int(choice[n_acc])]
            # budget and EOS trims (a round can overshoot both)
            new = new[:req.max_new_tokens - len(req.tokens)]
            if eos_id is not None and eos_id in new:
                new = new[:new.index(eos_id) + 1]
            req.tokens += new
            if journal is not None:
                journal.tokens(req.rid, new)
            next_tok[slot] = new[-1]
            undo[slot] = k + 1 - len(new)
        self.rounds += 1
        self.state.lengths.sub_(torch.from_numpy(undo).to(
            self.state.lengths.device))
        return undo


class SpecCounters:
    """The JAX engines' speculative counters, read from the engine's
    `draft` (None: no draft attached)."""

    draft: Optional[Draft]

    @property
    def spec_k(self) -> int:
        return self.draft.k if self.draft is not None else 0

    @property
    def spec_proposed(self) -> int:
        return self.draft.proposed if self.draft is not None else 0

    @property
    def spec_accepted(self) -> int:
        return self.draft.accepted if self.draft is not None else 0

    @property
    def spec_rounds(self) -> int:
        return self.draft.rounds if self.draft is not None else 0

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Fraction of proposed draft tokens the target's argmax matched
        (before trims), over the engine's lifetime; None before any
        speculative round."""
        if self.draft is None:
            return None
        return self.draft.acceptance_rate
