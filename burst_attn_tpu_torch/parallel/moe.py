"""Mixture-of-Experts with expert parallelism (port of
burst_attn_tpu/parallel/moe.py).

The JAX module routes with dense one-hot tensors, dispatch and combine
[T, E, C] (token t -> slot c of expert e), and two einsums.  Here the
same slot assignment is kept and the one-hot products become gathers,
which is exact (a one-hot sum has one nonzero term; the combine adds the
k gate-weighted expert rows in fp32):

  router logits  [T, E] fp32 -> softmax -> top-k gates, renormalized
  slot assignment: within each k-level priority goes by token order, the
                 k-levels run one after another; a (token, choice) past
                 its expert's capacity C is DROPPED
  expert inputs  h [E, C, d]: each slot gathers its token's row (an empty
                 slot points at a zero row)
  expert outputs per-expert SwiGLU on [E, C, d] (three batched products)
  combined       y [T, d]: each token gathers its k slots' outputs and
                 weights them by its gates (a dropped choice reads the
                 zero row)

Every shape is static and nothing reads the device: no `nonzero`, no
boolean indexing, no `.item()`, so the serving paths can capture the
layer in a CUDA graph and run it under the sync-debug mode.  The
load-balancing loss is the Switch aux loss, E * sum_e(mean top-1
one-hot_e * mean prob_e), returned with the share of dropped choices.

Expert parallelism (`moe_apply(mesh={"ep": W})`): W positions sharing one
device each route their contiguous share of the tokens; `mesh.all_to_all`
regroups [E, C, d] so position p holds its E/W experts' slots from every
peer ([E/W, C*W, d]), the local experts run, and a second all-to-all
sends the results home.  aux and dropped are averaged over the positions
(the JAX package's pmean).
"""

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .mesh import Mesh, all_to_all


class MoEParams(NamedTuple):
    router: torch.Tensor   # [d, E] fp32
    w_gate: torch.Tensor   # [E, d, f]
    w_up: torch.Tensor     # [E, d, f]
    w_down: torch.Tensor   # [E, f, d]


def init_moe_params(seed, d: int, d_ff: int, n_experts: int,
                    dtype=torch.float32, device=None) -> MoEParams:
    """normal(std 0.02) expert weights in `dtype` and an fp32 router from
    a numpy seed (an int, or a numpy Generator to draw from).  Same names
    and shapes as the JAX init_moe_params (the values differ)."""
    dev = resolve_device(device)
    rng = (seed if isinstance(seed, np.random.Generator)
           else np.random.default_rng(seed))

    def normal(shape, dt):
        w = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        return torch.from_numpy(w).to(device=dev, dtype=dt)

    return MoEParams(
        router=normal((d, n_experts), torch.float32),
        w_gate=normal((n_experts, d, d_ff), dtype),
        w_up=normal((n_experts, d, d_ff), dtype),
        w_down=normal((n_experts, d_ff, d), dtype),
    )


class Routing(NamedTuple):
    slot_tok: torch.Tensor   # [E, C] int64: token of each slot, T = empty
    tok_slot: torch.Tensor   # [T, K] int64: flat slot e*C + c, E*C = dropped
    gates: torch.Tensor      # [T, K] fp32, renormalized over the k chosen
    aux: torch.Tensor        # () fp32 Switch load-balancing loss
    dropped: torch.Tensor    # () fp32 share of (token, choice) pairs dropped


def route(x, router, top_k: int, capacity: int) -> Routing:
    """Slot assignment of [T, d] tokens (the JAX `_routing`, with index
    tensors in place of the one-hot dispatch and combine)."""
    t = x.shape[0]
    e = router.shape[1]
    dev = x.device
    probs = torch.softmax(x.float() @ router.float(), dim=-1)   # [T, E]
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)    # [T, K]
    gates = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    experts = torch.arange(e, device=dev)
    tok = torch.arange(t, device=dev)
    # column C of each expert absorbs the overflow (then cut away)
    slot_tok = torch.full((e * (capacity + 1),), t, dtype=torch.long,
                          device=dev)
    fill = torch.zeros(e, 1, dtype=torch.int32, device=dev)
    kept = torch.zeros((), dtype=torch.float32, device=dev)
    tok_slot = []
    for k in range(top_k):
        ek = expert_idx[:, k]
        # expert-major [E, T], so the running count is an inner-dim scan
        onehot = (experts[:, None] == ek[None, :]).int()
        pos = fill + torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
        pos_tok = (pos * onehot).sum(dim=0)                       # [T]
        in_cap = pos_tok < capacity
        slot_tok.scatter_(0, ek * (capacity + 1)
                          + torch.where(in_cap, pos_tok, capacity), tok)
        tok_slot.append(torch.where(in_cap, ek * capacity + pos_tok,
                                    e * capacity))
        fill = fill + (onehot * in_cap[None, :]).sum(dim=1, keepdim=True,
                                                      dtype=torch.int32)
        kept = kept + in_cap.sum()
    top1 = (expert_idx[:, :1] == experts[None, :]).float()
    aux = e * torch.sum(top1.mean(dim=0) * probs.mean(dim=0))
    dropped = 1.0 - kept / (t * top_k)
    return Routing(slot_tok.view(e, capacity + 1)[:, :capacity],
                   torch.stack(tok_slot, dim=1), gates, aux, dropped)


def dispatch(x, r: Routing):
    """Expert inputs h [E, C, d] in x's dtype: each slot's token row, an
    empty slot a zero row.  (index_select: its backward is an index_add,
    not the sorting backward of advanced indexing.)"""
    e, c = r.slot_tok.shape
    rows = torch.cat([x, x.new_zeros(1, x.shape[1])])
    return rows.index_select(0, r.slot_tok.reshape(-1)).view(e, c, -1)


def combine(out, r: Routing, dtype):
    """y [T, d] in `dtype`: each token's k slot outputs out [E, C, d]
    weighted by its gates, summed in fp32 (a dropped choice adds 0)."""
    flat = out.reshape(-1, out.shape[-1])
    flat = torch.cat([flat, flat.new_zeros(1, flat.shape[1])])
    y = 0
    for k in range(r.tok_slot.shape[1]):
        y = y + r.gates[:, k, None] * flat.index_select(
            0, r.tok_slot[:, k]).float()
    return y.to(dtype)


def expert_mlp(w_gate, w_up, w_down, h):
    """SwiGLU per expert: h [E, C, d] -> [E, C, d] (three batched
    products)."""
    g = torch.bmm(h, w_gate)
    u = torch.bmm(h, w_up)
    return torch.bmm(F.silu(g) * u, w_down)


def moe_shard(p: MoEParams, x, *, top_k: int, capacity: int):
    """Dense MoE of one routing group, [T, d] tokens -> (y [T, d] in x's
    dtype, aux, dropped)."""
    r = route(x, p.router, top_k, capacity)
    out = expert_mlp(p.w_gate, p.w_up, p.w_down, dispatch(x, r))
    return combine(out, r, x.dtype), r.aux, r.dropped


def capacity_for(tokens: int, experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-group expert slot count: the JAX package's rounding policy
    (moe_apply and the LM's _mlp both size their groups with it)."""
    return max(1, int(capacity_factor * top_k * tokens / experts))


def moe_apply(p: MoEParams, x, *, mesh=None, axis: Optional[str] = "ep",
              top_k: int = 2, capacity_factor: float = 1.25):
    """MoE layer on [B, T, d] (or [T, d]) tokens -> (y, aux, dropped).

    Without a mesh (or axis): one routing group of all B*T tokens.  With
    `mesh` ({"ep": W} or a Mesh) and `axis`: W expert positions on the
    tokens' device; position p routes tokens [p*T/W, (p+1)*T/W) of every
    row (capacity per local token count) and runs experts [p*E/W,
    (p+1)*E/W) on every position's slots, through two all-to-alls."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    b, t, d = x.shape
    e = p.router.shape[1]
    if mesh is None or axis is None:
        cap = capacity_for(b * t, e, top_k, capacity_factor)
        y, aux, dropped = moe_shard(p, x.reshape(b * t, d), top_k=top_k,
                                    capacity=cap)
        y = y.reshape(b, t, d)
        return (y[0] if squeeze else y), aux, dropped
    shape = mesh.shape if isinstance(mesh, Mesh) else dict(mesh)
    ep = int(shape.get(axis, 1))
    if e % ep:
        raise ValueError(f"experts {e} not divisible by ep axis size {ep}")
    if t % ep:
        raise ValueError(f"tokens {t} not divisible by ep axis size {ep}")
    cap = capacity_for(b * t // ep, e, top_k, capacity_factor)
    xs = [c.reshape(-1, d) for c in x.chunk(ep, dim=1)]
    rs = [route(xp, p.router, top_k, cap) for xp in xs]
    # [E, C, d] a position -> [E/ep, C*ep, d]: its experts' slots of
    # every peer
    hs = all_to_all([dispatch(xp, r) for xp, r in zip(xs, rs)],
                    split_dim=0, concat_dim=1, axis=axis)
    el = e // ep
    outs = [expert_mlp(*(w[i * el:(i + 1) * el]
                         for w in (p.w_gate, p.w_up, p.w_down)), h)
            for i, h in enumerate(hs)]
    outs = all_to_all(outs, split_dim=1, concat_dim=0, axis=axis)
    y = torch.cat([combine(o, r, x.dtype).reshape(b, t // ep, d)
                   for o, r in zip(outs, rs)], dim=1)
    aux = torch.stack([r.aux for r in rs]).mean()
    dropped = torch.stack([r.dropped for r in rs]).mean()
    return (y[0] if squeeze else y), aux, dropped
