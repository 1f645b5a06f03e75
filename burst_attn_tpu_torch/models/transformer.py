"""Decoder-only transformer LM (port of burst_attn_tpu/models/transformer.py).

Two forwards: `forward_with_aux` is the training forward (attention
through the differentiable flash kernels on one device, or, when the
mesh's sequence axes hold more than one position, through the
differentiable ring `burst_attn` or, with `attn_strategy="ulysses"`, the
all-to-all `ulysses_attn`; `torch.utils.checkpoint` per block when
`cfg.remat` is set); `forward` is the dense plain reference (attention
through the plain tile) that the serving checks teacher-force against.
With `cfg.pp_axis` set the training forward is the pipeline-parallel one
(models/pipeline_lm.py): the parameters hold STACKED layers (`layers` a
dict of [n_layers, ...] leaves, as init_params makes them) and the mesh
a `pp` axis of stages beside the sequence ring; serving refuses such a
config (check_serving), as the JAX package has no pp serving path.

Parameters are a plain dictionary with the JAX pytree's names and shapes:
{"embed" [V, d], "layers": [{"attn_norm", "wq" [d, N, H], "wk"/"wv"
[d, Nkv, H], "wo" [N, H, d], "mlp_norm", "w_gate"/"w_up" [d, F],
"w_down" [F, d]}], "final_norm", "lm_head" [V, d]}; an MoE layer
(`n_experts > 0`) holds "router" [d, E] fp32 and "w_gate"/"w_up"
[E, d, F], "w_down" [E, F, d] instead (parallel/moe.py).
`params_from_jax` turns the JAX tree (as numpy arrays) into this, so both
packages compute the same function in the tests.

MoE routing groups follow the JAX model's shard_map: in training each
ring (or Ulysses) position's contiguous S/W slice of the layout-order
tokens routes as its own group, with `capacity_for` of its token count,
and the aux loss is the mean over the groups; inference (`_mlp(...,
inference=True)`, every serving path) routes drop-free in chunks of
MOE_CHUNK tokens, each chunk at capacity = its length, which is exact
because drop-free routing is per token.

Numerics follow the JAX model: RMSNorm and rotary in fp32, cast back to
the activation dtype; logits accumulated and returned in fp32.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.flash import flash_attention
from ..ops.masks import check_window
from ..ops.tile import single_device_attention
from ..parallel.burst import burst_attn
from ..parallel.moe import MoEParams, capacity_for, init_moe_params, \
    moe_shard
from ..parallel.ulysses import ulysses_attn

# tokens an inference routing group holds (the JAX _mlp's chunk)
MOE_CHUNK = 512


@dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32768
    d_model: int = 1024
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_head: int = 128
    d_ff: int = 2816
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    # attention / parallelism (both packages take the same
    # configurations): layout, attn_backend and seq_axes drive the ring
    # prefill of serving/handoff.py and the training forward's ring
    # (burst_attn, or ulysses_attn for attn_strategy="ulysses") when the
    # mesh's sequence axes hold more than one position; pp_axis names the
    # pipeline's stage axis (pp_microbatches must divide the batch); dp,
    # tp and ep stay at size 1 (check_mesh)
    causal: bool = True
    attn_strategy: str = "burst"
    layout: str = "zigzag"
    attn_backend: str = "auto"
    # sliding-window causal attention (tokens each query may see, itself
    # included); needs layout="contig" and causal, as in the JAX package
    window: Optional[int] = None
    seq_axes: Tuple[str, ...] = ("sp",)
    batch_axis: Optional[str] = "dp"
    head_axis: Optional[str] = "tp"
    block_q: Optional[int] = None
    block_kv: Optional[int] = None
    remat: bool = True
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    expert_axis: Optional[str] = None
    pp_axis: Optional[str] = None
    pp_microbatches: int = 1

    def __post_init__(self):
        check_window(self.window, self.layout, self.causal)
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} must be a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")


Params = Dict[str, Any]


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random parameters from a numpy seed: normal(std 0.02) matrices in
    cfg.dtype, fp32 norm scales of ones.  Same names and shapes as the JAX
    init_params (the values differ: jax.random draws other numbers)."""
    dev = resolve_device(device)
    d, nh, nkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.d_head, cfg.d_ff)
    rng = np.random.default_rng(seed)

    def dense(*shape):
        w = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        return torch.from_numpy(w).to(device=dev, dtype=cfg.dtype)

    def ones():
        return torch.ones(d, dtype=torch.float32, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": ones(),
            "wq": dense(d, nh, hd),
            "wk": dense(d, nkv, hd),
            "wv": dense(d, nkv, hd),
            "wo": dense(nh, hd, d),
            "mlp_norm": ones(),
        }
        if cfg.n_experts:
            layer.update(init_moe_params(rng, d, f, cfg.n_experts,
                                         dtype=cfg.dtype,
                                         device=dev)._asdict())
        else:
            layer.update(w_gate=dense(d, f), w_up=dense(d, f),
                         w_down=dense(f, d))
        layers.append(layer)
    if cfg.pp_axis is not None:  # the pipeline slices stacked layers
        from .pipeline_lm import stack_layers

        layers = stack_layers(layers)
    return {
        "embed": dense(cfg.vocab, d),
        "layers": layers,
        "final_norm": ones(),
        "lm_head": dense(cfg.vocab, d),
    }


def _to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, device=None) -> Params:
    """The JAX model's parameter tree (arrays convertible by np.asarray)
    as the port's parameter dictionary, dtypes kept (a pp tree's stacked
    `layers` dict stays stacked)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return _to_torch(x, dev)

    return conv(tree)


LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
              "w_up", "w_down")
# an MoE layer's keys: the router joins the experts' weights
MOE_LAYER_KEYS = LAYER_KEYS[:6] + ("router",) + LAYER_KEYS[6:]


def layer_keys(layer) -> Tuple[str, ...]:
    """LAYER_KEYS, or MOE_LAYER_KEYS for a layer with a router."""
    return MOE_LAYER_KEYS if "router" in layer else LAYER_KEYS


def param_leaves(params: Params):
    """Every tensor of a parameter dictionary in one fixed order (embed,
    each layer's layer_keys, final_norm, lm_head; stacked layers: each
    stacked leaf in layer_keys order), whatever the dictionaries'
    insertion order: the optimizer's and checkpoints' order."""
    yield params["embed"]
    layers = params["layers"]
    for layer in [layers] if isinstance(layers, dict) else layers:
        for k in layer_keys(layer):
            yield layer[k]
    yield params["final_norm"]
    yield params["lm_head"]


def _rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embedding. x [B, N, S, H], positions [B, S] (global ids)."""
    h = x.shape[-1]
    exps = torch.arange(0, h, 2, dtype=torch.float32, device=x.device) / h
    freqs = 1.0 / (theta ** exps)
    angles = positions[:, None, :, None].float() * freqs  # [B,1,S,H/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _qkv_proj(p, x, positions, cfg: ModelConfig):
    """Norm + qkv projections + rotary: x [B, S, d] -> q [B, N, S, H],
    k, v [B, Nkv, S, H]."""
    h = _rms_norm(x, p["attn_norm"])
    q = torch.einsum("bsd,dnh->bnsh", h, p["wq"])
    k = torch.einsum("bsd,dnh->bnsh", h, p["wk"])
    v = torch.einsum("bsd,dnh->bnsh", h, p["wv"])
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _attn_out(p, o):
    """Output projection: o [B, N, S, H] -> [B, S, d]."""
    return torch.einsum("bnsh,nhd->bsd", o, p["wo"])


def _mlp(p, x, cfg: Optional[ModelConfig] = None, mesh=None,
         inference: bool = False):
    """The MLP sublayer (pre-norm): dense SwiGLU, or with cfg.n_experts a
    routed MoE.  Returns (out [B, S, d], aux): aux an fp32 0-d tensor
    for MoE, the float 0.0 for the dense MLP (no device op), so callers
    are uniform.

    MoE groups, as the JAX model's shard_map: in training each of the
    ring_world(cfg, mesh) positions routes its contiguous S/W slice of
    the (layout-order) tokens, all B rows, as one group at
    capacity_for(B * S/W tokens), and aux is the mean over the groups.
    `inference=True` (every serving path) routes drop-free in chunks of
    MOE_CHUNK tokens at capacity = the chunk's length: silently zeroing a
    token's MLP output is a training-time trade, and drop-free routing
    is per token, so the chunks give the one-group result."""
    h = _rms_norm(x, p["mlp_norm"])
    if cfg is None or not cfg.n_experts:
        gate = h @ p["w_gate"]
        up = h @ p["w_up"]
        out = (F.silu(gate) * up) @ p["w_down"]
        return out, 0.0
    mp = MoEParams(p["router"], p["w_gate"], p["w_up"], p["w_down"])
    b, s, d = h.shape
    top_k = cfg.moe_top_k
    if inference:
        parts = [moe_shard(mp, hc, top_k=top_k, capacity=hc.shape[0])
                 for hc in h.reshape(b * s, d).split(MOE_CHUNK)]
        y = torch.cat([y for y, _, _ in parts]).reshape(b, s, d)
        return y, torch.stack([a for _, a, _ in parts]).mean()
    groups = ring_world(cfg, mesh)
    cap = capacity_for(b * s // groups, cfg.n_experts, top_k,
                       cfg.moe_capacity_factor)
    parts = [moe_shard(mp, hg.reshape(-1, d), top_k=top_k, capacity=cap)
             for hg in h.chunk(groups, dim=1)]
    y = torch.cat([y.reshape(b, -1, d) for y, _, _ in parts], dim=1)
    return y, torch.stack([a for _, a, _ in parts]).mean()


def _logits(x, lm_head):
    """fp32 logits [..., vocab] (the JAX model's preferred_element_type
    accumulation).  A caller that computes logits every step passes an
    fp32 `lm_head` (ServeEngine does), and the cast costs nothing."""
    return x.float() @ lm_head.float().t()


def _block(x, p, positions, cfg: ModelConfig, mesh=None, stats_out=None,
           segment_ids=None):
    """One decoder block of the training forward: attention, then the MLP
    -> (x, the MLP's aux).  Attention runs the flash kernels (autograd
    `flash_attention`) on one device; when the mesh's sequence axes hold
    more than one position, the ring (autograd `burst_attn` over
    cfg.seq_axes, its layout and backend) or, for attn_strategy
    "ulysses", the all-to-all `ulysses_attn` over cfg.seq_axes[0], as the
    JAX model's `_attention` does; all take the packed-document
    `segment_ids`.  `stats_out`: None, or a list the ring's DevStats is
    appended to (collect_stats: the output is the same)."""
    q, k, v = _qkv_proj(p, x, positions, cfg)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    world = ring_world(cfg, mesh)
    if cfg.attn_strategy == "ulysses" and world > 1:
        o = ulysses_attn(q, k, v, mesh=dict(mesh), seq_axis=cfg.seq_axes[0],
                         causal=cfg.causal, backend=cfg.attn_backend,
                         head_axes=cfg.head_axis, window=cfg.window,
                         segment_ids=segment_ids)
    elif world > 1:
        o = burst_attn(q, k, v, mesh=dict(mesh), seq_axes=cfg.seq_axes,
                       causal=cfg.causal, layout=cfg.layout,
                       backend=cfg.attn_backend, window=cfg.window,
                       segment_ids=segment_ids,
                       collect_stats=stats_out is not None)
        if stats_out is not None:
            o, st = o
            stats_out.append(st)
    else:
        o = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                            segment_ids=segment_ids)
    x = x + _attn_out(p, o)
    m, aux = _mlp(p, x, cfg, mesh)
    return x + m, aux


def check_strategy(cfg: ModelConfig, collect_stats: bool = False) -> None:
    """The JAX model's `_attention` checks of cfg.attn_strategy: "burst"
    or "ulysses"; Ulysses attends in natural token order over one
    sequence axis (a ring layout's permutation would scramble causality)
    and has no ring to instrument (collect_stats)."""
    if cfg.attn_strategy not in ("burst", "ulysses"):
        raise ValueError(f"unknown attn_strategy {cfg.attn_strategy!r}; "
                         "expected 'burst' or 'ulysses'")
    if cfg.attn_strategy != "ulysses":
        return
    if collect_stats:
        raise ValueError(
            "collect_stats requires attn_strategy='burst' (devstats "
            f"instruments the ring); got {cfg.attn_strategy!r}")
    if len(cfg.seq_axes) != 1:
        raise ValueError("ulysses supports a single sequence axis")
    if cfg.layout != "contig":
        raise ValueError(
            "attn_strategy='ulysses' requires layout='contig' (natural "
            f"token order); got layout={cfg.layout!r}")


def check_expert_axis(cfg: ModelConfig, mesh) -> None:
    """Raise NotImplementedError for an expert axis (cfg.expert_axis) or,
    under Ulysses, a head axis (cfg.head_axis) of size > 1 in `mesh`:
    experts and heads sharded over cards are ROADMAP A7."""
    if mesh is None:
        return
    sizes = dict(mesh)
    for what, axis, on in (("expert", cfg.expert_axis, cfg.n_experts > 0),
                           ("head (tp)", cfg.head_axis,
                            cfg.attn_strategy == "ulysses")):
        if on and axis is not None and int(sizes.get(axis, 1)) > 1:
            raise NotImplementedError(
                f"{what} axis {axis!r} of size {sizes[axis]}: sharding over "
                "cards comes with the multi-card ring (ROADMAP A7)")


def check_mesh(mesh, seq_axes=("sp",), pp_axis=None) -> None:
    """Raise unless `mesh` (axis name -> size, or None) is a sequence
    ring, or with `pp_axis` (cfg.pp_axis) a pipeline of such rings: its
    sequence axes (`seq_axes`, cfg.seq_axes) and the pp axis take any
    size, and every other axis (dp, tp, ep) must have size 1: data and
    tensor parallelism and experts over cards are ROADMAP A2 (the
    multi-card ring, A7 in the current numbering)."""
    if mesh is None:
        return
    keep = tuple(seq_axes) + ((pp_axis,) if pp_axis is not None else ())
    other = {a: int(n) for a, n in dict(mesh).items()
             if a not in keep and int(n) != 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other} besides the sequence axes {tuple(seq_axes)}"
            f"{' and the pp axis' if pp_axis is not None else ''}: data and "
            "tensor parallelism and experts over cards need more than one "
            "card (ROADMAP A7: the multi-card ring, ROADMAP A2 before "
            "the re-numbering)")


def check_serving(cfg: ModelConfig) -> None:
    """Serving entry points take no pipeline config: the pipeline is a
    training path (the JAX package has no pp serving path)."""
    if cfg.pp_axis is not None:
        raise ValueError(
            f"pp_axis {cfg.pp_axis!r}: the pipeline is a training path; "
            "serve the model with pp_axis=None (unstack_layers its "
            "parameters)")


def ring_world(cfg: ModelConfig, mesh) -> int:
    """Ring positions over cfg.seq_axes of `mesh` (1 without a mesh),
    after check_expert_axis and check_mesh (a pipeline's stages each run
    a ring of this size)."""
    check_expert_axis(cfg, mesh)
    check_mesh(mesh, cfg.seq_axes, cfg.pp_axis)
    if mesh is None:
        return 1
    n = 1
    for a in cfg.seq_axes:
        n *= int(dict(mesh).get(a, 1))
    return n


def forward_with_aux(params: Params, tokens, positions, cfg: ModelConfig,
                     mesh=None, segment_ids=None, collect_stats=False):
    """Training forward: tokens, positions [B, S] int (layout order over
    the mesh's ring; with one position every layout is the natural order)
    -> (fp32 logits [B, S, vocab], the layers' summed MoE aux loss; 0
    for a dense model).  Attention is differentiable: the flash kernels
    on one position, burst_attn on a ring, ulysses_attn for
    attn_strategy "ulysses" (check_strategy's checks first); with
    `cfg.remat` each block goes through torch.utils.checkpoint
    (non-reentrant), the counterpart of jax.checkpoint: its activations
    are recomputed in the backward.  `mesh` names axis sizes ({"sp": W}
    or {"inter": a, "intra": b} with cfg.seq_axes to match; the ring
    positions share the tokens' device).  `segment_ids` [B, S] ints in
    the tokens' order pack documents into a row: every layer's attention
    stays inside a document (flash_attention / burst_attn(segment_ids=)).

    `collect_stats` (a ring only): also return the ring telemetry of
    every layer folded with obs.devstats.merge (counts add, extrema max /
    min) as a third element, `(logits, aux, DevStats)`; logits and
    gradients are bitwise those of collect_stats=False (a remat block's
    recompute in the backward adds no stats of its own to the result).

    With cfg.pp_axis set: the pipeline-parallel forward on stacked params
    (pipeline_lm.pp_forward_with_aux), without collect_stats."""
    if cfg.pp_axis is not None:
        if collect_stats:
            raise ValueError(
                "collect_stats is not supported on the pipeline-parallel "
                "path (pp_axis set) — the pp schedule slices layers across "
                "stages and has no single ring to instrument")
        from .pipeline_lm import pp_forward_with_aux

        return pp_forward_with_aux(params, tokens, positions, cfg, mesh,
                                   segment_ids=segment_ids)
    check_strategy(cfg, collect_stats)
    if collect_stats and ring_world(cfg, mesh) < 2:
        raise ValueError("collect_stats needs a ring: the mesh's sequence "
                         f"axes {tuple(cfg.seq_axes)} hold one position")
    ring_world(cfg, mesh)
    x = params["embed"][tokens].to(cfg.dtype)
    if segment_ids is not None:  # once, as the kernels take them
        segment_ids = segment_ids.to(device=x.device,
                                     dtype=torch.int32).contiguous()
    sinks = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in params["layers"]:
        sink = [] if collect_stats else None
        sinks.append(sink)
        if cfg.remat and torch.is_grad_enabled():
            x, aux_l = checkpoint(_block, x, p, positions, cfg, mesh, sink,
                                  segment_ids, use_reentrant=False)
        else:
            x, aux_l = _block(x, p, positions, cfg, mesh, sink, segment_ids)
        aux = aux + aux_l
    logits = _logits(_rms_norm(x, params["final_norm"]), params["lm_head"])
    if not collect_stats:
        return logits, aux
    from ..obs import devstats

    # each layer's first entry is its forward's (a remat recompute in the
    # backward appends later ones)
    stats = sinks[0][0]
    for sink in sinks[1:]:
        stats = devstats.merge(stats, sink[0])
    return logits, aux, stats


def forward(params: Params, tokens, positions, cfg: ModelConfig,
            segment_ids=None):
    """Dense single-device forward: tokens, positions [B, S] int -> fp32
    logits [B, S, vocab].  Causal attention (banded by cfg.window, kept
    inside each packed document by `segment_ids`) through the plain tile
    (single_device_attention), no kernels: the plain reference the
    serving checks teacher-force against.  An MoE model routes as the
    JAX forward does on one device: one group at the training capacity
    (cfg.moe_capacity_factor), so a serving check sets the factor high
    enough that nothing drops (n_experts / moe_top_k makes the capacity
    every token)."""
    x = params["embed"][tokens].to(cfg.dtype)
    for p in params["layers"]:
        q, k, v = _qkv_proj(p, x, positions, cfg)
        x = x + _attn_out(p, single_device_attention(
            q, k, v, causal=True, window=cfg.window,
            segment_ids=segment_ids))
        x = x + _mlp(p, x, cfg)[0]
    return _logits(_rms_norm(x, params["final_norm"]), params["lm_head"])
