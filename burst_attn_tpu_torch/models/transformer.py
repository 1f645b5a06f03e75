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
(dp group, ring or Ulysses position) routes its contiguous S/W slice of
the layout-order tokens as its own group, with `capacity_for` of its
token count, and the aux loss is the mean over the groups; with
cfg.expert_axis of size > 1 the groups along it exchange their slots
with the experts' owners (parallel/moe.py `moe_shard(axis=)`): over dp
the dp groups run in lockstep (forward_groups), over an axis of its own
(or tp) the group's replicas exchange.  Inference (`_mlp(...,
inference=True)`, every serving path) routes drop-free in chunks of
MOE_CHUNK tokens, each chunk at capacity = its length, which is exact
because drop-free routing is per token.

Numerics follow the JAX model: RMSNorm and rotary in fp32, cast back to
the activation dtype; logits accumulated and returned in fp32.

Data and tensor parallelism (`batch_axis`, `head_axis` of the mesh) as
positions on one device: `param_specs` is the JAX tree of Megatron
specs, and `shard_params` splits the parameters over the head (tp) axis
by it, into a `ShardedParams` tree that carries its mesh (as a JAX array
carries its sharding) and whose split leaves are `Shards`, one
contiguous tensor a tp position.  Every forward of this package takes
such a tree: each tp position projects its heads (column-parallel wq,
wk, wv; w_gate, w_up), the training forward runs the positions'
attention in one launch over all their heads (the serving paths launch
once a position, on its shard), and each position's row-parallel wo and
w_down give partial sums that `all_reduce` adds
(parallel/mesh.py); the vocab-parallel embedding masks the ids outside
a position's shard before its all_reduce, and the logits are
`all_gather`ed (training reduces the cross entropy over the vocab
shards instead: max, sum-exp and target logit, each an all_reduce).
Activations every tp position holds alike (x, the normed h) are held
once.  A dp axis splits the batch: each dp group runs the forward on its
rows (its own sequence ring), and the trainer averages the groups'
gradients with all_reduce(mean) (models/train.py); when dp is the MoE
expert axis the groups run layer by layer in lockstep (ep_on_batch).
The same tree of a pipeline (cfg.pp_axis) splits its stacked leaves
behind the stage dim, and a pp mesh takes dp, tp and the expert axis
beside its stages (models/pipeline_lm.py).

Across processes (a parallel/mesh.py Mesh laid over the processes of a
run): every loop above runs over this process's positions only.  tp
across processes holds only this process's shards (`Shards.first`,
`.total`; `full()` gathers the others'), and the activations every tp
position holds alike are held once a process: they enter the positions'
column-parallel products through Megatron's f (mesh.copy_to: the
backward sums their gradient over the processes) and leave the
row-parallel ones through its g (all_reduce over the processes, whose
backward hands each process the whole gradient), so every process's
replicated activations and replicated leaves carry the whole gradient.
An MoE layer's routing groups are this process's (dp groups, ring
positions), its exchange reaches the other processes' over an expert
axis that spans them (moe_shard(mesh=)); over a sequence axis that
spans processes each process's aux is its slices' share of the mean.
"""

import itertools
import math
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
from ..parallel.mesh import (
    _gathered, all_gather, all_reduce, axis_size, copy_to, crosses,
    local_size, seq_mesh, sub_mesh,
)
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
    # pipeline's stage axis (pp_microbatches must divide each dp group's
    # rows); batch_axis (dp) splits the batch and head_axis (tp) the
    # heads, MLP columns and vocab (param_specs); expert_axis (an axis of
    # its own, dp or a sequence axis) splits an MoE layer's experts
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


def tree_leaves(params: Params):
    """Every leaf of a parameter dictionary (a tensor, or the Shards of a
    split one) in one fixed order: embed, each layer's layer_keys,
    final_norm, lm_head; stacked layers: each stacked leaf in layer_keys
    order, whatever the dictionaries' insertion order."""
    yield params["embed"]
    layers = params["layers"]
    for layer in [layers] if isinstance(layers, dict) else layers:
        for k in layer_keys(layer):
            yield layer[k]
    yield params["final_norm"]
    yield params["lm_head"]


def param_leaves(params: Params):
    """Every tensor of a parameter dictionary in tree_leaves' order, a
    split leaf's tp shards in position order: the optimizer's and
    checkpoints' order."""
    for leaf in tree_leaves(params):
        if isinstance(leaf, Shards):
            yield from leaf.parts
        else:
            yield leaf


class P(tuple):
    """A partition spec: one mesh axis name (or None) a dimension, as
    jax.sharding.PartitionSpec (a tuple of them)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def param_specs(cfg: ModelConfig) -> Params:
    """The JAX package's PartitionSpec tree of init_params' parameters:
    Megatron tensor parallelism over cfg.head_axis.  qkv projections are
    column-parallel (heads split), the output projection row-parallel,
    the MLP gate / up column- and down row-parallel; embed and lm_head
    split the vocab; norm scales are replicated.  MoE experts split over
    cfg.expert_axis only; a pipeline (cfg.pp_axis) stacks the layer specs
    behind the stage axis and replicates embed and lm_head."""
    tp = cfg.head_axis
    layer = {"attn_norm": P(None), "wq": P(None, tp, None),
             "wk": P(None, tp, None), "wv": P(None, tp, None),
             "wo": P(tp, None, None), "mlp_norm": P(None)}
    if cfg.n_experts:
        ep = cfg.expert_axis
        layer.update(router=P(None, None), w_gate=P(ep, None, None),
                     w_up=P(ep, None, None), w_down=P(ep, None, None))
    else:
        layer.update(w_gate=P(None, tp), w_up=P(None, tp),
                     w_down=P(tp, None))
    if cfg.pp_axis is not None:
        layer = {k: P(cfg.pp_axis, *v) for k, v in layer.items()}
        return {"embed": P(None, None), "layers": layer,
                "final_norm": P(None), "lm_head": P(None, None)}
    return {"embed": P(tp, None), "layers": [layer] * cfg.n_layers,
            "final_norm": P(None), "lm_head": P(tp, None)}


class Shards:
    """A parameter split over the tp positions of mesh axis `axis` along
    dimension `dim` of the whole tensor: `parts[t]` is position
    `first + t`'s contiguous shard, of `total` (this process's positions
    when tp spans processes of `mesh`; all of them otherwise)."""

    def __init__(self, parts, dim: int, axis: Optional[str] = None, *,
                 total: Optional[int] = None, first: int = 0, mesh=None):
        self.parts = list(parts)
        self.dim = int(dim)
        self.axis = axis
        self.total = len(self.parts) if total is None else int(total)
        self.first = int(first)
        self.mesh = mesh

    def __len__(self):
        return len(self.parts)

    def _like(self, parts, dim) -> "Shards":
        return Shards(parts, dim, self.axis, total=self.total,
                      first=self.first, mesh=self.mesh)

    def full(self) -> torch.Tensor:
        """The whole tensor (the shards joined along `dim`; across
        processes the others' gathered first: every process of the tp
        axis calls it)."""
        parts = [t.detach() for t in self.parts]
        if self.total > len(parts):
            parts = _gathered(parts, self.axis, self.mesh)[0]
        return torch.cat(parts, dim=self.dim)

    def map(self, fn) -> "Shards":
        return self._like([fn(t) for t in self.parts], self.dim)

    def __getitem__(self, i: int) -> "Shards":
        """The shards of x[i] along the leading dim of a stacked (pp) leaf,
        which is never the split one (views)."""
        if self.dim == 0:
            raise IndexError("the leading dim of these Shards is the split "
                             "one")
        return self._like([t[i] for t in self.parts], self.dim - 1)

    __iter__ = None  # indexing slices the stacked dim; iterate `parts`


class ShardedParams(dict):
    """A parameter dictionary split over a mesh's head axis by
    param_specs (shard_params): its Megatron leaves are Shards, the
    others (norms, an MoE layer's router and experts) whole tensors held
    once.  `mesh` ({axis: size}), `axis` (cfg.head_axis) and `tp` (its
    size) travel with the tree, as a JAX array's sharding does."""

    def __init__(self, tree, mesh, axis: str, tp: int):
        super().__init__(tree)
        self.mesh = dict(mesh)
        self.axis = axis
        self.tp = int(tp)

    def replace(self, **leaves) -> "ShardedParams":
        """A copy of the tree with some top-level entries replaced."""
        return ShardedParams(dict(self, **leaves), self.mesh, self.axis,
                             self.tp)


def _mesh_shape(mesh) -> Dict[str, int]:
    return {str(a): int(n) for a, n in (
        mesh.shape if hasattr(mesh, "shape") else dict(mesh)).items()}


def check_tp(cfg: ModelConfig, mesh, *, strict: bool = False) -> int:
    """The tp size of `mesh` (its cfg.head_axis; 1 without a mesh or a
    head axis), after the JAX package's checks (the serving paths'
    _check_tp_mesh, models/paged_decode.py): n_heads, n_kv_heads and, as
    the vocab-parallel embed and lm_head need, vocab divisible by it (a
    pipeline keeps both whole).
    `strict` (the serving paths, as in JAX): a head_axis the mesh lacks
    is a ValueError, not size 1."""
    if mesh is None or cfg.head_axis is None:
        return 1
    shape = _mesh_shape(mesh)
    if strict and cfg.head_axis not in shape:
        raise ValueError(
            f"head_axis {cfg.head_axis!r} is not an axis of the mesh "
            f"{shape}; pass mesh=None for single-device serving or set "
            "cfg.head_axis to a mesh axis")
    tp = shape.get(cfg.head_axis, 1)
    if tp > 1 and (cfg.n_kv_heads % tp or cfg.n_heads % tp):
        raise ValueError(
            f"n_heads {cfg.n_heads} / n_kv_heads {cfg.n_kv_heads} not "
            f"divisible by {cfg.head_axis!r} mesh size {tp}")
    if tp > 1 and cfg.vocab % tp and cfg.pp_axis is None:
        raise ValueError(f"vocab {cfg.vocab} not divisible by "
                         f"{cfg.head_axis!r} mesh size {tp} (embed and "
                         "lm_head split the vocab)")
    return tp


def shard_params(params: Params, cfg: ModelConfig, mesh) -> ShardedParams:
    """The port's parameters (init_params, params_from_jax) split over
    the tp positions of `mesh` by param_specs: a ShardedParams whose
    Megatron leaves are Shards (contiguous copies, one a position) and
    whose replicated leaves are the given tensors.  A tree already split
    for this mesh's tp is returned as it is; one split for another tp is
    joined and split again (checkpoints restore across tp sizes).  A
    pipeline's stacked leaves split by param_specs' pp branch: the stage
    dim first, then the leaf's tp dim (embed and lm_head stay whole).
    When tp spans processes of `mesh`, each Shards holds this process's
    positions only."""
    tp = check_tp(cfg, mesh, strict=True)
    if isinstance(params, ShardedParams):
        if params.tp == tp:
            return params
        params = unshard_params(params)
    specs = param_specs(cfg)
    across = crosses(mesh, cfg.head_axis)
    first = mesh.local_start(cfg.head_axis) if across else 0
    held = mesh.local_size(cfg.head_axis) if across else tp

    def split(x, spec):
        if isinstance(x, dict):
            return {k: split(x[k], spec[k]) for k in x}
        if isinstance(x, list):
            return [split(a, b) for a, b in zip(x, spec)]
        if cfg.head_axis is None or cfg.head_axis not in spec:
            return x
        dim = spec.index(cfg.head_axis)
        return Shards([c.contiguous() for c in x.detach().chunk(tp, dim)
                       [first:first + held]], dim, cfg.head_axis, total=tp,
                      first=first, mesh=mesh if across else None)

    return ShardedParams(split(dict(params), specs), _mesh_shape(mesh),
                         cfg.head_axis, tp)


def unshard_params(params) -> Params:
    """A plain parameter dictionary with every Shards joined into its
    whole tensor (the all_gather of each split leaf); a plain tree is
    returned as it is."""
    if not isinstance(params, ShardedParams):
        return params

    def join(x):
        if isinstance(x, dict):
            return {k: join(v) for k, v in x.items()}
        if isinstance(x, list):
            return [join(v) for v in x]
        return x.full() if isinstance(x, Shards) else x

    return join(dict(params))


def expert_leaf_ids(params) -> set:
    """ids of the expert weights (an MoE layer's w_gate, w_up, w_down;
    stacked or per layer) of a parameter tree."""
    layers = params["layers"]
    return {id(layer[k]) for layer in ([layers] if isinstance(layers, dict)
                                       else layers)
            if "router" in layer for k in ("w_gate", "w_up", "w_down")}


def alias_params(params, keep=frozenset()):
    """A tree of the same structure whose tensors are fresh leaves on the
    same storage (detach, requiring grad), so that their gradients
    collect apart from the originals'; tensors whose id is in `keep` stay
    the originals.  A ShardedParams stays one, each shard aliased."""
    def alias(x):
        if isinstance(x, dict):
            return {k: alias(v) for k, v in x.items()}
        if isinstance(x, list):
            return [alias(v) for v in x]
        if isinstance(x, Shards):
            return x.map(alias)
        return x if id(x) in keep else x.detach().requires_grad_(True)

    tree = alias(dict(params))
    if isinstance(params, ShardedParams):
        return ShardedParams(tree, params.mesh, params.axis, params.tp)
    return tree


def params_device(params) -> torch.device:
    """The device of a (possibly split) parameter tree."""
    return next(iter(param_leaves(params))).device


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
    return _qkv_from_h(p, _rms_norm(x, p["attn_norm"]), positions, cfg)


def _qkv_from_h(p, h, positions, cfg: ModelConfig):
    """qkv projections + rotary of the normed h [B, S, d] (one tp
    position's heads when p is its part of a split layer)."""
    q = torch.einsum("bsd,dnh->bnsh", h, p["wq"])
    k = torch.einsum("bsd,dnh->bnsh", h, p["wk"])
    v = torch.einsum("bsd,dnh->bnsh", h, p["wv"])
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _attn_out(p, o):
    """Output projection: o [B, N, S, H] -> [B, S, d] (a tp position's
    partial sum when p is its part of a split layer)."""
    return torch.einsum("bnsh,nhd->bsd", o, p["wo"])


def tp_parts(p) -> list:
    """A layer as its tp positions see it: [p] for a whole layer, else one
    dict a position holding its shard of every split leaf (whole leaves
    shared)."""
    n = max((len(v) for v in p.values() if isinstance(v, Shards)),
            default=0)
    if n == 0:
        return [p]
    return [{k: v.parts[t] if isinstance(v, Shards) else v
             for k, v in p.items()} for t in range(n)]


def tp_sum(parts, axis: Optional[str], mesh=None):
    """The replicated sum of the tp positions' partial sums over mesh axis
    `axis` (cfg.head_axis; one part: the part itself; more: all_reduce,
    every position's copy alike, so the one value every position holds
    is kept).  When `axis` spans processes of `mesh` the parts are this
    process's and the sum is Megatron's g across them."""
    if len(parts) == 1 and not crosses(mesh, axis):
        return parts[0]
    return all_reduce(parts, "sum", axis, mesh=mesh)[0]


def tp_inputs(x, n: int, axis: Optional[str], mesh=None) -> list:
    """`x` (alike on every tp position) as the input of each of this
    process's `n` tp positions: one alias a position when n > 1, so that
    autograd sums x's gradient position by position, the last first; when
    `axis` spans processes of `mesh`, through Megatron's f (mesh.copy_to,
    which sums over the processes in the same order: one tp position a
    process gives the one-process run's gradient bit for bit)."""
    x = copy_to(x, axis, mesh)
    if n == 1:
        return [x]
    return [x.view_as(x) for _ in range(n)]



def _embed(params, tokens, cfg: ModelConfig, mesh=None):
    """The embedding rows of `tokens` in cfg.dtype; a vocab-parallel embed
    (Shards over tp): each position looks up the ids of its vocab shard,
    zeros the others, and all_reduce adds the positions' rows."""
    emb = params["embed"]
    if not isinstance(emb, Shards):
        return emb[tokens].to(cfg.dtype)
    parts, lo = [], emb.first * emb.parts[0].shape[0]
    for e in emb.parts:
        local = tokens - lo
        ok = (local >= 0) & (local < e.shape[0])
        rows = e[local.clamp(0, e.shape[0] - 1)].to(cfg.dtype)
        parts.append(rows.masked_fill(~ok[..., None], 0))
        lo += e.shape[0]
    return tp_sum(parts, emb.axis, mesh)


def _mlp(p, x, cfg: ModelConfig, mesh=None, inference: bool = False):
    """The MLP sublayer (pre-norm) of one group: dense SwiGLU, or with
    cfg.n_experts a routed MoE (_mlp_groups).  Returns (out [B, S, d],
    aux): aux an fp32 0-d tensor for MoE, the float 0.0 for the dense MLP
    (no device op), so callers are uniform.

    `inference=True` (every serving path) routes drop-free in chunks of
    MOE_CHUNK tokens at capacity = the chunk's length: silently zeroing a
    token's MLP output is a training-time trade, and drop-free routing
    is per token, so the chunks give the one-group result."""
    if inference and cfg.n_experts:
        h = _rms_norm(x, p["mlp_norm"])
        mp = MoEParams(p["router"], p["w_gate"], p["w_up"], p["w_down"])
        b, s, d = h.shape
        parts = [moe_shard(mp, hc, top_k=cfg.moe_top_k, capacity=hc.shape[0])
                 for hc in h.reshape(b * s, d).split(MOE_CHUNK)]
        y = torch.cat([y for y, _, _ in parts]).reshape(b, s, d)
        return y, torch.stack([a for _, a, _ in parts]).mean()
    ys, auxes = _mlp_groups([p], [x], cfg, mesh)
    return ys[0], auxes[0]


def _moe_sets(cfg: ModelConfig, mesh, n_groups: int):
    """The training routing groups of `n_groups` data-parallel groups run
    in lockstep on `mesh` (their mesh: dp at size 1), flat k = g * W + j
    for dp group g and sequence position j of the W = ring_world ones
    (row-major over cfg.seq_axes), arranged as the JAX `_mlp`'s shard_map
    exchanges them: (sets, r, replicated), each set the groups that swap
    slots over cfg.expert_axis in that axis's order, r the copies of each
    member (> 1 when the expert axis holds replicas of the tokens: an axis
    of its own, or tp) and whether the axis holds such replicas.  No
    expert axis: every group alone, r = 1.  Across processes the groups
    and copies are this process's (local_size)."""
    axes = [(cfg.batch_axis, n_groups)] + [
        (a, local_size(mesh, a)) for a in cfg.seq_axes]
    n = math.prod(size for _, size in axes)
    ea = cfg.expert_axis
    names = [a for a, _ in axes]
    if ea is None or not cfg.n_experts:
        return [[k] for k in range(n)], 1, False
    if ea in names:
        i = names.index(ea)
        sets = {}
        for k, c in enumerate(itertools.product(*(range(size)
                                                  for _, size in axes))):
            sets.setdefault(c[:i] + c[i + 1:], []).append(k)
        return list(sets.values()), 1, False
    return [[k] for k in range(n)], local_size(mesh, ea), True


def _mlp_groups(ps, xs, cfg: ModelConfig, mesh=None):
    """The training MLP sublayer of data-parallel groups in lockstep: ps,
    xs the groups' layers and activations [B, S, d] -> ([out], [aux]).

    MoE groups, as the JAX model's shard_map: each of the ring_world(cfg,
    mesh) positions of a dp group routes its contiguous S/W slice of the
    (layout-order) tokens, all B rows, as one group at capacity_for(B *
    S/W tokens); with cfg.expert_axis the groups _moe_sets names exchange
    their slots (moe_shard(axis=)): over dp (several groups in xs, the
    trainer's coupled groups), over a sequence axis, or as replicas of
    one group over an axis of its own or tp (the replicas' outputs are
    alike: the first is kept).  A group's aux is the mean over its
    slices of its exchange's mean, so every dp group of an exchange over
    dp holds the mean over all groups, as JAX's pmeans give it."""
    hs = [_rms_norm(x, p["mlp_norm"]) for p, x in zip(ps, xs)]
    if not cfg.n_experts:
        # split over tp: column-parallel gate / up, row-parallel down
        out = []
        for p, h in zip(ps, hs):
            parts = tp_parts(p)
            ins = tp_inputs(h, len(parts), cfg.head_axis, mesh)
            out.append(tp_sum([(F.silu(hp @ pt["w_gate"])
                                * (hp @ pt["w_up"])) @ pt["w_down"]
                               for pt, hp in zip(parts, ins)],
                              cfg.head_axis, mesh))
        return out, [0.0] * len(ps)
    w = ring_world(cfg, mesh)
    wl = math.prod(local_size(mesh, a) for a in cfg.seq_axes)  # held here
    b, s, d = hs[0].shape
    top_k = cfg.moe_top_k
    cap = capacity_for(b * s // wl, cfg.n_experts, top_k,
                       cfg.moe_capacity_factor)
    mps = [MoEParams(p["router"], p["w_gate"], p["w_up"], p["w_down"])
           for p in ps]
    chunks = [c.reshape(-1, d) for h in hs for c in h.chunk(wl, dim=1)]
    ys, auxes = [None] * len(chunks), [None] * len(chunks)
    sets, r, replicated = _moe_sets(cfg, mesh, len(ps))
    across = crosses(mesh, cfg.expert_axis)
    for members in sets:
        if len(members) == 1 and r == 1 and not across:
            k = members[0]
            ys[k], auxes[k], _ = moe_shard(mps[k // wl], chunks[k],
                                           top_k=top_k, capacity=cap)
            continue
        out, aux, _ = moe_shard([mps[k // wl] for k in members
                                 for _ in range(r)],
                                [chunks[k] for k in members
                                 for _ in range(r)],
                                top_k=top_k, capacity=cap,
                                axis=cfg.expert_axis, mesh=mesh,
                                replicated=replicated)
        for i, k in enumerate(members):
            ys[k], auxes[k] = out[i * r], aux
    # a sequence split between processes: each its slices' share of the
    # mean over all w (the trainer sums the shares)
    share = ((lambda a: torch.stack(a).sum() / w) if wl < w
             else (lambda a: torch.stack(a).mean()))
    return ([torch.cat([y.reshape(b, -1, d) for y in ys[g * wl:(g + 1)
                                                          * wl]], dim=1)
             for g in range(len(ps))],
            [share(auxes[g * wl:(g + 1) * wl]) for g in range(len(ps))])


def _logits(x, lm_head):
    """fp32 logits [..., vocab] (the JAX model's preferred_element_type
    accumulation).  A caller that computes logits every step passes an
    fp32 `lm_head` (ServeEngine does), and the cast costs nothing.  A
    vocab-parallel lm_head (Shards): each tp position's logits over its
    vocab shard, all_gathered."""
    parts = _logit_parts(x, lm_head)
    if len(parts) == 1:
        return parts[0]
    return all_gather(parts, dim=-1, axis=lm_head.axis)[0]


def _logit_parts(x, lm_head, mesh=None) -> list:
    """Each tp position's fp32 logits over its vocab shard (one part for a
    whole lm_head; this process's positions' when tp spans processes of
    `mesh`, x entering them through Megatron's f)."""
    if not isinstance(lm_head, Shards):
        return [x.float() @ lm_head.float().t()]
    ins = tp_inputs(x, len(lm_head), lm_head.axis, mesh)
    return [xp.float() @ w.float().t() for xp, w in zip(ins, lm_head.parts)]


def fp32_head(params):
    """`params` with lm_head upcast to fp32 once (the serving engines'
    per-step logits then make no fresh fp32 copy of it)."""
    head = params["lm_head"]
    head = (head.map(lambda t: t.float()) if isinstance(head, Shards)
            else head.float())
    if isinstance(params, ShardedParams):
        return params.replace(lm_head=head)
    return dict(params, lm_head=head)


def _attention(x, p, positions, cfg: ModelConfig, mesh=None, stats_out=None,
               segment_ids=None):
    """x plus the attention sublayer of one group (pre-norm).  Attention
    runs the flash kernels (autograd `flash_attention`) on one device;
    when the mesh's sequence axes hold more than one position, the ring
    (autograd `burst_attn` over cfg.seq_axes, its layout and backend) or,
    for attn_strategy "ulysses", the all-to-all `ulysses_attn` over
    cfg.seq_axes[0], as the JAX model's `_attention` does; all take the
    packed-document `segment_ids`.  A layer split over tp projects each
    position's heads with its shard of the weights, runs the positions'
    attention in one launch over all their heads a sequence position
    (burst_attn or ulysses_attn with cfg.head_axis as the head axis: each
    tp position's ring, or all-to-all, is independent of the others'),
    and all_reduces the positions' wo partial sums.  `stats_out`: None,
    or a list the ring's DevStats is appended to (collect_stats: the
    output is the same)."""
    world = ring_world(cfg, mesh)
    parts = tp_parts(p)
    ins = tp_inputs(_rms_norm(x, p["attn_norm"]), len(parts), cfg.head_axis,
                    mesh)
    qkv = [_qkv_from_h(pt, hp, positions, cfg)
           for pt, hp in zip(parts, ins)]
    q, k, v = (torch.cat(t, dim=1) if len(parts) > 1 else t[0].contiguous()
               for t in zip(*qkv))
    ring = seq_mesh(mesh, cfg.seq_axes) if world > 1 else None
    if ring is not None and len(parts) > 1:
        ring = sub_mesh(mesh, dict(ring.shape if hasattr(ring, "shape")
                                   else ring, **{cfg.head_axis: len(parts)}))
    if cfg.attn_strategy == "ulysses" and world > 1:
        o = ulysses_attn(q, k, v, mesh=ring, seq_axis=cfg.seq_axes[0],
                         causal=cfg.causal, backend=cfg.attn_backend,
                         head_axes=cfg.head_axis, window=cfg.window,
                         segment_ids=segment_ids)
    elif world > 1:
        o = burst_attn(q, k, v, mesh=ring, seq_axes=cfg.seq_axes,
                       head_axes=cfg.head_axis, causal=cfg.causal,
                       layout=cfg.layout, backend=cfg.attn_backend,
                       window=cfg.window, segment_ids=segment_ids,
                       collect_stats=stats_out is not None)
        if stats_out is not None:
            o, st = o
            stats_out.append(st)
    else:
        o = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                            segment_ids=segment_ids)
    os = o.chunk(len(parts), dim=1)
    return x + tp_sum([_attn_out(pt, ot) for pt, ot in zip(parts, os)],
                      cfg.head_axis, mesh)


def _blocks(xs, ps, positions, cfg: ModelConfig, mesh=None, sinks=None,
            segment_ids=None):
    """One decoder block of the training forward over data-parallel groups
    in lockstep (lists a group: activations, layers, positions, DevStats
    sinks, segment ids): each group's attention (_attention), then the
    groups' MLPs together (_mlp_groups: an MoE exchange over dp couples
    them) -> (xs, each group's aux)."""
    n = len(xs)
    sinks = sinks or [None] * n
    segment_ids = segment_ids or [None] * n
    xs = [_attention(x, p, pos, cfg, mesh, sink, seg) for x, p, pos, sink,
          seg in zip(xs, ps, positions, sinks, segment_ids)]
    ms, auxes = _mlp_groups(ps, xs, cfg, mesh)
    return [x + m for x, m in zip(xs, ms)], auxes


def check_strategy(cfg: ModelConfig, collect_stats: bool = False,
                   mesh=None) -> None:
    """The JAX model's `_attention` checks of cfg.attn_strategy: "burst"
    or "ulysses"; Ulysses attends in natural token order over one
    sequence axis (a ring layout's permutation would scramble causality),
    has no ring to instrument (collect_stats) and needs each tp group's
    q and kv heads divisible by the sequence axis of `mesh` (the
    ulysses_attn check, made before any layer runs)."""
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
    w = axis_size(mesh, cfg.seq_axes[0])
    tp = axis_size(mesh, cfg.head_axis)
    if w > 1 and ((cfg.n_heads // tp) % w or (cfg.n_kv_heads // tp) % w):
        raise ValueError(
            f"ulysses needs per-group q heads {cfg.n_heads}/{tp} and kv "
            f"heads {cfg.n_kv_heads}/{tp} divisible by the "
            f"{cfg.seq_axes[0]!r} axis size {w}")


def check_expert_axis(cfg: ModelConfig, mesh) -> None:
    """The JAX package's expert-axis checks (ValueError): n_experts must
    divide by the size of cfg.expert_axis in `mesh`, and the expert axis
    cannot be the pipeline's stage axis (the stacked expert specs would
    name it twice, which JAX refuses)."""
    if mesh is None or not cfg.n_experts or cfg.expert_axis is None:
        return
    if cfg.expert_axis == cfg.pp_axis:
        raise ValueError(f"expert_axis {cfg.expert_axis!r} is the pp axis: "
                         "experts split over another axis than the stages")
    ep = axis_size(mesh, cfg.expert_axis)
    if cfg.n_experts % ep:
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by "
                         f"expert_axis {cfg.expert_axis!r} size {ep}")


def check_mesh(mesh, seq_axes=("sp",), pp_axis=None, batch_axis="dp",
               head_axis="tp", expert_axis=None) -> None:
    """Raise ValueError unless every axis of `mesh` (axis name -> size, or
    None) with size > 1 is one the model splits its work over: the
    sequence axes (`seq_axes`, cfg.seq_axes), data (`batch_axis`), tensor
    (`head_axis`) and expert (`expert_axis`) parallelism and a pipeline's
    stages (`pp_axis`), each of any size, in any combination.  Any other
    axis of size > 1 would only replicate the work (its positions share
    the one device)."""
    if mesh is None:
        return
    keep = tuple(seq_axes) + tuple(a for a in (pp_axis, batch_axis,
                                               head_axis, expert_axis)
                                   if a is not None)
    other = {a: int(n) for a, n in _mesh_shape(mesh).items()
             if a not in keep and int(n) != 1}
    if other:
        raise ValueError(
            f"mesh axes {other} are none of the sequence axes "
            f"{tuple(seq_axes)} and the pp, batch, head and expert axes "
            f"{(pp_axis, batch_axis, head_axis, expert_axis)}: the model "
            "splits no work over them")


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
    after check_expert_axis, check_mesh and check_tp (a pipeline's stages
    and each (dp, tp) group run a ring of this size)."""
    check_expert_axis(cfg, mesh)
    check_mesh(mesh, cfg.seq_axes, cfg.pp_axis, cfg.batch_axis,
               cfg.head_axis, cfg.expert_axis if cfg.n_experts else None)
    check_tp(cfg, mesh)
    if mesh is None:
        return 1
    n = 1
    for a in cfg.seq_axes:
        n *= int(_mesh_shape(mesh).get(a, 1))
    return n


def tp_of(params, cfg: ModelConfig, mesh, *, strict: bool = False) -> int:
    """The tp size a forward runs: the parameters' split (ShardedParams),
    which must be the mesh's tp (check_tp, `strict` as there) when a mesh
    is given: plain parameters on a tp mesh are a ValueError, split once
    with shard_params."""
    have = params.tp if isinstance(params, ShardedParams) else 1
    if mesh is not None:
        want = check_tp(cfg, mesh, strict=strict)
        if want != have:
            raise ValueError(
                f"the parameters are split over {have} tp position(s), the "
                f"mesh's {cfg.head_axis!r} axis has {want}: pass "
                "shard_params(params, cfg, mesh)")
    return have


def dp_groups(cfg: ModelConfig, mesh, batch: int):
    """The batch rows of each data-parallel group this process holds:
    [slice] a group of cfg.batch_axis's size in `mesh` (one whole slice
    without dp, or when dp spans processes: `batch` is then this
    process's rows, its one group).  The batch must divide by it, as
    JAX's batch sharding needs."""
    dp = local_size(mesh, cfg.batch_axis)
    if batch % dp:
        raise ValueError(f"batch {batch} not divisible by the "
                         f"{cfg.batch_axis!r} axis size {dp}")
    per = batch // dp
    return [slice(g * per, (g + 1) * per) for g in range(dp)]


def group_mesh(cfg: ModelConfig, mesh):
    """What one data-parallel group runs on: `mesh` with cfg.batch_axis at
    size 1 (a Mesh.sub, when `mesh` spans processes, that keeps a ring
    axis across them)."""
    if mesh is None or cfg.batch_axis is None:
        return mesh
    shape = _mesh_shape(mesh)
    if cfg.batch_axis in shape:
        shape[cfg.batch_axis] = 1
    return sub_mesh(mesh, shape)


def ep_on_batch(cfg: ModelConfig, mesh) -> bool:
    """Whether an MoE model's expert axis is its batch (dp) axis of size
    > 1 in `mesh`: the MoE exchange then runs between the dp groups,
    whose forwards (and backward) must run in lockstep (forward_groups)."""
    return bool(cfg.n_experts and cfg.expert_axis is not None
                and cfg.expert_axis == cfg.batch_axis
                and axis_size(mesh, cfg.batch_axis) > 1)


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
    or {"inter": a, "intra": b} with cfg.seq_axes to match, beside
    cfg.batch_axis "dp", cfg.head_axis "tp" and cfg.expert_axis; the
    positions share the tokens' device).  A dp axis splits the batch into
    groups, each its own forward (the logits joined along the batch, the
    aux their mean), run in lockstep when the expert axis is dp
    (ep_on_batch); a tp axis of size > 1 needs the parameters split for
    it (shard_params), and the logits come all_gathered from the vocab
    shards.  `segment_ids` [B, S] ints in the tokens' order pack
    documents into a row: every layer's attention stays inside a
    document (flash_attention / burst_attn(segment_ids=)).

    `collect_stats` (a ring only): also return the ring telemetry of
    every layer folded with obs.devstats.merge (counts add, extrema max /
    min) as a third element, `(logits, aux, DevStats)`; logits and
    gradients are bitwise those of collect_stats=False (a remat block's
    recompute in the backward adds no stats of its own to the result).

    With cfg.pp_axis set: the pipeline-parallel forward on stacked params
    (models/pipeline_lm.py), without collect_stats."""
    out = forward_parts(params, tokens, positions, cfg, mesh,
                        segment_ids=segment_ids, collect_stats=collect_stats)
    parts = out[0]
    logits = (parts[0] if len(parts) == 1 and not crosses(
        mesh, cfg.head_axis) else all_gather(
            parts, dim=-1, axis=cfg.head_axis, mesh=mesh)[0])
    return (logits,) + tuple(out[1:])


def forward_parts(params: Params, tokens, positions, cfg: ModelConfig,
                  mesh=None, segment_ids=None, collect_stats=False):
    """forward_with_aux with the logits left on their tp positions: (a
    list of each position's fp32 logits over its vocab shard, one entry
    without tp or with pp; aux[, DevStats]).  The trainer's
    vocab-parallel cross entropy reads them so."""
    if cfg.pp_axis is not None:
        if collect_stats:
            raise ValueError(
                "collect_stats is not supported on the pipeline-parallel "
                "path (pp_axis set) — the pp schedule slices layers across "
                "stages and has no single ring to instrument")
        from .pipeline_lm import check_pp

        check_pp(cfg, mesh, tokens.shape[0])
    else:
        check_strategy(cfg, collect_stats, mesh)
        if collect_stats and ring_world(cfg, mesh) < 2:
            raise ValueError("collect_stats needs a ring: the mesh's "
                             f"sequence axes {tuple(cfg.seq_axes)} hold one "
                             "position")
        ring_world(cfg, mesh)
    tp_of(params, cfg, mesh)
    groups = dp_groups(cfg, mesh, tokens.shape[0])
    gm = group_mesh(cfg, mesh)
    outs = []
    for run in ([groups] if ep_on_batch(cfg, mesh)
                else [[g] for g in groups]):
        outs += forward_groups(
            [params] * len(run), [tokens[g] for g in run],
            [positions[g] for g in run], cfg, gm,
            None if segment_ids is None else [segment_ids[g] for g in run],
            collect_stats)
    if len(outs) == 1:
        return outs[0]
    parts = [torch.cat([o[0][t] for o in outs]) for t in range(
        len(outs[0][0]))]
    aux = torch.stack([torch.as_tensor(o[1]) for o in outs]).mean()
    if not collect_stats:
        return parts, aux
    from ..obs import devstats

    stats = outs[0][2]
    for o in outs[1:]:
        stats = devstats.merge(stats, o[2])
    return parts, aux, stats


def forward_groups(params, tokens, positions, cfg: ModelConfig, mesh,
                   segment_ids=None, collect_stats=False):
    """The training forward of data-parallel groups in lockstep, lists a
    group (parameter trees, tokens, positions, segment ids or None) on
    `mesh`, the groups' mesh (cfg.batch_axis at size 1, group_mesh):
    layer by layer every group's block, its MLPs together, so that an MoE
    exchange over the batch axis (ep_on_batch) runs between them; a
    pipeline (cfg.pp_axis) runs its ticks so.  -> [(logit parts, aux[,
    DevStats])] a group.  The trainer passes each group a tree of its
    own (its copies of the replicated leaves), as each dp position holds
    its own; forward_parts passes the one tree."""
    if segment_ids is None:
        segment_ids = [None] * len(tokens)
    if cfg.pp_axis is not None:
        from .pipeline_lm import pp_forward_groups

        return pp_forward_groups(params, tokens, positions, cfg, mesh,
                                 segment_ids)
    xs = [_embed(p, t, cfg, mesh) for p, t in zip(params, tokens)]
    # once, as the kernels take them
    segs = [None if s is None else s.to(device=x.device,
                                        dtype=torch.int32).contiguous()
            for s, x in zip(segment_ids, xs)]
    sinks = []  # a layer: a list a group
    auxes = [torch.zeros((), dtype=torch.float32, device=x.device)
             for x in xs]
    for li in range(len(params[0]["layers"])):
        ps = [p["layers"][li] for p in params]
        sink = [[] if collect_stats else None for _ in xs]
        sinks.append(sink)
        if cfg.remat and torch.is_grad_enabled():
            xs, aux_l = checkpoint(_blocks, xs, ps, positions, cfg, mesh,
                                   sink, segs, use_reentrant=False)
        else:
            xs, aux_l = _blocks(xs, ps, positions, cfg, mesh, sink, segs)
        auxes = [a + b for a, b in zip(auxes, aux_l)]
    outs = []
    for g, (p, x) in enumerate(zip(params, xs)):
        parts = _logit_parts(_rms_norm(x, p["final_norm"]), p["lm_head"],
                             mesh)
        if not collect_stats:
            outs.append((parts, auxes[g]))
            continue
        from ..obs import devstats

        # each layer's first entry is its forward's (a remat recompute in
        # the backward appends later ones)
        stats = sinks[0][g][0]
        for sink in sinks[1:]:
            stats = devstats.merge(stats, sink[g][0])
        outs.append((parts, auxes[g], stats))
    return outs


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
