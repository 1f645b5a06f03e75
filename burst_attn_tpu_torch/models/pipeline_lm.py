"""Pipeline-parallel forward of the LM (port of
burst_attn_tpu/models/pipeline_lm.py): GPipe over the mesh's `pp` axis,
each stage's attention on its own sequence ring.

Stage p holds layers [p * L / P, (p + 1) * L / P) of the stacked
parameters (`layers` holds leaves [n_layers, ...], stack_layers).  The
tokens are embedded once, split into cfg.pp_microbatches microbatches
along the batch, and pushed through parallel/pipeline.pipeline: at tick t
stage s runs its layers on microbatch t - s, whose positions and
packed-segment ids travel with it (the activation is the tree (x,
positions, ids)); stage 0 injects and the last stage banks.  Only the live
(stage, microbatch) pairs run (the P stages share the card): the JAX
program's bubble ticks compute masked garbage that reaches no output.
Each layer is transformer._blocks, the regular path's math: attention
runs burst_attn over the stage's sequence ring (sp, or inter x intra;
mesh.seq_mesh), or the flash kernels when that ring has one position;
the window comes from cfg.window.  An MoE layer routes each sequence
shard of the microbatch as one group: the JAX module's `_moe_block` (its
per-shard moe_shard call) is transformer._mlp_groups here, which groups
the same tokens.  The aux counts live ticks only (the stage function adds
up each run's), is summed over the stages and divided by the microbatch
count.
The head (final norm, fp32 logits) runs on the banked activations.  With
cfg.remat each layer goes through torch.utils.checkpoint; the backward is
autograd through the tick loop.

Beside the stages a pp mesh takes dp, tp and an expert axis, as the JAX
module's shard_map over the whole mesh does.  Each dp group runs its own
pipeline on its rows (models/transformer.forward_groups), unless the
expert axis is dp: then the groups' ticks run in lockstep, each stage's
MoE exchanging slots between the groups (the JAX `_moe_block`'s
moe_shard over the expert axis).  Under tp the stacked leaves arrive as
Shards split by param_specs' pp branch (stage dim first, tp dim after):
a stage's layers slice them (Shards[i]), and each layer is the regular
path's Megatron block (column-parallel projections, the tp positions'
heads in one ring launch, all_reduce of the row-parallel partial sums),
which is the JAX `_layer_fwd`'s hand-written psums.  Embed and lm_head
stay whole under pp, as in JAX.

Across processes (a pp axis that spans them, parallel/pipeline.py): each
process runs its own stages; a process without the last stage computes
no logits (its parts are empty) and adds its sends' tokens (value 0) to
its first group's aux, which carries their gradients' arrival into the
caller's backward.
"""

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import axis_size, local_size
from ..parallel.pipeline import pipeline, tree_map
from .transformer import (
    ModelConfig, Shards, _blocks, _embed, _logits, _rms_norm,
    check_expert_axis, check_mesh,
)


def stack_layers(layers):
    """List of layer dicts -> one dict with leading [n_layers, ...] leaves
    (the layout the pp path slices into stages)."""
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def unstack_layers(stacked, n_layers):
    """Inverse of stack_layers (views of the stacked leaves; a split
    leaf's Shards slice into the layer's Shards)."""
    return [{k: a[i] for k, a in stacked.items()} for i in range(n_layers)]


def _stages(a, n_stages: int, per: int):
    """A stacked leaf [L, ...] as [P, L / P, ...] (stage p's layers at
    [p]); a Shards leaf shard by shard, its split dim one further."""
    if isinstance(a, Shards):
        return a._like([_stages(t, n_stages, per) for t in a.parts],
                       a.dim + 1)
    return a.reshape(n_stages, per, *a.shape[1:])


def check_pp(cfg: ModelConfig, mesh, b: int) -> int:
    """The JAX pp_forward_with_aux checks, in its order, then the mesh's
    (check_mesh); returns the stage count."""
    sizes = dict(mesh.shape if hasattr(mesh, "shape") else mesh)
    if cfg.head_axis is not None:
        if cfg.head_axis not in sizes:
            raise ValueError(
                f"head_axis {cfg.head_axis!r} is not an axis of the mesh "
                f"{sizes}; set head_axis=None (ModelConfig defaults it to "
                "'tp') or add the axis to the mesh")
        tp_size = sizes.get(cfg.head_axis, 1)
        if cfg.n_heads % tp_size or cfg.n_kv_heads % tp_size:
            raise ValueError(
                f"n_heads {cfg.n_heads} / n_kv_heads {cfg.n_kv_heads} not "
                f"divisible by {cfg.head_axis!r} mesh size {tp_size}")
        if not cfg.n_experts and cfg.d_ff % tp_size:
            raise ValueError(
                f"d_ff {cfg.d_ff} not divisible by {cfg.head_axis!r} mesh "
                f"size {tp_size} (the dense MLP weights are column-sliced "
                "over tp)")
    if cfg.n_experts and cfg.expert_axis is not None:
        if cfg.expert_axis not in sizes:
            raise ValueError(
                f"expert_axis {cfg.expert_axis!r} is not an axis of the "
                f"mesh {sizes}")
        ep_size = sizes.get(cfg.expert_axis, 1)
        if cfg.n_experts % ep_size:
            raise ValueError(
                f"n_experts {cfg.n_experts} not divisible by "
                f"expert_axis {cfg.expert_axis!r} size {ep_size}")
    if cfg.attn_strategy != "burst":
        raise ValueError("pp path supports attn_strategy='burst' only")
    if cfg.pp_axis not in sizes:
        raise ValueError(
            f"pp_axis {cfg.pp_axis!r} is not an axis of the mesh {sizes}")
    if cfg.batch_axis is not None and cfg.batch_axis not in sizes:
        raise ValueError(
            f"batch_axis {cfg.batch_axis!r} is not an axis of the mesh "
            f"{sizes}; set batch_axis=None or add a dp axis")
    n_stages = sizes.get(cfg.pp_axis, 1)
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"n_layers {cfg.n_layers} not divisible by pp={n_stages}")
    m = cfg.pp_microbatches
    # the dp groups this process holds (1 when dp spans processes)
    dp = local_size(mesh, cfg.batch_axis)
    b_local = b // dp
    if b_local % m:
        raise ValueError(
            f"per-dp-shard batch {b_local} not divisible by "
            f"pp_microbatches {m}")
    check_expert_axis(cfg, sizes)
    check_mesh(sizes, cfg.seq_axes, cfg.pp_axis, cfg.batch_axis,
               cfg.head_axis, cfg.expert_axis if cfg.n_experts else None)
    return n_stages


def pp_forward_groups(params, tokens, positions, cfg: ModelConfig, mesh,
                      segment_ids):
    """transformer.forward_groups on a pipeline: lists a data-parallel
    group (stacked parameter trees, tokens, positions, segment ids), the
    groups' mesh (`mesh`, dp at size 1) -> [([logits], aux)] a group.
    The tokens are embedded once, split into cfg.pp_microbatches
    microbatches along the batch and pushed through
    parallel/pipeline.pipeline, every group's microbatch t - s at stage s
    on tick t (their positions and ids travel with them); each layer is
    transformer._blocks over the groups in lockstep.  A group's aux
    counts live ticks only, summed over the stages and divided by the
    microbatch count."""
    n_stages = axis_size(mesh, cfg.pp_axis)
    m = cfg.pp_microbatches
    per = cfg.n_layers // n_stages
    n = len(params)
    # [P, L / P, ...] views of the stacked leaves: stage p's layers
    stage_params = [{k: _stages(a, n_stages, per)
                     for k, a in p["layers"].items()} for p in params]
    xs = [_embed(p, t, cfg) for p, t in zip(params, tokens)]
    segs = [None if s is None else s.to(device=x.device,
                                        dtype=torch.int32).contiguous()
            for s, x in zip(segment_ids, xs)]
    auxes = [[] for _ in range(n)]  # a group: one per live stage run

    def stage_fn(ps, acts):
        xs_, pos, seg = (list(t) for t in zip(*acts))
        aux = [torch.zeros((), dtype=torch.float32, device=x.device)
               for x in xs_]
        layers = [unstack_layers(p, per) for p in ps]
        for li in range(per):
            lp = [layer[li] for layer in layers]
            if cfg.remat and torch.is_grad_enabled():
                xs_, aux_l = checkpoint(_blocks, xs_, lp, pos, cfg, mesh,
                                        None, seg, use_reentrant=False)
            else:
                xs_, aux_l = _blocks(xs_, lp, pos, cfg, mesh, None, seg)
            aux = [a + b for a, b in zip(aux, aux_l)]
        for g, a in enumerate(aux):
            auxes[g].append(a)
        return [(x, p_, s_) for x, p_, s_ in zip(xs_, pos, seg)]

    tokens = []
    out = pipeline(stage_fn, stage_params,
                   [(x, p_, s_) for x, p_, s_ in zip(xs, positions, segs)],
                   mesh=mesh, axis=cfg.pp_axis, microbatches=m,
                   tokens=tokens)
    if out is None:  # the last stage is another process's
        return [([], sum(a) / m + (sum(tokens) if g == 0 else 0.0))
                for g, a in enumerate(auxes)]
    return [([_logits(_rms_norm(xf, p["final_norm"]), p["lm_head"])],
             sum(a) / m) for (xf, _, _), p, a in zip(out, params, auxes)]
