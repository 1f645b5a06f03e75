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
Each layer is transformer._block, the regular path's math, with the
stage's mesh restricted to cfg.seq_axes (mesh.seq_mesh): attention runs
burst_attn over the stage's sequence ring (sp, or inter x intra), or the
flash kernels when that ring has one position; the window comes from
cfg.window.  An MoE layer routes each sequence shard of the microbatch
as one group: the JAX module's `_moe_block` (its per-shard moe_shard
call) is transformer._mlp's training call here, which groups the same
tokens.  The aux counts live ticks only (the stage function adds up each
run's), is summed over the stages and divided by the microbatch count.
The head (final norm, fp32 logits) runs on the banked activations.  With
cfg.remat each layer goes through torch.utils.checkpoint; the backward is
autograd through the tick loop.

A pp mesh with dp, tp or ep of size > 1 raises NotImplementedError: the
pipeline beside those axes is ROADMAP A7a's second half.
"""

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import seq_mesh
from ..parallel.pipeline import pipeline, tree_map
from .transformer import (
    ModelConfig, _block, _logits, _rms_norm, check_expert_axis, check_mesh,
)


def stack_layers(layers):
    """List of layer dicts -> one dict with leading [n_layers, ...] leaves
    (the layout the pp path slices into stages)."""
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def unstack_layers(stacked, n_layers):
    """Inverse of stack_layers (views of the stacked leaves)."""
    return [{k: a[i] for k, a in stacked.items()} for i in range(n_layers)]


def _layer_fwd(p, x, positions, cfg: ModelConfig, mesh, seg=None):
    """One transformer block of a stage, the regular path's _block on the
    stage's sequence mesh -> (x, the MoE aux; 0.0 for a dense layer)."""
    return _block(x, p, positions, cfg, mesh, None, seg)


def check_pp(cfg: ModelConfig, mesh, b: int) -> int:
    """The JAX pp_forward_with_aux checks, in its order, then the axes
    that need more than one card; returns the stage count."""
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
    dp = sizes.get(cfg.batch_axis, 1) if cfg.batch_axis else 1
    b_local = b // dp
    if b_local % m:
        raise ValueError(
            f"per-dp-shard batch {b_local} not divisible by "
            f"pp_microbatches {m}")
    # not yet beside a pipeline: dp, tp, ep > 1 (ROADMAP A7a)
    check_expert_axis(cfg, sizes)
    check_mesh(sizes, cfg.seq_axes, cfg.pp_axis)
    return n_stages


def pp_forward_with_aux(params, tokens, positions, cfg: ModelConfig, mesh,
                        segment_ids=None):
    """Pipeline-parallel forward_with_aux: fp32 logits [B, S, vocab] + the
    MoE aux loss (0 for dense models), on stacked params.  Same contract
    as transformer.forward_with_aux, which dispatches here when
    cfg.pp_axis is set.  With pp_microbatches > 1 the MoE aux and routing
    groups are per microbatch, the mean over microbatches (as grad
    accumulation's microbatches are); m == 1 matches the regular path."""
    b, s = tokens.shape
    n_stages = check_pp(cfg, mesh, b)
    m = cfg.pp_microbatches
    stage_mesh = seq_mesh(mesh, cfg.seq_axes)
    per = cfg.n_layers // n_stages
    # [P, L / P, ...] views of the stacked leaves: stage p's layers
    stage_params = {k: a.reshape(n_stages, per, *a.shape[1:])
                    for k, a in params["layers"].items()}
    x = params["embed"][tokens].to(cfg.dtype)
    if segment_ids is not None:  # once, as the kernels take them
        segment_ids = segment_ids.to(device=x.device,
                                     dtype=torch.int32).contiguous()
    auxes = []  # one per live (stage, microbatch) run

    def stage_fn(p, act):
        xs, pos, seg = act
        aux = torch.zeros((), dtype=torch.float32, device=xs.device)
        for layer in unstack_layers(p, per):
            if cfg.remat and torch.is_grad_enabled():
                xs, aux_l = checkpoint(_layer_fwd, layer, xs, pos, cfg,
                                       stage_mesh, seg, use_reentrant=False)
            else:
                xs, aux_l = _layer_fwd(layer, xs, pos, cfg, stage_mesh, seg)
            aux = aux + aux_l
        auxes.append(aux)
        return xs, pos, seg

    xf, _, _ = pipeline(stage_fn, stage_params, (x, positions, segment_ids),
                        mesh=mesh, axis=cfg.pp_axis, microbatches=m)
    logits = _logits(_rms_norm(xf, params["final_norm"]), params["lm_head"])
    return logits, sum(auxes) / m
