"""Training step for the LM (port of burst_attn_tpu/models/train.py): on
one device, or on a sequence ring whose positions share the device.

`make_train_step` returns step((params, optimizer), batch) -> (state,
metrics): the next-token cross entropy through `forward_with_aux` (flash
attention forward and backward kernels on the card), AdamW with global
norm clipping as optax's `chain(clip_by_global_norm, adamw)`, and
`grad_accum` microbatches normalized by the global valid-label count.
The state is updated in place (PyTorch has no donation; the returned
state is the same objects).

Loss convention: `tokens` and `labels` arrive in layout order with
`labels` already shifted (the loader's targets); `positions` carries the
true positions for rotary.  On one position every layout is the
identity; on a ring of W positions (`mesh={"sp": W}`, or {"inter": a,
"intra": b} with cfg.seq_axes = ("inter", "intra")) the batch is permuted
into cfg.layout's order at that world and attention runs the ring
forward and backward (parallel/burst.py).

Metrics (the JAX trainer's instruments): `train.steps`,
`train.step_interval_s` (dispatch to dispatch: the step returns without
waiting on the card), `train.tokens_per_s` and `train.events{kind}`.
`TrainConfig(collect_devstats=True)` (a ring, grad_accum 1) takes the
ring telemetry of every layer through the step and publishes it
(`labels={"source": "train"}`) after the dispatch is timed: the one
read-back it costs; the loss and gradients are bitwise those of
collect_devstats=False.

Packed documents: `packed_fields` (torch) / `packed_fields_np` (numpy,
for the host prefetch path) derive segment ids, per-document positions
and boundary-masked labels from an EOS-delimited stream;
`batch_from_host(packed_eos_id=)`, `prefetch_batches(packed_eos_id=)`
and `make_packed_batch` add `segment_ids` to the batch (layout order),
and the step passes them to every layer's attention.

A windowed model (`ModelConfig(window=, layout="contig")`) trains on one
device and on a contig ring like any other: every layer's attention
takes the band (flash_attention(window=) / burst_attn(window=)).  The
JAX trainer's tri gate (models/train.py l.242-250: a window takes the
band path, not the wrapped-diagonal grid) is flash_attention's: its
backward asks for the triangular route only without a window, and
ops/flash.py bwd_route applies the band rule otherwise.

An MoE model (`ModelConfig(n_experts=E)`) adds `moe_aux_weight * aux`
to the objective, per microbatch with grad_accum, as the JAX trainer
does; its routing groups are the ring positions' shards (models/
transformer.py `_mlp`).  A Ulysses model (`attn_strategy="ulysses"`,
contig) trains on `{"sp": W}` through parallel/ulysses.py.

A pipeline-parallel model (`ModelConfig(pp_axis="pp", pp_microbatches=M)`
on `make_mesh({"pp": P, "sp": W})`) trains on stacked layers through
models/pipeline_lm.py; AdamW and the global-norm clip run over the
stacked leaves with the same math, and the batch keeps its layout
permutation over the sequence ring only.

Data and tensor parallelism (`make_mesh({"dp": 2, "sp": 2, "tp": 2})`,
every position on one device): `init_train_state` splits the parameters
over tp (transformer.shard_params; AdamW and the clip run over the
shards, which hold every element once, so the global norm is the
unsplit tree's), the model runs Megatron's column- and row-parallel
layers with their all_reduces and a vocab-parallel cross entropy (the
max, the sum of exponentials and the target logit all_reduced over the
vocab shards), and each dp group runs its forward and backward on its
rows of the batch: the step then averages the groups' gradients with
all_reduce(mean) over dp (parallel/mesh.py), as a data-parallel run
across cards does, before the clip and the update.  Each group's
objective carries the dp factor of the global normalization (the valid
labels of the whole batch), so the mean is the whole batch's gradient.
An MoE model whose expert axis is dp (`expert_axis="dp"`, the runner's
default on a dp mesh) exchanges slots between the groups in the middle of
every layer, so their forwards run in lockstep in one graph and one
backward (`_coupled_backward`): each group holds its own copy of the
replicated leaves (whose gradients meet in the same all_reduce(mean)) and
the experts stay sharded, each owner's gradient the sum over every
group's tokens.  A pipeline takes dp (each dp group its own pipeline, or
its ticks in lockstep with the experts on dp), tp and ep beside its
stages.

Across processes (`make_mesh(sizes, process_axes="auto")` in a process
group, utils/multihost.py): the mesh is laid over the processes in JAX's
process-major order (parallel/mesh.py process_layout), so any axis may
span them.  Each process holds its positions: its dp groups and their
rows of the batch (batch_from_host takes the process's LOCAL rows, so the
global batch is local_B x the processes on dp), its part of the sequence
when a ring's (or Ulysses') axis spans processes, its tp shards, its
experts.  The valid-label count is summed over the processes that hold
distinct tokens (dp and the sequence axes); the dp groups' gradients and
losses meet in all_reduce(mean) over the processes (bit for bit the
one-process dp step); over a sequence axis across processes each
process's gradients and loss are its tokens' share, summed over them in
position order (the one-process step up to fp32 summation order); tp
across processes keeps Megatron's conventions (transformer.py: every
process's replicated leaves carry the whole gradient, the global norm
gathers the other processes' shards' squares); an MoE model's expert
leaves, each owned by one process of the expert axis, are summed over
it.  A pipeline's stages may span processes (a stage or more a process:
models/pipeline_lm.py, parallel/pipeline.py), its gradients and the loss
then summed over them; a pipeline model's sequence, tp or expert axis
across processes is ROADMAP A7b.

The TPU-only tri-backward compile probe (`probe_model_tri_bwd`) has no
counterpart: a CUDA kernel either builds or the run stops.
"""

import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import obs
from ..device import resolve_device
from ..parallel import layouts
from ..parallel.mesh import (
    Mesh, _gathered, all_reduce, axis_size, crosses, process_axes,
)
from .transformer import (
    ModelConfig, Shards, alias_params, check_mesh, check_tp,
    dp_groups, ep_on_batch, expert_leaf_ids, forward_groups, forward_parts,
    group_mesh, init_params, param_leaves, ring_world, shard_params,
    tree_leaves,
)

logger = obs.get_logger(__name__)

# train-loop metrics, updated by the step's host code after the dispatch
# (never inside a captured graph); step time is dispatch to dispatch
_M_STEPS = obs.counter("train.steps")
_M_EVENTS = obs.counter(
    "train.events", "exceptional train-loop events by kind (probe_failure; "
                    "loss-scale kinds reserved for a mixed-precision scaler)")
_M_STEP_S = obs.histogram("train.step_interval_s")
_M_TPS = obs.gauge("train.tokens_per_s")


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    moe_aux_weight: float = 0.01  # weight of the MoE load-balancing loss
    grad_accum: int = 1  # microbatches per optimizer step
    # publish the ring telemetry (obs.devstats) of every step
    collect_devstats: bool = False


def make_mesh(axis_sizes: dict, devices=None, *, process_axes=(),
              device=None):
    """The axis sizes of a run, as {"pp": 2, "dp": 2, "sp": 2,
    "tp": 2}-style names to sizes (order kept).  The sequence axes ("sp",
    or "inter" and "intra" for the double ring), "dp", "tp", "ep" and a
    pipeline's "pp" take any size, in any combination, their positions
    and stages sharing one device; any other axis must have size 1
    (ValueError: the model splits no work over it).  `process_axes`:
    "auto" (or the axes parallel/mesh.py `process_axes_for` gives) lays
    the mesh over the processes of the run; then the result is a
    parallel.mesh.Mesh on `device`."""
    del devices
    sizes = {str(k): int(v) for k, v in dict(axis_sizes).items()}
    check_mesh(sizes, tuple(a for a in ("sp", "inter", "intra")
                            if a in sizes), "pp", "dp", "tp", "ep")
    if process_axes:
        return Mesh(sizes, device=device, process_axes=process_axes)
    return sizes


def _world(cfg: ModelConfig, mesh) -> int:
    """Ring size over cfg.seq_axes of `mesh`; a pipeline model's mesh may
    span processes on its stage and batch axes only (NotImplementedError
    naming ROADMAP A7b)."""
    if cfg.pp_axis is not None:
        other = [a for a in process_axes(mesh)
                 if a not in (cfg.pp_axis, cfg.batch_axis)]
        if other:
            raise NotImplementedError(
                f"a pipeline model with mesh axes {other} across processes:"
                f" its sequence, tp or expert axis across processes is "
                "ROADMAP A7b; only its stage and batch axes may span them")
    return ring_world(cfg, mesh)


def _crossing(mesh, axes):
    """The axes of `axes` (names or None) that span processes of `mesh`."""
    return [a for a in axes if a is not None and crosses(mesh, a)]


def data_shard(cfg: ModelConfig, mesh):
    """(shard_id, num_shards) of this process's rows of the token stream:
    its index among the processes along the batch axis when that spans
    processes (the rows of every dp index it holds; the processes of any
    other axis read the same rows, a sequence axis's each keeping its
    part of the sequence); for a mesh not laid over processes its rank
    among the run's processes, as the JAX runner shards its loader."""
    if not isinstance(mesh, Mesh) or mesh.transport is None:
        from ..utils.multihost import process_count, process_index

        return process_index(), process_count()
    if mesh.crosses(cfg.batch_axis):
        return (mesh.axis_index(cfg.batch_axis),
                len(mesh.axis_ranks(cfg.batch_axis)))
    return 0, 1


def _optimizer(params, tcfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW over every parameter in one group, as optax's unmasked adamw
    (eps 1e-8; moments in the parameters' dtype).  Clipping is done by
    the step, before this optimizer runs."""
    return torch.optim.AdamW(list(param_leaves(params)), lr=tcfg.lr,
                             betas=(tcfg.b1, tcfg.b2), eps=1e-8,
                             weight_decay=tcfg.weight_decay)


def place_params(params, cfg: ModelConfig, mesh=None):
    """`params` as a step on `mesh` takes them: split over its tp axis
    (shard_params) when that has size > 1, every leaf requiring grad."""
    if check_tp(cfg, mesh) > 1:
        params = shard_params(params, cfg, mesh)
    for t in param_leaves(params):
        t.requires_grad_(True)
    return params


def init_train_state(seed: int, cfg: ModelConfig, tcfg: TrainConfig,
                     mesh=None, *, device=None):
    """(params, optimizer): random parameters from a numpy seed on
    `device` (default: the card), split over the mesh's tp axis when it
    has one of size > 1 (place_params), each requiring grad."""
    _world(cfg, mesh)
    params = place_params(init_params(cfg, seed, device=device), cfg, mesh)
    return params, _optimizer(params, tcfg)


def _loss_parts(params, tokens, positions, labels, cfg: ModelConfig,
                mesh=None, segment_ids=None, collect_stats=False):
    """(sum of the masked next-token nll, MoE aux): the linear pieces of
    the objective.  labels < 0 are masked out.  `collect_stats` appends the
    ring telemetry (forward_with_aux)."""
    out = forward_parts(params, tokens, positions, cfg, mesh,
                        segment_ids=segment_ids, collect_stats=collect_stats)
    return (_nll_sum(out[0], labels, cfg, mesh),) + tuple(out[1:])


def _nll_sum(parts, labels, cfg: ModelConfig, mesh=None):
    """The masked next-token nll summed over the tokens, from the logits
    of forward_parts (one part, or the vocab shards of the tp positions:
    this process's when tp spans processes of `mesh`; none on a pipeline
    process without the last stage: 0)."""
    if not parts:
        return torch.zeros((), dtype=torch.float32, device=labels.device)
    if len(parts) > 1 or crosses(mesh, cfg.head_axis):
        return _vocab_parallel_nll(parts, labels, cfg.head_axis,
                                   mesh).sum()
    target = torch.where(labels >= 0, labels, -100).long()
    return F.cross_entropy(parts[0].flatten(0, 1), target.flatten(),
                           ignore_index=-100, reduction="sum")


def _vocab_parallel_nll(parts, labels, axis="tp", mesh=None):
    """Megatron's vocab-parallel cross entropy: the per-token nll [B, S]
    (0 where labels < 0) from each tp position's fp32 logits over its
    vocab shard, without gathering the logits: the max (a constant of the
    gradient), the sum of exponentials and the target's logit, each an
    all_reduce over the shards (across the processes when `axis` spans
    them: the parts are this process's shards)."""
    m = all_reduce([p.detach().amax(-1) for p in parts], "max", axis,
                   mesh=mesh)[0]
    lo = (mesh.local_start(axis) * parts[0].shape[-1]
          if crosses(mesh, axis) else 0)
    sum_exp, target = [], []
    for p in parts:
        sum_exp.append((p - m[..., None]).exp().sum(-1))
        local = labels.long() - lo
        ok = (local >= 0) & (local < p.shape[-1])
        hit = p.gather(-1, local.clamp(0, p.shape[-1] - 1)[..., None])[..., 0]
        target.append(torch.where(ok, hit, 0.0))
        lo += p.shape[-1]
    se = all_reduce(sum_exp, "sum", axis, mesh=mesh)[0]
    tl = all_reduce(target, "sum", axis, mesh=mesh)[0]
    return torch.where(labels >= 0, se.log() + m - tl, 0.0)


def loss_fn(params, tokens, positions, labels, cfg: ModelConfig, mesh=None,
            moe_aux_weight: float = 0.0, segment_ids=None,
            collect_stats=False):
    """Mean next-token cross entropy (fp32) + weighted MoE aux loss; with
    `collect_stats`, (loss, DevStats)."""
    out = _loss_parts(params, tokens, positions, labels, cfg, mesh,
                      segment_ids=segment_ids, collect_stats=collect_stats)
    nll_sum, aux = out[:2]
    ce = nll_sum / (labels >= 0).sum().clamp(min=1)
    loss = ce + moe_aux_weight * aux
    return (loss, out[2]) if collect_stats else loss


def _global_norm(params) -> torch.Tensor:
    """fp32 l2 norm over every gradient (optax.global_norm), summed in
    param_leaves' order; when tp spans processes the other processes'
    shards' squares are gathered, so every process sums the whole tree's
    squares in the one-process order."""
    sq, mine, mesh, axis = [], [], None, None
    for leaf in tree_leaves(params):
        ts = leaf.parts if isinstance(leaf, Shards) else [leaf]
        got = [t.grad.float().square().sum() for t in ts]
        if isinstance(leaf, Shards) and leaf.total > len(ts):
            sq.append((len(mine), len(ts)))
            mine += got
            mesh, axis = leaf.mesh, leaf.axis
        else:
            sq.append(got)
    if mine:
        procs = _gathered([torch.stack(mine)], axis, mesh)[0]
        sq = [[v[i] for v in procs for i in range(at[0], at[0] + at[1])]
              if isinstance(at, tuple) else at for at in sq]
    return torch.sqrt(sum(x for got in sq for x in got))


def _clip_(grads, norm: torch.Tensor, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g / norm * max_norm when
    norm >= max_norm, else g unchanged.  (torch's clip_grad_norm_ divides
    by norm + 1e-6, which is not the same function.)"""
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm.to(g.dtype) * max_norm, g))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None, *,
                    device=None):
    """Returns step((params, optimizer), batch) -> (state, metrics).

    batch = dict(tokens, positions, labels), each [B, S] int on the step's
    device (batch_from_host / make_batch), plus `segment_ids` for packed
    documents (make_packed_batch, batch_from_host(packed_eos_id=)).  metrics = {"loss", "grad_norm"}
    as 0-d fp32 tensors (no host sync); grad_norm is the norm before
    clipping.  `device` defaults to the card and raises without one unless
    "cpu" is asked for.  Each call counts train.steps and, from the second
    call, the dispatch interval; with tcfg.collect_devstats the step's
    DevStats is published after that (metrics never carry it)."""
    dev = resolve_device(device)
    _world(cfg, mesh)
    collect = tcfg.collect_devstats
    if collect and tcfg.grad_accum != 1:
        raise ValueError(
            "collect_devstats supports grad_accum=1 only (per-microbatch "
            "stats would need a merge across the microbatches)")
    aux_w = tcfg.moe_aux_weight if cfg.n_experts else 0.0
    accum = tcfg.grad_accum
    last_dispatch = []  # [t_prev] once the first step has gone out

    def guarded_step(state, batch):
        out, stats = step(state, batch)
        now = time.perf_counter()
        _M_STEPS.inc()
        if last_dispatch:
            dt = now - last_dispatch[0]
            _M_STEP_S.observe(dt)
            if dt > 0:
                _M_TPS.set(batch["tokens"].numel() / dt)
        last_dispatch[:] = [now]
        if stats is not None:
            # after the interval is measured: publish reads the stats back
            # (the one sync the knob costs); telemetry never fails a step
            try:
                stats.publish(labels={"source": "train"})
            except Exception as e:  # noqa: BLE001
                _M_EVENTS.inc(kind="devstats_publish_failure")
                logger.warning("devstats publish failed (%s: %s); step "
                               "continues without telemetry",
                               type(e).__name__, e)
        return out

    def step(state, batch):
        params, opt = state
        leaves = list(param_leaves(params))
        if leaves[0].device != dev:
            raise ValueError(f"parameters are on {leaves[0].device}, the "
                             f"step on {dev}")
        tokens, positions, labels = (batch[k] for k in
                                     ("tokens", "positions", "labels"))
        seg = batch.get("segment_ids")
        opt.zero_grad(set_to_none=True)
        stats = None
        groups = dp_groups(cfg, mesh, tokens.shape[0])
        if (accum == 1 and axis_size(mesh, cfg.batch_axis) == 1
                and not _crossing(mesh, cfg.seq_axes)):
            # every process holds all the tokens (a tp or expert axis
            # across processes replicates them): the one-process step
            loss = loss_fn(params, tokens, positions, labels, cfg, mesh,
                           moe_aux_weight=aux_w, segment_ids=seg,
                           collect_stats=collect)
            if collect:
                loss, stats = loss
            loss.backward()
            loss = loss.detach()
            for t in leaves:
                if t.grad is None:  # a parameter the loss does not reach
                    t.grad = torch.zeros_like(t)
            if process_axes(mesh):
                loss = _reduce_across(params, leaves, loss)
        elif ep_on_batch(cfg, mesh):
            loss, stats = _coupled_backward(params, leaves, tokens,
                                            positions, labels, seg, groups)
        else:
            loss, stats = _grouped_backward(params, leaves, tokens,
                                            positions, labels, seg, groups)
        grads = [t.grad for t in leaves]
        gnorm = _global_norm(params)
        _clip_(grads, gnorm, tcfg.grad_clip)
        opt.step()
        return ((params, opt), {"loss": loss, "grad_norm": gnorm}), stats

    def _microbatches(tokens, labels, groups):
        """(rows a microbatch, v_total) of the grad_accum microbatches of
        each dp group: the global valid-label count (summed over the
        processes when dp spans them) normalizes every piece of the
        objective."""
        per = groups[0].stop - groups[0].start
        if per % accum:
            raise ValueError(f"batch {tokens.shape[0]} not divisible by "
                             f"grad_accum {accum}"
                             + (f" within its {len(groups)} dp groups"
                                if len(groups) > 1 else ""))
        v = (labels >= 0).sum()
        for a in _crossing(mesh, (cfg.batch_axis,) + tuple(cfg.seq_axes)):
            v = all_reduce([v], "sum", a, mesh=mesh)[0]
        return per // accum, v.clamp(min=1).float()

    def _grouped_backward(params, leaves, tokens, positions, labels, seg,
                          groups):
        """The gradients of the whole batch's objective through each dp
        group's rows (and, with grad_accum, each group's microbatches),
        averaged over the groups with all_reduce(mean) into the leaves'
        .grad; returns (loss, merged DevStats or None).  The global
        valid-label count (known from the labels alone) normalizes every
        piece, so uneven masking gives exactly the full-batch objective;
        a group's pieces carry the factor dp, and the MoE aux rides each
        microbatch with weight v_total / accum.  When dp spans processes
        `groups` are this process's own and the mean meets the others';
        then _reduce_across."""
        dp = axis_size(mesh, cfg.batch_axis)
        gm = group_mesh(cfg, mesh)
        mb, v_total = _microbatches(tokens, labels, groups)
        group_grads, group_loss, stats = [], [], None
        for g in groups:
            s_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum):
                sl = slice(g.start + i * mb, g.start + (i + 1) * mb)
                out = _loss_parts(
                    params, tokens[sl], positions[sl], labels[sl], cfg, gm,
                    segment_ids=None if seg is None else seg[sl],
                    collect_stats=collect)
                nll_sum, aux = out[:2]
                if collect:
                    from ..obs import devstats

                    stats = out[2] if stats is None else devstats.merge(
                        stats, out[2])
                piece = dp * nll_sum + aux_w * aux * (v_total / accum)
                piece.backward()
                s_sum += piece.detach()
            for t in leaves:  # scaled in place
                if t.grad is None:  # a parameter the loss does not reach
                    t.grad = torch.zeros_like(t)
                t.grad.div_(v_total)
            group_loss.append(s_sum / v_total)
            if dp > 1:  # the group's gradients, held as its card would
                group_grads.append([t.grad for t in leaves])
                for t in leaves:
                    t.grad = None
        loss = group_loss[0]
        if dp > 1:
            # leaf by leaf, each group's gradient freed once its mean is
            # made
            for i, t in enumerate(leaves):
                parts = [gg[i] for gg in group_grads]
                for gg in group_grads:
                    gg[i] = None
                t.grad = all_reduce(parts, "mean", cfg.batch_axis,
                                    mesh=mesh)[0]
                del parts
            loss = all_reduce(group_loss, "mean", cfg.batch_axis,
                              mesh=mesh)[0]
        return _reduce_across(params, leaves, loss), stats

    def _reduce_across(params, leaves, loss):
        """The sums across processes after the dp mean: over each
        sequence axis that spans processes, every gradient and the loss
        (each process's tokens' share), in position order; over an expert
        axis of its own (or tp) that spans them, the expert leaves (each
        process's gradient holds its own experts' rows alone); over a
        pipeline's stage axis that spans them (after the stage hops'
        gradient sends), every gradient and the loss: each process holds
        its stages' (and the embed's or the head's) alone and its share of
        the objective.  Returns the loss."""
        if _crossing(mesh, (cfg.pp_axis,)):
            mesh.transport.drain()
            for t in leaves:
                t.grad = all_reduce([t.grad], "sum", cfg.pp_axis,
                                    mesh=mesh)[0]
            loss = all_reduce([loss], "sum", cfg.pp_axis, mesh=mesh)[0]
        for a in _crossing(mesh, cfg.seq_axes):
            for t in leaves:
                t.grad = all_reduce([t.grad], "sum", a, mesh=mesh)[0]
            loss = all_reduce([loss], "sum", a, mesh=mesh)[0]
        ea = cfg.expert_axis
        if (cfg.n_experts and ea not in (cfg.batch_axis, *cfg.seq_axes)
                and _crossing(mesh, (ea,))):
            experts = expert_leaf_ids(params)
            for t in leaves:
                if id(t) in experts:
                    t.grad = all_reduce([t.grad], "sum", ea, mesh=mesh)[0]
        return loss

    def _coupled_backward(params, leaves, tokens, positions, labels, seg,
                          groups):
        """_grouped_backward when the MoE exchange runs between the dp
        groups (ep_on_batch): each microbatch's forward runs the groups in
        lockstep (forward_groups) and one backward takes every group's
        piece.  Each group holds its own copy of the replicated leaves
        (aliases of the same storage, as every dp position holds its
        own), whose gradients are its tokens' alone: all_reduce(mean)
        over dp makes them the whole batch's, as in _grouped_backward.
        The experts are sharded over dp, not replicated: dp position i
        owns experts [i E/dp, (i+1) E/dp) and the exchange brings every
        group's slots, and their cotangents, to their owner, so an expert
        leaf's gradient is its owner's alone, the sum over every group's
        tokens (JAX's shard_map transpose of the all_to_all), with no
        reduction over dp.  The pieces carry the factor dp of the
        group mean, so the experts' sum is divided by dp too.  When dp
        spans processes each holds its own groups and experts: the
        exchange and the aux mean cross them (transformer._mlp_groups),
        and each expert leaf's gradient, nonzero on its owner's rows
        alone, is summed over them."""
        dp = axis_size(mesh, cfg.batch_axis)
        gm = group_mesh(cfg, mesh)
        mb, v_total = _microbatches(tokens, labels, groups)
        experts = expert_leaf_ids(params)
        trees = [alias_params(params, experts) for _ in groups]
        group_leaves = [list(param_leaves(t)) for t in trees]
        sums = [torch.zeros((), dtype=torch.float32, device=dev)
                for _ in groups]
        stats = None
        for i in range(accum):
            sls = [slice(g.start + i * mb, g.start + (i + 1) * mb)
                   for g in groups]
            outs = forward_groups(
                trees, [tokens[sl] for sl in sls],
                [positions[sl] for sl in sls], cfg, gm,
                None if seg is None else [seg[sl] for sl in sls],
                collect_stats=collect)
            pieces = []
            for o, sl in zip(outs, sls):
                pieces.append(dp * _nll_sum(o[0], labels[sl], cfg, gm)
                              + aux_w * o[1] * (v_total / accum))
                if collect:
                    from ..obs import devstats

                    stats = o[2] if stats is None else devstats.merge(
                        stats, o[2])
            torch.stack(pieces).sum().backward()
            sums = [s + p.detach() for s, p in zip(sums, pieces)]
        across = _crossing(mesh, (cfg.batch_axis,))
        for j, t in enumerate(leaves):
            if id(t) in experts:
                g = t.grad if t.grad is not None else torch.zeros_like(t)
                if across:
                    g = all_reduce([g], "sum", cfg.batch_axis, mesh=mesh)[0]
                t.grad = g / (dp * v_total)
                continue
            parts = [(gl[j].grad if gl[j].grad is not None
                      else torch.zeros_like(t)) / v_total
                     for gl in group_leaves]
            for gl in group_leaves:
                gl[j].grad = None
            t.grad = all_reduce(parts, "mean", cfg.batch_axis, mesh=mesh)[0]
            del parts
        loss = all_reduce([s / v_total for s in sums], "mean",
                          cfg.batch_axis, mesh=mesh)[0]
        return _reduce_across(params, leaves, loss), stats

    return guarded_step


def train_step(state, batch, cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
               *, device=None):
    """Convenience one-shot of make_train_step."""
    return make_train_step(cfg, tcfg, mesh, device=device)(state, batch)


def batch_from_host(tokens, labels, cfg: ModelConfig, mesh=None,
                    packed_eos_id=None, *, device=None):
    """A host batch (data.DataLoader's inputs/targets [B, S] int32 numpy,
    natural order) as the layout-ordered batch dict `make_train_step`
    consumes, on `device` (default: the card).  In a run across processes
    these are the process's LOCAL rows (its shard of the loader's
    stream); the global batch is local_B x the processes on dp.  When a
    sequence axis spans processes the batch keeps this process's part of
    the layout-order sequence (its ring positions' shards).  Labels were
    shifted by the loader; here they only get the layout permutation at
    the mesh's ring world (the identity on one position).

    `packed_eos_id`: treat the stream as EOS-delimited packed documents:
    positions restart per document, labels are re-derived with boundary
    masking (packed_fields_np; the loader's labels are superseded), and
    `segment_ids` join the batch, all in layout order."""
    dev = resolve_device(device)
    tokens, labels = np.asarray(tokens), np.asarray(labels)
    b, s = tokens.shape
    perm = layouts.seq_permutation(cfg.layout, s, _world(cfg, mesh))
    procs = mesh.ring_procs(cfg.seq_axes) if isinstance(mesh, Mesh) else None
    if procs is not None:  # this process's ring positions' shards
        w = len(procs.owners)
        perm = perm[procs.pos[0] * s // w:(procs.pos[-1] + 1) * s // w]

    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.int64)).to(dev)

    if packed_eos_id is not None:
        seg, pos_packed, labels_packed = packed_fields_np(tokens,
                                                          packed_eos_id)
        return {"tokens": put(tokens[:, perm]),
                "positions": put(pos_packed[:, perm]),
                "labels": put(labels_packed[:, perm]),
                "segment_ids": put(seg[:, perm])}
    return {"tokens": put(tokens[:, perm]),
            "positions": put(np.broadcast_to(perm[None, :], (b, len(perm)))),
            "labels": put(labels[:, perm])}


def prefetch_batches(dl, cfg: ModelConfig, mesh=None, depth: int = 2,
                     packed_eos_id=None, *, device=None):
    """Generator keeping `depth` device batches ahead of the consumer (the
    loader's worker threads fill the host windows meanwhile).  `dl` is a
    data.DataLoader or any (inputs, targets) iterator.  `packed_eos_id`:
    packed documents, see batch_from_host."""
    q = deque()
    it = iter(dl)

    def mk(x, y):
        return batch_from_host(x, y, cfg, mesh, packed_eos_id, device=device)

    try:
        for _ in range(depth):
            q.append(mk(*next(it)))
    except StopIteration:
        pass  # source shorter than depth
    else:
        for x, y in it:
            q.append(mk(x, y))
            yield q.popleft()
    while q:  # finite iterator: drain what is already in flight
        yield q.popleft()


def make_batch(seed: int, cfg: ModelConfig, mesh=None, batch: int = 1,
               seq: int = 128, *, device=None):
    """Synthetic LM batch from a numpy seed: uniform random tokens, labels
    shifted by one with -1 at the end, in layout order on `device`."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(batch, seq), dtype=np.int32)
    labels = np.concatenate(
        [tokens[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
    return batch_from_host(tokens, labels, cfg, mesh, device=device)


def packed_fields(tokens, eos_id: int):
    """Packed-training fields of a [B, S] integer token tensor in NATURAL
    order whose documents are delimited by `eos_id` (the EOS token belongs
    to the document it ends):

      segment_ids [B, S] int32  document index per token (monotone from 0)
      positions   [B, S] int64  rotary positions restarting per document
      labels      [B, S] int64  next-token targets, -1 at document ends
                                (an EOS never predicts the next
                                document's first token) and at the last
                                position

    Permute all three (and the tokens) into the ring's layout order
    (layouts.to_layout(axis=1)) before a zigzag or striped ring."""
    tokens = torch.as_tensor(tokens)
    b, s = tokens.shape
    is_eos = (tokens == eos_id).to(torch.int32)
    # token t's segment = number of EOS strictly before t
    seg = (torch.cumsum(is_eos, dim=1) - is_eos).to(torch.int32)
    idx = torch.arange(s, device=tokens.device).expand(b, s)
    is_start = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                     device=tokens.device),
                          seg[:, 1:] != seg[:, :-1]], dim=1)
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    positions = idx - seg_start
    nxt_same = torch.cat([seg[:, 1:] == seg[:, :-1],
                          torch.zeros((b, 1), dtype=torch.bool,
                                      device=tokens.device)], dim=1)
    labels = torch.where(nxt_same, torch.roll(tokens, -1, dims=1).long(),
                         -1)
    return seg, positions, labels


def packed_fields_np(tokens, eos_id: int):
    """numpy twin of packed_fields for the host prefetch path (the loader
    thread derives the fields without touching the device): int32
    (segment_ids, positions, labels)."""
    tokens = np.asarray(tokens)
    b, s = tokens.shape
    is_eos = tokens == eos_id
    seg = (np.cumsum(is_eos, axis=1) - is_eos).astype(np.int32)
    idx = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    is_start = np.concatenate(
        [np.ones((b, 1), bool), seg[:, 1:] != seg[:, :-1]], axis=1)
    seg_start = np.maximum.accumulate(np.where(is_start, idx, 0), axis=1)
    positions = (idx - seg_start).astype(np.int32)
    nxt_same = np.concatenate(
        [seg[:, 1:] == seg[:, :-1], np.zeros((b, 1), bool)], axis=1)
    labels = np.where(
        nxt_same, np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1),
        -1).astype(np.int32)
    return seg, positions, labels


def packed_tokens(seed: int, vocab: int, batch: int, seq: int,
                  eos_id: int = 0):
    """A synthetic packed token stream [batch, seq] int32 from a numpy
    seed, in natural order: uniform tokens (>= 1) with EOS drawn
    independently at each position with p = 4 / seq (about four
    documents a row, the JAX package's rate)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)
    eos = rng.random((batch, seq)) < 4.0 / seq
    return np.where(eos, eos_id, np.maximum(tokens, 1)).astype(np.int32)


def make_packed_batch(seed: int, cfg: ModelConfig, mesh=None,
                      batch: int = 1, seq: int = 128, eos_id: int = 0, *,
                      device=None):
    """Synthetic PACKED LM batch from a numpy seed (packed_tokens): the
    fields packed_fields derives, everything in layout order on `device`
    (batch_from_host(packed_eos_id=eos_id))."""
    tokens = packed_tokens(seed, cfg.vocab, batch, seq, eos_id)
    return batch_from_host(tokens, tokens, cfg, mesh, packed_eos_id=eos_id,
                           device=device)
