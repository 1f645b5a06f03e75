"""End-to-end training runner + CLI (port of
burst_attn_tpu/models/runner.py), on one device or a mesh of pp, dp, sp,
tp and ep positions that share it.

Ties together the native data loader (data/loader.py), the train step
(models/train.py), checkpoints (utils/checkpoint.py), step timing
(utils/profiling.py) and held-out eval (models/evaluate.py).  Resume is
exact: the checkpoint step repositions the deterministic loader with
`seek(step)`, so the token stream continues as if the run never stopped.

CLI (the card by default; `--device cpu` runs the plain versions):
    python -m burst_attn_tpu_torch.models.runner --data tokens.batd \\
        --steps 100 --d-model 2048 --n-layers 16 --n-heads 16 --seq-len 8192

`--mesh sp=4` trains on a ring of 4 positions (`--mesh inter=2,intra=2`
on the double ring); `--mesh dp=2,sp=2,tp=2` adds data and tensor
parallelism (each dp group its rows of the batch, the parameters split
over tp; every position shares the device); `--packed-eos ID` trains
(and evaluates) on EOS-delimited packed documents; `--n-experts E` makes
every MLP a top-2 MoE, its expert axis "ep" if the mesh has one, else
"dp" (then the MoE exchange runs between the dp groups, which train in
lockstep); `--mesh pp=2,sp=2 --microbatches 2` trains the
pipeline-parallel model (stacked layers; microbatches default to the
stage count, and `--microbatches` without a pp axis exits, as in JAX),
beside dp, tp and ep too (`--mesh pp=2,dp=2,sp=2`, `--mesh
pp=2,tp=2,sp=2`).  `--multihost` (the JAX runner's multi-host start)
joins the process group (utils/multihost.initialize: torchrun's env://
over gloo) and lays the mesh over the processes in JAX's process-major
order (parallel/mesh.py `process_layout`, derived from the process
count): `--mesh dp=2,sp=2` in two processes puts a dp group in each,
every process reading its shard of the token stream; `--mesh
inter=2,intra=2` puts a half of the double ring's positions in each
(both read the same rows); `--mesh sp=4` splits the ring 2 + 2;
`--mesh tp=2,sp=2` puts a tp position's shards in each; `--mesh
ep=2,sp=2 --n-experts 4` an expert owner; `--mesh pp=2,sp=2` a stage.
A mesh whose positions do not divide between the processes raises
ValueError; a pipeline model with its sequence, tp or expert axis across
processes raises NotImplementedError naming ROADMAP A7b.  Only the
primary process logs and writes checkpoints; `--obs-export` writes one
file a process (`.p<rank>` before the suffix), which `python -m
burst_attn_tpu_torch.obs --merge` folds.  The JAX runner's
`--probe-tri-bwd` is a TPU compile probe and has no counterpart here.

    torchrun --nproc-per-node 2 -m burst_attn_tpu_torch.models.runner \
        --multihost --mesh dp=2,sp=2 --data tokens.batd --steps 100
"""

import argparse
import json
import os
from dataclasses import dataclass
from typing import Optional

from .. import obs
from ..data import DataLoader
from ..device import resolve_device
from ..obs import StepTimer
from ..parallel.mesh import process_axes_for
from ..utils import log_helper, multihost
from ..utils.checkpoint import Checkpointer
from .train import (
    TrainConfig, _world, data_shard, init_train_state, make_mesh,
    make_train_step, prefetch_batches,
)
from .transformer import ModelConfig


@dataclass(frozen=True)
class RunConfig:
    """One training run: data, duration, checkpointing cadence."""

    data_path: str
    steps: int
    batch: int
    seq_len: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 500
    ckpt_keep: int = 3  # checkpoints kept in ckpt_dir (newest first)
    log_every: int = 10
    seed: int = 0
    loader_threads: int = 2
    eval_data_path: Optional[str] = None
    eval_every: int = 500
    eval_batches: int = 16
    # packed-document training: EOS token id delimiting documents in the
    # stream (positions restart, attention isolated per document)
    packed_eos_id: Optional[int] = None
    # where the run's obs state is exported at the end (JSONL, read by
    # `python -m burst_attn_tpu_torch.obs`); None: BURST_OBS_EXPORT, if set
    obs_export: Optional[str] = None


def fit(cfg: ModelConfig, tcfg: TrainConfig, run: RunConfig, mesh=None, *,
        device=None):
    """Train for run.steps, checkpointing and resuming as configured, on
    `device` (default: the card).  Returns (state, history), history a
    list of {step, loss, grad_norm, step_s} and eval rows.  Each eval is
    the span `train.eval`; at the end the obs state goes to run.obs_export
    (or the BURST_OBS_EXPORT path) as a JSONL export, one file a process
    in a run across processes (multihost.process_path).  Each process
    reads its shard of the token stream (the loader's shard_id /
    num_shards: train.data_shard)."""
    log = log_helper.get_logger("burst_attn_tpu_torch.runner")
    primary = log_helper.is_primary()
    dev = resolve_device(device)
    _world(cfg, mesh)
    ckpt = None
    state, start_step = None, 0
    if run.ckpt_dir:
        ckpt = Checkpointer(run.ckpt_dir, max_to_keep=run.ckpt_keep)
        state, restored = ckpt.restore_latest(cfg, tcfg, mesh, device=dev)
        if restored is not None:
            start_step = restored
            if primary:
                log.info("resumed from step %d", start_step)
    if state is None:
        state = init_train_state(run.seed, cfg, tcfg, mesh, device=dev)

    step_fn = make_train_step(cfg, tcfg, mesh, device=dev)
    timer = StepTimer()
    history = []

    evaluator = None
    if run.eval_data_path:
        from .evaluate import Evaluator

        evaluator = Evaluator(cfg, mesh, run.eval_data_path, batch=run.batch,
                              seq_len=run.seq_len,
                              max_batches=run.eval_batches,
                              packed_eos_id=run.packed_eos_id, device=dev)

    def maybe_eval(step):
        if evaluator is None:
            return
        if (step + 1) % run.eval_every and step + 1 != run.steps:
            return
        with obs.span("train.eval", step=step + 1):
            metrics = evaluator(state[0])
        row = {"step": step + 1,
               **{k: round(v, 4) for k, v in metrics.items()}}
        history.append(row)
        if primary:
            log.info("%s", json.dumps(row))

    try:
        shard_id, num_shards = data_shard(cfg, mesh)
        with DataLoader(run.data_path, run.batch, run.seq_len,
                        shard_id=shard_id, num_shards=num_shards,
                        seed=run.seed, num_threads=run.loader_threads) as dl:
            if start_step:
                dl.seek(start_step)
            batches = prefetch_batches(dl, cfg, mesh,
                                       packed_eos_id=run.packed_eos_id,
                                       device=dev)
            for step in range(start_step, run.steps):
                batch = next(batches)
                with timer as t:
                    state, metrics = step_fn(state, batch)
                    t.watch(metrics["loss"])
                if (step + 1) % run.log_every == 0 or step + 1 == run.steps:
                    row = {"step": step + 1,
                           "loss": float(metrics["loss"]),
                           "grad_norm": float(metrics["grad_norm"]),
                           "step_s": timer.times[-1]}
                    history.append(row)
                    if primary:
                        log.info("%s", json.dumps(row))
                maybe_eval(step)
                if ckpt and ((step + 1) % run.ckpt_every == 0
                             or step + 1 == run.steps):
                    ckpt.save(step + 1, state)
    finally:
        if ckpt:
            ckpt.close()
        if evaluator is not None:
            evaluator.close()
    s = timer.summary()
    if s["steps"] and primary:
        log.info("done: %d steps, mean %.3fs/step", s["steps"], s["mean_s"])
    export_path = run.obs_export or os.environ.get("BURST_OBS_EXPORT")
    if export_path:
        export_path = multihost.process_path(export_path)
        parent = os.path.dirname(export_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        obs.export_jsonl(export_path)
        if primary:
            log.info("obs export written to %s", export_path)
    return state, history


def _parse_mesh(spec: str) -> dict:
    """"sp=4" -> {"sp": 4}; "dp=1,sp=2" -> {"dp": 1, "sp": 2} (order
    preserved)."""
    out = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        if not size:
            raise ValueError(f"bad mesh spec {spec!r}; want e.g. sp=4")
        out[name.strip()] = int(size)
    return out


def main(argv=None):
    """The CLI: parse `argv`, train (fit) and return fit's (state,
    history)."""
    p = argparse.ArgumentParser(
        description="Train the LM on a token file, on one device or a "
                    "mesh of pp, dp, sp, tp and ep positions sharing it.")
    p.add_argument("--data", required=True,
                   help="BATD token file (data.write_token_file)")
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seq-len", type=int, default=4096)
    p.add_argument("--mesh", default="sp=1",
                   help="axis sizes, e.g. sp=4 or inter=2,intra=2 (the "
                        "sequence ring), dp=2,sp=2,tp=2 (data and tensor "
                        "parallelism beside the ring), pp=2,sp=2 (a "
                        "pipeline of rings; dp, tp and ep beside it too)")
    p.add_argument("--microbatches", type=int, default=None,
                   help="GPipe microbatches of a pp mesh (default: the "
                        "pp size)")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group (torchrun's env:// over "
                        "gloo) and span the mesh's leading axes over the "
                        "processes (dp, or the double ring's inter axis)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--ckpt-keep", type=int, default=3)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--eval-data", default=None,
                   help="held-out BATD token file (perplexity eval)")
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--eval-batches", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--vocab", type=int, default=32768)
    p.add_argument("--d-model", type=int, default=1024)
    p.add_argument("--n-layers", type=int, default=8)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-kv-heads", type=int, default=None)
    p.add_argument("--d-ff", type=int, default=None)
    p.add_argument("--layout", default="zigzag")
    p.add_argument("--n-experts", type=int, default=0,
                   help="MoE experts per layer (0 = dense MLP)")
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--packed-eos", type=int, default=None,
                   help="EOS token id delimiting packed documents: positions "
                        "restart per document, loss masks boundaries, and "
                        "attention never crosses them (segment_ids)")
    p.add_argument("--obs-export", default=None,
                   help="JSONL the run's obs state is appended to at the "
                        "end, e.g. results/obs.jsonl (default: the "
                        "BURST_OBS_EXPORT path, if set)")
    args = p.parse_args(argv)
    if args.multihost:
        multihost.initialize()

    mesh_axes = _parse_mesh(args.mesh)
    # a double-ring mesh (inter, intra) maps straight onto seq_axes; any
    # other mesh uses a (possibly trivial) "sp" ring
    if "inter" in mesh_axes and "intra" in mesh_axes:
        seq_axes = ("inter", "intra")
    else:
        seq_axes = ("sp",)
        mesh_axes.setdefault("sp", 1)
    # experts shard over "ep" when the mesh has it, else ride "dp" (the
    # JAX runner's GShard layout)
    expert_axis = None
    if args.n_experts:
        expert_axis = "ep" if "ep" in mesh_axes else (
            "dp" if "dp" in mesh_axes else None)
    # a pp= axis turns on the pipeline-parallel forward (pipeline_lm.py);
    # microbatches default to the stage count (the GPipe sweet spot floor)
    pp_axis = "pp" if "pp" in mesh_axes else None
    if args.microbatches and not pp_axis:
        raise SystemExit("--microbatches requires a pp= axis in --mesh")
    cfg = ModelConfig(
        seq_axes=seq_axes, n_experts=args.n_experts, expert_axis=expert_axis,
        pp_axis=pp_axis,
        pp_microbatches=(args.microbatches or mesh_axes.get("pp", 1))
        if pp_axis else 1,
        batch_axis="dp" if "dp" in mesh_axes else None,
        head_axis="tp" if "tp" in mesh_axes else None, vocab=args.vocab,
        d_model=args.d_model, n_layers=args.n_layers, n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads or args.n_heads,
        d_head=args.d_model // args.n_heads,
        d_ff=args.d_ff or 4 * args.d_model, layout=args.layout,
        remat=not args.no_remat,
    )
    mesh = make_mesh(mesh_axes, process_axes=process_axes_for(
        mesh_axes, multihost.process_count()), device=args.device)
    tcfg = TrainConfig(lr=args.lr, grad_accum=args.grad_accum)
    run = RunConfig(
        data_path=args.data, steps=args.steps, batch=args.batch,
        seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, ckpt_keep=args.ckpt_keep,
        log_every=args.log_every, seed=args.seed,
        eval_data_path=args.eval_data, eval_every=args.eval_every,
        eval_batches=args.eval_batches, packed_eos_id=args.packed_eos,
        obs_export=args.obs_export,
    )
    return fit(cfg, tcfg, run, mesh, device=args.device)


if __name__ == "__main__":
    main()
