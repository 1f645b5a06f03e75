"""Multi-process runtime setup (port of burst_attn_tpu/utils/multihost.py).

Every process runs the same program.  `initialize` starts the process
group (torch.distributed over gloo: the reference's torchrun rendezvous,
test.sh:6), and `make_hybrid_mesh` gives a parallel/mesh.py `Mesh` of
the `dcn` axes (outermost) then the `ici` axes, laid over the processes
in JAX's process-major order: process r holds the flat positions
[r N/P, (r+1) N/P).  With dcn axes that multiply to the process count
each process holds one dcn index and every ici position (the double
ring's "inter" axis on the processes, its "intra" ring on the positions
of each); otherwise an axis may split between processes (sp=4 over two:
positions 0-1 in rank 0, 2-3 in rank 1), as JAX's reshape of the
process-major devices does.

Typical launch (one process per rank, e.g. under torchrun):

    from burst_attn_tpu_torch.utils import multihost
    multihost.initialize()                    # env:// under torchrun
    mesh = multihost.make_hybrid_mesh(ici={"intra": 2}, dcn={"inter": 2})
    # burst_attn(q_local, ..., mesh=mesh, seq_axes=("inter", "intra"))

Transport is gloo; NCCL needs a card a process and comes with ROADMAP
A7b.
"""

import datetime
import os
from typing import Dict, Optional

import torch.distributed as dist

# a crashed peer fails its partners' collectives after this long instead
# of hanging them
GROUP_TIMEOUT_S = 120.0


def _cluster_env() -> bool:
    """True iff the environment advertises a MULTI-process run: the
    signals the JAX package's auto-detection keys on, and torchrun's
    WORLD_SIZE > 1.  Single-valued forms (TPU_WORKER_HOSTNAMES=localhost,
    one-task SLURM/MPI jobs, WORLD_SIZE=1) do not count."""
    for v in ("MEGASCALE_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
              "JAX_COORDINATOR_ADDRESS", "JOBSET_NAME"):
        if os.environ.get(v):
            return True
    if "," in os.environ.get("TPU_WORKER_HOSTNAMES", ""):
        return True
    for v in ("OMPI_COMM_WORLD_SIZE", "SLURM_NTASKS", "SLURM_NPROCS",
              "WORLD_SIZE"):
        try:
            if int(os.environ.get(v, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo") -> None:
    """Start the process group.  With no arguments it reads torchrun's
    environment (`env://`: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE);
    with them, `coordinator_address` is a `tcp://host:port` or
    `file://path` rendezvous (a bare host:port means tcp) for
    `num_processes` processes, this one `process_id`.

    The JAX package's tolerance rules: a second call is benign; with no
    arguments and no cluster environment the call does nothing (one
    process); wrong explicit arguments, or a cluster environment whose
    rendezvous fails, raise (N duplicate single-process jobs must not run
    silently).  `backend="nccl"` raises NotImplementedError: NCCL needs a
    card a process (ROADMAP A7b); the transport never switches silently.
    """
    if backend == "nccl":
        raise NotImplementedError(
            "backend='nccl': NCCL needs one card a process, and the ring "
            "across cards is ROADMAP A7b; use backend='gloo'")
    if backend != "gloo":
        raise ValueError(f"backend must be 'gloo', got {backend!r}")
    if dist.is_initialized():
        return  # a double initialize is benign
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError("num_processes / process_id need a "
                             "coordinator_address")
        if not _cluster_env():
            return  # one process, nothing to join
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return
    if num_processes is None or process_id is None:
        raise ValueError("an explicit coordinator_address needs "
                         "num_processes and process_id")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process_id {process_id} outside "
                         f"{num_processes} processes")
    addr = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)


def shutdown() -> None:
    """Tear the process group down (nothing without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The processes of the run (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_path(path: str) -> str:
    """`path` for this process's own copy of a per-process file: with more
    than one process, `.p<rank>` before the suffix (obs.jsonl ->
    obs.p1.jsonl; `python -m burst_attn_tpu_torch.obs --merge
    'obs*.jsonl'` folds them); unchanged in one process."""
    if process_count() == 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.p{process_index()}{ext}"


def make_hybrid_mesh(ici: Dict[str, int], dcn: Dict[str, int], *,
                     device=None):
    """A Mesh of the `dcn` axes (outermost) then the `ici` axes on this
    process's device (default: the card), laid over the run's processes
    in JAX's process-major order (parallel/mesh.py process_layout): any
    axes, any sizes; in one process every axis is positions here.  The
    mesh's positions must divide between the processes (ValueError)."""
    from ..parallel.mesh import Mesh

    shape = dict(dcn, **ici)
    if len(shape) != len(dcn) + len(ici):
        raise ValueError(f"an axis is in both dcn {dcn} and ici {ici}")
    if process_count() == 1:
        return Mesh(shape, device=device)
    return Mesh(shape, device=device, process_axes="auto")
