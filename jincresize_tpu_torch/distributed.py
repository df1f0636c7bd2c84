"""Multi-process entry point: the torch.distributed process group and meshes
that span its ranks.

Port of ``jincresize_tpu/distributed.py``. The JAX module joins hosts with
``jax.distributed.initialize`` and lays the ``rows`` axis of a mesh along
``jax.devices()``; here ``init_distributed`` forms a ``torch.distributed``
process group and ``global_mesh`` builds a ``sharding.RowMesh`` over every
rank's devices, whose ``ranks`` grid says which process owns each entry.
``sharding.ShardedApplier`` on such a mesh builds and runs only the calling
process's shards, takes the halo rows of the others' shards over the process
group, and returns this process's rows (``.index``, ``.data``).

Launch recipe (one process per host, all hosts run the same program):

    # host 0 (coordinator), N hosts total:
    JINCRESIZE_COORDINATOR=host0:8476 JINCRESIZE_NUM_PROCESSES=N \
    JINCRESIZE_PROCESS_ID=0 python my_resize_job.py
    # host k:
    JINCRESIZE_COORDINATOR=host0:8476 JINCRESIZE_NUM_PROCESSES=N \
    JINCRESIZE_PROCESS_ID=k python my_resize_job.py

    # my_resize_job.py:
    from jincresize_tpu_torch.distributed import init_distributed, global_mesh
    from jincresize_tpu_torch.sharding import ShardedApplier
    init_distributed()                    # reads the variables above
    mesh = global_mesh()                  # rows axis over every rank's card
    for shard in ShardedApplier(op, mesh)(src):
        ...                               # shard.data is result[shard.index]

``torchrun`` works too: with none of the variables above set,
``init_distributed()`` joins the group that ``MASTER_ADDR``/``WORLD_SIZE``/
``RANK`` describe, and ``global_mesh`` takes ``cuda:{LOCAL_RANK}``.

The default backend is gloo: the halos of CUDA shards cross through host
buffers, and several processes may share one card (NCCL refuses two ranks
on one card). NCCL is the default only under ``torchrun``, whose
``LOCAL_WORLD_SIZE`` says how many processes share the host, and only where
each of them has a card of its own; a caller may name either backend. The
NCCL transport (halos sent from the card) has not yet run on more than one
card.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .sharding import RowMesh, make_mesh


def default_backend() -> str:
    """``'nccl'`` where torchrun's ``LOCAL_WORLD_SIZE`` is set and every
    process of this host has a card of its own, else ``'gloo'``."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is None or not (torch.cuda.is_available() and dist.is_nccl_available()):
        return "gloo"
    return "nccl" if int(local) <= torch.cuda.device_count() else "gloo"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the multi-process group (idempotent).

    Arguments default to ``JINCRESIZE_COORDINATOR`` (``host:port``) /
    ``JINCRESIZE_NUM_PROCESSES`` / ``JINCRESIZE_PROCESS_ID``; a partial set
    raises. With none set, joins ``torchrun``'s group when ``MASTER_ADDR``,
    ``WORLD_SIZE`` and ``RANK`` are all set, and otherwise does nothing (a
    single-process run). ``backend`` defaults to ``default_backend()``.
    """
    coordinator_address = coordinator_address or os.environ.get("JINCRESIZE_COORDINATOR")
    if num_processes is None and "JINCRESIZE_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JINCRESIZE_NUM_PROCESSES"])
    if process_id is None and "JINCRESIZE_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JINCRESIZE_PROCESS_ID"])
    explicit = {
        "coordinator_address": coordinator_address,
        "num_processes": num_processes,
        "process_id": process_id,
    }
    given = [k for k, v in explicit.items() if v is not None]
    if given and len(given) != len(explicit):
        missing = sorted(set(explicit) - set(given))
        raise ValueError(
            "init_distributed: cluster coordinates must be fully specified — "
            f"got {sorted(given)} but missing {missing} (set the matching "
            "JINCRESIZE_COORDINATOR / JINCRESIZE_NUM_PROCESSES / "
            "JINCRESIZE_PROCESS_ID or pass all three arguments)"
        )
    if dist.is_initialized():
        return
    if not given:
        if all(v in os.environ for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            dist.init_process_group(backend or default_backend(), init_method="env://")
        return
    dist.init_process_group(
        backend or default_backend(),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def global_mesh(n_rows: int | None = None, n_data: int = 1, devices=None) -> RowMesh:
    """('data', 'rows') mesh over every device of every rank.

    ``devices`` are this rank's (default: ``cuda:{LOCAL_RANK}``, raising
    when no card is visible; CPU callers pass ``["cpu"] * k``); every rank
    must list as many. The lists are exchanged and laid out rank by rank,
    each rank's own first as ``jax.devices()`` enumerates, so each rank's
    row shards are contiguous and halos cross processes only at rank
    boundaries. Without a process group this is ``make_mesh`` over
    ``devices``.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_mesh: no CUDA device is visible")
        devices = [torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))]
    devices = [torch.device(d) for d in devices]
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return make_mesh(n_rows=n_rows, n_data=n_data, devices=devices)
    if dist.get_backend() == "nccl" and devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, [str(d) for d in devices])
    if len({len(x) for x in lists}) != 1:
        raise ValueError(
            f"global_mesh: every rank must hold as many devices, got {[len(x) for x in lists]}"
        )
    flat = [torch.device(d) for x in lists for d in x]
    owner = [r for r, x in enumerate(lists) for _ in x]
    mesh = make_mesh(n_rows=n_rows, n_data=n_data, devices=flat)
    n = mesh.n_rows
    ranks = tuple(tuple(owner[j * n : (j + 1) * n]) for j in range(mesh.n_data))
    return RowMesh(mesh.devices, ranks)
