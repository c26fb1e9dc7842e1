"""The process group, the walker shards and the collectives (port of
``deephall_tpu/parallel/mesh.py``).

Walkers are split into equal contiguous shards of the global ``[batch, nelec,
2]`` batch, one per rank, in rank order; parameters, optimizer state, widths
and statistics are replicated.  Every other module reaches ``torch.distributed``
through the functions here.  Without a process group each collective returns
its input and calls nothing, so a single process runs exactly the code it ran
before this module existed; a launch of one process (``WORLD_SIZE=1``) makes a
real group of one, whose collectives are real calls.

Launches: ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), Slurm (``SLURM_PROCID``, ``SLURM_NTASKS``,
``SLURM_LOCALID``) and OpenMPI (``OMPI_COMM_WORLD_RANK``,
``OMPI_COMM_WORLD_SIZE``, ``OMPI_COMM_WORLD_LOCAL_RANK``); the last two
rendezvous at ``MASTER_ADDR:MASTER_PORT`` too.  The backend is NCCL on CUDA
devices and gloo on the CPU unless the caller names one: two ranks on one card
need gloo, because NCCL refuses them.  Both take CUDA tensors in every
collective used here, so nothing is staged through the host.

A process joins its launch's group once and keeps it until it exits: a second
entry point called in the same process (the observables CLI once for each
estimator, say) takes the group it finds.  Leaving and joining again at the
same ``MASTER_ADDR:MASTER_PORT`` would race: a rank could reach the old
rendezvous store before rank 0 had closed it, and the join then failed or hung.
"""

from __future__ import annotations

import atexit
import datetime
import itertools
import logging
import os
import socket
from pathlib import Path

import torch
import torch.distributed as dist

from deephall_tpu_torch.utils import resolve_device

logger = logging.getLogger("deephall")

BACKENDS = ("nccl", "gloo")

# (rank, world size, local rank) variables of each launcher, in the order tried.
_LAUNCHERS = (
    ("RANK", "WORLD_SIZE", "LOCAL_RANK"),
    ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
    ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"),
)


def launch_env() -> tuple[int, int, int] | None:
    """``(rank, world_size, local_rank)`` that the launcher announces, or ``None``.

    ``WORLD_SIZE`` (torchrun, or set by hand) announces a launch of any size,
    one included; Slurm and OpenMPI announce one only with more than one task,
    so that a single-task job runs as a single process.
    """
    for i, (rank_var, size_var, local_var) in enumerate(_LAUNCHERS):
        size = os.environ.get(size_var)
        if size is None or (i > 0 and int(size) <= 1):
            continue
        if rank_var not in os.environ:
            raise RuntimeError(f"{size_var}={size} is set but {rank_var} is not")
        rank = int(os.environ[rank_var])
        return rank, int(size), int(os.environ.get(local_var, rank))
    return None


def device_for_rank(device: str | torch.device, local_rank: int) -> torch.device:
    """``cuda`` becomes ``cuda:{local_rank}``; an explicit index is kept, so that
    ``cuda:0`` puts every rank on card 0 (a one-card check, with gloo)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local_rank} has no card: {torch.cuda.device_count()} visible")
        device = torch.device("cuda", local_rank)
    return device


# The kernel hands out ports of this range to bind(0) and to every connect.
EPHEMERAL_RANGE = Path("/proc/sys/net/ipv4/ip_local_port_range")
PORT_BLOCK = 256
_port_offsets: dict[int, itertools.count] = {}


def rendezvous_port(block: int = 0) -> int:
    """A free port of this host for ``MASTER_PORT``, from below the ephemeral range.

    A port that ``bind(0)`` finds free is closed again before rank 0's store
    binds it, seconds later (after the children's imports), and meanwhile the
    kernel may hand it to any socket of the host: every ``bind(0)`` and every
    outgoing ``connect`` draw from the ephemeral range.  Below that range the
    kernel hands out no port unasked.  Callers that pick ports at the same
    time take different ``block`` numbers (``PORT_BLOCK`` ports each, counted
    down from the range's start); within its block a process starts at an
    offset from its id, moves on with every call, and takes the first port
    that a bind without ``SO_REUSEADDR`` finds free (not one still in
    ``TIME_WAIT``).
    """
    low = int(EPHEMERAL_RANGE.read_text().split()[0]) if EPHEMERAL_RANGE.exists() else 32768
    start = low - (block + 1) * PORT_BLOCK
    if start < 1024:
        raise ValueError(f"port block {block} lies below 1024 (ephemeral range from {low})")
    offsets = _port_offsets.setdefault(block, itertools.count(os.getpid() % PORT_BLOCK))
    for _ in range(PORT_BLOCK):
        port = start + next(offsets) % PORT_BLOCK
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in {start}..{start + PORT_BLOCK - 1}")


def initialize_distributed(
    device: str | torch.device = "cuda", backend: str | None = None, timeout: float | None = None
) -> torch.device:
    """Join the process group that the launch announces, and return this rank's device.

    Without a launch (no variables of ``launch_env``) nothing is joined and the
    device is ``device`` itself.  Joining twice returns the device again.  The
    group is left when the process exits (or by :func:`shutdown_distributed`).  A
    launch that cannot rendezvous within ``timeout`` seconds (torch's default
    when ``None``) raises: no rank carries on alone.

    Args:
        device: ``cuda`` (the card of this rank's local rank), ``cuda:K`` or ``cpu``.
        backend: ``nccl`` or ``gloo``; by default NCCL on CUDA and gloo on the CPU.
        timeout: seconds for the rendezvous and for every later collective.
    """
    launch = launch_env()
    if launch is None:
        return resolve_device(device)
    rank_, size, local_rank = launch
    device = device_for_rank(device, local_rank)
    if dist.is_initialized():
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    address, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if not (address and port):
        raise RuntimeError(
            f"a launch of {size} processes needs MASTER_ADDR and MASTER_PORT for the rendezvous")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(
            backend,
            init_method=f"tcp://{address}:{port}",
            world_size=size,
            rank=rank_,
            timeout=datetime.timedelta(seconds=timeout) if timeout else None,
            device_id=device if backend == "nccl" else None,
        )
    except RuntimeError as e:
        raise RuntimeError(
            f"rank {rank_} of {size} could not rendezvous at {address}:{port} ({backend}): {e}"
        ) from e
    atexit.register(shutdown_distributed)
    logger.info("Joined the process group: rank %d of %d on %s (%s)", rank_, size, device, backend)
    return device


def shutdown_distributed() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def in_group() -> bool:
    """Whether this process joined a process group (a launch of any size)."""
    return dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global walker-major array: the ``rank``-th of
    ``world_size`` equal contiguous blocks, as a tensor of its own (contiguous,
    in fresh memory).  ``x`` itself when there is one rank."""
    size = world_size()
    if size == 1:
        return x
    if x.shape[0] % size:
        raise ValueError(f"{x.shape[0]} rows do not split over {size} ranks")
    rows = x.shape[0] // size
    return x[rank() * rows:(rank() + 1) * rows].clone(memory_format=torch.contiguous_format)


def draw_rows(fn, shape: tuple[int, ...], **kwargs) -> torch.Tensor:
    """This rank's rows of ``fn(global_shape, **kwargs)``, a draw of the whole batch.

    ``shape`` is this rank's; the global shape has ``world_size`` times its
    rows.  Every rank draws from the same generator state, so each walker gets
    the numbers it would get on one rank, and the generators stay in step.
    """
    return shard_rows(fn((world_size() * shape[0], *shape[1:]), **kwargs))


def _pack(tensors) -> tuple[torch.Tensor, list]:
    """One flat buffer of the tensors (complex ones as real pairs), and their layout."""
    parts = [torch.view_as_real(t) if t.is_complex() else t for t in tensors]
    if len({p.dtype for p in parts}) != 1:
        raise TypeError(f"packed collectives need one real dtype, got {[p.dtype for p in parts]}")
    layout = [(p.shape, t.is_complex()) for p, t in zip(parts, tensors)]
    return torch.cat([p.reshape(-1) for p in parts]), layout


def _unpack(flat: torch.Tensor, layout: list) -> list[torch.Tensor]:
    out, start = [], 0
    for shape, is_complex in layout:
        n = shape.numel()
        part = flat[start:start + n].reshape(shape)
        out.append(torch.view_as_complex(part.clone()) if is_complex else part)
        start += n
    return out


def _all_reduce(op, tensors):
    if not dist.is_initialized():
        return tensors[0] if len(tensors) == 1 else tensors
    flat, layout = _pack(tensors)
    dist.all_reduce(flat, op=op)
    out = _unpack(flat, layout)
    return out[0] if len(out) == 1 else tuple(out)


def all_reduce_sum(*tensors: torch.Tensor):
    """The sum over the ranks of each tensor, as new tensors (one collective for
    all of them); the tensors themselves without a process group."""
    return _all_reduce(dist.ReduceOp.SUM, tensors)


def all_reduce_max(*tensors: torch.Tensor):
    """The elementwise largest value over the ranks (real tensors), as ``all_reduce_sum``."""
    return _all_reduce(dist.ReduceOp.MAX, tensors)


def all_reduce_mean(*tensors: torch.Tensor):
    """The mean over the ranks: of per-rank means over equal shards, the global mean."""
    if not dist.is_initialized():
        return tensors[0] if len(tensors) == 1 else tensors
    out = all_reduce_sum(*tensors)
    size = world_size()
    return out / size if len(tensors) == 1 else tuple(t / size for t in out)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global walker-major array: every rank's ``x`` (one shape on all
    ranks) stacked along the rows in rank order, on ``x``'s device."""
    if not dist.is_initialized():
        return x
    part = (torch.view_as_real(x) if x.is_complex() else x).contiguous()
    pieces = [torch.empty_like(part) for _ in range(world_size())]
    dist.all_gather(pieces, part)
    out = torch.cat(pieces)
    return torch.view_as_complex(out) if x.is_complex() else out


def broadcast_(*tensors: torch.Tensor, src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s, in place (one collective for all)."""
    if not dist.is_initialized():
        return
    flat, layout = _pack(tensors)
    dist.broadcast(flat, src=src)
    with torch.no_grad():
        for t, part in zip(tensors, _unpack(flat, layout)):
            t.copy_(part)
