"""Joining a ``torch.distributed`` world, counterpart of
``cgat_tpu/parallel/distributed.py``.

A world is one process per rank, described by the environment torchrun
sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), on one host or many; ``cli.train
--devices N`` sets the same for N ranks it starts on one host. The backend
follows the device: NCCL for CUDA cards, one card a rank (``LOCAL_RANK``),
gloo for the CPU. Data stays process-local: every rank computes the same
shuffled order and collates only its own replica
(``ParallelLoader(process_index=dp_index, process_count=dp)``).
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from .mesh import Mesh


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def rank_device(device: torch.device, backend: str) -> torch.device:
    """This rank's device: for NCCL the card ``LOCAL_RANK`` (raising,
    with both counts, when the host holds more ranks than visible cards);
    for gloo on CUDA, ranks beyond the cards share them round robin (the
    several-ranks-on-one-card check); the CPU as it is."""
    if device.type != "cuda":
        return device
    cards = torch.cuda.device_count()
    local_rank = _env_int("LOCAL_RANK", 0)
    if backend == "nccl":
        local_world = _env_int("LOCAL_WORLD_SIZE",
                               dist.get_world_size() if dist.is_initialized()
                               else _env_int("WORLD_SIZE", 1))
        if local_world > cards or local_rank >= cards:
            raise RuntimeError(
                f"an NCCL world with {local_world} ranks on this host needs "
                f"{local_world} cards, and {cards} are visible (NCCL takes "
                f"one card a rank)")
        return torch.device("cuda", local_rank)
    return torch.device("cuda", local_rank % max(cards, 1))


def init_distributed(device, *, backend: str | None = None) -> torch.device:
    """Join the world the environment describes (unless this process has
    joined one already) and return this rank's device, made the current
    CUDA device. ``backend``: NCCL for CUDA and gloo for the CPU unless
    given; the only other choice taken is gloo on CUDA, which puts several
    ranks on one card."""
    device = torch.device(device)
    want = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        backend = dist.get_backend()
    backend = backend or want
    if backend not in (want, "gloo"):
        raise ValueError(f"backend {backend!r} on {device.type}: the port "
                         f"runs {want}, or gloo")
    device = rank_device(device, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=_env_int("RANK", 0),
                                world_size=_env_int("WORLD_SIZE", 1))
    return device


def local_dp_rows(mesh: Mesh) -> tuple[int, int]:
    """(offset, count) of the dp rows whose ranks are on this host. Raises
    when an edge group would straddle hosts (a host's rank count not a
    multiple of ``edge``): its exchanges must stay on one host."""
    edge = mesh.edge.size
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE")
                      or dist.get_world_size())
    if local_world % edge:
        raise ValueError(
            f"{local_world} ranks a host do not hold whole edge groups of "
            f"{edge}: an edge group would straddle hosts")
    host = dist.get_rank() // local_world
    return host * local_world // edge, local_world // edge


def free_port() -> int:
    """A free TCP port on this host for a world's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
