"""Multi-host (multi-process) worlds and meshes for encrypted serving.

Counterpart of `orion_tpu/parallel/multihost.py`.  The production layout
across hosts:

  * ``dp``   (independent encrypted queries) is laid out ACROSS hosts: it
    exchanges only requests and responses, so it can ride the slow links
    between hosts;
  * ``limb`` (the RNS rows of each key-switch, `limbshard.py`) is laid out
    WITHIN a host: its all-gather and all-reduce per key-switch are
    latency-critical and must stay on the host's own links (NVLink).

orion_tpu joins one JAX process per host, each with several devices.  The
port runs one process per device (rank), as torch.distributed does: NCCL
with one CUDA device per local rank by default.  The host of a rank comes
from `LOCAL_WORLD_SIZE` (ranks 0..k-1 on the first host, as torchrun
numbers them) or, without it, from an exchange of host names.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh

_DEVICE: torch.device | None = None


def _local_rank(rank: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if "LOCAL_WORLD_SIZE" in os.environ:
        return rank % int(os.environ["LOCAL_WORLD_SIZE"])
    return rank


def init_multihost(init_method=None, world_size: int | None = None,
                   rank: int | None = None, backend: str | None = None,
                   device=None, timeout_s: float = 600.0) -> torch.device:
    """Join (or start) a torch.distributed world; returns this rank's
    device.

    `init_method` is a URL (``tcp://host:port``, ``file://...``), an
    (address, port) pair, or None for the ``env://`` variables torchrun
    sets (as are `world_size` and `rank` when None).  The device is
    ``cuda`` (the local rank's card, which becomes the current device)
    unless the caller passes another: ``cuda:i`` for one card of the
    caller's choice, or ``cpu``.  The backend is NCCL on CUDA and gloo on
    the CPU, or the one the caller names; gloo also carries CUDA tensors
    (through host memory), which lets several ranks share one card,
    where NCCL refuses.  Without CUDA this raises unless the caller asks
    for the CPU or for gloo (then the device defaults to the CPU).
    Idempotent: a second call returns the first call's device."""
    global _DEVICE
    if dist.is_initialized():
        if _DEVICE is None:
            raise RuntimeError("torch.distributed was initialised outside "
                               "init_multihost")
        return _DEVICE
    if isinstance(init_method, (tuple, list)):
        addr, port = init_method
        init_method = f"tcp://{addr}:{int(port)}"
    if device is None:
        device = "cpu" if backend == "gloo" else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: init_multihost runs ranks on the GPU by "
                "default; pass device='cpu' or backend='gloo' to run them "
                "on the host")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if init_method is None:
        init_method = "env://"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", _local_rank(rank))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} asks for {dev}; the host has "
                               f"{torch.cuda.device_count()} CUDA devices")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    _DEVICE = dev
    return dev


def rank_hosts() -> list[int]:
    """The host index of every rank of the world (hosts numbered in the
    order of their first rank)."""
    world = dist.get_world_size()
    if "LOCAL_WORLD_SIZE" in os.environ:
        per = int(os.environ["LOCAL_WORLD_SIZE"])
        return [r // per for r in range(world)]
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    order: dict = {}
    return [order.setdefault(h, len(order)) for h in names]


def make_dcn_mesh(dp: int | None = None, limb: int = 1,
                  hosts: list[int] | None = None) -> Mesh:
    """Build a (dp, limb) mesh of the world with dp spanning hosts and
    each limb group within one host.

    Each ROW (fixed dp index, varying limb) holds ranks of one host, so
    the collectives over ``limb`` stay on the host, while ``dp`` crosses
    hosts where the forward needs no communication at all.  `hosts` (the
    host of each rank) defaults to `rank_hosts()`.

    Constraints: ``limb`` must divide the ranks per host (a limb group
    must not straddle hosts) and dp * limb must equal the world size.
    With ``dp=None`` it is derived."""
    n = dist.get_world_size()
    hosts = rank_hosts() if hosts is None else list(hosts)
    if len(hosts) != n:
        raise ValueError(f"{len(hosts)} hosts given for {n} ranks")
    if dp is None:
        if n % limb:
            raise ValueError(f"{n} ranks not divisible by limb={limb}")
        dp = n // limb
    if dp * limb != n:
        raise ValueError(f"dp*limb = {dp}*{limb} != {n} ranks")
    by_host: dict[int, list[int]] = {}
    for r, h in enumerate(hosts):
        by_host.setdefault(h, []).append(r)
    per_host = [len(v) for v in by_host.values()]
    if len(set(per_host)) > 1:
        raise ValueError(f"uneven ranks per host: {per_host}")
    if per_host[0] % limb:
        raise ValueError(
            f"limb={limb} must divide the per-host rank count "
            f"{per_host[0]} so limb collectives never cross hosts")
    rows = []
    for h in sorted(by_host):
        local = by_host[h]
        rows += [local[i:i + limb] for i in range(0, len(local), limb)]
    return Mesh(np.array(rows).reshape(dp, limb), ("dp", "limb"),
                hosts=hosts)


def mesh_report(mesh: Mesh) -> dict:
    """Topology summary: the mesh's shape, its processes (ranks) and
    hosts, and which axes cross host boundaries."""
    hosts = rank_hosts() if mesh.hosts is None else mesh.hosts
    host = np.vectorize(lambda r: hosts[r])(mesh.ranks)
    out = {"shape": dict(mesh.shape),
           "num_processes": int(mesh.ranks.size),
           "num_hosts": len(set(host.flat))}
    for ax, name in enumerate(mesh.axis_names):
        moved = np.moveaxis(host, ax, 0)
        crosses = any(len(set(moved[(slice(None),) + idx].flat)) > 1
                      for idx in np.ndindex(*moved.shape[1:]))
        out[f"{name}_crosses_hosts"] = bool(crosses)
    return out
