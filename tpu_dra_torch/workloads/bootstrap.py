"""Consume the driver-injected bootstrap environment with torch.distributed.

Counterpart of ``tpu_dra/workloads/bootstrap.py``. The CD kubelet plugin
injects (via CDI) the env the slice daemon rendered
(``tpu_dra/computedomain/daemon/bootstrap.py``): TPU_WORKER_ID,
TPU_WORKER_HOSTNAMES, JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
MEGASCALE_*. The driver renders these names and they are the contract,
so the port reads the same ones. A workload calls
:func:`initialize_from_env` first thing; on a single-process allocation
it is a no-op.

Where JAX calls ``jax.distributed.initialize``, the port builds a
``torch.distributed`` process group: rank = ``TPU_WORKER_ID``, world =
``JAX_NUM_PROCESSES``, over a ``TCPStore`` at the resolved coordinator
``host:port`` (rank 0 serves it). The backend is NCCL for a CUDA device
and gloo for the CPU.

Multi-slice domains rendezvous per slice, as JAX does:
``JAX_NUM_PROCESSES`` and the coordinator are slice-local, and
``MEGASCALE_*`` only names the slice. JAX leaves the cross-slice (DCN)
traffic to libtpu's megascale layer; the port has no counterpart of it,
so a process group never spans slices.

The env parsing (``resolve_coordinator``, ``SliceEnv``,
``read_slice_env``) and ``read_bootstrap_env`` (the daemon's reader of
``bootstrap.env``) are copies: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import socket
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.distributed.constants as dist_constants

from tpu_dra_torch.workloads.device import resolve_device

log = logging.getLogger(__name__)

#: Where the CD kubelet plugin mounts the per-domain config dir into
#: workload containers (the /imexd analog).
DEFAULT_CONFIG_DIR = "/tpu-cd"

#: The rendezvous bound, overridable per fleet (JAX's
#: ``initialization_timeout``).
DEFAULT_INIT_TIMEOUT_SECONDS = 120


def read_bootstrap_env(config_dir: str) -> Optional[Dict[str, str]]:
    """The KEY=VALUE lines of ``<config_dir>/bootstrap.env`` as a dict,
    or None when the file is missing."""
    path = os.path.join(config_dir, "bootstrap.env")
    try:
        with open(path) as f:
            out = {}
            for line in f:
                line = line.strip()
                if line and "=" in line:
                    k, _, v = line.partition("=")
                    out[k] = v
            return out
    except FileNotFoundError:
        return None


def resolve_coordinator(address: str, config_dir: Optional[str] = None) -> str:
    """Resolve the rendered coordinator address to something dialable.

    The daemon renders ``JAX_COORDINATOR_ADDRESS`` with daemon-0's
    stable DNS name, normally resolvable through the /etc/hosts block
    the daemon maintains. A workload that does not share that hosts file
    can still rendezvous: the same config dir carries ``peers.json``,
    which maps every peer's DNS name to its registered IP, so fall back
    to it. Returns the address unchanged when neither resolves it.
    """
    host, _, port = address.rpartition(":")
    if not host:
        return address
    try:
        socket.getaddrinfo(host, None)
        return address
    except socket.gaierror:
        pass
    cfg = config_dir or os.environ.get("CD_CONFIG_DIR", DEFAULT_CONFIG_DIR)
    peers_path = os.path.join(cfg, "peers.json")
    try:
        with open(peers_path) as f:
            peers = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return address
    for p in peers:
        if p.get("dnsName") == host and p.get("ipAddress"):
            resolved = f"{p['ipAddress']}:{port}"
            log.info("resolved coordinator %s -> %s via %s",
                     address, resolved, peers_path)
            return resolved
    return address


@dataclass
class SliceEnv:
    worker_id: int = 0
    num_processes: int = 1
    coordinator_address: str = ""
    accelerator_type: str = ""
    topology: str = ""
    num_slices: int = 1
    slice_id: int = 0

    @property
    def multi_host(self) -> bool:
        return self.num_processes > 1


def read_slice_env(env: Optional[dict] = None) -> SliceEnv:
    e = env if env is not None else os.environ
    return SliceEnv(
        worker_id=int(e.get("TPU_WORKER_ID", e.get("JAX_PROCESS_ID", "0")) or 0),
        num_processes=int(e.get("JAX_NUM_PROCESSES", "1") or 1),
        coordinator_address=e.get("JAX_COORDINATOR_ADDRESS", ""),
        accelerator_type=e.get("TPU_ACCELERATOR_TYPE", ""),
        topology=e.get("TPU_TOPOLOGY", ""),
        num_slices=int(e.get("MEGASCALE_NUM_SLICES", "1") or 1),
        slice_id=int(e.get("MEGASCALE_SLICE_ID", "0") or 0),
    )


def mesh_config_from_slice_env(
    se: SliceEnv, chips_per_host: int, tp: int = 1, sp: int = 1
):
    """The mesh a CD-bootstrapped trainer should use: the slice axis
    (DCN, gradient-only traffic) maps to ``dp``, and hosts x chips
    within a slice fill ``fsdp``, less any tp/sp the caller claims.
    Raises ValueError when the devices do not factor."""
    from tpu_dra_torch.workloads.train import MeshConfig

    total = se.num_processes * chips_per_host * se.num_slices
    inner, rem = divmod(total, se.num_slices * tp * sp)
    if rem:
        raise ValueError(
            f"cannot factor {total} devices into slices={se.num_slices} "
            f"tp={tp} sp={sp}"
        )
    return MeshConfig(dp=se.num_slices, fsdp=inner, sp=sp, tp=tp)


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def rendezvous(
    coordinator: str, rank: int, world: int, device=None,
    timeout_s: float = DEFAULT_INIT_TIMEOUT_SECONDS,
    backend: Optional[str] = None,
) -> str:
    """Join the default process group of ``world`` ranks as ``rank``
    through the TCPStore at ``coordinator`` (``host:port``; rank 0
    serves it on that port). Returns the backend: NCCL for a CUDA
    ``device`` (the default), gloo for the CPU, or ``backend`` when
    given (gloo over CUDA tensors puts several ranks on one card, which
    NCCL refuses; it stages each collective through host memory).

    ``timeout_s`` bounds the rendezvous only: rank 0 waits that long for
    every peer to connect and a peer that long for rank 0, then raises.
    The collectives keep torch's own timeout: the process group's
    ``timeout`` would shorten it along with the rendezvous, and a group
    built on a given store keeps that store's timeout for its own reads
    (NCCL reads its communicator ids from the store at each first
    collective), so the store's timeout goes back to torch's default
    once the group is up.
    """
    device = resolve_device(device)
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r} is not host:port")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    backend = backend or backend_for(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    store = dist.TCPStore(
        host, int(port), world_size=world, is_master=rank == 0,
        timeout=datetime.timedelta(seconds=timeout_s),
        wait_for_workers=True,
    )
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    store.set_timeout(collective_timeout(backend))
    return backend


def collective_timeout(backend: str) -> datetime.timedelta:
    """torch's default timeout for a process group of ``backend``."""
    if backend == "nccl" and isinstance(
            dist_constants.default_pg_nccl_timeout, datetime.timedelta):
        return dist_constants.default_pg_nccl_timeout
    return dist_constants.default_pg_timeout


def shutdown() -> None:
    """Leave the default process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def initialize_from_env(
    env: Optional[dict] = None, config_dir: Optional[str] = None,
    device=None, backend: Optional[str] = None,
) -> SliceEnv:
    """torch.distributed from the injected bootstrap env: a no-op on
    single-process allocations, else :func:`rendezvous` at the resolved
    coordinator with rank ``worker_id`` and world ``num_processes``.
    ``config_dir`` points at the mounted per-CD config dir for the
    peers.json fallback (default ``$CD_CONFIG_DIR`` or /tpu-cd);
    ``device`` picks the backend (default: the CUDA device, NCCL)
    unless ``backend`` names one.

    A peer that never arrives fails the rendezvous within
    ``TPU_DRA_INIT_TIMEOUT_SECONDS`` (default 120): the Job-level restart
    then replaces a severed worker quickly instead of after a silent
    stall.
    """
    e = env if env is not None else os.environ
    se = read_slice_env(e)
    device = resolve_device(device)
    if se.multi_host and se.coordinator_address:
        coordinator = resolve_coordinator(se.coordinator_address, config_dir)
        timeout_s = int(e.get("TPU_DRA_INIT_TIMEOUT_SECONDS",
                              str(DEFAULT_INIT_TIMEOUT_SECONDS)))
        log.info(
            "initializing torch.distributed (%s): process %d/%d via %s",
            backend or backend_for(device), se.worker_id, se.num_processes,
            coordinator,
        )
        rendezvous(coordinator, se.worker_id, se.num_processes, device,
                   timeout_s, backend)
    return se
