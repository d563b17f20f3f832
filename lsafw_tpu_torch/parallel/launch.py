"""Multi-process launch on ``torch.distributed`` (the ``mpirun -n <np>`` story).

Counterpart of the reference's ``parallel/launch.py``.  One process per
rank, each on its own device, joined into one process group by
:func:`initialize_distributed`:

    torchrun --nproc-per-node N -m lsafw_tpu_torch --distributed eigen ...
    # or programmatically:
    from lsafw_tpu_torch.parallel import initialize_distributed, global_mesh
    initialize_distributed()      # from MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE
    mesh = global_mesh()          # 1D "dof" mesh over every rank

Host planning (meshing, RCM, segmentation, the Schur bookkeeping) is
replicated on every rank, each computing the same values; the device
work and its collectives are per rank.  Logging comes from rank 0 only:
the other ranks' package logger is set to ERROR.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from lsafw_tpu_torch import resolve_device
from lsafw_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_DEVICE: list = []  # the device initialize_distributed gave this rank


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, *, backend: str | None = None,
                           device="cuda") -> int:
    """Join this process to the process group (idempotent) and return its
    rank.

    Without arguments the group comes from the environment torch's
    launchers set (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``); ``init_method`` (a ``file://`` store, say) and the
    sizes may be given instead.  With neither, no coordinator is
    configured and this is a no-op returning 0, as in the reference.
    ``device``: the rank's device; a CUDA rank r takes ``cuda:r % count``
    (r the local rank where the launcher sets ``LOCAL_RANK``).  The
    backend is NCCL where every local rank has a card of its own, gloo
    otherwise; an explicit ``backend`` wins."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None:
        if not env.get("MASTER_ADDR"):
            logger.info("No process-group coordinator (no init_method, MASTER_ADDR unset); "
                        "staying single-process.")
            return 0
        init_method = "env://"
    world_size = 1 if world_size is None else world_size
    rank = 0 if rank is None else rank
    device = torch.device(device)
    local_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    if device.type == "cuda":
        resolve_device(device)
        if device.index is None:
            local = int(env.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if backend is None:
        own_card = device.type == "cuda" and torch.cuda.device_count() >= local_size
        backend = "nccl" if own_card else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    _DEVICE[:] = [device]
    if rank != 0:
        logging.getLogger("lsafw_tpu_torch").setLevel(logging.ERROR)
    logger.info("Process group up: rank %d of %d, backend %s, device %s.", rank, world_size,
                backend, device)
    return rank


def default_device() -> torch.device:
    """The device :func:`initialize_distributed` gave this rank, else
    ``cuda``."""
    return _DEVICE[0] if _DEVICE else torch.device("cuda")


def global_mesh():
    """1D mesh over every rank of the process group, on this rank's
    device: the argument of the ``parallel.sharded`` constructors."""
    from lsafw_tpu_torch.parallel.sharded import device_mesh

    return device_mesh()


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
