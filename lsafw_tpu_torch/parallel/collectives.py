"""The collectives of the scale-out layer, in one place.

Every collective the port runs goes through :func:`all_reduce` (a sum
over the group's ranks) or :func:`all_gather` (each rank's block,
concatenated along the first axis in rank order).  ``group=None`` is a
world of one without a process group: both return their input.  A
complex tensor travels as its real view.  NCCL takes CUDA tensors, gloo
CPU and CUDA tensors (``chip_smoke.py`` phase 16b probes gloo's on the
card), so nothing is staged through the host here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, as a new tensor."""
    if group is None:
        return t
    buf = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(_real(buf), group=group)
    return buf


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks), concatenated along the
    first axis in rank order."""
    if group is None:
        return t
    src = _real(t.detach().contiguous())
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return torch.view_as_complex(out) if t.is_complex() else out
