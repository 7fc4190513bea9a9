"""Pinned host staging for host-to-device copies that do not wait.

A copy from pageable host memory makes the host wait for the device;
one from a pinned buffer is queued on the stream and returns. A pinned
buffer may be written again only once the copy that read it has run, so
:class:`HostStaging` keeps a ring of pinned slots, each with the event
of its last copy, and waits on that event (normally long passed) before
reusing a slot.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import check_not_capturing


class HostStaging:
    """``copy_(dst, array)``: ``dst`` (any shape, contiguous) takes the
    values of the numpy ``array`` through a pinned slot, queued on the
    current stream. A CPU ``dst`` takes them directly."""

    def __init__(self, depth=4):
        self._slots = [None] * depth      # (pinned tensor, event)
        self._next = 0

    def copy_(self, dst, array):
        src = torch.from_numpy(np.ascontiguousarray(array).reshape(-1))
        flat = dst.view(-1)
        if dst.device.type != "cuda":
            flat.copy_(src)
            return dst
        check_not_capturing("a staged host-to-device copy")
        i = self._next
        self._next = (i + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is not None:
            slot[1].synchronize()
        if slot is None or slot[0].numel() < src.numel() or \
                slot[0].dtype != src.dtype:
            slot = self._slots[i] = (torch.empty(
                src.numel(), dtype=src.dtype, pin_memory=True),
                torch.cuda.Event())
        buf = slot[0][:src.numel()]
        buf.copy_(src)
        flat.copy_(buf, non_blocking=True)
        slot[1].record()
        return dst


__all__ = ["HostStaging"]
