"""Misc ops (counterpart: paddle_tpu/ops/misc.py): the beam-search
backtrace.  The rest of that module is not ported yet."""
from __future__ import annotations

import torch

__all__ = ["gather_tree"]


def gather_tree(ids, parents, name=None):
    """Full beam sequences [T, B, W] from each step's tokens ``ids`` and
    parent beams ``parents`` (both [T, B, W]), walking the parent
    pointers back from the last step."""
    t, b, w = ids.shape
    beams = torch.arange(w, device=ids.device).expand(b, w)
    out = []
    for row in range(t - 1, -1, -1):
        out.append(ids[row].gather(-1, beams))
        beams = parents[row].long().gather(-1, beams)
    return torch.stack(out[::-1])
