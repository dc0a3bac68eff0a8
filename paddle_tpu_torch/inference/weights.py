"""Weight carry-over from and to the JAX package (counterpart:
paddle_tpu/inference/serving.py `_extract_gpt_params`).

The JAX side yields a tree ``{wte, wpe, lnf_w, lnf_b, blocks: [{ln1_w,
ln1_b, ln2_w, ln2_b, qkv_w, qkv_b, out_w, out_b, fc1_w, fc1_b, fc2_w,
fc2_b}], head_w, head_b}`` (the head only when embeddings are untied)
with every projection stored [in, out].  A caller turns its leaves into
numpy arrays; `params_from_numpy` turns them into the port's tensors,
keeping names and layout, and `params_to_numpy` turns such a tree back.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy"]


def _map_tree(tree: dict, leaf) -> dict:
    out = {k: leaf(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [{k: leaf(v) for k, v in blk.items()}
                     for blk in tree["blocks"]]
    return out


def params_from_numpy(tree: dict, device=None, dtype=None,
                      requires_grad=False) -> dict:
    """Copy a numpy weight tree onto ``device`` (default: the CUDA card)
    as tensors, the floating leaves of ``dtype`` (default: each array's
    own) and the others (the int8 payloads of a quantized tree) of their
    own dtype; floating leaves require grad when ``requires_grad``.
    ``None`` leaves (an untied head without bias) stay ``None``."""
    device = resolve_device(device)

    def leaf(a):
        if a is None:
            return None
        t = torch.from_numpy(np.array(a))
        if not t.is_floating_point():
            return t.to(device=device)
        return t.to(device=device, dtype=dtype).requires_grad_(requires_grad)

    return _map_tree(tree, leaf)


def params_to_numpy(tree: dict) -> dict:
    """The same tree as numpy arrays on the host (bf16 leaves widened to
    f32, which numpy lacks)."""
    def leaf(t):
        if t is None:
            return None
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _map_tree(tree, leaf)
