"""Weight carry-over from and to the JAX package (counterpart:
paddle_tpu/inference/serving.py `_extract_gpt_params`).

The JAX side yields a tree ``{wte, wpe, lnf_w, lnf_b, blocks: [{ln1_w,
ln1_b, ln2_w, ln2_b, qkv_w, qkv_b, out_w, out_b, fc1_w, fc1_b, fc2_w,
fc2_b}], head_w, head_b}`` (the head only when embeddings are untied)
with every projection stored [in, out].  A caller turns its leaves into
numpy arrays; `params_from_numpy` turns them into the port's tensors,
keeping names and layout, and `params_to_numpy` turns such a tree back.

A model split over a hybrid group (tensor-parallel layers, whose
parameters carry ``mesh_axes``) crosses by its state dict:
`shard_state_dict` cuts the whole arrays (a JAX ``state_dict``, a
``paddle.load`` of its save, `gpt_spmd.init_params`) into this rank's
blocks and copies them in; `full_state_dict` gathers the blocks back
into whole tensors, which ``framework.io.save`` writes for the JAX
package's ``paddle.load``.  (`models.gpt_spmd.shard_params` /
`gather_params` do the same for that step's dict.)
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy", "shard_state_dict",
           "full_state_dict"]


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


def _mp_coords(group):
    return {"mp": (group.rank, group.nranks)} if group is not None else {}


def _mp_of(model):
    from ..distributed.fleet.meta_parallel.mp_layers import mp_group_of

    inner = model
    while hasattr(inner, "_layers") and not hasattr(inner, "mp_group"):
        inner = inner._layers
    return mp_group_of(getattr(inner, "mp_group", None))


@torch.no_grad()
def shard_state_dict(model, state: dict, group=None) -> list:
    """Copy the whole arrays of ``state`` (by ``model.state_dict()``'s
    names) into ``model``, each parameter taking its block under its
    ``mesh_axes`` for this rank of the tensor-parallel ``group`` (default:
    the model's).  Returns the names ``state`` did not have."""
    from ..parallel.partition import shard_leaf

    group = group if group is not None else _mp_of(model)
    coords = _mp_coords(group)
    missing = []
    for name, t in model.state_dict(keep_vars=True).items():
        if name not in state:
            missing.append(name)
            continue
        v = state[name]
        v = v.detach() if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.array(v))
        spec = getattr(t, "mesh_axes", None)
        if spec:
            v = shard_leaf(v, spec, coords)
        t.copy_(v.to(device=t.device, dtype=t.dtype))
    return missing


@torch.no_grad()
def full_state_dict(model, group=None) -> dict:
    """``model.state_dict()`` with every split parameter gathered over the
    tensor-parallel ``group`` (default: the model's) into the whole
    tensor, on the CPU; every rank returns it."""
    from ..distributed.collective import _gather
    from ..parallel.partition import join_leaf

    group = group if group is not None else _mp_of(model)
    out = {}
    for name, t in model.state_dict(keep_vars=True).items():
        spec = getattr(t, "mesh_axes", None)
        t = t.detach()
        if spec and group is not None and any(
                a is not None and str(a).startswith("mp") for a in spec):
            t = join_leaf(_gather(t.contiguous(), group), spec, "mp")
        out[name] = t.cpu()
    return out
