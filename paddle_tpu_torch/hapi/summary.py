"""Model summary and FLOPs count (counterpart: paddle_tpu/hapi/summary.py)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["summary", "flops"]


def summary(net, input_size=None, dtypes=None):
    """Print each parameter's name, shape and size and the totals; returns
    ``{"total_params", "trainable_params"}``."""
    total_params = 0
    trainable_params = 0
    lines = ["-" * 64, f"{'Layer':<30}{'Param shape':<22}{'#':>10}", "=" * 64]
    for name, p in net.named_parameters():
        n = p.numel()
        total_params += n
        if p.requires_grad:
            trainable_params += n
        lines.append(f"{name:<30}{str(list(p.shape)):<22}{n:>10}")
    lines += ["=" * 64,
              f"Total params: {total_params:,}",
              f"Trainable params: {trainable_params:,}",
              "-" * 64]
    print("\n".join(lines))
    return {"total_params": total_params, "trainable_params": trainable_params}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The JAX package's per-layer count over a dry run on zeros of
    ``input_size`` (float32, on the network's device, without grad, in
    eval mode): a `Linear` counts ``in_features x`` its output's elements
    (multiply-accumulates), a `LayerNorm` twice its output's elements,
    ``custom_ops[type](layer, inputs, output)`` any other type.  Returns
    the total."""
    from ..nn.layer import LayerNorm, Linear

    counts = {}
    hooks = []

    def numel(out):
        o = out[0] if isinstance(out, (list, tuple)) else out
        return int(np.prod(tuple(o.shape)))

    def hook(layer, inputs, output):
        f = 0
        if isinstance(layer, Linear):
            f = int(layer.weight.shape[0]) * numel(output)
        elif isinstance(layer, LayerNorm):
            f = 2 * numel(output)
        if custom_ops and type(layer) in custom_ops:
            f = custom_ops[type(layer)](layer, inputs, output)
        if f:
            # a layer that runs several times a forward counts each run
            name, prev = counts.get(id(layer), (type(layer).__name__, 0))
            counts[id(layer)] = (name, prev + f)

    for sub in net.modules():
        hooks.append(sub.register_forward_hook(hook))
    was_training = net.training
    net.eval()
    p = next(net.parameters(), None)
    try:
        with torch.no_grad():
            net(torch.zeros(list(input_size), dtype=torch.float32,
                            device=None if p is None else p.device))
    finally:
        net.train(was_training)
        for h in hooks:
            h.remove()
    total = sum(f for _, f in counts.values())
    if print_detail:
        for name, f in counts.values():
            print(f"{name:<24}{f:>16,}")
    print(f"Total Flops: {total:,}")
    return total
