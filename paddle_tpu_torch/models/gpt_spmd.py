"""GPT's hybrid-parallel train step over (dp, pp, sp, mp) (counterpart:
paddle_tpu/models/gpt_spmd.py).

The JAX package writes one ``shard_map`` program over the 4-axis mesh
and differentiates it whole.  Here each rank is a process holding its
blocks of the parameters (`shard_params`, by `parallel.partition.
gpt_train_rules`), and one step runs, on every rank:

* **data** — the tokens cut over ``dp`` (rows) and ``sp`` (columns);
* **tensor** — qkv and fc1 split on their columns, out and fc2 on their
  rows (`mp_layers.c_identity` before, `mp_allreduce` after), the
  vocab-parallel embedding and cross entropy (``_vocab_parallel_ce``:
  `mp_layers.parallel_cross_entropy`);
* **sequence** — ring attention over ``sp`` (`parallel.ring_attention.
  RingAttention`, kernel K3 a block on the card);
* **pipeline** — the stage's blocks over ``num_micro`` micro-batches in
  the 1F1B schedule (`parallel.pipeline.pipeline_1f1b_local`): stage 0
  embeds, the last stage takes the loss;
* **update** — each gradient summed over the axes its parameter is
  replicated on among dp, sp and pp (what JAX's varying-axis tracking
  does), and SGD on the rank's own blocks;

and returns the loss reassembled over dp, sp and pp (the mean
next-token loss of the global batch) and the rank's new blocks.
`compute_dtype` (bf16 by default, as in JAX) is the matmuls' dtype; the
LayerNorms run inline in f32, as JAX's ``_layernorm`` (kernel K5 is not
on this path).  `reference_loss` is the dense single-process loss.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..distributed.collective import ReduceOp, _gather, _reduce_inplace
from ..distributed.fleet.meta_parallel.mp_layers import (
    c_identity, mp_allreduce, parallel_cross_entropy)
from ..distributed.topology import get_hybrid_communicate_group
from ..parallel.partition import (gpt_train_rules, join_leaf,
                                  match_partition_rules, shard_leaf)
from ..parallel.pipeline import StageLink, pipeline_1f1b_local
from ..parallel.ring_attention import RingAttention
from .gpt import GPTConfig

__all__ = ["param_specs", "init_params", "shard_params", "gather_params",
           "build_spmd_train_step", "reference_loss"]

_PARAM_NAMES = (
    "wte", "wpe",
    "ln1_w", "ln1_b", "w_qkv", "b_qkv", "w_out", "b_out",
    "ln2_w", "ln2_b", "w_fc1", "b_fc1", "w_fc2", "b_fc2",
    "lnf_w", "lnf_b", "lm_head",
)


def param_specs(cfg: GPTConfig) -> Dict[str, tuple]:
    shapes = {k: torch.zeros(2, 2) for k in _PARAM_NAMES}
    return match_partition_rules(gpt_train_rules(), shapes)


def init_params(cfg: GPTConfig, seed: int = 0, device="cpu",
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The whole parameter dict, drawn as the JAX package's
    ``init_params`` draws it (N(0, 0.02), the residual projections scaled
    by ``1 / sqrt(2 L)``, norms at 1 and 0, zero biases) from a torch
    generator seeded with ``seed``."""
    h, nl, f = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    v, s = cfg.vocab_size, cfg.max_seq_len
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    std, rstd = 0.02, 0.02 / math.sqrt(2 * nl)

    def normal(*shape, scale=std):
        return torch.randn(*shape, generator=gen) * scale

    out = {
        "wte": normal(v, h), "wpe": normal(s, h),
        "ln1_w": torch.ones(nl, h), "ln1_b": torch.zeros(nl, h),
        "w_qkv": normal(nl, h, 3 * h), "b_qkv": torch.zeros(nl, 3 * h),
        "w_out": normal(nl, h, h, scale=rstd), "b_out": torch.zeros(nl, h),
        "ln2_w": torch.ones(nl, h), "ln2_b": torch.zeros(nl, h),
        "w_fc1": normal(nl, h, f), "b_fc1": torch.zeros(nl, f),
        "w_fc2": normal(nl, f, h, scale=rstd), "b_fc2": torch.zeros(nl, h),
        "lnf_w": torch.ones(h), "lnf_b": torch.zeros(h),
        "lm_head": normal(h, v),
    }
    return {k: t.to(device=device, dtype=dtype) for k, t in out.items()}


def _coords(hcg):
    return {ax: (hcg.axis_rank(ax), hcg.axis_size(ax))
            for ax in ("pp", "mp")}


def shard_params(params, mesh=None, device=None):
    """This rank's blocks of the whole dict ``params`` (tensors or numpy
    arrays, global shapes), as tensors on ``device``."""
    hcg = mesh if hasattr(mesh, "axis_group") else \
        get_hybrid_communicate_group()
    specs = match_partition_rules(gpt_train_rules(), {
        k: torch.zeros(2, 2) for k in params})
    coords = _coords(hcg)
    return {k: shard_leaf(torch.as_tensor(a), specs[k], coords).to(device)
            for k, a in params.items()}


@torch.no_grad()
def gather_params(local, mesh=None):
    """The whole dict from every rank's blocks (all-gathers over ``mp``,
    then ``pp``); every rank returns it."""
    hcg = mesh if hasattr(mesh, "axis_group") else \
        get_hybrid_communicate_group()
    specs = match_partition_rules(gpt_train_rules(), {
        k: torch.zeros(2, 2) for k in local})
    out = {}
    for k, t in local.items():
        for ax in ("mp", "pp"):
            if ax in specs[k] and hcg.axis_size(ax) > 1:
                t = join_leaf(_gather(t.contiguous(), hcg.axis_group(ax)),
                              specs[k], ax)
        out[k] = t
    return out


def _layernorm(x, w, b, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _block(x, p, li, heads_local, cd, groups):
    """One transformer block on this rank's blocks. x: [b, s_local, H]."""
    b, s, _ = x.shape
    mp = groups["mp"]
    y = c_identity(_layernorm(x, p["ln1_w"][li], p["ln1_b"][li]), mp)
    qkv = y.to(cd) @ p["w_qkv"][li].to(cd) + p["b_qkv"][li].to(cd)
    # the packed qkv axis is head-major ((heads, 3, d)), as in JAX
    hd = qkv.shape[-1] // (3 * heads_local)
    qkv = qkv.reshape(b, s, heads_local, 3, hd).permute(3, 0, 2, 1, 4)
    attn = RingAttention.apply(qkv[0], qkv[1], qkv[2], groups["sp"], True,
                               None)
    attn = attn.permute(0, 2, 1, 3).reshape(b, s, heads_local * hd)
    out = mp_allreduce(attn @ p["w_out"][li].to(cd), mp) + \
        p["b_out"][li].to(cd)
    x = x + out.to(x.dtype)
    y = c_identity(_layernorm(x, p["ln2_w"][li], p["ln2_b"][li]), mp)
    h1 = torch.nn.functional.gelu(
        y.to(cd) @ p["w_fc1"][li].to(cd) + p["b_fc1"][li].to(cd),
        approximate="tanh")
    h2 = mp_allreduce(h1 @ p["w_fc2"][li].to(cd), mp) + \
        p["b_fc2"][li].to(cd)
    return x + h2.to(x.dtype)


def _embed(tokens, p, sp_rank, cd, mp):
    """The vocab-parallel embedding plus the positions of this rank's
    sequence block."""
    v_local = p["wte"].shape[0]
    lo = mp.rank * v_local if mp is not None else 0
    local = tokens.long() - lo
    inside = (local >= 0) & (local < v_local)
    emb = p["wte"][torch.where(inside, local, 0)] * \
        inside.unsqueeze(-1).to(p["wte"].dtype)
    emb = mp_allreduce(emb, mp)
    s_local = tokens.shape[1]
    pos = sp_rank * s_local + torch.arange(s_local, device=tokens.device)
    return (emb + p["wpe"][pos]).to(cd)


def build_spmd_train_step(cfg: GPTConfig, mesh=None, num_micro: int = 1,
                          lr: float = 1e-3, compute_dtype=torch.bfloat16):
    """Returns ``step(params, tokens, labels) -> (loss, new_params)``:
    ``params`` this rank's blocks (`shard_params`), tokens and labels the
    global ``[B, S]`` on every rank (``B % (dp * num_micro) == 0``,
    ``S % sp == 0``, ``heads % mp == 0``, ``layers % pp == 0``, ``vocab
    % mp == 0``).  ``mesh``: the `HybridCommunicateGroup` (default: the
    current one)."""
    hcg = mesh if hasattr(mesh, "axis_group") else \
        get_hybrid_communicate_group()
    pp, mpn = hcg.axis_size("pp"), hcg.axis_size("mp")
    dp, sp = hcg.axis_size("dp"), hcg.axis_size("sp")
    heads_local = cfg.num_heads // mpn
    groups = {ax: hcg.axis_group(ax) for ax in ("dp", "pp", "sp", "mp")}
    mp_group = groups["mp"] if mpn > 1 else None
    stage, sp_rank = hcg.axis_rank("pp"), hcg.axis_rank("sp")
    first, last = stage == 0, stage == pp - 1
    specs = param_specs(cfg)
    link = StageLink(groups["pp"])
    cd = compute_dtype

    def step(params, tokens, labels):
        tokens, labels = torch.as_tensor(tokens), torch.as_tensor(labels)
        bsz, seq = tokens.shape
        bl, sl = bsz // dp, seq // sp
        d = hcg.axis_rank("dp")
        rows = slice(d * bl, (d + 1) * bl)
        cols = slice(sp_rank * sl, (sp_rank + 1) * sl)
        tok, lab = tokens[rows, cols], labels[rows, cols]
        mb = bl // num_micro
        prm = {k: t.detach().requires_grad_(True) for k, t in
               params.items()}
        n_tokens = bsz * seq

        def fwd_apply(i, x):
            if first:
                x = _embed(tok[i * mb:(i + 1) * mb], prm, sp_rank, cd,
                           mp_group)
            for li in range(prm["w_qkv"].shape[0]):
                x = _block(x, prm, li, heads_local, cd, groups)
            if not last:
                return x
            xf = c_identity(_layernorm(x, prm["lnf_w"], prm["lnf_b"]),
                            mp_group)
            logits = xf.to(cd) @ prm["lm_head"].to(cd)
            nll = parallel_cross_entropy(logits, lab[i * mb:(i + 1) * mb],
                                         mp_group)
            return nll.sum() / n_tokens

        losses = pipeline_1f1b_local(fwd_apply, num_micro, link=link,
                                     first_input=lambda i: None)
        with torch.no_grad():
            grads = {k: p.grad if p.grad is not None else
                     torch.zeros_like(p) for k, p in prm.items()}
            for ax in ("dp", "sp", "pp"):
                if hcg.axis_size(ax) == 1:
                    continue
                names = [k for k in grads if ax not in specs[k]]
                flat = torch.cat([grads[k].reshape(-1) for k in names])
                _reduce_inplace(flat, ReduceOp.SUM, groups[ax])
                off = 0
                for k in names:
                    n = grads[k].numel()
                    grads[k] = flat[off:off + n].view_as(grads[k])
                    off += n
            dev = tok.device
            loss = torch.stack(losses).sum() if losses else \
                torch.zeros((), device=dev)
            loss = loss.float().to(dev)
            for ax in ("dp", "sp", "pp"):
                if hcg.axis_size(ax) > 1:
                    _reduce_inplace(loss, ReduceOp.SUM, groups[ax])
            new = {k: (params[k] - lr * grads[k]).to(params[k].dtype)
                   for k in params}
        return loss, new

    step.link = link
    return step


def reference_loss(cfg: GPTConfig, params, tokens, labels):
    """The dense single-process loss of the whole ``params`` (no
    parallelism, f32, composed attention), for correctness checks."""
    h = cfg.hidden_size
    p = {k: torch.as_tensor(v).float() for k, v in params.items()}
    tokens, labels = torch.as_tensor(tokens).long(), \
        torch.as_tensor(labels).long()
    s = tokens.shape[1]
    x = p["wte"][tokens] + p["wpe"][torch.arange(s, device=tokens.device)]

    def ln(x, w, b, eps=1e-5):
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, unbiased=False, keepdim=True)
        return (x - mu) / torch.sqrt(var + eps) * w + b

    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    hd = h // cfg.num_heads
    for li in range(cfg.num_layers):
        y = ln(x, p["ln1_w"][li], p["ln1_b"][li])
        b_ = y.shape[0]
        qkv = y @ p["w_qkv"][li] + p["b_qkv"][li]
        qkv = qkv.reshape(b_, s, cfg.num_heads, 3, hd).permute(3, 0, 2, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        logits = torch.where(mask, logits, -1e30)
        attn = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1), v)
        attn = attn.permute(0, 2, 1, 3).reshape(b_, s, h)
        x = x + attn @ p["w_out"][li] + p["b_out"][li]
        y = ln(x, p["ln2_w"][li], p["ln2_b"][li])
        hh = torch.nn.functional.gelu(y @ p["w_fc1"][li] + p["b_fc1"][li],
                                      approximate="tanh")
        x = x + hh @ p["w_fc2"][li] + p["b_fc2"][li]
    x = ln(x, p["lnf_w"], p["lnf_b"])
    logp = torch.log_softmax(x @ p["lm_head"], -1)
    return -logp.gather(-1, labels.unsqueeze(-1)).squeeze(-1).mean()
