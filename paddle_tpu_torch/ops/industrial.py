"""Industrial long-tail ops: CTR, tree models, text matching
(counterpart: paddle_tpu/ops/industrial.py).

Torch ops on the inputs' device over the JAX package's static-shape
forms (LoD as padded + lengths; dynamic row counts as front compaction
with validity masks), differentiable in their float inputs.  Kept from
the JAX package: `pyramid_hash` hashes with an FNV-1a mix where Paddle
uses XXH32; its ids equal the JAX package's (the uint32 lattice is
computed in int64 masked to 32 bits, since torch's uint32 has no
arithmetic on CUDA).  The samplers (`tdm_sampler`, `sample_logits`'s
log-uniform draw, `pyramid_hash`'s dropout) draw from a
``torch.Generator`` (seeded by ``seed`` when it is not 0) and equal the
JAX package's in distribution only.  `ops.sample_logits` is this
sampled-softmax op; a serve's token choice is `nn.decode.sample_logits`.
"""
from __future__ import annotations

import torch

from ..core import framework

__all__ = [
    "tdm_child", "tdm_sampler", "rank_attention", "match_matrix_tensor",
    "var_conv_2d", "filter_by_instag", "tree_conv", "pyramid_hash",
    "lstmp", "sample_logits",
]

_U32 = 0xFFFFFFFF


def _generator(seed, device):
    if seed:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        return g
    return framework.generator_for(device)


def tdm_child(x, tree_info, child_nums, dtype="int64", name=None):
    """Children of each node id: ``tree_info`` rows are ``[item_id,
    layer_id, ancestor_id, child_0 .. child_{n-1}]``; node 0 and
    childless nodes give zeros.  Returns ``(child, leaf_mask)`` shaped
    ``x.shape[:-1] + (child_nums,)`` for a trailing-1 input, else
    ``x.shape + (child_nums,)``."""
    child_nums = int(child_nums)
    flat = x.reshape(-1).long()
    children = tree_info[flat, 3:3 + child_nums].long()
    has_child = (flat != 0) & (tree_info[flat, 3] != 0)
    children = torch.where(has_child[:, None], children, 0)
    is_item = tree_info[children.reshape(-1), 0] != 0
    mask = is_item.reshape(children.shape) & has_child[:, None]
    shape = (tuple(x.shape[:-1]) if x.dim() and x.shape[-1] == 1
             else tuple(x.shape)) + (child_nums,)
    return children.reshape(shape), mask.long().reshape(shape)


def tdm_sampler(x, travel, layer, neg_samples_num_list, layer_offset_lod,
                output_positive=True, seed=0, name=None):
    """Layerwise samples for each item: its travel path's node at each
    tree layer (when ``output_positive``) and ``neg_samples_num_list[l]``
    negatives drawn uniformly without replacement from layer ``l`` but
    the positive (a top-k of uniform scores).  Padding (travel id 0)
    gives zeros with mask 0.  Returns ``(out, labels, mask)``, each
    [N, sum(neg_l + output_positive)] int64."""
    negs = [int(n) for n in neg_samples_num_list]
    offs = [int(o) for o in layer_offset_lod]
    gen = _generator(seed, x.device)
    trav = travel[x.reshape(-1).long()]                       # [N, L]
    n = trav.shape[0]
    nodes_all = layer.reshape(-1)
    outs, labels, masks = [], [], []
    for li, neg in enumerate(negs):
        nodes = nodes_all[offs[li]:offs[li + 1]]
        pos = trav[:, li]
        alive = (pos != 0)[:, None]
        if output_positive:
            outs.append(torch.where(alive, pos[:, None], 0))
            labels.append(alive.long())
            masks.append(alive.long())
        scores = torch.rand((n, nodes.shape[0]), generator=gen,
                            device=x.device)
        scores = torch.where(nodes[None, :] == pos[:, None], -torch.inf,
                             scores)
        idx = torch.topk(scores, neg, dim=1).indices
        outs.append(torch.where(alive, nodes[idx], 0))
        labels.append(torch.zeros((n, neg), dtype=torch.long,
                                  device=x.device))
        masks.append(alive.long().expand(n, neg))
    return (torch.cat(outs, -1).long(), torch.cat(labels, -1).long(),
            torch.cat(masks, -1).long())


def rank_attention(x, rank_offset, rank_param, max_rank=3, max_size=0,
                   name=None):
    """CTR rank attention: instance i of rank ``r = rank_offset[i, 0] -
    1`` multiplies each slot k's instance ``index_k`` by the parameter
    block ``(r * max_rank + faster_k)``.  Returns ``(out [N, p],
    input_help [N, max_rank * d], ins_rank [N, 1])``."""
    k = int(max_rank)
    n, d = x.shape
    p = rank_param.shape[1]
    ro = rank_offset.long()
    lower = ro[:, 0] - 1
    faster = ro[:, 1::2][:, :k] - 1
    index = ro[:, 2::2][:, :k]
    valid = (lower[:, None] >= 0) & (faster >= 0)
    ih = torch.where(valid[..., None], x[index], 0.0)
    par3 = rank_param.reshape(-1, d, p)
    block = (lower[:, None] * k + faster).clamp(0, par3.shape[0] - 1)
    sel = torch.where(valid[..., None, None], par3[block], 0.0)
    out = torch.einsum("nkd,nkdp->np", ih, sel)
    return out, ih.reshape(n, k * d), ro[:, 0].to(x.dtype)[:, None]


def match_matrix_tensor(x, y, w, x_lens=None, y_lens=None, dim_t=1,
                        name=None):
    """``out[b, t, i, j] = x_i^T W_t y_j``: x [B, Lx, d], y [B, Ly, d], W
    [d, dim_t, d]; returns ``(out [B, dim_t, Lx, Ly], tmp [B, Lx, dim_t,
    d] = x W)``, zero outside the valid positions when lengths are
    given."""
    tmp = torch.einsum("bid,dte->bite", x, w)
    out = torch.einsum("bite,bje->btij", tmp, y)
    if x_lens is not None:
        mi = _ar(x.shape[1], x)[None, :] < x_lens.to(x.device)[:, None]
        mj = _ar(y.shape[1], x)[None, :] < y_lens.to(x.device)[:, None]
        out = out * (mi[:, None, :, None] & mj[:, None, None, :])
        tmp = tmp * mi[..., None, None]
    return out, tmp


def _ar(n, like):
    return torch.arange(n, device=like.device)


def var_conv_2d(x, w, row_lens, col_lens, input_channel, output_channel,
                kernel_h, kernel_w, stride_h=1, stride_w=1, name=None):
    """A 2-D convolution of each sample over its own rows and columns:
    x [B, C, Hmax, Wmax] zeroed past each sample's region, output masked
    to each sample's ``ceil(h / stride) x ceil(w / stride)``."""
    from ..nn import functional as F

    b, c, hm, wm = x.shape
    rl, cl = row_lens.to(x.device), col_lens.to(x.device)
    rmask = _ar(hm, x)[None, :] < rl[:, None]
    cmask = _ar(wm, x)[None, :] < cl[:, None]
    x = x * (rmask[:, None, :, None] & cmask[:, None, None, :])
    ker = w.reshape(output_channel, input_channel, kernel_h, kernel_w)
    pads = [(kernel_h - 1) // 2, kernel_h // 2, (kernel_w - 1) // 2,
            kernel_w // 2]
    out = F.conv2d(x, ker, stride=[stride_h, stride_w], padding=pads)
    oh = (rl - 1) // stride_h + 1
    ow = (cl - 1) // stride_w + 1
    omr = _ar(out.shape[2], x)[None, :] < oh[:, None]
    omc = _ar(out.shape[3], x)[None, :] < ow[:, None]
    return out * (omr[:, None, :, None] & omc[:, None, None, :])


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True,
                     out_val_if_empty=0, name=None):
    """Instances whose tags meet ``filter_tag``, compacted to the front
    in their order; the rest of the rows hold ``out_val_if_empty``.
    ``ins_tag`` [N, K] is padded with -1.  Returns ``(out [N, d],
    loss_weight [N, 1], index_map [N])`` (-1 on padding)."""
    tags = ins_tag.long()
    hit = (tags[:, :, None] == filter_tag.long()[None, None, :]) & \
        (tags[:, :, None] >= 0)
    keep = hit.any(dim=2).any(dim=1)
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    kept = keep[order]
    out = torch.where(kept[:, None], ins[order],
                      torch.tensor(out_val_if_empty, dtype=ins.dtype,
                                   device=ins.device))
    return (out, kept.float()[:, None],
            torch.where(kept, order, -1).long())


def tree_conv(nodes_vector, edge_set, filter, max_depth, name=None):
    """Tree-based convolution (TBCNN): each node's patch is its subtree
    within ``max_depth``, weighted by the eta_t/eta_l/eta_r
    coefficients, contracted with ``filter`` [F, 3, output_size,
    num_filters].  Subtrees are dense reachability (powers of the child
    adjacency).  nodes_vector [B, N, F]; edge_set [B, E, 2] 1-based
    parent -> child ids, (0, 0) padding; out [B, N, output_size,
    num_filters]."""
    md = int(max_depth)
    feat = nodes_vector
    b, n, _ = feat.shape
    e = edge_set.shape[1]
    dt, dev = feat.dtype, feat.device
    u, v = edge_set[..., 0].long(), edge_set[..., 1].long()
    evalid = (u != 0) & (v != 0)
    ui, vi = torch.where(evalid, u - 1, 0), torch.where(evalid, v - 1, 0)
    bidx = torch.arange(b, device=dev)[:, None].expand(b, e)
    adj = torch.zeros((b, n, n), dtype=dt, device=dev).index_put(
        (bidx, ui, vi), evalid.to(dt), accumulate=True).clamp(max=1.0)
    same = (u[:, :, None] == u[:, None, :]) & evalid[:, None, :] & \
        evalid[:, :, None]
    ar_e = torch.arange(e, device=dev)
    earlier = same & (ar_e[None, None, :] < ar_e[None, :, None])
    child_pos_e, sib_cnt_e = earlier.sum(-1).to(dt), same.sum(-1).to(dt)
    vi_or_oob = torch.where(evalid, vi, n)       # padding edges dropped
    child_pos = torch.zeros((b, n + 1), dtype=dt, device=dev).index_put(
        (bidx, vi_or_oob), child_pos_e, accumulate=True)[:, :n]
    sib_cnt = torch.ones((b, n + 1), dtype=dt, device=dev).index_put(
        (bidx, vi_or_oob), sib_cnt_e)[:, :n]

    def etas(depth, pos, cnt):
        eta_t = (md - depth) / md
        tmp = torch.where(cnt == 1, 0.5, pos / torch.clamp(cnt - 1, min=1))
        eta_l = (1.0 - eta_t) * tmp
        return eta_t, eta_l, (1.0 - eta_t) * (1.0 - eta_l)

    zeros = torch.zeros((b, n), dtype=dt, device=dev)
    t0, l0, r0 = etas(zeros, zeros, zeros + 1)
    acc_t, acc_l, acc_r = (t0[..., None] * feat, l0[..., None] * feat,
                           r0[..., None] * feat)
    reach = torch.eye(n, dtype=dt, device=dev).expand(b, n, n)
    depths = torch.arange(1, md, dtype=dt, device=dev)[:, None, None]
    tk, lk, rk = etas(depths, child_pos[None], sib_cnt[None])  # [md-1,B,N]
    for k in range(1, md):
        reach = torch.clamp(reach @ adj, max=1.0)
        acc_t = acc_t + reach @ (tk[k - 1][..., None] * feat)
        acc_l = acc_l + reach @ (lk[k - 1][..., None] * feat)
        acc_r = acc_r + reach @ (rk[k - 1][..., None] * feat)
    patch = torch.stack([acc_l, acc_r, acc_t], dim=-1)        # [B,N,F,3]
    return torch.einsum("bnfk,fkom->bnom", patch, filter)


def _fnv_mix(h, salt):
    """The FNV-1a-style mix of the JAX package (``(h ^ salt) *
    16777619``, then ``h ^ (h >> 15)``) on the uint32 lattice, computed
    in int64 masked to 32 bits."""
    h = ((h ^ (salt & _U32)) * 16777619) & _U32
    return h ^ (h >> 15)


def pyramid_hash(x, w, lengths=None, num_emb=8, space_len=1000,
                 pyramid_layer=2, rand_len=4, drop_out_percent=0.0,
                 is_training=False, seed=0, name=None):
    """Pyramid hash embedding: every n-gram of 2..pyramid_layer tokens
    hashes, a ``rand_len`` chunk at a time, into the flat table ``w``
    [space_len + rand_len]; the chunks make a ``num_emb`` embedding.  x
    [B, T] ids; returns ``(out [B, T, L, num_emb], mask [B, T, L])``,
    layer l holding the n-gram ``x[b, t : t + l + 2]``."""
    assert num_emb % rand_len == 0
    layers = max(int(pyramid_layer) - 1, 1)
    b, t = x.shape
    ids = x.long() & _U32
    length = lengths.to(x.device) if lengths is not None else \
        torch.full((b,), t, device=x.device)
    padded_ids = torch.nn.functional.pad(ids, (0, layers + 1))
    outs, masks = [], []
    for li in range(layers):
        ng = li + 2
        h = torch.zeros((b, t), dtype=torch.long, device=x.device)
        for j in range(ng):
            h = _fnv_mix(h ^ padded_ids[:, j:j + t], 2654435761 + j)
        chunks = []
        for j in range(0, int(num_emb), int(rand_len)):
            pos = _fnv_mix(h, j + 77) % int(space_len)
            chunks.append(w[pos[..., None] + _ar(rand_len, x)])
        emb = torch.cat(chunks, dim=-1)
        valid = (_ar(t, x)[None, :] + ng) <= length[:, None]
        outs.append(torch.where(valid[..., None], emb, 0.0))
        masks.append(valid)
    out = torch.stack(outs, dim=2)
    mask = torch.stack(masks, dim=2)
    if is_training and drop_out_percent > 0:
        keep = torch.rand(mask.shape, generator=_generator(seed, x.device),
                          device=x.device) < 1.0 - float(drop_out_percent)
        out = out * keep[..., None]
        mask = mask & keep
    return out, mask.to(torch.int32)


_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "relu": torch.relu, "identity": lambda v: v}


def lstmp(x, weight, proj_weight, bias=None, h0=None, c0=None,
          use_peepholes=True, is_reverse=False, gate_activation="sigmoid",
          cell_activation="tanh", candidate_activation="tanh",
          proj_activation="tanh", name=None):
    """Projection LSTM: the recurrent state is ``r_t = act_p(h_t @
    proj_weight)`` [P] (recurrent weight [P, 4D]); x is the
    pre-projected [B, T, 4D] (or [T, 4D]), gates in the order c, i, f,
    o; ``bias`` [4D] (+ a 3D peephole tail).  Returns ``(projection
    [.., T, P], cell [.., T, D])``."""
    actg, actc = _ACTS[gate_activation], _ACTS[cell_activation]
    actn, actp = _ACTS[candidate_activation], _ACTS[proj_activation]
    d, p = proj_weight.shape
    single = x.dim() == 2
    xv = x[None] if single else x
    b = xv.shape[0]
    bias_v = bias.reshape(-1) if bias is not None else \
        xv.new_zeros(4 * d)
    gb = bias_v[:4 * d]
    peep = use_peepholes and bias_v.numel() >= 7 * d
    if peep:
        w_ic, w_fc, w_oc = (bias_v[4 * d:5 * d], bias_v[5 * d:6 * d],
                            bias_v[6 * d:7 * d])
    r = h0.reshape(b, p) if h0 is not None else xv.new_zeros((b, p))
    c = c0.reshape(b, d) if c0 is not None else xv.new_zeros((b, d))
    steps = range(xv.shape[1])
    rs, cs = {}, {}
    for i in (reversed(steps) if is_reverse else steps):
        g = xv[:, i] + r @ weight + gb
        gc, gi, gf, go = torch.split(g, d, dim=-1)
        if peep:
            gi = gi + c * w_ic
            gf = gf + c * w_fc
        c = actg(gf) * c + actg(gi) * actc(gc)
        if peep:
            go = go + c * w_oc
        r = actp((actg(go) * actn(c)) @ proj_weight)
        rs[i], cs[i] = r, c
    proj = torch.stack([rs[i] for i in steps], dim=1)
    cell = torch.stack([cs[i] for i in steps], dim=1)
    return (proj[0], cell[0]) if single else (proj, cell)


def sample_logits(logits, labels, num_samples, uniq=True,
                  remove_accidental_hits=True, use_customized_samples=False,
                  customized_samples=None, customized_probabilities=None,
                  seed=0, name=None):
    """Sampled softmax's logits: each row's true-label logits and
    ``num_samples`` negatives (log-uniform, shared across rows; without
    replacement under ``uniq``, as a Gumbel top-k), each corrected by
    ``log(expected count)``; accidental hits are -1e20.  Returns
    ``(sampled_logits [N, T + S], sampled_labels [N, T])``."""
    s = int(num_samples)
    n, v = logits.shape
    t = labels.shape[1]
    dev = logits.device
    if use_customized_samples:
        samples = customized_samples.long()
        probs = customized_probabilities
    else:
        gen = _generator(seed, dev)
        ar = torch.arange(v, dtype=torch.float32, device=dev)
        if uniq:
            logw = torch.log(torch.log((ar + 2.0) / (ar + 1.0)))
            u = torch.rand(v, generator=gen, device=dev).clamp(min=1e-20)
            samples = torch.topk(logw - torch.log(-torch.log(u)),
                                 s).indices
        else:
            u = torch.rand(s, generator=gen, device=dev)
            samples = (torch.exp(u * torch.log(torch.tensor(
                v + 1.0, device=dev))) - 1.0).long().clamp(0, v - 1)
        probs = torch.log((samples + 2.0) / (samples + 1.0)) / \
            torch.log(torch.tensor(v + 1.0, device=dev))
    lb = labels.long()
    log_v1 = torch.log(torch.tensor(v + 1.0, device=dev))
    true_p = torch.log((lb + 2.0) / (lb + 1.0)) / log_v1
    true_logit = logits.gather(1, lb) - torch.log(true_p * s + 1e-20)
    samp_logit = logits[:, samples] - torch.log(probs * s + 1e-20)[None, :]
    if remove_accidental_hits:
        hit = (samples[None, None, :] == lb[:, :, None]).any(1)
        samp_logit = torch.where(hit, -1e20, samp_logit)
    out = torch.cat([true_logit, samp_logit], dim=1)
    return out, torch.arange(t, device=dev).repeat(n, 1)
