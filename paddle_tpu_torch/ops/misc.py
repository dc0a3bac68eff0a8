"""Misc long-tail ops (counterpart: paddle_tpu/ops/misc.py).

Torch ops on the inputs' device, differentiable in their float inputs
where the JAX package's are.  The ops that are host numpy in the JAX
package stay host numpy here (`anchor_generator`, `bipartite_match`,
`ctc_align`, `edit_distance`, `similarity_focus`: greedy or dynamic
programming walks, as Paddle's CPU kernels) and return tensors on the
input's device; no other op leaves the device.  Kept from the JAX
package: `hash_op` hashes with FNV-1a where Paddle uses xxHash (the ids
equal the JAX package's; uint32 arithmetic in int64 masked to 32 bits);
`sampling_id` and `shuffle_batch` draw from a ``torch.Generator`` and
equal the JAX package's in distribution only.
"""
from __future__ import annotations

import numpy as np
import torch

from ._util import div as _div
from ._util import host as _host

__all__ = [
    "add_position_encoding", "affine_channel", "anchor_generator",
    "bipartite_match", "bpr_loss", "center_loss", "ctc_align", "data_norm",
    "edit_distance", "gather_tree", "hinge_loss", "l1_norm", "mean_iou",
    "modified_huber_loss", "rank_loss", "sampling_id", "space_to_depth",
    "squared_l2_distance", "squared_l2_norm", "teacher_student_sigmoid_loss",
    "row_conv", "set_value", "segment_sum", "segment_mean", "segment_max",
    "segment_min", "segment_pool", "fsp_matrix", "Print", "Assert",
    "conv_shift", "cvm", "shuffle_batch", "hash_op", "batch_fc",
    "similarity_focus", "lookup_table_dequant",
]

_U32 = 0xFFFFFFFF


def _dev(x):
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def add_position_encoding(x, alpha=1.0, beta=1.0, name=None):
    """``alpha * x + beta * PE`` with the sinusoidal encoding (sines,
    then cosines) of x [B, T, D]."""
    b, t, d = x.shape
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    half = d // 2
    div = torch.pow(torch.tensor(10000.0, device=x.device),
                    _div(torch.arange(half, dtype=torch.float32,
                                      device=x.device), half))
    ang = pos / div[None, :]
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if pe.shape[-1] < d:
        pe = torch.nn.functional.pad(pe, (0, d - pe.shape[-1]))
    return alpha * x + beta * pe[None].to(x.dtype)


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None):
    """``x * scale + bias`` a channel."""
    shape = (1, -1, 1, 1) if data_layout == "NCHW" else (1, 1, 1, -1)
    return x * scale.reshape(shape) + bias.reshape(shape)


def anchor_generator(input, anchor_sizes, aspect_ratios, variances,
                     stride, offset=0.5, name=None):
    """RPN anchors [H, W, A, 4] (xyxy) of a feature map and their
    variances (host numpy, as Paddle's kernel: aspect ratios the outer
    loop, base sizes rounded from the stride cell)."""
    h, w = int(input.shape[2]), int(input.shape[3])
    sw, sh = float(stride[0]), float(stride[1])
    ws, hs = [], []
    for ar in aspect_ratios:
        base_w = np.round(np.sqrt(sw * sh / ar))
        base_h = np.round(base_w * ar)
        for size in anchor_sizes:
            ws.append(size / sw * base_w)
            hs.append(size / sh * base_h)
    a = len(ws)
    cx = np.arange(w) * sw + offset * (sw - 1)
    cy = np.arange(h) * sh + offset * (sh - 1)
    cxg, cyg = np.meshgrid(cx, cy)
    half_w = (np.asarray(ws, np.float32) - 1.0) * 0.5
    half_h = (np.asarray(hs, np.float32) - 1.0) * 0.5
    anchors = np.stack([
        cxg[..., None] - half_w, cyg[..., None] - half_h,
        cxg[..., None] + half_w, cyg[..., None] + half_h,
    ], axis=-1).astype(np.float32)
    var = np.broadcast_to(np.asarray(variances, np.float32),
                          (h, w, a, 4)).copy()
    dev = _dev(input)
    return torch.from_numpy(anchors).to(dev), torch.from_numpy(var).to(dev)


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    """Greedy bipartite matching of rows (ground truth) to columns
    (priors): ``(match_indices [cols] (-1 unmatched), match_dist
    [cols])``.  Host numpy, as Paddle's CPU-only kernel."""
    d = np.asarray(_host(dist_matrix), np.float32).copy()
    rows, cols = d.shape
    match_idx = np.full((cols,), -1, np.int64)
    match_dist = np.zeros((cols,), np.float32)
    work = d.copy()
    for _ in range(min(rows, cols)):
        r, c = np.unravel_index(np.argmax(work), work.shape)
        if work[r, c] < 1e-6:
            break
        match_idx[c] = r
        match_dist[c] = d[r, c]
        work[r, :] = -1.0
        work[:, c] = -1.0
    if match_type == "per_prediction":
        for c in range(cols):
            if match_idx[c] == -1:
                r = int(np.argmax(d[:, c]))
                if d[r, c] >= max(dist_threshold, 1e-6):
                    match_idx[c] = r
                    match_dist[c] = d[r, c]
    dev = _dev(dist_matrix)
    return (torch.from_numpy(match_idx).to(dev),
            torch.from_numpy(match_dist).to(dev))


def bpr_loss(input, label, name=None):
    """Bayesian personalised ranking: ``-mean_j log sigmoid(pos -
    logit_j)`` over the other classes, [N, 1]."""
    n, c = input.shape
    y = label.reshape(-1).long()
    pos = input.gather(1, y[:, None])
    logsig = torch.nn.functional.logsigmoid(pos - input)
    mask = 1.0 - torch.nn.functional.one_hot(y, c).to(input.dtype)
    return -_div((logsig * mask).sum(1, keepdim=True), c - 1)


def center_loss(input, label, centers, alpha=0.5, update_center=True,
                name=None):
    """``0.5 * |x - center(y)|^2`` a row (differentiated in ``input``
    only), and the updated centers: ``c + alpha * sum(diff) / (count +
    1)``."""
    y = label.reshape(-1).long()
    diff = input - centers.detach()[y]
    loss = 0.5 * (diff * diff).sum(1, keepdim=True)
    with torch.no_grad():
        if update_center:
            counts = torch.zeros(centers.shape[0], dtype=input.dtype,
                                 device=input.device).index_add(
                0, y, torch.ones_like(y, dtype=input.dtype))
            sums = torch.zeros_like(centers).index_add(0, y, diff.detach())
            new_c = centers + alpha * sums / (counts[:, None] + 1.0)
        else:
            new_c = centers.detach().clone()
    return loss, new_c


def ctc_align(input, blank=0, merge_repeated=True, padding_value=0,
              input_length=None, name=None):
    """CTC decode of each row: repeats merged, blanks dropped, padded with
    ``padding_value``; returns ``(out, lengths)`` (host numpy)."""
    arr = _host(input)
    in_lens = _host(input_length).reshape(-1) \
        if input_length is not None else None
    out = np.full_like(arr, padding_value)
    lens = np.zeros((arr.shape[0],), np.int64)
    for i, row in enumerate(arr):
        prev, k = None, 0
        n = int(in_lens[i]) if in_lens is not None else len(row)
        for v in row[:n]:
            if merge_repeated and prev is not None and v == prev:
                continue
            prev = v
            if v != blank:
                out[i, k] = v
                k += 1
        lens[i] = k
    dev = _dev(input)
    return torch.from_numpy(out).to(dev), torch.from_numpy(lens).to(dev)


def data_norm(x, means, scales, name=None):
    """``(x - mean) * scale`` with given statistics."""
    return (x - means) * scales


def edit_distance(input, label, normalized=True, input_length=None,
                  label_length=None, name=None):
    """Levenshtein distance of each row pair of ids [B, T] (host dynamic
    programming), divided by the label's length when ``normalized``;
    returns ``(distances [B, 1], sequence count [1])``."""
    a, b = _host(input), _host(label)
    il = _host(input_length).reshape(-1) if input_length is not None \
        else np.full(a.shape[0], a.shape[1])
    ll = _host(label_length).reshape(-1) if label_length is not None \
        else np.full(b.shape[0], b.shape[1])
    out = np.zeros((a.shape[0], 1), np.float32)
    for i in range(a.shape[0]):
        x, y = a[i, :int(il[i])], b[i, :int(ll[i])]
        n = len(y)
        dp = np.arange(n + 1, dtype=np.int64)
        for r in range(1, len(x) + 1):
            prev, dp[0] = dp[0], r
            for c in range(1, n + 1):
                cur = dp[c]
                dp[c] = min(dp[c] + 1, dp[c - 1] + 1,
                            prev + (x[r - 1] != y[c - 1]))
                prev = cur
        d = float(dp[n])
        out[i, 0] = d / max(n, 1) if normalized else d
    dev = _dev(input)
    return (torch.from_numpy(out).to(dev),
            torch.full((1,), a.shape[0], dtype=torch.long, device=dev))


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


def hinge_loss(input, label, name=None):
    """``max(0, 1 - pred * (2y - 1))``."""
    return torch.clamp(1.0 - input * (2.0 * label - 1.0), min=0.0)


def l1_norm(x, name=None):
    return x.abs().sum()


def mean_iou(input, label, num_classes, name=None):
    """Mean IoU of integer predictions against labels over a confusion
    matrix on the inputs' device: ``(mean_iou, out_wrong [C],
    out_correct [C])``; a mismatch counts against both its label's and
    its prediction's class."""
    p = input.reshape(-1).long()
    t = label.reshape(-1).long().to(p.device)
    c = int(num_classes)
    conf = torch.zeros(c * c, dtype=torch.float32, device=p.device)
    conf = conf.index_add(0, t * c + p, torch.ones_like(
        p, dtype=torch.float32)).reshape(c, c)
    inter = torch.diagonal(conf)
    union = conf.sum(0) + conf.sum(1) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp(union, min=1.0), 0.0)
    miou = iou.sum() / torch.clamp(valid.sum(), min=1)
    return miou, conf.sum(0) + conf.sum(1) - 2.0 * inter, inter


def modified_huber_loss(input, label, name=None):
    """``z = pred * (2y - 1)``: ``max(0, 1 - z)^2`` for ``z >= -1``,
    else ``-4z``."""
    z = input * (2.0 * label - 1.0)
    return torch.where(z >= -1.0, torch.square(torch.clamp(1.0 - z,
                                                           min=0.0)),
                       -4.0 * z)


def rank_loss(label, left, right, name=None):
    """RankNet's pairwise loss ``log(1 + e^d) - y d``, ``d = left -
    right``."""
    d = left - right
    return torch.log1p(torch.exp(d)) - label * d


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64", name=None):
    """A category a row of probabilities: ``r ~ U(min, max)`` walks the
    row's CDF (past the total mass, the last index).  ``seed`` other than
    0 seeds a generator of its own, else ``paddle.seed``'s."""
    from ..core import framework
    from ._util import dt

    if seed:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
    else:
        gen = framework.generator_for(x.device)
    n = x.shape[0]
    r = torch.rand(n, generator=gen, device=x.device) * (max - min) + min
    cdf = torch.cumsum(x, dim=-1)
    ids = torch.argmax((cdf >= r[:, None]).to(torch.int8), dim=-1)
    ids = torch.where(r > cdf[:, -1], x.shape[1] - 1, ids)
    return ids.to(dt(dtype))


def space_to_depth(x, blocksize, name=None):
    """Darknet's reorg, [N, C, H, W] to [N, C * bs^2, H / bs, W / bs],
    through Paddle's intermediate [N, C / bs^2, H * bs, W * bs] reading
    of the buffer (C divisible by bs^2)."""
    bs = int(blocksize)
    n, c, h, w = x.shape
    if c % (bs * bs):
        raise ValueError(
            f"space_to_depth: channel {c} must divide blocksize^2 "
            f"{bs * bs} (reference PADDLE_ENFORCE)")
    out_c = c // (bs * bs)
    interp = x.reshape(n, bs, bs, out_c, h, w).permute(0, 3, 4, 1, 5, 2)
    interp = interp.reshape(n, out_c, h * bs, w * bs)
    return interp.reshape(n, c * bs * bs, h // bs, w // bs)


def squared_l2_distance(x, y, name=None):
    """``(sum((x - y)^2) a row [N, 1], x - y)``."""
    sub = x - y
    return (sub * sub).sum(-1, keepdim=True), sub


def squared_l2_norm(x, name=None):
    return (x * x).sum()


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0, name=None):
    """The distillation loss over Paddle's label code: -2 no teacher, no
    click; -1 no teacher, click; [0, 1) a teacher's score, no click;
    [1, 2] 1 + the score, click: the hard cross entropy, plus the soft
    one where a teacher scored."""
    x, y = input, label
    softplus = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(
        y < -1.0, softplus,
        torch.where(y < 0.0, softplus - x,
                    torch.where(y < 1.0, softplus + softplus - x * y,
                                (softplus - x) + softplus - x * (y - 1.0))))


def row_conv(input, weight, name=None):
    """Lookahead row convolution (DeepSpeech2): ``out[t] = sum_k
    input[t + k] * weight[k]`` over ``weight`` [context + 1, D]."""
    ctx = weight.shape[0]
    b, t, d = input.shape
    pad = torch.nn.functional.pad(input, (0, 0, 0, ctx - 1))
    out = torch.zeros_like(input)
    for k in range(ctx):
        out = out + pad[:, k:k + t, :] * weight[k][None, None, :]
    return out


def set_value(x, value, slices=None, name=None):
    """``x`` with ``x[slices] = value`` (all of it without ``slices``),
    out of place and differentiable in both."""
    val = value if isinstance(value, torch.Tensor) else \
        torch.as_tensor(np.asarray(value), device=x.device)
    if slices is None:
        return torch.broadcast_to(val.to(x.dtype), x.shape).clone()
    out = x.clone()
    out[slices] = val.to(x.dtype)
    return out


def _n_segments(segment_ids):
    return int(segment_ids.max().item()) + 1


def segment_sum(data, segment_ids, name=None):
    """Sums of the rows of each segment id (``max(id) + 1`` segments,
    read on the host)."""
    n = _n_segments(segment_ids)
    s = segment_ids.to(data.device).long()
    return data.new_zeros((n,) + tuple(data.shape[1:])).index_add(0, s,
                                                                  data)


def _segment_reduce(data, segment_ids, mode):
    n = _n_segments(segment_ids)
    s = segment_ids.to(data.device).long()
    if mode == "mean":
        tot = data.new_zeros((n,) + tuple(data.shape[1:])).index_add(
            0, s, data)
        cnt = data.new_zeros(n).index_add(0, s, torch.ones_like(
            s, dtype=data.dtype))
        return tot / torch.clamp(cnt, min=1).reshape(
            (-1,) + (1,) * (data.dim() - 1))
    if mode not in ("max", "min"):
        raise ValueError(mode)
    # an empty segment holds the reduction's identity, as
    # jax.ops.segment_max/min
    info = torch.finfo(data.dtype) if data.is_floating_point() else \
        torch.iinfo(data.dtype)
    fill = (-torch.inf if mode == "max" else torch.inf) \
        if data.is_floating_point() else (info.min if mode == "max"
                                          else info.max)
    init = torch.full((n,) + tuple(data.shape[1:]), fill, dtype=data.dtype,
                      device=data.device)
    idx = s.reshape((-1,) + (1,) * (data.dim() - 1)).expand(data.shape)
    return init.scatter_reduce(0, idx, data, "amax" if mode == "max"
                               else "amin", include_self=True)


def segment_mean(data, segment_ids, name=None):
    return _segment_reduce(data, segment_ids, "mean")


def segment_max(data, segment_ids, name=None):
    return _segment_reduce(data, segment_ids, "max")


def segment_min(data, segment_ids, name=None):
    return _segment_reduce(data, segment_ids, "min")


def segment_pool(data, segment_ids, pool_type="sum", name=None):
    """`segment_sum`/`mean`/`max`/`min` by Paddle's ``pooltype``."""
    pt = pool_type.lower()
    if pt == "sum":
        return segment_sum(data, segment_ids)
    return _segment_reduce(data, segment_ids, pt)


def fsp_matrix(x, y, name=None):
    """The flow-of-solution-procedure matrix: [N, Cx, H, W] and [N, Cy,
    H, W] to ``x_flat @ y_flat^T / (H * W)`` [N, Cx, Cy]."""
    n, cx, h, w = x.shape
    out = torch.einsum("ncs,nds->ncd", x.reshape(n, cx, h * w),
                       y.reshape(n, y.shape[1], h * w))
    return _div(out, h * w)


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both", name=None):
    """Print the tensor's shape, dtype and first ``summarize`` values now
    (a host read); returns the input."""
    msg = message or ""
    vals = _host(input).ravel()[:summarize]
    print(f"{msg} shape={tuple(input.shape)} dtype={input.dtype} "
          f"values={vals}")
    return input


def Assert(cond, data=None, summarize=20, name=None):
    """Raise AssertionError (with the first values of ``data``) unless
    every element of ``cond`` holds; returns ``cond``."""
    from .control_flow import _readable

    ok = bool(_readable(cond).all()) if isinstance(cond, torch.Tensor) \
        else bool(np.all(cond))
    if not ok:
        detail = [_host(d).ravel()[:summarize] for d in (data or [])]
        raise AssertionError(f"Assert failed; data={detail}")
    return cond


def conv_shift(x, y, name=None):
    """Circular convolution: ``out[i, j] = sum_k x[i, (j + k - M // 2)
    mod W] * y[i, k]``."""
    w, m = x.shape[1], y.shape[1]
    j = torch.arange(w, device=x.device)[:, None]
    k = torch.arange(m, device=x.device)[None, :]
    idx = (j + k - m // 2) % w
    return torch.einsum("bwm,bm->bw", x[:, idx], y)


def cvm(x, cvm_input, use_cvm=True, name=None):
    """The continuous-value model: the show and click columns as
    ``log(show + 1)``, ``log(click + 1) - log(show + 1)``
    (``use_cvm``), or dropped."""
    if use_cvm:
        c0 = torch.log(x[:, :1] + 1.0)
        c1 = torch.log(x[:, 1:2] + 1.0) - c0
        return torch.cat([c0, c1, x[:, 2:]], dim=1)
    return x[:, 2:]


def shuffle_batch(x, seed=0, name=None):
    """The rows in a random order: ``(shuffled, shuffle_idx, seed)``."""
    from ..core import framework

    if seed:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(int(seed))
    else:
        gen = framework.generator_for(x.device)
    perm = torch.randperm(x.shape[0], generator=gen, device=x.device)
    return x[perm], perm, torch.tensor([seed], dtype=torch.int32,
                                       device=x.device)


def hash_op(x, num_hash=1, mod_by=100000000, name=None):
    """Feature hashing: each integer row [D] to ``num_hash`` ids ``mod
    mod_by``, [N, num_hash, 1], through distinct FNV-1a mixes."""
    v = (x.long() & _U32).reshape(x.shape[0], -1)
    outs = []
    for i in range(num_hash):
        h = torch.full((v.shape[0],), (2166136261 + i * 16777619) & _U32,
                       dtype=torch.long, device=x.device)
        for d in range(v.shape[1]):
            h = ((h ^ v[:, d]) * 16777619) & _U32
        outs.append(h % int(mod_by))
    return torch.stack(outs, dim=1)[:, :, None]


def batch_fc(x, w, bias=None, name=None):
    """One fully connected layer a slot: x [S, N, I], w [S, I, O], bias
    [S, O] to [S, N, O]."""
    out = torch.einsum("sni,sio->sno", x, w)
    return out if bias is None else out + bias[:, None, :]


def similarity_focus(x, axis, indexes, name=None):
    """The similarity-focus mask: for each index along ``axis``, the
    [B, C] slice's maxima picked greedily, each row and column once,
    OR-ed over the indexes and broadcast to x's shape (host numpy, as
    Paddle's CPU-only kernel)."""
    arr = np.asarray(_host(x), np.float32)
    n = arr.shape[0]
    if axis not in (1, 2, 3):
        raise ValueError("similarity_focus: axis must be 1, 2 or 3")
    if not indexes:
        raise ValueError("similarity_focus: indexes must be non-empty")
    out = np.zeros_like(arr)
    for b in range(n):
        mask = None
        for idx in indexes:
            t = np.take(arr[b], int(idx), axis=axis - 1)
            r, cc = t.shape
            used_r, used_c = np.zeros(r, bool), np.zeros(cc, bool)
            m = np.zeros((r, cc), bool)
            picked = 0
            for flat in np.argsort(-t, axis=None):
                i, j = divmod(int(flat), cc)
                if used_r[i] or used_c[j]:
                    continue
                m[i, j] = True
                used_r[i] = used_c[j] = True
                picked += 1
                if picked == min(r, cc):
                    break
            mask = m if mask is None else (mask | m)
        out[b] = np.broadcast_to(np.expand_dims(mask, axis - 1),
                                 arr[b].shape)
    return torch.from_numpy(out).to(_dev(x))


def lookup_table_dequant(w, ids, pow_2_bits=8, name=None):
    """A quantized embedding lookup: each row of ``w`` [V, 2 + P] packs
    its min and max as two f32 and then uint8 codes in the P f32 words
    after; out ``(max - min) / 2^bits * code + min``, [..., 4P]."""
    rows = w.detach()[ids.reshape(-1).long()]
    mn, mx = rows[:, 0:1], rows[:, 1:2]
    codes = rows[:, 2:].contiguous().view(torch.uint8).reshape(
        rows.shape[0], -1).float()
    out = _div(mx - mn, float(2 ** pow_2_bits)) * codes + mn
    return out.reshape(tuple(ids.shape) + (out.shape[-1],))
