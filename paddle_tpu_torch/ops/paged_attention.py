"""Ragged paged attention over a paged KV cache (counterpart:
paddle_tpu/ops/pallas/paged_attention.py).

K/V live in page pools ``[Hkv, num_pages, page, D]`` indexed by a
per-sequence block table; each sequence has its own length, query heads
may outnumber KV heads (GQA), and ``q`` may carry several query tokens
per sequence with a per-sequence causal offset (chunked prefill).

`paged_attention` is the entry point.  A CUDA tensor goes to kernel K1
(`csrc/paged_attention.cu`) through `paged_attention_cuda`, or, over
int8 pages (``FLAGS_kv_quant=int8``), to kernel K2 in the same source
through `paged_attention_cuda_q`; a CPU tensor goes to
`paged_attention_reference`, the plain PyTorch version, which is also
what both kernels are checked against on the card.  There is no other
route: a CUDA input a kernel does not take raises.

Page-size selection, the write coordinates of the serving steps and the
quantized write (`paged_quant_write`) live here too.  Unlike JAX,
PyTorch raises on an out-of-bounds scatter index instead of dropping the
row.  So a serving pool holds one page more than its allocator hands
out, the **drop page**, whose id ``num_pages_total`` is JAX's "drop this
row" marker: a dropped row (and a dropped span page) lands there, no
block table points at it, and every write keeps its shape whatever the
data, which is what lets a step be captured in a CUDA graph.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..nn.functional.attention import multi_query_causal_mask
from ..observability import costmodel as _costmodel
from ..quantization.int8 import Q_MAX
from . import _build

__all__ = ["pick_page_size", "default_page_size", "paged_write_indices",
           "paged_write_rows", "paged_write", "paged_write_spans",
           "paged_quant_write",
           "paged_attention_reference", "paged_attention",
           "paged_attention_cuda", "paged_attention_cuda_q", "split_plan",
           "paged_attention_work"]

_MIN_PAGE_SIZE = 16
_DEFAULT_PAGE_SIZE = 64


def pick_page_size(max_len: int, page_size: int = _DEFAULT_PAGE_SIZE):
    """Largest power-of-two page (floor 16) that tiles ``max_len``;
    None when no page size tiles it."""
    while page_size > _MIN_PAGE_SIZE and max_len % page_size:
        page_size //= 2
    if page_size < _MIN_PAGE_SIZE or max_len % page_size:
        return None
    return page_size


def default_page_size(max_len: int) -> int:
    """The page size a pool uses when the caller picks none.  The JAX
    package first consults a page size autotuned on a TPU; those
    measurements do not transfer to the GPU, so the port uses the shrink
    rule alone."""
    return pick_page_size(max_len) or _MIN_PAGE_SIZE


def paged_write_indices(block_tables, seq_lens, write_caps, qn: int,
                        num_pages_total: int, page: int):
    """Scatter coordinates for writing up to ``qn`` new K/V rows per
    sequence: row ``i`` of sequence ``b`` lands at position
    ``seq_lens[b] + i``.  Rows ``i >= write_caps[b]`` get page id
    ``num_pages_total`` (the drop page, one past the live pages), the JAX
    package's "drop this row" marker.

    block_tables: [B, pages_max]; seq_lens, write_caps: [B].  Returns
    ``(page_idx, slot)``, both [B, qn] int64."""
    b, pages_max = block_tables.shape
    dev = block_tables.device
    offs = torch.arange(qn, dtype=torch.int64, device=dev)
    pos = seq_lens.long()[:, None] + offs[None, :]
    writable = offs[None, :] < write_caps.long()[:, None]
    # a capped row may sit past the block table's horizon: clamp the
    # lookup (JAX clamps gathers; torch would raise)
    bt_idx = torch.clamp(pos // page, max=pages_max - 1)
    rows = torch.arange(b, device=dev)[:, None]
    page_idx = torch.where(writable, block_tables.long()[rows, bt_idx],
                           num_pages_total)
    return page_idx, pos % page


def paged_write_rows(page_idx, slot, span_idx=None):
    """The flat write coordinates of one step: ``(page_idx, slot)`` of
    every row (any matching shape, flattened), and with ``span_idx``
    (`paged_write_spans`) the refold set of a quantized write after them.
    Dropped rows keep their page id ``num_pages_total``, the drop page,
    so the write's shape never depends on the data and nothing waits
    for the device."""
    rows = (page_idx.reshape(-1), slot.reshape(-1))
    return rows if span_idx is None else rows + (span_idx.reshape(-1),)


def paged_write(pages, write_rows, vals) -> None:
    """Write K or V rows into one layer's pages, IN PLACE.

    pages: [Hkv, num_pages_total + 1, page, D] (the last page the drop
    page); write_rows: `paged_write_rows`' output; vals: [R, Hkv, D], one
    row per coordinate.  The JAX steps return new pools that the jit
    donates; here the pool tensor itself is updated, and the rows JAX
    drops land in the drop page."""
    page_idx, slot = write_rows[:2]
    pages[:, page_idx, slot] = vals.transpose(0, 1).to(pages.dtype)


# ---------------------------------------------------------------------------
# Quantized KV pages (FLAGS_kv_quant=int8): symmetric per-page, per-head
# int8 with the quantization.int8 convention (scale = absmax / Q_MAX,
# dequant = q * scale)
# ---------------------------------------------------------------------------
def paged_write_spans(block_tables, seq_lens, write_caps, qn: int,
                      num_pages_total: int, page: int):
    """The distinct pages a write of up to ``qn`` rows per sequence (rows
    ``i < write_caps[b]`` at positions ``seq_lens[b] + i``) touches: the
    refold set of `paged_quant_write`, one entry per (sequence, page)
    instead of one per row.  Returns [B * n_span] int64 page ids, with
    ``num_pages_total`` (the drop marker) for inactive sequences and span
    slots past the write's last page; ``n_span = (qn + page - 2) // page
    + 1`` is the worst case (an unaligned ``qn``-row run)."""
    b, pages_max = block_tables.shape
    dev = block_tables.device
    n_span = (qn + page - 2) // page + 1
    j = torch.arange(n_span, dtype=torch.int64, device=dev)
    caps = write_caps.long()
    first = seq_lens.long() // page
    last = (seq_lens.long() + torch.clamp(caps, min=1) - 1) // page
    want = first[:, None] + j[None, :]
    valid = (caps[:, None] > 0) & (want <= last[:, None])
    bt_idx = torch.clamp(want, max=pages_max - 1)
    rows = torch.arange(b, device=dev)[:, None]
    span = torch.where(valid, block_tables.long()[rows, bt_idx],
                       num_pages_total)
    return span.reshape(-1)


def paged_quant_write(pages, scales, write_rows, vals):
    """Quantized write of new K or V rows into one layer's int8 pages, IN
    PLACE (counterpart: `paged_quant_write` of the JAX package, which
    returns new pools): fold the rows' per-head absmax into the running
    page scales and re-quantize a written page's existing rows when its
    scale grows (the refold), so a page stays consistent under one scale
    however incrementally it was filled.

    pages: [Hkv, P + 1, page, D] int8 (the last page the drop page);
    scales: [Hkv, P + 1] f32 running scales (absmax / Q_MAX; 0 = not
    written since the page was handed out, the engine zeroes a page's
    entry then); write_rows: `paged_write_rows`' ``(page_idx, slot)`` —
    the refold then runs per row, which is the distinct page set of a
    one-row-per-sequence decode write — or ``(page_idx, slot, spans)``;
    vals: [R, Hkv, D] float, one row per coordinate.

    The fold is a scatter-max (order-free under duplicate rows); the
    refold multiplies by ``s_old / s_new``: 1.0 where nothing grew (a
    bit no-op), 0 for a fresh page (its stale bytes become zeros);
    duplicate span ids write identical bytes.  Dropped rows and spans
    fold into and refold the drop page only.  Returns the number of
    live (page, head) scale entries that grew past an established value,
    a 0-d int32 tensor."""
    page_idx, slot = write_rows[:2]
    spans = write_rows[2] if len(write_rows) > 2 else page_idx
    h, live = pages.shape[0], pages.shape[1] - 1
    v = vals.float()                                      # [R, H, D]
    s_old = scales.clone()                                # [H, P]
    s_new = scales
    s_new.scatter_reduce_(1, page_idx[None].expand(h, -1),
                          v.abs().amax(dim=-1).T / Q_MAX, "amax")
    # refold the written pages' existing rows at the grown scale
    so_g, sn_g = s_old[:, spans], s_new[:, spans]         # [H, S]
    ratio = torch.where(so_g > 0,
                        so_g / torch.where(sn_g > 0, sn_g, 1.0), 0.0)
    old = pages[:, spans].float()                         # [H, S, page, D]
    pages[:, spans] = torch.round(old * ratio[..., None, None]).to(
        torch.int8)
    # the new rows at their page's (possibly grown) scale
    sn_rows = s_new[:, page_idx].T[..., None]             # [R, H, 1]
    q = torch.clamp(torch.round(v / torch.clamp(sn_rows, min=1e-30)),
                    -Q_MAX, Q_MAX).to(torch.int8)
    pages[:, page_idx, slot] = q.transpose(0, 1)
    grew = (s_new > s_old) & (s_old > 0)
    return grew[:, :live].sum().to(torch.int32)


def paged_attention_reference(q, k_pages, v_pages, block_tables, seq_lens,
                              scale=None, q_offsets=None, k_scales=None,
                              v_scales=None):
    """Plain PyTorch paged attention: `_xla_paged_attention` of the JAX
    package, with its cast discipline — the q.k product scaled in the
    input dtype, masked and softmaxed in f32, probabilities cast back —
    and fully masked rows zeroed after the softmax, so a seq_len 0 slot
    gives exact zeros.  Over int8 pages the gathered pages dequantize
    first, ``(q8 * scale)`` in f32 cast to q's dtype, as in JAX.

    q: [B, Hq, D] or [B, Q, Hq, D]; k_pages/v_pages: [Hkv, num_pages,
    page, D]; block_tables: [B, pages_max]; seq_lens, q_offsets: [B]
    (q_offsets defaults to ``seq_lens - Q``); k_scales/v_scales: [Hkv,
    num_pages] f32, with int8 pages only.  Returns q's shape."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    hkv, _, page, d = k_pages.shape
    b, qn, hq, _ = q.shape
    g = hq // hkv
    if q_offsets is None:
        q_offsets = seq_lens - qn
    s = scale if scale is not None else \
        1.0 / torch.sqrt(torch.tensor(float(d), dtype=q.dtype))
    bt = block_tables.long()
    # gather each sequence's pages: [Hkv, B, pages_max, page, D]
    k, v = k_pages[:, bt], v_pages[:, bt]
    if k_scales is not None:
        k = (k.float() * k_scales[:, bt][..., None, None]).to(q.dtype)
        v = (v.float() * v_scales[:, bt][..., None, None]).to(q.dtype)
    k = k.movedim(1, 0).reshape(b, hkv, -1, d)
    v = v.movedim(1, 0).reshape(b, hkv, -1, d)
    qg = q.reshape(b, qn, hkv, g, d)
    logits = (torch.einsum("bqhgd,bhsd->bqhgs", qg, k) * s).float()
    valid = multi_query_causal_mask(q_offsets, qn, seq_lens,
                                    k.shape[2])[:, :, None, None, :]
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    probs = torch.where(valid, probs, torch.zeros_like(probs))
    out = torch.einsum("bqhgs,bhsd->bqhgd", probs, v).reshape(b, qn, hq, d)
    return out[:, 0] if squeeze else out


# The kernels' geometry (csrc/paged_attention.cu): rows of a block on each
# path, KV positions of a split's chunk unit, and the blocks a launch aims
# for per SM.  The split count depends on host-known sizes only, so a step
# never waits for the device to choose it.
_TC_MIN_ROWS = 16
_TC_ROWS = 64
_SIMT_ROWS = 8
_CHUNK_UNIT = 64
_MAX_SPLITS = 16
_BLOCKS_PER_SM = 8


@functools.lru_cache(maxsize=256)
def split_plan(batch: int, rows: int, hkv: int, horizon: int,
               sm_count: int):
    """``(splits, chunk)`` of a launch over ``rows = q_len * group`` query
    rows a sequence and ``horizon = pages_max * page`` positions: the KV
    range is cut into ``splits`` chunks of ``chunk`` positions (a multiple
    of 64), as many as it takes to give the card about
    ``_BLOCKS_PER_SM`` blocks an SM, and no more than the range has
    64-position units, nor more than ``_MAX_SPLITS``."""
    if rows >= _TC_MIN_ROWS:
        row_tiles = -(-rows // _TC_ROWS)
    else:
        row_tiles = 1 if rows == 1 else -(-rows // _SIMT_ROWS)
    units = max(1, -(-horizon // _CHUNK_UNIT))
    want = -(-_BLOCKS_PER_SM * sm_count // max(1, batch * hkv * row_tiles))
    splits = min(max(want, 1), units, _MAX_SPLITS)
    per = -(-units // splits)
    return -(-units // per), per * _CHUNK_UNIT


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _PagedAttentionCuda:
    """ctypes wrapper of kernel K1 (``quant=False``: f32/bf16 pages) or K2
    (``quant=True``: int8 pages with per-page, per-head f32 scales).
    ``launches`` counts the kernel launches this process made; it grows
    by one per launch and nowhere else.  A call made while the stream is
    being captured into a CUDA graph launches nothing: it adds one to
    ``captured`` instead, and the graph adds its captured launches to
    ``launches`` each time it replays (`inference.serving._StepGraph`).

    A launch that splits the KV range gets an f32 workspace for the
    partials from the caching allocator and a zeroed int32 counter per
    (sequence, KV head, row tile), kept here per device, which the
    kernel leaves zero; launches on one device share the counters, so
    they run on one stream at a time.  The counters are allocated by an
    eager launch, never inside a capture (a graph's private memory
    must not outlive it), and a grown set keeps the old one alive for
    the graphs that hold its address."""

    _DTYPES = {torch.float32: 0, torch.bfloat16: 1}
    _HEAD_DIMS = (64, 128)

    def __init__(self, symbol: str, quant: bool):
        self.launches = 0
        self.captured = 0
        self._symbol = symbol
        self._quant = quant
        self._fn = None
        self._counters = {}
        self._retired = []

    def _kernel(self):
        if self._fn is None:
            fn = getattr(_build.load("paged_attention"), self._symbol)
            fn.argtypes = ([ctypes.c_void_p] * (11 if self._quant else 9)
                           + [ctypes.c_int] * 8
                           + [ctypes.c_longlong] * 3
                           + [ctypes.c_int] * 2
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _counters_for(self, device, n: int):
        have = self._counters.get(device)
        if have is None or have.numel() < n:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{self._symbol}: the split counters must exist before "
                    f"a capture; launch this shape once eagerly first")
            if have is not None:
                self._retired.append(have)
            have = self._counters[device] = torch.zeros(
                max(n, 1024), dtype=torch.int32, device=device)
        return have

    def __call__(self, q, k_pages, v_pages, block_tables, seq_lens,
                 q_offsets, scale=None, k_scales=None, v_scales=None):
        """q: [B, Q, Hq, D], its last dim contiguous and its other strides
        multiples of 16 bytes; the other arguments as for
        `paged_attention`, with ``q_offsets`` given, and the scales with
        K2 only.  Returns a dense [B, Q, Hq, D].  Raises on any input the
        kernel does not take."""
        if q.dim() != 4:
            raise ValueError(f"kernel takes q as [B, Q, Hq, D], got rank "
                             f"{q.dim()}")
        b, qn, hq, d = q.shape
        hkv, num_pages, page, dk = k_pages.shape
        pages_max = block_tables.shape[1]
        if q.dtype not in self._DTYPES:
            raise ValueError(f"kernel takes float32 or bfloat16, got "
                             f"{q.dtype}")
        if d not in self._HEAD_DIMS:
            raise ValueError(f"kernel takes head_dim in {self._HEAD_DIMS}, "
                             f"got {d}")
        if hq % hkv:
            raise ValueError(f"query heads {hq} not a multiple of kv heads "
                             f"{hkv}")
        kv_dtype = torch.int8 if self._quant else q.dtype
        for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
            if t.dtype != kv_dtype or tuple(t.shape) != (hkv, num_pages,
                                                         page, d):
                raise ValueError(f"{name} must be {kv_dtype} "
                                 f"[{hkv}, {num_pages}, {page}, {d}]")
        if hkv * num_pages * page >= 2 ** 31:
            raise ValueError("kernel takes pools of fewer than 2**31 rows")
        checks = [("block_tables", block_tables, torch.int32, (b, pages_max)),
                  ("seq_lens", seq_lens, torch.int32, (b,)),
                  ("q_offsets", q_offsets, torch.int32, (b,))]
        scales = ()
        if self._quant:
            scales = (k_scales, v_scales)
            checks += [(n, t, torch.float32, (hkv, num_pages))
                       for n, t in (("k_scales", k_scales),
                                    ("v_scales", v_scales))]
        elif k_scales is not None or v_scales is not None:
            raise ValueError("K1 takes no scales")
        for name, t, dtype, shape in checks:
            if t is None or t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {dtype} {list(shape)}")
        dev = q.device
        others = (k_pages, v_pages, block_tables, seq_lens, q_offsets,
                  *scales)
        if dev.type != "cuda" or any(t.device != dev for t in others):
            raise ValueError("kernel inputs must all lie on one CUDA "
                             "device")
        if not all(t.is_contiguous() for t in others):
            raise ValueError("kernel inputs other than q must be "
                             "contiguous")
        # a dim of size 1 is never stepped along: its stride is moot
        strides = [q.stride(i) if q.shape[i] > 1 else 0 for i in range(3)]
        if q.stride(3) != 1 or any(st % (16 // q.element_size())
                                   for st in strides):
            raise ValueError("q's last dim must be contiguous and its other "
                             "strides multiples of 16 bytes")
        for t in (q, k_pages, v_pages):
            if t.data_ptr() % 16:
                raise ValueError("q and pages must be 16-byte aligned")
        out = torch.empty((b, qn, hq, d), dtype=q.dtype, device=dev)
        if b == 0 or qn == 0:
            return out
        s = scale if scale is not None else 1.0 / math.sqrt(d)
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        rows = qn * (hq // hkv)
        splits, chunk = split_plan(b, rows, hkv, pages_max * page,
                                   _sm_count(index))
        ws = counters = None  # the workspace lives until the launch
        if splits > 1:
            counters = self._counters_for(
                dev, b * hkv * -(-rows // _SIMT_ROWS)).data_ptr()
            ws = torch.empty(b * hkv * splits * rows * (d + 2),
                             dtype=torch.float32, device=dev)
        args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                *(t.data_ptr() for t in scales), block_tables.data_ptr(),
                seq_lens.data_ptr(), q_offsets.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), counters,
                b, qn, hq, hkv, d, num_pages, page, pages_max,
                *strides, splits, chunk, float(s), self._DTYPES[q.dtype])
        # the launch goes to the current device: switch only when q is
        # elsewhere (the switch costs host time on every call)
        if index == torch.cuda.current_device():
            err = self._kernel()(*args,
                                 torch.cuda.current_stream(dev).cuda_stream)
        else:
            with torch.cuda.device(dev):
                err = self._kernel()(
                    *args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self._symbol} kernel launch failed: "
                               f"cudaError {err}")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        return out


paged_attention_cuda = _PagedAttentionCuda("paged_attention_fwd", False)
paged_attention_cuda_q = _PagedAttentionCuda("paged_attention_q_fwd", True)


def paged_attention_work(q_shape, k_pages_shape, pages_max: int,
                         kv_bytes: int, q_bytes: int, quant: bool):
    """``(flops, bytes)`` of one launch at its shapes, the most its
    fixed-shape grid can need: every query row over the whole block-table
    horizon (``pages_max * page`` positions), 4 * D flops a (row,
    position) pair (two products); bytes read q once, every K and V
    page of the horizon once (with their scales over int8 pages) and
    write the output once.  What a step's cost profile charges K1/K2
    (`observability.costmodel`), which no dispatch mode sees."""
    b, qn, hq, d = q_shape
    hkv, _, page, _ = k_pages_shape
    horizon = pages_max * page
    flops = 4.0 * d * hq * b * qn * horizon
    kv = 2.0 * b * hkv * horizon * d * kv_bytes
    if quant:
        kv += 2.0 * b * hkv * pages_max * 4
    return flops, kv + 2.0 * b * qn * hq * d * q_bytes + b * pages_max * 4


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                    scale=None, q_offsets=None, k_scales=None,
                    v_scales=None):
    """Attention of each sequence's queries over its paged KV cache.

    q: [B, Hq, D] (one query token per sequence) or [B, Q, Hq, D]
    (query ``i`` of sequence ``b`` at absolute position
    ``q_offsets[b] + i``); k_pages/v_pages: [Hkv, num_pages, page, D];
    block_tables: [B, pages_max] page ids in position order; seq_lens:
    [B] valid KV tokens per sequence (0 = inactive slot -> zeros);
    q_offsets: [B] (default ``seq_lens - Q``); k_scales/v_scales: [Hkv,
    num_pages] f32 per-page, per-head dequant scales, required with int8
    pages and refused otherwise.  Hq must be a multiple of Hkv.  CUDA
    tensors run kernel K1, or K2 over int8 pages; CPU tensors the plain
    version.
    """
    hkv, num_pages, page, d = k_pages.shape
    if q.dim() not in (3, 4):
        raise ValueError(f"q must be [B, Hq, D] or [B, Q, Hq, D], "
                         f"got rank {q.dim()}")
    hq, dq = q.shape[-2], q.shape[-1]
    if hq % hkv:
        raise ValueError(
            f"query heads {hq} not a multiple of kv heads {hkv}")
    if dq != d:
        raise ValueError(f"head_dim mismatch: q {dq} vs pages {d}")
    quant = k_pages.dtype == torch.int8
    if quant:
        if k_scales is None or v_scales is None:
            raise ValueError(
                "int8 KV pages need k_scales/v_scales ([Hkv, num_pages]"
                " f32 per-page dequant scales)")
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if tuple(t.shape) != (hkv, num_pages):
                raise ValueError(
                    f"{name} shape {tuple(t.shape)} != (Hkv, num_pages) = "
                    f"{(hkv, num_pages)}")
    elif k_scales is not None or v_scales is not None:
        raise ValueError(
            "k_scales/v_scales passed for non-int8 KV pages "
            f"(dtype {k_pages.dtype})")
    tally = _costmodel.active_tally()
    if tally is not None:
        # a cost profile is being counted: charge the kernel's work
        # formula, one row, and hide the inner ops (the CPU's plain
        # version, the wrapper's allocations) from the count
        qs = tuple(q.shape) if q.dim() == 4 else \
            (q.shape[0], 1, *q.shape[1:])
        flops, nbytes = paged_attention_work(
            qs, tuple(k_pages.shape), block_tables.shape[1],
            k_pages.element_size(), q.element_size(), quant)
        tally.note("paged_attention[K2]" if quant else
                   "paged_attention[K1]", flops, nbytes)
        with tally.pause():
            return _paged_attention(q, k_pages, v_pages, block_tables,
                                    seq_lens, scale, q_offsets, k_scales,
                                    v_scales, quant)
    return _paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                            scale, q_offsets, k_scales, v_scales, quant)


def _paged_attention(q, k_pages, v_pages, block_tables, seq_lens, scale,
                     q_offsets, k_scales, v_scales, quant):
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         seq_lens, scale, q_offsets,
                                         k_scales, v_scales)
    squeeze = q.dim() == 3
    q4 = q[:, None] if squeeze else q
    if q_offsets is None:
        q_offsets = seq_lens - q4.shape[1]
    if quant:
        out = paged_attention_cuda_q(q4, k_pages, v_pages, block_tables,
                                     seq_lens, q_offsets, scale, k_scales,
                                     v_scales)
    else:
        out = paged_attention_cuda(q4, k_pages, v_pages, block_tables,
                                   seq_lens, q_offsets, scale)
    return out[:, 0] if squeeze else out
