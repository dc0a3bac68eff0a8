"""Partition rules for tensor-parallel serving (counterpart:
paddle_tpu/parallel/partition.py, copied and adapted, not imported).

Each rule is ``(regex, PartitionSpec)``, matched with `re.search` against
the '/'-joined path of a leaf of the serving params dict
(``blocks/3/qkv_w``, ``wte``, ...).  The first match wins; scalars and
size-1 leaves always replicate; a leaf no rule covers raises.  The rules
are JAX's, over the single ``"mp"`` axis: qkv and fc1 split on their
columns, out and fc2 on their rows (their products end in an all-reduce),
the biases of column-split products with their columns, everything else
replicated.

**One rule differs by design: qkv is split head-aligned.**  JAX's rule
``qkv_w -> P(None, "mp")`` cuts the packed ``3h`` columns into contiguous
halves, so at ``mp=2`` rank 0 would hold all of q and half of k: not
whole heads.  GSPMD then gathers ``qkv`` back into head order before
attention.  On `tests/test_sharded_serving.py`'s TINY model (2 slots x
16 ragged rows, 2 layers, h = 32, mp=2) the optimized HLO of one ragged
step holds 4 all-reduces (16384 bytes, after out_w and fc2_w) and 2
all-gathers of the whole ``[32, 96]`` qkv (24576 bytes): 40960 bytes of
collectives.  Here the ``3h`` axis is viewed as ``(3, H, D)`` and split
on ``H`` (`QKV_HEADS`), as Megatron does: q, k and v of the same heads
land on one rank, attention and the KV write stay local, and the step
moves the 16384 bytes of the all-reduces alone.  It is the same function.

The weight bridge: `shard_params` cuts the port's params dict (the output
of `inference.weights.params_from_numpy` or `GPT.params()`, int8 weight
pairs included) into one dict a rank, `gather_params` joins them back.

Training's tables: `gpt_train_rules` (JAX's, for `models.gpt_spmd`'s
stacked pytree over ``pp`` and ``mp``; its packed qkv axis is head-major
there, so a contiguous ``mp`` split already holds whole heads) and
`gpt_tensor_parallel_rules` (the `models.gpt.GPT` module under a
tensor-parallel group: the serving table with the vocab-parallel ``wte``
and the untied head split on its columns).  `shard_leaf` cuts a leaf by
a spec of any number of sharded axes for one rank's coordinates
(``{"mp": (rank, size), "pp": ...}``), `join_leaf` joins one axis back.
"""
from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["PartitionSpec", "P", "QKV_HEADS", "tree_path_names",
           "match_partition_rules", "gpt_serving_rules", "gpt_train_rules",
           "gpt_tensor_parallel_rules", "shard_leaf", "join_leaf",
           "kv_pages_spec",
           "kv_scales_spec", "parse_mesh_spec", "build_mesh",
           "shard_params", "gather_params", "collective_bytes"]

# the axis entry of a packed qkv axis split head-aligned: viewed as
# (3, H, D) and sharded on H over "mp"
QKV_HEADS = "mp:heads"


class PartitionSpec(tuple):
    """One entry an axis of a leaf: None (replicated), ``"mp"`` (split in
    contiguous blocks over the mesh) or `QKV_HEADS`.  Trailing replicated
    axes may be left out, as in JAX."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P" + super().__repr__().replace(",)", ")")

    def axis(self):
        """``(axis index, entry)`` of the sharded axis, or None."""
        for i, a in enumerate(self):
            if a is not None:
                return i, a
        return None


P = PartitionSpec


# ---------------------------------------------------------------------------
# tree paths + rule matching
# ---------------------------------------------------------------------------
def _walk(tree, prefix=()):
    """``(path, leaf)`` of every non-None leaf, in JAX's tree_leaves order
    (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _map(tree, fn, prefix=()):
    if isinstance(tree, dict):
        return {k: _map(v, fn, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(prefix, tree)


def tree_path_names(tree, sep: str = "/") -> List[str]:
    """'/'-joined path of every leaf, in tree_leaves order."""
    return [sep.join(p) for p, _ in _walk(tree)]


def match_partition_rules(rules: Sequence[Tuple[str, PartitionSpec]],
                          params):
    """The params dict with a `PartitionSpec` at each leaf (None stays
    None).  Scalars and size-1 leaves replicate; every other leaf takes
    the spec of the first rule whose regex `re.search`-es its path, and a
    leaf no rule covers raises."""
    def spec_of(path, leaf):
        name = "/".join(path)
        if leaf.dim() == 0 or leaf.numel() == 1:
            return P()
        for rule, spec in rules:
            if re.search(rule, name):
                return spec
        raise ValueError(f"Partition rule not found for param: {name}")

    return _map(params, spec_of)


# ---------------------------------------------------------------------------
# GPT rule tables
# ---------------------------------------------------------------------------
def gpt_serving_rules() -> List[Tuple[str, PartitionSpec]]:
    """JAX's serving rules over the per-block weights ([in, out]) and
    the replicated embeddings, norms and head.  Int8 weights
    (``serve_weights="int8"``) carry ``*_q``/``*_s`` pairs: the int8
    payload shards like its f32 twin, the per-out-channel scale like the
    column-split bias; row-split weights keep their out axis whole, so
    their scales replicate.  qkv splits head-aligned (`QKV_HEADS`, the
    module docstring says why)."""
    return [
        (r"qkv_w(_q)?$", P(None, QKV_HEADS)),
        (r"(qkv_b|qkv_w_s)$", P(QKV_HEADS)),
        (r"out_w(_q)?$", P("mp", None)),
        (r"fc1_w(_q)?$", P(None, "mp")),
        (r"(fc1_b|fc1_w_s)$", P("mp")),
        (r"fc2_w(_q)?$", P("mp", None)),
        (r".*", P()),
    ]


def gpt_train_rules() -> List[Tuple[str, PartitionSpec]]:
    """JAX's rules for `models.gpt_spmd`'s parameter pytree: the stacked
    block parameters lead with ``pp``, qkv and fc1 split their columns
    over ``mp`` (the packed qkv axis is head-major, so contiguous shards
    hold whole heads), out and fc2 their rows, a vocab-parallel ``wte``
    and ``lm_head``, replicated norms, ``wpe`` and row-product biases."""
    return [
        (r"^wte$", P("mp", None)),
        (r"^wpe$", P()),
        (r"^(ln1|ln2)_(w|b)$", P("pp", None)),
        (r"^w_qkv$", P("pp", None, "mp")),
        (r"^b_qkv$", P("pp", "mp")),
        (r"^w_out$", P("pp", "mp", None)),
        (r"^w_fc1$", P("pp", None, "mp")),
        (r"^b_fc1$", P("pp", "mp")),
        (r"^w_fc2$", P("pp", "mp", None)),
        (r"^(b_out|b_fc2)$", P("pp", None)),
        (r"^lnf_(w|b)$", P()),
        (r"^lm_head$", P(None, "mp")),
    ]


def gpt_tensor_parallel_rules() -> List[Tuple[str, PartitionSpec]]:
    """The `models.gpt.GPT` params tree (``GPT.params()``'s layout) under
    a tensor-parallel group: qkv head-aligned (`QKV_HEADS`), fc1 on its
    columns, out and fc2 on their rows, the vocab-parallel ``wte`` on its
    rows (the tied head reads it), an untied head on its columns, the
    rest replicated."""
    return [
        (r"qkv_w$", P(None, QKV_HEADS)),
        (r"qkv_b$", P(QKV_HEADS)),
        (r"out_w$", P("mp", None)),
        (r"fc1_w$", P(None, "mp")),
        (r"fc1_b$", P("mp")),
        (r"fc2_w$", P("mp", None)),
        (r"^wte$", P("mp", None)),
        (r"^head_w$", P(None, "mp")),
        (r".*", P()),
    ]


def kv_pages_spec() -> PartitionSpec:
    """KV page pool [L, H, pages, page, D]: split on the head axis, so
    each rank holds its heads of every page; page ids, the allocator and
    the block tables stay the controller's, whole."""
    return P(None, "mp")


def kv_scales_spec() -> PartitionSpec:
    """int8 KV page scales [L, H, pages]: the head axis, with the
    pages."""
    return P(None, "mp")


# ---------------------------------------------------------------------------
# mesh specs
# ---------------------------------------------------------------------------
def parse_mesh_spec(spec: str) -> List[Tuple[str, int]]:
    """'mp=2' / 'dp=2,mp=4' -> ordered [(axis, size), ...].  Raises on
    malformed axes or non-positive sizes; an empty string is an error
    here (callers treat empty as mesh-off before parsing)."""
    out: List[Tuple[str, int]] = []
    if not spec or not spec.strip():
        raise ValueError("empty mesh spec")
    for part in spec.split(","):
        m = re.fullmatch(r"\s*([A-Za-z_]\w*)\s*=\s*(\d+)\s*", part)
        if not m:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected 'axis=N[,axis=N...]'")
        name, n = m.group(1), int(m.group(2))
        if n <= 0:
            raise ValueError(f"bad mesh spec {spec!r}: {name}={n}")
        if any(name == a for a, _ in out):
            raise ValueError(f"bad mesh spec {spec!r}: duplicate axis {name}")
        out.append((name, n))
    return out


def build_mesh(spec: str, device=None):
    """The process's `mesh.Mesh` for ``spec`` on ``device`` (the
    controller's; None = the card), started at the first call and shared
    by every engine built on it after.  `mesh.Mesh` states the backend and
    placement rule."""
    from .mesh import get_mesh

    return get_mesh(spec, device)


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------
def shard_leaf(t: torch.Tensor, spec, coords: dict) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: every axis whose entry
    names a mesh axis in ``coords`` (``{axis: (rank, size)}``) is cut
    into ``size`` contiguous blocks and the ``rank``-th kept; `QKV_HEADS`
    cuts a packed ``(3, H, D)`` axis on ``H`` by the ``"mp"``
    coordinate.  A copy when anything was cut."""
    cut = False
    for i, entry in enumerate(spec):
        name = "mp" if entry == QKV_HEADS else entry
        if name is None or name not in coords or coords[name][1] == 1:
            continue
        r, n = coords[name]
        if entry == QKV_HEADS:
            t = t.unflatten(i, (3, n, -1)).select(i + 1, r).flatten(i, i + 1)
        else:
            t = t.narrow(i, r * (t.shape[i] // n), t.shape[i] // n)
        cut = True
    return t.clone() if cut else t


def join_leaf(parts, spec, axis: str) -> torch.Tensor:
    """Join the blocks of the mesh axis ``axis`` (in rank order) back
    along the tensor axis ``spec`` gives it: `shard_leaf`'s inverse for
    one axis."""
    for i, entry in enumerate(spec):
        if entry == axis or (axis == "mp" and entry == QKV_HEADS):
            break
    else:
        return parts[0]
    if entry == QKV_HEADS:
        return torch.stack([p.unflatten(i, (3, -1)) for p in parts],
                           i + 1).flatten(i, i + 2)
    return torch.cat(list(parts), i)


def _shard(t: torch.Tensor, spec: PartitionSpec, mp: int, rank: int):
    ax = spec.axis()
    if ax is None or mp == 1:
        return t
    i, kind = ax
    if kind == QKV_HEADS:
        v = t.unflatten(i, (3, mp, -1)).select(i + 1, rank)
        return v.flatten(i, i + 1).clone()
    n = t.shape[i] // mp
    return t.narrow(i, rank * n, n).clone()


def shard_params(params: dict, specs: dict, mp: int) -> List[dict]:
    """Cut ``params`` by ``specs`` (`match_partition_rules`' output) into
    ``mp`` dicts of the same layout, rank by rank.  A replicated leaf is
    the same tensor in every dict; a sharded leaf is a copy of its
    block, so the whole can be freed."""
    out = []
    for r in range(mp):
        out.append(_map(params, lambda path, t, r=r: _shard(
            t, _at(specs, path), mp, r)))
    return out


def gather_params(shards: List[dict], specs: dict) -> dict:
    """Join one dict a rank back into the whole (`shard_params`'
    inverse)."""
    mp = len(shards)

    def join(path, t0):
        spec = _at(specs, path)
        ax = spec.axis()
        if ax is None or mp == 1:
            return t0
        parts = [_at(s, path) for s in shards]
        i, kind = ax
        if kind == QKV_HEADS:
            parts = [p.unflatten(i, (3, -1)) for p in parts]
            return torch.stack(parts, i + 1).flatten(i, i + 2)
        return torch.cat(parts, i)

    return _map(shards[0], join)


def _at(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


# ---------------------------------------------------------------------------
# the collective volume of a sharded step
# ---------------------------------------------------------------------------
def collective_bytes(*, rows: int, hidden: int, layers: int, mp: int,
                     dtype_bytes: int = 4, kv_int8: bool = False) -> float:
    """Bytes one sharded step moves through collectives, counted from
    its arithmetic: two all-reduces a block (after the row-split out_w
    and fc2_w products) of ``[rows, hidden]`` in the activation dtype,
    and with int8 KV the step's refold count (one int32).  0 at
    ``mp=1``, where nothing leaves the card.  On JAX's TINY probe (rows
    2 x 16, hidden 32, 2 layers, f32) this is 16384, JAX's all-reduce
    bytes; JAX's all-gathers of qkv have no counterpart here."""
    if mp <= 1:
        return 0.0
    out = 2.0 * layers * rows * hidden * dtype_bytes
    return out + (4.0 if kv_int8 else 0.0)
