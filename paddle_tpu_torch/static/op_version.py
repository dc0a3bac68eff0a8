"""Op-version compatibility upgrades for loaded programs (a copy of
paddle_tpu/static/op_version.py: the same upgraders on the same descs).

Reference: `framework/op_version_registry.h:142` — 67 reference ops carry
``REGISTER_OP_VERSION`` checkpoints recording incompatible changes
(new/deleted inputs, changed attribute defaults, bug-fixes that changed
behavior).  A serialized ProgramDesc stores each op type's version in
``op_version_map``; an executor loading an OLDER program must translate
old conventions to current semantics.

Most checkpoints need no action here: ``NewAttr`` entries choose defaults
equal to the old behavior (the checkpoint contract), and our translators
read attrs with those defaults.  The upgraders below cover the cases
where old programs mean something DIFFERENT:

* ``arg_max``/``arg_min`` < 1: the ``dtype`` default changed -1 -> 3
  (int64); old programs carrying -1/missing mean "int64 indices"
  (`operators/arg_max_op.cc:45`).
* ``roi_align`` < 1 / ``generate_proposals`` < 1: the bogus
  RpnRoisLod input/output was deleted
  (`operators/roi_align_op.cc:239`, `detection/generate_proposals_op.cc:305`).
* ``leaky_relu`` < 1: formula was ``max(x, alpha*x)`` (differs from the
  current piecewise form when alpha < 0 or alpha > 1); old programs keep
  the old math via the ``__legacy_formula__`` attr the interp translator
  honors (`operators/activation_op.cc` BugfixWithBehaviorChanged).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple


def program_op_versions(desc: Dict) -> Dict[str, int]:
    """op type -> saved version (absent = 0, the pre-registry era)."""
    out: Dict[str, int] = {}
    vmap = desc.get("op_version_map") or {}
    for pair in vmap.get("pair", []):
        name = pair.get("op_name")
        ver = (pair.get("op_version") or {}).get("version", 0)
        if name:
            out[name] = int(ver)
    return out


def _set_attr(op_desc: Dict, name: str, value, attr_type: int):
    attrs = op_desc.setdefault("attrs", [])
    for a in attrs:
        if a.get("name") == name:
            a.clear()
            a.update(_attr(name, value, attr_type))
            return
    attrs.append(_attr(name, value, attr_type))


def _attr(name, value, attr_type):
    from .proto import AttrType as T

    key = {T.INT: "i", T.BOOLEAN: "b", T.FLOAT: "f",
           T.STRING: "s", T.LONG: "l"}[attr_type]
    return {"name": name, "type": attr_type, key: value}


def _get_attr(op_desc: Dict, name: str):
    for a in op_desc.get("attrs", []):
        if a.get("name") == name:
            return a
    return None


def _up_argmax_dtype(op_desc: Dict):
    from .proto import AttrType as T

    a = _get_attr(op_desc, "dtype")
    if a is None or a.get("i", a.get("l", -1)) in (-1, None):
        _set_attr(op_desc, "dtype", 3, T.INT)  # VarType int64


def _drop_io(slot: str, name: str) -> Callable[[Dict], None]:
    def up(op_desc: Dict):
        op_desc[slot] = [v for v in op_desc.get(slot, [])
                         if v.get("parameter") != name]
    return up


def _up_leaky_relu(op_desc: Dict):
    from .proto import AttrType as T

    _set_attr(op_desc, "__legacy_formula__", True, T.BOOLEAN)


# op type -> [(first_fixed_version, upgrader)]: the upgrader runs when the
# program's saved version is BELOW first_fixed_version
UPGRADERS: Dict[str, List[Tuple[int, Callable[[Dict], None]]]] = {
    "arg_max": [(1, _up_argmax_dtype)],
    "arg_min": [(1, _up_argmax_dtype)],
    "roi_align": [(1, _drop_io("inputs", "RpnRoisLod"))],
    "generate_proposals": [(1, _drop_io("outputs", "RpnRoisLod"))],
    "leaky_relu": [(1, _up_leaky_relu)],
}


def upgrade_program(desc: Dict) -> int:
    """Apply version upgraders in place to every block; returns the
    number of ops touched.  Idempotent (upgraders are)."""
    versions = program_op_versions(desc)
    touched = 0
    for block in desc.get("blocks", []):
        for op_desc in block.get("ops", []):
            ups = UPGRADERS.get(op_desc.get("type"))
            if not ups:
                continue
            saved = versions.get(op_desc["type"], 0)
            for fixed_at, fn in ups:
                if saved < fixed_at:
                    fn(op_desc)
                    touched += 1
    return touched
