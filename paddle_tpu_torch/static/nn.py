"""`paddle.static.nn` — the static-graph control-flow surface
(counterpart: paddle_tpu/static/nn.py; reference
`python/paddle/static/nn/__init__.py`).

`cond`, `while_loop`, `case` and `switch_case` are the port's eager
`ops/control_flow.py`: the predicate is read on the host and only the
taken branch runs.  The JAX package's traced branch (``lax.cond`` /
``while_loop`` / ``switch``, and the exporter's sub-blocks) comes with
slice 4b.
"""
from ..ops.control_flow import case, cond, switch_case, while_loop

__all__ = ["case", "cond", "switch_case", "while_loop"]
