"""The serving stack's runtime sanitizer (counterpart: paddle_tpu/analysis).

`sanitizer` is the runtime mode ``FLAGS_sanitize`` switches on: lock-order
cycle detection over the designated telemetry locks, warm retraces
raising instead of counting, a host-sync sentinel, and the
`KVBlockPool.assert_consistent` audit at every engine step.  The JAX
package's static passes (``analysis.passes``, ``tools/tracecheck.py``)
have no counterpart here yet.
"""
from . import sanitizer  # noqa: F401

__all__ = ["sanitizer"]
