"""Shared harness of the port's fleet tests (tests/test_torch_fleet.py,
tests/test_torch_fleettrace.py): a `_Fleet` per package — its `Side`
(tests/torch_reliability_common.py) plus the fleet, ops-server and alert
modules — and the HTTP helpers both files drive the edges with."""
import json
import urllib.request

from paddle_tpu import fleet as JFL
from paddle_tpu.observability import alerts as JAL
from paddle_tpu.observability import opsserver as JOPS
from paddle_tpu_torch import fleet as TFL
from paddle_tpu_torch.fleet.router import _sse_events
from paddle_tpu_torch.observability import alerts as TAL
from paddle_tpu_torch.observability import opsserver as TOPS

from torch_reliability_common import Side

SIDES = ("jax", "torch")
P1 = [1, 2, 3, 4, 5, 1, 2, 3, 4, 5, 1, 2]
P2 = [7, 8, 9, 7, 8, 9, 7, 8]
NEW = 12
# every HTTP call of the tests is bounded
HTTP_TIMEOUT = 30


class Fleet:
    """One package's fleet, engines and ops plane over the shared
    weights (a `Side` plus the fleet modules)."""

    def __init__(self, name):
        self.side = Side(name)
        self.jax = self.side.jax
        self.FL = JFL if self.jax else TFL
        self.ops = JOPS if self.jax else TOPS
        self.alerts = JAL if self.jax else TAL
        self.D = self.side.D

    def engine(self, **kw):
        kw.setdefault("max_batch_size", 2)
        kw.setdefault("max_seq_len", 96)
        kw.setdefault("page_size", 4)
        kw.setdefault("prefix_cache", True)
        return self.side.engine(**kw)

    def edge(self, **kw):
        edge = self.FL.EdgeServer(self.engine(**kw))
        return edge, edge.start()


def stop_all():
    """Stop both packages' ops servers, turn FLAGS_fleet_trace off and
    reset both packages' telemetry and request ids."""
    JOPS.stop_ops_server()
    TOPS.stop_ops_server()
    for name in SIDES:
        side = Side(name)
        side._flags.set_flags({"fleet_trace": False})
        side.reset()


def post(url, body, headers=None, timeout=HTTP_TIMEOUT):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def get(url, timeout=HTTP_TIMEOUT):
    return urllib.request.urlopen(url, timeout=timeout)


def drain_sse(resp):
    """(meta, tokens, done_event) off one generation stream, asserting
    contiguous token indexes."""
    ev = _sse_events(resp)
    meta = next(ev)
    toks, done = [], None
    for e in ev:
        if e.get("done"):
            done = e
            break
        assert e["i"] == meta.get("start_index", 0) + len(toks), e
        toks.append(int(e["t"]))
    return meta, toks, done
