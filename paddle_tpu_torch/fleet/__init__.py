"""Fleet serving: the network front door over N engine replicas
(counterpart: paddle_tpu/fleet, copied and adapted, not imported).

Everything below the fleet layer lives in one engine's process —
content-addressed prefix pages, the write-ahead journal, `/readyz`
as an admission key, calibrated step-cost headroom — but nothing
polled them from OUTSIDE the process.  This package is that consumer,
in two halves:

* `fleet.edge.EdgeServer` — a real HTTP edge on one replica: a stdlib
  daemon-thread server (the `observability.opsserver` pattern) that
  wraps the engine in a `ServingFrontend`, accepts generation requests
  over ``POST /v1/generate`` and streams tokens back as Server-Sent
  Events, serves the failover surfaces (``/v1/adopt`` replays a dead
  sibling's journal into this replica, ``/v1/resume`` reconnects a
  migrated stream), and describes itself on ``GET /v1/info``;

* `fleet.router.FleetRouter` — the fleet brain: routes each request by
  **prefix affinity** (the prefix cache's chain hashes of the longest
  page-aligned prompt prefix are the routing key, so requests sharing
  a prefix land on the replica already holding those KV pages), admits
  by the ops plane's ``/readyz`` verdict + capacity headroom +
  predicted step cost rather than a raw slot count, and on replica
  death performs **zero-loss failover**: the dead replica's journal
  replays into a survivor (`durability.adopt_from_dir`) and every
  interrupted SSE stream resumes mid-generation, token-for-token.

`chip_smoke.py`'s fleet phase (``--fleet``) drives both on the card:
the affinity win over round robin, and a kill -9 of a replica with
zero loss and token-for-token continuity.
"""
from .edge import EdgeServer
from .router import (FleetConfigError, FleetRouter, FleetStream,
                     ReplicaHandle)

__all__ = ["EdgeServer", "FleetRouter", "FleetStream", "ReplicaHandle",
           "FleetConfigError"]
