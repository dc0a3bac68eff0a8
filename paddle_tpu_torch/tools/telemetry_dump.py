"""Telemetry dump: run a small `DecodeEngine` workload of the port and
export every observability format (counterpart: tools/telemetry_dump.py
of the JAX package, copied and adapted, not imported).

Builds a small random GPT, serves a couple of requests through the
port's paged decode engine (optionally speculative), and writes

* ``telemetry.prom``        — Prometheus text exposition;
* ``telemetry.json``        — structured snapshot;
* ``telemetry_trace.json``  — merged chrome-trace timeline (engine step
  spans + request spans, one named track each; the host track holds
  the eager profiler's events, if it ran);
* ``telemetry_flight.json`` — the flight-recorder window (what
  `paddle_tpu_torch.tools.explain_request` reads);
* ``telemetry_statusz.json`` / ``telemetry_statusz.txt`` — the live
  `DecodeEngine.statusz()` snapshot in its JSON and text forms;
* ``telemetry_cost.json``    — the cost observatory's section;
* ``telemetry_profile.json`` — the profiling plane (with ``--profile``).

With ``--url http://host:port`` it PULLS the same files from a live ops
server (``FLAGS_ops_port``) instead of serving a local workload.  The
workload runs on the CUDA card unless ``--device cpu`` asks for the
CPU.

Usage:
    python -m paddle_tpu_torch.tools.telemetry_dump [--outdir DIR]
        [--batch 2] [--context 24] [--new-tokens 8] [--spec-k 0]
        [--seed 0] [--profile] [--device cpu]
    python -m paddle_tpu_torch.tools.telemetry_dump --url http://host:port
"""
import argparse
import json
import os
import sys


def dump_from_url(url: str, outdir: str, engine=None) -> int:
    """Pull /metrics, /statusz and /flightz from a live ops server and
    write the in-process dump's artifact files.  ``engine`` selects
    one engine on a multi-engine process (without it a multi-engine
    /statusz answers the ``{"engines": {...}}`` map form instead of
    the single-engine dict the in-process path writes)."""
    from urllib.error import HTTPError
    from urllib.request import urlopen

    def get(path: str, **params) -> str:
        if engine is not None:
            params["engine"] = engine
        if params:
            path += "?" + "&".join(f"{k}={v}"
                                   for k, v in params.items())
        with urlopen(url.rstrip("/") + path, timeout=10) as r:
            return r.read().decode("utf-8")

    os.makedirs(outdir, exist_ok=True)
    wrote = []
    with open(os.path.join(outdir, "telemetry.prom"), "w") as f:
        f.write(get("/metrics"))
    wrote.append("telemetry.prom")
    statusz = get("/statusz")
    json.loads(statusz)  # a torn/error payload must fail loudly HERE
    with open(os.path.join(outdir, "telemetry_statusz.json"), "w") as f:
        f.write(statusz)
    with open(os.path.join(outdir, "telemetry_statusz.txt"), "w") as f:
        f.write(get("/statusz", format="text"))
    wrote += ["telemetry_statusz.json", "telemetry_statusz.txt"]
    try:
        flight = get("/flightz")
        json.loads(flight)
        with open(os.path.join(outdir, "telemetry_flight.json"),
                  "w") as f:
            f.write(flight)
        wrote.append("telemetry_flight.json")
    except HTTPError as e:
        # tolerate EXACTLY the documented case — flight recorder
        # disabled on the remote engine (404); a dead server or any
        # other error must fail the pull, not silently drop the
        # crash-post-mortem artifact
        if e.code != 404:
            raise
    try:
        prof = get("/profilez")
        json.loads(prof)
        with open(os.path.join(outdir, "telemetry_profile.json"),
                  "w") as f:
            f.write(prof)
        wrote.append("telemetry_profile.json")
    except HTTPError as e:
        # same contract as /flightz: 404 = profiling plane disarmed
        # (FLAGS_profile=0) — the one documented absence; anything
        # else fails the pull
        if e.code != 404:
            raise
    for name in wrote:
        print(f"wrote {os.path.join(outdir, name)} (from {url})")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="telemetry_out")
    ap.add_argument("--url", default=None,
                    help="pull from a live ops server "
                         "(http://host:port) instead of serving a "
                         "local workload")
    ap.add_argument("--engine", default=None,
                    help="pull mode: engine id to select on a "
                         "multi-engine process (default: the "
                         "server's single-engine form)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--context", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative draft length (0 = classic decode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="arm the profiling plane, one probe a step")
    ap.add_argument("--device", default=None,
                    help="cpu for the plain PyTorch path (default: the "
                         "CUDA card)")
    args = ap.parse_args()

    if args.url:
        # pull mode: no model — just HTTP + files
        return dump_from_url(args.url, args.outdir,
                             engine=args.engine)

    # the heavy imports live here so pull mode starts in milliseconds
    import numpy as np

    from paddle_tpu_torch import observability, profiler
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig

    cfg = GPTConfig(vocab_size=args.vocab, hidden_size=args.hidden,
                    num_layers=args.layers, num_heads=args.heads,
                    max_seq_len=args.context + args.new_tokens + 32,
                    use_parallel_layers=False, dropout=0.0)
    model = GPT.random(cfg, seed=args.seed, device=args.device)

    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, args.vocab, (args.context,)).astype(np.int32)
               for _ in range(args.batch)]

    # fresh slate so the dump describes exactly this workload
    observability.reset()
    observability.clear_spans()
    profiler.reset_decode_stats()

    kw = {"spec_decode_k": args.spec_k} if args.spec_k else {}
    if args.profile:
        kw.update(profile=True, profile_sample_steps=1)
    eng = DecodeEngine(model, max_batch_size=args.batch,
                       max_seq_len=args.context + args.new_tokens,
                       page_size=args.page_size, seed=args.seed,
                       device=args.device, **kw)
    outs = eng.generate(prompts, max_new_tokens=args.new_tokens)

    os.makedirs(args.outdir, exist_ok=True)
    prom_path = os.path.join(args.outdir, "telemetry.prom")
    json_path = os.path.join(args.outdir, "telemetry.json")
    trace_path = os.path.join(args.outdir, "telemetry_trace.json")
    flight_path = os.path.join(args.outdir, "telemetry_flight.json")
    statusz_path = os.path.join(args.outdir, "telemetry_statusz.json")
    statusz_txt = os.path.join(args.outdir, "telemetry_statusz.txt")
    cost_path = os.path.join(args.outdir, "telemetry_cost.json")
    profile_path = os.path.join(args.outdir, "telemetry_profile.json")

    with open(prom_path, "w") as f:
        f.write(observability.prometheus_text())
    with open(json_path, "w") as f:
        json.dump({"workload": {"batch": args.batch,
                                "context": args.context,
                                "new_tokens": args.new_tokens,
                                "spec_k": args.spec_k,
                                "tokens_out": sum(len(o) for o in outs)},
                   "metrics": observability.snapshot()}, f, indent=2)
    trace = observability.export_chrome_trace(trace_path)
    # the flight window + statusz: the black-box and live-state halves
    # of the same serve (explain_request.py reads the flight file)
    if eng._flight is not None:
        eng._flight.dump(reason="manual", path=flight_path)
    with open(statusz_path, "w") as f:
        json.dump(eng.statusz(), f, indent=2)
    with open(statusz_txt, "w") as f:
        f.write(eng.statusz_text() + "\n")
    if eng._cost is not None:
        with open(cost_path, "w") as f:
            json.dump(eng._cost.statusz(), f, indent=2)
    if eng._profiling is not None:
        with open(profile_path, "w") as f:
            json.dump(eng._profiling.statusz(), f, indent=2)

    tracks = sorted(e["args"]["name"] for e in trace["traceEvents"]
                    if e.get("ph") == "M" and e.get("name") == "process_name")
    print(f"wrote {prom_path}")
    print(f"wrote {json_path}")
    print(f"wrote {trace_path} (tracks: {', '.join(tracks)})")
    if eng._flight is not None:
        print(f"wrote {flight_path} "
              f"({len(eng._flight.records())} records)")
    print(f"wrote {statusz_path}")
    print(f"wrote {statusz_txt}")
    if eng._cost is not None:
        print(f"wrote {cost_path}")
    if eng._profiling is not None:
        print(f"wrote {profile_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
