"""One fleet replica process for tests/test_torch_fleet.py's chaos test:
a seeded tiny port GPT on the CPU behind an `EdgeServer`, with its ops
server and a journal (``fsync=always``), each on an ephemeral port.

    python tests/torch_fleet_child.py --name r0 --dir JOURNALS --seed 0

prints ``FLEET_CHILD name=<name> edge=<port> ops=<port>`` once serving,
then serves until it is killed or its standard input closes (the parent
went away)."""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.core import flags  # noqa: E402
from paddle_tpu_torch.fleet import EdgeServer  # noqa: E402
from paddle_tpu_torch.inference.serving import DecodeEngine  # noqa: E402
from paddle_tpu_torch.models.gpt import GPT, GPTConfig  # noqa: E402
from paddle_tpu_torch.observability import opsserver  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--name", required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--config", required=True,
                    help="JSON: the GPTConfig and the engine's keywords")
    ap.add_argument("--fault-plan", default="")
    args = ap.parse_args()
    cfg = json.loads(args.config)
    flags.set_flags({"journal_fsync": "always",
                     "fleet_trace": bool(cfg.get("fleet_trace"))})
    model = GPT.random(GPTConfig(**cfg["gpt"]), seed=args.seed,
                       device="cpu")
    eng = DecodeEngine(model, device="cpu",
                       journal_dir=os.path.join(args.dir, args.name),
                       fault_plan=args.fault_plan or None, **cfg["engine"])
    ops = opsserver.start_ops_server(port=0, host="127.0.0.1")
    edge = EdgeServer(eng)
    port = edge.start()
    print(f"FLEET_CHILD name={args.name} edge={port} ops={ops}", flush=True)
    # serve until killed, or until the parent closes our standard input
    sys.stdin.read()
    os._exit(0)


if __name__ == "__main__":
    main()
