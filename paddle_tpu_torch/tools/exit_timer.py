"""Run a command and time its exit: how long the process lives after the
last line it prints.

    python -m paddle_tpu_torch.tools.exit_timer [--limit S] -- CMD [ARG...]

The command's output passes through unchanged (standard error merged into
standard output).  At its end one JSON line follows: the exit code, the
wall seconds, and ``exit_s``, the seconds from its last line of output to
the end of the process (a process that hangs in its exit handlers, as a
NCCL communicator left open can make it, shows it here).  With
``--limit``, the command is killed after S seconds (``"killed": true``,
exit code 124).
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time


def run(cmd, limit=None):
    t0 = time.monotonic()
    last = [t0]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1)

    def pump():
        for line in proc.stdout:
            last[0] = time.monotonic()
            sys.stdout.write(line)
            sys.stdout.flush()

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    killed = False
    try:
        rc = proc.wait(timeout=limit)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc, killed = 124, True
        proc.wait()
    end = time.monotonic()
    reader.join(timeout=5)
    return dict(rc=rc, wall_s=end - t0, exit_s=end - last[0], killed=killed)


def main(argv) -> int:
    limit = None
    if argv[:1] == ["--limit"]:
        limit, argv = float(argv[1]), argv[2:]
    if argv[:1] != ["--"] or len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    res = run(argv[1:], limit)
    print(json.dumps({"exit_timer": res}), flush=True)
    return res["rc"]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
