"""Does a process that served over an NCCL mesh exit?  (Run on four
cards; not collected by pytest.)

    python -m paddle_tpu_torch.tools.exit_timer --limit 170 -- \\
        python3 tests/torch_mesh_exit.py keep|drop|eager

GPT-2-small (`tools.serve_profile.gpt2_small_serve`) serves 4 prompts 8
tokens through a ragged engine at ``serve_mesh="mp=2"`` and then
``"mp=4"`` (NCCL: a card a rank), then the script ends: ``keep`` with
both engines, and their captured CUDA graphs, alive; ``drop`` after
deleting them and collecting; ``eager`` after serving without capture.
`exit_timer`'s ``exit_s`` is how long the process lives after its last
line (the mesh's exit handler tears the communicators down).
"""
import gc
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from paddle_tpu_torch.inference import serving  # noqa: E402
from paddle_tpu_torch.tools import serve_profile  # noqa: E402


def main(variant):
    model, prompts, new_engine = serve_profile.gpt2_small_serve(
        "cuda", ragged_step=True)
    keep = []
    for spec in ("mp=2", "mp=4"):
        eng = new_engine(serve_mesh=spec)
        if variant == "eager":
            with serving.disable_capture():
                eng.generate(prompts[:4], 8)
        else:
            eng.generate(prompts[:4], 8)
        keep.append(eng)
        print(variant, spec, "served", flush=True)
    if variant == "drop":
        keep.clear()
        del eng
        gc.collect()
        torch.cuda.synchronize()
        print("dropped engines", flush=True)
    print("END", variant, flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
