"""One run of a hybrid-parallel rank job a test session.

`shared_run` starts ``nprocs`` gloo ranks of a `tests/torch_hybrid_runner`
function once, however the tests that read its results are spread over
pytest-xdist workers: the first worker to ask takes a file lock in the
session's shared temporary directory, writes the job's inputs
(``prepare(out)``), runs it and marks it done; the others wait on the
lock and read the same results.
"""
import fcntl
import os
import pickle


def shared_run(tmp_path_factory, name, fn, nprocs, prepare):
    from paddle_tpu_torch import distributed as TD

    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = (tmp_path_factory.getbasetemp().parent / f"torch_hybrid_{uid}"
            if uid else tmp_path_factory.getbasetemp() / "torch_hybrid")
    base.mkdir(parents=True, exist_ok=True)
    out = str(base / name)
    with open(base / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (base / f"{name}.done").exists():
            prepare(out)
            saved = {k: os.environ.get(k) for k in ("PADDLE_DEVICE",
                                                     "OMP_NUM_THREADS")}
            os.environ.update(PADDLE_DEVICE="cpu", OMP_NUM_THREADS="1")
            try:
                TD.spawn(fn, args=(out,), nprocs=nprocs)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            (base / f"{name}.done").write_text("done")
    results = []
    for r in range(nprocs):
        with open(f"{out}.{r}", "rb") as f:
            results.append(pickle.load(f))
    return results
