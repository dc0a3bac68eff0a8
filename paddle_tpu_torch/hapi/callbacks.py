"""hapi callbacks (counterpart: paddle_tpu/hapi/callbacks.py).

Host-side Python copied from the JAX package: the base, the list that
fans calls out, the progress logger, checkpoints, early stopping, the
LR-scheduler stepper and `VisualDL`, which writes JSONL (one line a
train batch) as the JAX package's does.
"""
from __future__ import annotations

import numbers
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)

            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            logs = logs or {}
            msg = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, numbers.Number) else f"{k}: {v}"
                for k, v in logs.items()
            )
            print(f"step {step}/{self.steps or '?'} - {msg}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            logs = logs or {}
            msg = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, numbers.Number) else f"{k}: {v}"
                for k, v in logs.items()
            )
            print(f"Epoch {epoch + 1} done in {dt:.1f}s - {msg}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            import os

            self.model.save(os.path.join(self.save_dir, f"epoch_{epoch}"))

    def on_train_end(self, logs=None):
        if self.save_dir:
            import os

            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.better = lambda cur, best: cur > best + self.min_delta
            self.best = -float("inf")
        else:
            self.better = lambda cur, best: cur < best - self.min_delta
            self.best = float("inf")

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self.better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None) if opt else None
        from ..optimizer.lr import LRScheduler as Sched

        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s and self.by_epoch:
            s.step()


class VisualDL(Callback):
    """Metric logging callback; writes JSONL (VisualDL itself is not
    available in this environment)."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def on_train_batch_end(self, step, logs=None):
        import json
        import os

        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "train.jsonl"), "a") as f:
            f.write(json.dumps({"step": step, **{k: float(v) if isinstance(v, numbers.Number) else str(v) for k, v in (logs or {}).items()}}) + "\n")
