"""``paddle.Model``, the high-level API (counterpart:
paddle_tpu/hapi/model.py).

`prepare` takes the optimizer, the loss and the metrics; `train_batch`
runs one `jit.TrainStep` (forward, backward and the optimizer's staged
update, as the JAX package's fused step), `fit` loops over a dataset or
loader with the callbacks, `evaluate` and `predict` run without grad.
Batches go to the device of the network's parameters.
``amp_configs`` ("O1", or a dict with ``dtype``) runs the forward under
`amp.auto_cast` and the loss outside it (the JAX package takes the
argument and ignores it).  ``save(training=False)`` is export, which
comes with a later slice.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from .. import amp
from ..core import flags
from ..metric import Metric
from . import callbacks as cbks

__all__ = ["Model"]


def _amp_dtype(amp_configs):
    """The autocast dtype ``amp_configs`` asks for, or None."""
    if amp_configs is None:
        return None
    if isinstance(amp_configs, str):
        if amp_configs not in ("O1", "O2"):
            raise ValueError(f"amp_configs level must be 'O1' or 'O2', got "
                             f"{amp_configs!r}")
        return str(flags.flag("amp_dtype"))
    return str(amp_configs.get("dtype", flags.flag("amp_dtype")))


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._optimizer = None
        self._metrics: List[Metric] = []
        self._amp_dtype = None
        self._train_step = None
        self.stop_training = False

    def _device(self):
        p = next(self.network.parameters(), None)
        return p.device if p is not None else None

    # -- setup --------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, Metric):
            self._metrics = [metrics]
        else:
            self._metrics = list(metrics)
        if optimizer is not None and optimizer._parameters is None:
            optimizer._parameters = list(self.network.parameters())
        self._amp_dtype = _amp_dtype(amp_configs)
        self._train_step = None  # rebuilt lazily

    def _forward(self, net, xs):
        if self._amp_dtype is None:
            return net(*xs)
        with amp.auto_cast(enable=True, dtype=self._amp_dtype):
            return net(*xs)

    def _loss_fn(self, net, *batch):
        *xs, y = batch
        loss = self._loss(self._forward(net, xs), y)
        if isinstance(loss, (list, tuple)):
            loss = sum(loss)
        return loss

    def _ensure_train_step(self):
        if self._train_step is None:
            from ..jit import TrainStep

            self._train_step = TrainStep(self.network, self._loss_fn,
                                         self._optimizer)

    def _on_device(self, xs):
        dev = self._device()
        xs = xs if isinstance(xs, (list, tuple)) else [xs]
        return [x.to(dev) if isinstance(x, torch.Tensor) else
                torch.as_tensor(np.asarray(x), device=dev) for x in xs]

    # -- single batches -----------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        self._ensure_train_step()
        batch = self._on_device(inputs) + self._on_device(labels)
        return [float(self._train_step(*batch))]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs, labels = self._on_device(inputs), self._on_device(labels)
        with torch.no_grad():
            out = self._forward(self.network, inputs)
            loss = self._loss(out, labels[0]) if self._loss else None
        metrics = []
        for m in self._metrics:
            m.update(m.compute(out, labels[0]))
            metrics.append(m.accumulate())
        return ([float(loss)] if loss is not None else []), metrics

    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            return self._forward(self.network, self._on_device(inputs))

    # -- loops --------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle=False, drop_last=False,
                num_workers=0):
        from ..io import DataLoader, Dataset

        if isinstance(data, Dataset):
            return DataLoader(data, places=self._device(),
                              batch_size=batch_size, shuffle=shuffle,
                              drop_last=drop_last, num_workers=num_workers)
        return data

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Train ``epochs`` passes over ``train_data`` (a Dataset, batched
        here, or any iterable of batches), the last element of each batch
        the label; ``callbacks`` after the progress logger and the
        LR-scheduler stepper (and ``ModelCheckpoint`` with ``save_dir``).
        Returns self."""
        train_loader = self._loader(train_data, batch_size, shuffle,
                                    drop_last, num_workers)
        eval_loader = self._loader(eval_data, batch_size,
                                   num_workers=num_workers) \
            if eval_data is not None else None
        cb_list = [cbks.ProgBarLogger(log_freq, verbose=verbose),
                   cbks.LRScheduler()]
        if save_dir:
            cb_list.append(cbks.ModelCheckpoint(save_freq, save_dir))
        cb_list += list(callbacks or [])
        cbs = cbks.CallbackList(cb_list)
        cbs.set_model(self)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbs.set_params({"epochs": epochs, "steps": steps, "verbose": verbose})

        self.stop_training = False
        cbs.on_train_begin()
        it_count = 0
        logs = {}
        for epoch in range(epochs):
            cbs.on_epoch_begin(epoch)
            logs = {}
            for step, batch in enumerate(train_loader):
                cbs.on_train_batch_begin(step)
                ins, labs = self._split_batch(batch)
                logs = {"loss": self.train_batch(ins, labs)[0]}
                cbs.on_train_batch_end(step, logs)
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
                cbs.on_eval_end(logs={k.replace("eval_", ""): v
                                      for k, v in logs.items()})
            cbs.on_epoch_end(epoch, logs)
            if self.stop_training or (num_iters is not None
                                      and it_count >= num_iters):
                break
        cbs.on_train_end(logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """``{"loss": mean of the batches' losses, <metric>: value}``."""
        loader = self._loader(eval_data, batch_size, num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            ins, labs = self._split_batch(batch)
            loss, _ = self.eval_batch(ins, labs)
            if loss:
                losses.append(loss[0])
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            names, vals = m.name(), m.accumulate()
            if isinstance(names, str):
                names, vals = [names], [vals]
            elif not isinstance(vals, (list, tuple)):
                vals = [vals]
            logs.update(zip(names, vals))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """``[outputs]``: each batch's output as a numpy array (stacked
        into one with ``stack_outputs``)."""
        loader = self._loader(test_data, batch_size, num_workers=num_workers)
        outputs = []
        for batch in loader:
            ins = batch[0] if isinstance(batch, (list, tuple)) else batch
            out = self.predict_batch([ins])
            outputs.append(out.detach().float().cpu().numpy()
                           if isinstance(out, torch.Tensor) else out)
        if stack_outputs:
            return [np.concatenate(outputs)]
        return [outputs]

    def _split_batch(self, batch):
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            return list(batch[:-1]), [batch[-1]]
        return [batch], []

    # -- persistence --------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (the network's ``state_dict``) and
        ``path.pdopt`` (the optimizer's)."""
        from ..framework.io import save as fsave

        if not training:
            raise NotImplementedError(
                "Model.save(training=False) exports an inference program "
                "(jit.save), which lands with the export slice of "
                "paddle_tpu_torch")
        fsave(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as fload

        dev = self._device()
        self.network.set_state_dict(fload(path + ".pdparams", device=dev))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(fload(path + ".pdopt",
                                                 device=dev))
        self._train_step = None

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters())

    def summary(self, input_size=None, dtype=None):
        from .summary import summary

        return summary(self.network, input_size, dtype)
