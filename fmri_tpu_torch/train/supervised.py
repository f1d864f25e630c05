"""The generic supervised training and validation loops: the port's
counterpart of ``fmri_tpu/train/supervised.py``.

The reference's ``training_loop`` / ``validation_loop``
(``train/train_utils.py:474-675``) drive any (model, optimizer, loss) with a
``mode`` that routes batch fields to (inputs, targets):

  * ``'cogenc'`` / ``'decoder'``: fmri -> image;
  * ``'encoder'``: image -> fmri;
  * ``'vae'`` / ``'autoencoder'``: the batch is the input and the target.

:func:`make_supervised_step` gives a train step (forward in train mode, the
loss, its gradient, one update with the port's optimizers of
``train/optim.py``) and an eval step (running statistics); the state's one
group is ``model`` (:class:`SupervisedModel`). :func:`run_epoch` sums the
step's metrics on the device and moves them to the host once per epoch.
Batches are tensors on the model's device (``data/pipeline.py``'s
``device_iterator`` stages host batches there).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Tuple

import torch
from torch import nn

from fmri_tpu_torch.train.state import TrainState, _Groups, make_state

MODE_ROUTES = {
    "cogenc": ("fmri", "image"),
    "decoder": ("fmri", "image"),
    "encoder": ("image", "fmri"),
    "vae": (None, None),          # the batch is the input and the target
    "autoencoder": (None, None),
}


def route_batch(mode: str, batch) -> Tuple[Any, Any]:
    """(inputs, targets) of ``batch`` for ``mode`` (``train_utils.py:514-528``)."""
    try:
        in_key, gt_key = MODE_ROUTES[mode]
    except KeyError:
        raise ValueError(f"wrong mode in training loop: {mode!r}") from None
    if in_key is None:
        return batch, batch
    return batch[in_key], batch[gt_key]


class SupervisedModel(_Groups):
    """One group, ``model``: the module a supervised step trains."""

    PREFIXES = {"model": "model."}

    def __init__(self, module: nn.Module):
        super().__init__()
        self.model = module


def make_supervised_state(module: nn.Module, optimizer) -> TrainState:
    """A TrainState over ``module`` as group ``model`` with ``optimizer``'s
    fresh moments."""
    return make_state(SupervisedModel(module), {"model": optimizer})


def make_supervised_step(module: nn.Module, optimizer, loss_fn: Callable, mode: str,
                         lr_schedule: Callable | None = None):
    """(train_step, eval_step) of ``loss_fn(module(inputs), targets)``.
    ``train_step(state, batch) -> (state, {"loss", "lr"})`` updates the
    state's ``model`` group in place; ``eval_step(state, batch) -> (outputs,
    {"loss"})`` runs in eval mode. ``lr_schedule(step)`` defaults to 1e-3."""
    if mode not in MODE_ROUTES:
        raise ValueError(f"wrong mode in training loop: {mode!r}")
    if lr_schedule is None:
        lr_schedule = lambda step: torch.tensor(1e-3, device=step.device)  # noqa: E731

    def train_step(state: TrainState, batch):
        inputs, targets = route_batch(mode, batch)
        module.train()
        loss = loss_fn(module(inputs), targets)
        params = state.nets.group("model")
        # a parameter the loss does not reach gets a zero gradient, as in JAX
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                     materialize_grads=True)))
        lr = lr_schedule(state.step)
        optimizer.update(grads, state.opt_state["model"], params, lr, 1.0)
        state.step += 1
        return state, {"loss": loss.detach(), "lr": lr}

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        inputs, targets = route_batch(mode, batch)
        module.eval()
        out = module(inputs)
        return out, {"loss": loss_fn(out, targets)}

    return train_step, eval_step


def run_epoch(train_step, state: TrainState, batches: Iterable
              ) -> Tuple[TrainState, Dict[str, float]]:
    """One training epoch: the mean of each metric over the batches
    (``train_utils.py:474-578``), summed on the device, one transfer."""
    total: Dict[str, torch.Tensor] = {}
    nb = 0
    for batch in batches:
        state, m = train_step(state, batch)
        for k, v in m.items():
            total[k] = v if k not in total else total[k] + v
        nb += 1
    keys = sorted(total)
    sums = torch.stack([total[k].float() for k in keys]).tolist() if keys else []
    return state, {k: v / nb for k, v in zip(keys, sums)}


def run_validation(eval_step, state: TrainState, batches: Iterable) -> Dict[str, float]:
    """Mean validation loss (``validation_loop``, ``train_utils.py:581-675``)."""
    losses = [eval_step(state, batch)[1]["loss"] for batch in batches]
    if not losses:
        return {"loss": 0.0}
    return {"loss": float(torch.stack(losses).float().sum()) / len(losses)}
