"""Named spans of the program's phases in a ``torch.profiler`` trace.

``with span("train.forward"): ...`` marks the block as
``fmri.train.forward`` in the profiler's Chrome trace, beside the kernels
and CUDA runtime calls it caused and on the same clock; its parent is the
span that encloses it on that thread. There is no switch of its own: while
no profiler runs, ``span`` returns one shared no-op context and records
nothing.

The guard is the flag ``torch.profiler`` sets for the process while it
runs, not the thread-local ``torch._C._autograd._profiler_enabled()``: the
latter reads False on a thread other than the profiler's even when the
profiler records every thread, which would hide the input producer's span.
Either costs a fraction of a microsecond; an unguarded ``record_function``
costs microseconds with the profiler off.

Spans (the readers of each: ``portbench/metrics/``, and the "by program
span" table of ``utils/profile_report.py``):

* ``train.step``, each train step's body; inside it ``train.forward``,
  ``train.backward`` (the spliced backward's segments as
  ``train.backward.discriminator``, ``.decoder``, ``.encoder``),
  ``train.gate`` (the gradients' reduction, the head sums, the
  equilibrium gate and the learning rate) and ``train.optimizer`` (one
  ``train.optimizer.<group>`` per trained group); the WAE steps' phase 1,
  ``train.latent_disc`` (the latent discriminator's forwards, gradient and
  its update, ``train.optimizer.latent_disc``). In the WAE/Dual-GAN step
  phase 1 runs inside ``train.forward`` (``stage1_grads`` calls it from
  the encoder's forward), so there the forward's host time and the
  optimizer's both count the latent D's update;
* ``input.stage``, a batch's copy to the device (``data/pipeline.py``);
* ``input.augment``, the train-time augmentation (``data/transforms.py``).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

PREFIX = "fmri."
OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``fmri.<name>`` while a profiler runs, else
    the shared no-op :data:`OFF`."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return OFF
