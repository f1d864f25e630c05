"""The port's training: optimizers, train states, the steps of both families,
the :class:`Trainer`, the stage builders (``BUILDERS``) and the
``python -m fmri_tpu_torch.train.run`` CLI.

The exports of ``fmri_tpu/train/__init__.py`` resolve on first use, so that
importing one submodule (the checkpoint store imports ``train.optim``)
does not import the trainer and the builders with it.
"""

import importlib

_EXPORTS = {
    "Adam": "optim", "RmsProp": "optim", "exponential_lr": "optim", "step_lr": "optim",
    "TrainState": "state", "init_cognitive": "state", "init_vaegan": "state",
    "init_wae": "state", "init_wae_cognitive": "state", "init_wae_dual_gan": "state",
    "make_state": "state",
    "StepFns": "steps_vgan", "make_vgan_cognitive_step": "steps_vgan",
    "make_vgan_stage1_step": "steps_vgan",
    "make_wae_cognitive_step": "steps_wae", "make_wae_stage1_step": "steps_wae",
    "make_wae_vgan_step": "steps_wae",
    "Draws": "trainer", "EarlyStopping": "trainer", "GameSchedules": "trainer",
    "Trainer": "trainer",
    "BUILDERS": "stages",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
