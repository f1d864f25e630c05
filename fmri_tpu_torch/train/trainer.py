"""The training loop that drives every stage of every family.

Counterpart of ``fmri_tpu/train/trainer.py``. One :class:`Trainer` runs a
stage's step through epochs (``train/stages.py`` builds the state, the
steps and the trainer's keywords per stage):

* host batches shuffled per epoch (``data/pipeline.py``), staged onto the
  device ahead of the step, or with ``on_device=True`` gathered from the
  device-resident dataset (``train/epoch_scan.py``);
* the train-time augmentation on the device (flip for stage-I images,
  shift for stage-II/III pairs, then normalize);
* the equilibrium-game scalars of the VAE/GAN family, decayed per epoch by
  :class:`GameSchedules` and put on the device once per epoch;
* metrics summed on the device with no host sync in the batch loop, moved
  to the host in one transfer per epoch;
* validation and train-batch metrics (PCC, SSIM, MSE; SSIM through the
  port's kernel on the card), image grids, ``results.csv``, TensorBoard,
  the NaN guard and patience, checkpoints on a cadence (optionally written
  by a background thread and pruned) and a final one;
* ``profile``: a ``torch.profiler`` trace of the second epoch of the run,
  summarized by ``python -m fmri_tpu_torch.utils.profile_report``: kernels
  by device time, the idle share, and a table by program span (the
  step's phases and the input path, ``utils/spans.py``: host ms, kernels
  launched, blocking syncs and device idle ms in each);
* cuDNN's deterministic algorithms (``device.deterministic_cudnn``) inside
  ``fit`` and ``evaluate_batches``, so a seed gives one run and a resumed
  run equals the uninterrupted one, as in the JAX trainer;
* ``mesh`` (``parallel/mesh.py``): every rank runs ``fit`` on its rows of
  each global batch (the same permutation and draws everywhere, each rank
  taking its rows), with the state placed by ``shard_state`` (``voxel_tp``
  for the cognitive encoder's ``fc1``). Validation evaluates each rank's
  rows and gathers the reconstructions for MSE, PCC and the grids, and sums
  the per-rank SSIM, so every rank holds the same metrics; the stop
  decisions are rank 0's, broadcast; rank 0 alone writes ``results.csv``,
  TensorBoard, the grids, the log and the checkpoints. A D-way run equals
  the single-process run of the same seed, as the JAX mesh run equals its
  single-device run.

Randomness comes from a draws object (:class:`Draws` by default) asked per
(epoch, batch) for the flip mask, the shifts and the step's noise, and per
evaluation pass for the eval eps and the generated panel's z_p. The JAX
trainer derives the same quantities from one key (``fold_in(key(seed),
epoch)``, then ``fold_in(., batch)`` split into augment and step keys;
``0x7FFFFFFF``/``0x7FFFFFFE`` for the two eval passes), which the tests
replay through this interface.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Any, Callable, Dict, Iterable, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from fmri_tpu_torch.checkpoints.store import (
    AsyncCheckpointWriter, prune_checkpoints, restore_checkpoint, save_checkpoint,
)
from fmri_tpu_torch.configs.presets import Config
from fmri_tpu_torch.data.pipeline import Batches, device_iterator, num_examples, to_device
from fmri_tpu_torch.data.transforms import denormalize, train_augment
from fmri_tpu_torch.device import deterministic_cudnn
from fmri_tpu_torch.metrics.quality import mse, pearson_correlation, ssim
from fmri_tpu_torch.parallel.mesh import check_batch, shard_state
from fmri_tpu_torch.train.epoch_scan import device_epoch, epoch_permutation
from fmri_tpu_torch.train.state import TrainState
from fmri_tpu_torch.utils.runlog import (
    ResultsCSV, TensorBoard, dump_config, save_image_grid, save_loss_plots, setup_logging,
)

# the eval passes' streams, the JAX trainer's fold_in constants (:362, :370)
VALID_STREAM, TRAIN_METRICS_STREAM = 0x7FFFFFFF, 0x7FFFFFFE


class EarlyStopping:
    """Patience-based stopper with a NaN stop (reference ``EarlyStopping``,
    ``train_utils.py:17-69``; ``patience=0`` disables it)."""

    def __init__(self, patience: int = 0, mode: str = "max"):
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def update(self, value: float) -> bool:
        """True when training should stop."""
        if math.isnan(value):
            return True
        if self.patience == 0:
            return False
        better = (self.best is None or
                  (value > self.best if self.mode == "max" else value < self.best))
        if better:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs > self.patience


class GameSchedules:
    """Per-epoch decay of the equilibrium game scalars
    (``train_vgan_stage1.py:451-458``): margin and equilibrium times their
    decays, ``equilibrium = max(equilibrium, margin)``, ``lambda_mse``
    capped at 1. Python floats; :meth:`args` puts them on the device."""

    def __init__(self, cfg: Config):
        t = cfg.train
        self.margin = t.margin
        self.equilibrium = t.equilibrium
        self.lambda_mse = t.lambda_mse
        self._dm, self._de, self._dl = t.decay_margin, t.decay_equilibrium, t.decay_mse

    def epoch_end(self) -> None:
        self.margin *= self._dm
        self.equilibrium *= self._de
        if self.margin > self.equilibrium:
            self.equilibrium = self.margin
        self.lambda_mse *= self._dl
        if self.lambda_mse > 1.0:
            self.lambda_mse = 1.0

    def args(self, device: torch.device) -> tuple:
        """(margin, equilibrium, lambda_mse) as float32 scalars on ``device``."""
        return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                     for v in (self.margin, self.equilibrium, self.lambda_mse))


class DrawSpec(NamedTuple):
    """What one train step draws: ``batch`` rows, a flip mask if ``flip``,
    shifts in [-max_shift, max_shift] if ``max_shift``, and each noise
    tensor of ``noise``, ((name, scale), ...) in the JAX step's split order,
    [batch, latent] standard normals times the scale."""
    batch: int
    latent: int
    flip: bool
    max_shift: int
    noise: Sequence
    device: torch.device


def _generator(device: torch.device, *words: int) -> torch.Generator:
    seed = int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(seed)


class _EvalDraws:
    def __init__(self, gen: torch.Generator, device: torch.device):
        self.gen, self.device = gen, device

    def eps(self, n: int, latent: int) -> torch.Tensor:
        return torch.randn((n, latent), generator=self.gen, device=self.device)

    z_p = eps


class Draws:
    """The default draws: ``torch.Generator``s on the device, one per epoch
    for the train steps (flip, shifts, noise in that order per batch) and
    one per (epoch, eval stream), seeded from (seed, epoch[, stream]), so a
    run resumed at an epoch draws what the uninterrupted run drew."""

    def __init__(self, seed: int):
        self.seed = seed
        self._epoch: Optional[tuple] = None

    def train(self, epoch: int, index: int, spec: DrawSpec):
        """(flip mask or None, shifts or None, {name: noise}) of batch
        ``index``; batches are drawn in order within an epoch."""
        if self._epoch is None or self._epoch[0] != epoch or index == 0:
            self._epoch = (epoch, _generator(spec.device, self.seed, epoch, 0))
        gen, dev = self._epoch[1], spec.device
        flip = (torch.rand(spec.batch, generator=gen, device=dev) < 0.5
                if spec.flip else None)
        shifts = (torch.randint(-spec.max_shift, spec.max_shift + 1, (spec.batch, 2),
                                generator=gen, device=dev) if spec.max_shift else None)
        noise = {name: scale * torch.randn((spec.batch, spec.latent), generator=gen, device=dev)
                 for name, scale in spec.noise}
        return flip, shifts, noise

    def eval(self, epoch: int, stream: int, device: torch.device) -> _EvalDraws:
        """The draws of one evaluation pass: ``eps(n, latent)`` per batch,
        then ``z_p(n, latent)`` for the generated panel."""
        return _EvalDraws(_generator(device, self.seed, epoch, stream), device)


def _device_of(state: TrainState) -> torch.device:
    return next(state.nets.parameters()).device


class Trainer:
    """Drives a stage's steps through epochs with eval, logging and
    checkpoints.

    Args:
      cfg: the full config.
      steps: ``StepFns`` of the stage's adapter (``train/stages.py``):
        ``train_step(state, batch, noise, *gate)``, ``eval_step(state,
        input, eps)``, ``generate_step(state, z_p)``.
      run_dir: the artifact directory (``utils/runlog.py``).
      data_kind: 'image' (stage I) or 'pair' ({'fmri', 'image'}).
      uses_gate: the step takes (margin, equilibrium, lambda_mse).
      noise: ((name, scale), ...), the noise the step takes.
      augment: dict(flip=, max_shift=) of the train-time augmentation.
      eval_sample: reparameterize at eval (the VAE/GAN families sample in
        eval, ``vae_gan.py:288-297``; WAE decodes the mean).
      mesh: a ``parallel.mesh.Mesh``, this rank's place in a multi-rank
        run (the batch size must split over its data axis); voxel_tp: shard
        the cognitive encoder's ``fc1`` over its model axis.
      draws: where the randomness comes from (default :class:`Draws` of
        the fit's seed).
    """

    def __init__(self, cfg: Config, steps, run_dir: str, *,
                 data_kind: str = "image", uses_gate: bool = True,
                 noise: Sequence = (), augment: Optional[Mapping[str, Any]] = None,
                 eval_sample: bool = True, mesh=None, voxel_tp: bool = False,
                 debug: bool = False, tensorboard: bool = True,
                 profile: bool = False, async_ckpt: bool = False,
                 ckpt_retention: Optional[Mapping[str, Any]] = None, draws=None):
        if mesh is not None:
            check_batch(cfg.train.batch_size, mesh.data)
        self.mesh, self.voxel_tp = mesh, voxel_tp
        self._writes = mesh is None or mesh.is_writer
        self.cfg = cfg
        self.steps = steps
        self.run_dir = run_dir
        self.data_kind = data_kind
        self.uses_gate = uses_gate
        self.noise = tuple(noise)
        self.eval_sample = eval_sample
        self.debug = debug
        self.profile = profile
        self.draws = draws
        if self._writes:
            self.logger = setup_logging(run_dir)
        else:
            # the other ranks log nowhere: rank 0's log is the run's
            self.logger = logging.getLogger(f"fmri_tpu_torch.train.{run_dir}.rank{mesh.rank}")
            self.logger.propagate = False
            if not self.logger.handlers:
                self.logger.addHandler(logging.NullHandler())
        self.results = ResultsCSV(os.path.join(run_dir, "results.csv") if self._writes
                                  else None)
        self.tb = TensorBoard(run_dir, enabled=tensorboard and self._writes)
        self.ckpt_dir = os.path.join(run_dir, "checkpoints")
        self._ckpt_retention = dict(ckpt_retention) if ckpt_retention else None
        self._ckpt_writer = AsyncCheckpointWriter() if async_ckpt else None
        self._augment_cfg = {"flip": False, "max_shift": 0, **(augment or {})}
        self._mean, self._std = tuple(cfg.data.mean), tuple(cfg.data.std)

    # ------------------------------------------------------------------

    def _augment(self, batch, flip, shifts):
        if isinstance(batch, dict):
            return dict(batch, image=train_augment(batch["image"], flip, shifts,
                                                   self._mean, self._std))
        return train_augment(batch, flip, shifts, self._mean, self._std)

    def _target_of(self, batch):
        return batch["image"] if isinstance(batch, dict) else batch

    def _eval_input(self, batch):
        return batch if self.data_kind == "pair" else self._target_of(batch)

    def _place(self, state: TrainState) -> TrainState:
        if self.mesh is None:
            return state
        return shard_state(state, self.mesh, voxel_tp=self.voxel_tp)

    def _shard(self) -> tuple:
        """(data index, data size) of this rank: its rows of each batch."""
        return (0, 1) if self.mesh is None else (self.mesh.data_index, self.mesh.data)

    def _rows(self, t):
        return t if self.mesh is None else self.mesh.rows(t)

    def _spec(self, device: torch.device) -> DrawSpec:
        aug = self._augment_cfg
        return DrawSpec(self.cfg.train.batch_size, self.cfg.model.latent_dim,
                        bool(aug["flip"]), int(aug["max_shift"]), self.noise, device)

    def resume(self, state: TrainState, epoch: Optional[int] = None):
        """(state, start epoch) restored from this run's checkpoint dir, the
        latest checkpoint unless ``epoch`` (reference resume contract,
        ``train_vgan_stage1.py:239-247``)."""
        state, meta = restore_checkpoint(self.ckpt_dir, state, epoch=epoch)
        return state, int(meta["epoch"]) + 1

    @deterministic_cudnn()
    def evaluate_batches(self, state: TrainState, batches: Iterable, draws,
                         max_batches: int = 0, save_images_to: Optional[str] = None,
                         nrow: int = 8) -> Dict[str, float]:
        """Mean PCC/SSIM/MSE over (up to) ``max_batches`` host batches (0 =
        all), with ``draws`` one evaluation pass's draws (``Draws.eval``).
        The reference evaluates one batch per epoch
        (``train_vgan_stage1.py:594``). With ``save_images_to`` the last
        batch's reconstructions, originals and a generated panel are written
        as PNG grids and to TensorBoard. Under a mesh ``batches`` are this
        rank's rows (``Batches(shard=...)``); every rank returns the same
        metrics."""
        state = self._place(state)
        device = _device_of(state)
        latent = self.cfg.model.latent_dim
        data = 1 if self.mesh is None else self.mesh.data
        rows, last = [], None
        for i, batch in enumerate(batches):
            if max_batches and i >= max_batches:
                break
            batch = self._augment(to_device(batch, device), None, None)
            target = self._target_of(batch)
            eps = self._rows(draws.eps(len(target) * data, latent))
            recon = self.steps.eval_step(state, self._eval_input(batch),
                                         eps if self.eval_sample else None)
            # SSIM over this rank's rows; MSE and PCC, a global correlation,
            # over the data group's reconstructions gathered
            rank_ssim = ssim(denormalize(recon, self._mean, self._std),
                             denormalize(target, self._mean, self._std))
            if data > 1:
                recon, target = self.mesh.gather_data(torch.stack([recon, target], 1)).unbind(1)
            r = denormalize(recon, self._mean, self._std)
            t = denormalize(target, self._mean, self._std)
            rows.append(torch.stack([mse(recon, target), pearson_correlation(r, t),
                                     rank_ssim]))
            last = (r, t)
        if not rows:
            return {}
        table = torch.stack(rows)
        if data > 1:  # the mean of the ranks' SSIMs over equal row counts
            table[:, 2] = self.mesh.data_sum(table[:, 2]) / data
        sums = [0.0, 0.0, 0.0]
        for row in table.tolist():  # one transfer per pass
            sums = [s + v for s, v in zip(sums, row)]
        if save_images_to and last is not None:
            r, t = (a[: nrow * 2].cpu().numpy() for a in last)
            step = int(state.step)
            base, ext = os.path.splitext(save_images_to)
            if self._writes:
                save_image_grid(r, save_images_to, nrow=nrow)
                save_image_grid(t, f"{base}_original{ext}", nrow=nrow)
            if self.steps.generate_step is not None:
                gen = self.steps.generate_step(state, draws.z_p(nrow * 2, latent))
                g = denormalize(gen, self._mean, self._std).cpu().numpy()
                if self._writes:
                    save_image_grid(g, f"{base}_generated{ext}", nrow=nrow)
                self.tb.image_grid("generated", g, step, nrow=nrow)
            self.tb.image_grid("reconstructed", r, step, nrow=nrow)
            self.tb.image_grid("original", t, step, nrow=nrow)
        return {k: s / len(rows) for k, s in zip(("MSE", "PCC", "SSIM"), sums)}

    def _train_epoch(self, state: TrainState, batches, draws, epoch: int,
                     gate: tuple, spec: DrawSpec) -> Dict[str, float]:
        acc: Dict[str, torch.Tensor] = {}
        nb = 0
        for b_idx, batch in enumerate(batches):
            # drawn for the global batch; this rank takes its rows
            flip, shifts, noise = draws.train(epoch, b_idx, spec)
            noise = {k: self._rows(v) for k, v in noise.items()}
            state, m = self.steps.train_step(
                state, self._augment(batch, self._rows(flip), self._rows(shifts)), noise, *gate)
            for key, v in m.items():  # summed on the device: no host sync here
                acc[key] = v if key not in acc else acc[key] + v
            nb += 1
        keys = sorted(acc)  # the JAX step's metrics come back key-sorted
        sums = torch.stack([acc[k].float() for k in keys]).tolist()  # one transfer
        return {k: v / nb for k, v in zip(keys, sums)}

    def _profiler(self, device: torch.device):
        from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # every thread: the input producer's ``input.stage`` spans too
        return profile(activities=acts,
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))

    # ------------------------------------------------------------------

    @deterministic_cudnn()
    def fit(self, state: TrainState, train_data, valid_data=None, *,
            n_epochs: Optional[int] = None, start_epoch: int = 0,
            eval_batches: int = 1, grid_every: int = 2,
            seed: Optional[int] = None, on_device: bool = False,
            epoch_callback: Optional[Callable] = None) -> TrainState:
        """Train from ``start_epoch`` to ``n_epochs`` on host arrays.
        ``on_device=True`` puts the training set on the device once and
        gathers each batch there (same order, same draws, same result)."""
        cfg = self.cfg
        t = cfg.train
        n_epochs = n_epochs if n_epochs is not None else t.n_epochs
        seed = seed if seed is not None else t.seed
        if self._writes:
            extra = {"data_kind": self.data_kind, "seed": seed, "on_device": on_device,
                     "start_epoch": start_epoch, "n_epochs": n_epochs}
            if self.mesh is not None:
                extra["mesh"] = dict(self.mesh.shape, voxel_tp=self.voxel_tp)
            dump_config(self.run_dir, cfg, extra=extra)
        state = self._place(state)
        device = _device_of(state)
        draws = self.draws if self.draws is not None else Draws(seed)
        spec = self._spec(device)

        shard = self._shard()
        train_batches = Batches(train_data, t.batch_size, shuffle=True, seed=seed,
                                shard=shard)
        train_batches.epoch = start_epoch
        valid_batches = (Batches(valid_data, t.batch_size, shuffle=False, shard=shard)
                         if valid_data is not None else None)
        device_data = to_device(train_data, device) if on_device else None

        sched = GameSchedules(cfg)
        for _ in range(start_epoch):  # fast-forward the schedules on resume
            sched.epoch_end()
        stopper = EarlyStopping(patience=t.patience, mode="max")

        final_epoch = start_epoch
        last_row: Optional[Dict[str, float]] = None
        saved_epoch: Optional[int] = None
        try:
            for epoch in range(start_epoch, n_epochs):
                final_epoch = epoch
                prof = None
                if self.profile and epoch == start_epoch + 1 and self._writes:
                    prof = self._profiler(device)
                    prof.__enter__()
                if device_data is not None:
                    perm = torch.from_numpy(epoch_permutation(
                        num_examples(train_data), t.batch_size, seed, epoch)).to(device)
                    batches = device_epoch(device_data, perm, t.batch_size, shard)
                else:
                    batches = device_iterator(iter(train_batches), device)
                gate = sched.args(device) if self.uses_gate else ()
                epoch_metrics = self._train_epoch(state, batches, draws, epoch, gate, spec)
                if prof is not None:
                    prof.__exit__(None, None, None)
                    trace = os.path.join(self.run_dir, "profile", "trace.json")
                    os.makedirs(os.path.dirname(trace), exist_ok=True)
                    prof.export_chrome_trace(trace)
                    self.logger.info("profile trace written; summarize with: python -m "
                                     "fmri_tpu_torch.utils.profile_report %s", trace)
                sched.epoch_end()

                row: Dict[str, float] = {"epoch": float(epoch)}
                row.update(epoch_metrics)

                if valid_batches is not None and (epoch % t.eval_every == 0):
                    grid_path = None
                    if grid_every and epoch % grid_every == 0:
                        grid_path = os.path.join(self.run_dir, "images", "valid",
                                                 f"epoch_{epoch:04d}.png")
                    vm = self.evaluate_batches(
                        state, iter(valid_batches), draws.eval(epoch, VALID_STREAM, device),
                        max_batches=eval_batches, save_images_to=grid_path)
                    row.update({f"valid_{k}": v for k, v in vm.items()})
                    # train-batch metrics, the reference's train_* columns
                    # (train_vgan_stage1.py:583-618)
                    tm = self.evaluate_batches(
                        state, iter(Batches(train_data, t.batch_size, shard=shard)),
                        draws.eval(epoch, TRAIN_METRICS_STREAM, device),
                        max_batches=max(eval_batches, 1))
                    row.update({f"train_{k}": v for k, v in tm.items()})

                self.results.append(row)
                for key, v in row.items():
                    if key != "epoch":
                        self.tb.scalar(key, v, epoch)
                self.logger.info("epoch %d | %s", epoch, " ".join(
                    f"{k}={v:.5f}" for k, v in row.items() if k != "epoch"))

                last_row = row
                if t.ckpt_every and epoch % t.ckpt_every == 0 and not self.debug:
                    self._save_ckpt(epoch, state, seed, row)
                    saved_epoch = epoch

                if epoch_callback is not None:
                    epoch_callback(epoch, state, row)

                # a NaN anywhere stops training (train_utils.py:41-42);
                # patience follows valid_PCC (maximized)
                if any(math.isnan(v) for v in row.values()):
                    guard = float("nan")
                elif "valid_PCC" in row:
                    guard = row["valid_PCC"]
                else:
                    guard = stopper.best if stopper.best is not None else 0.0
                stop = stopper.update(guard)
                if self.mesh is not None:  # one decision: a rank that stops alone hangs
                    stop = self.mesh.agree(stop)
                if stop:
                    self.logger.info("early stop at epoch %d", epoch)
                    break
        except KeyboardInterrupt:  # the reference saves its plots on interrupt
            self.logger.info("interrupted; saving plots")
        finally:
            if self._writes:
                save_loss_plots(self.results, self.run_dir, self.logger)
            self.tb.close()
            # drain an in-flight background write even on the exception path
            # (a daemon thread killed mid-write would leave a half checkpoint);
            # its error is logged here, re-raised by the wait() below
            if self._ckpt_writer is not None:
                try:
                    self._ckpt_writer.wait()
                except Exception:
                    self.logger.exception("background checkpoint write failed")

        # the final checkpoint carries the last epoch's metrics (for
        # keep-best); skipped when the cadence already saved this epoch
        if not self.debug and saved_epoch != final_epoch:
            self._save_ckpt(final_epoch, state, seed, last_row)
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()
        return state

    def _save_ckpt(self, epoch: int, state: TrainState, seed: int,
                   row: Optional[Mapping[str, float]] = None) -> None:
        meta: Dict[str, Any] = {"seed": seed}
        if row:
            meta["metrics"] = {k: float(v) for k, v in row.items() if k != "epoch"}
        if self._ckpt_writer is not None:
            self._ckpt_writer.save(self.ckpt_dir, epoch, state, meta,
                                   prune=self._ckpt_retention)
        else:
            save_checkpoint(self.ckpt_dir, epoch, state, meta)
            if self._ckpt_retention and self._writes:
                prune_checkpoints(self.ckpt_dir, **self._ckpt_retention)
