"""In-process serving of a cognitive VAE/GAN checkpoint: fMRI -> image.

Counterpart of ``fmri_tpu/eval/serve.py:87-316`` (``batch_buckets`` and
``ServingModel``, without the mesh branch). The model and one zero-padded
input buffer per bucket live on the device. A request batch is chunked at
``max_batch`` and each chunk padded up to the nearest power-of-two bucket,
so the set of batch shapes the device sees stays fixed (the shapes a later
CUDA-graph capture needs). Padding is exact: eval-mode BatchNorm uses running
statistics, so pad rows cannot perturb real rows. Denormalize, clip and the
optional uint8 quantization run on the device.

Not in this port yet: the threaded ``BatchingServer``, the socket CLI and
hot ``reload``.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np
import torch

from fmri_tpu_torch.configs.presets import Config
from fmri_tpu_torch.data.transforms import denormalize
from fmri_tpu_torch.device import resolve_device
from fmri_tpu_torch.eval.steps import VaeGanCognitive


def batch_buckets(max_batch: int, min_bucket: int = 1) -> List[int]:
    """Power-of-two bucket ladder ending exactly at ``max_batch``."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1")
    out, b = [], max(1, min_bucket)
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return sorted(set(out))


class ServingModel:
    """A device-resident :class:`VaeGanCognitive` behind bucketed batches.

    ``reconstruct`` takes any [N, V] request batch (or one [V] sample) and
    returns [N, H, W, 3] images in [0, 1] (float32, or uint8 with
    ``output="uint8"``). ``generate`` decodes prior samples. With ``sample``
    the latent is reparameterized with noise from a ``torch.Generator``
    seeded with ``seed``; ``generate`` draws from its own generator seeded
    with ``seed + 0x5EED``.
    """

    def __init__(self, cfg: Config, model: VaeGanCognitive, *,
                 max_batch: int = 64, min_bucket: int = 1,
                 sample: bool = False, seed: int = 0, output: str = "float",
                 device: str | torch.device = "cuda"):
        if output not in ("float", "uint8"):
            raise ValueError(f"output must be 'float' or 'uint8', got {output!r}")
        self.cfg, self.output = cfg, output
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.max_batch = int(max_batch)
        self.buckets = batch_buckets(self.max_batch, min_bucket)
        v = cfg.model.num_voxels
        self._inputs = {b: torch.zeros((b, v), device=self.device)
                        for b in self.buckets}
        self._rng = (torch.Generator(device=self.device).manual_seed(seed)
                     if sample else None)
        self._gen_rng = torch.Generator(device=self.device).manual_seed(seed + 0x5EED)
        self._lock = threading.Lock()   # buffers and generators

    @classmethod
    def from_pth(cls, path: str, preset: str = "res64", **kw) -> "ServingModel":
        """Serve a reference-layout ``VaeGanCognitive`` ``.pth``."""
        from fmri_tpu_torch.checkpoints.convert import load_pth
        from fmri_tpu_torch.configs.presets import get_config

        cfg = get_config(preset)
        model = VaeGanCognitive(cfg.model)
        model.load_state_dict(load_pth(path), strict=True)
        return cls(cfg, model, **kw)

    def sample_shape(self) -> tuple:
        """Per-request input shape (no batch dim)."""
        return (self.cfg.model.num_voxels,)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _finish(self, out: torch.Tensor) -> torch.Tensor:
        """Model output in [-1, 1] -> images in [0, 1] (or uint8), on device."""
        d = self.cfg.data
        out = denormalize(out, d.mean, d.std).clamp(0.0, 1.0)
        if self.output == "uint8":
            out = (out * 255.0 + 0.5).to(torch.uint8)
        return out

    def _run(self, chunk: np.ndarray) -> np.ndarray:
        """One chunk (<= max_batch rows) through its padded bucket."""
        n = len(chunk)
        b = self._bucket_for(n)
        inp = self._inputs[b]
        inp[:n].copy_(torch.from_numpy(chunk))
        inp[n:].zero_()
        eps = None
        if self._rng is not None:
            eps = torch.randn((b, self.cfg.model.latent_dim),
                              generator=self._rng, device=self.device)
        out = self._finish(self.model.reconstruct(inp, eps))
        return out[:n].cpu().numpy()

    def warmup(self, generate: bool = True) -> None:
        """Run every bucket once (reconstruct and, by default, generate)
        before traffic arrives. The sampling generators are restored after,
        so outputs depend on the seed alone, not on warmup."""
        gens = [g for g in (self._rng, self._gen_rng) if g is not None]
        with self._lock:
            saved = [g.get_state() for g in gens]
            for b in self.buckets:
                self._run(np.zeros((b, *self.sample_shape()), np.float32))
                if generate:
                    self._generate_bucket(b)
            for g, state in zip(gens, saved):
                g.set_state(state)

    def reconstruct(self, x) -> np.ndarray:
        """[N, V] request batch (or a single [V] sample) -> [N, H, W, 3]."""
        x = np.asarray(x, np.float32)
        single = x.ndim == 1
        if single:
            x = x[None]
        if x.ndim != 2 or x.shape[1] != self.cfg.model.num_voxels:
            raise ValueError(f"expected [N, {self.cfg.model.num_voxels}] fMRI, "
                             f"got {x.shape}")
        if len(x) == 0:
            s = self.cfg.model.image_size
            return np.zeros((0, s, s, 3),
                            np.uint8 if self.output == "uint8" else np.float32)
        with self._lock:
            outs = [self._run(x[lo:lo + self.max_batch])
                    for lo in range(0, len(x), self.max_batch)]
        out = np.concatenate(outs)
        return out[0] if single else out

    def _generate_bucket(self, b: int) -> torch.Tensor:
        z = torch.randn((b, self.cfg.model.latent_dim), generator=self._gen_rng,
                        device=self.device)
        return self._finish(self.model.generate(z))

    def generate(self, n: int) -> np.ndarray:
        """Decode ``n`` samples z ~ N(0, I) with BatchNorm running statistics,
        in bucket-sized batches."""
        if n < 1:
            raise ValueError("n must be >= 1")
        outs, remaining = [], n
        with self._lock:
            while remaining > 0:
                k = min(remaining, self.max_batch)
                outs.append(self._generate_bucket(self._bucket_for(k))[:k].cpu().numpy())
                remaining -= k
        return np.concatenate(outs)
