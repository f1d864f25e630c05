"""Weights into the port: from the JAX package's parameter trees, from a
reference-layout ``.pth``, or seeded random trees.

* :func:`from_jax_groups` turns ``{"encoder": {"params", "batch_stats"},
  "decoder": ...}`` numpy trees (the JAX package's NHWC/HWIO layout) into the
  state dict of :class:`fmri_tpu_torch.eval.steps.VaeGanCognitive`. It is the
  port's own copy of the inverse converters of
  ``fmri_tpu/checkpoints/torch_import.py:200-225`` and gives the same arrays
  as that module's ``export_state_dict(..., kind="vae-gan-cognitive")``.
  The 180-degree deconv-tap rotation happens here (``_inv_deconv``), never in
  the op.
* :func:`load_pth` reads a reference-layout ``.pth``.
* :func:`random_groups` makes seeded numpy trees in the JAX layout, for runs
  that need weights but no checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from fmri_tpu_torch.configs.presets import Config

# prefixes of a VaeGanCognitive .pth that inference does not use
UNUSED_PREFIXES = ("discriminator.", "teacher_net.")


def _inv_lin(k) -> np.ndarray:
    return np.asarray(k, np.float32).T  # [in, out] -> [out, in]


def _inv_conv(k) -> np.ndarray:
    return np.asarray(k, np.float32).transpose(3, 2, 0, 1)  # HWIO -> OIHW


def _inv_deconv(k) -> np.ndarray:
    # HWIO correlation taps -> torch's scattered IOHW: rotate 180 degrees
    k = np.asarray(k, np.float32)
    return np.flip(k, (0, 1)).transpose(2, 3, 0, 1).copy()


def _inv_fc_out(k, c: int, h: int, wd: int) -> np.ndarray:
    """Dense kernel [z, H*W*C] (HWC-major output) -> Linear [C*H*W, z]."""
    k = np.asarray(k, np.float32).T
    zin = k.shape[1]
    return k.reshape(h, wd, c, zin).transpose(2, 0, 1, 3).reshape(-1, zin)


def _inv_vec(v, c: int, h: int, wd: int) -> np.ndarray:
    return np.asarray(v, np.float32).reshape(h, wd, c).transpose(2, 0, 1).reshape(-1)


def _bn(out: Dict, prefix: str, params: Mapping, stats: Mapping, perm=None) -> None:
    f = perm or (lambda v: np.asarray(v, np.float32))
    out[f"{prefix}.weight"] = f(params["scale"])
    out[f"{prefix}.bias"] = f(params["bias"])
    out[f"{prefix}.running_mean"] = f(stats["mean"])
    out[f"{prefix}.running_var"] = f(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _encoder(group: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    p, s = group["params"], group["batch_stats"]
    out = {f"{prefix}fc1.0.weight": _inv_lin(p["fc1"]["kernel"])}
    _bn(out, f"{prefix}fc1.1", p["BatchNorm_0"], s["BatchNorm_0"])
    for name, dense in (("l_mu", "Dense_0"), ("l_var", "Dense_1")):
        out[f"{prefix}{name}.weight"] = _inv_lin(p[dense]["kernel"])
        out[f"{prefix}{name}.bias"] = np.asarray(p[dense]["bias"], np.float32)
    return out


def _decoder(group: Mapping, cfg: Config, prefix: str) -> Dict[str, np.ndarray]:
    c = cfg.model
    size0 = c.encoder_channels[-1]
    p, s = group["params"], group["batch_stats"]
    out = {f"{prefix}fc.0.weight": _inv_fc_out(p["Dense_0"]["kernel"], size0,
                                               c.fc_input, c.fc_input)}
    _bn(out, f"{prefix}fc.1", p["BatchNorm_0"], s["BatchNorm_0"],
        lambda v: _inv_vec(v, size0, c.fc_input, c.fc_input))
    for i in range(3):
        blk = p[f"DecoderBlock_{i}"]
        out[f"{prefix}conv.{i}.conv.weight"] = _inv_deconv(blk["kernel"])
        _bn(out, f"{prefix}conv.{i}.bn", blk["BatchNorm_0"],
            s[f"DecoderBlock_{i}"]["BatchNorm_0"])
    out[f"{prefix}conv.3.0.weight"] = _inv_conv(p["out_kernel"])
    out[f"{prefix}conv.3.0.bias"] = np.asarray(p["out_bias"], np.float32)
    return out


def from_jax_groups(groups: Mapping[str, Mapping], cfg: Config
                    ) -> Dict[str, torch.Tensor]:
    """JAX-layout ``encoder`` (cognitive) and ``decoder`` groups -> the
    ``encoder.*``/``decoder.*`` state dict, as CPU tensors."""
    sd = _encoder(groups["encoder"], "encoder.")
    sd.update(_decoder(groups["decoder"], cfg, "decoder."))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """The ``encoder.*``/``decoder.*`` tensors of a reference-layout
    ``VaeGanCognitive`` ``.pth`` (a plain state dict; ``weights_only=True``
    unpickles nothing else). ``discriminator.*`` and ``teacher_net.*`` are
    dropped; any other key is kept so a strict load reports it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if not k.startswith(UNUSED_PREFIXES)}


def _uniform(rng, shape, fan_in):
    a = 1.0 / np.sqrt(3.0 * fan_in)  # the reference init, vae_gan.py:258-262
    return rng.uniform(-a, a, shape).astype(np.float32)


def _random_bn(rng, n):
    params = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
              "bias": rng.normal(0.0, 0.1, n).astype(np.float32)}
    stats = {"mean": rng.normal(0.0, 0.1, n).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
    return params, stats


def random_groups(cfg: Config, seed: int = 0) -> Dict[str, Dict[str, Any]]:
    """Seeded ``encoder``/``decoder`` numpy trees in the JAX package's layout
    and naming, with non-trivial BatchNorm statistics."""
    c = cfg.model
    rng = np.random.default_rng(seed)
    v, hid, lat = c.num_voxels, c.cog_hidden, c.latent_dim
    bnp, bns = _random_bn(rng, hid)
    encoder = {
        "params": {"fc1": {"kernel": _uniform(rng, (v, hid), v)},
                   "BatchNorm_0": bnp,
                   "Dense_0": {"kernel": _uniform(rng, (hid, lat), hid),
                               "bias": _uniform(rng, (lat,), hid)},
                   "Dense_1": {"kernel": _uniform(rng, (hid, lat), hid),
                               "bias": _uniform(rng, (lat,), hid)}},
        "batch_stats": {"BatchNorm_0": bns}}
    size0 = c.encoder_channels[-1]
    flat = c.fc_input * c.fc_input * size0
    bnp, bns = _random_bn(rng, flat)
    dp = {"Dense_0": {"kernel": _uniform(rng, (lat, flat), lat)}, "BatchNorm_0": bnp}
    ds = {"BatchNorm_0": bns}
    chans = (size0, size0, c.decoder_channels[1], c.decoder_channels[2])
    k = c.kernel_size
    for i in range(3):
        bnp, bns = _random_bn(rng, chans[i + 1])
        dp[f"DecoderBlock_{i}"] = {
            "kernel": _uniform(rng, (k, k, chans[i], chans[i + 1]), k * k * chans[i]),
            "BatchNorm_0": bnp}
        ds[f"DecoderBlock_{i}"] = {"BatchNorm_0": bns}
    cout = c.decoder_channels[3]
    dp["out_kernel"] = _uniform(rng, (5, 5, chans[3], cout), 25 * chans[3])
    dp["out_bias"] = _uniform(rng, (cout,), 25 * chans[3])
    return {"encoder": encoder, "decoder": {"params": dp, "batch_stats": ds}}
