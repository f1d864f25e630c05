"""Weights into the port: from the JAX package's parameter trees, from a
reference-layout ``.pth``, or seeded random trees.

* :func:`from_jax_groups` turns named numpy groups ``{"encoder": {"params",
  "batch_stats"}, "decoder": ..., ...}`` (the JAX package's NHWC/HWIO
  layout) into a state dict in the reference's torch layout and naming. A
  kind names the module the state dict is for: its required groups
  (``KINDS``; a missing one raises ``KeyError``) and its optional ones
  (``OPTIONAL``):

  - ``"vae-gan"``: ``encoder`` (visual), ``decoder``, ``discriminator``:
    the stage-I ``VaeGan`` (``train/state.py``);
  - ``"vae-gan-cognitive"``: ``encoder`` (cognitive), ``decoder``,
    ``discriminator``, and the optional ``teacher_encoder``, which gives
    ``teacher_net.encoder.*`` and the
    ``teacher_net.decoder.*``/``teacher_net.discriminator.*`` copies of
    the shared modules: the stage-II/III ``VaeGanCognitiveTrain`` loads
    it strictly with the teacher. This is the JAX package's kind of the
    same name;
  - ``"vae-gan-cognitive-eval"``: ``encoder`` (cognitive) and ``decoder``,
    the inference module ``eval/steps.py::VaeGanCognitive``.

  It is the port's own copy of the inverse converters of
  ``fmri_tpu/checkpoints/torch_import.py:200-384`` and gives the same
  arrays as that module's ``export_state_dict``. The 180-degree deconv-tap
  rotation happens here (``_inv_deconv``), never in the op.
* :func:`moments_from_jax` maps optimizer moments (trees shaped like the
  params of the groups given) through the same permutations, into the
  port's per-parameter layout.
* :func:`load_pth` reads a reference-layout ``.pth`` for inference,
  :func:`load_train_pth` for training.
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


def _f32(v) -> np.ndarray:
    return np.asarray(v, np.float32)


def _inv_lin(k) -> np.ndarray:
    return _f32(k).T  # [in, out] -> [out, in]


def _inv_conv(k) -> np.ndarray:
    return _f32(k).transpose(3, 2, 0, 1)  # HWIO -> OIHW


def _inv_deconv(k) -> np.ndarray:
    # HWIO correlation taps -> torch's scattered IOHW: rotate 180 degrees
    return np.flip(_f32(k), (0, 1)).transpose(2, 3, 0, 1).copy()


def _inv_fc_in(k, c: int, h: int, wd: int) -> np.ndarray:
    """Dense kernel [H*W*C, out] (HWC-major input) -> Linear [out, C*H*W]."""
    k = _f32(k).T
    out = k.shape[0]
    return k.reshape(out, h, wd, c).transpose(0, 3, 1, 2).reshape(out, -1)


def _inv_fc_out(k, c: int, h: int, wd: int) -> np.ndarray:
    """Dense kernel [z, H*W*C] (HWC-major output) -> Linear [C*H*W, z]."""
    k = _f32(k).T
    zin = k.shape[1]
    return k.reshape(h, wd, c, zin).transpose(2, 0, 1, 3).reshape(-1, zin)


def _inv_vec(v, c: int, h: int, wd: int) -> np.ndarray:
    return _f32(v).reshape(h, wd, c).transpose(2, 0, 1).reshape(-1)


def _bn(out: Dict, prefix: str, params: Mapping, stats: Mapping | None,
        perm=None) -> None:
    """BatchNorm weight/bias, and its running statistics where ``stats`` is
    given (moment trees have none)."""
    f = perm or _f32
    out[f"{prefix}.weight"] = f(params["scale"])
    out[f"{prefix}.bias"] = f(params["bias"])
    if stats is not None:
        out[f"{prefix}.running_mean"] = f(stats["mean"])
        out[f"{prefix}.running_var"] = f(stats["var"])
        out[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _sub(stats: Mapping | None, *path: str) -> Mapping | None:
    for key in path:
        if stats is None:
            return None
        stats = stats[key]
    return stats


def _cognitive_encoder(group: Mapping, cfg: Config, prefix: str) -> Dict:
    p, s = group["params"], group.get("batch_stats")
    out = {f"{prefix}fc1.0.weight": _inv_lin(p["fc1"]["kernel"])}
    _bn(out, f"{prefix}fc1.1", p["BatchNorm_0"], _sub(s, "BatchNorm_0"))
    for name, dense in (("l_mu", "Dense_0"), ("l_var", "Dense_1")):
        out[f"{prefix}{name}.weight"] = _inv_lin(p[dense]["kernel"])
        out[f"{prefix}{name}.bias"] = _f32(p[dense]["bias"])
    return out


def _visual_encoder(group: Mapping, cfg: Config, prefix: str) -> Dict:
    c = cfg.model
    p, s = group["params"], group.get("batch_stats")
    out: Dict[str, np.ndarray] = {}
    for i in range(len(c.encoder_channels)):
        blk = p[f"EncoderBlock_{i}"]
        out[f"{prefix}conv.{i}.conv.weight"] = _inv_conv(blk["kernel"])
        _bn(out, f"{prefix}conv.{i}.bn", blk["BatchNorm_0"],
            _sub(s, f"EncoderBlock_{i}", "BatchNorm_0"))
    out[f"{prefix}fc.0.weight"] = _inv_fc_in(
        p["Dense_0"]["kernel"], c.encoder_channels[-1], c.fc_input, c.fc_input)
    _bn(out, f"{prefix}fc.1", p["BatchNorm_0"], _sub(s, "BatchNorm_0"))
    for name, dense in (("l_mu", "Dense_1"), ("l_var", "Dense_2")):
        out[f"{prefix}{name}.weight"] = _inv_lin(p[dense]["kernel"])
        out[f"{prefix}{name}.bias"] = _f32(p[dense]["bias"])
    return out


def _decoder(group: Mapping, cfg: Config, prefix: str) -> Dict:
    c = cfg.model
    size0 = c.encoder_channels[-1]
    p, s = group["params"], group.get("batch_stats")
    out = {f"{prefix}fc.0.weight": _inv_fc_out(p["Dense_0"]["kernel"], size0,
                                               c.fc_input, c.fc_input)}
    _bn(out, f"{prefix}fc.1", p["BatchNorm_0"], _sub(s, "BatchNorm_0"),
        lambda v: _inv_vec(v, size0, c.fc_input, c.fc_input))
    for i in range(3):
        blk = p[f"DecoderBlock_{i}"]
        out[f"{prefix}conv.{i}.conv.weight"] = _inv_deconv(blk["kernel"])
        _bn(out, f"{prefix}conv.{i}.bn", blk["BatchNorm_0"],
            _sub(s, f"DecoderBlock_{i}", "BatchNorm_0"))
    out[f"{prefix}conv.3.0.weight"] = _inv_conv(p["out_kernel"])
    out[f"{prefix}conv.3.0.bias"] = _f32(p["out_bias"])
    return out


def _image_discriminator(group: Mapping, cfg: Config, prefix: str) -> Dict:
    c = cfg.model
    p, s = group["params"], group.get("batch_stats")
    out = {f"{prefix}conv.0.0.weight": _inv_conv(p["in_kernel"]),
           f"{prefix}conv.0.0.bias": _f32(p["in_bias"])}
    for i in range(1, len(c.discrim_channels)):
        blk = p[f"EncoderBlock_{i - 1}"]
        out[f"{prefix}conv.{i}.conv.weight"] = _inv_conv(blk["kernel"])
        _bn(out, f"{prefix}conv.{i}.bn", blk["BatchNorm_0"],
            _sub(s, f"EncoderBlock_{i - 1}", "BatchNorm_0"))
    out[f"{prefix}fc.0.weight"] = _inv_fc_in(
        p["Dense_0"]["kernel"], c.discrim_channels[-1], c.fc_input_gan,
        c.fc_input_gan)
    _bn(out, f"{prefix}fc.1", p["BatchNorm_0"], _sub(s, "BatchNorm_0"))
    out[f"{prefix}fc.3.weight"] = _inv_lin(p["Dense_1"]["kernel"])
    out[f"{prefix}fc.3.bias"] = _f32(p["Dense_1"]["bias"])
    return out


# {kind: {group: converter}}: the required groups; each group's keys carry
# the prefix "<group>."
KINDS = {
    "vae-gan": {"encoder": _visual_encoder, "decoder": _decoder,
                "discriminator": _image_discriminator},
    "vae-gan-cognitive": {"encoder": _cognitive_encoder, "decoder": _decoder,
                          "discriminator": _image_discriminator},
    "vae-gan-cognitive-eval": {"encoder": _cognitive_encoder, "decoder": _decoder},
}
# {kind: {group: (converter, prefix, shared prefixes)}}: the optional groups.
# The stage-I teacher of "vae-gan-cognitive" (torch_import.py:372-383) brings
# its visual encoder and teacher_net.* copies of the shared decoder and
# discriminator.
OPTIONAL = {
    "vae-gan-cognitive": {"teacher_encoder": (
        _visual_encoder, "teacher_net.encoder.", ("decoder.", "discriminator."))},
}


def _kind(kind: str) -> Mapping:
    try:
        return KINDS[kind]
    except KeyError:
        raise KeyError(f"unknown kind {kind!r}; one of {sorted(KINDS)}") from None


def _tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    # np.array copies: arrays from JAX are read-only, and torch needs writable
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def from_jax_groups(groups: Mapping[str, Mapping], cfg: Config,
                    kind: str = "vae-gan-cognitive-eval") -> Dict[str, torch.Tensor]:
    """JAX-layout groups -> the state dict of ``kind``, as CPU tensors.
    Every required group of the kind must be in ``groups``; an optional
    group (:data:`OPTIONAL`) adds its keys where given; others are ignored.
    A group without ``batch_stats`` gives parameters only."""
    sd: Dict[str, np.ndarray] = {}
    for group, fn in _kind(kind).items():
        if group not in groups:
            raise KeyError(f"kind {kind!r} needs group {group!r}; got {sorted(groups)}")
        sd.update(fn(groups[group], cfg, f"{group}."))
    for group, (fn, prefix, shared) in OPTIONAL.get(kind, {}).items():
        if group in groups:
            sd.update(fn(groups[group], cfg, prefix))
            owner = prefix[:prefix.index(".") + 1]  # "teacher_net."
            sd.update({owner + k: v for k, v in list(sd.items()) if k.startswith(shared)})
    return _tensors(sd)


def moments_from_jax(trees: Mapping[str, Any], cfg: Config,
                     kind: str = "vae-gan") -> Dict[str, Dict[str, torch.Tensor]]:
    """Optimizer moments shaped like the JAX params of the groups given (e.g.
    RMSprop's ``sq_avg`` of the trained groups) -> ``{group: {parameter
    name: tensor}}`` in the port's layout, by the same permutations as the
    weights."""
    fns = dict(_kind(kind))
    fns.update({g: spec[0] for g, spec in OPTIONAL.get(kind, {}).items()})
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for group, tree in trees.items():
        if group not in fns:
            raise KeyError(f"kind {kind!r} has no group {group!r}")
        sd = fns[group]({"params": tree}, cfg, "")
        out[group] = _tensors(sd)
    return out


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """The ``encoder.*``/``decoder.*`` tensors of a reference-layout
    ``VaeGan`` or ``VaeGanCognitive`` ``.pth``, for inference (a plain state
    dict; ``weights_only=True`` unpickles nothing else).
    ``discriminator.*`` and ``teacher_net.*`` are dropped; any other key is
    kept so a strict load reports it."""
    return {k: v for k, v in load_train_pth(path).items()
            if not k.startswith(UNUSED_PREFIXES)}


def load_train_pth(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a reference-layout ``.pth``, ``discriminator.*`` and
    ``teacher_net.*`` included, for a train module's strict load."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _uniform(rng, shape, fan_in):
    a = 1.0 / np.sqrt(3.0 * fan_in)  # the reference init, vae_gan.py:258-262
    return rng.uniform(-a, a, shape).astype(np.float32)


def _random_bn(rng, n):
    params = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
              "bias": rng.normal(0.0, 0.1, n).astype(np.float32)}
    stats = {"mean": rng.normal(0.0, 0.1, n).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
    return params, stats


def _random_conv_stack(rng, cin: int, chans, k: int):
    """``EncoderBlock_{i}`` params and stats of a stack of conv blocks."""
    params, stats = {}, {}
    for i, cout in enumerate(chans):
        bnp, bns = _random_bn(rng, cout)
        params[f"EncoderBlock_{i}"] = {
            "kernel": _uniform(rng, (k, k, cin, cout), k * k * cin),
            "BatchNorm_0": bnp}
        stats[f"EncoderBlock_{i}"] = {"BatchNorm_0": bns}
        cin = cout
    return params, stats


def _random_visual_encoder(rng, c) -> Dict[str, Any]:
    p, s = _random_conv_stack(rng, 3, c.encoder_channels, c.kernel_size)
    flat = c.fc_input * c.fc_input * c.encoder_channels[-1]
    p["Dense_0"] = {"kernel": _uniform(rng, (flat, c.fc_output), flat)}
    p["BatchNorm_0"], s["BatchNorm_0"] = _random_bn(rng, c.fc_output)
    for dense in ("Dense_1", "Dense_2"):
        p[dense] = {"kernel": _uniform(rng, (c.fc_output, c.latent_dim), c.fc_output),
                    "bias": _uniform(rng, (c.latent_dim,), c.fc_output)}
    return {"params": p, "batch_stats": s}


def _random_cognitive_encoder(rng, c) -> Dict[str, Any]:
    v, hid, lat = c.num_voxels, c.cog_hidden, c.latent_dim
    bnp, bns = _random_bn(rng, hid)
    return {
        "params": {"fc1": {"kernel": _uniform(rng, (v, hid), v)},
                   "BatchNorm_0": bnp,
                   "Dense_0": {"kernel": _uniform(rng, (hid, lat), hid),
                               "bias": _uniform(rng, (lat,), hid)},
                   "Dense_1": {"kernel": _uniform(rng, (hid, lat), hid),
                               "bias": _uniform(rng, (lat,), hid)}},
        "batch_stats": {"BatchNorm_0": bns}}


def _random_decoder(rng, c) -> Dict[str, Any]:
    lat = c.latent_dim
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
    return {"params": dp, "batch_stats": ds}


def _random_image_discriminator(rng, c) -> Dict[str, Any]:
    ch = c.discrim_channels
    p, s = _random_conv_stack(rng, ch[0], ch[1:], c.kernel_size)
    p["in_kernel"] = _uniform(rng, (5, 5, 3, ch[0]), 75)
    p["in_bias"] = _uniform(rng, (ch[0],), 75)
    flat = c.fc_input_gan * c.fc_input_gan * ch[-1]
    p["Dense_0"] = {"kernel": _uniform(rng, (flat, c.fc_output_gan), flat)}
    p["BatchNorm_0"], s["BatchNorm_0"] = _random_bn(rng, c.fc_output_gan)
    p["Dense_1"] = {"kernel": _uniform(rng, (c.fc_output_gan, 1), c.fc_output_gan),
                    "bias": _uniform(rng, (1,), c.fc_output_gan)}
    return {"params": p, "batch_stats": s}


def random_groups(cfg: Config, seed: int = 0, kind: str = "vae-gan-cognitive-eval"
                  ) -> Dict[str, Dict[str, Any]]:
    """Seeded numpy groups of ``kind`` in the JAX package's layout and
    naming, with non-trivial BatchNorm statistics: ``encoder`` (visual),
    ``decoder`` and ``discriminator`` for ``"vae-gan"``; ``encoder``
    (cognitive) and ``decoder`` for ``"vae-gan-cognitive-eval"``, then
    ``discriminator`` and ``teacher_encoder`` (visual) for
    ``"vae-gan-cognitive"`` (its first two groups are the eval kind's of
    the same seed)."""
    _kind(kind)
    c = cfg.model
    rng = np.random.default_rng(seed)
    if kind == "vae-gan":
        encoder = _random_visual_encoder(rng, c)
        decoder = _random_decoder(rng, c)
        return {"encoder": encoder, "decoder": decoder,
                "discriminator": _random_image_discriminator(rng, c)}
    encoder = _random_cognitive_encoder(rng, c)
    groups = {"encoder": encoder, "decoder": _random_decoder(rng, c)}
    if kind == "vae-gan-cognitive":
        groups["discriminator"] = _random_image_discriminator(rng, c)
        groups["teacher_encoder"] = _random_visual_encoder(rng, c)
    return groups
