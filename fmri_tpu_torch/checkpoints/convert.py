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
    the inference module ``eval/steps.py::VaeGanCognitive``;
  - ``"wae-gan"``: ``encoder`` (visual), ``decoder`` and ``latent_disc``
    under the reference's ``discriminator.`` prefix: ``train/state.py::
    WaeGan``, the JAX package's kind of the same name;
  - ``"wae-gan-cognitive"``: ``encoder`` (cognitive), ``decoder``,
    ``latent_disc`` (``discriminator.``), and the optional
    ``teacher_encoder`` (``teacher_encoder.``, a key the reference does not
    save): ``WaeGanCognitiveTrain``; without the teacher, the JAX package's
    kind of the same name;
  - ``"wae-vgan"``: ``encoder`` (visual), ``decoder``, ``discriminator``
    (image) and ``latent_disc`` (``latent_disc.``): ``WaeDualGan``. The JAX
    package has no such kind; the names are the port's;
  - ``"exp-decoder"``: ``decoder``, a VoxelDecoder (the decoder's mapping,
    its FC reading the voxels): ``train/state.py::ExpDecoder``;
  - ``"dcgan"``: ``decoder`` and ``discriminator``: ``DcGan``. The
    ablations' cognitive module ``CognitiveVaeGan`` is
    ``"vae-gan-cognitive"`` without the teacher;
  - ``"wae-decoder"``: ``decoder``, a ``WaeDecoder`` (the decoder's mapping
    at 1024 channels), and ``"resnet-encoder"``: ``encoder``, a
    ``ResNetEncoder`` (its compact trunk's ``Conv_0``, ``BatchNorm_0`` and
    ``_ResBlock_0..3`` where the group has them, then ``Dense_0..3`` and
    the head's two BatchNorms), both with no prefix: the state dicts of the
    modules themselves. These kinds are the port's names too.

  It is the port's own copy of the inverse converters of
  ``fmri_tpu/checkpoints/torch_import.py:200-384`` and gives the same
  arrays as that module's ``export_state_dict``. The 180-degree deconv-tap
  rotation happens here (``_inv_deconv``), never in the op.
* :func:`moments_from_jax` maps optimizer moments (trees shaped like the
  params of the groups given, or Adam states of such trees) through the
  same permutations, into the port's per-parameter layout.
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
from fmri_tpu_torch.models.nets import RESNET_FC_HIDDEN
from fmri_tpu_torch.train.optim import AdamState

# prefixes of a train module's .pth that inference does not use
UNUSED_PREFIXES = ("discriminator.", "teacher_net.", "teacher_encoder.", "latent_disc.")


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


def _decoder(group: Mapping, cfg: Config, prefix: str, size0: int | None = None) -> Dict:
    """Decoder, VoxelDecoder (the FC's input width is the kernel's) and, with
    ``size0`` 1024, WaeDecoder."""
    c = cfg.model
    size0 = size0 or c.encoder_channels[-1]
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


def _wae_decoder(group: Mapping, cfg: Config, prefix: str) -> Dict:
    return _decoder(group, cfg, prefix, size0=1024)


def _resnet_encoder(group: Mapping, cfg: Config, prefix: str) -> Dict:
    """ResNetEncoder: Flax names its layers in creation order, so the head's
    BatchNorms are ``BatchNorm_1``/``_2`` after the compact trunk's stem
    and ``BatchNorm_0``/``_1`` over a ``trunk``."""
    p, s = group["params"], group.get("batch_stats")
    out: Dict[str, np.ndarray] = {}
    head_bn = ("BatchNorm_0", "BatchNorm_1")
    if "Conv_0" in p:
        out[f"{prefix}stem.weight"] = _inv_conv(p["Conv_0"]["kernel"])
        _bn(out, f"{prefix}stem_bn", p["BatchNorm_0"], _sub(s, "BatchNorm_0"))
        for i in range(4):
            blk = p[f"_ResBlock_{i}"]
            for j, (conv, bn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"),
                                            ("proj", "proj_bn"))):
                if f"Conv_{j}" in blk:
                    pre = f"{prefix}blocks.{i}."
                    out[pre + conv + ".weight"] = _inv_conv(blk[f"Conv_{j}"]["kernel"])
                    _bn(out, pre + bn, blk[f"BatchNorm_{j}"],
                        _sub(s, f"_ResBlock_{i}", f"BatchNorm_{j}"))
        head_bn = ("BatchNorm_1", "BatchNorm_2")
    for j, name in enumerate(("fc1", "fc2", "fc3_mu", "fc3_logvar")):
        out[f"{prefix}{name}.weight"] = _inv_lin(p[f"Dense_{j}"]["kernel"])
        out[f"{prefix}{name}.bias"] = _f32(p[f"Dense_{j}"]["bias"])
    for name, bn in zip(("bn1", "bn2"), head_bn):
        _bn(out, f"{prefix}{name}", p[bn], _sub(s, bn))
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


def _latent_discriminator(group: Mapping, cfg: Config, prefix: str) -> Dict:
    p = group["params"]
    out: Dict[str, np.ndarray] = {}
    for j, idx in enumerate((0, 2, 4, 6, 8)):
        out[f"{prefix}main.{idx}.weight"] = _inv_lin(p[f"Dense_{j}"]["kernel"])
        out[f"{prefix}main.{idx}.bias"] = _f32(p[f"Dense_{j}"]["bias"])
    return out


_VISUAL = (_visual_encoder, "encoder.")
_COGNITIVE = (_cognitive_encoder, "encoder.")
_DECODER = (_decoder, "decoder.")
_IMAGE_D = (_image_discriminator, "discriminator.")
# {kind: {group: (converter, prefix)}}: the required groups
KINDS = {
    "vae-gan": {"encoder": _VISUAL, "decoder": _DECODER, "discriminator": _IMAGE_D},
    "vae-gan-cognitive": {"encoder": _COGNITIVE, "decoder": _DECODER,
                          "discriminator": _IMAGE_D},
    "vae-gan-cognitive-eval": {"encoder": _COGNITIVE, "decoder": _DECODER},
    # the reference's WaeGan / WaeGanCognitive keep the latent D under
    # "discriminator." (torch_import.py:339-350)
    "wae-gan": {"encoder": _VISUAL, "decoder": _DECODER,
                "latent_disc": (_latent_discriminator, "discriminator.")},
    "wae-gan-cognitive": {"encoder": _COGNITIVE, "decoder": _DECODER,
                          "latent_disc": (_latent_discriminator, "discriminator.")},
    "wae-vgan": {"encoder": _VISUAL, "decoder": _DECODER, "discriminator": _IMAGE_D,
                 "latent_disc": (_latent_discriminator, "latent_disc.")},
    "exp-decoder": {"decoder": _DECODER},
    "dcgan": {"decoder": _DECODER, "discriminator": _IMAGE_D},
    "wae-decoder": {"decoder": (_wae_decoder, "")},
    "resnet-encoder": {"encoder": (_resnet_encoder, "")},
}
# {kind: {group: (converter, prefix, shared prefixes)}}: the optional groups.
# The stage-I teacher of "vae-gan-cognitive" (torch_import.py:372-383) brings
# its visual encoder and teacher_net.* copies of the shared decoder and
# discriminator; the WAE teacher is a module of its own.
OPTIONAL = {
    "vae-gan-cognitive": {"teacher_encoder": (
        _visual_encoder, "teacher_net.encoder.", ("decoder.", "discriminator."))},
    "wae-gan-cognitive": {"teacher_encoder": (_visual_encoder, "teacher_encoder.", ())},
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
    for group, (fn, prefix) in _kind(kind).items():
        if group not in groups:
            raise KeyError(f"kind {kind!r} needs group {group!r}; got {sorted(groups)}")
        sd.update(fn(groups[group], cfg, prefix))
    for group, (fn, prefix, shared) in OPTIONAL.get(kind, {}).items():
        if group in groups:
            sd.update(fn(groups[group], cfg, prefix))
            if shared:
                owner = prefix[:prefix.index(".") + 1]  # "teacher_net."
                sd.update({owner + k: v for k, v in list(sd.items())
                           if k.startswith(shared)})
    return _tensors(sd)


def moments_from_jax(trees: Mapping[str, Any], cfg: Config,
                     kind: str = "vae-gan") -> Dict[str, Any]:
    """Optimizer moments of the groups given -> the port's layout, by the
    same permutations as the weights: a tree shaped like a group's JAX
    params (RMSprop's ``sq_avg``), or an RMSprop state holding one, gives
    ``{parameter name: tensor}``; an Adam state (``mu``, ``nu``, ``count``,
    as the JAX ``AdamState``) gives an
    :class:`~fmri_tpu_torch.train.optim.AdamState`."""
    fns = {g: spec[0] for g, spec in _kind(kind).items()}
    fns.update({g: spec[0] for g, spec in OPTIONAL.get(kind, {}).items()})
    out: Dict[str, Any] = {}
    for group, tree in trees.items():
        if group not in fns:
            raise KeyError(f"kind {kind!r} has no group {group!r}")

        def convert(t):
            return _tensors(fns[group]({"params": t}, cfg, ""))

        if hasattr(tree, "mu") and hasattr(tree, "nu"):
            out[group] = AdamState(convert(tree.mu), convert(tree.nu), torch.tensor(
                int(np.asarray(tree.count)), dtype=torch.int32))
        else:
            out[group] = convert(getattr(tree, "sq_avg", tree))
    return out


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """The ``encoder.*``/``decoder.*`` tensors of a reference-layout
    ``.pth`` of any kind above, for inference (a plain state dict;
    ``weights_only=True`` unpickles nothing else). The prefixes in
    ``UNUSED_PREFIXES`` (the discriminators and teachers) are dropped; any
    other key is kept so a strict load reports it."""
    return {k: v for k, v in load_train_pth(path).items()
            if not k.startswith(UNUSED_PREFIXES)}


def load_train_pth(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a reference-layout ``.pth``, the discriminators and
    teachers included, for a train module's strict load."""
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


def _random_decoder(rng, c, zin: int | None = None, chans: tuple | None = None
                    ) -> Dict[str, Any]:
    """Decoder; VoxelDecoder with ``zin`` the voxels; WaeDecoder with
    ``chans`` (1024, 512, 256, 128)."""
    lat = zin or c.latent_dim
    size0 = c.encoder_channels[-1]
    chans = chans or (size0, size0, c.decoder_channels[1], c.decoder_channels[2])
    flat = c.fc_input * c.fc_input * chans[0]
    bnp, bns = _random_bn(rng, flat)
    dp = {"Dense_0": {"kernel": _uniform(rng, (lat, flat), lat)}, "BatchNorm_0": bnp}
    ds = {"BatchNorm_0": bns}
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


def _random_latent_discriminator(rng, c) -> Dict[str, Any]:
    p, width = {}, c.latent_dim
    for j in range(5):
        out = 1 if j == 4 else c.wae_disc_hidden
        p[f"Dense_{j}"] = {"kernel": _uniform(rng, (width, out), width),
                           "bias": _uniform(rng, (out,), width)}
        width = out
    return {"params": p, "batch_stats": {}}


def _random_resnet_encoder(rng, c) -> Dict[str, Any]:
    """ResNetEncoder with its compact trunk."""
    p, s = {"Conv_0": {"kernel": _uniform(rng, (7, 7, 3, 64), 147)}}, {}
    p["BatchNorm_0"], s["BatchNorm_0"] = _random_bn(rng, 64)
    for i, (cin, cout) in enumerate(((64, 64), (64, 128), (128, 256), (256, 512))):
        bp, bs = {}, {}
        shapes = [(3, 3, cin, cout), (3, 3, cout, cout)] + ([(1, 1, cin, cout)] if i else [])
        for j, shape in enumerate(shapes):
            bp[f"Conv_{j}"] = {"kernel": _uniform(rng, shape, int(np.prod(shape[:3])))}
            bp[f"BatchNorm_{j}"], bs[f"BatchNorm_{j}"] = _random_bn(rng, cout)
        p[f"_ResBlock_{i}"], s[f"_ResBlock_{i}"] = bp, bs
    h1, h2 = RESNET_FC_HIDDEN
    for j, (fan, out) in enumerate(((512, h1), (h1, h2), (h2, c.latent_dim),
                                    (h2, c.latent_dim))):
        p[f"Dense_{j}"] = {"kernel": _uniform(rng, (fan, out), fan),
                           "bias": _uniform(rng, (out,), fan)}
    p["BatchNorm_1"], s["BatchNorm_1"] = _random_bn(rng, h1)
    p["BatchNorm_2"], s["BatchNorm_2"] = _random_bn(rng, h2)
    return {"params": p, "batch_stats": s}


# the kinds whose groups are not the VAE/GAN families' encoder-first set,
# each group drawn in this order
_OTHER_KINDS = {
    "exp-decoder": (("decoder", lambda rng, c: _random_decoder(rng, c, c.num_voxels)),),
    "dcgan": (("decoder", _random_decoder), ("discriminator", _random_image_discriminator)),
    "wae-decoder": (("decoder", lambda rng, c: _random_decoder(
        rng, c, chans=(1024, 512, 256, 128))),),
    "resnet-encoder": (("encoder", _random_resnet_encoder),),
}


def random_groups(cfg: Config, seed: int = 0, kind: str = "vae-gan-cognitive-eval"
                  ) -> Dict[str, Dict[str, Any]]:
    """Seeded numpy groups of ``kind`` in the JAX package's layout and
    naming, with non-trivial BatchNorm statistics, drawn in this order:
    ``encoder`` (visual for ``"vae-gan"``, ``"wae-gan"`` and
    ``"wae-vgan"``, else cognitive), ``decoder``, then ``discriminator``
    (image) for ``"vae-gan"``, ``"vae-gan-cognitive"`` and ``"wae-vgan"``,
    then ``latent_disc`` for the WAE kinds, then ``teacher_encoder``
    (visual) for the two cognitive train kinds. So the groups two kinds
    share come out equal for one seed (the first two of
    ``"vae-gan-cognitive"`` are the eval kind's). The kinds of the
    ablations and backbones draw their own groups (``_OTHER_KINDS``)."""
    _kind(kind)
    c = cfg.model
    rng = np.random.default_rng(seed)
    if kind in _OTHER_KINDS:
        return {g: fn(rng, c) for g, fn in _OTHER_KINDS[kind]}
    visual = kind in ("vae-gan", "wae-gan", "wae-vgan")
    groups = {"encoder": (_random_visual_encoder if visual
                          else _random_cognitive_encoder)(rng, c),
              "decoder": _random_decoder(rng, c)}
    if kind in ("vae-gan", "vae-gan-cognitive", "wae-vgan"):
        groups["discriminator"] = _random_image_discriminator(rng, c)
    if kind.startswith("wae"):
        groups["latent_disc"] = _random_latent_discriminator(rng, c)
    if kind in ("vae-gan-cognitive", "wae-gan-cognitive"):
        groups["teacher_encoder"] = _random_visual_encoder(rng, c)
    return groups
