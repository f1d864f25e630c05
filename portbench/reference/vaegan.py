"""Plain PyTorch reference of the Dual-VAE/GAN of
github.com/MariaPdg/thesis-fmri-reconstruction (``models/vae_gan.py``,
``train_vgan_stage1.py``, ``train_vgan_stage2.py``): the nets, the loss
terms, the equilibrium gate and RMSprop, written from the thesis with
``torch.nn.functional`` calls on a flat dict of tensors keyed as the
thesis's state dicts (``encoder.conv.0.conv.weight``, ...).

It imports nothing of the program under test. Its precision is a
:class:`Precision`: ``"float32"`` (the reference: TF32 off) or the one below
a configuration's (:func:`control_precision`), which rounds every conv and
matmul operand, output and gradient as a program computing in it would: the
control that the comparison has to refuse.

Layouts: images are NHWC at the boundary, NCHW inside; a conv weight is
OIHW, a transposed conv's IOHW, a linear's [out, in]; a flatten is
C-major, as the thesis's ``view(B, -1)``. BatchNorm: eps 1e-5, batch
statistics with the biased variance in train mode, running statistics in
eval mode.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LOG_EPS = 1e-3  # inside the GAN logs (vae_gan.py:316-318)
FP8_MAX = 448.0  # largest float8_e4m3fn


def _round(t: torch.Tensor, kind: str) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _Rounded(torch.autograd.Function):
    """Rounds the value going forward and the gradient coming back."""

    @staticmethod
    def forward(ctx, t, kind):
        ctx.kind = kind
        return _round(t, kind)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.kind), None


class Precision:
    """Where the conv and matmul operands, outputs and gradients are rounded:
    nowhere for ``"float32"``; to ``"float8"`` (e4m3 with one scale per
    tensor)."""

    KINDS = ("float32", "float8")

    def __init__(self, kind: str = "float32"):
        if kind not in self.KINDS:
            raise ValueError(f"precision must be one of {self.KINDS}, got {kind!r}")
        self.kind = kind

    def r(self, t):
        if t is None or self.kind == "float32":
            return t
        return _Rounded.apply(t, self.kind)

    def conv(self, x, w, stride, padding):
        return self.r(F.conv2d(self.r(x), self.r(w), stride=stride, padding=padding))

    def deconv(self, x, w, stride, padding, output_padding):
        return self.r(F.conv_transpose2d(self.r(x), self.r(w), stride=stride,
                                         padding=padding, output_padding=output_padding))

    def linear(self, x, w, b=None):
        return self.r(F.linear(self.r(x), self.r(w), self.r(b)))


# the precision one step below each compute dtype a configuration states
CONTROL = {"bfloat16": "float8"}


def control_precision(m: dict) -> Precision:
    """The control's precision: one step below the model's ``compute_dtype``."""
    dtype = m.get("compute_dtype")
    if dtype not in CONTROL:
        raise ValueError(f"no control precision below compute_dtype {dtype!r}")
    return Precision(CONTROL[dtype])


# ----------------------------- the shapes -----------------------------


def _bn(prefix: str, c: int) -> List[Tuple[str, tuple, str]]:
    return [(prefix + "weight", (c,), "bn_weight"), (prefix + "bias", (c,), "bn_bias"),
            (prefix + "running_mean", (c,), "running_mean"),
            (prefix + "running_var", (c,), "running_var"),
            (prefix + "num_batches_tracked", (), "count")]


def _lin(prefix: str, cin: int, cout: int, bias: bool) -> List[Tuple[str, tuple, str]]:
    out = [(prefix + "weight", (cout, cin), "linear")]
    return out + ([(prefix + "bias", (cout,), "bias")] if bias else [])


def visual_encoder_spec(m: dict, p: str = "encoder.") -> List[Tuple[str, tuple, str]]:
    k, ch = m["kernel_size"], (3, *m["encoder_channels"])
    out = []
    for i in range(len(ch) - 1):
        out.append((f"{p}conv.{i}.conv.weight", (ch[i + 1], ch[i], k, k), "conv"))
        out += _bn(f"{p}conv.{i}.bn.", ch[i + 1])
    flat = m["fc_input"] ** 2 * ch[-1]
    out += _lin(f"{p}fc.0.", flat, m["fc_output"], False) + _bn(f"{p}fc.1.", m["fc_output"])
    out += _lin(f"{p}l_mu.", m["fc_output"], m["latent_dim"], True)
    out += _lin(f"{p}l_var.", m["fc_output"], m["latent_dim"], True)
    return out


def cognitive_encoder_spec(m: dict, p: str = "encoder.") -> List[Tuple[str, tuple, str]]:
    h = m["cog_hidden"]
    out = _lin(f"{p}fc1.0.", m["num_voxels"], h, False) + _bn(f"{p}fc1.1.", h)
    out += _lin(f"{p}l_mu.", h, m["latent_dim"], True)
    return out + _lin(f"{p}l_var.", h, m["latent_dim"], True)


def _decoder_chans(m: dict) -> tuple:
    s0, dc = m["encoder_channels"][-1], m["decoder_channels"]
    return (s0, s0, dc[1], dc[2])


def decoder_spec(m: dict, p: str = "decoder.") -> List[Tuple[str, tuple, str]]:
    k, ch = m["kernel_size"], _decoder_chans(m)
    flat = m["fc_input"] ** 2 * ch[0]
    out = _lin(f"{p}fc.0.", m["latent_dim"], flat, False) + _bn(f"{p}fc.1.", flat)
    for i in range(3):
        out.append((f"{p}conv.{i}.conv.weight", (ch[i], ch[i + 1], k, k), "deconv"))
        out += _bn(f"{p}conv.{i}.bn.", ch[i + 1])
    out.append((f"{p}conv.3.0.weight", (m["decoder_channels"][3], ch[3], 5, 5), "conv"))
    return out + [(f"{p}conv.3.0.bias", (m["decoder_channels"][3],), "bias")]


def discriminator_spec(m: dict, p: str = "discriminator.") -> List[Tuple[str, tuple, str]]:
    ch = m["discrim_channels"]
    out = [(f"{p}conv.0.0.weight", (ch[0], 3, 5, 5), "conv"), (f"{p}conv.0.0.bias", (ch[0],), "bias")]
    for i in range(1, len(ch)):
        out.append((f"{p}conv.{i}.conv.weight", (ch[i], ch[i - 1], m["kernel_size"],
                                                 m["kernel_size"]), "conv"))
        out += _bn(f"{p}conv.{i}.bn.", ch[i])
    flat = m["fc_input_gan"] ** 2 * ch[-1]
    out += _lin(f"{p}fc.0.", flat, m["fc_output_gan"], False) + _bn(f"{p}fc.1.", m["fc_output_gan"])
    return out + _lin(f"{p}fc.3.", m["fc_output_gan"], 1, True)


def is_parameter(kind: str) -> bool:
    return kind not in ("running_mean", "running_var", "count")


# ----------------------------- the nets -----------------------------


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def batch_norm(x, w, p: str, train: bool):
    """Train mode: the batch's statistics over every axis but 1 (biased
    variance); eval mode: the running statistics."""
    if train:
        dims = [0] + list(range(2, x.dim()))
        mean = x.mean(dim=dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
        if "_record" in w:  # calibration: the batch's statistics become the running ones
            w["_record"][p] = (mean.reshape(-1), var.reshape(-1))
    else:
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean = w[p + "running_mean"].view(shape)
        var = w[p + "running_var"].view(shape)
    shape = [1, -1] + [1] * (x.dim() - 2)
    return (x - mean) / torch.sqrt(var + BN_EPS) * w[p + "weight"].view(shape) \
        + w[p + "bias"].view(shape)


def visual_encoder(w, x, m, P: Precision, train: bool = True, p: str = "encoder."):
    """NHWC image in [-1, 1] -> (mu, logvar) (vae_gan.py:63-96)."""
    x = _nchw(x)
    for i in range(len(m["encoder_channels"])):
        x = P.conv(x, w[f"{p}conv.{i}.conv.weight"], m["stride"], m["padding"])
        x = torch.relu(batch_norm(x, w, f"{p}conv.{i}.bn.", train))
    x = P.linear(x.reshape(x.shape[0], -1), w[f"{p}fc.0.weight"])
    x = torch.relu(batch_norm(x, w, f"{p}fc.1.", train))
    return (P.linear(x, w[f"{p}l_mu.weight"], w[f"{p}l_mu.bias"]),
            P.linear(x, w[f"{p}l_var.weight"], w[f"{p}l_var.bias"]))


def cognitive_encoder(w, v, m, P: Precision, train: bool = True, p: str = "encoder."):
    """fMRI voxels [B, V] -> (mu, logvar) (vae_gan.py:190-232)."""
    x = P.linear(v, w[f"{p}fc1.0.weight"])
    x = torch.relu(batch_norm(x, w, f"{p}fc1.1.", train))
    return (P.linear(x, w[f"{p}l_mu.weight"], w[f"{p}l_mu.bias"]),
            P.linear(x, w[f"{p}l_var.weight"], w[f"{p}l_var.bias"]))


def decoder(w, z, m, P: Precision, train: bool = True, p: str = "decoder."):
    """Latent -> NHWC image in [-1, 1] (vae_gan.py:99-132): FC + BN + ReLU,
    three transposed convs + BN + ReLU, a 5x5 conv with bias, tanh."""
    ch = _decoder_chans(m)
    x = P.linear(z, w[f"{p}fc.0.weight"])
    x = torch.relu(batch_norm(x, w, f"{p}fc.1.", train))
    x = x.reshape(x.shape[0], ch[0], m["fc_input"], m["fc_input"])
    for i in range(3):
        x = P.deconv(x, w[f"{p}conv.{i}.conv.weight"], m["stride"], m["padding"],
                     1 if m["output_pad_dec"][i] else 0)
        x = torch.relu(batch_norm(x, w, f"{p}conv.{i}.bn.", train))
    x = P.conv(x, w[f"{p}conv.3.0.weight"], 1, 2) + w[f"{p}conv.3.0.bias"].view(1, -1, 1, 1)
    return torch.tanh(x).permute(0, 2, 3, 1)


def discriminator(w, x, m, P: Precision, p: str = "discriminator."):
    """NHWC images -> (features, score) (vae_gan.py:135-187), train mode:
    ``features`` is the pre-BN output of block ``recon_level``, flattened."""
    x = P.conv(_nchw(x), w[f"{p}conv.0.0.weight"], m["stride_gan"], 2)
    x = torch.relu(x + w[f"{p}conv.0.0.bias"].view(1, -1, 1, 1))
    feats = None
    for i in range(1, len(m["discrim_channels"])):
        pre = P.conv(x, w[f"{p}conv.{i}.conv.weight"], m["stride"], m["padding"])
        if i == m["recon_level"]:
            feats = pre.reshape(pre.shape[0], -1)
        x = torch.relu(batch_norm(pre, w, f"{p}conv.{i}.bn.", True))
    x = P.linear(x.reshape(x.shape[0], -1), w[f"{p}fc.0.weight"])
    x = torch.relu(batch_norm(x, w, f"{p}fc.1.", True))
    return feats, torch.sigmoid(P.linear(x, w[f"{p}fc.3.weight"], w[f"{p}fc.3.bias"]))


# ----------------------------- the losses -----------------------------


def head_losses(x, x_tilde, feats, score, mu, lv, lam):
    """The 'vae-gan' losses (vae_gan.py:302-320, train_vgan_stage1.py:359-387)
    over the discriminator's pass on [x, x_tilde, x_p]: the encoder's
    KL + feature matching, the discriminator's three BCE terms, the
    decoder's lam * feature matching - (1 - lam) * the discriminator's, the
    reconstruction sum; and the gate's two means."""
    b = x.shape[0]
    nle = 0.5 * (x.reshape(b, -1) - x_tilde.reshape(b, -1)) ** 2
    kld = -0.5 * torch.sum(-torch.exp(lv) - mu ** 2 + lv + 1.0, dim=1)
    mse = torch.sum(0.5 * (feats[:b] - feats[b:2 * b]) ** 2, dim=1)
    s = score.reshape(-1)
    bce_orig = -torch.log(s[:b] + LOG_EPS)
    bce_pred = -torch.log(1.0 - s[b:2 * b] + LOG_EPS)
    bce_samp = -torch.log(1.0 - s[2 * b:] + LOG_EPS)
    loss_dis = bce_orig.sum() + bce_pred.sum() + bce_samp.sum()
    return {"encoder": kld.sum() + mse.sum(),
            "decoder": (lam * mse).sum() - (1.0 - lam) * loss_dis,
            "discriminator": loss_dis,
            "reconstruction": nle.sum()}, (bce_orig.mean(), bce_pred.mean())


def gates(means, equilibrium: float, margin: float) -> Tuple[bool, bool]:
    """(train decoder, train discriminator) of the equilibrium game
    (train_vgan_stage1.py:396-404): both when both would be off."""
    m_orig, m_pred = means
    dis = not (m_orig < equilibrium - margin or m_pred < equilibrium - margin)
    dec = not (m_orig > equilibrium + margin or m_pred > equilibrium + margin)
    if not dis and not dec:
        return True, True
    return dec, dis


# ----------------------------- the input half -----------------------------


def augment(x_uint8, flip=None, shifts=None, mean=(0.5,) * 3, std=(0.5,) * 3):
    """uint8 NHWC -> [0, 1] -> optional horizontal flip where ``flip`` [B] is
    set -> optional integer shift by ``shifts`` [B, 2] = (dy, dx) with
    nearest-edge fill -> per-channel (x - mean) / std."""
    x = x_uint8.float() / 255.0
    if flip is not None:
        x = torch.where(flip.view(-1, 1, 1, 1), x.flip(2), x)
    if shifts is not None:
        b, h, wd = x.shape[:3]
        rows = (torch.arange(h, device=x.device) - shifts[:, :1]).clamp(0, h - 1)
        cols = (torch.arange(wd, device=x.device) - shifts[:, 1:]).clamp(0, wd - 1)
        x = x[torch.arange(b, device=x.device).view(-1, 1, 1), rows[:, :, None],
              cols[:, None, :]]
    mean = torch.tensor(mean, device=x.device)
    std = torch.tensor(std, device=x.device)
    return (x - mean) / std


def to_uint8_image(y):
    """A tanh image in [-1, 1] -> uint8 in [0, 255]: x * 0.5 + 0.5, clipped,
    x * 255 + 0.5 truncated."""
    return ((y * 0.5 + 0.5).clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


# ----------------------------- a train step -----------------------------


def rmsprop(w: Dict[str, torch.Tensor], sq: Dict[str, torch.Tensor],
            grads: Dict[str, torch.Tensor], lr: float, decay: float, eps: float) -> None:
    """torch's RMSprop (train_vgan_stage1.py:275-283), in place."""
    for k, g in grads.items():
        sq[k] = decay * sq[k] + (1.0 - decay) * g * g
        w[k] = w[k] - lr * g / (torch.sqrt(sq[k]) + eps)


def stage1_forward(w, x, eps, z_p, m, P: Precision, lam: float):
    """The stage-I VAE/GAN forward on normalized NHWC images ``x``."""
    mu, lv = visual_encoder(w, x, m, P)
    z = mu + eps * torch.exp(0.5 * lv)
    x_tilde = decoder(w, z, m, P)
    x_p = decoder(w, z_p, m, P)
    feats, score = discriminator(w, torch.cat([x, x_tilde, x_p]), m, P)
    return head_losses(x, x_tilde, feats, score, mu, lv, lam)


def stage2_forward(w, fmri, image, eps, eps_t, z_p, m, P: Precision, lam: float):
    """The stage-II forward (train_vgan_stage2.py): the cognitive encoder and
    the frozen decoder, whose reconstruction of the frozen teacher's latent
    of ``image`` is the discriminator's real input; every net in train mode."""
    mu, lv = cognitive_encoder(w, fmri, m, P)
    x_tilde = decoder(w, mu + eps * torch.exp(0.5 * lv), m, P)
    with torch.no_grad():
        mu_t, lv_t = visual_encoder(w, image, m, P, p="teacher_net.encoder.")
        gt_x = decoder(w, mu_t + eps_t * torch.exp(0.5 * lv_t), m, P)
        x_p = decoder(w, z_p, m, P)
    feats, score = discriminator(w, torch.cat([gt_x, x_tilde, x_p]), m, P)
    return head_losses(gt_x, x_tilde, feats, score, mu, lv, lam)


# the groups each stage trains, their gradient clamp (None: none), and the
# losses that train them (train_vgan_stage1.py:396-432, train_vgan_stage2.py:328-329)
STAGES = {1: (("encoder", "decoder", "discriminator"), None),
          2: (("encoder", "discriminator"), 1.0)}


def train_steps(stage: int, w0: Dict[str, torch.Tensor], specs, steps, m: dict, t: dict,
                P: Precision, follow: Optional[List[Tuple[bool, bool]]] = None):
    """Run ``len(steps)`` train steps of ``stage`` from the weights ``w0``
    (``specs``: (key, shape, kind) of every tensor) and zero moments.
    ``steps`` holds each step's inputs: ``x`` (uint8 NHWC), ``flip`` or
    ``shifts``, ``eps``, ``z_p`` (stage 2: also ``fmri``, ``eps_t``).
    ``follow``: the gate decisions (decoder, discriminator) of the side
    under judgement, step by step; the groups train as they say, as a
    served model's reference follows the tokens it judges. Returns
    ``{"losses": [{head: loss}] per step, "gates": [(dec, dis)] as this
    side's own game decides them, "means": [(bce real, bce fake)] that
    decide them, "grad1": {key: |g|} of step 1 as RMSprop takes it,
    "change": {key: |w - w0|} after the last step}`` over the trained
    parameters."""
    exact_fp32()
    groups, clip = STAGES[stage]
    keys = [k for k, _, kind in specs if is_parameter(kind) and k.split(".")[0] in groups]
    w = dict(w0)
    sq = {k: torch.zeros_like(w0[k]) for k in keys}
    out = {"losses": [], "gates": [], "means": [], "grad1": {}, "change": {}}
    lam, lr = t["lambda_mse"], t["learning_rate"]
    for i, s in enumerate(steps):
        live = {k: w[k].detach().clone().requires_grad_() for k in keys}
        wi = dict(w, **live)
        x = augment(s["x"], s.get("flip"), s.get("shifts"))
        if stage == 1:
            losses, means = stage1_forward(wi, x, s["eps"], s["z_p"], m, P, lam)
            means = tuple(float(v.detach()) for v in means)
            dec, dis = gates(means, t["equilibrium"], t["margin"])
            on_dec, on_dis = (dec, dis) if follow is None else follow[i]
            on = {"encoder": True, "decoder": on_dec, "discriminator": on_dis}
        else:
            losses, means = stage2_forward(wi, s["fmri"], x, s["eps"], s["eps_t"], s["z_p"],
                                           m, P, lam)
            means = tuple(float(v.detach()) for v in means)
            dec, dis = False, True
            on = {"encoder": True, "discriminator": True}
        grads = {}
        for j, g in enumerate(groups):
            mine = [k for k in keys if k.startswith(g + ".")]
            for k, d in zip(mine, torch.autograd.grad(losses[g], [live[k] for k in mine],
                                                      retain_graph=j < len(groups) - 1)):
                grads[k] = d if clip is None else d.clamp(-clip, clip)
        applied = {k: v for k, v in grads.items() if on[k.split(".")[0]]}
        if i == 0:
            out["grad1"] = {k: float(torch.linalg.vector_norm(applied[k]))
                            if k in applied else 0.0 for k in keys}
        w = {k: v.detach() for k, v in w.items()}
        rmsprop(w, sq, applied, lr, t["rms_decay"], t["rms_eps"])
        b = s["eps"].shape[0]
        out["losses"].append({h: float(v.detach()) / b for h, v in losses.items()})
        out["gates"].append((dec, dis))
        out["means"].append(means)
    out["change"] = {k: float(torch.linalg.vector_norm(w[k] - w0[k])) for k in keys}
    return out


def exact_fp32() -> None:
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def calibrate(w: Dict[str, torch.Tensor], v: torch.Tensor, m: dict) -> None:
    """Running statistics for the cognitive encoder and the decoder, in place:
    each BatchNorm's batch statistics on the scans ``v`` in float32, so that
    eval mode normalizes as train mode did on them and the images stay
    inside (0, 255)."""
    exact_fp32()
    w["_record"] = {}
    P = Precision("float32")
    decoder(w, cognitive_encoder(w, v, m, P)[0], m, P)
    for p, (mean, var) in w.pop("_record").items():
        w[p + "running_mean"].copy_(mean)
        w[p + "running_var"].copy_(var)


@torch.no_grad()
def serve_images(w: Dict[str, torch.Tensor], v: torch.Tensor, m: dict, P: Precision):
    """The served stage-III model in eval mode (vae_gan.py:397-402): scans ->
    z = mu of the cognitive encoder -> the decoder -> uint8 NHWC images."""
    exact_fp32()
    return to_uint8_image(decoder(w, cognitive_encoder(w, v, m, P, train=False)[0], m, P,
                                  train=False))
