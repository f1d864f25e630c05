"""Operations and bytes of a train step's convs, transposed convs and
linears, from the configuration's shapes alone.

Each layer pass counts its forward, and where the step needs them its
data grad (the gradient to its input) and its weight grad, each
2 x multiply-adds, with each input read once and each output written
once in the compute dtype. This is the model's work with no recompute:
what any program of the thesis's step has to do at least, so a share of
a roofline or of the peak taken from it cannot pass 100% unless the time
leaves out part of the work.

Which passes need which grads (train_vgan_stage1.py, train_vgan_stage2.py):
stage I trains the visual encoder (no data grad of its first conv: the
images are data), the decoder on z (a data grad down to z, which the
encoder's gradient needs) and on the prior draws (none at the FC), and the
discriminator over the 3B concat (its first conv's data grad only for the
2B generated rows). Stage II trains the cognitive encoder (no data grad of
``fc1``) and the discriminator (its first conv's data grad for the B rows of
x_tilde); the frozen decoder's pass on z needs data grads only, the teacher
and the other two decodes run forward only.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

from portbench.peaks import PEAK_BY_DTYPE, least_seconds


class Op(NamedTuple):
    name: str
    flops: float
    nbytes: float


def _conv_out(h: int, k: int, s: int, p: int) -> int:
    return (h + 2 * p - k) // s + 1


class Layer(NamedTuple):
    name: str
    macs: int      # per row
    x: int         # input elements per row
    y: int         # output elements per row
    w: int         # weight elements


def visual_encoder(m: dict) -> List[Layer]:
    k, s, p = m["kernel_size"], m["stride"], m["padding"]
    h, ch, out = m["image_size"], (3, *m["encoder_channels"]), []
    for i in range(len(ch) - 1):
        ho = _conv_out(h, k, s, p)
        out.append(Layer(f"enc.conv{i}", ho * ho * ch[i + 1] * ch[i] * k * k,
                         h * h * ch[i], ho * ho * ch[i + 1], ch[i + 1] * ch[i] * k * k))
        h = ho
    flat, fo, lat = h * h * ch[-1], m["fc_output"], m["latent_dim"]
    return out + [Layer("enc.fc", flat * fo, flat, fo, flat * fo),
                  Layer("enc.l_mu", fo * lat, fo, lat, fo * lat),
                  Layer("enc.l_var", fo * lat, fo, lat, fo * lat)]


def cognitive_encoder(m: dict) -> List[Layer]:
    v, hd, lat = m["num_voxels"], m["cog_hidden"], m["latent_dim"]
    return [Layer("cog.fc1", v * hd, v, hd, v * hd),
            Layer("cog.l_mu", hd * lat, hd, lat, hd * lat),
            Layer("cog.l_var", hd * lat, hd, lat, hd * lat)]


def decoder(m: dict) -> List[Layer]:
    k, s, p = m["kernel_size"], m["stride"], m["padding"]
    s0, dc = m["encoder_channels"][-1], m["decoder_channels"]
    ch = (s0, s0, dc[1], dc[2])
    h, lat = m["fc_input"], m["latent_dim"]
    flat = h * h * ch[0]
    out = [Layer("dec.fc", lat * flat, lat, flat, lat * flat)]
    for i in range(3):
        ho = (h - 1) * s - 2 * p + k + (1 if m["output_pad_dec"][i] else 0)
        out.append(Layer(f"dec.deconv{i}", h * h * ch[i] * ch[i + 1] * k * k,
                         h * h * ch[i], ho * ho * ch[i + 1], ch[i] * ch[i + 1] * k * k))
        h = ho
    out.append(Layer("dec.out", h * h * dc[3] * ch[3] * 25, h * h * ch[3], h * h * dc[3],
                     dc[3] * ch[3] * 25))
    return out


def discriminator(m: dict) -> List[Layer]:
    k, s, p = m["kernel_size"], m["stride"], m["padding"]
    ch, h = m["discrim_channels"], m["image_size"]
    ho = _conv_out(h, 5, m["stride_gan"], 2)
    out = [Layer("dis.conv0", ho * ho * ch[0] * 3 * 25, h * h * 3, ho * ho * ch[0], ch[0] * 75)]
    h = ho
    for i in range(1, len(ch)):
        ho = _conv_out(h, k, s, p)
        out.append(Layer(f"dis.conv{i}", ho * ho * ch[i] * ch[i - 1] * k * k,
                         h * h * ch[i - 1], ho * ho * ch[i], ch[i] * ch[i - 1] * k * k))
        h = ho
    flat, fo = h * h * ch[-1], m["fc_output_gan"]
    return out + [Layer("dis.fc", flat * fo, flat, fo, flat * fo),
                  Layer("dis.fc3", fo, fo, 1, fo)]


def _ops(layers: List[Layer], rows: int, dgrad, wgrad: bool, e: int) -> List[Op]:
    """The forward of every layer over ``rows``; the data grad where
    ``dgrad(layer)`` gives its rows (0: none); the weight grad if ``wgrad``."""
    out = []
    for L in layers:
        out.append(Op(L.name + ".fwd", 2.0 * L.macs * rows, e * (rows * (L.x + L.y) + L.w)))
        n = dgrad(L)
        if n:
            out.append(Op(L.name + ".dgrad", 2.0 * L.macs * n, e * (n * (L.x + L.y) + L.w)))
        if wgrad:
            out.append(Op(L.name + ".wgrad", 2.0 * L.macs * rows, e * (rows * (L.x + L.y) + L.w)))
    return out


def step_ops(m: dict, stage: int, batch: int) -> List[Op]:
    """The step's conv, transposed-conv and linear work at ``batch`` rows."""
    e = 2 if m.get("compute_dtype") == "bfloat16" else 4
    b = batch
    if stage == 1:
        return (_ops(visual_encoder(m), b, lambda L: 0 if L.name == "enc.conv0" else b, True, e)
                + _ops(decoder(m), b, lambda L: b, True, e)
                + _ops(decoder(m), b, lambda L: 0 if L.name == "dec.fc" else b, True, e)
                + _ops(discriminator(m), 3 * b,
                       lambda L: 2 * b if L.name == "dis.conv0" else 3 * b, True, e))
    if stage == 2:
        return (_ops(cognitive_encoder(m), b, lambda L: 0 if L.name == "cog.fc1" else b, True, e)
                + _ops(decoder(m), b, lambda L: b, False, e)
                + _ops(visual_encoder(m), b, lambda L: 0, False, e)
                + _ops(decoder(m), 2 * b, lambda L: 0, False, e)
                + _ops(discriminator(m), 3 * b,
                       lambda L: b if L.name == "dis.conv0" else 3 * b, True, e))
    raise ValueError(f"no counts for stage {stage}")


def step_totals(m: dict, stage: int, batch: int) -> Dict[str, float]:
    """``flops``, ``bytes`` and ``least_s`` (each op's least time, summed) of
    one step at the compute dtype's peak."""
    ops = step_ops(m, stage, batch)
    peak = PEAK_BY_DTYPE[m.get("compute_dtype") or "float32"]
    return {"flops": sum(o.flops for o in ops), "bytes": sum(o.nbytes for o in ops),
            "least_s": sum(least_seconds(o.flops, o.nbytes, peak) for o in ops)}
