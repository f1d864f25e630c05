"""Operations and bytes of a WAE/GAN stage-I step's convs, transposed convs
and linears, from the configuration's shapes alone, as ``counts.py`` counts
the Dual-VAE/GAN's: each pass's forward, data grad and weight grad, 2 x
multiply-adds, each input read once and each output written once.

The step's least work (train_wae_stage1.py:259-311). The thesis runs the
encoder twice a batch; the second forward recomputes the first, so the
encoder counts once: its forward and weight grad, and the data grad of
every layer but ``enc.conv0`` (the images are data). ``enc.l_var`` feeds no
loss and counts nothing. The decoder: the forward on mu, the data grad down
to mu and the weight grad. The latent discriminator, phase 1: the forward
over the 2B rows of z_real and z_fake and its weight grad, with the data
grad of every layer but the first (the inputs are detached); phase 2: the
forward over the B rows of mu and the data grad to mu, no weight grad (D is
frozen).
"""

from __future__ import annotations

from typing import Dict, List

from portbench.counts import Layer, Op, _ops, decoder, visual_encoder
from portbench.peaks import PEAK_BY_DTYPE, least_seconds


def latent_disc(m: dict) -> List[Layer]:
    """``WaeDiscriminator``'s five linears (vae_gan.py:499-529)."""
    h = m["wae_disc_hidden"]
    dims = [(m["latent_dim"], h), (h, h), (h, h), (h, h), (h, 1)]
    return [Layer(f"ld.fc{i}", cin * cout, cin, cout, cin * cout)
            for i, (cin, cout) in enumerate(dims)]


def step_ops(m: dict, batch: int) -> List[Op]:
    """The step's conv, transposed-conv and linear work at ``batch`` rows."""
    e = 2 if m.get("compute_dtype") == "bfloat16" else 4
    b = batch
    enc = [L for L in visual_encoder(m) if L.name != "enc.l_var"]
    return (_ops(enc, b, lambda L: 0 if L.name == "enc.conv0" else b, True, e)
            + _ops(decoder(m), b, lambda L: b, True, e)
            + [o._replace(name="p1." + o.name) for o in _ops(
                latent_disc(m), 2 * b, lambda L: 0 if L.name == "ld.fc0" else 2 * b, True, e)]
            + [o._replace(name="p2." + o.name) for o in _ops(
                latent_disc(m), b, lambda L: b, False, e)])


def step_totals(m: dict, batch: int) -> Dict[str, float]:
    """``flops``, ``bytes`` and ``least_s`` (each op's least time, summed) of
    one step at the compute dtype's peak."""
    ops = step_ops(m, batch)
    peak = PEAK_BY_DTYPE[m.get("compute_dtype") or "float32"]
    return {"flops": sum(o.flops for o in ops), "bytes": sum(o.nbytes for o in ops),
            "least_s": sum(least_seconds(o.flops, o.nbytes, peak) for o in ops)}
