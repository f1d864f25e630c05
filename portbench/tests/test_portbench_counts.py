"""The operation and byte counts against hand counts at the tiny widths."""

from __future__ import annotations

import pytest

from conftest import TINY_MODEL
from portbench import counts
from portbench.peaks import PEAK_FP32_FLOPS, least_seconds


def test_layers_by_hand():
    m = TINY_MODEL
    enc = {L.name: L for L in counts.visual_encoder(m)}
    # 16 px -> 8 -> 4 -> 2; conv0 3->8 at 8x8 out, 5x5 taps
    assert enc["enc.conv0"].macs == 8 * 8 * 8 * 3 * 25
    assert enc["enc.conv2"].y == 2 * 2 * 16 and enc["enc.fc"].macs == 64 * 32
    dec = {L.name: L for L in counts.decoder(m)}
    # FC 16 -> 2*2*16, deconvs 2 -> 4 -> 8 -> 16, out conv 8 -> 3 at 16x16
    assert dec["dec.fc"].macs == 16 * 64
    assert dec["dec.deconv0"].macs == 2 * 2 * 16 * 16 * 25 and dec["dec.deconv0"].y == 4 * 4 * 16
    assert dec["dec.out"].macs == 16 * 16 * 3 * 8 * 25
    dis = {L.name: L for L in counts.discriminator(m)}
    assert dis["dis.conv0"].macs == 16 * 16 * 8 * 3 * 25 and dis["dis.fc3"].macs == 32
    cog = {L.name: L for L in counts.cognitive_encoder(m)}
    assert cog["cog.fc1"].macs == 128 * 32


def test_stage1_step_by_hand():
    m, b = TINY_MODEL, 8
    enc = sum(L.macs for L in counts.visual_encoder(m))
    dec = sum(L.macs for L in counts.decoder(m))
    dis = sum(L.macs for L in counts.discriminator(m))
    conv0 = 8 * 8 * 8 * 3 * 25
    dec_fc, dis0 = 16 * 64, 16 * 16 * 8 * 3 * 25
    macs = (b * (3 * enc - conv0) + b * 3 * dec + b * (3 * dec - dec_fc)
            + 3 * b * 3 * dis - b * dis0)
    assert counts.step_totals(m, 1, b)["flops"] == pytest.approx(2 * macs)


def test_stage2_step_by_hand():
    m, b = TINY_MODEL, 8
    cog = sum(L.macs for L in counts.cognitive_encoder(m))
    enc = sum(L.macs for L in counts.visual_encoder(m))
    dec = sum(L.macs for L in counts.decoder(m))
    dis = sum(L.macs for L in counts.discriminator(m))
    dis0 = 16 * 16 * 8 * 3 * 25
    macs = (b * (3 * cog - 128 * 32) + b * 2 * dec + b * enc + 2 * b * dec
            + 3 * b * 3 * dis - 2 * b * dis0)
    assert counts.step_totals(m, 2, b)["flops"] == pytest.approx(2 * macs)


def test_bytes_and_least_time_by_hand():
    m = dict(TINY_MODEL, compute_dtype="float32")
    op = [o for o in counts.step_ops(m, 1, 8) if o.name == "enc.conv0.fwd"][0]
    x, y, w = 16 * 16 * 3, 8 * 8 * 8, 8 * 3 * 25
    assert op.nbytes == 4 * (8 * (x + y) + w)
    bf = [o for o in counts.step_ops(dict(m, compute_dtype="bfloat16"), 1, 8)
          if o.name == "enc.conv0.fwd"][0]
    assert bf.nbytes == op.nbytes / 2 and bf.flops == op.flops
    assert least_seconds(op.flops, op.nbytes, PEAK_FP32_FLOPS) == max(
        op.flops / 67e12, op.nbytes / 3.35e12)
