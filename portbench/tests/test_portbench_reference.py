"""The plain reference against the program at the tiny widths on the CPU, in
float32: the training cells' first three steps (losses, first gradients,
changes) and the served images; and the reference imports nothing of the
program."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, TINY_MODEL, last_result, run_cell, tiny_bench


@pytest.mark.parametrize("cell", ["train_s1_res64", "train_s2_res64"])
def test_train_steps_match_the_program_in_float32(tmp_path, capsys, cell):
    bench = tiny_bench(tmp_path, cell)
    assert run_cell(bench, cell) == 0
    out = last_result(capsys.readouterr().out)
    assert out["correct"] is True
    for name, check in out["checks"].items():
        assert check["value"] < 1e-4, (name, check)


def test_served_images_match_the_program(tmp_path, capsys):
    bench = tiny_bench(tmp_path, "serve_s3_res100")
    assert run_cell(bench, "serve_s3_res100", seconds=0.5) == 0
    out = last_result(capsys.readouterr().out)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["max_lsb"]["value"] <= 1.0


def test_reference_serving_is_the_eval_module():
    from fmri_tpu_torch.configs.presets import get_config
    from fmri_tpu_torch.eval.steps import VaeGanCognitive

    from portbench import datagen
    from portbench.reference import vaegan as ref

    m = TINY_MODEL
    specs = ref.cognitive_encoder_spec(m) + ref.decoder_spec(m)
    w = datagen.weights(specs, 5, "cpu")
    v = torch.from_numpy(datagen.scans(64, m["num_voxels"], 5, "cpu"))
    ref.calibrate(w, v, m)
    module = VaeGanCognitive(get_config("tiny").model)
    module.load_state_dict(w, strict=True)
    with torch.no_grad():
        want = module.reconstruct(v)
    got = ref.decoder(w, ref.cognitive_encoder(w, v, m, ref.Precision(), train=False)[0], m,
                      ref.Precision(), train=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)
    assert 0.1 < float(got.std()) and float(got.abs().max()) < 0.999  # unsaturated


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.vaegan; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('fmri_tpu')))"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"
    with open(os.path.join(BENCH, "reference", "vaegan.py")) as f:
        assert "fmri_tpu" not in f.read()


def _tiny_steps(n: int, b: int = 4):
    from portbench import datagen

    m = TINY_MODEL
    g = torch.Generator().manual_seed(3)
    imgs = datagen.images(b, m["image_size"], 3, "cpu")
    return [{"x": torch.from_numpy(imgs), "flip": torch.rand(b, generator=g) < 0.5,
             "eps": torch.randn(b, m["latent_dim"], generator=g),
             "z_p": torch.randn(b, m["latent_dim"], generator=g)} for _ in range(n)]


def test_the_reference_trains_its_groups_as_the_judged_gates_say():
    """``follow`` sets which groups train; the reference's own decisions
    and the means behind them are still reported, and ``gate_gap`` reads
    how far the mean nearest a threshold lay from it where they differ."""
    from portbench import datagen, harness
    from portbench.reference import vaegan as ref

    m = TINY_MODEL
    t = {"lambda_mse": 1e-6, "learning_rate": 1e-4, "rms_decay": 0.9, "rms_eps": 1e-8,
         "equilibrium": 0.68, "margin": 0.35}
    specs = ref.visual_encoder_spec(m) + ref.decoder_spec(m) + ref.discriminator_spec(m)
    w0 = datagen.weights(specs, 4, "cpu")
    steps = _tiny_steps(2)
    own = ref.train_steps(1, w0, specs, steps, m, t, ref.Precision())
    one = ref.train_steps(1, w0, specs, steps[:1], m, t, ref.Precision())
    told = [own["gates"][0], (False, False)]
    led = ref.train_steps(1, w0, specs, steps, m, t, ref.Precision(), follow=told)
    assert led["gates"][0] == own["gates"][0] and len(led["means"]) == 2
    for k, v in led["change"].items():
        assert (v == one["change"][k]) is (not k.startswith("encoder.")), k
    th = harness.gate_thresholds(t)
    judged = dict(led, gates=[(not d, not s) for d, s in led["gates"]])
    means = led["means"]
    assert harness.train_numbers(judged, led, th)["gate_gap"] == pytest.approx(
        max(min(abs(v - x) / x for v in ms for x in th) for ms in means))
    assert harness.train_numbers(led, led, th)["gate_gap"] == 0.0


def test_the_control_precision_is_one_below_the_configurations():
    from portbench.reference import vaegan as ref

    assert ref.control_precision({"compute_dtype": "bfloat16"}).kind == "float8"
    with pytest.raises(ValueError):
        ref.control_precision({"compute_dtype": None})
