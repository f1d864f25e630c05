"""The port's inference slice against the JAX package on the CPU: data and
transforms, reconstruction + metrics + n-way identification on tiny
synthetic pairs, serving, the inference CLI, import hygiene, and
``chip_smoke.py`` refusing to run without a card.

Inputs and weights are made with numpy from a seed and handed to both
packages. Tolerances: reconstructions and metrics 1e-5 (fp32 both sides,
different summation orders); n-way fractions equal or within 1/N (a pair
whose two scores tie to float rounding may rank either way); served uint8
images within 1 LSB (a float at a rounding boundary may round either way)."""

import ast
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_state, port_model

from fmri_tpu.checkpoints.torch_import import export_state_dict
from fmri_tpu.configs import get_config as jax_config
from fmri_tpu.data.packed import save_packed
from fmri_tpu.data.synthetic import synthetic_pairs as jax_pairs
from fmri_tpu.data.transforms import resize_batch as jax_resize
from fmri_tpu.eval import evaluate as jax_eval
from fmri_tpu.eval.serve import ServingModel as JaxServingModel
from fmri_tpu.models.nets import ImageDiscriminator
from fmri_tpu.train.steps_vgan import make_vgan_cognitive_step
from fmri_tpu_torch.checkpoints.convert import random_groups
from fmri_tpu_torch.configs import get_config
from fmri_tpu_torch.data import transforms
from fmri_tpu_torch.data.packed import open_packed
from fmri_tpu_torch.data.synthetic import synthetic_pairs
from fmri_tpu_torch.device import resolve_device
from fmri_tpu_torch.eval import evaluate, inference
from fmri_tpu_torch.eval.serve import ServingModel, batch_buckets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BS = 32, 8


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny")
    groups = random_groups(cfg, seed=3)
    data = synthetic_pairs(N, cfg.data.image_size, cfg.model.num_voxels, seed=0)
    return cfg, groups, data


def _batches(data, n=N):
    return [{k: v[lo:lo + BS] for k, v in data.items()} for lo in range(0, n, BS)]


def _jax_eval(groups, data, n=N):
    """The JAX package's stage-3 eval over the first n pairs."""
    jcfg = jax_config("tiny")
    step = make_vgan_cognitive_step(jcfg, 3, donate=False).eval_step
    return jax_eval.reconstruct_dataset(step, jax_state(groups), _batches(data, n))


def test_synthetic_data_matches_jax():
    got = synthetic_pairs(12, 16, 40, seed=5)
    ref = jax_pairs(12, 16, 40, seed=5)
    for k in ("fmri", "image"):
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("size", [32, 200])
def test_resize_matches_jax_upsampling(size):
    x = np.random.default_rng(size).uniform(size=(2, 16, 16, 3)).astype(np.float32)
    got = transforms.resize_batch(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_resize(jnp.asarray(x), size)),
                               atol=1e-5)


def test_eval_preprocess_and_packed_reader(tmp_path):
    data = jax_pairs(10, 16, 20, seed=1)
    save_packed(str(tmp_path), data)
    arrays = open_packed(str(tmp_path))
    assert arrays["image"].dtype == np.uint8
    np.testing.assert_array_equal(arrays["fmri"], data["fmri"])
    img = transforms.eval_preprocess(torch.from_numpy(np.array(arrays["image"])))
    np.testing.assert_allclose(transforms.denormalize(img, (0.5,) * 3, (0.5,) * 3),
                               data["image"], atol=0.5 / 255 + 1e-6)


def test_reconstruction_metrics_and_objective_match_jax(tiny):
    cfg, groups, data = tiny
    ref_r, ref_t = _jax_eval(groups, data)
    model = port_model(groups, cfg)
    recons, targets = evaluate.reconstruct_dataset(model, _batches(data))
    np.testing.assert_allclose(recons.numpy(), ref_r, atol=1e-5)
    np.testing.assert_array_equal(targets.numpy(), ref_t)

    got = evaluate.quality_metrics(recons, targets, with_is=False)
    ref = jax_eval.quality_metrics(ref_r, ref_t, with_is=False)
    assert set(got) == set(ref) == {"pcc", "ssim", "mse"}
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-5), k

    got = evaluate.objective_scores(recons, targets)
    ref = jax_eval.objective_scores(ref_r, ref_t)
    assert got["top"] == ref["top"] == [2, 5, 10]
    for k in ("pcc", "ssim"):
        np.testing.assert_allclose(got[k], ref[k], atol=1.0 / N + 1e-12)


def test_sampling_is_seeded(tiny):
    cfg, groups, data = tiny
    model = port_model(groups, cfg)
    a, _ = evaluate.reconstruct_dataset(model, _batches(data), sample=True, seed=4)
    b, _ = evaluate.reconstruct_dataset(model, _batches(data), sample=True, seed=4)
    c, _ = evaluate.reconstruct_dataset(model, _batches(data), sample=True, seed=5)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_serving_matches_jax_and_padding_is_exact(tiny):
    cfg, groups, data = tiny
    jcfg = jax_config("tiny")
    ref = JaxServingModel("vgan", 3, jcfg, jax_state(groups), max_batch=8,
                          output="uint8")
    served = ServingModel(cfg, port_model(groups, cfg), max_batch=8,
                          output="uint8", device="cpu")
    assert served.buckets == ref.buckets == batch_buckets(8)
    x = data["fmri"][:11]                               # chunks 8 + (3 -> 4)
    got, want = served.reconstruct(x), ref.reconstruct(x)
    assert got.shape == (11, 16, 16, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    one = served.reconstruct(x[0])
    assert one.shape == (16, 16, 3)
    assert np.abs(one.astype(int) - want[0].astype(int)).max() <= 1
    assert served.reconstruct(x[:0]).shape == (0, 16, 16, 3)

    floats = ServingModel(cfg, port_model(groups, cfg), max_batch=8, device="cpu")
    batched = floats.reconstruct(x[:3])                 # bucket 4, one pad row
    alone = np.stack([floats.reconstruct(x[i]) for i in range(3)])
    np.testing.assert_allclose(batched, alone, atol=1e-5)


def test_serving_generate_and_warmup_keep_the_streams(tiny):
    cfg, groups, data = tiny

    def make():
        return ServingModel(cfg, port_model(groups, cfg), max_batch=8,
                            sample=True, seed=1, device="cpu")

    fresh, warmed = make(), make()
    warmed.warmup()
    np.testing.assert_array_equal(warmed.generate(3), fresh.generate(3))
    x = data["fmri"][:5]
    np.testing.assert_array_equal(warmed.reconstruct(x), fresh.reconstruct(x))
    out = fresh.generate(11)
    assert out.shape == (11, 16, 16, 3) and 0.0 <= out.min() and out.max() <= 1.0
    with pytest.raises(ValueError):
        fresh.generate(0)
    with pytest.raises(ValueError):
        fresh.reconstruct(np.zeros((2, 7), np.float32))


def _write_pth(groups, path):
    c = jax_config("tiny").model
    disc = jax.eval_shape(lambda: ImageDiscriminator(c).init(
        jax.random.key(0), jnp.zeros((2, 16, 16, 3)), train=True))
    rng = np.random.default_rng(0)
    groups = dict(groups, discriminator=jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), disc))
    sd = export_state_dict(groups, jax_config("tiny"), kind="vae-gan-cognitive")
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)


def test_inference_cli_on_a_pth(tiny, tmp_path, capsys):
    cfg, groups, data = tiny
    pth = str(tmp_path / "model.pth")
    _write_pth(groups, pth)
    packed = str(tmp_path / "pairs")
    save_packed(packed, {k: v for k, v in data.items()})
    out = str(tmp_path / "out")
    assert inference.main([
        "--family", "vgan", "--stage", "3", "--preset", "tiny", "--ckpt", pth,
        "--input", packed, "--batch-size", str(BS), "-o", out, "--device", "cpu",
        "--save-images", "--resize", "32"]) == 0
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert json.loads(capsys.readouterr().out) == summary
    # held-out split: the first max(n // 10, batch) = 8 pairs, uint8 images
    assert summary["num_images"] == 8
    stored = {"fmri": data["fmri"][:8],
              "image": np.array(open_packed(packed)["image"][:8]) / np.float32(255)}
    ref_r, ref_t = _jax_eval(groups, stored, n=8)
    ref = jax_eval.quality_metrics(ref_r, ref_t, with_is=True)
    assert [k for k in summary if k.startswith("is_")] == ["is_mean", "is_std", "is_proxy"]
    for k in ref:
        tol = {"abs": 1e-5} if k in ("pcc", "ssim", "mse") else {"rel": 1e-5}
        assert summary[k] == pytest.approx(ref[k], **tol), k
    for name in ("objective.csv", "objective.png"):
        assert os.path.exists(os.path.join(out, name))
    assert len(os.listdir(os.path.join(out, "images"))) == 8
    # the same .pth behind the serving model
    served = ServingModel.from_pth(pth, "tiny", device="cpu")
    np.testing.assert_allclose(served.reconstruct(stored["fmri"]),
                               np.clip(ref_r, 0.0, 1.0), atol=1e-5)


@pytest.mark.parametrize("argv, message", [
    (["--family", "wae", "--dataset", "coco"], "needs --input"),
    (["--family", "wae-vgan", "--dataset", "mnist69"], "stage 1 expects"),
    (["--family", "vgan", "--dataset", "bold"], "stage 1 expects"),
])
def test_inference_cli_refuses_what_is_not_ported(tmp_path, argv, message):
    """Every family reaches the train CLI's data loaders, which refuse what
    they cannot read: a raw dataset without ``--input``, or one the stage
    does not take (the default ``--stage`` is 1, image -> image)."""
    with pytest.raises(SystemExit, match=message):
        inference.main(argv + ["--ckpt", "x.pth", "--preset", "tiny",
                               "--device", "cpu", "-o", str(tmp_path)])


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "fmri_tpu"}


def _port_sources():
    root = os.path.join(REPO, "fmri_tpu_torch")
    for d, _, files in os.walk(root):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_nothing_of_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, fmri_tpu_torch.eval.inference, fmri_tpu_torch.eval.serve,"
            " fmri_tpu_torch.train.steps_vgan, fmri_tpu_torch.train.run,"
            " fmri_tpu_torch.train.trainer, fmri_tpu_torch.train.stages,"
            " fmri_tpu_torch.utils.profile_report, fmri_tpu_torch.data.prepare,"
            " fmri_tpu_torch.data.etl, fmri_tpu_torch.metrics.inception,"
            " fmri_tpu_torch.metrics.inception_v3, fmri_tpu_torch.eval.parity,"
            " fmri_tpu_torch.eval.user_study;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r);"
            "assert not bad, bad" % (FORBIDDEN,))
    r = _run(["-c", code], REPO)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    r = _run(["chip_smoke.py"], REPO)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0 and '"ok"' not in r.stdout
