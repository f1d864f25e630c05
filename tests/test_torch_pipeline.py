"""The port's input pipeline and train-time augmentation
(``fmri_tpu_torch/data/pipeline.py``, ``data/transforms.py``,
``train/epoch_scan.py``) against the JAX package's, on the CPU.

Batch order, permutations and the augmentation are integer work or exact
elementwise float32 arithmetic, so every comparison here is exact."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmri_tpu.data import pipeline as jax_pipeline
from fmri_tpu.data import transforms as jax_transforms
from fmri_tpu.train.epoch_scan import epoch_permutation as jax_epoch_permutation
from fmri_tpu_torch.data import pipeline
from fmri_tpu_torch.data.transforms import train_augment
from fmri_tpu_torch.train.epoch_scan import device_epoch, epoch_permutation
from fmri_tpu_torch.train.trainer import DrawSpec
from torch_port_helpers import JaxDraws


def _data(kind, n=21):
    rng = np.random.default_rng(n)
    image = rng.uniform(size=(n, 4, 4, 3)).astype(np.float32)
    if kind == "array":
        return image
    return {"fmri": rng.normal(size=(n, 7)).astype(np.float32), "image": image}


def _double(batch):
    if isinstance(batch, dict):
        return {k: 2 * v for k, v in batch.items()}
    return 2 * batch


def _as_list(batch):
    return [batch] if not isinstance(batch, dict) else [batch[k] for k in sorted(batch)]


@pytest.mark.parametrize("kind", ["array", "dict"])
@pytest.mark.parametrize("shuffle,drop_last,transform", [
    (True, True, None), (False, True, None), (True, False, None), (False, False, _double),
    (True, True, _double)])
def test_batches_match_jax(kind, shuffle, drop_last, transform):
    """Three epochs: the same rows in the same order, the same shapes."""
    data = _data(kind)
    ours = pipeline.Batches(data, 4, shuffle=shuffle, seed=3, drop_last=drop_last,
                            transform=transform)
    ref = jax_pipeline.Batches(data, 4, shuffle=shuffle, seed=3, drop_last=drop_last,
                               transform=transform)
    assert len(ours) == len(ref) == (5 if drop_last else 6)
    for _ in range(3):
        got, want = list(ours), list(ref)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(_as_list(g), _as_list(w)):
                np.testing.assert_array_equal(a, b)
    assert ours.epoch == ref.epoch == 3


def test_batches_refuse_an_empty_epoch():
    with pytest.raises(ValueError, match="no batches"):
        pipeline.Batches(_data("array", 3), 4)


@pytest.mark.parametrize("n,bs,seed,epoch", [(21, 4, 3, 0), (21, 4, 3, 5), (64, 8, 8, 1),
                                             (640, 64, 8, 2)])
def test_epoch_permutation_matches_jax(n, bs, seed, epoch):
    got = epoch_permutation(n, bs, seed, epoch)
    np.testing.assert_array_equal(got, jax_epoch_permutation(n, bs, seed, epoch))
    assert got.dtype == np.int32 and len(got) == n // bs * bs
    # the same order as the shuffled host batches of that epoch
    batches = pipeline.Batches(np.arange(n), bs, shuffle=True, seed=seed)
    batches.epoch = epoch
    np.testing.assert_array_equal(np.concatenate(list(batches)), got)


@pytest.mark.parametrize("kind", ["array", "dict"])
def test_device_epoch_gathers_the_host_batches(kind):
    data = _data(kind)
    host = pipeline.Batches(data, 4, shuffle=True, seed=3)
    host.epoch = 2
    perm = torch.from_numpy(epoch_permutation(21, 4, 3, 2))
    got = list(device_epoch(pipeline.to_device(data, torch.device("cpu")), perm, 4))
    want = list(host)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in zip(_as_list(g), _as_list(w)):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_device_iterator_keeps_the_order(prefetch):
    data = _data("dict")
    batches = list(pipeline.device_iterator(
        iter(pipeline.Batches(data, 4, shuffle=True, seed=1)), torch.device("cpu"),
        prefetch=prefetch))
    want = list(pipeline.Batches(data, 4, shuffle=True, seed=1))
    assert len(batches) == 5
    for g, w in zip(batches, want):
        assert isinstance(g["image"], torch.Tensor)
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
        np.testing.assert_array_equal(g["fmri"].numpy(), w["fmri"])


def test_device_iterator_reraises_the_producer_error():
    def batches():
        yield np.zeros((2, 3), np.float32)
        yield np.ones((2, 3), np.float32)
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for b in pipeline.device_iterator(batches(), torch.device("cpu")):
            got.append(float(b.sum()))
    assert got == [0.0, 6.0]


def test_device_iterator_stops_its_producer_when_abandoned():
    before = threading.active_count()
    it = pipeline.device_iterator(iter([np.zeros(2)] * 50), torch.device("cpu"), prefetch=1)
    next(it)
    it.close()
    assert threading.active_count() == before


def test_memmapped_rows_are_copied_writable(tmp_path):
    path = tmp_path / "a.npy"
    np.save(path, np.arange(12, dtype=np.float32).reshape(4, 3))
    view = np.load(path, mmap_mode="r")[1:3]
    t = pipeline.to_device(view, torch.device("cpu"))
    t += 1  # a read-only memmap view would refuse this
    np.testing.assert_array_equal(t.numpy(), np.arange(3, 9).reshape(2, 3) + 1)


@pytest.mark.parametrize("flip,max_shift,uint8", [
    (True, 0, False), (False, 5, False), (True, 5, False), (False, 0, True),
    (True, 5, True)])
def test_train_augment_matches_jax(flip, max_shift, uint8):
    """With the JAX draws (the augment key split into flip and shift), the
    port's augmentation equals ``fmri_tpu.data.transforms.train_augment``
    bit for bit; uint8 batches are dequantized on the device first."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(6, 16, 16, 3)).astype(np.float32)
    if uint8:
        x = (x * 255).astype(np.uint8)
    mean, std = (0.4, 0.5, 0.6), (0.3, 0.5, 0.7)
    key = jax.random.key(7)
    k_flip, k_shift = jax.random.split(key)  # train_augment's own split
    flip_t = (torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5, (6,))))
              if flip else None)
    shift_t = (torch.from_numpy(np.array(jax.random.randint(
        k_shift, (6, 2), -max_shift, max_shift + 1))) if max_shift else None)
    want = jax_transforms.train_augment(key, jnp.asarray(x), flip=flip,
                                        max_shift=max_shift, mean=mean, std=std)
    got = train_augment(torch.from_numpy(x), flip_t, shift_t, mean, std)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if flip or max_shift:  # the draws moved something
        assert not np.array_equal(got.numpy(), np.asarray(jax_transforms.eval_preprocess(
            jnp.asarray(x), mean, std)))


def test_jax_draws_replay_the_trainer_keys():
    """``JaxDraws`` gives the flip and shifts ``train_augment`` draws from
    the JAX trainer's augment key of (epoch 2, batch 3)."""
    spec = DrawSpec(4, 8, True, 5, (("eps", 1.0), ("z_p", 1.0)), torch.device("cpu"))
    flip, shifts, noise = JaxDraws(8).train(2, 3, spec)
    k = jax.random.fold_in(jax.random.fold_in(jax.random.key(8), 2), 3)
    k_aug, k_step = jax.random.split(k)
    x = np.random.default_rng(1).uniform(size=(4, 16, 16, 3)).astype(np.float32)
    want = jax_transforms.train_augment(k_aug, jnp.asarray(x), flip=True, max_shift=5)
    np.testing.assert_array_equal(
        train_augment(torch.from_numpy(x), flip, shifts).numpy(), np.asarray(want))
    k_eps, k_zp = jax.random.split(k_step)
    np.testing.assert_array_equal(noise["z_p"].numpy(),
                                  np.asarray(jax.random.normal(k_zp, (4, 8))))
