"""The port's checkpoint store (``fmri_tpu_torch/checkpoints/store.py``) on the
CPU: bitwise round trips of whole train states, the stage handoff by group,
retention against the JAX ``prune_checkpoints``, the async writer."""

import json
import os

import numpy as np
import pytest
import torch

from fmri_tpu.checkpoints import store as jax_store
from fmri_tpu_torch.checkpoints import store
from fmri_tpu_torch.configs import get_config
from fmri_tpu_torch.train import state as st
from fmri_tpu_torch.train.optim import AdamState

CFG = get_config("tiny")


def _stirred(state, seed):
    """``state`` with every tensor moved off its init (parameters, BN
    statistics and counts, moments, step), so a round trip that dropped
    any of them would show."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in state.nets.state_dict().items():
            if v.is_floating_point():
                v.add_(torch.randn(v.shape, generator=gen))
            else:
                v.add_(3)
        for m in state.opt_state.values():
            tensors = (list(m.mu.values()) + list(m.nu.values())
                       if isinstance(m, AdamState) else list(m.values()))
            for v in tensors:
                v.copy_(torch.rand(v.shape, generator=gen))
            if isinstance(m, AdamState):
                m.count.fill_(7)
    state.step.fill_(11)
    return state


STATES = {
    "vgan_stage1": lambda seed: st.make_state(st.init_vaegan(CFG, seed), {
        g: st.RmsProp() for g in st.GROUPS}),
    "vgan_stage2": lambda seed: st.make_cognitive_state(st.init_cognitive(CFG, seed=seed),
                                                        CFG, 2),
    "wae_stage1": lambda seed: st.make_wae_state(st.init_wae(CFG, seed), CFG),
    "wae_stage3": lambda seed: st.make_wae_cognitive_state(
        st.init_wae_cognitive(CFG, seed=seed), CFG, 3),
    "wae_vgan_stage1": lambda seed: st.make_wae_dual_gan_state(
        st.init_wae_dual_gan(CFG, seed), CFG),
}


def _assert_same(a, b):
    sa, sb = a.nets.state_dict(), b.nets.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert sorted(a.opt_state) == sorted(b.opt_state)
    for g, m in a.opt_state.items():
        n = b.opt_state[g]
        pairs = ([(m.mu, n.mu), (m.nu, n.nu)] if isinstance(m, AdamState) else [(m, n)])
        for x, y in pairs:
            assert sorted(x) == sorted(y)
            for k in x:
                assert torch.equal(x[k], y[k]), (g, k)
        if isinstance(m, AdamState):
            assert torch.equal(m.count, n.count)
    assert torch.equal(a.step, b.step) and a.step.dtype == torch.int64


@pytest.mark.parametrize("kind", sorted(STATES))
def test_round_trip_is_bitwise(tmp_path, kind):
    """Parameters, BN statistics and ``num_batches_tracked``, RMSprop or
    Adam moments and count, and the step come back bit for bit; the file
    holds only plain dicts of tensors (``weights_only=True`` reads it)."""
    live = _stirred(STATES[kind](0), 1)
    path = store.save_checkpoint(str(tmp_path), 3, live, {"seed": 8, "metrics": {"x": 1.5}})
    assert os.path.basename(path) == "ckpt_00003"
    assert sorted(os.listdir(path)) == ["meta.json", "state.pt"]
    tree = torch.load(os.path.join(path, "state.pt"), weights_only=True)
    assert sorted(tree) == ["groups", "opt_state", "step"]
    assert sorted(tree["groups"]) == sorted(live.nets.PREFIXES)
    restored, meta = store.restore_checkpoint(str(tmp_path), STATES[kind](5))
    _assert_same(restored, live)
    assert meta == {"epoch": 3, "seed": 8, "metrics": {"x": 1.5}}


def test_restore_refuses_another_stage(tmp_path):
    store.save_checkpoint(str(tmp_path), 0, STATES["vgan_stage1"](0))
    with pytest.raises(KeyError, match="groups"):
        store.restore_checkpoint(str(tmp_path), STATES["wae_stage1"](0))
    with pytest.raises(FileNotFoundError):
        store.restore_checkpoint(str(tmp_path / "nothing"), STATES["vgan_stage1"](0))


def test_latest_and_listed_epochs(tmp_path):
    s = STATES["wae_stage1"](0)
    for e in (0, 4, 2):
        s.step.fill_(e)
        store.save_checkpoint(str(tmp_path), e, s)
    assert sorted(store.list_checkpoints(str(tmp_path))) == [0, 2, 4]
    assert store.latest_epoch(str(tmp_path)) == 4
    for epoch, want in ((None, 4), (0, 0), (2, 2)):
        restored, meta = store.restore_checkpoint(str(tmp_path), STATES["wae_stage1"](9),
                                                  epoch=epoch)
        assert meta["epoch"] == int(restored.step) == want


def test_load_groups_and_graft_match_the_stage_wiring(tmp_path):
    """Stage II's wiring: the decoder and discriminator from stage I, the
    teacher from the stage-I encoder, buffers and ``num_batches_tracked``
    included; the same groups from a checkpoint dir and from a
    reference-layout ``.pth``."""
    stage1 = _stirred(STATES["vgan_stage1"](0), 2)
    store.save_checkpoint(str(tmp_path / "ckpt"), 0, stage1)
    pth = str(tmp_path / "stage1.pth")
    torch.save(stage1.nets.state_dict(), pth)
    names = ["encoder", "decoder", "discriminator"]
    from_dir = store.load_groups(str(tmp_path / "ckpt"), names)
    from_pth = store.load_groups(pth, names, prefixes=st.VaeGan.PREFIXES)
    for g in names:
        for k, v in from_dir[g].items():
            assert torch.equal(v, from_pth[g][k]), (g, k)
    nets = st.init_cognitive(CFG, seed=3)
    fresh = {k: v.clone() for k, v in nets.encoder.state_dict().items()}
    store.graft_groups(nets, from_dir, {"decoder": "decoder", "discriminator": "discriminator",
                                        "teacher_encoder": "encoder"})
    for target, source in (("decoder", "decoder"), ("discriminator", "discriminator"),
                           ("teacher_net.encoder", "encoder")):
        got = nets.get_submodule(target).state_dict()
        want = getattr(stage1.nets, source).state_dict()
        for k in want:
            assert torch.equal(got[k], want[k]), (target, k)
    assert int(nets.decoder.fc[1].num_batches_tracked) == 3
    for k, v in nets.encoder.state_dict().items():  # the fresh cognitive encoder stays
        assert torch.equal(v, fresh[k])
    with pytest.raises(KeyError, match="latent_disc"):
        store.load_groups(str(tmp_path / "ckpt"), ["latent_disc"])
    with pytest.raises(ValueError, match="prefixes"):
        store.load_groups(pth, names)


def _fake_checkpoints(root, epochs, metrics):
    os.makedirs(root, exist_ok=True)
    for e in epochs:
        d = os.path.join(root, f"ckpt_{e:05d}")
        os.makedirs(d)
        meta = {"epoch": e}
        if e in metrics:
            meta["metrics"] = {"valid_PCC": metrics[e]}
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump(meta, f)


@pytest.mark.parametrize("policy", [
    dict(), dict(keep_last=2), dict(keep_best=2), dict(keep_last=1, keep_best=1),
    dict(keep_every=3), dict(keep_last=1, keep_every=4, keep_best=2),
    dict(keep_best=2, best_mode="min"), dict(keep_best=9)])
def test_prune_matches_jax(tmp_path, policy):
    """Over the same ``meta.json`` files the port deletes the same epochs as
    the JAX ``prune_checkpoints``; the latest always stays."""
    epochs = [0, 1, 2, 3, 5, 8, 9]
    metrics = {0: 0.1, 1: 0.5, 2: 0.3, 3: 0.45, 5: 0.2, 9: 0.05}  # 8 has none
    _fake_checkpoints(str(tmp_path / "port"), epochs, metrics)
    _fake_checkpoints(str(tmp_path / "jax"), epochs, metrics)
    got = store.prune_checkpoints(str(tmp_path / "port"), **policy)
    want = jax_store.prune_checkpoints(str(tmp_path / "jax"), **policy)
    assert got == want
    assert sorted(store.list_checkpoints(str(tmp_path / "port"))) == sorted(
        jax_store.list_checkpoints(str(tmp_path / "jax")))
    assert 9 in store.list_checkpoints(str(tmp_path / "port"))


def test_async_snapshot_survives_an_in_place_update(tmp_path):
    """``save`` returns with a finished host copy: a step that updates the
    live state in place right after it reaches neither the file nor the
    snapshot."""
    live = _stirred(STATES["wae_vgan_stage1"](0), 4)
    snapshot = {k: v.clone() for k, v in live.nets.state_dict().items()}
    moments = {k: v.clone() for k, v in live.opt_state["encoder"].items()}
    writer = store.AsyncCheckpointWriter()
    writer.save(str(tmp_path), 1, live, {"seed": 8})
    with torch.no_grad():
        for v in live.nets.state_dict().values():
            v.add_(1) if v.is_floating_point() else v.add_(100)
        for v in live.opt_state["encoder"].values():
            v.mul_(-1)
    live.step.add_(1)
    writer.wait()
    assert writer.last_path.endswith("ckpt_00001")
    restored, _ = store.restore_checkpoint(str(tmp_path), STATES["wae_vgan_stage1"](7))
    for k, v in restored.nets.state_dict().items():
        assert torch.equal(v, snapshot[k]), k
    for k, v in restored.opt_state["encoder"].items():
        assert torch.equal(v, moments[k]), k
    assert int(restored.step) == 11


def test_async_writer_reraises_a_write_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a dir")
    writer = store.AsyncCheckpointWriter()
    writer.save(str(blocker), 0, STATES["wae_stage1"](0))
    with pytest.raises(OSError):
        writer.wait()
    writer.wait()  # the error is raised once


def test_async_writer_prunes_after_writing(tmp_path):
    writer = store.AsyncCheckpointWriter()
    s = STATES["wae_stage1"](0)
    for e in range(4):
        writer.save(str(tmp_path), e, s, prune=dict(keep_last=2))
    writer.wait()
    assert sorted(store.list_checkpoints(str(tmp_path))) == [2, 3]


def test_load_eval_state_reads_a_port_checkpoint(tmp_path):
    live = STATES["vgan_stage2"](6)  # unstirred: its BN variances stay positive
    live.step.fill_(11)
    store.save_checkpoint(str(tmp_path), 2, live, {"seed": 8})
    groups, meta = store.load_eval_state(str(tmp_path))
    assert meta["epoch"] == 2 and meta["step"] == 11
    assert sorted(groups) == sorted(st.VaeGanCognitiveTrain.PREFIXES)
    from fmri_tpu_torch.eval.steps import VaeGanCognitive

    model = VaeGanCognitive(CFG.model)
    model.load_state_dict({f"{g}.{k}": v for g in ("encoder", "decoder")
                           for k, v in groups[g].items()}, strict=True)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, CFG.model.num_voxels)).astype(np.float32))
    live.nets.eval()
    with torch.no_grad():
        want = live.nets.decoder(live.nets.encoder(x)[0])
    assert torch.equal(model.reconstruct(x), want)
