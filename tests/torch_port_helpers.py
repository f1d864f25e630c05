"""Shared pieces of the ``tests/test_torch_*.py`` files: the CUDA fixture and
the JAX-side state built from the same numpy weights the port loads."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, or a skip. Decided when the test runs, never at import:
    every xdist worker must collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from fmri_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def jax_state(groups):
    """A JAX ``TrainState`` holding numpy ``encoder``/``decoder`` groups."""
    import jax.numpy as jnp

    from fmri_tpu.train.state import TrainState

    return TrainState(
        params={k: g["params"] for k, g in groups.items()},
        batch_stats={k: g["batch_stats"] for k, g in groups.items()},
        opt_state={}, step=jnp.zeros((), jnp.int32))


def port_model(groups, cfg, device="cpu"):
    """The port's ``VaeGanCognitive`` loaded strictly from JAX groups."""
    from fmri_tpu_torch.checkpoints.convert import from_jax_groups
    from fmri_tpu_torch.eval.steps import VaeGanCognitive

    model = VaeGanCognitive(cfg.model)
    model.load_state_dict(from_jax_groups(groups, cfg), strict=True)
    return model.to(device)


def uniform_pair(shape, seed):
    """Two correlated NHWC float32 images in [0, 1]."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0.0, 0.1, shape), 0.0, 1.0).astype(np.float32)
    return a, b


class JaxDraws:
    """The port trainer's draws interface (``fmri_tpu_torch.train.trainer.
    Draws``) replaying the JAX trainer's keys exactly: per (epoch, batch)
    ``fold_in(fold_in(key(seed), epoch), batch)`` split into the augment
    and step keys (``fmri_tpu/train/trainer.py:304,324-325``), the augment
    key split into flip and shift (``transforms.py:143``), the step key
    used whole for one noise tensor or split in the step's order; per eval
    pass ``fold_in(ep_key, stream)`` split once per batch, its remainder
    drawing the generated panel (:215, :236)."""

    def __init__(self, seed):
        import jax

        self.root = jax.random.key(seed)

    def train(self, epoch, index, spec):
        import jax
        import jax.numpy as jnp

        k = jax.random.fold_in(jax.random.fold_in(self.root, epoch), index)
        k_aug, k_step = jax.random.split(k)
        k_flip, k_shift = jax.random.split(k_aug)
        shape = (spec.batch, spec.latent)
        flip = shifts = None
        if spec.flip:
            flip = jax.random.bernoulli(k_flip, 0.5, (spec.batch,))
        if spec.max_shift:
            m = spec.max_shift
            shifts = jax.random.randint(k_shift, (spec.batch, 2), -m, m + 1)
        n = len(spec.noise)
        keys = [k_step] if n == 1 else list(jax.random.split(k_step, n)) if n else []
        noise = {name: scale * jax.random.normal(key, shape, jnp.float32)
                 for (name, scale), key in zip(spec.noise, keys)}

        def put(a):
            return None if a is None else torch.from_numpy(np.array(a)).to(spec.device)

        return put(flip), put(shifts), {k: put(v) for k, v in noise.items()}

    def eval(self, epoch, stream, device):
        import jax

        return _JaxEvalDraws(jax.random.fold_in(jax.random.fold_in(self.root, epoch), stream),
                             device)


class _JaxEvalDraws:
    def __init__(self, rng, device):
        self.rng, self.device = rng, device

    def eps(self, n, latent):
        import jax

        self.rng, k = jax.random.split(self.rng)
        return torch.from_numpy(np.array(jax.random.normal(k, (n, latent)))).to(self.device)

    def z_p(self, n, latent):
        import jax
        import jax.numpy as jnp

        return torch.from_numpy(np.array(
            jax.random.normal(self.rng, (n, latent), jnp.float32))).to(self.device)


def warm_jax_moments(state):
    """A JAX ``TrainState`` with every optimizer moment at ones, as
    ``tests/ref_oracle.py:110`` warms them (from zero RMSprop moments an
    update is about 3.16 lr sign(g) and flips on rounding noise)."""
    import jax
    import jax.numpy as jnp

    return state.replace(opt_state=jax.tree_util.tree_map(jnp.ones_like, state.opt_state))


def port_state_from_jax(state, cfg, kind, nets, device="cpu"):
    """The port's ``TrainState`` holding a JAX builder's state: its groups
    loaded strictly into ``nets`` through ``from_jax_groups(kind)``, its
    moments through ``moments_from_jax``, its step count."""
    from fmri_tpu_torch.checkpoints.convert import from_jax_groups, moments_from_jax
    from fmri_tpu_torch.train.state import make_state

    groups = {g: {"params": state.params[g], "batch_stats": state.batch_stats.get(g, {})}
              for g in state.params}
    nets.load_state_dict(from_jax_groups(groups, cfg, kind), strict=True)
    moments = moments_from_jax(dict(state.opt_state), cfg, kind)
    out = make_state(nets.to(device), {g: None for g in moments}, moments)
    out.step.fill_(int(np.asarray(state.step)))
    return out


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread for a test module: the suite runs
    several workers at once, and tiny ops on every worker's full thread
    pool spend their time waiting for each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the converter kind of each served (family, stage): the groups random_groups
# draws and from_jax_groups reads
SERVE_KINDS = {("vgan", 1): "vae-gan", ("vgan", 2): "vae-gan-cognitive-eval",
               ("vgan", 3): "vae-gan-cognitive-eval", ("wae", 1): "wae-gan",
               ("wae", 2): "wae-gan-cognitive", ("wae", 3): "wae-gan-cognitive",
               ("wae-vgan", 1): "wae-vgan", ("wae-vgan", 3): "wae-vgan"}


def serving_pair(family, stage, seed=0, max_batch=8, **kw):
    """(the port's ServingModel on the CPU, the JAX ServingModel) of one
    (family, stage), both holding the same seeded random groups; the JAX
    one with a single bucket (``min_bucket == max_batch``: one compiled
    program)."""
    from fmri_tpu.configs import get_config as jax_config
    from fmri_tpu.eval.serve import ServingModel as JaxServingModel
    from fmri_tpu_torch.checkpoints.convert import (
        UNUSED_PREFIXES, from_jax_groups, random_groups,
    )
    from fmri_tpu_torch.configs import get_config
    from fmri_tpu_torch.eval.serve import ServingModel
    from fmri_tpu_torch.eval.steps import eval_module

    cfg = get_config("tiny")
    kind = SERVE_KINDS[(family, stage)]
    groups = random_groups(cfg, seed=seed, kind=kind)
    sd = {k: v for k, v in from_jax_groups(groups, cfg, kind).items()
          if not k.startswith(UNUSED_PREFIXES)}
    model = eval_module(family, stage)[0](cfg.model)
    model.load_state_dict(sd, strict=True)
    port = ServingModel(cfg, model, family=family, stage=stage, max_batch=max_batch,
                        device="cpu", **kw)
    ref = JaxServingModel(family, stage, jax_config("tiny"), jax_state(groups),
                          max_batch=max_batch, min_bucket=max_batch, **kw)
    return port, ref, groups


def serve_requests(model, n, seed):
    """``n`` seeded requests for a ServingModel: images in [0, 1] for the
    image kinds, standard normal fMRI for the pair kinds."""
    rng = np.random.default_rng(seed)
    shape = (n, *model.sample_shape())
    if model.data_kind == "image":
        return rng.uniform(size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def jax_decode(groups, z):
    """The JAX package's ``tiny`` decoder on latents ``z`` (numpy),
    denormalized and clipped to [0, 1] as the served images are."""
    import jax.numpy as jnp

    from fmri_tpu.configs import get_config as jax_config
    from fmri_tpu.data.transforms import denormalize
    from fmri_tpu.models.nets import Decoder

    cfg = jax_config("tiny")
    dec = groups["decoder"]
    out = Decoder(cfg.model).apply(
        {"params": dec["params"], "batch_stats": dec["batch_stats"]},
        jnp.asarray(z), train=False)
    return np.clip(np.asarray(denormalize(out, cfg.data.mean, cfg.data.std)), 0.0, 1.0)


def _coco(i):
    return f"COCO_train2014_{i:012d}.jpg"


# the stimuli each subject's runs show, in order: (ImgName, ImgType) per row
# of events.tsv; an empty cell is NaN to pandas
_BOLD_RUNS = {
    ("CSI1", 1, 1): [(_coco(1), "coco"), ("", "coco"), ("n01440764_1.JPEG", "imagenet"),
                     ("beach_1.jpg", ""), ("beach_2.jpg", "rep_scenes"),
                     (_coco(2), "rep_coco"), (_coco(3), "coco")],
    ("CSI1", 1, 2): [(_coco(4), None), (_coco(5), None), (_coco(1), None), (_coco(6), None)],
    ("CSI2", 2, 1): [(_coco(7), "coco"), ("beach_3.jpg", "scenes"), (_coco(8), "coco"),
                     ("n01440764_2.JPEG", "imagenet"), (_coco(9), "Coco")],
}


def write_bold5000(root, seed=0, size=(40, 56)):
    """A BOLD5000-layout fixture under ``root``: ``ds001499/sub-CSI*/ses-*/
    func/*_bold.nii.gz`` with their ``events.tsv`` (one run lacks the
    ``ImgType`` column, cells are empty, one run has no events file, one
    file name does not match the run pattern), ``stimuli/{COCO,ImageNet,
    Scene}`` images, ``rois/stim_lists/CSI0*_stim_lists.txt`` with ``rep_``
    entries and a name no run shows, and ``rois/CSI*/h5/*_ROIs_TR34.h5``
    (needs h5py) with one row per stim-list line. Returns the paths."""
    import csv
    import os

    from PIL import Image

    from fmri_tpu_torch.data import nifti

    rng = np.random.default_rng(seed)
    paths = {k: os.path.join(root, k) for k in ("ds001499", "stimuli", "rois")}
    sub_of = {"COCO_": "COCO", "n0": "ImageNet", "beach": "Scene"}
    names = sorted({name for rows in _BOLD_RUNS.values() for name, _ in rows if name})
    for name in names:
        d = os.path.join(paths["stimuli"], next(v for k, v in sub_of.items()
                                                 if name.startswith(k)))
        os.makedirs(d, exist_ok=True)
        img = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(d, name), format="JPEG")
    lists = {}
    for (sub, ses, run), rows in _BOLD_RUNS.items():
        func = os.path.join(paths["ds001499"], f"sub-{sub}", f"ses-{ses:02d}", "func")
        os.makedirs(func, exist_ok=True)
        stem = f"sub-{sub}_ses-{ses:02d}_task-5000scenes_run-{run:02d}"
        nifti.save(os.path.join(func, stem + "_bold.nii.gz"),
                   rng.normal(size=(2, 2, 2, 5)).astype(np.float32))
        with open(os.path.join(func, stem + "_events.tsv"), "w", newline="") as f:
            w = csv.writer(f, delimiter="\t")
            typed = rows[0][1] is not None
            w.writerow(["onset", "duration", "ImgName"] + (["ImgType"] if typed else []))
            for i, (name, kind) in enumerate(rows):
                w.writerow([10.0 * i, 1.0, name] + ([kind] if typed else []))
        lists.setdefault(sub, []).extend(name for name, _ in rows if name)
    extra = os.path.join(paths["ds001499"], "sub-CSI2", "ses-02", "func")
    nifti.save(os.path.join(extra, "sub-CSI2_ses-02_task-5000scenes_run-03_bold.nii.gz"),
               np.zeros((2, 2, 2, 5), np.float32))  # no events file
    nifti.save(os.path.join(extra, "sub-CSI2_ses-02_task-5000scenes_acq-x_run-01_bold.nii.gz"),
               np.zeros((2, 2, 2, 5), np.float32))  # not the run pattern
    stim_lists = os.path.join(paths["rois"], "stim_lists")
    os.makedirs(stim_lists)
    voxels = {"CSI1": {"RHPPA": 5, "LHEarlyVis": 7, "LHLOC": 3},
              "CSI2": {"RHPPA": 4, "LHEarlyVis": 9, "LHLOC": 6}}
    for sub, shown in lists.items():
        entries = [("rep_" + n if i % 3 == 1 else n) for i, n in enumerate(shown)]
        entries.insert(2, "never_shown.jpg")
        with open(os.path.join(stim_lists, f"CSI0{sub[-1]}_stim_lists.txt"), "w") as f:
            f.write("\n".join(entries) + "\n")
        try:
            import h5py
        except ImportError:
            continue
        d = os.path.join(paths["rois"], sub, "h5")
        os.makedirs(d)
        with h5py.File(os.path.join(d, f"{sub}_ROIs_TR34.h5"), "w") as f:
            for region, n in voxels[sub].items():
                f[region] = rng.normal(size=(len(entries), n))
    return paths
