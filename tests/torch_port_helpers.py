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
