"""How far the stage-I step's fp32 update drifts between the two packages,
and how far each sits from a float64 run of the port, on the CPU:

    python tests/torch_step_drift.py

1. For each case of ``test_torch_train.py::CASES`` and
   ``test_torch_res100.py::CASES``, after steps 1 and 3, the
   largest per-tensor gap between the port and the JAX step in the measures
   that test bounds: losses (relative), parameter movement, BN running
   statistics and RMSprop moments (L2 relative). These are the measured
   values behind its bounds.
2. At res64 with the kernel flags off, batch 4, one step from the same
   state: for every parameter, the largest element gap of the fp32 update
   (JAX's and the port's) from the port's float64 update, relative to the
   largest float64 update of that tensor; the worst tensors are printed.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_res100 as R  # noqa: E402
import test_torch_train as T  # noqa: E402


def _rel(a, b, scale):
    return float((a.double() - b.double()).norm() / max(float(scale.double().norm()), 1e-30))


def case_gaps(case, spec):
    preset, flags, dtype, b, _, _ = spec
    jcfg, cfg = T._configs(preset, flags, dtype)
    groups = T.random_groups(cfg, 0, "vae-gan")
    jstate, state = T._jax_state(groups, jcfg), T._port_state(groups, cfg)
    start = {k: v.clone() for k, v in state.nets.state_dict().items()}
    jfns, fns = T.jax_step(jcfg, "vae-gan", donate=False), T.make_vgan_stage1_step(cfg)
    for i in range(3):
        x = T._images(cfg, b, 10 + i)
        key = jax.random.key(100 + i)
        eps, z_p = T._noise(key, b, cfg.model.latent_dim)
        hyper = (T.MARGIN, T.EQUILIBRIUM, T.LAMBDA_MSE)
        jstate, jm = jfns.train_step(jstate, jnp.asarray(x), key,
                                     *(jnp.float32(h) for h in hyper))
        state, m = fns.train_step(state, torch.from_numpy(x), torch.from_numpy(eps),
                                  torch.from_numpy(z_p), *hyper)
        if i not in (0, 2):
            continue
        gap = {"loss": max(abs(float(m[k]) - float(jm[k])) / abs(float(jm[k]))
                           for k in jm if float(jm[k])),
               "param": 0.0, "stats": 0.0, "sq": 0.0}
        ref = T.from_jax_groups({g: {"params": jstate.params[g],
                                     "batch_stats": jstate.batch_stats[g]}
                                 for g in T.GROUPS}, cfg, "vae-gan")
        got = state.nets.state_dict()
        for k, r in ref.items():
            if k.endswith("num_batches_tracked"):
                continue
            if "running" in k:
                gap["stats"] = max(gap["stats"], _rel(got[k], r, r))
            elif not torch.equal(r, start[k]):
                gap["param"] = max(gap["param"], _rel(got[k], r, r - start[k]))
        ref_sq = T.moments_from_jax({g: jstate.opt_state[g].sq_avg for g in T.GROUPS}, cfg)
        for g in T.GROUPS:
            for k, r in ref_sq[g].items():
                gap["sq"] = max(gap["sq"], _rel(state.opt_state[g][k], r, r))
        print(f"{case} step {i + 1}: " + ", ".join(f"{k} {v:.3g}" for k, v in gap.items()),
              flush=True)


def float64_gaps(b=4):
    jcfg, cfg = T._configs("res64")
    groups = T.random_groups(cfg, 0, "vae-gan")
    x = T._images(cfg, b, 10)
    key = jax.random.key(100)
    eps, z_p = T._noise(key, b, cfg.model.latent_dim)
    hyper = (T.MARGIN, T.EQUILIBRIUM, T.LAMBDA_MSE)
    jstate, _ = T.jax_step(jcfg, "vae-gan", donate=False).train_step(
        T._jax_state(groups, jcfg), jnp.asarray(x), key, *(jnp.float32(h) for h in hyper))
    fns = T.make_vgan_stage1_step(cfg)
    after = {}
    for dt in (torch.float32, torch.float64):
        state = T._port_state(groups, cfg)
        state.nets.to(dt)
        for moments in state.opt_state.values():
            for k in moments:
                moments[k] = moments[k].to(dt)
        state, _ = fns.train_step(state, *(torch.from_numpy(a).to(dt) for a in (x, eps, z_p)),
                                  *hyper)
        after[dt] = state.nets.state_dict()
    start = T.from_jax_groups(groups, cfg, "vae-gan")
    ref = T.from_jax_groups({g: {"params": jstate.params[g],
                                 "batch_stats": jstate.batch_stats[g]} for g in T.GROUPS},
                            cfg, "vae-gan")
    rows = []
    for k, p0 in start.items():
        if "running" in k or k.endswith("num_batches_tracked"):
            continue
        d64 = after[torch.float64][k] - p0.double()
        scale = float(d64.abs().max())
        if scale == 0:
            continue
        gaps = [float(((p - p0.double()) - d64).abs().max()) / scale
                for p in (ref[k].double(), after[torch.float32][k].double())]
        rows.append((*gaps, k))
    print(f"res64 batch {b}, one step: largest element gap of the fp32 update from the "
          "port's float64 update, relative to the largest float64 update of the tensor")
    for jax_gap, port_gap, k in sorted(rows)[-6:]:
        print(f"  {k}: JAX fp32 {jax_gap:.3g}, port fp32 {port_gap:.3g}")
    worst_port = max(rows, key=lambda r: r[1])
    print(f"  worst port fp32: {worst_port[2]} {worst_port[1]:.3g}")


if __name__ == "__main__":
    for case, spec in sorted({**T.CASES, **R.CASES}.items()):
        case_gaps(case, spec)
    float64_gaps()
