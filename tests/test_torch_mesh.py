"""Training across ranks (``fmri_tpu_torch/parallel/mesh.py``) on the CPU over
gloo, at ``tiny``: the port's stage-II step at data=2, model=2 against the
JAX package's step on ``make_mesh(data=2, model=2)`` over 4 of the
conftest's 8 virtual devices, and the port's steps under a mesh against its
own single-process step (which the other port tests hold against JAX).

Every case's ranks run in one group of four worker processes, started once
for the module (``python tests/test_torch_mesh.py --worker ...``, each with
its own ``communicate(timeout=...)``, so a hang fails in seconds). The
workers run in rounds: a world of all four ranks (data=2 x model=2, and
data=4), then two worlds of two (data=2). They read their inputs from the
file the module writes and write, per rank and case, the metrics of each
step and the state gathered whole (``store.host_tree``).

Tolerances: against JAX those of ``tests/test_mesh.py`` (losses rtol 2e-4,
parameters rtol 2e-3 and atol 2e-5); against the single-process step
``TOL``: losses 1e-5 relative, each parameter's L2 difference 1e-3 of how
far the step moved it, BN running statistics and second moments 1e-5
relative, Adam's first moments (gradients) 1e-3 as ``tests/test_torch_wae.py``,
``num_batches_tracked`` equal; a tensor whose own rounding noise is larger
(the single-process step on the batch in reverse order, the same sums in
another order, as ``chip_smoke.py``'s ``check_tensors`` measures it: the WAE
encoder's ``l_mu`` bias takes a near-cancelling update) within ``FLOOR``
times that noise. Moments start warm (RMSprop's at one, Adam's second
moments at one), so an update is about linear in its gradient. Replicas
are bitwise equal across ranks.

The traps (a gate on one rank's means, BatchNorm statistics also summed
over the model group) have tests of their own; each fails against the
wrong version.
"""

import argparse
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # the worker runs this file as a script
    sys.path.insert(0, REPO)

from fmri_tpu_torch.checkpoints import convert, store  # noqa: E402
from fmri_tpu_torch.configs import presets  # noqa: E402
from fmri_tpu_torch.models.nets import reparameterize  # noqa: E402
from fmri_tpu_torch.train.optim import AdamState, RmsProp  # noqa: E402
from fmri_tpu_torch.train.state import (  # noqa: E402
    GROUPS, VaeGan, VaeGanCognitiveTrain, WaeGan, WaeGanCognitiveTrain, init_vaegan,
    init_wae, init_wae_cognitive, make_cognitive_state, make_state, make_wae_cognitive_state,
    make_wae_state,
)
from fmri_tpu_torch.train.steps_vgan import (  # noqa: E402
    make_vgan_cognitive_step, make_vgan_stage1_step,
)
from fmri_tpu_torch.train.steps_wae import (  # noqa: E402
    make_wae_cognitive_step, make_wae_stage1_step,
)

KIND = "vae-gan-cognitive"
B = 8
TOL = dict(loss=1e-5, param=1e-3, stats=1e-5, mu=1e-3, sq=1e-5)
FLOOR = 3
JAX_TOL = dict(loss=2e-4, rtol=2e-3, atol=2e-5)
WORKERS = 4
# each round: the sub-worlds (worker ranks) and the cases each runs
ROUNDS = [
    [((0, 1, 2, 3), ("stage2_jax", "stage3_tp", "wae2_tp", "stage1_d4"))],
    [((0, 1), ("stage1_d2", "gate_trap")), ((2, 3), ("wae1_d2",))],
]


def configs(**flags):
    """The port's tiny config with model flags."""
    cfg = presets.get_config("tiny")
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **flags))


FLAGS_ON = dict(pallas_bn=True, pallas_backward=True)


def build_state(kind: str, cfg, weights, moments, device="cpu"):
    """A fresh state of ``kind`` on ``device`` holding ``weights`` and
    ``moments``."""
    module = {"vgan1": VaeGan, "vgan2": VaeGanCognitiveTrain, "vgan3": VaeGanCognitiveTrain,
              "wae1": WaeGan, "wae2": WaeGanCognitiveTrain}[kind]
    nets = module(cfg)
    nets.load_state_dict(weights, strict=True)
    nets = nets.to(device)
    if kind == "vgan1":
        t = cfg.train
        state = make_state(nets, {g: RmsProp(t.rms_decay, t.rms_eps, t.grad_clip)
                                  for g in GROUPS}, moments)
    elif kind in ("vgan2", "vgan3"):
        state = make_cognitive_state(nets, cfg, int(kind[-1]), moments)
    elif kind == "wae1":
        state = make_wae_state(nets, cfg, moments)
    else:
        state = make_wae_cognitive_state(nets, cfg, 2, moments)
    return state


def make_step(kind: str, cfg, mesh=None):
    if kind == "vgan1":
        return make_vgan_stage1_step(cfg, mesh=mesh).train_step
    if kind in ("vgan2", "vgan3"):
        return make_vgan_cognitive_step(cfg, int(kind[-1]), mesh=mesh).train_step
    if kind == "wae1":
        return make_wae_stage1_step(cfg, mesh=mesh).train_step
    return make_wae_cognitive_step(cfg, 2, mesh=mesh).train_step


def warm(state):
    """RMSprop moments at one, Adam's second moments at one."""
    for m in state.opt_state.values():
        for v in (m.nu if isinstance(m, AdamState) else m).values():
            v.fill_(1.0)
    return state


def moments_of(state):
    return {g: (AdamState({k: v.clone() for k, v in m.mu.items()},
                          {k: v.clone() for k, v in m.nu.items()}, m.count.clone())
                if isinstance(m, AdamState) else {k: v.clone() for k, v in m.items()})
            for g, m in state.opt_state.items()}


def run_single(case, reverse=False, device="cpu"):
    """The single-process reference on ``device``: (metrics per step, host
    tree after the steps); with ``reverse`` each batch in reverse row
    order."""
    cfg = configs(**case["flags"])
    state = build_state(case["kind"], cfg, case["weights"], case["moments"], device)
    step = make_step(case["kind"], cfg)
    metrics = []
    for args in case["steps"]:
        args = [a.to(device) if torch.is_tensor(a) else a for a in args]
        if reverse:
            args = [a.flip(0) if torch.is_tensor(a) else a for a in args]
        state, m = step(state, *args)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, store.host_tree(state)


# ------------------------------------------------------------------ worker


def _rows(mesh, a):
    return mesh.rows(a).to(mesh.device) if torch.is_tensor(a) else a


def run_case(case, mesh, ckpt_dir=None):
    """One case on this rank: metrics per step, the host tree, this rank's
    fc1 shard and, for a checkpoint case, whether the resumed run equals the
    uninterrupted one bit for bit."""
    from fmri_tpu_torch.parallel.mesh import shard_state

    cfg = configs(**case["flags"])

    def fresh():
        state = build_state(case["kind"], cfg, case["weights"], case["moments"])
        return shard_state(state, mesh, **case["tp"])

    step = make_step(case["kind"], cfg, mesh)
    state, metrics = fresh(), []
    n_ckpt = case.get("ckpt_after")
    for i, args in enumerate(case["steps"]):
        state, m = step(state, *(_rows(mesh, a) for a in args))
        metrics.append({k: float(v) for k, v in m.items()})
        if n_ckpt == i + 1:
            store.save_checkpoint(ckpt_dir, i, state, {"seed": 0})
            tree = store.host_tree(state)
    out = {"metrics": metrics, "tree": tree if n_ckpt else store.host_tree(state)}
    if state.shards:
        out["shards"] = {f"{g}/{k}": state.nets.group(g)[k].detach().clone()
                         for g, k in state.shards}
    if n_ckpt:
        full = store.host_tree(state)
        resumed, _ = store.restore_checkpoint(ckpt_dir, fresh())
        for args in case["steps"][n_ckpt:]:
            resumed, _ = step(resumed, *(_rows(mesh, a) for a in args))
        again = store.host_tree(resumed)
        out["resume_equal"] = _trees_equal(full, again)
    return out


def _flat(tree, prefix=""):
    if torch.is_tensor(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")


def _trees_equal(a, b) -> bool:
    fa, fb = dict(_flat(a)), dict(_flat(b))
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)


def worker(argv) -> None:
    from fmri_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    p = argparse.ArgumentParser()
    p.add_argument("--worker", required=True, help="the work dir")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--ports", required=True)
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    from fmri_tpu_torch.device import resolve_device

    resolve_device(args.device)  # on a card: TF32 off, as the reference's step
    cases = torch.load(os.path.join(args.worker, "inputs.pt"), weights_only=False)
    ports = iter(int(x) for x in args.ports.split(","))
    results = {}
    for rnd in cases["rounds"]:
        for ranks, names in rnd:
            port = next(ports)
            if args.rank not in ranks:
                continue
            world, rank = len(ranks), ranks.index(args.rank)
            backend = "gloo"
            initialize_multihost(f"localhost:{port}", world, rank, backend=backend)
            for name in names:
                case = cases["cases"][name]
                mesh = make_mesh(*case["mesh"], devices=[args.device] * world,
                                 backend=backend)
                results[name] = run_case(case, mesh,
                                         os.path.join(args.worker, f"ckpt_{name}"))
            mesh.close()
    buf = io.BytesIO()
    torch.save(results, buf)
    with open(os.path.join(args.worker, f"out_{args.rank}.pt"), "wb") as f:
        f.write(buf.getvalue())


def start_workers(work: str, cases, rounds, device="cpu", n=WORKERS):
    """Write the inputs and start ``n`` worker processes; returns them."""
    from fmri_tpu_torch.parallel.mesh import free_port

    torch.save({"cases": cases, "rounds": rounds}, os.path.join(work, "inputs.pt"))
    ports = ",".join(str(free_port()) for rnd in rounds for _ in rnd)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", work, "--rank", str(r),
         "--ports", ports, "--device", device],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]


def join_workers(work: str, procs, timeout=120):
    """Each worker's results, {rank: {case: out}}; a worker that fails or
    hangs fails the caller with its output."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {r} failed:\n{out[-4000:]}"
    return {r: torch.load(os.path.join(work, f"out_{r}.pt"), weights_only=False)
            for r in range(len(procs))}


# ------------------------------------------------------------------ inputs


def _images(rng, n, size=16):
    return torch.from_numpy(rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32))


def _normal(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _gate(cfg):
    t = cfg.train
    return (t.margin, t.equilibrium, t.lambda_mse)


def stage1_case(seed, data, steps=1, flags=FLAGS_ON, gate=None):
    cfg = configs(**flags)
    rng = np.random.default_rng(seed)
    state = warm(build_state("vgan1", cfg, init_vaegan(cfg, seed).state_dict(), None))
    lat = cfg.model.latent_dim
    return dict(kind="vgan1", mesh=(data, 1), tp={}, flags=flags,
                weights=state.nets.state_dict(), moments=moments_of(state),
                steps=[(_images(rng, B), _normal(rng, B, lat), _normal(rng, B, lat),
                        *(gate or _gate(cfg))) for _ in range(steps)])


def cognitive_case(kind, seed, mesh, tp, steps=1, flags=FLAGS_ON, weights=None,
                   noise=None, ckpt_after=None):
    cfg = configs(**flags)
    rng = np.random.default_rng(seed)
    stage = int(kind[-1])
    if weights is None:
        weights = convert.from_jax_groups(convert.random_groups(cfg, seed, KIND), cfg, KIND)
    state = warm(build_state(kind, cfg, weights, None))
    lat, v = cfg.model.latent_dim, cfg.model.num_voxels
    batches = []
    for i in range(steps):
        fmri, image = _normal(rng, B, v), _images(rng, B)
        eps = noise[i] if noise is not None else [_normal(rng, B, lat) for _ in range(3)]
        batches.append((fmri, image, *eps, *_gate(cfg)))
    assert stage in (2, 3)
    return dict(kind=kind, mesh=mesh, tp=tp, flags=flags, weights=weights,
                moments=moments_of(state), steps=batches, ckpt_after=ckpt_after)


def wae_case(kind, seed, mesh, tp, flags=FLAGS_ON):
    cfg = configs(**flags)
    rng = np.random.default_rng(seed)
    nets = init_wae(cfg, seed) if kind == "wae1" else init_wae_cognitive(cfg, seed=seed)
    state = warm(build_state(kind, cfg, nets.state_dict(), None))
    lat, v = cfg.model.latent_dim, cfg.model.num_voxels
    if kind == "wae1":
        args = (_images(rng, B), cfg.train.wae_sigma * _normal(rng, B, lat))
    else:
        args = (_normal(rng, B, v), _images(rng, B))
    return dict(kind=kind, mesh=mesh, tp=tp, flags=flags, weights=state.nets.state_dict(),
                moments=moments_of(state), steps=[args])


def jax_noise(key, b, latent):
    """eps, eps_t, z_p as the JAX cognitive step draws them from its key."""
    import jax
    import jax.numpy as jnp

    return [torch.from_numpy(np.array(jax.random.normal(k, (b, latent), jnp.float32)))
            for k in jax.random.split(key, 3)]


def gate_trap_case(seed=21):
    """A stage-I batch ordered so that data rank 0's rows have the lower
    mean of the gate's lower term: with the threshold between that rank's
    mean and the global batch's, the global gate trains the discriminator
    and a gate on rank 0's own rows would skip it."""
    cfg = configs()
    case = stage1_case(seed, 2, flags={})
    x, eps, z_p = case["steps"][0][:3]
    nets = build_state("vgan1", cfg, case["weights"], case["moments"]).nets.train()
    with torch.no_grad():
        mu, lv = nets.encoder(x)
        x_tilde, x_p = nets.decoder(reparameterize(mu, lv, eps)), nets.decoder(z_p)
        _, score = nets.discriminator(torch.cat([x, x_tilde, x_p]))
    orig = -torch.log(score[:B, 0] + 1e-3)
    pred = -torch.log(1.0 - score[B:2 * B, 0] + 1e-3)
    key = orig if orig.mean() <= pred.mean() else pred
    order = key.argsort()
    orig, pred = orig[order], pred[order]
    low_rank = min(float(a[:B // 2].mean()) for a in (orig, pred))
    low_all = min(float(orig.mean()), float(pred.mean()))
    high = max(float(a[h].mean()) for a in (orig, pred)
               for h in (slice(0, B // 2), slice(B // 2, B), slice(0, B))) + 1.0
    threshold = 0.5 * (low_rank + low_all)
    margin, equilibrium = 0.5 * (high - threshold), 0.5 * (high + threshold)
    case["steps"] = [(x[order], eps[order], z_p[order], margin, equilibrium,
                      cfg.train.lambda_mse)]
    case["trap"] = dict(low_rank=low_rank, low_all=low_all, threshold=threshold)
    return case


# ------------------------------------------------------------------ fixture


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's inputs, the four workers' results, and the references:
    the port's single-process step of each case and the JAX mesh step."""
    import jax

    from fmri_tpu.configs import presets as jax_presets

    torch.set_num_threads(1)
    work = str(tmp_path_factory.mktemp("mesh"))
    cfg_off = configs()
    jax_groups = convert.random_groups(cfg_off, 3, KIND)
    key = jax.random.key(7)
    cases = {
        "stage2_jax": cognitive_case(
            "vgan2", 3, (2, 2), dict(voxel_tp=True), flags={},
            weights=convert.from_jax_groups(jax_groups, cfg_off, KIND),
            noise=[jax_noise(key, B, cfg_off.model.latent_dim)]),
        "stage3_tp": cognitive_case("vgan3", 4, (2, 2), dict(voxel_tp=True, decoder_tp=True),
                                    steps=4, ckpt_after=2),
        "wae2_tp": wae_case("wae2", 5, (2, 2), dict(voxel_tp=True)),
        "stage1_d4": stage1_case(6, 4),
        "stage1_d2": stage1_case(6, 2),
        "gate_trap": gate_trap_case(),
        "wae1_d2": wae_case("wae1", 8, (2, 1), {}),
    }
    procs = start_workers(work, cases, ROUNDS)
    try:
        single, noise = {}, {}
        for name, case in cases.items():
            first = dict(case, steps=case["steps"][:case.get("ckpt_after") or len(case["steps"])])
            single[name] = run_single(first)
            noise[name] = run_single(first, reverse=True)[1]
        jcfg = jax_presets.get_config("tiny")
        jax_ref = jax_mesh_step(jcfg, jax_groups, cases["stage2_jax"], key)
    finally:
        results = join_workers(work, procs)
    return dict(cases=cases, results=results, single=single, noise=noise, jax=jax_ref,
                work=work)


def jax_mesh_step(jcfg, groups, case, key):
    """The JAX stage-II step on a data=2 x model=2 mesh over 4 of the 8
    virtual devices, moments at one: (metrics, groups after the step)."""
    import jax
    import jax.numpy as jnp

    from fmri_tpu.parallel import make_mesh, shard_batch, shard_state
    from fmri_tpu.train import RmsProp as JaxRmsProp
    from fmri_tpu.train import make_state as jax_make_state
    from fmri_tpu.train import make_vgan_cognitive_step
    from fmri_tpu.train.optim import RmsState

    t = jcfg.train
    opt = JaxRmsProp(t.rms_decay, t.rms_eps, clip=1.0)
    state = jax_make_state(groups, {g: opt for g in ("encoder", "discriminator")})
    state = state.replace(opt_state={g: RmsState(jax.tree_util.tree_map(jnp.ones_like, s.sq_avg))
                                     for g, s in state.opt_state.items()})
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    fmri, image = case["steps"][0][:2]
    batch = shard_batch({"fmri": fmri.numpy(), "image": image.numpy()}, mesh, voxel_tp=True)
    step = make_vgan_cognitive_step(jcfg, stage=2, donate=False)
    state, m = step.train_step(shard_state(state, mesh, voxel_tp=True), batch, key,
                               *(jnp.float32(v) for v in _gate(jcfg)))
    after = {g: {"params": jax.device_get(state.params[g]),
                 "batch_stats": jax.device_get(state.batch_stats[g])} for g in groups}
    assert "model" in str(state.params["encoder"]["fc1"]["kernel"].sharding.spec)
    return {k: float(v) for k, v in m.items()}, after


# ------------------------------------------------------------------ checks


def _rel(a, b, scale) -> float:
    return float((a.double() - b.double()).norm() / max(float(scale.double().norm()), 1e-30))


def check_against_single(name, runs, tol=TOL):
    """Every rank's metrics, parameters, moments and BN statistics against
    the single-process step; replicas bitwise equal across ranks."""
    case, ref_metrics, ref = runs["cases"][name], *runs["single"][name]
    ranks = [r for r, res in runs["results"].items() if name in res]
    assert len(ranks) == case["mesh"][0] * case["mesh"][1]
    first = runs["results"][ranks[0]][name]
    for r in ranks:
        got = runs["results"][r][name]
        assert _trees_equal(got["tree"], first["tree"]), f"{name}: rank {r}'s replica differs"
        for m, rm in zip(got["metrics"], ref_metrics):
            for k, v in rm.items():
                assert m[k] == pytest.approx(v, rel=tol["loss"], abs=1e-7), (name, k)
    start = case["weights"]
    tree, noise = first["tree"], runs["noise"][name]

    def close(got, other, v, scale, kind, what):
        bound = max(tol[kind], FLOOR * _rel(other, v, scale))
        assert _rel(got, v, scale) <= bound, (name, *what)

    for g, sd in ref["groups"].items():
        for k, v in sd.items():
            got, other = tree["groups"][g][k], noise["groups"][g][k]
            assert got.shape == v.shape, (g, k)
            if k.endswith("num_batches_tracked"):
                assert torch.equal(got, v), (g, k)
            elif "running" in k:
                close(got, other, v, v, "stats", (g, k))
            else:
                moved = v - _start_of(start, case["kind"], g, k)
                if float(moved.abs().max()) == 0.0:
                    assert torch.equal(got, v), (name, g, k)
                else:
                    close(got, other, v, moved, "param", (g, k))
    for g, saved in ref["opt_state"].items():
        for part, moments in saved.items():
            if part == "count":
                assert torch.equal(tree["opt_state"][g][part], moments)
                continue
            for k, v in moments.items():
                close(tree["opt_state"][g][part][k], noise["opt_state"][g][part][k], v, v,
                      "mu" if part == "mu" else "sq", (g, part, k))


PREFIXES = {"vgan1": VaeGan.PREFIXES, "vgan2": VaeGanCognitiveTrain.PREFIXES,
            "vgan3": VaeGanCognitiveTrain.PREFIXES, "wae1": WaeGan.PREFIXES,
            "wae2": WaeGanCognitiveTrain.PREFIXES}


def _start_of(weights, kind, group, key):
    return weights[PREFIXES[kind][group] + key]


@pytest.mark.parametrize("name", ["stage1_d2", "stage1_d4", "stage3_tp", "wae1_d2",
                                  "wae2_tp"])
def test_mesh_step_matches_the_single_process_step(runs, name):
    """Stage I at data=2 and data=4 with both kernel flags (off the card
    their plain versions, with the all-reduce between the two BatchNorm
    passes), stage III at data=2 x model=2 with fc1 and the decoder's
    projection sharded (two steps), WAE I at data=2 and WAE II at data=2 x
    model=2."""
    check_against_single(name, runs)


def test_stage2_dp_tp_matches_the_jax_mesh_step(runs):
    """The port's stage-II step at data=2, model=2 and the JAX step on the
    same mesh, from one state (``from_jax_groups``) with the JAX key's
    eps / eps_t / z_p: losses, every parameter, and each rank's fc1 shard
    the matching voxel columns of the JAX kernel."""
    cfg = configs()
    jm, after = runs["jax"]
    ref = convert.from_jax_groups(after, cfg, KIND)
    for r, res in runs["results"].items():
        got = res["stage2_jax"]
        for k in ("loss_encoder", "loss_decoder", "loss_discriminator", "loss_reconstruction"):
            assert got["metrics"][0][k] == pytest.approx(jm[k], rel=JAX_TOL["loss"]), k
        tree = got["tree"]["groups"]
        for key, v in ref.items():
            if key.endswith("num_batches_tracked") or "teacher_net" in key:
                continue
            g, k = key.split(".", 1)
            np.testing.assert_allclose(tree[g][k].numpy(), v.numpy(), rtol=JAX_TOL["rtol"],
                                       atol=JAX_TOL["atol"], err_msg=key)
        shard = got["shards"]["encoder/fc1.0.weight"]
        lo = (r % 2) * shard.shape[1]  # model index r % 2: model innermost
        columns = ref["encoder.fc1.0.weight"][:, lo:lo + shard.shape[1]]
        np.testing.assert_allclose(shard.numpy(), columns.numpy(), rtol=JAX_TOL["rtol"],
                                   atol=JAX_TOL["atol"])
        assert shard.shape == (32, 64)


def test_bn_statistics_count_the_data_group_only(runs):
    """At data=2, model=2 every BatchNorm's running statistics equal the
    single-process tick (its unbiased variance over the global count): the
    model group's ranks hold the same rows, and a reduction over them too
    would double n in n / (n - 1)."""
    _, ref = runs["single"]["stage2_jax"]
    for r, res in runs["results"].items():
        tree = res["stage2_jax"]["tree"]["groups"]
        checked = 0
        for g, sd in ref["groups"].items():
            for k, v in sd.items():
                if "running_var" in k:
                    assert _rel(tree[g][k], v, v) <= 1e-6, (r, g, k)
                    checked += 1
        assert checked >= 10


def test_the_gate_takes_the_global_batchs_means(runs):
    """Rank 0's rows alone would skip the discriminator (their mean is below
    equilibrium - margin); the global batch's mean trains it, on both ranks,
    and the step equals the single-process one."""
    trap = runs["cases"]["gate_trap"]["trap"]
    assert trap["low_rank"] < trap["threshold"] < trap["low_all"]
    for r in (0, 1):
        assert runs["results"][r]["gate_trap"]["metrics"][0]["train_dis"] == 1.0
    assert runs["single"]["gate_trap"][0][0]["train_dis"] == 1.0
    check_against_single("gate_trap", runs)


def test_mesh_checkpoint_is_the_single_process_layout_and_resumes_exactly(runs):
    """Stage III at data=2 x model=2 (fc1 and the decoder projection
    sharded, RMSprop moments with them): the checkpoint after two steps has
    the single-process checkpoint's keys and shapes, with the shards
    gathered, and its values within the step tolerance; restored into a
    fresh placed state, two more steps give the uninterrupted run's state
    bit for bit."""
    path = os.path.join(runs["work"], "ckpt_stage3_tp", "ckpt_00001", "state.pt")
    saved = torch.load(path, weights_only=True)
    _, ref = runs["single"]["stage3_tp"]
    assert dict(_flat(saved)).keys() == dict(_flat(ref)).keys()
    for k, v in _flat(ref):
        assert dict(_flat(saved))[k].shape == v.shape, k
    assert tuple(saved["groups"]["decoder"]["fc.0.weight"].shape) == (64, 16)
    assert tuple(saved["groups"]["encoder"]["fc1.0.weight"].shape) == (32, 128)
    assert _trees_equal(saved, runs["results"][0]["stage3_tp"]["tree"])
    for r, res in runs["results"].items():
        assert res["stage3_tp"]["resume_equal"], f"rank {r}: resumed run differs"
    # it loads into a single-process state of the stage
    cfg = configs(**FLAGS_ON)
    state = build_state("vgan3", cfg, runs["cases"]["stage3_tp"]["weights"],
                        runs["cases"]["stage3_tp"]["moments"])
    store.restore_checkpoint(os.path.dirname(os.path.dirname(path)), state)
    assert int(state.step) == 2


# ------------------------------------------------------------------ layouts


@pytest.mark.parametrize("model", [2, 4, 8, 16, 32])
def test_fullbrain_fc1_shards_over_the_model_axis(model):
    """The ``fullbrain`` preset's fc1 (98,304 voxels, ~100M weights) splits
    its voxel axis over every power-of-two model axis, as geometry on the
    meta device (``tests/test_mesh.py``'s ``fullbrain`` case); a count that
    does not split raises."""
    from fmri_tpu_torch.parallel.dryrun import fullbrain_geometry

    geo = fullbrain_geometry(model)
    assert geo == {"fc1": [1024, 98304], "shard": [1024, 98304 // model]}
    with pytest.raises(ValueError, match="does not shard"):
        fullbrain_geometry(model * 5)


@pytest.mark.parametrize("world, rank, local, cards, mesh, error", [
    (4, 3, 1, 2, (4, 1), None),  # two hosts of two cards
    (8, 7, 3, 4, (8, 1), None),  # two hosts of four cards, data=8
    (4, 1, 1, 2, (8, 1), "mesh 8x1 exceeds 4 devices"),
    (4, 2, 2, 2, (2, 2), "card 2 .LOCAL_RANK. and the host has 2"),
])
def test_default_devices_span_hosts(monkeypatch, world, rank, local, cards, mesh, error):
    """With no devices given, a torchrun world across hosts is one card per
    rank: the mesh is held against the world's size, and this rank's
    ``LOCAL_RANK`` against its own host's cards."""
    from fmri_tpu_torch.parallel.mesh import _rank_device

    monkeypatch.setenv("LOCAL_RANK", str(local))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if error:
        with pytest.raises(ValueError, match=error):
            _rank_device(*mesh, world, rank, None)
    else:
        assert _rank_device(*mesh, world, rank, None) == torch.device("cuda", local)


def test_dryrun_runs_on_the_cards_unless_asked_for_the_cpu(monkeypatch):
    """The dry run and its CLI default to the cards and raise without one;
    the CPU is taken only when asked for."""
    from fmri_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: dryrun.dryrun_multichip(4), lambda: dryrun.main(["4"])):
        with pytest.raises(RuntimeError, match="is_available"):
            run()
    assert dryrun._devices(2, "cpu", False) == (["cpu", "cpu"], "gloo")


def test_dryrun_serves_over_the_stage2_mesh():
    """``dryrun_multichip(4, "cpu")``: every training path's step, then the
    serving part (``__graft_entry__.py:288-305``) from stage II's trained
    state over its data=2 x model=2 mesh, uint8 images."""
    from fmri_tpu_torch.parallel import dryrun

    results = dryrun.dryrun_multichip(4, device="cpu")
    assert all(r["ok"] for r in results.values() if "ok" in r)
    served = results["serving"]
    assert served["mesh"] == "dp=2 tp=2"
    assert 0.0 < served["recon_mean"] < 255.0 and 0.0 < served["gen_mean"] < 255.0


def test_mesh_layouts():
    """A rank's rows, columns and specs, from its coordinate alone
    (``model`` innermost): rank 3 of data=2 x model=2 is (1, 1)."""
    from fmri_tpu_torch.models.nets import CognitiveEncoder, Decoder
    from fmri_tpu_torch.parallel.mesh import (
        Mesh, batch_sharding, cognitive_param_specs, decoder_param_specs, replicated,
        shard_batch, shard_batch_multihost, shard_params,
    )

    mesh = Mesh(2, 2, rank=3, device=torch.device("cpu"), backend="gloo")
    assert (mesh.data_index, mesh.model_index) == (1, 1)
    assert mesh.data_rows(8) == (4, 8) and mesh.model_slice(128) == (64, 128)
    with pytest.raises(ValueError, match="not divisible by the mesh model axis"):
        mesh.model_slice(129)
    with pytest.raises(ValueError, match="batch_size=6 is not divisible"):
        Mesh(4, 1, rank=0, device=torch.device("cpu"), backend="gloo").data_rows(6)
    x = torch.arange(8.0).view(8, 1)
    assert torch.equal(shard_batch({"fmri": x.numpy()}, mesh)["fmri"], x[4:])
    assert batch_sharding(mesh, 2) == ("data", None) and replicated(mesh) == ()
    assert shard_batch_multihost is shard_batch
    cfg = configs()
    enc, dec = CognitiveEncoder(cfg.model), Decoder(cfg.model)
    enc_specs, dec_specs = cognitive_param_specs(enc), decoder_param_specs(dec)
    assert {k for k, v in enc_specs.items() if v} == {"fc1.0.weight"}
    assert {k for k, v in dec_specs.items() if v} == {"fc.0.weight"}
    local = shard_params(dict(dec.named_parameters()), mesh, dec_specs)
    assert torch.equal(local["fc.0.weight"], dec.fc[0].weight[:, 8:].detach())
    assert local["fc.1.weight"] is not None and local["fc.1.weight"].shape == (64,)


if __name__ == "__main__":
    worker(sys.argv[1:])
