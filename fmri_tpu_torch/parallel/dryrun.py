"""The dry run across ranks, its training half: one real step of every
training path on a mesh at ``tiny`` shapes.

Counterpart of ``dryrun_multichip`` in ``__graft_entry__.py:62-…``, whose
serving part comes with the serving mesh. ``n`` ranks are started as
processes (``torch.multiprocessing``, spawn) and each path's step runs on
them from one seed:

* stage I, WAE/GAN stage I, WAE/Dual-GAN and the DCGAN experiments (stage
  1 on images, stage 2 over its generator) data parallel over all ranks;
* stage II, WAE stage II data x voxel tensor parallel (``model=2`` where
  ``n`` is even), and stages III of both families with the decoder's
  projection sharded too;
* the ``fullbrain`` voxel count's ``fc1`` at ``model=4``, as geometry only
  (the real weight is ~100M parameters), on the ``meta`` device.

Each path's losses must be finite and every rank's replicated parameters
equal to rank 0's, bit for bit. It runs on the cards, one per rank over
NCCL, or with ``share_card=True`` all ranks on ``cuda:0`` over gloo, asked
for by name; ``device="cpu"`` runs over gloo on the CPU.

    python -m fmri_tpu_torch.parallel.dryrun 4 [--share-card | --device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Dict

import torch

from fmri_tpu_torch.device import resolve_device
from fmri_tpu_torch.parallel.mesh import (
    cognitive_param_specs, free_port, initialize_multihost, make_mesh, shard_state,
)


def _devices(n: int, device: str, share_card: bool):
    """(devices, backend) of an n-rank run on ``device``."""
    if device == "cpu":
        return ["cpu"] * n, "gloo"
    resolve_device(device)  # no card: raise, never the CPU
    if share_card:
        return ["cuda:0"] * n, "gloo"
    if torch.cuda.device_count() < n:
        raise ValueError(f"dryrun over {n} ranks needs {n} cards, one each; this machine "
                         f"has {torch.cuda.device_count()} (share_card=True puts the "
                         f"ranks on one card over gloo)")
    return [f"cuda:{i}" for i in range(n)], "nccl"


def _replicas_equal(state, mesh) -> bool:
    """Every replicated trained parameter equal to rank 0's, on every rank."""
    flat = torch.cat([p.detach().reshape(-1) for g in state.opt_state
                      for k, p in state.nets.group(g).items() if (g, k) not in state.shards])
    same = torch.equal(flat, mesh.broadcast(flat.clone()))
    bad = torch.tensor([0.0 if same else 1.0], device=mesh.device)
    torch.distributed.all_reduce(bad)
    return float(bad.item()) == 0.0


def _paths(mesh_dp, mesh_tp, b: int) -> Dict[str, tuple]:
    """{path: (state, step, args, loss key)} of every training path, each
    on its mesh with this rank's rows of one seeded global batch."""
    from fmri_tpu_torch.configs import get_config
    from fmri_tpu_torch.train.state import (
        CognitiveVaeGan, DcGan, init_cognitive, init_groups, init_vaegan, init_wae,
        init_wae_cognitive, init_wae_dual_gan, make_cognitive_state, make_state,
        make_wae_cognitive_state, make_wae_dual_gan_state, make_wae_state,
    )
    from fmri_tpu_torch.train.optim import RmsProp
    from fmri_tpu_torch.train.steps_exp import make_dcgan_stage1_step, make_dcgan_stage2_step
    from fmri_tpu_torch.train.steps_vgan import make_vgan_cognitive_step, make_vgan_stage1_step
    from fmri_tpu_torch.train.steps_wae import (
        make_wae_cognitive_step, make_wae_stage1_step, make_wae_vgan_step,
    )

    cfg = get_config("tiny")
    t, c = cfg.train, cfg.model
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((b, c.image_size, c.image_size, 3), generator=gen) * 2.0 - 1.0
    fmri = torch.randn((b, c.num_voxels), generator=gen)
    eps, eps_t, z_p, z_fake = (torch.randn((b, c.latent_dim), generator=gen) for _ in range(4))
    gate = (t.margin, t.equilibrium, t.lambda_mse)
    rms = RmsProp(decay=t.rms_decay, eps=t.rms_eps, clip=1.0)

    def rows(mesh, *ts):
        return [mesh.rows(a).to(mesh.device) for a in ts]

    dp, tp, both = dict(mesh=mesh_dp), dict(mesh=mesh_tp, voxel_tp=True), dict(
        mesh=mesh_tp, voxel_tp=True, decoder_tp=True)
    dcgan_opts = {"decoder": RmsProp(decay=t.rms_decay, eps=t.rms_eps), "discriminator": rms}
    paths = {  # path: (state, placement, step maker, step inputs, loss key)
        "stage1": (make_state(init_vaegan(cfg, 0), {g: rms for g in (
            "encoder", "decoder", "discriminator")}), dp, make_vgan_stage1_step,
            (x, eps, z_p, *gate), "loss_encoder"),
        "stage2": (make_cognitive_state(init_cognitive(cfg, seed=3), cfg, 2), tp,
                   lambda c_, mesh: make_vgan_cognitive_step(c_, 2, mesh=mesh),
                   (fmri, x, eps, eps_t, z_p, *gate), "loss_encoder"),
        "stage3": (make_cognitive_state(init_cognitive(cfg, seed=3), cfg, 3), both,
                   lambda c_, mesh: make_vgan_cognitive_step(c_, 3, mesh=mesh),
                   (fmri, x, eps, eps_t, z_p, *gate), "loss_decoder"),
        "wae_stage1": (make_wae_state(init_wae(cfg, 10), cfg), dp, make_wae_stage1_step,
                       (x, z_fake), "loss_reconstruction"),
        "wae_stage2": (make_wae_cognitive_state(init_wae_cognitive(cfg, seed=13), cfg, 2), tp,
                       lambda c_, mesh: make_wae_cognitive_step(c_, 2, mesh=mesh),
                       (fmri, x), "loss_reconstruction"),
        "wae_stage3": (make_wae_cognitive_state(init_wae_cognitive(cfg, seed=13), cfg, 3), both,
                       lambda c_, mesh: make_wae_cognitive_step(c_, 3, mesh=mesh),
                       (fmri, x), "loss_reconstruction"),
        "wae_vgan_stage1": (make_wae_dual_gan_state(init_wae_dual_gan(cfg, 7), cfg), dp,
                            make_wae_vgan_step, (x, eps, z_p, z_fake, *gate), "loss_encoder"),
        "exp_dcgan_stage1": (make_state(init_groups(DcGan, cfg, 5), {
            "decoder": rms, "discriminator": rms}), dp, make_dcgan_stage1_step,
            (x, z_p, *gate), "loss_decoder"),
        "exp_dcgan_stage2": (make_state(init_groups(CognitiveVaeGan, cfg, 6), dcgan_opts), dp,
                             make_dcgan_stage2_step, (fmri, x, eps, z_p, *gate),
                             "loss_decoder"),
    }
    out = {}
    for path, (state, place, maker, args, key) in paths.items():
        mesh = place["mesh"]
        out[path] = (shard_state(state, **place), maker(cfg, mesh=mesh),
                     (*rows(mesh, *(a for a in args if torch.is_tensor(a))),
                      *(a for a in args if not torch.is_tensor(a))), key)
    return out


def fullbrain_geometry(model: int = 4) -> Dict[str, list]:
    """The ``fullbrain`` cognitive encoder's ``fc1`` sharded over ``model``
    ranks, on the meta device: {"fc1": full shape, "shard": per rank}."""
    from fmri_tpu_torch.configs import get_config
    from fmri_tpu_torch.models.nets import CognitiveEncoder

    cfg = get_config("fullbrain")
    with torch.device("meta"):
        enc = CognitiveEncoder(cfg.model)
    spec = cognitive_param_specs(enc)["fc1.0.weight"]
    hidden, voxels = enc.fc1[0].weight.shape
    if spec != (None, "model") or voxels % model:
        raise ValueError(f"fullbrain fc1 {[hidden, voxels]} does not shard over "
                         f"model={model} (spec {spec})")
    return {"fc1": [hidden, voxels], "shard": [hidden, voxels // model]}


def _rank(rank: int, n: int, port: int, device: str, share_card: bool, out) -> None:
    devices, backend = _devices(n, device, share_card)
    if device == "cpu":  # n ranks share the host's cores
        torch.set_num_threads(1)
    initialize_multihost(f"localhost:{port}", n, rank, backend=backend)
    model = 2 if n % 2 == 0 and n >= 2 else 1
    mesh_dp = make_mesh(n, 1, devices, backend)
    mesh_tp = make_mesh(n // model, model, devices, backend)
    b = max(2 * n, 8)
    results = {}
    for path, (state, step, args, key) in _paths(mesh_dp, mesh_tp, b).items():
        state, metrics = step.train_step(state, *args)
        losses = {k: float(v) for k, v in metrics.items() if k.startswith("loss")}
        mesh = state.mesh
        ok = all(math.isfinite(v) for v in losses.values()) and _replicas_equal(state, mesh)
        results[path] = {"loss": losses[key], "key": key, "ok": ok,
                         "mesh": f"dp={mesh.data} tp={mesh.model}"}
        if rank == 0:
            print(f"dryrun {path} {results[path]['mesh']}: {key}={losses[key]:.3f}"
                  f"{'' if ok else ' FAILED'}", flush=True)
    if rank == 0:
        results["fullbrain"] = fullbrain_geometry(4)
        print(f"dryrun fullbrain fc1 {results['fullbrain']['fc1']} at tp=4: "
              f"{results['fullbrain']['shard']} per rank", flush=True)
        out.put(results)
    mesh_dp.close()


def dryrun_multichip(n: int, device: str = "cuda", share_card: bool = False) -> dict:
    """One step of every training path over ``n`` ranks; returns rank 0's
    ``{path: {"loss", "key", "ok", "mesh"}, "fullbrain": ...}`` and raises
    if a path failed."""
    import torch.multiprocessing as mp

    _devices(n, device, share_card)  # refuse before starting anything
    out = mp.get_context("spawn").SimpleQueue()
    mp.spawn(_rank, args=(n, free_port(), device, share_card, out), nprocs=n, join=True)
    results = out.get()
    failed = [p for p, r in results.items() if p != "fullbrain" and not r["ok"]]
    if failed:
        raise RuntimeError(f"dryrun over {n} ranks: {failed} failed (non-finite losses "
                           f"or replicas that differ)")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--share-card", action="store_true",
                   help="every rank on cuda:0 over gloo")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.share_card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
