"""Serving over a mesh of ranks (``ServingModel(mesh=, voxel_tp=)``) on the CPU
over gloo, at ``tiny``: data=2 x model=2 with ``voxel_tp`` against the JAX
``ServingModel`` on ``make_mesh(data=2, model=2)`` over 4 of the conftest's
8 virtual devices (as ``tests/test_serve.py``'s voxel-TP test, one bucket
compiled), and data=4, data=2 and data=2 x model=2 against the port's
single-process server with the same seed and the same buckets:
``reconstruct``, sampled ``reconstruct``, ``generate``, ``reload`` (one
accepted, one refused on every rank, one refused by a follower alone).

The ranks are four worker processes started once for the module
(``python tests/test_torch_serve_mesh.py --worker ...``, each with its own
``communicate(timeout=...)``, so a hang fails in seconds): rank 0 calls
the server, the other ranks follow it. They run in rounds, a world of four,
then two worlds of two, and write rank 0's answers and every rank's
weights after the calls.

Tolerances, as ``tests/test_torch_serve.py``: float images 1e-5 (fp32
both sides, ``fc1`` summed in another order under ``voxel_tp``, other
batch shapes per rank), uint8 images 1 LSB.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # the worker runs this file as a script
    sys.path.insert(0, REPO)

from fmri_tpu_torch.checkpoints import convert  # noqa: E402
from fmri_tpu_torch.configs import get_config  # noqa: E402
from fmri_tpu_torch.eval.serve import ServingModel  # noqa: E402
from fmri_tpu_torch.eval.steps import eval_module  # noqa: E402
from fmri_tpu_torch.parallel.mesh import Mesh  # noqa: E402

TOL = 1e-5
WORKERS = 4
KINDS = {("vgan", 1): "vae-gan", ("vgan", 2): "vae-gan-cognitive-eval",
         ("vgan", 3): "vae-gan-cognitive-eval"}
ROUNDS = [
    [((0, 1, 2, 3), ("jax", "tp", "d4"))],
    [((0, 1), ("d2",)), ((2, 3), ("d2_image",))],
]


def weights(family, stage, seed, preset="tiny"):
    """The eval module's state dict of seeded random groups, and the groups."""
    cfg = get_config(preset)
    kind = KINDS[(family, stage)]
    groups = convert.random_groups(cfg, seed=seed, kind=kind)
    sd = {k: v for k, v in convert.from_jax_groups(groups, cfg, kind).items()
          if not k.startswith(convert.UNUSED_PREFIXES)}
    return sd, groups


def server(case, mesh=None, min_bucket=None, device="cpu"):
    """The case's ServingModel: on ``mesh``, or single-process on ``device``
    with the mesh's buckets (``min_bucket``)."""
    cfg = get_config(case["preset"])
    model = eval_module(case["family"], case["stage"])[0](cfg.model)
    model.load_state_dict(case["weights"], strict=True)
    kw = dict(family=case["family"], stage=case["stage"], max_batch=case["max_batch"],
              sample=case["sample"], seed=case["seed"], output=case["output"], device=device)
    if mesh is None:
        return ServingModel(cfg, model, min_bucket=min_bucket or case["min_bucket"], **kw)
    return ServingModel(cfg, model, min_bucket=case["min_bucket"], mesh=mesh,
                        voxel_tp=case["voxel_tp"], **kw)


def run_ops(served, ops, skip=()):
    """Each op's answer: ("ok", array or dict) or ("error", type, message)."""
    out = []
    for op in ops:
        if op[0] in skip:
            continue
        try:
            if op[0] == "reconstruct":
                out.append(("ok", served.reconstruct(op[1])))
            elif op[0] == "generate":
                out.append(("ok", served.generate(op[1])))
            else:
                out.append(("ok", served.reload(op[1])))
        except Exception as exc:  # noqa: BLE001 - the answer under test
            out.append(("error", type(exc).__name__, str(exc)))
    return out


# ------------------------------------------------------------------ worker


def count_collectives(counts):
    """Wrap ``torch.distributed``'s two collectives to count, in
    ``counts``, every call and those made while a CUDA graph is captured."""
    import torch.distributed as dist

    def wrap(fn):
        def counted(*a, **k):
            counts["calls"] += 1
            if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                counts["in_capture"] += 1
            return fn(*a, **k)
        return counted

    dist.all_reduce, dist.broadcast = wrap(dist.all_reduce), wrap(dist.broadcast)


def worker(argv) -> None:
    from fmri_tpu_torch.device import resolve_device
    from fmri_tpu_torch.eval import inference
    from fmri_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    p = argparse.ArgumentParser()
    p.add_argument("--worker", required=True, help="the work dir")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--ports", required=True)
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    resolve_device(args.device)  # on a card: TF32 off
    counts = {"calls": 0, "in_capture": 0}
    count_collectives(counts)
    cases = torch.load(os.path.join(args.worker, "inputs.pt"), weights_only=False)
    ports = iter(int(x) for x in args.ports.split(","))
    real_load = inference.load_weights
    results = {}
    for rnd in cases["rounds"]:
        for ranks, names in rnd:
            port = next(ports)
            if args.rank not in ranks:
                continue
            world, rank = len(ranks), ranks.index(args.rank)
            initialize_multihost(f"localhost:{port}", world, rank, backend="gloo")
            for name in names:
                case = cases["cases"][name]
                mesh = make_mesh(*case["mesh"], devices=[args.device] * world,
                                 backend="gloo")

                def load(path, epoch=None, _fail=case.get("fails_on", {}).get(rank)):
                    if path == _fail:
                        raise OSError(f"rank {rank} cannot read {path}")
                    return real_load(path, epoch)

                inference.load_weights = load
                served = server(case, mesh)
                res = {"shard": tuple(served.model.encoder.fc1[0].weight.shape)
                       if hasattr(served.model.encoder, "fc1") else None}
                if rank == 0:
                    served.warmup()
                    res["answers"] = run_ops(served, case["ops"])
                    served.stop()
                else:
                    served.follow()
                res["state"] = {k: v.cpu() for k, v in served.model.state_dict().items()}
                res.update(buckets=served.buckets, graphs=served.graphs, **counts)
                results[name] = res
                inference.load_weights = real_load
            mesh.close()
    torch.save(results, os.path.join(args.worker, f"out_{args.rank}.pt"))


def start_workers(work, cases, rounds, device="cpu"):
    from fmri_tpu_torch.parallel.mesh import free_port

    torch.save({"cases": cases, "rounds": rounds}, os.path.join(work, "inputs.pt"))
    ports = ",".join(str(free_port()) for rnd in rounds for _ in rnd)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", work, "--rank", str(r),
         "--ports", ports, "--device", device], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORKERS)]


def join_workers(work, procs, timeout=120):
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


# ------------------------------------------------------------------ fixture


def requests(n, shape, seed):
    rng = np.random.default_rng(seed)
    if len(shape) == 3:  # images in [0, 1]
        return rng.uniform(size=(n, *shape)).astype(np.float32)
    return rng.normal(size=(n, *shape)).astype(np.float32)


def make_case(family, stage, seed, mesh, voxel_tp=False, max_batch=8, min_bucket=1,
              sample=False, output="float", ops=(), preset="tiny", **extra):
    sd, groups = weights(family, stage, seed, preset)
    return dict(family=family, stage=stage, seed=seed, mesh=mesh, voxel_tp=voxel_tp,
                preset=preset,
                max_batch=max_batch, min_bucket=min_bucket, sample=sample, output=output,
                ops=list(ops), weights=sd, groups=groups, **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case, the workers' results and the single-process answers."""
    torch.set_num_threads(1)
    work = str(tmp_path_factory.mktemp("serve_mesh"))
    v = get_config("tiny").model.num_voxels
    fmri5, fmri11 = requests(5, (v,), 1), requests(11, (v,), 2)
    images = requests(11, (16, 16, 3), 3)
    other, wrong, unread = (os.path.join(work, f"{n}.pth") for n in ("other", "wrong", "unread"))
    torch.save(weights("vgan", 3, 11)[0], other)
    torch.save(weights("vgan", 3, 12)[0], unread)
    torch.save(weights("vgan", 1, 13)[0], wrong)  # a visual encoder: other keys
    cases = {
        # the JAX mesh server compiles one bucket of 8
        "jax": make_case("vgan", 2, 5, (2, 2), voxel_tp=True, min_bucket=8,
                         ops=[("reconstruct", fmri5)]),
        "tp": make_case("vgan", 3, 6, (2, 2), voxel_tp=True, sample=True,
                        ops=[("reconstruct", fmri5), ("generate", 3), ("reload", other),
                             ("reconstruct", fmri5), ("reload", wrong),
                             ("reload_unread", unread), ("reconstruct", fmri11),
                             ("generate", 11)],
                        fails_on={3: unread}),
        "d4": make_case("vgan", 3, 7, (4, 1), sample=True,
                        ops=[("reconstruct", fmri5), ("reconstruct", fmri11),
                             ("generate", 11)]),
        "d2": make_case("vgan", 2, 8, (2, 1), sample=True, output="uint8",
                        ops=[("reconstruct", fmri11), ("generate", 5)]),
        "d2_image": make_case("vgan", 1, 9, (2, 1), ops=[("reconstruct", images),
                                                         ("generate", 3)]),
    }
    procs = start_workers(work, cases, ROUNDS)
    try:
        single = {}
        for name, case in cases.items():
            data = case["mesh"][0]
            ref = server(case, min_bucket=max(case["min_bucket"], data))
            single[name] = run_ops(ref, case["ops"], skip=("reload_unread",))
        jax_out = jax_mesh_reconstruct(cases["jax"])
    finally:
        results = join_workers(work, procs)
    return dict(cases=cases, results=results, single=single, jax=jax_out,
                paths=dict(other=other, wrong=wrong, unread=unread))


def jax_mesh_reconstruct(case):
    """The JAX ServingModel on a data=2 x model=2 mesh of 4 virtual devices."""
    import jax

    from fmri_tpu.configs import get_config as jax_config
    from fmri_tpu.eval.serve import ServingModel as JaxServingModel
    from fmri_tpu.parallel.mesh import make_mesh
    from torch_port_helpers import jax_state

    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    ref = JaxServingModel("vgan", 2, jax_config("tiny"), jax_state(case["groups"]),
                          max_batch=8, min_bucket=8, mesh=mesh, voxel_tp=True)
    return ref.reconstruct(case["ops"][0][1])


def _answers(runs, name):
    """The answers of the case's rank 0 (the first worker of its world)."""
    (answers,) = [res[name]["answers"] for res in runs["results"].values()
                  if "answers" in res.get(name, {})]
    return answers


def _close(got, want, output):
    assert got.shape == want.shape and got.dtype == want.dtype
    if output == "uint8":
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=TOL)


# ------------------------------------------------------------------ tests


def test_voxel_tp_matches_the_jax_mesh_server(runs):
    (status, got), = _answers(runs, "jax")
    assert status == "ok" and got.shape == (5, 16, 16, 3)
    np.testing.assert_allclose(got, runs["jax"], atol=TOL)
    assert runs["results"][0]["jax"]["buckets"] == [8]


@pytest.mark.parametrize("name", ["tp", "d4", "d2", "d2_image"])
def test_mesh_answers_the_single_process_server(runs, name):
    """The same requests and seed give the single-process server's images:
    plain and sampled ``reconstruct``, ``generate``, and the reloads."""
    case = runs["cases"][name]
    got = [a for op, a in zip(case["ops"], _answers(runs, name))
           if op[0] != "reload_unread"]
    want = runs["single"][name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0], (g, w)
        if g[0] == "error":
            assert g[1:] == w[1:]
        elif isinstance(w[1], dict):
            assert g[1] == w[1]
        else:
            _close(g[1], w[1], case["output"])


def test_buckets_are_the_jax_servers():
    """Multiples of the data axis, the smallest ``min_bucket // data``
    floored at 1 (``fmri_tpu/eval/serve.py:157-160``)."""
    from fmri_tpu.eval.serve import batch_buckets as jax_buckets

    for data, max_batch, min_bucket in [(2, 8, 1), (4, 8, 1), (2, 64, 1), (4, 64, 8),
                                        (2, 8, 8), (8, 64, 3)]:
        mesh = Mesh(data, 1, rank=0, device=torch.device("cpu"), backend="gloo")
        model = eval_module("vgan", 3)[0](get_config("tiny").model)
        served = ServingModel(get_config("tiny"), model, max_batch=max_batch,
                              min_bucket=min_bucket, mesh=mesh, device="cpu")
        want = [b * data for b in jax_buckets(max_batch // data, max(1, min_bucket // data))]
        assert served.buckets == want and all(b % data == 0 for b in want)


def test_each_rank_holds_its_fc1_columns(runs):
    """fc1 is [hidden, voxels / 2] on every rank of model=2, and each holds
    its columns of the weights it last took (the accepted reload's)."""
    hidden, voxels = get_config("tiny").model.cog_hidden, get_config("tiny").model.num_voxels
    final = torch.load(runs["paths"]["other"], weights_only=True)
    for r in range(WORKERS):
        res = runs["results"][r]["tp"]
        assert res["shard"] == (hidden, voxels // 2)
        lo = (r % 2) * voxels // 2
        for k, v in res["state"].items():
            want = final[k][:, lo:lo + voxels // 2] if k == "encoder.fc1.0.weight" else final[k]
            assert torch.equal(v, want), (r, k)
    for r in range(WORKERS):  # data parallelism keeps the whole weight
        assert runs["results"][r]["d4"]["shard"] == (hidden, voxels)


def test_refused_reloads_leave_every_rank_as_it_was(runs):
    """A checkpoint of other keys is refused by every rank; one that a
    follower cannot read is refused by all, rank 0 naming the rank; the
    answers after them are the accepted reload's."""
    ops, answers = runs["cases"]["tp"]["ops"], _answers(runs, "tp")
    by_path = {op[1]: a for op, a in zip(ops, answers) if op[0].startswith("reload")}
    assert by_path[runs["paths"]["other"]] == ("ok", {"reloaded": runs["paths"]["other"],
                                                      "epoch": None})
    status, kind, msg = by_path[runs["paths"]["wrong"]]
    assert (status, kind) == ("error", "ValueError") and "other keys" in msg
    status, kind, msg = by_path[runs["paths"]["unread"]]
    assert (status, kind) == ("error", "ValueError") and "rank(s) [3]" in msg


def test_mesh_validation():
    """The JAX server's ValueErrors (``tests/test_serve.py::
    test_voxel_tp_validation``), raised before any collective."""
    cfg = get_config("tiny")
    cpu = torch.device("cpu")

    def build(stage, mesh, voxel_tp, max_batch=8):
        model = eval_module("vgan", stage)[0](cfg.model)
        return ServingModel(cfg, model, family="vgan", stage=stage, max_batch=max_batch,
                            mesh=mesh, voxel_tp=voxel_tp, device="cpu")

    with pytest.raises(ValueError, match="voxel_tp requires a mesh"):
        build(2, None, True)
    with pytest.raises(ValueError, match="voxel_tp serves cognitive"):
        build(1, Mesh(4, 2, rank=0, device=cpu, backend="gloo"), True)
    with pytest.raises(ValueError, match="num_voxels=.* not divisible by the model axis"):
        build(2, Mesh(1, 3, rank=0, device=cpu, backend="gloo"), True)
    with pytest.raises(ValueError, match="max_batch=6 not divisible by the mesh's data axis"):
        build(2, Mesh(4, 1, rank=0, device=cpu, backend="gloo"), False, max_batch=6)
    with pytest.raises(RuntimeError, match="ranks other than 0"):
        build(2, None, False).follow()


if __name__ == "__main__":
    worker(sys.argv[1:])
