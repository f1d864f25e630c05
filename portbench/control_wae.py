"""The readings that the WAE cells' limits are set from, in one process on
the card:

    python3 portbench/control_wae.py --workload <cell> --program-seeds 1,2,... \
        --control-seeds 7,8,9 [--faults float8,half_batch,one_tick,disc_lr] \
        [--leaf-seeds 3,4,...] [--seconds 1]

For each program seed, one run of the cell as ``run.py`` makes it (a short
window; its result line carries the compared numbers of a sound run). For
each control seed and each of ``--faults``, the same inputs with the
reference put in the program's place and compared with the float32
reference: ``float8``, computed one precision below the configuration's
(``reference.vaegan.control_precision``: bf16 operands -> float8 e4m3 with
a per-tensor scale); ``half_batch``, in float32 on the first half of each
step's rows; ``one_tick``, in float32 with the encoder's BatchNorm ticked
once a step where the thesis's two forwards tick it twice; ``disc_lr``, in
float32 with the latent D stepped at the full lr where the thesis takes half.
The numbers the comparison has to refuse. For each leaf seed, the readings
behind the leaves that the change is not compared on
(:func:`leaf_readings`). The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("float8", "half_batch", "one_tick", "disc_lr")
SHIFT = "encoder.l_mu.bias"  # a shift of mu common to every row


def _half(steps):
    """Each step's inputs cut to the first half of its rows."""
    return [{k: v[:len(v) // 2] for k, v in s.items()} for s in steps]


def control_numbers(config, traffic, seed: int, device, faults=("float8",)) -> dict:
    """``{fault: the compared numbers}`` of the reference computed as each
    of ``faults`` says in the program's place, for the inputs that ``seed``
    gives the cell."""
    from portbench import harness
    from portbench.reference import vaegan
    from portbench.reference import wae as ref

    kind = harness.traffic_kind(traffic["kind"])
    imgs, w0 = kind.inputs(config, seed, device)
    draws = kind.drawer(config, traffic, seed, device)
    checked = [draws() for _ in range(traffic["checked_steps"])]
    steps = kind.reference_steps(checked, imgs, seed, traffic["batch"], device)
    m, t = config["model"], config["train"]
    spe = config["train_images"] // traffic["batch"]
    exact_p = vaegan.Precision("float32")
    exact = ref.train_steps(w0, steps, m, t, exact_p, spe)
    runs = {"float8": lambda: ref.train_steps(w0, steps, m, t, vaegan.control_precision(m), spe),
            "half_batch": lambda: ref.train_steps(w0, _half(steps), m, t, exact_p, spe),
            "one_tick": lambda: ref.train_steps(w0, steps, m, t, exact_p, spe,
                                                fault="one_tick"),
            "disc_lr": lambda: ref.train_steps(w0, steps, m, t, exact_p, spe, fault="disc_lr")}
    return {f: kind.compare(runs[f](), exact) for f in faults}


def _norm(t) -> float:
    import torch

    return float(torch.linalg.vector_norm(t.double()))


def leaf_readings(config, traffic, seed: int, device) -> dict:
    """What the program's first gradient of ``SHIFT`` is made of, against
    the float32 reference's, for the inputs that ``seed`` gives the cell:
    the program's step-1 gradient of mu split into the reconstruction's
    rows ``r`` (the decoder's backward from the weights before the step)
    and the penalty's ``p`` (against the latent D after phase 1); the norms
    of sum r (what rounding leaves of terms that cancel in exact
    arithmetic), of sum |r| (the size of those terms) and of sum p; the
    program's whole gradient (Adam's first moment after one step, / (1 -
    b1)) and the reference's; the elements whose sign differs, of how
    many, and how many of them where |sum r| passes the reference's
    gradient. Also the reference's reconstruction part of every leaf's
    first gradient over the whole (``penalty_only``'s rule) and each
    leaf's change gap after the checked steps, the three worst."""
    import copy

    import torch

    from fmri_tpu_torch.device import deterministic_cudnn, resolve_device
    from fmri_tpu_torch.losses.gan_losses import wae_penalty_sum
    from portbench import harness
    from portbench.reference import vaegan
    from portbench.reference import wae as ref

    resolve_device(device)
    kind = harness.traffic_kind(traffic["kind"])
    m, t = config["model"], config["train"]
    b, b1 = traffic["batch"], t["adam_b1"]
    imgs, w0 = kind.inputs(config, seed, device)
    state, step, feed = kind.program(config, traffic, imgs, w0, seed, device)
    before = copy.deepcopy(state.nets).train()
    checked, prog = [], {}
    with deterministic_cudnn():
        for i in range(traffic["checked_steps"]):
            _, d, x = step()
            checked.append(d)
            if i == 0:
                enc = state.opt_state["encoder"].mu
                g_prog = enc[SHIFT[len("encoder."):]] / (1.0 - b1)
                mu = before.encoder(x)[0].detach().requires_grad_()
                x_rec = before.decoder(mu)
                r, = torch.autograd.grad(x_rec, mu, x_rec.detach() - x)
                mu_p = mu.detach().requires_grad_()
                p, = torch.autograd.grad(
                    wae_penalty_sum(state.nets.discriminator(mu_p), t["wae_lambda"]), mu_p)
        prog["change"] = kind.train_loop._readings_change(state, w0)
    feed.close()
    steps = kind.reference_steps(checked, imgs, seed, b, device)
    spe = config["train_images"] // b
    exact = ref.train_steps(w0, steps, m, t, vaegan.Precision("float32"), spe)
    one = ref.train_steps(w0, steps[:1], m, t, vaegan.Precision("float32"), spe)
    g_ref = one["moments"][SHIFT][0] / (1.0 - b1)
    left = r.sum(0)
    flips = torch.sign(g_prog) != torch.sign(g_ref)
    keep = [k for k, g in exact["grad1"].items()
            if g >= 1e-3 * harness._median(list(exact["grad1"].values()))]
    c_med = harness._median([exact["change"][k] for k in keep])
    gaps = {k: abs(prog["change"][k] - exact["change"][k]) / max(exact["change"][k], c_med)
            for k in keep}
    return {"seed": seed, "leaf": SHIFT, "elements": int(g_ref.numel()),
            "sum_r": _norm(left), "sum_abs_r": _norm(r.abs().sum(0)), "sum_p": _norm(p.sum(0)),
            "g_program": _norm(g_prog), "g_reference": _norm(g_ref),
            "g_program_minus_reference": _norm(g_prog - g_ref),
            "signs_differ": int(flips.sum()),
            "signs_differ_where_sum_r_passes": int((flips & (left.abs() > g_ref.abs())).sum()),
            "sum_r_passes": int((left.abs() > g_ref.abs()).sum()),
            "rec_share": {k: exact["grad1_rec"][k] / exact["grad1"][k]
                          for k in exact["grad1_rec"] if exact["grad1"][k] > 0},
            "penalty_only": kind.penalty_only(exact),
            "worst_change_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:3]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="float8")
    ap.add_argument("--leaf-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    faults = args.faults.split(",")
    if not set(faults) <= set(FAULTS):
        ap.error(f"--faults must name some of {FAULTS}")
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    cell, config, traffic = harness.load_cell(args.workload)
    device = torch.device("cuda")
    kind = harness.traffic_kind(traffic["kind"])
    print(f"card: {harness.card_line()}", flush=True)
    for s in filter(None, args.program_seeds.split(",")):
        print(f"program seed {s}", flush=True)
        kind.run(cell, config, traffic, seed=int(s), seconds=args.seconds, trace=False,
                 device=device)
    for s in filter(None, args.control_seeds.split(",")):
        for fault, numbers in control_numbers(config, traffic, int(s), device, faults).items():
            print("control " + json.dumps({"seed": int(s), "fault": fault,
                                           "numbers": numbers}), flush=True)
    for s in filter(None, args.leaf_seeds.split(",")):
        print("leaves " + json.dumps(leaf_readings(config, traffic, int(s), device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
