"""Fits the planted client deltas of an aggregation mix to deltas that the
program itself makes, on the card, in one process:

    python3 bench/fit_traffic.py --config stablelm-2-1.6b --source fedround \\
        --mix agg40 --rounds 6 --seed 2147483659

1. Real deltas: the federated round of the ``--source`` mix (its Markov
   clients, local Adam steps and batch) with the ``--mix``'s client count,
   the clients' local steps run in groups of the source mix's size, the
   deltas aggregated by the ``--mix``'s FedRPCA session and the update
   applied, for ``--rounds`` rounds from the seed's global adapter.
2. Their statistics, per module (one (vec, n_clients) matrix a layer,
   target and factor) and as the median over each factor's modules; the
   session's fallbacks a round.
3. The planted parameters fitted to the warm rounds (all but the first,
   whose A deltas are zero while B is), per factor, at the mix's rank of
   the common part: a first reading of each (``fit``), then
   ``REFINE_STEPS`` steps that match the planted rounds' statistics to the
   real ones (``refine``).
4. The same session over planted rounds with the fitted parameters and
   with the mix's own, and their statistics and fallbacks beside the real
   ones.

Writes ``chiprun_out/fit/<mix>.json``.  The benchmark's own runs never run
this; the fitted parameters go into the mix file by hand, with the record
in PERF.md.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

import torch  # noqa: E402

#: Residual entries past this many robust deviations of the bulk count as
#: the sparse part.
OUTLIER_SIGMAS = 4.0
#: Steps of ``refine`` after the first fit.
REFINE_STEPS = 5


def module_stats(m: torch.Tensor, k: int) -> dict:
    """Statistics of one module's (vec, n) client matrix, its rank-k part
    L and the rest R = M - L: the rms of L, the robust deviation of R's
    bulk (1.4826 MAD) and its share of outliers past ``OUTLIER_SIGMAS`` of
    it with their rms, the mean pairwise cosine of the clients' columns of
    M and of L, the share of energy in the top k singular values, the top
    eight singular values over the first (``sv_i``), and L's column
    space."""
    m = m.double()
    vec, n = m.shape
    evals, evecs = torch.linalg.eigh(m.T @ m)
    evals, evecs = evals.flip(0).clamp_min(0.0), evecs.flip(1)
    sv = evals.sqrt()
    vk = evecs[:, :k]
    low = m @ vk @ vk.T
    rest = m - low
    dev = 1.4826 * rest.abs().median()
    out = rest.abs() > OUTLIER_SIGMAS * dev
    rms_low = low.square().mean().sqrt()

    def cosine(x):
        x = x / torch.linalg.vector_norm(x, dim=0, keepdim=True).clamp_min(1e-300)
        sim = x.T @ x
        return float((sim.sum() - sim.diagonal().sum()) / (n * (n - 1)))

    u = (m @ vk) / sv[:k].clamp_min(1e-300)
    return {
        "rms_low": float(rms_low),
        "rms": float(m.square().mean().sqrt()),
        "dev": float(dev),
        "outliers": float(out.double().mean()),
        "outlier_rms": float(rest[out].square().mean().sqrt()) if bool(out.any()) else 0.0,
        "cos": cosine(m),
        "cos_low": cosine(low),
        "energy_k": float(evals[:k].sum() / evals.sum().clamp_min(1e-300)),
        **{f"sv_{i}": float(sv[i] / sv[0].clamp_min(1e-300)) for i in range(1, min(8, n))},
        "basis": u,
    }


def drift(u0: torch.Tensor, u1: torch.Tensor) -> float:
    """Mean principal angle (radians) between two column spaces."""
    c = torch.linalg.svdvals(u0.T @ u1).clamp(-1.0, 1.0)
    return float(torch.arccos(c).mean())


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else 0.5 * (xs[len(xs) // 2 - 1] + xs[len(xs) // 2])


def round_stats(mats: list, names: list, k_of: dict) -> dict:
    """{factor: [module stats]} of one round's matrices; ``names[i]`` is
    matrix i's (target, factor, layer)."""
    out = {}
    for m, (t, f, i) in zip(mats, names):
        out.setdefault(f, []).append(module_stats(m, k_of.get(f, 4)))
    return out


def summary(rounds: list) -> dict:
    """Per factor, the median over modules and rounds of each statistic,
    and the median angle between consecutive rounds' column spaces."""
    out = {}
    for f in rounds[0]:
        per = [s for r in rounds for s in r[f]]
        row = {key: median([s[key] for s in per]) for key in per[0] if key != "basis"}
        angles = [drift(a["basis"], b["basis"]) for r0, r1 in zip(rounds, rounds[1:])
                  for a, b in zip(r0[f], r1[f])]
        row["drift"] = median(angles) if angles else None
        out[f] = row
    return out


def fit(summ: dict, rank_of: dict) -> dict:
    """The planted parameters of each factor from its statistics at rank
    ``rank_of[factor]``: the common part's scale (rms of L) and client spread (a cosine c of
    the clients' common parts gives spread sqrt(1/c - 1), since their
    mixing is c0 + spread N(0, 1) with c0 ~ N(0, 1)); the noise as R's bulk
    deviation over L's rms; the sparse part as R's outliers (their share
    and rms over L's); the drift as the angle a round."""
    out = {}
    for f, s in summ.items():
        c = min(max(s["cos_low"], 1e-3), 0.999)
        out[f] = {"rank": rank_of[f], "scale": s["rms_low"],
                  "client_spread": math.sqrt(1.0 / c - 1.0),
                  "noise": s["dev"] / s["rms_low"],
                  "density": s["outliers"],
                  "sparse_scale": (s["outlier_rms"] / s["rms_low"]) if s["outliers"] else 0.0,
                  "drift": s["drift"] or 0.0}
    return out


#: (parameter, statistic, power): each parameter is matched to its
#: statistic, whose value grows as the parameter to about that power (the
#: dimensionless ones taken over the common part's rms; the spread's
#: statistic is 1/cos_low - 1, which goes as the spread squared; the
#: drift's angle rises slower than the drift from the floor that the noise
#: gives it).
PAIRS = (("scale", "rms_low", 1.0), ("client_spread", "spread2", 2.0),
         ("noise", "dev_rel", 1.0), ("density", "outliers", 1.0),
         ("sparse_scale", "outlier_rel", 1.0), ("drift", "drift", 0.5))


def matched(row: dict) -> dict:
    """The statistics that ``PAIRS`` matches, from a summary row."""
    rel = lambda x: x / row["rms_low"]
    c = min(max(row["cos_low"], 1e-3), 0.999)
    return {"rms_low": row["rms_low"], "spread2": 1.0 / c - 1.0, "dev_rel": rel(row["dev"]),
            "outliers": row["outliers"], "outlier_rel": rel(row["outlier_rms"]),
            "drift": row["drift"] or 0.0}


def refine(params: dict, target: dict, got: dict) -> dict:
    """One step towards the target statistics: each parameter times
    (target / got) ** (1 / power), per factor."""
    out = {}
    for f, p in params.items():
        t, g = matched(target[f]), matched(got[f])
        q = dict(p)
        for name, stat, power in PAIRS:
            if g[stat] > 0 and t[stat] > 0:
                q[name] = p[name] * (t[stat] / g[stat]) ** (1.0 / power)
            elif t[stat] == 0:
                q[name] = 0.0
        out[f] = q
    return out


def planted_rounds(blocks, n, p, seed, dev, rounds) -> list:
    """Planted rounds as (vec, n) matrices in ``weights.modules`` order."""
    from bench.drivers import agg as agg_drv
    from bench.gen import planted

    gen = planted.Planted(blocks, n, p, seed, dev)
    return [[x.clone() for x in agg_drv._modules(gen.round(r))] for r in range(rounds)]


def measure(spec: dict, src: dict, mix: dict, rounds: int, seed: int, dev) -> dict:
    """The record of steps 1-4 (see the module docstring)."""
    from bench.drivers import agg as agg_drv
    from bench.drivers import fedround as fed_drv
    from bench.gen import planted
    from bench.gen import weights as W
    from bench.harness import program
    from repro_torch.core import engine
    from repro_torch.launch import steps
    from repro_torch.models.model import DecoderLM
    from repro_torch.utils.pytree import tree_map

    t_start = time.perf_counter()
    n, group = mix["clients"], src["clients"]
    acfg = program.agg_config(mix)

    pcfg = program.port_config(spec)
    model = DecoderLM(pcfg, None, device=dev)
    W.load_into(model, spec, W.base_weights(spec, seed, dev))
    lora = W.program_lora(W.lora_init(spec, seed, dev))
    batch_of = fed_drv.client_batches(dict(src, clients=n), spec, seed, dev)
    local_step = steps.make_local_step(pcfg, local_lr=src["local_lr"],
                                       local_steps=src["local_steps"], local_optimizer="adam",
                                       remat=src["remat"])

    def session():
        example = tree_map(lambda x: torch.zeros((n, *x.shape), dtype=x.dtype, device=dev),
                           lora)
        return (steps.make_agg_step(acfg, engine="packed"),
                engine.init_agg_carry(engine.plan_aggregation(example, acfg)))

    names = [(t, f, i) for t in sorted(W.lora_dims(spec)) for f in ("A", "B")
             for i in range(spec["n_layers"])]
    record = {"seed": seed, "clients": n, "rounds": rounds,
              "real": {"fallbacks": [], "metrics": []}}
    agg_step, carry = session()
    real = []
    for r in range(rounds):
        b = batch_of(r)
        parts = [local_step(model, lora, {"tokens": b[i:i + group, :, :-1],
                                          "labels": b[i:i + group, :, 1:]}, (seed, 1000 + r))[0]
                 for i in range(0, n, group)]
        deltas = tree_map(lambda *xs: torch.cat(xs), *parts)
        del parts
        upd, metrics, carry = agg_step(deltas, None, (seed, 1000 + r), carry)
        lora = steps.apply_update(lora, upd)
        real.append([m.clone() for m in W.modules(W.from_program_lora(deltas), stacked=True)])
        record["real"]["fallbacks"].append(float(metrics["fallback_count"]))
        record["real"]["metrics"].append({k: float(v) for k, v in metrics.items()
                                          if torch.is_tensor(v) and v.numel() == 1
                                          or isinstance(v, (int, float))})
        print(f"real round {r}: fallbacks {record['real']['fallbacks'][-1]}", flush=True)
    del model, agg_step, carry, deltas, upd
    torch.cuda.empty_cache() if torch.device(dev).type == "cuda" else None

    # The common part keeps the mix's rank; its spectrum is recorded beside.
    rank_of = {f: planted.params_for(mix["planted"], ("", f))["rank"] for f in ("A", "B")}
    warm = summary([round_stats(m, names, rank_of) for m in real[1:]])
    record["real"]["summary"] = warm
    fitted = fit(warm, rank_of)
    record["fit_steps"] = [fitted]
    blocks = agg_drv._blocks(spec)
    for _ in range(REFINE_STEPS):
        got = summary([round_stats(m, names, rank_of) for m in
                       planted_rounds(blocks, n, {"by_factor": fitted}, seed, dev, rounds)[1:]])
        fitted = refine(fitted, warm, got)
        record["fit_steps"].append(fitted)
    record["fitted"] = fitted
    print("real:", json.dumps(warm), "\nfitted:", json.dumps(fitted), flush=True)

    candidates = {"fitted": {**mix["planted"], "by_factor": fitted},
                  "mix": mix["planted"]}
    record["planted"] = {}
    for label, p in candidates.items():
        gen = planted.Planted(blocks, n, p, seed, dev)
        agg_step, carry = session()
        falls = []
        for r in range(rounds):
            _, metrics, carry = agg_step(agg_drv._tree(spec, gen.round(r), n), None, (seed, r),
                                         carry)
            falls.append(float(metrics["fallback_count"]))
        mats = planted_rounds(blocks, n, p, seed, dev, rounds)
        record["planted"][label] = {
            "params": p, "fallbacks": falls,
            "summary": summary([round_stats(m, names, rank_of) for m in mats[1:]]),
            "cosine_round0": planted.mean_pairwise_cosine(gen.round(0))}
        print(f"planted {label}: fallbacks {falls}", flush=True)
        del agg_step, carry, mats
    record["real"]["cosine_round1"] = planted.mean_pairwise_cosine(dict(enumerate(real[1])))
    record["seconds"] = time.perf_counter() - t_start
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--source", required=True, help="the mix whose round makes the deltas")
    ap.add_argument("--mix", required=True, help="the aggregation mix to fit")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=2147483659)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from bench.harness import manifest

    read = lambda sub, name: json.loads((manifest.BENCH / sub / f"{name}.json").read_text())
    record = measure(read("configs", args.config), read("mixes", args.source),
                     read("mixes", args.mix), args.rounds, args.seed, args.device)
    record.update(config=args.config, source=args.source, mix=args.mix)
    out_dir = ROOT / "chiprun_out" / "fit"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{args.mix}.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({k: v for k, v in record.items() if k != "planted"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    sys.exit(main())
