"""Deterministic fault injection for federated rounds.

Port of ``repro/fed/faults.py``.  Real cohorts straggle, drop out, and now
and then ship garbage; this module makes each of those a seeded,
config-driven, testable scenario:

  * ``FaultConfig`` / ``parse`` — the declarative fault model and its spec
    grammar (``"nan:0.1"``, ``"dropout:0.2,straggler:0.5"``, ...).
  * ``FaultModel.inject`` — applied to one round's stacked client deltas:
    result-loss dropout, stragglers missing the round deadline, and
    per-client corruption (nan / inf / norm blow-up / sign flip).
  * ``make_deadline_sampler`` — deadline-based cohort formation over any
    ``fed.server.make_sampler`` sampler.

Every draw comes from a fresh CPU ``torch.Generator`` seeded from (seed,
round) — and, for the arrival delays, the 0x57A6 salt — never from one
generator advanced across rounds.  So a round's faults are a pure
function of (seed, round): resume and replay plant the same ones, and
round r recomputes round r-1's stragglers.  A ``draws`` hook given to
``FaultModel`` replaces those draws (a parity test passes the reference's
``jax.random`` ones).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.utils.pytree import tree_map

#: Corruption modes: ``nan``/``inf`` poison every element of the client's
#: delta; ``scale`` multiplies it by ``corrupt_scale``; ``sign`` flips it
#: (finite and norm-preserving: it slips past both quarantine layers and
#: stresses the aggregator's own robustness).
CORRUPT_MODES = ("nan", "inf", "scale", "sign")

#: Score bonus that seats last round's late arrivals ahead of everyone else
#: in the deadline sampler (any value > the largest delay term).
_BUFFER_BONUS = 1e6

#: Salt of the arrival-delay stream, the reference's.
_DELAY_SALT = 0x57A6

#: Kinds of draw a ``FaultModel`` takes, each (n,) for one round: ``drop``,
#: ``corrupt`` and ``slow`` uniform [0, 1) variates (compared with the
#: probability), ``delay`` unit-mean exponentials.
DRAW_KINDS = ("drop", "corrupt", "slow", "delay")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Declarative fault model for one federated run.

    Probabilities are per (round, active client).  Delays and the deadline
    share one simulated time unit (a "round budget"): a client whose
    exponential delay exceeds ``deadline`` misses the round.
    """

    dropout: float = 0.0  # P(an active client's result is lost)
    straggler: float = 0.0  # P(a client is slow this round)
    straggler_delay_mean: float = 2.0  # mean exponential delay of a slow client
    deadline: float = 1.0  # arrival cutoff, same unit as the delays
    corrupt: float = 0.0  # P(an active client ships a corrupted delta)
    corrupt_mode: str = "nan"  # see CORRUPT_MODES
    corrupt_scale: float = 1e4  # blow-up factor for corrupt_mode="scale"
    seed: int = 0

    def __post_init__(self):
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(
                f"unknown corrupt_mode: {self.corrupt_mode!r} "
                f"(expected one of {CORRUPT_MODES})"
            )
        for name in ("dropout", "straggler", "corrupt"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} is not a probability")

    @property
    def active(self) -> bool:
        return self.dropout > 0 or self.straggler > 0 or self.corrupt > 0

    def replace(self, **kw) -> "FaultConfig":
        return dataclasses.replace(self, **kw)


def parse(spec: str, seed: int = 0) -> FaultConfig:
    """Parse a ``--faults`` spec into a ``FaultConfig``.

    Grammar: comma-separated ``name:value`` terms.  A corruption-mode name
    (``nan``/``inf``/``scale``/``sign``) sets both the corruption
    probability and the mode.  Other names map to config fields:
    ``dropout``, ``straggler``, ``delay`` (straggler_delay_mean),
    ``deadline``, ``corrupt_scale``, ``seed``.  Terms compose left to right.
    """
    kw: dict = {"seed": seed}
    for term in filter(None, (t.strip() for t in spec.split(","))):
        if ":" not in term:
            raise ValueError(
                f"bad --faults term {term!r}: expected name:value "
                f"(e.g. 'nan:0.1' or 'dropout:0.2')"
            )
        name, _, value = term.partition(":")
        name = name.strip()
        value = value.strip()
        if name in CORRUPT_MODES:
            kw["corrupt"] = float(value)
            kw["corrupt_mode"] = name
        elif name in ("dropout", "straggler", "corrupt", "deadline", "corrupt_scale"):
            kw[name] = float(value)
        elif name == "delay":
            kw["straggler_delay_mean"] = float(value)
        elif name == "seed":
            kw["seed"] = int(value)
        else:
            raise ValueError(
                f"unknown --faults term {name!r} (corruption modes "
                f"{CORRUPT_MODES} or dropout/straggler/delay/deadline/"
                "corrupt_scale/seed)"
            )
    return FaultConfig(**kw)


def _generator(*path: int) -> torch.Generator:
    seed = np.random.SeedSequence([int(p) for p in path]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(seed))


class FaultModel:
    """Seeded fault injector.

    ``draws(kind, round_idx, n) -> (n,) tensor`` (see ``DRAW_KINDS``)
    replaces the model's own draws; None draws from fresh CPU generators
    seeded from (seed, round, kind) and, for ``slow`` / ``delay``, (seed,
    0x57A6, round, kind).
    """

    def __init__(self, cfg: FaultConfig, draws: Optional[Callable] = None):
        self.cfg = cfg
        self._draws = draws or self._own_draws

    def _own_draws(self, kind: str, round_idx: int, n: int) -> torch.Tensor:
        k = DRAW_KINDS.index(kind)
        if kind in ("slow", "delay"):
            gen = _generator(self.cfg.seed, _DELAY_SALT, round_idx, k)
        else:
            gen = _generator(self.cfg.seed, round_idx, k)
        if kind == "delay":
            return torch.empty((n,), dtype=torch.float32).exponential_(1.0, generator=gen)
        return torch.rand((n,), generator=gen)

    def _draw(self, kind: str, round_idx: int, n: int) -> torch.Tensor:
        out = torch.as_tensor(np.array(self._draws(kind, int(round_idx), n)))
        if tuple(out.shape) != (n,):
            raise ValueError(f"{kind} draws of round {round_idx}: shape {tuple(out.shape)} != {(n,)}")
        return out.cpu()

    # -- simulated arrival process -----------------------------------------

    def delays(self, round_idx: int, n: int) -> torch.Tensor:
        """(n,) float32 CPU arrival delays for one round: 0 for fast clients,
        exponential(mean=straggler_delay_mean) for slow ones.  Pure in
        (seed, round, index), so any round's process can be recomputed."""
        slow = self._draw("slow", round_idx, n) < self.cfg.straggler
        delay = self._draw("delay", round_idx, n).to(torch.float32) * self.cfg.straggler_delay_mean
        return torch.where(slow, delay, torch.zeros_like(delay))

    # -- delta corruption --------------------------------------------------

    def _poison(self, x: torch.Tensor, corrupt: torch.Tensor) -> torch.Tensor:
        c = corrupt.reshape(corrupt.shape + (1,) * (x.ndim - 1))
        mode = self.cfg.corrupt_mode
        if mode == "nan":
            return torch.where(c, torch.full_like(x, float("nan")), x)
        if mode == "inf":
            return torch.where(c, torch.full_like(x, float("inf")), x)
        if mode == "scale":
            return torch.where(c, x * self.cfg.corrupt_scale, x)
        return torch.where(c, -x, x)  # "sign"

    def inject(self, round_idx: int, deltas, mask, *, stragglers: bool = True):
        """Apply one round's faults to the stacked client deltas.

        ``mask`` is the (cohort,) float32 validity mask (all-ones for full
        participation).  Returns ``(deltas', mask', fault_slots)`` on the
        mask's device, where ``fault_slots`` marks the corrupted clients
        (float32).  Dropout and straggler losses fold into the mask;
        ``stragglers=False`` skips the straggler term when deadline cohorts
        applied it upstream.  Never empties the cohort: if every slot would
        drop, the original mask is kept.
        """
        cfg = self.cfg
        dev = mask.device
        cohort = mask.shape[0]
        new_mask = mask
        zero = torch.zeros_like(mask)
        if cfg.dropout > 0:
            drop = (self._draw("drop", round_idx, cohort) < cfg.dropout).to(dev)
            new_mask = torch.where(drop, zero, new_mask)
        if cfg.straggler > 0 and stragglers:
            late = (self.delays(round_idx, cohort) > cfg.deadline).to(dev)
            new_mask = torch.where(late, zero, new_mask)
        new_mask = torch.where(torch.sum(new_mask) > 0, new_mask, mask)
        fault_slots = torch.zeros((cohort,), dtype=torch.float32, device=dev)
        if cfg.corrupt > 0:
            cor = (self._draw("corrupt", round_idx, cohort) < cfg.corrupt).to(dev)
            cor = cor & (new_mask > 0)
            fault_slots = cor.to(torch.float32)
            deltas = tree_map(lambda x: self._poison(x, cor), deltas)
        return deltas, new_mask, fault_slots


def top_k_stable(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties to the lower index (the order
    of ``jax.lax.top_k``): a stable descending sort."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def make_deadline_sampler(model: FaultModel, inner, n_clients: int, cohort_pad: int):
    """Deadline-based cohort formation over an over-sampling inner sampler.

    ``inner`` is a ``make_sampler`` sampler built with over-sampled slots
    (> ``cohort_pad``); each round it proposes candidates, ranked by
    simulated arrival: last round's late arrivals first (their buffered
    results are "already here" — the delay process is pure in (round,
    client), so "late in round r-1" is recomputed in round r), then the
    earliest arrivals.  The first ``cohort_pad`` seats form the cohort;
    seats whose client still misses this round's deadline are zeroed in
    ``slot_valid`` and get a priority seat next round.  Delays are indexed
    by client id over all ``n_clients``.  Returns ``(generator, round_idx)
    -> (cohort, slot_valid)``, CPU tensors.
    """

    def sample(gen, round_idx):
        round_idx = int(round_idx)
        cand, cand_valid = inner(gen, round_idx)
        d_now = model.delays(round_idx, n_clients)[cand]
        d_prev = model.delays(max(round_idx - 1, 0), n_clients)[cand]
        buffered = ((d_prev > model.cfg.deadline) & (round_idx > 0)).to(torch.float32)
        score = torch.where(cand_valid > 0, buffered * _BUFFER_BONUS - d_now,
                            torch.full_like(d_now, float("-inf")))
        seat = top_k_stable(score, cohort_pad)
        arrived = (d_now[seat] <= model.cfg.deadline).to(torch.float32)
        return cand[seat], cand_valid[seat] * arrived

    return sample
