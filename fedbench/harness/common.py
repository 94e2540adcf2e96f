"""What every traffic kind shares: a program run of S members and its
bookkeeping (`Run`), the configuration's leaf shapes from its model
family, and the reference's members of a dense population."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List

import numpy as np

from fedbench.harness import manifest
from fedbench.reference import clock, data
from fedbench.reference.rounds import Member


def pick(value, dataset: str):
    """A traffic parameter, given once or per dataset."""
    return value[dataset] if isinstance(value, dict) else value


def param_shapes(cfg: dict) -> dict:
    """{leaf: shape} of the configuration's model, as its family lays it
    out."""
    return manifest.family(cfg["family"]).param_shapes(cfg["model"])


@dataclass
class RefMember:
    """One member as the reference derives it: its plan, its run, and its
    Eq. 8 records over any number of rounds."""

    label: str
    b: int
    V: int
    member: Member
    records: Callable[[int], list]


class Run:
    """A program run of S members, each over `lanes` clients a round (the
    traffic's and configuration's numbers, not the program's): `advance`
    drives the window's call and keeps each member's records; a kind
    implements `_advance(rounds, eval_every) -> [new records of each
    member]` and `params(i)`."""

    def __init__(self, cfg: dict, traffic: dict, sims: list, lanes: int):
        self.cfg = cfg
        self.family = manifest.family(cfg["family"])
        self.compress = traffic["compress"]
        self.sims = sims
        self.lanes = lanes
        self.hist: List[list] = [[] for _ in sims]

    @property
    def n(self) -> int:
        return len(self.sims)

    def advance(self, rounds: int, eval_every: int) -> int:
        """One call of `rounds` rounds; returns its member-rounds."""
        for h, new in zip(self.hist, self._advance(rounds, eval_every)):
            h.extend(new)
        return self.n * rounds

    def plans(self):
        return [(s.fed.batch_size, s.fed.local_rounds) for s in self.sims]

    def work(self, rounds: int, eval_every: int):
        """(useful flops, their least seconds, quantized rows) of one call
        of `rounds` rounds with an eval every `eval_every` and at the
        call's end (every configuration evaluates: run.py holds the
        program's spec to it), the work as the model's family counts it."""
        rows = sum(-(-int(np.prod(s)) // 1024)
                   for s in self.family.param_shapes(
                       self.cfg["model"]).values())
        evals = -(-rounds // min(eval_every, rounds))
        ef, el = self.family.member_eval(self.cfg)
        flops = least = 0.0
        qrows = 0
        for b, V in self.plans():
            f, t = self.family.member_round(self.cfg, b, V, self.lanes)
            flops += f * rounds + ef * evals
            least += t * rounds + el * evals
            if self.compress:
                qrows += self.lanes * rows * rounds
        return flops, least, qrows

    def extras(self) -> dict:
        return {}


def dense_members(cfg: dict, seed: int, plans, compress: bool,
                  scenario: bool):
    """Reference members over the Dirichlet partition of M clients drawn at
    `seed`; `plans` [(label, b, V, run seed)]. Returns (members, (x, y))."""
    x, y = data.make_dataset(cfg["dataset"], cfg["n_train"], seed)
    shapes = param_shapes(cfg)
    M = cfg["fed"]["n_devices"]
    parts = data.partition_dirichlet(y, M, cfg["alpha"], seed)
    sizes = np.array([len(p) for p in parts], np.int64)
    out = []
    for label, b, V, s in plans:
        member = Member(b=b, V=V, seed=s, compress=compress,
                        client_rows=lambda m, parts=parts: parts[m],
                        sizes=sizes)
        out.append(RefMember(
            label, b, V, member,
            lambda n, b=b, V=V: clock.records(cfg, shapes, M, b, V,
                                              compress, n,
                                              scenario=scenario)))
    return out, (x, y)
