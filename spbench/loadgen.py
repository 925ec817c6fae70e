"""The one general generator of traffic: reads a traffic mix's data file and
drives the program with it.

A mix is a JSON file under ``spbench/traffic/`` named after the mix:

    {"loop": "closed", "clients": 1, "warmup_steps": 2, "chunk": 32, "judged": 64}

* ``loop``: ``closed``, one client that waits for each answer before it
  sends the next request (a solver's caller); the only loop there is. A
  request is ``solve.solve_refined(A, b, fac=fac)`` with the program's
  defaults, on the factor made in set-up; its latency runs from the call to
  the answer.
* Every request has a right-hand side of its own, b = A x with x standard
  normal, drawn from the run's seed and the request's index: the window's
  requests in chunks of ``chunk``, each made on the device when the one
  before is used up (the first in set-up), so no two requests of a run, nor
  of two seeds, send the same b.
* ``warmup_steps``: requests made in set-up before the window, on right-hand
  sides of a stream of their own, so that every shape the window uses is warm.
* ``judged``: how many answers the reference judges after the window: a
  sample of the window's requests drawn from the run's seed (all of them
  where there are fewer).
"""
from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from . import standin
from .trace import span

__all__ = ["Step", "Mix"]

WINDOW, WARMUP, SAMPLE = 1, 2, 4          # streams of the run's seed


@dataclass
class Step:
    """One request of the window: its timing and what the program reported."""

    index: int
    latency_s: float
    iterations: int
    converged: bool


class Mix:
    """A traffic mix bound to one run: the program's solve module, the
    matrix as the program takes it, the factorization and the seed."""

    def __init__(self, spec: dict, solve_mod, m, a, seed: int, device="cpu"):
        if spec.get("loop", "closed") != "closed" or int(spec.get("clients", 1)) != 1:
            raise ValueError("only a closed loop with one client is generated")
        self.spec, self.S, self.a, self.seed = spec, solve_mod, a, seed
        self.fac = None  # the program's factorization, set once set-up has made it
        self.spans = None  # set to a trace.Spans while the window is traced
        self.n = a.shape[0]
        self.errors = 0
        self.chunk = int(spec.get("chunk", 32))
        self.images = standin.Images(m, device)
        self.bank = self.images.chunk(seed, WINDOW, 0, self.chunk)
        self.keep = int(spec.get("judged", 64))
        self.judged: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.pick = np.random.default_rng([standin.seed_words(seed), SAMPLE])

    def request(self, b: np.ndarray, index: int) -> Tuple[Step, np.ndarray]:
        """One request; one that raises is answered by NaN and counted as
        failed (its traceback goes to standard error), and the loop goes on."""
        t0 = time.perf_counter()
        try:
            with span("solve", self.spans):
                x, rep = self.S.solve_refined(self.a, b, fac=self.fac)
            iterations, converged = int(rep.iterations), bool(rep.converged)
        except Exception:
            self.errors += 1
            if self.errors <= 3:
                traceback.print_exc(file=sys.stderr)
            x, iterations, converged = np.full(self.n, np.nan), 0, False
        return Step(index, time.perf_counter() - t0, iterations, converged), x

    def rhs_of(self, i: int) -> np.ndarray:
        """Request i's right-hand side: row i % chunk of the window's chunk i // chunk."""
        if i and i % self.chunk == 0:
            self.bank = self.images.chunk(self.seed, WINDOW, i // self.chunk, self.chunk)
        return self.bank[i % self.chunk]

    def sample(self, i: int, x: np.ndarray, b: np.ndarray) -> None:
        """Keeps request i's answer if the seeded sample (a reservoir of
        ``judged``) takes it."""
        if i < self.keep:
            self.judged[i] = (x, b.copy())
            return
        j = int(self.pick.integers(0, i + 1))
        if j < self.keep:
            del self.judged[sorted(self.judged)[j]]
            self.judged[i] = (x, b.copy())

    def warm_up(self) -> None:
        warm = self.images.chunk(self.seed, WARMUP, 0, self.chunk)
        for k in range(int(self.spec.get("warmup_steps", 1))):
            self.request(warm[k % self.chunk], -1 - k)

    def window(self, seconds: float) -> tuple:
        """Requests until ``seconds`` have passed since the first; the
        request under way then completes. Returns (steps, seconds from the
        first request to the last answer)."""
        steps: List[Step] = []
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            b = self.rhs_of(i)
            step, x = self.request(b, i)
            steps.append(step)
            self.sample(i, x, b)
            i += 1
        return steps, time.perf_counter() - t0

    def answers(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The judged sample's ``(x, b)``, in request order."""
        return [self.judged[i] for i in sorted(self.judged)]
