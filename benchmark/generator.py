"""The one generator of traffic: reads a mix, `traffic/<name>.json`, and
draws a cell's trapdoor, statements, requests and arrivals from the seed.

A mix's keys:
  loop        "closed": each client sends its next request when its last
              proof is back.  "open": requests arrive at their own times
              (exponential gaps at `rate_per_s`, from the seed), queue,
              and are served in order of arrival
  clients     closed: the clients, each with one request in flight.
              open: the workers that serve the queue
  rate_per_s  open only: the mean arrivals a second
  pool        statements drawn in set-up, whose witnesses are made there
              too; requests cycle over them.  0: every request carries a
              fresh statement and its witness is made inside the request
  warmup      requests run in set-up, one at a time, from a stream of
              their own

Every request gets a fresh blinding (r, s).  Each stream is seeded by
the seed and its own name, so the same seed gives the same trapdoor,
statements, blindings and arrivals in every run, whatever else a run
draws.
"""

from __future__ import annotations

import json
import os
import random
from typing import Iterator, NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
KEYS = {"loop", "clients", "pool", "warmup"}
OPEN_KEYS = KEYS | {"rate_per_s"}


class Request(NamedTuple):
    index: int
    statement_id: int
    statement: object
    blinding: tuple


def load(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        mix = json.load(f)
    loop = mix.get("loop")
    want = {"closed": KEYS, "open": OPEN_KEYS}.get(loop)
    if want is None or set(mix) != want:
        raise ValueError(f"traffic {name}: a closed loop has the keys "
                         f"{sorted(KEYS)}, an open one also rate_per_s; "
                         f"not {mix}")
    if not (isinstance(mix["clients"], int) and mix["clients"] >= 1
            and isinstance(mix["pool"], int) and mix["pool"] >= 0
            and isinstance(mix["warmup"], int) and mix["warmup"] >= 1):
        raise ValueError(f"traffic {name}: clients >= 1, pool >= 0 and "
                         f"warmup >= 1 are whole numbers; not {mix}")
    if loop == "open" and not mix["rate_per_s"] > 0:
        raise ValueError(f"traffic {name}: rate_per_s > 0; not {mix}")
    return mix


def stream(seed: int, name: str) -> random.Random:
    return random.Random(f"{seed}/{name}")


def trapdoor(seed: int, p: int) -> tuple:
    rng = stream(seed, "trapdoor")
    return tuple(rng.randrange(1, p) for _ in range(5))


def blinding(rng: random.Random, p: int) -> tuple:
    return (rng.randrange(1, p), rng.randrange(1, p))


def arrivals(seed: int, rate_per_s: float) -> Iterator[float]:
    """Arrival times in seconds from the window's start: a Poisson
    process at `rate_per_s`."""
    rng = stream(seed, "arrivals")
    t = 0.0
    while True:
        t += rng.expovariate(rate_per_s)
        yield t


class Traffic:
    """The statements of a pool and the request stream of a cell."""

    def __init__(self, mix: dict, statement, seed: int, p: int):
        """statement(rng): one statement drawn from rng."""
        self.mix, self.statement, self.seed, self.p = mix, statement, seed, p
        rng = stream(seed, "pool")
        self.pool = [statement(rng) for _ in range(mix["pool"])]

    def _requests(self, name: str) -> Iterator[Request]:
        blind = stream(self.seed, name + "/blinding")
        fresh = stream(self.seed, name + "/statements")
        i = 0
        while True:
            if self.pool:
                sid = i % len(self.pool)
                st = self.pool[sid]
            else:
                sid, st = i, self.statement(fresh)
            yield Request(i, sid, st, blinding(blind, self.p))
            i += 1

    def requests(self) -> Iterator[Request]:
        return self._requests("requests")

    def warmup(self) -> Iterator[Request]:
        return self._requests("warmup")

    def arrivals(self) -> Iterator[float]:
        return arrivals(self.seed, self.mix["rate_per_s"])
