"""The one traffic generator: reads a mix's parameters (``traffic/*.json``)
and yields batches of neutral predicate tuples (see
:mod:`h100_bench.reference.evaluate`), the same for the same seed.

Batch ``k`` is the same whatever came before it, and warm-up batches
draw from a stream of the seed that the window never uses.

A mix names its ``source`` (the public query set its clauses come from),
its ``entry`` (see :mod:`h100_bench.program`), its ``batch`` size and its
``templates``.  A mix may name another in ``like``: it then takes every
key of that mix that it does not set itself.  Each template is an AND of
clauses and appears ``count`` times a batch, in the listed order.  A
clause names a column of the configuration by its ``column`` name and an
``op``, and takes one of its options:

``range`` with ``choices``
    one of the listed ``[lo, hi]`` pairs (both ends included);
``in`` with ``distinct``
    one set of that many distinct values of the column's domain;
``in`` with ``keys_of``
    the keys of a dimension table of the configuration (its ``tables``)
    whose attributes named in ``where`` each equal one value of that
    attribute's domain: a join with a selective dimension pushed down as
    an IN-list of keys.

A template's parameters are one option of each clause.  A run deals all
of them in an order drawn from the seed, each once before any comes
again, so every seed asks the same set of predicates, in another order.
Warm-up batches draw theirs at random.

A dimension table has one row for each value of its key column, and each
attribute is drawn uniformly from its domain, from its own stream of the
seed.
"""

from __future__ import annotations

import itertools
import json
import math
from pathlib import Path

import numpy as np

STREAM_DATA, STREAM_BATCH, STREAM_WARMUP, STREAM_SAMPLE, STREAM_TABLES = (
    1, 2, 3, 4, 5)
MAX_OPTIONS = 1 << 20   # of one template


def rng_for(seed: int, stream: int, k: int = 0):
    """A generator for one stream of a seed (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream, k])


def load(root, name: str) -> dict:
    mix = json.loads((Path(root) / "traffic" / f"{name}.json").read_text())
    if "like" in mix:
        mix = {**load(root, mix["like"]), **mix}
        del mix["like"]
    return mix


def dimension_tables(config: dict, seed: int) -> dict:
    """{table: {attribute: values}}, one value a key of the table."""
    names = [c["name"] for c in config["columns"]]
    out = {}
    for t, (name, spec) in enumerate(sorted(config.get("tables", {})
                                            .items())):
        n = int(config["columns"][names.index(spec["key"])]["card"])
        rng = rng_for(seed, STREAM_TABLES, t)
        out[name] = {a: rng.integers(0, int(card), size=n)
                     for a, card in spec["attributes"].items()}
    return out


class Traffic:
    def __init__(self, mix: dict, config: dict, seed: int):
        if mix["kind"] != "templates":
            raise ValueError(f"unknown traffic kind {mix['kind']!r}")
        self.mix = mix
        self.config = config
        self.names = [c["name"] for c in config["columns"]]
        self.cards = [int(c["card"]) for c in config["columns"]]
        self.tables = dimension_tables(config, seed)
        self.seed = seed
        total = sum(t["count"] for t in mix["templates"])
        if total != mix["batch"]:
            raise ValueError(f"templates give {total} predicates a batch, "
                             f"not {mix['batch']}")
        self.options = [[self._options(t, c) for c in t["clauses"]]
                        for t in mix["templates"]]
        self.sizes = [math.prod(n for n, _ in opts) for opts in self.options]
        if max(self.sizes) > MAX_OPTIONS:
            raise ValueError(f"a template of {max(self.sizes)} parameter "
                             f"sets; at most {MAX_OPTIONS}")
        self.order = [rng_for(seed, STREAM_BATCH, t).permutation(n)
                      for t, n in enumerate(self.sizes)]

    def batch(self, k: int) -> list:
        out = []
        for t, tmpl in enumerate(self.mix["templates"]):
            n = tmpl["count"]
            out += [self._instance(t, self.order[t][(k * n + i)
                                                    % self.sizes[t]])
                    for i in range(n)]
        return out

    def warmup(self, k: int) -> list:
        rng = rng_for(self.seed, STREAM_WARMUP, k)
        return [self._instance(t, int(rng.integers(self.sizes[t])))
                for t, tmpl in enumerate(self.mix["templates"])
                for _ in range(tmpl["count"])]

    def _instance(self, t: int, j: int):
        parts = []
        for n, option in self.options[t]:
            j, i = divmod(int(j), n)
            parts.append(option(i))
        return parts[0] if len(parts) == 1 else ("and", parts)

    def _options(self, t: dict, c: dict):
        """(number of options, option i -> predicate tuple) of a clause."""
        if c["column"] not in self.names:
            raise ValueError(f"template {t['name']} names column "
                             f"{c['column']!r}, which "
                             f"{self.config['name']} lacks")
        col = self.names.index(c["column"])
        if c["op"] == "range":
            pairs = [(int(lo), int(hi)) for lo, hi in c["choices"]]
            return len(pairs), lambda i: ("range", col, *pairs[i])
        if c["op"] == "in" and "distinct" in c:
            n = math.comb(self.cards[col], int(c["distinct"]))
            if n > MAX_OPTIONS:
                raise ValueError(f"{n} sets of values for {c['column']}")
            sets = list(itertools.combinations(range(self.cards[col]),
                                               int(c["distinct"])))
            return n, lambda i: ("in", col, list(sets[i]))
        if c["op"] == "in" and "keys_of" in c:
            table = self.tables[c["keys_of"]]
            cards = [int(self.config["tables"][c["keys_of"]]["attributes"][a])
                     for a in c["where"]]

            def keys(i):
                keep = np.ones(self.cards[col], dtype=bool)
                for attr, card in zip(c["where"], cards):
                    i, v = divmod(i, card)
                    keep &= table[attr] == v
                return ("in", col, [int(v) for v in np.flatnonzero(keep)])
            return math.prod(cards), keys
        raise ValueError(f"unknown clause {c!r}")
