"""Install-phase profile database (paper Step 1).

Entries: (engine, op, dtype_bytes, threads, pcie_active) -> list of
(dims, gflops, gbps) measurements. Lookup follows the paper exactly:

1. exact match on (op, dtype, threads, dims) -> use its FLOPS;
2. partial match (op, dtype, threads) -> nearest neighbour over log-dims,
   then roofline-classify the query kernel against that neighbour's
   achieved FLOPS / bandwidth;
3. no match (metadata ops) -> skipped (cost 0).

CPU entries are *measured* on this machine at install time; accelerator
("gpu" engine) entries are seeded from datasheet constants with a
shape-dependent efficiency curve — same schema, so measured TPU profiles
drop in without code changes (DESIGN.md §2).
"""
from __future__ import annotations

import json
import math
import os
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class Entry:
    dims: Tuple[int, ...]
    gflops: float      # achieved Gflop/s
    gbps: float        # achieved GB/s (memory-bound proxy)


class ProfileDB:
    def __init__(self):
        self.entries: Dict[tuple, List[Entry]] = defaultdict(list)
        self.meta: dict = {}
        # lookup results by query, dropped whenever an entry is added: the
        # planner asks the same few hundred queries hundreds of thousands
        # of times for an expert-granular graph
        self._found: dict = {}

    @staticmethod
    def key(engine: str, op: str, dtype_bytes: int, threads: int,
            pcie_active: bool = False) -> tuple:
        return (engine, op, dtype_bytes, threads, bool(pcie_active))

    def add(self, key: tuple, dims, gflops: float, gbps: float):
        self.entries[key].append(Entry(tuple(dims), gflops, gbps))
        self._found.clear()

    # ---------------------------------------------------------- lookup
    def lookup(self, engine, op, dtype_bytes, threads, dims,
               pcie_active=False) -> Optional[Tuple[Entry, str]]:
        """Returns (entry, match_kind) or None; match_kind in exact|partial."""
        query = (engine, op, dtype_bytes, threads, tuple(dims),
                 bool(pcie_active))
        if query not in self._found:
            self._found[query] = self._lookup(*query)
        return self._found[query]

    def _lookup(self, engine, op, dtype_bytes, threads, dims, pcie_active):
        k = self.key(engine, op, dtype_bytes, threads, pcie_active)
        cands = self.entries.get(k)
        if not cands:
            # relax threads to the nearest profiled count (paper profiles a
            # sweep; planner may ask for an in-between count)
            tcands = [kk for kk in self.entries
                      if kk[0] == engine and kk[1] == op and kk[2] == dtype_bytes
                      and kk[4] == bool(pcie_active)]
            if not tcands:
                return None
            kk = min(tcands, key=lambda x: abs(x[3] - threads))
            cands = self.entries[kk]
        dims = tuple(dims)
        for e in cands:
            if e.dims == dims:
                return e, "exact"
        # nearest neighbour in log-dim space over same-rank candidates
        ranked = [e for e in cands if len(e.dims) == len(dims)]
        if not ranked:
            ranked = cands

        def dist(e):
            n = min(len(e.dims), len(dims))
            return sum((math.log(max(e.dims[i], 1)) - math.log(max(dims[i], 1))) ** 2
                       for i in range(n))
        return min(ranked, key=dist), "partial"

    # ---------------------------------------------------------- routing
    # Per-model MoE routing statistics (DESIGN.md §9): for each layer, the
    # fraction of router assignments landing on each expert. Seeded at
    # install/first-serve time, refined online by the executor's EMA of
    # router selections, and read back by the planner to pick the hot set.
    # Schema inside ``meta`` (so it rides the existing JSON save/load):
    #   meta["routing"][model_name][str(layer)] = [freq_e for e in range(E)]
    def get_routing(self, model: str):
        """{layer: [freq per expert]} for ``model`` — empty when unseeded
        (callers default to uniform 1/E)."""
        stored = self.meta.get("routing", {}).get(model, {})
        return {int(layer): list(freqs) for layer, freqs in stored.items()}

    def set_routing(self, model: str, layer: int, freqs):
        self.meta.setdefault("routing", {}).setdefault(model, {})[
            str(layer)] = [float(f) for f in freqs]

    # ---------------------------------------------------------- io
    def save(self, path: str):
        blob = {
            "meta": self.meta,
            "entries": {
                "|".join(map(str, k)): [[list(e.dims), e.gflops, e.gbps]
                                        for e in v]
                for k, v in self.entries.items()
            },
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(blob, f)

    @classmethod
    def load(cls, path: str) -> "ProfileDB":
        with open(path) as f:
            blob = json.load(f)
        db = cls()
        db.meta = blob.get("meta", {})
        for kstr, rows in blob["entries"].items():
            parts = kstr.split("|")
            k = (parts[0], parts[1], int(parts[2]), int(parts[3]),
                 parts[4] == "True")
            for dims, gf, gb in rows:
                db.add(k, tuple(dims), gf, gb)
        return db

    def stats(self):
        return {"n_keys": len(self.entries),
                "n_entries": sum(len(v) for v in self.entries.values())}
