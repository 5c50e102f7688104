"""Query batches through ``Collection.query`` of an in-memory cosine
collection: the lock, the normalisation, the routing, the device top-k
and the ids, distances and metadata lists a caller gets back.

The collection holds a game's rows, ids and metadata (harness/traffic.py),
below the store's IVF threshold, so the exact device route serves every
query. The corpus goes to the device with the warm-up's first query. No
kernel of the program's library runs here, so none is built.

What is compared: a sample of the window's batches drawn from the seed,
and its last batch, against float64 scores of the harness's own rows.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from harness import compare, cost, reference, seeds, traffic
from harness.entries import Clock


class Entry:
    span = "query"

    def __init__(self, cfg: dict, t: dict, seed: int, device):
        from vit_research_tpu_torch.store.vector_store import Collection

        self.cfg, self.t, self.device = cfg, t, torch.device(device)
        clock = Clock()
        self.rows, self.ids, self.metas = traffic.game_rows(
            t, cfg["hidden_size"], seed, self.device)
        self.queries = traffic.query_batches(self.rows, t, seed, self.device)
        clock("rows")
        self.col = Collection("game", space="cosine", dim=cfg["hidden_size"],
                              device=self.device)
        self.col.upsert(self.ids, self.rows, self.metas)
        clock("upsert")
        for i in range(t["warmup_batches"]):
            self.col.query(self.queries[i % len(self.queries)],
                           n_results=t["k"])
        clock("warmup")
        self.setup_phases = clock.phases
        self.keep = set(seeds.rng(seed, "sample").choice(
            t["sample_within"], t["sample_batches"], replace=False).tolist())
        self.kept, self.last, self.calls = [], None, 0

    def call(self) -> tuple:
        """(queries asked, queries with fewer than k answers)."""
        b = self.calls % len(self.queries)
        ans = self.col.query(self.queries[b], n_results=self.t["k"])
        if self.calls in self.keep:
            self.kept.append((b, ans))
        self.last = (b, ans)
        self.calls += 1
        short = sum(len(ids) != self.t["k"] for ids in ans["ids"])
        return len(self.queries[b]), short

    def end_to_end(self, calls: list, start: float) -> dict:
        ms = [(c[1] - c[0]) * 1e3 for c in calls]
        return {"search_p95_ms": float(np.percentile(ms, 95))}

    def run_info(self, calls: list) -> dict:
        q, n, d = self.t["queries"], self.t["rows"], self.cfg["hidden_size"]
        return {"batches": len(calls),
                "query_flops": cost.query_flops(q, n, d),
                "query_bound_s": cost.query_bound_s(q, n, d,
                                                    self.cfg["dtype"]),
                "dtype": self.cfg["dtype"]}

    def release(self) -> None:
        self.col = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _batches(self) -> list:
        kept = list(self.kept)
        if self.last is not None and all(a is not self.last[1]
                                         for _, a in kept):
            kept.append(self.last)
        return [(self.queries[b], ans) for b, ans in kept]

    def checks(self) -> dict:
        scores = reference.CosineScores(self.rows, self.device)
        return compare.search_gaps(scores, self._batches(),
                                   {i: n for n, i in enumerate(self.ids)},
                                   self.metas, self.t["k"])

    def control(self) -> dict:
        """The query computed plainly in TF32 in the store's place, held
        to the same comparison."""
        k = self.t["k"]
        qs = [q for q, _ in self._batches()]
        dist_all, idx_all = reference.cosine_topk(
            self.rows, np.concatenate(qs), k, self.device, tf32=True,
            block=len(qs[0]))
        batches, at = [], 0
        for q in qs:
            dist, idx = dist_all[at:at + len(q)], idx_all[at:at + len(q)]
            at += len(q)
            batches.append((q, {
                "ids": [[self.ids[j] for j in row] for row in idx],
                "distances": dist.tolist(),
                "metadatas": [[self.metas[j] for j in row] for row in idx]}))
        scores = reference.CosineScores(self.rows, self.device)
        return compare.search_gaps(scores, batches,
                                   {i: n for n, i in enumerate(self.ids)},
                                   self.metas, k)
