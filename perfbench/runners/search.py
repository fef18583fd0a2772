"""The ``search`` runner: one caller in a closed loop over ``RetrievalIndex.search``.

Set-up draws a corpus of unit rows around seeded centroids on the card,
a (manual, page) key for every row, and ``query_batches`` batches of
queries around the same centroids, then builds the program's index with
``build_index`` from host arrays, as the program takes them. The window
sends the batches in turn, the next when the last answer is back on the
host. A seeded sample of the calls is checked against the exact float64
reference once the window has closed.
"""

from __future__ import annotations

import contextlib
import time
from typing import List

import numpy as np
import torch

from perfbench.runners.common import Reservoir, free_cuda
from perfbench.e2e import Call
from perfbench.reference import search as ref_search
from perfbench.weights import generator

__all__ = ["Runner"]


class Runner:
    """``control=True`` puts a TF32 product and ``topk`` over the same
    corpus on the card, the precision below the configuration's float32,
    in the index's place."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: torch.device,
                 control: bool = False):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.control = control

    def corpus(self) -> torch.Tensor:
        """The (rows, dim) float32 unit rows, made on the card."""
        mix, dev = self.mix, self.device
        g = generator(self.seed, "corpus", dev)
        centroids = self.centroids()
        assign = torch.randint(0, mix["centroids"], (mix["rows"],), generator=g, device=dev)
        rows = torch.randn(mix["rows"], mix["dim"], generator=g, device=dev)
        rows.mul_(mix["noise_per_dim"]).add_(centroids[assign])
        return rows.div_(rows.norm(dim=1, keepdim=True))

    def centroids(self) -> torch.Tensor:
        g = generator(self.seed, "centroids", self.device)
        c = torch.randn(self.mix["centroids"], self.mix["dim"], generator=g, device=self.device)
        return c / c.norm(dim=1, keepdim=True)

    # -- set-up ----------------------------------------------------------------

    def build(self) -> None:
        mix, dev = self.mix, self.device
        g = generator(self.seed, "keys", dev)
        n = mix["rows"]
        manuals = torch.randint(0, mix["manuals"], (n,), generator=g, device=dev).cpu().numpy()
        pages = torch.randint(0, mix["pages_per_manual"], (n,), generator=g,
                              device=dev).cpu().numpy()
        gq = generator(self.seed, "queries", dev)
        nq = mix["query_batches"] * mix["queries_per_call"]
        pick = torch.randint(0, mix["centroids"], (nq,), generator=gq, device=dev)
        q = torch.randn(nq, mix["dim"], generator=gq, device=dev)
        q.mul_(mix["noise_per_dim"]).add_(self.centroids()[pick])
        q.div_(q.norm(dim=1, keepdim=True))
        self.queries = q.cpu().numpy().reshape(mix["query_batches"], mix["queries_per_call"],
                                               mix["dim"])
        corpus = self.corpus()
        if self.control:
            self.rows = corpus
            self.search = self._control_search
        else:
            from tpualign_torch.parallel.retrieval import build_index

            host = corpus.cpu().numpy()
            del corpus
            names = np.char.add("manual-", manuals.astype(str)).tolist()
            self.index = build_index(host, names, pages.tolist(), device=dev, **mix["index"])
            del host, names
            self.search = self._program_search
        free_cuda(dev)

    def _program_search(self, q: np.ndarray):
        return self.index.search(q, k=self.mix["k"], global_search=self.mix["global_search"])

    def _control_search(self, q: np.ndarray):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            s = torch.from_numpy(q).to(self.device) @ self.rows.t()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        vals, idx = torch.topk(s, self.mix["k"], dim=1)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def warmup(self) -> None:
        for i in range(self.mix["warmup_calls"]):
            self.search(self.queries[i % len(self.queries)])

    # -- the window ------------------------------------------------------------

    def window(self, seconds: float, span=None) -> List[Call]:
        mix = self.mix
        span = span or (lambda name: contextlib.nullcontext())
        self.sample = Reservoir(lambda stratum: mix["check_calls"], self.seed, "sample")
        pass_ = ("k2", mix["queries_per_call"], mix["rows"], mix["dim"], mix["k"])
        calls: List[Call] = []
        start, i = time.perf_counter(), mix["warmup_calls"]
        while True:
            b = i % len(self.queries)
            t0 = time.perf_counter()
            with span("search_call"):
                vals, idx = self.search(self.queries[b])
            t1 = time.perf_counter()
            calls.append(Call("search_call", t0, t1, len(self.queries[b]), [pass_]))
            self.sample.offer("search", (b, vals, idx))
            i += 1
            if t1 - start >= seconds:
                break
        return calls

    def release(self) -> None:
        self.__dict__.pop("index", None)
        self.__dict__.pop("rows", None)
        self.search = None
        free_cuda(self.device)

    # -- the check -------------------------------------------------------------

    def check(self) -> dict:
        """Each kept call's answers against the exact float64 top-k: the
        largest gap between a returned value and the exact score of the
        row it names, and the largest amount by which the exact score of
        the row returned at a rank lies below the exact score due there
        (a wrong, missing or repeated row reads as its full deficit)."""
        dev, k = self.device, self.mix["k"]
        corpus64 = self.corpus().to(torch.float64)
        value_gap = rank_gap = 0.0
        for b, vals, idx in self.sample.kept["search"]:
            q = torch.from_numpy(self.queries[b]).to(dev)
            s = ref_search.scores(q, corpus64)
            want, _ = ref_search.exact_topk(s, k)
            got_idx = torch.from_numpy(np.asarray(idx, np.int64)).to(dev)
            valid = (got_idx >= 0) & (got_idx < s.shape[1])
            exact = s.gather(1, got_idx.clamp(0, s.shape[1] - 1))
            exact = torch.where(valid, exact, torch.full_like(exact, -2.0))
            # a row named twice counts once: its second slot reads as empty
            dup = torch.zeros_like(valid)
            for r in range(1, k):
                dup[:, r] = (got_idx[:, r:r + 1] == got_idx[:, :r]).any(dim=1)
            exact = torch.where(dup, torch.full_like(exact, -2.0), exact)
            got_vals = torch.from_numpy(np.asarray(vals, np.float64)).to(dev)
            value_gap = max(value_gap, float((got_vals - exact).abs().max()))
            rank_gap = max(rank_gap, float((want - exact).max()))
        return {"value_gap": value_gap, "rank_gap": rank_gap,
                "queries_checked": len(self.sample.kept["search"]) * self.queries.shape[1]}
