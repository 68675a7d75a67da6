"""Text search against an image index: one client in a closed loop.

Set-up makes the configuration's weights, an index of ``index`` unit f32
image embeddings (as ``cli/encode_cli.py`` writes them) and a pool of
captions from ``pool_records`` records, all from the seed. Request q sends
``sizes[q]`` captions through ``retrieval/search.py:search_texts`` with
``k``; the client sends the next as soon as the top-k ids are on the host.
Request sizes come in blocks, each a permutation (drawn from the seed) of
every size from ``min_queries`` to ``max_queries``, so every seed sends the
same sizes in another order. Warm-up sends one request of each size.

The check draws ``check.requests`` completed requests from the seed, the
largest sent among them, keeping only their answers through the window
(``harness.Reservoir``); the reference embeds their captions, scores them
against the index and ranks the index.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from multimodal_embedding_tpu_torch.retrieval.search import Index, search_texts
from perfbench import generator, yardstick
from perfbench.harness import Reservoir, sub_seed
from perfbench.port import load
from perfbench.reference import retrieval, towers


CONTROL = "fp8"  # the precision below the bfloat16 text tower


class Session:
    def __init__(self, cell):
        self.cell = cell
        cfg, tr, dev = cell.config, cell.traffic, cell.device
        self.cfg, self.k = cfg, tr["k"]
        self.sd, self.model, self.engine = load(cell)
        gen = torch.Generator(device=dev).manual_seed(sub_seed(cell.seed, 6))
        emb = torch.randn(tr["index"], yardstick.embed_dim(cfg), generator=gen, device=dev)
        self.index = Index(embeddings=emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True),
                           ids=np.arange(tr["index"]))
        rng = np.random.default_rng([cell.seed, 7])
        self.pool = [c for r in generator.records(tr["pool_records"], rng) for c in r["captions"]]
        sizes = np.arange(tr["min_queries"], tr["max_queries"] + 1)
        blocks = -(-tr["max_requests"] // len(sizes))
        self.sizes = np.concatenate([rng.permutation(sizes) for _ in range(blocks)])
        self.starts = np.concatenate([[0], np.cumsum(self.sizes)])
        self.picks = rng.integers(len(self.pool), size=int(self.starts[-1]))
        self.kept: Reservoir | None = None
        self.largest: tuple[int, dict] | None = None  # the first request of the largest size sent

    def texts(self, q: int) -> list[str]:
        """Request q's captions (the sequence repeats after ``max_requests``)."""
        q %= len(self.sizes)
        return [self.pool[j] for j in self.picks[self.starts[q] : self.starts[q + 1]]]

    def warmup(self):
        for size in range(self.cell.traffic["min_queries"], self.cell.traffic["max_queries"] + 1):
            search_texts(self.model, self.engine, self.index, self.pool[size : 2 * size], k=self.k)
        self.engine.outputs = []
        if self.cell.spans is not None:
            self.cell.spans.clear()
        self.kept = Reservoir(self.cell.traffic["check"]["requests"], np.random.default_rng([self.cell.seed, 98]))

    def step(self, i: int) -> dict:
        texts = self.texts(i)
        traced = self.cell.spans is not None
        with torch.profiler.record_function("perfbench.request") if traced else contextlib.nullcontext():
            t0 = time.perf_counter()
            res = search_texts(self.model, self.engine, self.index, texts, k=self.k)
            latency = time.perf_counter() - t0
        answer = {"emb": self.engine.outputs.pop(), "ids": np.array([[d for d, _ in row] for row in res]),
                  "scores": np.array([[s for _, s in row] for row in res])}
        if self.kept is not None:
            self.kept.offer(i, answer)
            if self.largest is None or len(texts) > len(self.largest[1]["ids"]):
                self.largest = (i, answer)
        rec = {"q": i, "latency_s": latency, "queries": len(texts)}
        if traced:
            rec["spans"] = {"text_encode": sum(self.cell.spans.pop("text_sweep", []))}
        return rec

    def required(self, records: list[dict]) -> dict:
        t, n_index = yardstick.text_len(self.cfg), self.index.embeddings.shape[0]
        e = yardstick.embed_dim(self.cfg)
        flops = 0.0
        for r in records:
            for c in self.texts(r["q"]):
                flops += yardstick.caption_flops(self.cfg, yardstick.caption_tokens(c, t))
            flops += yardstick.dense_score_flops(r["queries"], n_index, e)
        return {"flops": flops}

    def free(self):
        del self.model, self.engine
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check -----------------------------------------------------------

    def answers(self) -> dict[int, dict]:
        return {**self.kept.kept(), self.largest[0]: self.largest[1]}

    def sample(self, records: list[dict], rng) -> list[int]:
        pick = sorted(self.kept.kept())
        if self.largest[0] not in pick:
            if len(pick) == self.kept.size:
                pick.pop(int(rng.integers(len(pick))))
            pick.append(self.largest[0])
        return sorted(pick)

    def outputs(self, records: list[dict], sample: list[int]) -> list[dict]:
        answers = self.answers()
        return [{"emb": answers[q]["emb"].float(), "ids": answers[q]["ids"], "scores": answers[q]["scores"]}
                for q in sample]

    def reference(self, sample: list[int], prec: str) -> list[dict]:
        out = []
        for q in sample:
            emb = retrieval.l2_normalize(towers.text_embeddings(self.texts(q), self.sd, self.cfg, prec,
                                                                self.cell.device))
            scores = retrieval.dense_scores(emb, self.index.embeddings, prec)
            ids, top = retrieval.top_k(scores, self.k)
            out.append({"emb": emb, "ids": self.index.ids[ids.cpu().numpy()], "scores": top.cpu().numpy(),
                        "all_scores": scores})
        return out

    def compare(self, got: list[dict], want: list[dict]) -> dict[str, float]:
        """Worst 1 - cosine of a query embedding; worst gap between a
        returned score and the reference's score of the same id; worst
        amount by which a returned id's reference score lies below the
        reference's k-th best."""
        cos, score, rank = 0.0, 0.0, 0.0
        for g, w in zip(got, want):
            cos = max(cos, float((1.0 - torch.nn.functional.cosine_similarity(g["emb"], w["emb"], dim=-1)).max()))
            rows = np.arange(len(g["ids"]))[:, None]
            ref_of_ids = w["all_scores"].cpu().numpy()[rows, g["ids"]]
            score = max(score, float(np.abs(g["scores"] - ref_of_ids).max()))
            rank = max(rank, float((w["scores"][:, -1:] - ref_of_ids).clip(min=0.0).max()))
        return {"text_cos_gap": cos, "score_gap": score, "topk_gap": rank}

