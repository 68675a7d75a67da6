"""The statistics phase of a COCO-5k evaluation, the encoder bypassed.

Set-up makes ``images`` unit image embeddings and ``captions_per_image``
captions each, every caption its image's embedding plus Gaussian noise of
``noise`` a dimension, renormalized, on the device from the seed (so recall
lies strictly between 0 and 100), and the records' first captions for the
failure analysis. Each round runs what ``cli/main.py:run_bootstrap_benchmark``
runs after the encode: both dense score matrices
(``retrieval/scoring.py:dense_scores``), ``iterations`` bootstrap iterations
(``stats/bootstrap.py:bootstrap_benchmark``) with a seed of its own, the
confidence interval and standard deviation of each metric, and the failure
analysis.

The check draws ``check.rounds`` completed rounds from the seed and
compares all of each: every iteration's recall, every metric's interval and
standard deviation, and the failure analysis. The reference scores the
embeddings itself, draws the round's bootstrap samples as the port documents
them (a ``torch.Generator`` on the device seeded with the round's seed,
``torch.randint``), ranks every sampled query of every iteration, and works
out the intervals and the failure analysis from its own recalls
(``reference/statistics.py``).
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from multimodal_embedding_tpu_torch.analysis.failure import aggregate_failure_analysis
from multimodal_embedding_tpu_torch.retrieval.scoring import dense_scores
from multimodal_embedding_tpu_torch.stats.bootstrap import bootstrap_benchmark
from multimodal_embedding_tpu_torch.stats.ci import bootstrap_confidence_interval
from perfbench import generator, yardstick
from perfbench.harness import sub_seed
from perfbench.reference import retrieval, statistics


CONTROL = "tf32"  # the precision below the float32 scores


class Session:
    def __init__(self, cell):
        self.cell = cell
        tr, dev = cell.traffic, cell.device
        n, self.k, e = tr["images"], tr["captions_per_image"], yardstick.embed_dim(cell.config)
        gen = torch.Generator(device=dev).manual_seed(sub_seed(cell.seed, 4))
        img = torch.randn(n, e, generator=gen, device=dev)
        self.img = img / torch.linalg.vector_norm(img, dim=1, keepdim=True)
        caps = self.img.repeat_interleave(self.k, dim=0)
        caps += tr["noise"] * torch.randn(caps.shape, generator=gen, device=dev)
        self.caps = caps / torch.linalg.vector_norm(caps, dim=1, keepdim=True)
        recs = generator.records(n, np.random.default_rng([cell.seed, 5]))
        self.first_captions = [r["captions"][0] for r in recs]
        self.iterations = tr["iterations"]

    def round_seed(self, i: int) -> int:
        return sub_seed(self.cell.seed, 100 + i)

    def warmup(self):
        """One round with a seed that no round of the window takes."""
        self.step(-1)

    def step(self, i: int) -> dict:
        s_t2i = dense_scores(self.caps[:: self.k], self.img)
        s_i2t = dense_scores(self.img, self.caps)
        out = bootstrap_benchmark(s_t2i, s_i2t, self.iterations, seed=self.round_seed(i), caps_per_image=self.k)
        summary = {}
        for key, values in out.metrics.items():
            summary[key] = (*bootstrap_confidence_interval(values), float(np.std(values)))
        failure = json.dumps(aggregate_failure_analysis(out.correct_r1, out.sample_idx, self.first_captions))
        return {"iterations": self.iterations, "seed": self.round_seed(i), "metrics": out.metrics,
                "summary": summary, "failure": failure}

    def required(self, records: list[dict]) -> dict:
        n, e = self.img.shape
        per_round = (self.iterations * yardstick.bootstrap_iteration_flops(n, self.k)
                     + yardstick.dense_score_flops(n, n, e) + yardstick.dense_score_flops(n, n * self.k, e))
        return {"flops": per_round * len(records)}

    def free(self):
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check -----------------------------------------------------------

    def sample(self, records: list[dict], rng) -> list[dict]:
        n = min(self.cell.traffic["check"]["rounds"], len(records))
        return [{"round": int(r), "seed": records[r]["seed"], "iterations": records[r]["iterations"]}
                for r in sorted(rng.choice(len(records), size=n, replace=False))]

    def outputs(self, records: list[dict], sample: list[dict]) -> list[dict]:
        out = []
        for s in sample:
            rec = records[s["round"]]
            failure = json.loads(rec["failure"])
            flat = {k: v for k, v in failure.items() if k != "accuracy_by_category"}
            flat.update({f"accuracy_by_category.{c}": v for c, v in failure.get("accuracy_by_category", {}).items()})
            out.append({"metrics": rec["metrics"], "summary": rec["summary"], "failure": flat})
        return out

    def reference(self, sample: list[dict], prec: str) -> list[dict]:
        dev, n = self.cell.device, self.img.shape[0]
        s_t2i = retrieval.dense_scores(self.caps[:: self.k], self.img, prec)
        s_i2t = retrieval.dense_scores(self.img, self.caps, prec)
        out = []
        for s in sample:
            gen = torch.Generator(device=dev).manual_seed(s["seed"])
            idx = torch.randint(0, n, (s["iterations"], n), generator=gen, device=dev)
            metrics, hits = retrieval.bootstrap_round(s_t2i, s_i2t, idx, self.k)
            out.append({"metrics": metrics, "summary": statistics.summary(metrics),
                        "failure": statistics.failure_analysis(hits, idx.cpu().numpy(), self.first_captions)})
        return out

    @staticmethod
    def compare(got: list[dict], want: list[dict]) -> dict[str, float]:
        """Worst gaps, in percentage points, over the drawn rounds: of an
        iteration's recall; of a metric's mean, lower or upper bound or
        standard deviation; of a share of the failure analysis (infinite
        where the two name different breakdowns)."""
        recall = summary = failure = 0.0
        for g, w in zip(got, want):
            for k, v in w["metrics"].items():
                mine = np.asarray(g["metrics"].get(k, []), dtype=np.float64)
                if mine.shape != v.shape or k not in g["summary"]:
                    recall = summary = math.inf
                    continue
                recall = max(recall, float(np.abs(mine - v).max()))
                summary = max(summary, max(abs(a - b) for a, b in zip(g["summary"][k], w["summary"][k])))
            if set(g["failure"]) != set(w["failure"]):
                failure = math.inf
            else:
                failure = max(failure, max(abs(g["failure"][k] - v) for k, v in w["failure"].items()))
        return {"recall_gap_pp": recall, "summary_gap_pp": summary, "failure_gap_pp": failure}
