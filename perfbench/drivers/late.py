"""Late interaction over page images: a multi-vector retriever (ColPali's
path) encodes a set of pages and caption queries and scores them by MaxSim,
one set a round.

Set-up draws the configuration's HF-layout weights part by part on the
device from the seed (``weights_moe.py``) and loads them through the port's
converter (``models/colpali.py:colpali_deepseek_from_hf``), which holds the
only copy; the images are drawn as the ``encode`` driver draws them
(``images`` records in ``caches`` sets, each staged as the CLI's device
cache at the configuration's batch). Round r runs the CLI's
``compute_score_matrices`` on set r mod ``caches``: the page sweep (each
page its image tokens and the prompt suffix through the whole model), the
T2I sweep of the first captions and the I2T sweep of every caption (in
ColPali's query prompt, padded to the sweep's longest), then MaxSim T2I
[N x N] and I2T [N x K*N] on the card (I2T with the page's tokens as the
query and the caption's, zero where padded, as the document, as
``colpali_engine`` scores without masks). The language model's chosen experts
are kept (``route_sink``) and each expert's routed rows read once a round,
after the round's barrier.

The check draws ``check.rounds`` completed rounds from the seed (only their
outputs are kept through the window, ``harness.Reservoir``) and in each
``pages`` pages, ``t2i_captions`` first captions and ``captions``
captions. After ``free()`` the reference (``reference/colpali_moe.py``)
draws the weights again part by part and embeds the drawn pages from their
raw pixels and the captions from their text. Routing near-ties flip under
bf16 rounding, and a flip moves that token and, through attention, every
later one by a whole expert's output, so two sound computations part more
with every layer: the f32 reference runs the experts the outputs it is
compared with chose, and reports its own choice and how far theirs lies
from it. The compared numbers: the worst gap of a drawn MaxSim score over
the reference's (an I2T score sums a page's 1030 token maxima, a T2I one a
caption's 20 or so, so the gap is taken relative); the
share of (token, MoE layer) pairs whose experts differ from the
reference's own choice; the worst margin of those experts in the
reference's router (``score + bias`` below its k-th largest: 0 for its own
choice, small for a flipped near-tie, large for a wrong router); the worst
1 - cosine of a drawn token embedding.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_embedding_tpu_torch.cli.main import compute_score_matrices
from multimodal_embedding_tpu_torch.models import zoo
from multimodal_embedding_tpu_torch.models.arch import colpali_word_tokenizer
from multimodal_embedding_tpu_torch.models.colpali import ColPaliConfig, colpali_deepseek_from_hf
from multimodal_embedding_tpu_torch.models.deepseek import deepseek_config_from_hf
from multimodal_embedding_tpu_torch.models.registry import model_info
from multimodal_embedding_tpu_torch.models.towers import VisionConfig
from multimodal_embedding_tpu_torch.ops.preprocess import PreprocessConfig
from multimodal_embedding_tpu_torch.utils.timing import hard_sync
from perfbench import generator, weights_moe, yardstick, yardstick_moe
from perfbench.drivers.encode import device_cache, raw_image
from perfbench.harness import Reservoir, sub_seed
from perfbench.port import DTYPES, RecordingEngine
from perfbench.reference import colpali_moe

CONTROL = "fp8"  # the precision below the bfloat16 model


def colpali_config(cfg: dict) -> ColPaliConfig:
    vc = cfg["vision_config"]
    vision = VisionConfig(image_size=vc["image_size"], patch_size=vc["patch_size"], dim=vc["hidden_size"],
                          layers=vc["num_hidden_layers"], heads=vc["num_attention_heads"],
                          mlp_dim=vc["intermediate_size"], proj_dim=None, style="siglip", act=vc["hidden_act"],
                          ln_eps=vc["layer_norm_eps"], use_head=False)
    return ColPaliConfig(vision=vision, gemma=deepseek_config_from_hf(cfg), embedding_dim=cfg["embedding_dim"])


def load_model(cfg: dict, seed: int, device) -> zoo.LoadedModel:
    """The configuration's retriever on ``device`` in its dtype, its weights
    drawn part by part from ``seed`` and converted as they come."""
    dtype = DTYPES[cfg["dtype"]]
    ccfg = colpali_config(cfg)
    parts = (weights_moe.draw(cfg, p, seed, device=device, dtype=dtype) for p in weights_moe.parts(cfg))
    model = colpali_deepseek_from_hf(parts, ccfg, cfg["image_suffix_ids"], dtype=dtype)
    recipe = cfg["preprocess"]
    pre = PreprocessConfig(image_size=recipe["image_size"], resize_mode=recipe["resize_mode"],
                           interpolation=recipe["interpolation"], mean=tuple(recipe["mean"]), std=tuple(recipe["std"]))
    return zoo.LoadedModel(info=model_info(cfg["registry"]), cfg=ccfg, model=model, preprocess=pre,
                           tokenize=colpali_word_tokenizer(cfg["vocab_size"]), multi_vector=True,
                           weights_provenance="arch-random")


def query_tokens(caption: str) -> int:
    """Valid tokens of a caption in ColPali's query prompt: BOS, "query:",
    the words, the augmentation tokens, the newline."""
    return 1 + len(("query: " + caption).split()) + colpali_moe.AUGMENTATION + 1


class Session:
    def __init__(self, cell):
        self.cell = cell
        cfg, tr, dev = cell.config, cell.traffic, cell.device
        self.cfg = cfg
        self.wseed = sub_seed(cell.seed, 1)
        self.model = load_model(cfg, self.wseed, dev)
        self.lm = self.model.model.gemma
        self.lm.route_sink = []
        self.engine = RecordingEngine(self.model, cfg["batch_size"], device=dev, spans=cell.spans)
        rng = np.random.default_rng([cell.seed, 2])
        gen = torch.Generator(device=dev).manual_seed(sub_seed(cell.seed, 3))
        per = tr["images"] // tr["caches"]
        self.records, self.caches = [], []
        for c in range(tr["caches"]):
            recs = generator.records(per, rng, first_id=c * per)
            self.records.append(recs)
            self.caches.append(device_cache(recs, tr["geometries"], cfg["batch_size"], rng, gen, dev))
        self.k = tr["captions_per_image"]
        self.kept: Reservoir | None = None
        self._follow: list[dict] | None = None  # the outputs the f32 reference follows

    def warmup(self):
        """Both caption sweeps of every set, so that each caption batch's
        shape (its length is the sweep's longest caption) has its CUDA graph
        before the window, what they leave behind (outputs, routes, expert
        loads, spans) dropped; then one round on the last set, so that the
        window's first round, on set 0, follows a round of other pages."""
        for c in range(len(self.caches)):
            for texts in self._texts(c):
                self.engine.encode_texts(texts)
        self.engine.outputs, self.lm.route_sink = [], []
        self.lm.take_expert_loads()
        if self.cell.spans is not None:
            self.cell.spans.clear()
        self.step(len(self.caches) - 1)
        self.kept = Reservoir(self.cell.traffic["check"]["rounds"], np.random.default_rng([self.cell.seed, 98]))

    def step(self, i: int) -> dict:
        c = i % len(self.caches)
        s_t2i, s_i2t, encode_s = compute_score_matrices(self.model, self.engine, self.records[c], self.caches[c])
        hard_sync(s_i2t)
        img, t2i, caps = self.engine.outputs
        self.engine.outputs = []
        routes, self.lm.route_sink = self.lm.route_sink, []
        if self.kept is not None:
            self.kept.offer(i, (img, t2i, caps, s_t2i, s_i2t, routes))
            slot = next((j for j, (u, _) in enumerate(self.kept.slots) if u == i), None)
            if slot is not None:  # a kept round's choices go to the host, one uint8 block a forward, so that
                # the router's small tensors do not pin the allocator's blocks through the window
                self.kept.slots[slot] = (i, (img, t2i, caps, s_t2i, s_i2t,
                                             [torch.stack(call, dim=1).to(torch.uint8).cpu() for call in routes]))
        rec = {"cache": c, "images": len(self.records[c]), "captions": t2i.shape[0] + caps.shape[0],
               "encode_s": encode_s, "expert_loads": self.lm.take_expert_loads()}
        if self.cell.spans is not None:
            spans = self.cell.spans
            rec["spans"] = {"image_sweep": sum(spans.pop("image_sweep", [])),
                            "text_sweep": sum(spans.pop("text_sweep", []))}
        return rec

    def _texts(self, c: int) -> tuple[list[str], list[str]]:
        recs = self.records[c]
        return [r["captions"][0] for r in recs], [x for r in recs for x in r["captions"][: self.k]]

    def required(self, records: list[dict]) -> dict:
        """The operations and bytes ``records``' rounds need; ``experts``
        one (operations, bytes) a batch and MoE layer."""
        cfg, geoms = self.cfg, self.cell.traffic["geometries"]
        batch, text_batch = cfg["batch_size"], max(cfg["batch_size"], 128)  # the engine's text batch
        page_t = yardstick_moe.page_tokens(cfg)
        moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
        crop = cfg["preprocess"]["image_size"]
        ys = yardstick_moe
        flops, pre_bytes, attn, experts = 0.0, 0.0, [], []
        for r in records:
            cache = self.caches[r["cache"]]
            n = cache.n_images
            t2i, caps = ([query_tokens(x) for x in texts] for texts in self._texts(r["cache"]))
            flops += n * ys.vision_flops(cfg) + (n * page_t + sum(t2i) + sum(caps)) * ys.token_flops(cfg)
            flops += ys.maxsim_flops(cfg, t2i, n) + ys.maxsim_flops(cfg, caps, n)
            lm_attn = [ys.attention_work(cfg, [page_t] * n), ys.attention_work(cfg, t2i), ys.attention_work(cfg, caps)]
            flops += sum(f for f, _ in lm_attn)  # the vision tower's is in vision_flops
            attn += [ys.vision_attention_work(cfg, n), *lm_attn]
            pre_bytes += sum(yardstick.preprocess_bytes(tuple(geoms[i % len(geoms)]), crop) for i in range(n))
            pages = [min(batch, count - s) for _, _, dev, count in cache.groups
                     for s in range(0, dev.shape[0] * batch, batch)]
            texts = [sum(v[s : s + text_batch]) for v in (t2i, caps) for s in range(0, len(v), text_batch)]
            experts += [ys.expert_work(cfg, tokens) for tokens in [p * page_t for p in pages] + texts] * moe_layers
        return {"flops": flops, "attention": attn, "preprocess_bytes": pre_bytes, "experts": experts}

    def free(self):
        del self.model, self.engine, self.lm
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check -----------------------------------------------------------

    def sample(self, records: list[dict], rng) -> list[dict]:
        chk = self.cell.traffic["check"]
        out = []
        for r in self.kept.kept():
            n = records[r]["images"]
            out.append({"round": r, "cache": records[r]["cache"],
                        "pages": np.sort(rng.choice(n, chk["pages"], replace=False)),
                        "t2i": np.sort(rng.choice(n, chk["t2i_captions"], replace=False)),
                        "captions": np.sort(rng.choice(n * self.k, chk["captions"], replace=False))})
        return out

    def _routes(self, calls: list[torch.Tensor], cache, lengths: tuple[int, int]):
        """The kept round's chosen experts (one [B*T, L, k] block a forward)
        by item, each [T, L, k] ascending: (pages, first captions, captions),
        from the forwards in engine order (the cache's batches, then each
        caption sweep's batches)."""
        stacked = [call.long().sort(dim=-1).values for call in calls]  # [B*T, L, k]
        pages, it = [None] * cache.n_images, iter(stacked)
        for _, idxs, dev, count in cache.groups:
            for j in range(dev.shape[0]):
                r = next(it).view(dev.shape[1], -1, *stacked[0].shape[1:])
                for row in range(dev.shape[1]):
                    if j * dev.shape[1] + row < count:
                        pages[idxs[j * dev.shape[1] + row]] = r[row]
        texts = []
        for length, n in zip(lengths, (cache.n_images, cache.n_images * self.k)):
            rows = []
            while sum(x.shape[0] for x in rows) < n:
                rows.append(next(it).view(-1, length, *stacked[0].shape[1:]))
            texts.append(torch.cat(rows))
        return pages, texts[0], texts[1]

    def outputs(self, records: list[dict], sample: list[dict]) -> list[dict]:
        got = []
        for s in sample:
            img, t2i, caps, s_t2i, s_i2t, calls = self.kept.kept()[s["round"]]
            cache = self.caches[s["cache"]]
            first, every = self._texts(s["cache"])
            r_pages, r_t2i, r_caps = (r.to(img.device) if torch.is_tensor(r) else [x.to(img.device) for x in r]
                                      for r in self._routes(calls, cache, (t2i.shape[1], caps.shape[1])))
            texts = [(t2i, r_t2i, int(q), first[int(q)]) for q in s["t2i"]]
            texts += [(caps, r_caps, int(c), every[int(c)]) for c in s["captions"]]
            n = [query_tokens(x[3]) for x in texts]
            i, q, c = (torch.as_tensor(s[k], device=img.device) for k in ("pages", "t2i", "captions"))
            got.append({"pages": img[i].float(), "page_routes": torch.stack([r_pages[int(p)] for p in s["pages"]]),
                        "texts": [e[j, :v].float() for (e, _, j, _), v in zip(texts, n)],
                        "text_routes": [r[j, :v] for (_, r, j, _), v in zip(texts, n)],
                        "s_t2i": s_t2i[q][:, i].float(), "s_i2t": s_i2t[i][:, c].float()})
        self._follow = got
        return got

    def reference(self, sample: list[dict], prec: str) -> list[dict]:
        """The reference's outputs on ``sample`` in ``prec``. In "f32" each
        MoE layer runs the experts of the outputs last produced for the same
        sample (the program's, from :meth:`outputs`, or the control's, from
        this method in the control's precision), as ``harness.check`` makes
        them just before; in any other precision it routes by itself."""
        cfg, dev = self.cfg, self.cell.device
        dtype = DTYPES[cfg["dtype"]]
        follow = self._follow if prec == "f32" else None
        if prec == "f32" and follow is None:
            raise RuntimeError("the f32 reference follows the outputs made just before it; none were made")

        def draw(part):
            return weights_moe.draw(cfg, part, self.wseed, device=dev, dtype=dtype)

        out = []
        for j, s in enumerate(sample):
            cache = self.caches[s["cache"]]
            first, every = self._texts(s["cache"])
            texts = [first[int(q)] for q in s["t2i"]] + [every[int(c)] for c in s["captions"]]
            forced = None
            if follow is not None:
                f = follow[j]
                n = max(x.shape[0] for x in f["text_routes"])
                queries = torch.full((len(texts), n, *f["page_routes"].shape[2:]), -1, dtype=torch.int64, device=dev)
                for row, r in enumerate(f["text_routes"]):
                    queries[row, : r.shape[0]] = r
                forced = {"pages": f["page_routes"], "queries": queries}
            e = colpali_moe.embed([raw_image(cache, int(p)) for p in s["pages"]], texts, draw, cfg, prec, dev, forced)
            n = e["query_mask"].sum(dim=1).tolist()
            nq = len(s["t2i"])
            # I2T scores each page's tokens against a caption's tokens as the
            # sweep ran them: padded with zero vectors to the sweep's longest
            caps = e["queries"][nq:]
            longest = max(query_tokens(x) for x in every)
            caps = torch.nn.functional.pad(caps, (0, 0, 0, longest - caps.shape[1]))
            out.append({"pages": e["pages"], "page_routes": e["page_routes"], "page_margin": e["page_margin"],
                        "texts": [e["queries"][r, :v] for r, v in enumerate(n)],
                        "text_routes": [e["query_routes"][r, :v] for r, v in enumerate(n)],
                        "text_margin": [e["query_margin"][r, :v] for r, v in enumerate(n)],
                        "s_t2i": colpali_moe.maxsim(e["queries"][:nq], e["pages"], prec),
                        "s_i2t": colpali_moe.maxsim(e["pages"], caps, prec)})
        self._follow = out if prec != "f32" else None
        return out

    @staticmethod
    def compare(got: list[dict], want: list[dict]) -> dict[str, float]:
        """Worst gap of a drawn MaxSim score relative to the reference's; the
        share of (token, MoE layer) pairs whose experts differ from the
        reference's own choice; the worst margin of those experts in the
        reference's router (0 for its own choice); the worst 1 - cosine of a
        token embedding."""
        bad = {k: float("inf") for k in ("score_rel_gap", "route_flip_share", "route_margin", "token_cos_gap")}
        score, flips, pairs, margin, cos_gap = 0.0, 0, 0, 0.0, 0.0
        for g, w in zip(got, want):
            score = max(score, max(float(((g[k] - w[k]) / w[k]).abs().max()) for k in ("s_t2i", "s_i2t")))
            emb = [(g["pages"], w["pages"], g["page_routes"], w["page_routes"], w["page_margin"])]
            emb += list(zip(g["texts"], w["texts"], g["text_routes"], w["text_routes"], w["text_margin"]))
            for ge, we, gr, wr, wm in emb:
                if gr.shape != wr.shape or ge.shape != we.shape:
                    return bad
                differ = (gr != wr).any(dim=-1)  # [..., L]
                flips += int(differ.sum())
                pairs += differ.numel()
                margin = max(margin, float(wm.max()))
                cos = torch.nn.functional.cosine_similarity(ge, we, dim=-1)
                cos_gap = max(cos_gap, float((1.0 - cos).max()))
        return {"score_rel_gap": score, "route_flip_share": flips / max(pairs, 1), "route_margin": margin,
                "token_cos_gap": cos_gap}
