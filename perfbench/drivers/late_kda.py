"""Late interaction over page images with a hybrid linear-attention and MoE
retriever: the ``late`` driver (``late.py``, imported) for the
``colpali-kimi-linear`` family, ColPali's vision side around Kimi-Linear's
decoder of KDA and MLA layers, three to one, with a MoE of 256 experts.

A round is ``late.py``'s: the page sweep, the T2I and I2T caption sweeps in
ColPali's query prompt, MaxSim T2I and I2T on the card; the decoder's chosen
experts kept a forward and each expert's routed rows read once a round.
Set-up draws the weights part by part on the device (``weights_kda.py``) and
loads them through the port's converter
(``models/colpali.py:colpali_kimi_linear_from_hf``). The work a round needs
is ``yardstick_kda.py``'s; ``required`` adds the recurrence's, one
(operations, bytes) a batch and KDA layer, under ``"kda"``.

The check is ``late.py``'s, against ``reference/colpali_kda.py``: the f32
reference runs the experts the outputs it is held against chose, and reports
its own choice and the margin of theirs (``score + bias`` below its k-th
largest). The compared numbers are ``late.py``'s four: ``score_rel_gap``,
``route_flip_share``, ``route_margin`` and ``token_cos_gap``.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_embedding_tpu_torch.models import zoo
from multimodal_embedding_tpu_torch.models.arch import colpali_word_tokenizer
from multimodal_embedding_tpu_torch.models.colpali import ColPaliConfig, colpali_kimi_linear_from_hf
from multimodal_embedding_tpu_torch.models.kimi_linear import kimi_linear_config_from_hf
from multimodal_embedding_tpu_torch.models.registry import model_info
from multimodal_embedding_tpu_torch.models.towers import VisionConfig
from multimodal_embedding_tpu_torch.ops.preprocess import PreprocessConfig
from perfbench import generator, weights_kda, yardstick, yardstick_kda
from perfbench.drivers import late
from perfbench.drivers.encode import device_cache, raw_image
from perfbench.harness import sub_seed
from perfbench.port import DTYPES, RecordingEngine
from perfbench.reference import colpali_kda

CONTROL = late.CONTROL  # fp8: the precision below the bfloat16 model
query_tokens = late.query_tokens


def colpali_config(cfg: dict) -> ColPaliConfig:
    vc = cfg["vision_config"]
    vision = VisionConfig(image_size=vc["image_size"], patch_size=vc["patch_size"], dim=vc["hidden_size"],
                          layers=vc["num_hidden_layers"], heads=vc["num_attention_heads"],
                          mlp_dim=vc["intermediate_size"], proj_dim=None, style="siglip", act=vc["hidden_act"],
                          ln_eps=vc["layer_norm_eps"], use_head=False)
    return ColPaliConfig(vision=vision, gemma=kimi_linear_config_from_hf(cfg), embedding_dim=cfg["embedding_dim"])


def load_model(cfg: dict, seed: int, device) -> zoo.LoadedModel:
    """The configuration's retriever on ``device`` in its dtype, its weights
    drawn part by part from ``seed`` and converted as they come."""
    dtype = DTYPES[cfg["dtype"]]
    ccfg = colpali_config(cfg)
    parts = (weights_kda.draw(cfg, p, seed, device=device, dtype=dtype) for p in weights_kda.parts(cfg))
    model = colpali_kimi_linear_from_hf(parts, ccfg, cfg["image_suffix_ids"], dtype=dtype)
    recipe = cfg["preprocess"]
    pre = PreprocessConfig(image_size=recipe["image_size"], resize_mode=recipe["resize_mode"],
                           interpolation=recipe["interpolation"], mean=tuple(recipe["mean"]), std=tuple(recipe["std"]))
    return zoo.LoadedModel(info=model_info(cfg["registry"]), cfg=ccfg, model=model, preprocess=pre,
                           tokenize=colpali_word_tokenizer(cfg["vocab_size"]), multi_vector=True,
                           weights_provenance="arch-random")


class Session(late.Session):
    def __init__(self, cell):  # late.Session's, with this family's loader
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
        self.kept = None
        self._follow = None

    def required(self, records: list[dict]) -> dict:
        """The operations and bytes ``records``' rounds need; ``experts``
        one (operations, bytes) a batch and MoE layer, ``kda`` one a batch and
        KDA layer."""
        cfg, geoms = self.cfg, self.cell.traffic["geometries"]
        batch, text_batch = cfg["batch_size"], max(cfg["batch_size"], 128)  # the engine's text batch
        ys = yardstick_kda
        page_t = ys.page_tokens(cfg)
        kda_layers, _, moe_layers = ys.layer_counts(cfg)
        crop = cfg["preprocess"]["image_size"]
        flops, pre_bytes, attn, experts, kda = 0.0, 0.0, [], [], []
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
            tokens = [p * page_t for p in pages] + texts
            experts += [ys.expert_work(cfg, t) for t in tokens] * moe_layers
            kda += [ys.kda_work(cfg, t) for t in tokens] * kda_layers
        return {"flops": flops, "attention": attn, "preprocess_bytes": pre_bytes, "experts": experts, "kda": kda}

    def reference(self, sample: list[dict], prec: str) -> list[dict]:
        """``late.Session.reference`` on this family's reference and weights."""
        cfg, dev = self.cfg, self.cell.device
        dtype = DTYPES[cfg["dtype"]]
        follow = self._follow if prec == "f32" else None
        if prec == "f32" and follow is None:
            raise RuntimeError("the f32 reference follows the outputs made just before it; none were made")

        def draw(part):
            return weights_kda.draw(cfg, part, self.wseed, device=dev, dtype=dtype)

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
            e = colpali_kda.embed([raw_image(cache, int(p)) for p in s["pages"]], texts, draw, cfg, prec, dev, forced)
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
                        "s_t2i": colpali_kda.maxsim(e["queries"][:nq], e["pages"], prec),
                        "s_i2t": colpali_kda.maxsim(e["pages"], caps, prec)})
        self._follow = out if prec != "f32" else None
        return out
