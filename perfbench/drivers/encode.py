"""The encode phase of a COCO-5k evaluation, one tenth a round.

Set-up makes the configuration's weights and the traffic's images on the
device from the seed: ``images`` records split into ``caches`` sets, each
staged as the CLI's default ``--device-cache`` hands it to the engine
(``models/encode.py:stage_images``): grouped by geometry in order of first
appearance, padded batches of the configuration's batch size, the last
padded by repeating its group's last image. Round r runs the CLI's
``compute_score_matrices`` on set r mod ``caches`` and its records: the
image sweep, the T2I sweep of first captions, the I2T sweep of every
caption, then both dense score matrices.

The check draws ``check.rounds`` completed rounds from the seed, keeping
only their outputs through the window (``harness.Reservoir``), and, in
each, images, first captions and captions; the reference embeds them from
the raw pixels and the caption text, and scores the drawn pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_embedding_tpu_torch.cli.main import compute_score_matrices
from multimodal_embedding_tpu_torch.models.encode import DeviceImageCache
from multimodal_embedding_tpu_torch.utils.timing import hard_sync
from perfbench import generator, yardstick
from perfbench.harness import Reservoir, sub_seed
from perfbench.port import load
from perfbench.reference import retrieval, towers

REF_BATCH = 8  # images the reference runs at once
CONTROL = "fp8"  # the precision below the bfloat16 towers


def device_cache(recs: list[dict], geometries: list, batch: int, rng, gen, device) -> DeviceImageCache:
    """The images of ``recs`` (record i of geometry i mod G) rendered on the
    device and laid out as ``stage_images`` lays them out."""
    groups = []
    for g, (h, w) in enumerate(geometries):
        idxs = list(range(g, len(recs), len(geometries)))
        if not idxs:
            continue
        imgs = generator.render([recs[i] for i in idxs], h, w, rng, gen, device)
        nb = -(-len(idxs) // batch)
        pad = nb * batch - len(idxs)
        if pad:
            imgs = torch.cat([imgs, imgs[-1:].expand(pad, -1, -1, -1)])
        groups.append(((h, w), idxs, imgs.view(nb, batch, 3, h, w), len(idxs)))
    return DeviceImageCache(groups, batch, len(recs), 0.0)


def raw_image(cache: DeviceImageCache, i: int) -> torch.Tensor:
    """Record i's uint8 [3, H, W] pixels in a cache ``device_cache`` made."""
    g = i % len(cache.groups)
    _, idxs, dev, _ = cache.groups[g]
    j = idxs.index(i)
    return dev[j // cache.batch_size, j % cache.batch_size]


class Session:
    def __init__(self, cell):
        self.cell = cell
        cfg, tr, dev = cell.config, cell.traffic, cell.device
        self.cfg = cfg
        self.sd, self.model, self.engine = load(cell)
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

    def warmup(self):
        """One round on the last set, so that the window's first round, on
        set 0, follows a round of other images."""
        self.step(len(self.caches) - 1)
        self.kept = Reservoir(self.cell.traffic["check"]["rounds"], np.random.default_rng([self.cell.seed, 98]))

    def step(self, i: int) -> dict:
        c = i % len(self.caches)
        s_t2i, s_i2t, encode_s = compute_score_matrices(self.model, self.engine, self.records[c], self.caches[c])
        hard_sync(s_i2t)
        img, t2i, caps = self.engine.outputs
        self.engine.outputs = []
        if self.kept is not None:
            self.kept.offer(i, (img, t2i, caps, s_t2i, s_i2t))
        rec = {"cache": c, "images": len(self.records[c]), "captions": t2i.shape[0] + caps.shape[0],
               "encode_s": encode_s}
        if self.cell.spans is not None:
            spans = self.cell.spans
            rec["spans"] = {"image_sweep": sum(spans.pop("image_sweep", [])),
                            "text_sweep": sum(spans.pop("text_sweep", []))}
        return rec

    def required(self, records: list[dict]) -> dict:
        """The operations and bytes ``records``' rounds need."""
        cfg, geoms = self.cfg, self.cell.traffic["geometries"]
        crop = cfg["preprocess"]["image_size"]
        t = yardstick.text_len(cfg)
        e = yardstick.embed_dim(cfg)
        flops, pre_bytes, attn = 0.0, 0.0, []
        for r in records:
            recs = self.records[r["cache"]]
            n = len(recs)
            t2i = [yardstick.caption_tokens(x["captions"][0], t) for x in recs]
            caps = [yardstick.caption_tokens(c, t) for x in recs for c in x["captions"][: self.k]]
            flops += n * yardstick.image_flops(cfg)
            flops += sum(yardstick.caption_flops(cfg, v) for v in t2i + caps)
            flops += yardstick.dense_score_flops(n, n, e) + yardstick.dense_score_flops(n, len(caps), e)
            pre_bytes += sum(yardstick.preprocess_bytes(tuple(geoms[i % len(geoms)]), crop) for i in range(n))
            attn += yardstick.image_attention_work(cfg, n)
            attn += [yardstick.text_attention_work(cfg, t2i), yardstick.text_attention_work(cfg, caps)]
        return {"flops": flops, "attention": attn, "preprocess_bytes": pre_bytes}

    def free(self):
        del self.model, self.engine
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check -----------------------------------------------------------

    def sample(self, records: list[dict], rng) -> list[dict]:
        chk = self.cell.traffic["check"]
        out = []
        for r in self.kept.kept():
            n = records[r]["images"]
            out.append({"round": r, "cache": records[r]["cache"],
                        "images": np.sort(rng.choice(n, chk["images"], replace=False)),
                        "t2i": np.sort(rng.choice(n, chk["t2i_captions"], replace=False)),
                        "captions": np.sort(rng.choice(n * self.k, chk["captions"], replace=False))})
        return out

    def outputs(self, records: list[dict], sample: list[dict]) -> list[dict]:
        got = []
        for s in sample:
            img, t2i, caps, s_t2i, s_i2t = self.kept.kept()[s["round"]]
            i, q, c = (torch.as_tensor(s[k], device=img.device) for k in ("images", "t2i", "captions"))
            got.append({"images": img[i].float(), "t2i": t2i[q].float(), "captions": caps[c].float(),
                        "s_t2i": s_t2i[q][:, i].float(), "s_i2t": s_i2t[i][:, c].float()})
        return got

    def reference(self, sample: list[dict], prec: str) -> list[dict]:
        cfg, dev = self.cfg, self.cell.device
        out = []
        for s in sample:
            recs, cache = self.records[s["cache"]], self.caches[s["cache"]]
            pix = [raw_image(cache, int(i)) for i in s["images"]]
            img = torch.cat([towers.image_embeddings(pix[b : b + REF_BATCH], self.sd, cfg, prec)
                             for b in range(0, len(pix), REF_BATCH)])
            t2i = towers.text_embeddings([recs[int(q)]["captions"][0] for q in s["t2i"]], self.sd, cfg, prec, dev)
            caps = towers.text_embeddings([recs[int(c) // self.k]["captions"][int(c) % self.k] for c in s["captions"]],
                                          self.sd, cfg, prec, dev)
            img, t2i, caps = (retrieval.l2_normalize(x) for x in (img, t2i, caps))
            out.append({"images": img, "t2i": t2i, "captions": caps,
                        "s_t2i": retrieval.dense_scores(t2i, img, prec), "s_i2t": retrieval.dense_scores(img, caps, prec)})
        return out

    @staticmethod
    def compare(got: list[dict], want: list[dict]) -> dict[str, float]:
        """Worst 1 - cosine of image and of caption embeddings, and worst
        absolute gap of a drawn score, over the sample."""
        def cos_gap(a, b):
            return float((1.0 - torch.nn.functional.cosine_similarity(a, b, dim=-1)).max())

        img = max(cos_gap(g["images"], w["images"]) for g, w in zip(got, want))
        txt = max(max(cos_gap(g["t2i"], w["t2i"]), cos_gap(g["captions"], w["captions"])) for g, w in zip(got, want))
        score = max(max(float((g[k] - w[k]).abs().max()) for k in ("s_t2i", "s_i2t")) for g, w in zip(got, want))
        return {"image_cos_gap": img, "text_cos_gap": txt, "score_gap": score}
