"""A world of gloo ranks on the CPU for the port's parallel tests.

``run_world`` starts ``world`` processes of this file, each one rank of a
``torch.distributed`` gloo group over a ``FileStore`` (no TCP port: tier-1
runs several test files at once), one intra-op thread each, every
collective under a 60 s timeout so that a hang fails instead of waiting.
Each rank loads the inputs the test module saved (weights drawn by the JAX
package and carried by ``params_from_jax``, inputs made with numpy), runs
every case of its suite, and saves its results for the test module to check
against the JAX package. Each rank gets its own ``PYTHONHASHSEED``, so the
debug tokenizer's hash differs between ranks, as it does between processes
launched by torchrun.

    python tests/torch_parallel_world.py <suite> <work dir> <rank> <world>

Imports torch and the port only, never JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT_S = 240
COLLECTIVE_TIMEOUT_S = 60


def run_world(suite: str, world: int, work: Path, inputs: dict) -> list[dict]:
    """Save ``inputs``, run ``world`` ranks of ``suite`` in ``work`` and
    return each rank's results; raises with the failing ranks' output."""
    return join_world(start_world(suite, world, work, inputs), work)


def start_world(suite: str, world: int, work: Path, inputs: dict) -> list:
    """Save ``inputs`` and start ``world`` ranks of ``suite`` in ``work``;
    :func:`join_world` waits for them (the caller works meanwhile)."""
    import torch

    work.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, work / "inputs.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        log = open(work / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), suite, str(work), str(rank), str(world)],
            cwd=work, env={**env, "PYTHONHASHSEED": str(rank + 1)}, stdout=log, stderr=subprocess.STDOUT,
        ), log))
    return procs


def join_world(procs: list, work: Path) -> list[dict]:
    """Wait for the ranks :func:`start_world` started and return each rank's
    results; raises with the failing ranks' output."""
    import torch

    failed = []
    for rank, (proc, log) in enumerate(procs):
        try:
            rc = proc.wait(timeout=WORLD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append(f"rank {rank} ({rc}):\n{(work / f'rank{rank}.log').read_text()[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return [torch.load(work / f"out_{rank}.pt", weights_only=False) for rank in range(len(procs))]


# --- the ranks -----------------------------------------------------------------


def _gathered(x, mesh, dim):
    from multimodal_embedding_tpu_torch.parallel.mesh import all_gather_cat

    return all_gather_cat(x, mesh.model_group, mesh.n_model, dim=dim)


def parallel_suite(inp: dict) -> dict:
    import numpy as np
    import torch

    from multimodal_embedding_tpu_torch import runtime
    from multimodal_embedding_tpu_torch.models.colpali import ColPali, debug_colpali_config
    from multimodal_embedding_tpu_torch.models.encode import AsyncImageStager, EncodingEngine, stage_images
    from multimodal_embedding_tpu_torch.models.gemma import Gemma, GemmaConfig
    from multimodal_embedding_tpu_torch.models.layers import Encoder, MultiHeadAttention, attention_core
    from multimodal_embedding_tpu_torch.models.registry import model_info
    from multimodal_embedding_tpu_torch.models.towers import DualEncoder
    from multimodal_embedding_tpu_torch.models.zoo import debug_dual_config, load_debug_model
    from multimodal_embedding_tpu_torch.ops.maxsim_cuda import maxsim_scores
    from multimodal_embedding_tpu_torch.parallel import sp as psp
    from multimodal_embedding_tpu_torch.parallel.batched import sharded_batch_apply
    from multimodal_embedding_tpu_torch.parallel.mesh import get_mesh, get_multihost_mesh
    from multimodal_embedding_tpu_torch.parallel.sp import gather_tokens, shard_tokens, sp_attention
    from multimodal_embedding_tpu_torch.parallel.tp import shard_params_tp
    from multimodal_embedding_tpu_torch.retrieval.scoring import dense_scores
    from multimodal_embedding_tpu_torch.stats.bootstrap import bootstrap_benchmark

    out: dict = {}
    mesh22, mesh14, mesh41 = get_mesh(2, 2), get_mesh(1, 4), get_mesh(4, 1)
    gen = torch.Generator().manual_seed(0)

    # TP(2) x DP(2): the dual encoder, the kernel route (its plain version here)
    with runtime.using(attention="pallas", tp=mesh22):
        model = DualEncoder(debug_dual_config("dense"), device="cpu")
        model.load_state_dict(inp["dual_sd"])
        shard_params_tp(model, mesh22)
        out["tp_q_shape"] = tuple(model.vision.encoder.layers[0].attn.q.w.shape)
        with torch.inference_mode():
            out["tp_img"] = sharded_batch_apply(model.encode_image, inp["px"], mesh=mesh22, batch_size=8)
            out["tp_txt"] = sharded_batch_apply(model.encode_text, inp["ids"], mesh=mesh22, batch_size=8)

            # packed attention on this rank's heads, batch over the data axis
            d = inp["qf"].shape[-1]
            cols = slice(mesh22.model_rank * d // 2, (mesh22.model_rank + 1) * d // 2)

            def attn(q, k, v, m):
                return _gathered(attention_core(q[..., cols], k[..., cols], v[..., cols], 8 // 2, mask=m), mesh22, -1)

            out["tp_attn"] = sharded_batch_apply(attn, (inp["qf"], inp["kf"], inp["vf"], inp["attn_mask"]),
                                                 mesh=mesh22, batch_size=4)

            # a whole encoder stack under TP, the kernel route
            enc = Encoder(2, 512, 8, 256, "gelu", 1e-5, gen=gen, device="cpu", dtype=torch.float32)
            enc.load_state_dict(inp["enc_sd"])
            shard_params_tp(enc, mesh22)
            out["tp_encoder"] = sharded_batch_apply(enc, inp["enc_x"], mesh=mesh22, batch_size=4)

            # 6 heads over 4 ranks: kept whole, every rank runs the one-rank layer
            with runtime.using(tp=mesh14):
                fb = MultiHeadAttention(384, 6, gen=gen, device="cpu", dtype=torch.float32)
                fb.load_state_dict(inp["fb_sd"])
                shard_params_tp(fb, mesh14)
                out["fb_whole"] = (tuple(fb.q.w.shape), fb.n_heads, fb.o.reduce_group is None)
                out["fb"] = fb(inp["fb_x"])

            # Gemma under TP(2) x DP(2): query heads split, the one KV head on both
            gcfg = GemmaConfig(vocab_size=64, dim=32, layers=2, heads=4, kv_heads=1, head_dim=8, mlp_dim=64)
            gemma = Gemma(gcfg, gen=gen, device="cpu", dtype=torch.float32)
            gemma.load_state_dict(inp["gemma_sd"])
            whole = Gemma(gcfg, gen=gen, device="cpu", dtype=torch.float32)
            whole.load_state_dict(inp["gemma_sd"])
            shard_params_tp(gemma, mesh22)
            out["tp_gemma"] = sharded_batch_apply(gemma, (inp["gemma_x"], inp["gemma_mask"]), mesh=mesh22, batch_size=4)

    with torch.inference_mode():
        # sp_attention over 4 ranks against the JAX function
        def sp(q, k, v, mask=None, causal=False):
            km = None if mask is None else shard_tokens(mask, mesh14, dim=1)
            local = sp_attention(shard_tokens(q, mesh14, 2), shard_tokens(k, mesh14, 2), shard_tokens(v, mesh14, 2),
                                 mesh14, key_mask=km, causal=causal)
            return local, gather_tokens(local, mesh14, dim=2)

        for causal in (False, True):
            local, out[f"sp_{causal}"] = sp(inp["sp_q"], inp["sp_k"], inp["sp_v"], causal=causal)
            out[f"sp_local_shape_{causal}"] = tuple(local.shape)
        out["sp_gqa_mask"] = sp(inp["sp_q"], inp["sp_k2"], inp["sp_v2"], inp["sp_mask"], causal=True)[1]

        # ColPali under SP: 10 image tokens (a 6-token suffix) split over 2
        # ranks, not over 4; 16 query tokens over both
        calls = {"n": 0}
        real_sp_attention = psp.sp_attention

        def counting(*a, **kw):
            calls["n"] += 1
            return real_sp_attention(*a, **kw)

        psp.sp_attention = counting
        cp = ColPali(debug_colpali_config(), inp["cp_suffix"], device="cpu")
        cp.load_state_dict(inp["cp_sd"])
        out["cp_img_alone"] = cp.image_fwd(inp["cp_px"])
        out["cp_txt_alone"] = cp.text_fwd(inp["cp_ids"], inp["cp_mask"])
        for tag, mesh in (("sp2", mesh22), ("sp4", mesh14)):
            for fwd, args in (("img", (inp["cp_px"],)), ("txt", (inp["cp_ids"], inp["cp_mask"]))):
                calls["n"] = 0
                with runtime.using(sp=mesh):
                    out[f"cp_{fwd}_{tag}"] = (cp.image_fwd if fwd == "img" else cp.text_fwd)(*args)
                out[f"cp_{fwd}_{tag}_sp_calls"] = calls["n"]
        # Gemma over 11 tokens and 4 ranks: the whole sequence on every rank
        out["gemma11_alone"] = whole(inp["gemma11_x"])
        calls["n"] = 0
        with runtime.using(sp=mesh14):
            out["gemma11_sp4"] = whole(inp["gemma11_x"], sp=psp.sp_mesh_for(11))
        out["gemma11_sp_calls"] = calls["n"]
        psp.sp_attention = real_sp_attention

        # scoring and the bootstrap on a data mesh of 4 against one rank
        hosts = get_multihost_mesh(1, local_world=2)  # 2 hosts x 2 ranks
        for tag, mesh in (("flat", mesh41), ("multi", hosts), ("alone", None)):
            s_t2i = dense_scores(inp["txt"], inp["img"], mesh=mesh)
            s_i2t = dense_scores(inp["img"], inp["txt_all"], mesh=mesh)
            boot = bootstrap_benchmark(s_t2i, s_i2t, 10, seed=42, caps_per_image=5, mesh=mesh)
            out[f"scores_{tag}"] = (s_t2i, s_i2t)
            out[f"boot_{tag}"] = (boot.metrics, boot.correct_r1, boot.sample_idx)
            out[f"odd_{tag}"] = dense_scores(inp["odd_q"], inp["odd_d"], mesh=mesh)
            out[f"maxsim_{tag}"] = maxsim_scores(inp["ms_q"], inp["ms_d"], inp["ms_qmask"], inp["ms_dmask"],
                                                 impl="xla", mesh=mesh)

        # the stager and the engine: each data rank's rows of every batch
        rng = np.random.default_rng(7)
        images = [rng.integers(0, 256, (48, 64, 3) if i % 3 else (64, 48, 3), dtype=np.uint8) for i in range(11)]
        stager = AsyncImageStager(images, 8, "cpu", mesh41)
        cache = stager.wait()
        staged = stage_images(images, 8, "cpu", mesh41)
        out["stager_rows"] = [(geom, idxs, dev.clone(), count) for geom, idxs, dev, count in cache.groups]
        out["staged_rows"] = [(geom, idxs, dev.clone(), count) for geom, idxs, dev, count in staged.groups]
        clip = load_debug_model(model_info("OpenAI-CLIP-L"), seed=0, device="cpu")
        out["engine_dp"] = EncodingEngine(clip, 8, device="cpu", mesh=mesh41).encode_images_cached(cache).embeddings
        alone = stage_images(images, 8, "cpu")
        out["engine_alone"] = EncodingEngine(clip, 8, device="cpu").encode_images_cached(alone).embeddings
    return out


def cli_suite(inp: dict) -> dict:
    """The CLI on this world (DP, then TP over every rank, then SP over every
    rank for ColPali), recording the token ids each rank encoded and the
    files each rank wrote; then rank 0 alone, in the same process (so with
    the same hash salt), after the group is gone."""
    import numpy as np
    import pandas as pd
    import torch.distributed as dist

    from multimodal_embedding_tpu_torch.cli import main as cli
    from multimodal_embedding_tpu_torch.models import encode

    out: dict = {"shared": [], "to_csv": [], "savez": []}
    real_share, real_to_csv, real_savez = encode.share_from_rank0, pd.DataFrame.to_csv, np.savez_compressed

    def sharing(arr, device):
        mine = None if arr is None else np.array(arr)
        got = real_share(arr, device)
        if mine is not None and mine.shape[1] > 1 and dist.is_initialized():  # the world's ids and masks
            out["shared"].append((mine, got.numpy().copy()))
        return got

    def to_csv(self, path, *a, **kw):
        out["to_csv"].append(str(path))
        return real_to_csv(self, path, *a, **kw)

    def savez(path, *a, **kw):
        out["savez"].append(str(path))
        return real_savez(path, *a, **kw)

    encode.share_from_rank0, pd.DataFrame.to_csv, np.savez_compressed = sharing, to_csv, savez
    base = ["--device", "cpu", "--dataset", "synthetic", "--debug-models", "--sample-size", "16",
            "--bootstrap-iterations", "20", "--batch-size", "8", "--no-overlap-staging"]
    n = dist.get_world_size()
    runs = {
        "dp": [*base, "--models", "OpenAI-CLIP-L"],
        "tp": [*base, "--models", "OpenAI-CLIP-L", "--tensor-parallel", str(n)],
        "sp": [*base, "--models", "ColPali-v1.3", "--sequence-parallel", str(n)],
    }
    for tag, argv in runs.items():
        out[f"rc_{tag}"] = cli.main([*argv, "--output", f"{tag}.csv"])
    out["log_written"] = Path("benchmark_v29.log").exists()
    rank = dist.get_rank()
    dist.destroy_process_group()
    if rank == 0:
        out["rc_alone"] = cli.main([*base, "--models", "OpenAI-CLIP-L,ColPali-v1.3", "--output", "alone.csv"])
    encode.share_from_rank0, pd.DataFrame.to_csv, np.savez_compressed = real_share, real_to_csv, real_savez
    return out


def _numpy(tree):
    return {n: {p: x.detach().numpy().copy() for p, x in ab.items()} for n, ab in tree.items()}


def grpo_suite(inp: dict) -> dict:
    """Workload B on (data, model) meshes of 2 x 2 and 1 x 4: for each
    decoder case, one ``loss_and_grads`` and one AdamW step of a trainer on
    the mesh from the JAX adapters; then, on each decoder split over the
    model axis, the prefill's cache, greedy and sampled ``generate``, and the
    first decode step's logits beside the same model on one rank."""
    import torch
    import torch.distributed as dist

    from multimodal_embedding_tpu_torch.parallel.mesh import get_mesh
    from multimodal_embedding_tpu_torch.parallel.tp import shard_params_tp
    from multimodal_embedding_tpu_torch.rl.generate import generate
    from multimodal_embedding_tpu_torch.rl.grpo import GRPOConfig, GRPOTrainer
    from multimodal_embedding_tpu_torch.rl.lora import LoraConfig
    from multimodal_embedding_tpu_torch.rl.policy import get_arch
    from multimodal_embedding_tpu_torch.rl.rewards import support_ticket_reward

    def model(case):
        arch = get_arch(case["arch"])
        return arch.from_params(case["tree"], arch.config(**case["cfg"]), device="cpu")

    out: dict = {}
    rank = dist.get_rank()
    ids, mask = (torch.from_numpy(x) for x in inp["prompts"])
    for tag, mesh in (("2x2", get_mesh(2, 2)), ("1x4", get_mesh(1, 4))):
        for name, case in inp["cases"].items():
            trainer = GRPOTrainer(model(case), support_ticket_reward,
                                  GRPOConfig(lora=LoraConfig(), learning_rate=inp["lr"]), mesh=mesh)
            with torch.no_grad():
                for n, ab in trainer.adapters.items():
                    for p, x in ab.items():
                        x.copy_(torch.from_numpy(case["adapters"][n][p]))
            (loss, (pg, kl)), grads = trainer.loss_and_grads(trainer.adapters,
                                                             *(torch.from_numpy(x) for x in case["batch"]))
            trainer._update(grads)
            layer = trainer.base.layers[0]
            out[tag, name] = {"terms": [float(loss), float(pg), float(kl)], "grads": _numpy(grads),
                              "after": _numpy(trainer.adapters), "q_shape": tuple(layer.attn["q"].shape),
                              "split": layer.attn_split}
        for name in inp["rollout"]:
            case = inp["cases"][name]
            whole, split = model(case), shard_params_tp(model(case), mesh)
            new = inp["max_new"]
            valid = torch.cat([mask > 0, torch.ones_like(mask[:, :1], dtype=torch.bool)], dim=1)
            with torch.no_grad():
                steps = []
                for m in (whole, split):  # the prefill, then one decode step of token 7
                    _, kv = m.prefill(ids, mask, ids.shape[1] + 1)
                    steps.append(m.decode_step(kv, torch.full_like(ids[:, 0], 7), mask.sum(-1), ids.shape[1],
                                               valid)[0])
            own = torch.Generator().manual_seed(100 + rank)  # each rank's generator its own
            out[tag, name, "rollout"] = {
                "cache_heads": int(kv["k"].shape[2]),
                "decode_diff": float((steps[1] - steps[0]).abs().max()),
                "greedy": generate(split, ids, mask, new, greedy=True)[0].numpy(),
                "sampled": generate(split, ids, mask, new, generator=own)[0].numpy(),
            }
    return out


def main() -> None:
    import torch
    import torch.distributed as dist

    suite, work, rank, world = sys.argv[1], Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(work / "store"), world), rank=rank, world_size=world,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    out = {"parallel": parallel_suite, "cli": cli_suite, "grpo": grpo_suite}[suite](inputs)
    torch.save(out, work / f"out_{rank}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
