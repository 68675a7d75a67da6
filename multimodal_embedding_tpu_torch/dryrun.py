"""One step of every parallel path over a world of ranks, on tiny shapes.

Counterpart of ``__graft_entry__.dryrun_multichip``. The JAX function runs
one controller over ``n`` virtual devices; here :func:`dryrun_multichip`
starts ``n`` processes, one gloo rank each (on the card unless
``device="cpu"``; ranks share a card where there are fewer cards than
ranks), which run the same sequence on the same tiny configs:

- the data-sharded dense step on a data mesh of ``n``: the debug CLIP's
  preprocess and image and text encode over each rank's rows, the score
  matrices and four bootstrap iterations;
- the ColPali step: per-token encode over each rank's rows, MaxSim scores;
- the tensor-parallel encode on a ``(n // 2, 2)`` mesh (``(n, 1)`` for odd
  ``n``, as JAX);
- sequence-parallel attention over the model axis, then ColPali with its
  tokens sharded over it, held to the scores above within 5e-5 (JAX's check);
- one GRPO step (``loss_and_grads`` then AdamW) of a Gemma and of a Qwen3
  decoder on that mesh: the base split over ``model``, the completion group
  over ``data``, the adapters and optimizer state on every rank.

Rank 0's results are printed as the JAX function's summary line. A rank that
fails fails the run, with its output. Also runnable as

    python -m multimodal_embedding_tpu_torch.dryrun --ranks 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
from datetime import timedelta
from pathlib import Path

RANK_TIMEOUT_S = 600
COLLECTIVE_TIMEOUT_S = 120
SP_SCORES_TOL = 5e-5
# the JAX function's decoders: GemmaConfig(vocab 256, dim 32, layers 2,
# heads 4, kv_heads 2, head_dim 8, mlp 64), and a Qwen3 of the same widths
DECODER = dict(vocab_size=256, dim=32, layers=2, heads=4, kv_heads=2, head_dim=8, mlp_dim=64)
_RANK_MAIN = "import sys; from multimodal_embedding_tpu_torch.dryrun import run_rank; run_rank(*sys.argv[1:])"


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> dict:
    """Run the sequence on ``n_ranks`` gloo ranks and print rank 0's summary
    line; returns rank 0's results (the line, the two GRPO losses, its
    device and its kernel launches: attention, preprocess and MaxSim, the
    f32 bodies under their own names). Raises where a rank fails or outlasts
    ``RANK_TIMEOUT_S``; a CUDA ``device`` without a card raises too (no
    fall-back to the CPU)."""
    import torch

    if device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass device='cpu' to run on the CPU")
    root = str(Path(__file__).resolve().parents[1])
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([root, *filter(None, [env.get("PYTHONPATH")])])
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    work = Path(tempfile.mkdtemp(prefix="dryrun_multichip_"))
    try:
        procs = []
        for rank in range(n_ranks):
            log = open(work / f"rank{rank}.log", "w")
            procs.append((subprocess.Popen([sys.executable, "-c", _RANK_MAIN, str(work), str(rank), str(n_ranks),
                                            device], env=env, stdout=log, stderr=subprocess.STDOUT), log))
        failed = []
        for rank, (proc, log) in enumerate(procs):
            try:
                rc = proc.wait(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                for other, _ in procs:  # the others would wait on it in a collective
                    other.kill()
                    other.wait()
            log.close()
            if rc != 0:
                failed.append(f"rank {rank} ({rc}):\n{(work / f'rank{rank}.log').read_text()[-4000:]}")
        if failed:
            raise RuntimeError(f"dryrun_multichip({n_ranks}) failed:\n" + "\n".join(failed))
        out = json.loads((work / "result.json").read_text())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(out["line"])
    return out


def run_rank(work: str, rank: str, n_ranks: str, device: str) -> None:
    """One rank, started by :func:`dryrun_multichip`: joins the gloo world
    through a file store in ``work``; rank 0 writes ``result.json``."""
    import torch
    import torch.distributed as dist

    rank, n = int(rank), int(n_ranks)
    if device == "cpu":
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(work) / "store"), n), rank=rank, world_size=n,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        out = _sequence(n, dev)
        if rank == 0:
            (Path(work) / "result.json").write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _grpo_step(module, seed: int, mesh, batch, dev) -> float:
    """One GRPO step of a decoder drawn from ``seed`` on ``mesh``: the
    reference pass on this data rank's rows, ``loss_and_grads``, AdamW."""
    import torch

    from .parallel.mesh import gather_rows, shard_rows
    from .rl.grpo import GRPOConfig, GRPOTrainer, _completion_logps, completion_token_mask
    from .rl.rewards import support_ticket_reward

    base = module(gen=torch.Generator(device=dev).manual_seed(seed), device=dev, dtype=torch.float32)
    trainer = GRPOTrainer(base, support_ticket_reward, GRPOConfig(), mesh=mesh)
    p_ids, p_mask, comps, adv = batch
    comp_mask = completion_token_mask(comps)
    with torch.no_grad():
        ref = gather_rows(_completion_logps(trainer.base, *(shard_rows(x, mesh) for x in (p_ids, p_mask, comps))),
                          mesh)
    (loss, _), grads = trainer.loss_and_grads(trainer.adapters, p_ids, p_mask, comps, comp_mask, adv, ref)
    trainer._update(grads)
    loss = float(loss)
    if not math.isfinite(loss):
        raise RuntimeError(f"GRPO step loss {loss}")
    return loss


def _sequence(n: int, dev) -> dict:
    import functools

    import numpy as np
    import torch

    from . import runtime
    from .models.gemma import Gemma, GemmaConfig
    from .models.layers import l2_normalize
    from .models.qwen3 import Qwen3, Qwen3Config
    from .models.registry import model_info
    from .models.towers import DualEncoder
    from .models.zoo import debug_dual_config, debug_preprocess, hash_tokenizer, load_debug_model
    from .ops.preprocess_cuda import make_preprocess_cuda_fn
    from .parallel.batched import sharded_batch_apply
    from .parallel.mesh import get_mesh, share_from_rank0
    from .parallel.sp import gather_tokens, shard_tokens, sp_attention
    from .parallel.tp import shard_params_tp
    from .retrieval.scoring import dense_scores, late_interaction_scores
    from .stats.bootstrap import bootstrap_benchmark

    mesh = get_mesh(n_data=n)
    cfg = debug_dual_config("dense")
    tokenize = hash_tokenizer(cfg.text.vocab_size, cfg.text.max_len, cfg.text.eos_token_id)
    n_img, h, w = 2 * n, 96, 128  # tiny: 2 images a rank
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (n_img, 3, h, w), dtype=np.uint8)).to(dev)
    # token ids are rank 0's (the hash tokenizer is salted per process)
    ids_t2i = share_from_rank0(tokenize([f"caption {i}" for i in range(n_img)])[0], dev)
    ids_all = share_from_rank0(tokenize([f"caption {i} variant {j}" for i in range(n_img) for j in range(5)])[0], dev)
    pre = make_preprocess_cuda_fn(debug_preprocess(cfg), h, w, device=dev)

    def encode(model, mesh):
        img = sharded_batch_apply(lambda x: model.encode_image(pre(x)), images, mesh=mesh, batch_size=n_img)
        txt = sharded_batch_apply(model.encode_text, ids_t2i, mesh=mesh, batch_size=n_img)
        txt_all = sharded_batch_apply(model.encode_text, ids_all, mesh=mesh, batch_size=5 * n_img)
        return l2_normalize(img), l2_normalize(txt), l2_normalize(txt_all)

    with torch.inference_mode():
        img, txt, txt_all = encode(DualEncoder(cfg, seed=0, device=dev), mesh)
        s_t2i, s_i2t = dense_scores(txt, img, mesh=mesh), dense_scores(img, txt_all, mesh=mesh)
        boot = bootstrap_benchmark(s_t2i, s_i2t, 4, seed=0, mesh=mesh)
    if np.shape(boot.metrics["T2I_R@1"]) != (4,) or s_t2i.shape != (n_img, n_img) or s_i2t.shape != (n_img, 5 * n_img):
        raise RuntimeError(f"dense step shapes {tuple(s_t2i.shape)}, {tuple(s_i2t.shape)}")

    # the multi-vector (ColPali) step: per-token encode over each rank's rows, MaxSim
    cp = load_debug_model(model_info("ColPali-v1.3"), seed=0, device=dev)
    hc = cp.preprocess.image_size
    cp_images = torch.from_numpy(rng.integers(0, 256, (n_img, 3, hc, hc), dtype=np.uint8)).to(dev)
    cp_ids, cp_mask = cp.tokenize([f"query {i}" for i in range(n_img)])
    cp_ids, cp_mask = share_from_rank0(cp_ids, dev), share_from_rank0(cp_mask, dev)
    cp_pre = make_preprocess_cuda_fn(cp.preprocess, hc, hc, device=dev)

    def cp_step(mesh):
        img_mv = sharded_batch_apply(lambda x: cp.model.image_fwd(cp_pre(x)), cp_images, mesh=mesh, batch_size=n_img)
        txt_mv = sharded_batch_apply(cp.model.text_fwd, (cp_ids, cp_mask), mesh=mesh, batch_size=n_img)
        return late_interaction_scores(txt_mv, img_mv, cp_mask, mesh=mesh)

    with torch.inference_mode():
        s_mv = cp_step(mesh)
    if s_mv.shape != (n_img, n_img):
        raise RuntimeError(f"maxsim shape {tuple(s_mv.shape)}")

    # tensor parallelism on a (data, model) mesh: Megatron splits of the weights
    n_model = 2 if n % 2 == 0 else 1
    tp_mesh = get_mesh(n_data=n // n_model, n_model=n_model)
    with runtime.using(tp=tp_mesh), torch.inference_mode():
        tp_img, tp_txt, _ = encode(shard_params_tp(DualEncoder(cfg, seed=0, device=dev), tp_mesh), tp_mesh)
    if tp_img.shape[0] != n_img or tp_txt.shape[0] != n_img:
        raise RuntimeError(f"tp encode shapes {tuple(tp_img.shape)}, {tuple(tp_txt.shape)}")

    # sequence parallelism: the tokens sharded over the model axis, K and V gathered
    if n_model > 1:
        bq, hq, tq, dq = 2, 4, 8 * n_model, 16
        gen = torch.Generator(device=dev).manual_seed(3)
        q, k, v = (torch.randn(bq, hq, tq, dq, generator=gen, device=dev) for _ in range(3))
        with torch.inference_mode():
            local = sp_attention(*(shard_tokens(x, tp_mesh, dim=2) for x in (q, k, v)), tp_mesh, causal=True)
            sp_out = gather_tokens(local, tp_mesh, dim=2)
        if sp_out.shape != (bq, hq, tq, dq):
            raise RuntimeError(f"sp attention shape {tuple(sp_out.shape)}")
        # ColPali's Gemma with its tokens sharded over the model axis
        with runtime.using(sp=tp_mesh), torch.inference_mode():
            s_mv_sp = cp_step(tp_mesh)
        diff = float((s_mv_sp - s_mv).abs().max())
        if not diff <= SP_SCORES_TOL * max(1.0, float(s_mv.abs().max())):
            raise RuntimeError(f"ColPali scores under sequence parallelism differ by {diff}")

    # Workload B: one GRPO step of each decoder on the same (data, model) mesh,
    # the completion group (2 rows a data rank) sharded over "data"
    g, tp_, tn = 2 * tp_mesh.n_data, 6, 5
    batch = (torch.from_numpy(rng.integers(3, 250, (g, tp_))).to(dev, torch.int32),
             torch.ones((g, tp_), dtype=torch.int32, device=dev),
             torch.from_numpy(rng.integers(3, 250, (g, tn))).to(dev, torch.int32),
             torch.from_numpy(rng.normal(size=(g,)).astype(np.float32)).to(dev))
    loss = _grpo_step(functools.partial(Gemma, GemmaConfig(**DECODER)), 1, tp_mesh, batch, dev)
    q_loss = _grpo_step(functools.partial(Qwen3, Qwen3Config(**DECODER, tie_embeddings=False)), 3, tp_mesh, batch,
                        dev)
    line = (f"dryrun_multichip({n}): mesh={mesh.shape}, scores {tuple(s_t2i.shape)}/{tuple(s_i2t.shape)}, "
            f"maxsim {tuple(s_mv.shape)}, bootstrap ok, tp mesh={tp_mesh.shape} encode ok, sp attention ok, "
            f"grpo train step loss={loss:.4f} ok, qwen3 grpo train step loss={q_loss:.4f} ok")
    from .ops import launch_counts

    counts = launch_counts()  # this rank's, over the whole sequence
    launches = {k: counts[k] for k in ("fused_attention", "fused_attention_f32", "preprocess", "maxsim",
                                       "maxsim_f32")}
    return {"line": line, "loss": loss, "qwen3_loss": q_loss, "device": str(dev), "launches": launches}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, required=True, help="gloo ranks to start (processes)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the card (ranks share it where cards are fewer); cpu: the CPU")
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
