"""GRPO trainer: group-relative policy optimization with LoRA adapters, on one
NVIDIA GPU.

Counterpart of ``multimodal_embedding_tpu/rl/grpo.py`` (``GRPOConfig`` :40,
``_completion_logps`` :53, ``completion_token_mask`` :86, ``GRPOTrainer``
:93), the reference's TRL ``GRPOTrainer`` setup (train_rl_pure_lora.py:
108-138). Per prompt: sample a group of G completions from the merged
policy (``rl/generate.py``), normalize the rewards within the group to
advantages, take the completions' teacher-forced log-probs under the frozen
base (the reference policy) and under the base with the adapters applied
(``rl/lora.py:apply_lora``), and the gradient of the policy-gradient loss
plus TRL's k3 KL to the base with respect to the adapters only. Gradients
are summed over ``grad_accum`` prompts, divided, and applied by AdamW with
optax's ``adamw(lr)`` numbers (:data:`ADAMW`).

What differs from the JAX trainer: the adapters' init and the rollouts draw
from ``torch.Generator``s (seeds ``cfg.seed`` and ``cfg.seed + 1``) where
JAX draws from its keys, so a training run matches JAX in behaviour, not in
digits; the policy is a ``DecoderLM`` module, which carries its config and
architecture. On the card every forward's attention is the fused kernel
(``ops/attention_cuda.py``), whose backward recomputes through its plain
version, as the JAX kernel's ``custom_vjp`` does. ``save_state`` and
``load_state`` read and write the JAX trainer's file, so a run resumes
across the packages.

With ``mesh`` (a ``(data, model)`` mesh of ``parallel/mesh.py:get_mesh``)
the trainer runs as the JAX trainer on ``shard_params_tp(base, mesh)`` with
its batch sharded over ``data``: the base is split over the model axis
(``parallel/tp.py``); every rank draws the same adapters and the rollout
runs on each model group, world rank 0's completions broadcast to all; the
reference pass and the loss take this data rank's rows; the loss divides by
``Σ comp_mask`` over the data axis, and ``loss``, ``pg`` and ``kl`` are
summed over it, so each is the global value JAX reports. Each adapter's
gradient is summed over the model axis where its layer's attention is split
(each rank's part: its slice of ``b`` or ``a``, or its query heads' share of
a KV head it keeps with others), counted once where the attention stayed
whole, then summed over the data axis; AdamW then takes the same step on
every rank, and the adapters stay bit-equal across ranks.
"""

from __future__ import annotations

import json
import logging
import re
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from . import tokenizer as tok
from .generate import generate
from .lora import LoraConfig, apply_lora, lora_init, lora_merge
from ..models.decoder import DecoderLM
from ..models.towers import seeded_generator
from ..parallel.mesh import Mesh, all_reduce_sum, gather_rows, is_writer, share_from_rank0, shard_rows
from ..parallel.tp import shard_params_tp

logger = logging.getLogger("mme_tpu")

# optax.adamw(lr)'s other numbers (JAX rl/grpo.py:114): torch.optim.AdamW's
# own default weight decay is 1e-2
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


@dataclass
class GRPOConfig:
    learning_rate: float = 1e-5
    group_size: int = 8  # num_generations (reference :115)
    epochs: int = 5
    grad_accum: int = 4
    max_prompt_len: int = 256
    max_new_tokens: int = 48
    temperature: float = 1.0
    kl_beta: float = 0.04
    lora: LoraConfig = field(default_factory=LoraConfig)
    seed: int = 42


def _completion_logps(model: DecoderLM, prompt_ids, prompt_mask, completions, weights=None) -> torch.Tensor:
    """Teacher-forcing log-probs of completion tokens.

    prompt_ids [B, Tp] left-padded; completions [B, Tn]. ``weights`` (from
    ``apply_lora``) take the place of the model's own in its forward.
    Returns logps [B, Tn] (f32)."""
    b, tp = prompt_ids.shape
    tn = completions.shape[1]
    full = torch.cat([prompt_ids, completions.to(prompt_ids.dtype)], dim=1)
    mask = torch.cat([prompt_mask, prompt_mask.new_ones((b, tn))], dim=1)
    args = (model.embed_tokens(full), mask, True)
    hidden = model(*args) if weights is None else torch.func.functional_call(model, weights, args)
    # logits at index tp-1+i predict completion[i]
    logits = model.lm_logits(hidden[:, tp - 1 : tp + tn - 1])
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, completions[:, :, None].long())[:, :, 0]


def _parses_as_json(text: str) -> bool:
    """Lenient: does the completion contain a parseable JSON object? Mirrors
    the reward functions' extraction (strip, else first {...} span) so the
    telemetry tracks the same format chasm the rewards gate on."""
    for cand in (text.strip(), *re.findall(r"\{.*?\}", text, re.DOTALL)[:1]):
        try:
            if isinstance(json.loads(cand), dict):
                return True
        except (json.JSONDecodeError, ValueError):
            continue
    return False


def completion_token_mask(completions: torch.Tensor, eos_id: int = tok.EOS_ID) -> torch.Tensor:
    """1.0 for tokens up to and including the first EOS, 0 after."""
    is_eos = (completions == eos_id).to(torch.int32)
    after = torch.cumsum(is_eos, dim=1) - is_eos
    return (after == 0).float()


def _leaf_order(adapters: dict) -> list[tuple[str, str]]:
    """(target, part) in optax's leaf order: targets sorted, then a, b."""
    return [(name, part) for name in sorted(adapters) for part in ("a", "b")]


class GRPOTrainer:
    def __init__(
        self,
        base: DecoderLM,
        reward_fn: Callable[[str, str], float],
        cfg: GRPOConfig | None = None,
        tokenizer=None,
        system_prompt: str | None = None,
        mesh: Mesh | None = None,
    ):
        self.mesh = mesh
        self.base = base if mesh is None else shard_params_tp(base, mesh)
        self.reward_fn = reward_fn
        self.cfg = cfg or GRPOConfig()
        self.tokenizer = tokenizer or tok.ByteTokenizer()
        self.system_prompt = system_prompt
        self.adapters = lora_init(base, self.cfg.lora, generator=seeded_generator(self.cfg.seed, base.device))
        self._params = [self.adapters[n][p].requires_grad_() for n, p in _leaf_order(self.adapters)]
        self.opt = torch.optim.AdamW(self._params, lr=self.cfg.learning_rate, **ADAMW)
        self._gen = seeded_generator(self.cfg.seed + 1, base.device)

    def loss_and_grads(self, adapters, prompt_ids, prompt_mask, completions, comp_mask, advantages, ref_logps):
        """The JAX trainer's ``_grad_fn``: ``((loss, (pg, kl)), grads)``, the
        gradient with respect to ``adapters`` (a tree of tensors on the base's
        device) only, as a tree of the same shape. The batch is the whole
        group on every rank; on a mesh each data rank takes its rows, and the
        results are the whole group's on every rank."""
        mesh = self.mesh
        prompt_ids, prompt_mask, completions, comp_mask, advantages, ref_logps = (
            shard_rows(x, mesh) for x in (prompt_ids, prompt_mask, completions, comp_mask, advantages, ref_logps))
        leaves = {n: {p: x.detach().requires_grad_() for p, x in ab.items()} for n, ab in adapters.items()}
        order = _leaf_order(leaves)
        with torch.enable_grad():
            weights = apply_lora(self.base, leaves, self.cfg.lora)
            logps = _completion_logps(self.base, prompt_ids, prompt_mask, completions, weights)
            denom = comp_mask.sum()
            if mesh is not None:
                denom = all_reduce_sum(denom.detach().clone(), mesh.data_group)
            denom = torch.clamp(denom, min=1.0)
            pg = -(advantages[:, None] * logps * comp_mask).sum() / denom
            # TRL k3 KL estimator vs the frozen base policy
            diff = ref_logps - logps
            kl = ((torch.exp(diff) - diff - 1.0) * comp_mask).sum() / denom
            loss = pg + self.cfg.kl_beta * kl
            grads = torch.autograd.grad(loss, [leaves[n][p] for n, p in order])
        terms = (loss.detach(), pg.detach(), kl.detach())
        if mesh is not None:
            grads = self._reduce_grads(grads)
            terms = tuple(all_reduce_sum(torch.stack(terms), mesh.data_group))
        tree: dict = {n: {} for n in leaves}
        for (n, p), g in zip(order, grads):
            tree[n][p] = g
        return (terms[0], (terms[1], terms[2])), tree

    def _reduce_grads(self, grads) -> list[torch.Tensor]:
        """Each rank's adapter gradients ([L, ...] each) -> the whole
        batch's, the same on every rank: summed over the model axis where a
        layer's attention is split, kept from the model axis's first rank
        where it stayed whole (every rank holds all of it), then summed over
        the data axis; in one collective an axis."""
        mesh = self.mesh
        grads = list(grads)
        if mesh.model_group is not None and mesh.model_rank > 0:
            whole = torch.tensor([layer.attn_split is None for layer in self.base.layers], device=grads[0].device)
            grads = [torch.where(whole.view(-1, *[1] * (g.dim() - 1)), 0.0, g) for g in grads]
        flat = torch.cat([g.reshape(-1) for g in grads])
        for group in (mesh.model_group, mesh.data_group):
            all_reduce_sum(flat, group)
        return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]

    def _update(self, grads) -> None:
        for (n, p), param in zip(_leaf_order(self.adapters), self._params):
            param.grad = grads[n][p]
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)

    def policy(self) -> DecoderLM:
        """The merged policy the rollouts sample from."""
        return lora_merge(self.base, self.adapters, self.cfg.lora)

    # --- checkpoint / resume -------------------------------------------------

    def save_state(self, path) -> None:
        """Adapters and optimizer moments in the JAX trainer's layout:
        ``adapters/<target>/<a|b>``; ``opt/<i>`` in optax's leaf order
        (``opt/0`` the int32 step count, then ``mu`` and ``nu`` of each
        adapter in :func:`_leaf_order`). On a mesh, world rank 0 writes."""
        if not is_writer():
            return
        flat = {f"adapters/{n}/{p}": self.adapters[n][p].detach().cpu().numpy() for n, p in _leaf_order(self.adapters)}
        states = [self.opt.state.get(param, {}) for param in self._params]
        flat["opt/0"] = np.asarray(int(states[0]["step"]) if states[0] else 0, np.int32)
        for i, (param, st) in enumerate(zip(self._params, states)):
            for j, key in enumerate(("exp_avg", "exp_avg_sq")):
                moment = st[key] if st else torch.zeros_like(param)
                flat[f"opt/{1 + j * len(self._params) + i}"] = moment.detach().cpu().numpy()
        np.savez(path, **flat)

    def load_state(self, path) -> None:
        """The reverse of :meth:`save_state`, from either package's file."""
        n = len(self._params)
        with np.load(path) as data, torch.no_grad():
            step = torch.tensor(float(data["opt/0"]), dtype=torch.float32)
            for i, ((name, part), param) in enumerate(zip(_leaf_order(self.adapters), self._params)):
                param.copy_(torch.from_numpy(data[f"adapters/{name}/{part}"]))
                self.opt.state[param] = {
                    "step": step.clone(),
                    "exp_avg": torch.from_numpy(data[f"opt/{1 + i}"]).to(param.device),
                    "exp_avg_sq": torch.from_numpy(data[f"opt/{1 + n + i}"]).to(param.device),
                }

    def rollout(self, prompt: str):
        """Sample a group of completions for one prompt; returns
        (prompt_ids, prompt_mask, completions, texts, rewards), numpy."""
        g = self.cfg.group_size
        tk = self.tokenizer
        formatted = tk.format_prompt(prompt, self.system_prompt)
        ids = tk.encode(formatted, self.cfg.max_prompt_len)
        # the JAX trainer's bucket: the padded prompt length to a multiple of
        # 32 (left-padding further is semantics-free: mask-driven positions)
        bucket = min(self.cfg.max_prompt_len, -(-len(ids) // 32) * 32)
        prompt_ids, prompt_mask = tk.pad_left([ids] * g, max_len=bucket)
        dev = self.base.device
        completions, _ = generate(
            self.policy(),
            torch.from_numpy(prompt_ids).to(dev),
            torch.from_numpy(prompt_mask).to(dev),
            self.cfg.max_new_tokens,
            temperature=self.cfg.temperature,
            generator=self._gen,
        )
        completions = completions.cpu().numpy()
        if self.mesh is not None:  # one group for every rank: world rank 0's
            completions = share_from_rank0(completions, "cpu").numpy()
        texts = [tk.decode_until_eos(c) for c in completions]
        rewards = np.asarray([self.reward_fn(prompt, t) for t in texts], np.float32)
        return prompt_ids, prompt_mask, completions, texts, rewards

    def train(self, dataset: list[dict], log_every: int = 8) -> dict:
        """dataset: [{'prompt': str, ...}]. Returns training stats."""
        cfg = self.cfg
        dev = self.base.device
        stats = {"mean_reward": [], "loss": [], "kl": [],
                 "parse_rate": [], "adv_std": []}
        step_grads = None
        n_accum = 0
        for epoch in range(cfg.epochs):
            order = np.random.default_rng(cfg.seed + epoch).permutation(len(dataset))
            for si, di in enumerate(order):
                prompt = dataset[int(di)]["prompt"]
                p_ids, p_mask, comps, texts, rewards = self.rollout(prompt)
                adv = (rewards - rewards.mean()) / (rewards.std() + 1e-4)
                # learning-health telemetry: a flat reward with parse_rate ~0
                # means rollouts never cross the JSON format chasm; adv_std ~0
                # means the group carries no learning signal
                parse_rate = float(np.mean([_parses_as_json(t) for t in texts]))
                adv_std = float(rewards.std())
                p_ids, p_mask, comps = (torch.from_numpy(x).to(dev) for x in (p_ids, p_mask, comps))
                comp_mask = completion_token_mask(comps, self.tokenizer.eos_id)
                with torch.no_grad():
                    rows = (shard_rows(x, self.mesh) for x in (p_ids, p_mask, comps))
                    ref_logps = gather_rows(_completion_logps(self.base, *rows), self.mesh)
                (loss, (pg, kl)), grads = self.loss_and_grads(
                    self.adapters, p_ids, p_mask, comps, comp_mask, torch.from_numpy(adv).to(dev), ref_logps,
                )
                if step_grads is None:
                    step_grads = grads
                else:
                    step_grads = {n: {p: step_grads[n][p] + g for p, g in ab.items()} for n, ab in grads.items()}
                n_accum += 1
                if n_accum == cfg.grad_accum:
                    self._update({n: {p: g / cfg.grad_accum for p, g in ab.items()} for n, ab in step_grads.items()})
                    step_grads, n_accum = None, 0

                stats["mean_reward"].append(float(rewards.mean()))
                stats["loss"].append(float(loss))
                stats["kl"].append(float(kl))
                stats["parse_rate"].append(parse_rate)
                stats["adv_std"].append(adv_std)
                if si % log_every == 0:
                    logger.info(
                        f"epoch {epoch} step {si}: reward {rewards.mean():.2f} "
                        f"loss {float(loss):.4f} kl {float(kl):.5f} "
                        f"parse {parse_rate:.2f} adv_std {adv_std:.2f}"
                    )
        return stats
