"""Autoregressive sampling for the decoder LMs over a static KV cache.

Counterpart of ``multimodal_embedding_tpu/rl/generate.py:generate``. The JAX
function scans its decode steps inside one compiled program; here the prefill
(``DecoderLM.prefill``, through the attention kernel on the card) is followed
by ``max_new`` decode steps in a Python loop, each step's tokens staying on
the device. The same contract: left-padded prompts, token i written at cache
slot ``Tp + i`` with rope position ``prompt_len + i``, attending over the
valid prompt slots and generated tokens 0..i; the first token's logits from
the last prompt position; exactly ``max_new`` tokens with no stop at EOS.

Greedy decoding takes the first maximum (as ``jnp.argmax``). Sampling draws
from ``generator`` (``torch.multinomial`` over the softmax of
``logits / max(temperature, 1e-6)``), where JAX draws from its key, so
sampled tokens differ between the packages. ``logps`` are the log-softmax of
the unscaled logits at the chosen token, at any temperature.

On a tensor-parallel model (``parallel/tp.py:shard_params_tp``) every rank of
the model axis runs its heads of each step and holds the same logits; the
first rank's tokens are broadcast to the others, so every rank feeds and
returns the same tokens, however its generator was seeded.
"""

from __future__ import annotations

import torch

from ..models.decoder import DecoderLM
from ..parallel.mesh import broadcast_from_first


@torch.no_grad()
def generate(
    model: DecoderLM,
    prompt_ids: torch.Tensor,  # [B, Tp] LEFT-padded
    prompt_mask: torch.Tensor,  # [B, Tp]
    max_new: int,
    *,
    temperature: float = 1.0,
    greedy: bool = False,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, max_new] int32, logps [B, max_new] f32) on the
    model's device."""
    b, tp = prompt_ids.shape
    mesh = getattr(model, "tp_mesh", None)
    group = None if mesh is None else mesh.model_group
    hidden, kv = model.prefill(prompt_ids, prompt_mask, tp + max_new)
    prompt_len = prompt_mask.sum(dim=-1)
    prompt_valid = prompt_mask > 0
    # left padding: the last prompt token sits at index tp-1; its logits
    # predict the first new token
    logits = model.lm_logits(hidden[:, tp - 1 : tp])[:, 0]
    gen_slots = torch.arange(max_new, device=prompt_ids.device)
    toks, logps = [], []
    for i in range(max_new):
        if greedy:
            tok = logits.argmax(dim=-1)
        else:
            probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        tok = broadcast_from_first(tok, group)
        logps.append(torch.log_softmax(logits, dim=-1).gather(-1, tok[:, None])[:, 0])
        toks.append(tok)
        cache_valid = torch.cat([prompt_valid, (gen_slots <= i).expand(b, max_new)], dim=1)
        logits, kv = model.decode_step(kv, tok, prompt_len + i, tp + i, cache_valid)
    return torch.stack(toks, dim=1).to(torch.int32), torch.stack(logps, dim=1).float()
