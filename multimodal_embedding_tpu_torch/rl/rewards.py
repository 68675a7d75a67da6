"""Reward functions for the GRPO pipeline — reference scoring semantics.

Two judges, matching the reference exactly:
- support-ticket classifier (train_rl_pure_lora.py:14-70): -20 for <think>
  tags, ±5/+2 JSON-format shaping, keyword-routed category correctness
  (+15 / -10 for lazy OTHER), +15 for correct OTHER when no keywords hit.
- fintech credit decision (train_rl_hard.py:15-73): metrics regex-extracted
  from the prompt, target decision from the rule hierarchy (BigTech founder ->
  MANUAL_REVIEW; revenue > $10M with burn > 80% -> REJECT_RISK; NPS >= 80 ->
  A_PLUS_TIER; else STANDARD_LOAN), +30 correct / -15 wrong, with the
  asymmetric special penalties (-20 laziness: STANDARD misjudged as MANUAL;
  -30 disobedience: MANUAL misjudged as REJECT).
"""

from __future__ import annotations

import json
import re

BILLING_KEYWORDS = ["bill", "charge", "refund", "money", "price", "cost", "pay", "card"]
TECHNICAL_KEYWORDS = ["bug", "crash", "error", "login", "screen", "app", "broken", "slow"]
SHIPPING_KEYWORDS = ["package", "delivery", "track", "arrive", "ship", "lost", "where"]


def support_ticket_reward(prompt: str, completion: str) -> float:
    prompt_text = str(prompt).lower()
    response_text = str(completion)
    score = 0.0

    if "<think>" in response_text or "</think>" in response_text:
        score -= 20.0

    clean = response_text.strip()
    if not clean.startswith("{"):
        score -= 5.0
    else:
        score += 2.0
    if "```" in clean:
        score -= 5.0

    try:
        data = json.loads(clean)
        category = data.get("category", "UNKNOWN")
        hit = False
        if any(k in prompt_text for k in BILLING_KEYWORDS):
            if category == "BILLING":
                score += 15.0
                hit = True
            elif category == "OTHER":
                score -= 10.0
        elif any(k in prompt_text for k in TECHNICAL_KEYWORDS):
            if category == "TECHNICAL":
                score += 15.0
                hit = True
            elif category == "OTHER":
                score -= 10.0
        elif any(k in prompt_text for k in SHIPPING_KEYWORDS):
            if category == "SHIPPING":
                score += 15.0
                hit = True
            elif category == "OTHER":
                score -= 10.0
        if not hit and category == "OTHER":
            score += 15.0
    except (json.JSONDecodeError, AttributeError):
        score -= 5.0

    return score


def fintech_target_decision(prompt_text: str) -> str:
    """The reference's rule hierarchy (train_rl_hard.py:44-47 /
    generate_dataset.py:38-58)."""
    revenue = 0
    burn_rate = 0
    nps_score = -100
    m = re.search(r"Annual Revenue: \$([\d,]+)", prompt_text)
    if m:
        revenue = int(m.group(1).replace(",", ""))
    m = re.search(r"Annual Burn Rate: \$([\d,]+)", prompt_text)
    if m:
        burn_rate = int(m.group(1).replace(",", ""))
    m = re.search(r"Customer NPS Score: (-?\d+)", prompt_text)
    if m:
        nps_score = int(m.group(1))
    founder_bigtech = "Ex-Google" in prompt_text or "Ex-Facebook" in prompt_text

    if founder_bigtech:
        return "MANUAL_REVIEW"
    if revenue > 10_000_000 and burn_rate > revenue * 0.8:
        return "REJECT_RISK"
    if nps_score >= 80:
        return "A_PLUS_TIER"
    return "STANDARD_LOAN"


def fintech_reward(prompt: str, completion: str) -> float:
    prompt_text = str(prompt)
    response_text = str(completion)
    score = 0.0

    if "<think>" in response_text:
        score -= 20.0
    if not response_text.strip().startswith("{"):
        score -= 5.0
    else:
        score += 1.0

    target = fintech_target_decision(prompt_text)
    try:
        data = json.loads(response_text.strip())
        decision = data.get("decision", "UNKNOWN")
        if decision == target:
            score += 30.0
        else:
            score -= 15.0
            if target == "STANDARD_LOAN" and decision == "MANUAL_REVIEW":
                score -= 20.0  # laziness penalty
            if target == "MANUAL_REVIEW" and decision == "REJECT_RISK":
                score -= 30.0  # disobedience penalty
    except (json.JSONDecodeError, AttributeError):
        score -= 5.0

    return score
