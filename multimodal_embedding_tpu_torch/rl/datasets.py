"""Synthetic RL datasets (reference generate_dataset.py / prepare_data.py /
dataset.json).

- fintech: 600 startup loan applications with ground-truth decisions derived
  by the exact rule hierarchy (generate_dataset.py:38-58).
- support tickets: dataset.json-style customer messages across
  BILLING/TECHNICAL/SHIPPING/OTHER, phrased with the reward keywords.

Both emit chat-format records {'prompt': str, 'answer': str} (prepare_data.py
wraps into TRL chat format; our GRPO loop consumes the prompt string
directly).
"""

from __future__ import annotations

import numpy as np

from .rewards import fintech_target_decision

FINTECH_SYSTEM = (
    "You are a credit analyst. Respond ONLY with a JSON object "
    '{"decision": "..."} using one of STANDARD_LOAN, MANUAL_REVIEW, '
    "REJECT_RISK, A_PLUS_TIER."
)
SUPPORT_SYSTEM = (
    "You are a support-ticket router. Respond ONLY with a JSON object "
    '{"category": "..."} using one of BILLING, TECHNICAL, SHIPPING, OTHER.'
)

_FOUNDERS = ["Ex-Google", "Ex-Facebook", "University Dropout", "Serial Entrepreneur", "First-time Founder"]

_TICKET_TEMPLATES = {
    "BILLING": [
        "I was charged twice on my card, I want a refund",
        "why did the price go up, the cost is too high for my bill",
        "I need my money back, the charge was wrong",
    ],
    "TECHNICAL": [
        "the app keeps crashing with an error on the login screen",
        "there is a bug, everything is broken and slow",
        "I get an error when I login, the screen goes blank",
    ],
    "SHIPPING": [
        "where is my package, the delivery never arrived",
        "my order is lost, the tracking says it did not ship",
        "can you track my package, it should arrive today",
    ],
    "OTHER": [
        "I love your product, just wanted to say thanks",
        "do you have a partnership program for creators",
        "what are your office opening hours",
    ],
}


def generate_fintech_dataset(n: int = 600, seed: int = 42) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        revenue = int(rng.integers(100_000, 50_000_000))
        burn = int(rng.integers(50_000, int(revenue * 1.5)))
        nps = int(rng.integers(-50, 101))
        founder = _FOUNDERS[int(rng.integers(len(_FOUNDERS)))]
        prompt = (
            f"{FINTECH_SYSTEM}\n\nApplication #{i}:\n"
            f"    Annual Revenue: ${revenue:,}\n"
            f"    Annual Burn Rate: ${burn:,}\n"
            f"    Founder Background: {founder}\n"
            f"    Customer NPS Score: {nps}\n"
        )
        out.append({"prompt": prompt, "answer": fintech_target_decision(prompt)})
    return out


def generate_support_tickets(n: int = 50, seed: int = 42) -> list[dict]:
    rng = np.random.default_rng(seed)
    cats = list(_TICKET_TEMPLATES)
    out = []
    for i in range(n):
        cat = cats[int(rng.integers(len(cats)))]
        msg = _TICKET_TEMPLATES[cat][int(rng.integers(len(_TICKET_TEMPLATES[cat])))]
        out.append(
            {"prompt": f"{SUPPORT_SYSTEM}\n\nTicket #{i}: {msg}", "answer": cat}
        )
    return out
