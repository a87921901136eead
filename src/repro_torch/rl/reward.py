"""Rule-based reward (paper §6.1): the predicted answer is correct iff it can
be accurately extracted and matches the ground truth; otherwise 0.

Reward evaluation runs inside the producer's worker threads — each rollout is
scored independently and enqueued with its reward (Figure 1), decoupling
reward computation from both inference and training."""
from __future__ import annotations

from repro_torch.data.tasks import extract_answer
from repro_torch.data.tokenizer import Tokenizer


class RuleBasedReward:
    def __init__(self, tokenizer: Tokenizer):
        self.tok = tokenizer

    def __call__(self, response_ids, answer: int) -> float:
        text = self.tok.decode(response_ids)
        pred = extract_answer(text)
        return 1.0 if pred is not None and pred == int(answer) else 0.0
