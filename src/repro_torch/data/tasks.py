"""Synthetic math reasoning task — the offline stand-in for GSM8K /
DeepScaleR: integer arithmetic word problems with a rule-based
extract-and-match reward (paper §6.1)."""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional

from repro_torch.data.tokenizer import Tokenizer

_FILLER = ("carefully ", "step by step ", "using arithmetic ",
           "with full working shown ", "precisely ")


@dataclasses.dataclass
class Problem:
    prompt: str
    answer: int
    uid: int


class ArithmeticTask:
    """Deterministic problem stream. ``prompt_pad`` inflates the prompt with
    redundant instruction text — used to study the long-prompt/short-response
    regime where shared-prompt attention gives its K-fold win (§4.3)."""

    def __init__(self, seed: int = 0, max_operand: int = 99,
                 n_ops: int = 2, prompt_pad: int = 0):
        self.rng = random.Random(seed)
        self.max_operand = max_operand
        self.n_ops = n_ops
        self.prompt_pad = prompt_pad
        self._uid = 0

    def sample(self) -> Problem:
        ops = [self.rng.choice("+-*") for _ in range(self.n_ops)]
        vals = [self.rng.randint(1, self.max_operand)
                for _ in range(self.n_ops + 1)]
        expr = str(vals[0])
        for o, v in zip(ops, vals[1:]):
            if o == "*":
                v = self.rng.randint(2, 9)  # keep magnitudes tame
            expr += o + str(v)
        answer = eval(expr)  # trusted generator-side arithmetic only
        pad = ""
        while len(pad) < self.prompt_pad:
            pad += self.rng.choice(_FILLER)
        prompt = f"Solve {pad}: {expr} = "
        self._uid += 1
        return Problem(prompt=prompt, answer=answer, uid=self._uid)

    def batch(self, n: int) -> List[Problem]:
        return [self.sample() for _ in range(n)]


def extract_answer(text: str) -> Optional[int]:
    """Rule-based extraction: first integer (with optional sign) in the
    response; mirrors the paper's 'accurately extracted and matches' rule."""
    num = ""
    for ch in text:
        if ch == "-" and not num:
            num = "-"
        elif ch.isdigit():
            num += ch
        elif num and num != "-":
            break
        else:
            num = ""
    if num in ("", "-"):
        return None
    try:
        return int(num)
    except ValueError:
        return None
