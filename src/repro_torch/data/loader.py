"""Prompt data loader: batches of tokenized prompts for the RL pipeline.

This is the 'data source' box of the paper's Figure 1: it only hands
prompt batches to the temporary data generator; everything downstream
(inference dispatch, rewards, queueing) lives in repro.core."""
from __future__ import annotations

from typing import Iterator, List

import numpy as np

from repro_torch.data.tasks import ArithmeticTask, Problem
from repro_torch.data.tokenizer import Tokenizer


class PromptLoader:
    def __init__(self, task: ArithmeticTask, tokenizer: Tokenizer,
                 batch_size: int, max_prompt_len: int):
        self.task = task
        self.tok = tokenizer
        self.batch_size = batch_size
        self.max_prompt_len = max_prompt_len

    def encode_prompt(self, p: Problem) -> np.ndarray:
        ids = self.tok.encode(p.prompt)[: self.max_prompt_len]
        return np.asarray(ids, np.int32)

    def batches(self, num_batches: int) -> Iterator[List[tuple]]:
        """Yields lists of (problem, prompt_ids)."""
        for _ in range(num_batches):
            probs = self.task.batch(self.batch_size)
            yield [(p, self.encode_prompt(p)) for p in probs]
