"""Few-shot multiple-choice eval by likelihood comparison (MMLU-style).

Parity with the reference's `mmlu_eval.py` approach: for each question,
score every choice continuation by its total log-probability under the
model and pick the argmax — no sampling, a single batched forward per
choice set, which is the matmul-friendly way to run multiple choice.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from precondition_tpu.datamix.evals.eval import Eval
from precondition_tpu.models import transformer


class MultipleChoiceEval(Eval):
  """Accuracy of argmax-logprob choice selection."""

  def __init__(
      self,
      cfg: transformer.TransformerConfig,
      questions: Sequence[List[int]],       # tokenized question prompts
      choices: Sequence[Sequence[List[int]]],  # per-question choice tokens
      correct: Sequence[int],               # gold choice indices
      pad_id: int = 0,
  ):
    assert len(questions) == len(choices) == len(correct)
    self.cfg = cfg
    self.questions = questions
    self.choices = choices
    self.correct = list(correct)
    self.pad_id = pad_id

    @jax.jit
    def choice_logprob(params, tokens, mask):
      logits = transformer.forward(params, tokens[:, :-1], cfg)
      logp = jax.nn.log_softmax(logits, axis=-1)
      tgt = tokens[:, 1:]
      scores = jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
      return jnp.sum(scores * mask[:, 1:], axis=-1)

    self._choice_logprob = choice_logprob

  def evaluate(self, params) -> float:
    hits = 0
    for question, choice_set, gold in zip(
        self.questions, self.choices, self.correct):
      max_len = max(len(question) + len(c) for c in choice_set)
      max_len = min(max_len, self.cfg.max_seq_len)
      tokens = np.full((len(choice_set), max_len), self.pad_id, np.int32)
      mask = np.zeros((len(choice_set), max_len), np.float32)
      for i, choice in enumerate(choice_set):
        seq = (question + choice)[:max_len]
        tokens[i, :len(seq)] = seq
        mask[i, len(question):len(seq)] = 1.0
      scores = self._choice_logprob(
          params, jnp.asarray(tokens), jnp.asarray(mask))
      if int(np.argmax(np.asarray(scores))) == gold:
        hits += 1
    return hits / max(len(self.questions), 1)
