"""Code-generation eval: generate programs, execute their test suites.

Parity with the reference's `mbpp_eval.py`: sample a program for each
prompt, run it against the task's assert-based tests in a subprocess with a
timeout, and score pass rate.  Execution is sandboxed to a separate python
process (never in-process exec) with a wall-clock limit.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from typing import Callable, List, Optional, Sequence

from precondition_tpu.datamix.evals.eval import Eval
from precondition_tpu.datamix import sampler as sampler_lib


def run_program_with_tests(program: str, tests: Sequence[str],
                           timeout_s: float = 5.0) -> bool:
  """True iff the program + asserts exit cleanly within the timeout."""
  source = program + "\n\n" + "\n".join(tests) + "\n"
  with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
    f.write(source)
    path = f.name
  try:
    # -I (isolated mode) skips site/sitecustomize and ignores PYTHONPATH:
    # generated code must not inherit the host process's import surface
    # (a sitecustomize that initialises a jax plugin at interpreter
    # startup would eat into the timeout budget of every program), and an
    # untrusted program has no business importing the framework either.
    proc = subprocess.run(
        [sys.executable, "-I", path], capture_output=True, timeout=timeout_s)
    return proc.returncode == 0
  except subprocess.TimeoutExpired:
    return False


class CodeExecutionEval(Eval):
  """Pass-rate of generated programs against per-task test asserts."""

  def __init__(
      self,
      make_sampler: Callable[[dict], sampler_lib.Sampler],
      prompts: Sequence[List[int]],
      tests: Sequence[Sequence[str]],
      detokenize: Callable[[List[int]], str],
      max_new_tokens: int = 256,
      batch_size: int = 8,
      timeout_s: float = 5.0,
  ):
    assert len(prompts) == len(tests)
    self.make_sampler = make_sampler
    self.prompts = list(prompts)
    self.tests = list(tests)
    self.detokenize = detokenize
    self.max_new_tokens = max_new_tokens
    self.batch_size = batch_size
    self.timeout_s = timeout_s

  def evaluate(self, params) -> float:
    sampler = self.make_sampler(params)
    passed = 0
    for start in range(0, len(self.prompts), self.batch_size):
      batch = self.prompts[start:start + self.batch_size]
      batch_tests = self.tests[start:start + self.batch_size]
      for tokens, tests in zip(
          sampler.sample(batch, self.max_new_tokens), batch_tests):
        if run_program_with_tests(
            self.detokenize(tokens), tests, self.timeout_s):
          passed += 1
    return passed / max(len(self.prompts), 1)
