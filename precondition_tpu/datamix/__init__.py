"""Bandit-driven data-mixture selection for LM finetuning.

Equivalent of the reference's `datamix_gemma` research app
(`/root/reference/precondition/datamix_gemma/`): a zero-order bandit tunes
dataset mixture weights by finetune-then-evaluate two-point probes, with
exponentiated-gradient updates on the simplex.  Generic over models — the
in-repo flagship transformer stands in for Gemma-2B; the training loop,
batch generators, sampler, and eval harness mirror the reference's
architecture on jit+Mesh SPMD instead of pmap.
"""
