"""Offline generation-quality evaluator (paper §III-A item 4–5, §III-E).

Extends the AlpacaEval-style auto-annotator to N-way choice: sample 500
recent prompts, generate a response at every directive level, shuffle the
candidates to remove position bias, and ask the auto-eval LLM to name the
best one with a minimal-token reply. The preference-rate vector q feeds the
optimizer's quality constraint (Eq. 5).

The judge is any callable ``judge(request, levels, rng) -> level``; the
default simulates a GPT-4-class judge with the paper's measured 97%
agreement. A real API judge drops in unchanged.

Sample size: 500 prompts => max margin of error 4.4% at 95% confidence
(paper §III-D, ref [32]).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.workload import N_LEVELS, Request


@dataclasses.dataclass
class EvaluationReport:
    q: np.ndarray                 # preference rate per level (sums to 1)
    n_samples: int
    judge_queries: int
    judge_tokens_generated: int   # minimal-token replies (cost control)
    eval_energy_kwh: float        # evaluator-side energy (judge LLM)
    regen_energy_kwh: float       # inference-side regeneration energy
    q_by_task: Optional[dict] = None  # per-task preference rates (smoothed)


class QualityEvaluator:
    """N-way AlpacaEval-style evaluator with shuffling + fixed sample size."""

    def __init__(self, n_levels: int = N_LEVELS, sample_size: int = 500,
                 judge: Optional[Callable] = None, judge_error: float = 0.03,
                 seed: int = 17,
                 judge_energy_kwh_per_query: float = 2000.0 / 3.6e6,
                 regen_energy_fn: Optional[Callable] = None):
        """judge_energy default: paper Fig. 14 estimate — 16 A100s at max
        power (250 W) for the 500 ms API time = 2000 J per query."""
        self.n_levels = n_levels
        self.sample_size = sample_size
        self.judge = judge
        self.judge_error = judge_error
        self.rng = np.random.default_rng(seed)
        self.judge_energy = judge_energy_kwh_per_query
        self.regen_energy_fn = regen_energy_fn

    def evaluate(self, pool: Sequence[Request]) -> EvaluationReport:
        if len(pool) == 0:
            q = np.ones(self.n_levels) / self.n_levels
            return EvaluationReport(q, 0, 0, 0, 0.0, 0.0)
        idx = self.rng.choice(len(pool), size=min(self.sample_size, len(pool)),
                              replace=len(pool) < self.sample_size)
        votes = np.zeros(self.n_levels)
        task_votes: dict = {}
        regen_kwh = 0.0
        tokens = 0
        for i in idx:
            r = pool[int(i)]
            order = self.rng.permutation(self.n_levels)  # position-bias shuffle
            if self.judge is not None:
                pick = self.judge(r, list(order), self.rng)
            else:
                pick = r.judge_pick(self.rng, list(order), self.judge_error)
            votes[pick] += 1
            tv = task_votes.setdefault(r.task, np.zeros(self.n_levels))
            tv[pick] += 1
            tokens += 3  # "Output (k)" — minimal-token reply (Fig. 8)
            if self.regen_energy_fn is not None:
                regen_kwh += sum(self.regen_energy_fn(r, l)
                                 for l in range(self.n_levels))
        q = votes / votes.sum()
        # per-task rates, smoothed toward the aggregate (small task samples)
        q_by_task = {t: (v + 5.0 * q) / (v.sum() + 5.0)
                     for t, v in task_votes.items()}
        return EvaluationReport(q, len(idx), len(idx), tokens,
                                float(len(idx)) * self.judge_energy, regen_kwh,
                                q_by_task)
