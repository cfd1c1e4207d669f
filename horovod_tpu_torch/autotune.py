"""Autotuning of the fusion threshold (ParameterManager analog).

Copy of ``horovod_tpu/autotune.py`` (the port keeps its own copy).  The
port's ``core.init`` makes the manager as the JAX package's does
(``horovod_tpu/core.py:197-270``), rank 0's decision and bayes
candidates travel over the world's c10d store, and
``DistributedOptimizer`` scores its bucket reductions; the knob it tunes
is the port's fusion planner's threshold (``optimizer._allreduce_list``).

Reference: horovod/common/parameter_manager.h:42-110 — with
``HOROVOD_AUTOTUNE=1`` the ParameterManager explores tunables (fusion buffer
threshold, cycle time, response cache on/off, hierarchical ops) during
warm-up, scoring each sample by observed bytes/sec, converges, then freezes;
rank 0 tunes and broadcasts (``SynchronizeParameters``); samples optionally
logged to ``HOROVOD_AUTOTUNE_LOG``.  The reference's search is Bayesian
optimization (Gaussian process + expected improvement,
optim/bayesian_optimization.cc).

The search: a categorical sweep (each candidate for
``samples_per_candidate`` scored windows, then the argmax is locked) or
``search="bayes"`` (a GP with expected improvement over log2 bytes in
[20, 28], ``optim.py``).  Either way: warm-up exploration, converge,
freeze, a CSV log, rank 0 decides.
"""

from __future__ import annotations

import time
from typing import List, Optional

DEFAULT_CANDIDATES_MB = (1, 8, 32, 64, 128, 256)


class ParameterManager:
    def __init__(self, enabled: bool = False,
                 candidates_mb=DEFAULT_CANDIDATES_MB,
                 samples_per_candidate: int = 5,
                 initial_threshold: int = 128 * 1024 * 1024,
                 log_path: Optional[str] = None,
                 decide_fn=None,
                 search: str = "sweep",
                 bayes_rounds: int = 12,
                 candidate_pub=None,
                 candidate_fetch=None):
        """``decide_fn(local_best_threshold) -> final_threshold``: the
        SynchronizeParameters hook (parameter_manager.h) — in
        multi-controller mode, rank 0's choice is published through the
        rendezvous KV store and every rank adopts it, because per-rank
        wall-clock scores can diverge and a divergent threshold means
        divergent fusion buckets (mismatched collectives).  Exploration
        itself is deterministic: the candidate schedule advances on sample
        COUNT, identical on all ranks."""
        self.enabled = enabled
        self.search = search  # 'sweep' | 'bayes' (GP + expected improvement)
        self.candidates = [int(mb) * 1024 * 1024 for mb in candidates_mb]
        self.samples_per_candidate = samples_per_candidate
        self._scores: List[List[float]] = [[] for _ in self.candidates]
        self._idx = 0
        self._converged = not enabled
        self._threshold = initial_threshold
        self._decide_fn = decide_fn
        self._log = open(log_path, "a") if log_path else None
        if self._log:
            self._log.write("candidate_bytes,score_bytes_per_sec\n")
        if search == "bayes" and enabled:
            # Knob space: log2(bytes) in [20, 28] = 1 MB .. 256 MB, the same
            # span as the sweep candidates (bayesian_optimization.cc model).
            # Multi-controller: rank 0 owns the GP and PUBLISHES each
            # round's candidate (candidate_pub); followers FETCH it
            # (candidate_fetch) so exploration thresholds — and therefore
            # fusion buckets — stay identical on every rank (the
            # reference's rank-0-tunes + SynchronizeParameters design,
            # parameter_manager.h).  Round advancement is sample-count
            # driven, identical everywhere.
            self._bo_rounds = bayes_rounds
            self._bo_round = 0
            self._bo_scores: List[float] = []
            self._cand_pub = candidate_pub
            self._cand_fetch = candidate_fetch
            if candidate_fetch is None:
                from .optim import BayesianOptimizer
                self._bo = BayesianOptimizer(low=20.0, high=28.0)
                self._bo_current = self._bo.suggest()
                if candidate_pub is not None:
                    candidate_pub(0, float(self._bo_current))
            else:
                self._bo = None
                self._bo_current = float(candidate_fetch(0))

    @property
    def fusion_threshold_bytes(self) -> int:
        if self._converged:
            return self._threshold
        if self.search == "bayes":
            return int(2 ** self._bo_current)
        return self.candidates[self._idx]

    @property
    def converged(self) -> bool:
        return self._converged

    def record_sample(self, nbytes: int, seconds: float) -> None:
        """Score one dispatch window (bytes moved / wall time) against the
        currently-explored candidate (parameter_manager Update/Tune)."""
        if self._converged or seconds <= 0:
            return
        score = nbytes / seconds
        if self.search == "bayes":
            self._bo_scores.append(score)
            if self._log:
                self._log.write(
                    f"{int(2 ** self._bo_current)},{score:.1f}\n")
                self._log.flush()
            if len(self._bo_scores) >= self.samples_per_candidate:
                if self._bo is not None:
                    self._bo.observe(
                        self._bo_current,
                        sum(self._bo_scores) / len(self._bo_scores))
                self._bo_scores = []
                self._bo_round += 1
                if self._bo_round >= self._bo_rounds:
                    # Controller converges on its GP optimum; followers'
                    # decide_fn blocks on the controller's published
                    # decision (core.py _synced_decision).
                    local = int(2 ** (self._bo.best() if self._bo is not None
                                      else self._bo_current))
                    self._threshold = (self._decide_fn(local)
                                       if self._decide_fn else local)
                    self._converged = True
                    if self._log:
                        self._log.write(
                            f"# converged threshold={self._threshold}\n")
                        self._log.flush()
                elif self._bo is not None:
                    self._bo_current = self._bo.suggest()
                    if self._cand_pub is not None:
                        self._cand_pub(self._bo_round,
                                       float(self._bo_current))
                else:
                    self._bo_current = float(
                        self._cand_fetch(self._bo_round))
            return
        self._scores[self._idx].append(score)
        if self._log:
            self._log.write(f"{self.candidates[self._idx]},{score:.1f}\n")
            self._log.flush()
        if len(self._scores[self._idx]) >= self.samples_per_candidate:
            self._idx += 1
            if self._idx >= len(self.candidates):
                self._finalize()

    def _finalize(self) -> None:
        means = [sum(s) / len(s) if s else 0.0 for s in self._scores]
        best = max(range(len(means)), key=lambda i: means[i])
        local_choice = self.candidates[best]
        if self._decide_fn is not None:
            self._threshold = self._decide_fn(local_choice)
        else:
            self._threshold = local_choice
        self._converged = True
        if self._log:
            self._log.write(f"# converged threshold={self._threshold}\n")
            self._log.flush()

    def close(self):
        if self._log:
            self._log.close()
            self._log = None
