"""Bootstrap confidence intervals and the regression-gate rule (the
port's copy of the reference's statistics layer).

Kalibera & Jones' two-level scheme: repeat the whole benchmark (runs),
reduce each run to its mean over iterations, and bootstrap over the run
means — runs are the independent unit, iterations within one share warm
caches and clock state.

`bootstrap_ci`  — two-level bootstrap CI of the mean (or median) over
                  repeated runs; per-run means or per-run sample lists.
                  Seeded, and the run means are sorted first, so the
                  interval does not depend on run order.
`ci_ratio`      — current/baseline ratio CI, both sides resampled apart.
`gate_ratio`    — FAIL only when the ratio CI excludes the allowed
                  factor.
`variance_decomposition` — within-run against between-run share of the
                  run-mean variance, which sizes the number of repeats.

One run yields a zero-width interval (``ci_lo == mean == ci_hi``), and
the gate then reduces to the strict mean comparison. Every function
returns exactly what the reference's returns on the same runs and seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np

DEFAULT_CONFIDENCE = 0.95
DEFAULT_N_BOOT = 2000
METHOD = "kalibera-jones-bootstrap"

Runs = Union[Sequence[float], Sequence[Sequence[float]]]

_STATISTICS = {"mean": np.mean, "median": np.median}


def run_means(runs: Runs) -> np.ndarray:
    """Reduce level-two samples to sorted per-run means (level one).

    Accepts a flat sequence of per-run means or a nested sequence of
    per-run iteration samples. Sorting makes every downstream interval
    invariant under run permutation (the resampling indices are drawn
    from a seeded PRNG, so without sorting a shuffle of the same data
    would change which values the indices hit).
    """
    if len(runs) == 0:
        raise ValueError("need at least one run")
    first = runs[0]
    if isinstance(first, (list, tuple, np.ndarray)):
        means = [float(np.mean(np.asarray(r, dtype=np.float64)))
                 for r in runs]
    else:
        means = [float(r) for r in runs]
    return np.sort(np.asarray(means, dtype=np.float64))


@dataclasses.dataclass
class CIStats:
    """A location estimate with its bootstrap confidence interval.

    ``run_means`` carries the level-one data the interval was computed
    from, so a *committed* baseline row contains everything a later
    gate needs to bootstrap a ratio CI against fresh measurements —
    endpoints alone cannot be resampled.
    """

    mean: float
    ci_lo: float
    ci_hi: float
    n_runs: int
    confidence: float = DEFAULT_CONFIDENCE
    n_boot: int = DEFAULT_N_BOOT
    seed: int = 0
    method: str = METHOD
    run_means: List[float] = dataclasses.field(default_factory=list)

    def json_dict(self) -> dict:
        return dataclasses.asdict(self)


def bootstrap_ci(runs: Runs, *, confidence: float = DEFAULT_CONFIDENCE,
                 n_boot: int = DEFAULT_N_BOOT, seed: int = 0,
                 statistic: str = "mean") -> CIStats:
    """Two-level bootstrap CI of ``statistic`` over repeated runs.

    Each run is reduced to its mean (level two -> one), then ``n_boot``
    resamples of the run means — with replacement, sized like the
    original — are summarized by ``statistic`` ("mean" or "median") and
    the interval is the equal-tailed percentile range at ``confidence``.
    The interval is clamped to contain the point estimate.
    """
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0, 1): {confidence}")
    stat = _STATISTICS[statistic]
    means = run_means(runs)
    point = float(stat(means))
    n = means.size
    if n == 1:
        lo = hi = point
    else:
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, n, size=(n_boot, n))
        boots = stat(means[idx], axis=1)
        tail = 100.0 * (1.0 - confidence) / 2.0
        lo, hi = np.percentile(boots, [tail, 100.0 - tail])
    return CIStats(mean=point, ci_lo=float(min(lo, point)),
                   ci_hi=float(max(hi, point)), n_runs=int(n),
                   confidence=confidence, n_boot=n_boot, seed=seed,
                   run_means=[float(m) for m in means])


@dataclasses.dataclass
class RatioCI:
    """current/baseline ratio with its bootstrap interval."""

    ratio: float
    ci_lo: float
    ci_hi: float
    n_runs_baseline: int
    n_runs_current: int
    confidence: float = DEFAULT_CONFIDENCE

    def json_dict(self) -> dict:
        return dataclasses.asdict(self)


def ci_ratio(baseline: Runs, current: Runs, *,
             confidence: float = DEFAULT_CONFIDENCE,
             n_boot: int = DEFAULT_N_BOOT, seed: int = 0,
             statistic: str = "mean") -> RatioCI:
    """Bootstrap CI of the current/baseline ratio of ``statistic``.

    Both sides are resampled independently (they were measured
    independently); each bootstrap replicate is the ratio of the two
    resampled statistics. With a single run on both sides the interval
    is the degenerate point ratio. Baseline values must be nonzero.
    """
    if not 0.0 < confidence < 1.0:
        raise ValueError(f"confidence must be in (0, 1): {confidence}")
    stat = _STATISTICS[statistic]
    base = run_means(baseline)
    cur = run_means(current)
    if np.any(base == 0.0):
        raise ValueError("baseline contains zero runs (ratio undefined)")
    point = float(stat(cur) / stat(base))
    if base.size == 1 and cur.size == 1:
        lo = hi = point
    else:
        rng = np.random.default_rng(seed)
        bi = rng.integers(0, base.size, size=(n_boot, base.size))
        ci_ = rng.integers(0, cur.size, size=(n_boot, cur.size))
        denom = stat(base[bi], axis=1)
        boots = stat(cur[ci_], axis=1) / denom
        tail = 100.0 * (1.0 - confidence) / 2.0
        lo, hi = np.percentile(boots, [tail, 100.0 - tail])
    return RatioCI(ratio=point, ci_lo=float(min(lo, point)),
                   ci_hi=float(max(hi, point)),
                   n_runs_baseline=int(base.size),
                   n_runs_current=int(cur.size), confidence=confidence)


@dataclasses.dataclass
class GateDecision:
    """One gate verdict: the ratio interval vs the allowed factor."""

    ok: bool
    ratio: RatioCI
    factor: float
    higher_is_better: bool
    reason: str


def gate_ratio(baseline: Runs, current: Runs, *, factor: float,
               higher_is_better: bool,
               confidence: float = DEFAULT_CONFIDENCE,
               n_boot: int = DEFAULT_N_BOOT, seed: int = 0) -> GateDecision:
    """The CI-exclusion regression rule for one (baseline, current) cell.

    ``factor`` is the allowed degradation (e.g. 2.0 = current may be up
    to 2x slower / half the throughput). With r = current/baseline:

      * time-like metrics (``higher_is_better=False``): FAIL iff the
        whole interval sits above the factor — ``ci_lo(r) > factor``.
      * throughput-like metrics (``higher_is_better=True``): FAIL iff
        the whole interval sits below the floor — ``ci_hi(r) < 1/factor``.

    An interval that *straddles* the bound passes: the data cannot
    distinguish the cell from an allowed one, and failing it would be
    exactly the runner-noise false alarm this module exists to kill.
    Degenerate single-run intervals reduce the rule to the legacy
    strict mean comparison.
    """
    if factor <= 0.0:
        raise ValueError(f"factor must be positive: {factor}")
    r = ci_ratio(baseline, current, confidence=confidence, n_boot=n_boot,
                 seed=seed)
    if higher_is_better:
        floor = 1.0 / factor
        ok = r.ci_hi >= floor
        reason = (f"ratio {r.ratio:.3f} CI [{r.ci_lo:.3f}, {r.ci_hi:.3f}]"
                  f" {'contains or exceeds' if ok else 'entirely below'}"
                  f" allowed floor {floor:.3f} (factor {factor:g})")
    else:
        ok = r.ci_lo <= factor
        reason = (f"ratio {r.ratio:.3f} CI [{r.ci_lo:.3f}, {r.ci_hi:.3f}]"
                  f" {'contains or undercuts' if ok else 'entirely above'}"
                  f" allowed factor {factor:g}")
    return GateDecision(ok=ok, ratio=r, factor=factor,
                        higher_is_better=higher_is_better, reason=reason)


@dataclasses.dataclass
class VarianceDecomposition:
    """Where the run-mean variance comes from: within or between runs.

    One-way random-effects decomposition over repeated benchmark runs
    (K&J §3: iterations within a run share warm caches and frequency
    state, runs are the independent unit). ``within_var`` is the mean
    per-run iteration variance (S² within); ``between_var`` is the
    method-of-moments estimate of the *true* run-to-run variance after
    the within-run sampling noise is subtracted (clamped at zero).
    ``between_share`` is the fraction of the observed run-mean variance
    that more iterations per run can never remove — when it dominates,
    size ``--repeats`` up; when ``within_share`` dominates, longer runs
    beat more runs.
    """

    n_runs: int
    mean_iters: float            # mean iterations per run
    within_var: float            # S²_within — mean per-run variance
    between_var: float           # σ²_between — excess run-to-run variance
    within_share: float          # share of run-mean variance
    between_share: float

    def json_dict(self) -> dict:
        return dataclasses.asdict(self)


def variance_decomposition(run_samples: Sequence[Sequence[float]]
                           ) -> VarianceDecomposition:
    """Decompose run-mean variance into within/between-run components.

    Input is the nested level-two data (per-run iteration samples, the
    same shape `bootstrap_ci` accepts nested). The observed variance of
    the run means is ``σ²_between + S²_within / n̄``; both shares are
    reported against that total. Degenerate inputs — one run, or
    single-iteration runs, or zero total variance — yield 0.0 shares
    rather than NaNs: no decomposition is claimable from them.
    """
    if len(run_samples) == 0:
        raise ValueError("need at least one run")
    runs = [np.asarray(r, dtype=np.float64) for r in run_samples]
    if any(r.ndim != 1 or r.size == 0 for r in runs):
        raise ValueError("each run must be a non-empty 1-D sample list")
    n_runs = len(runs)
    mean_iters = float(np.mean([r.size for r in runs]))
    within = float(np.mean([r.var(ddof=1) if r.size > 1 else 0.0
                            for r in runs]))
    means = np.asarray([r.mean() for r in runs])
    obs = float(means.var(ddof=1)) if n_runs > 1 else 0.0
    sampling = within / mean_iters if mean_iters > 0 else 0.0
    between = max(0.0, obs - sampling)
    total = between + sampling
    if n_runs < 2 or total <= 0.0:
        w_share = b_share = 0.0
    else:
        b_share = between / total
        w_share = sampling / total
    return VarianceDecomposition(
        n_runs=n_runs, mean_iters=mean_iters, within_var=within,
        between_var=between, within_share=w_share,
        between_share=b_share)


def ci_json(ci: Optional[CIStats]) -> Optional[dict]:
    """None-propagating json_dict (telemetry stamping convenience)."""
    return None if ci is None else ci.json_dict()
