"""SLO accounting: availability + latency-threshold burn rates.

A copy of the reference package's ``runtime/slo.py`` (pure math; the
port imports nothing of the reference).

The math behind the scrape-time ``serving_slo_*`` gauges every
:class:`~synapseml_tpu_torch.io.serving.WorkerServer` registers (catalog +
methodology in docs/observability.md, "SLO accounting"). Pure
functions over data the telemetry registry already holds — the
per-status reply counters and the roundtrip latency histogram — so
nothing new is recorded on the request path; the SLO view is computed
when a scrape asks for it.

Definitions (the standard error-budget formulation):

- **availability** = 1 - (5xx replies / all replies). Client-caused
  4xx (400 poison payloads) and admission-control 429s are *not*
  availability losses — the replica answered deliberately; 500/503/504
  are (a shed 503/504 is capacity the caller asked for and did not
  get). No replies yet = 1.0 (no data is not an outage).
- **latency good fraction** = fraction of roundtrips at or under the
  threshold, estimated from the fixed histogram buckets with linear
  interpolation inside the covering bucket (the same
  ``histogram_quantile`` math the percentile readout uses, inverted).
- **burn rate** = (observed bad fraction) / (allowed bad fraction);
  1.0 burns the error budget exactly at the rate the SLO allows, 14.4
  sustained for an hour eats a 30-day 99.9% budget's month in ~2 days
  — the classic fast-burn alert threshold shipped in the chart's
  Prometheus rules (tools/k8s/chart/templates/alerts.yaml).

Targets come from ``SYNAPSEML_SLO_AVAILABILITY`` (default 0.999) and
``SYNAPSEML_SLO_LATENCY_MS`` (default 250) — read once per server at
construction, overridable per WorkerServer.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

__all__ = ["availability", "fraction_le", "burn_rate",
           "DEFAULT_AVAILABILITY_TARGET", "DEFAULT_LATENCY_MS"]

DEFAULT_AVAILABILITY_TARGET = 0.999
DEFAULT_LATENCY_MS = 250.0


def availability(replies_by_code: Mapping[object, float]) -> float:
    """Good-reply fraction from a ``{status_code: count}`` map.

    Bad = 5xx. Codes that do not parse as ints count as bad (an
    ``"error"`` bucket is a failure, not a reply). Empty map = 1.0."""
    total = 0.0
    bad = 0.0
    for code, n in replies_by_code.items():
        if n <= 0:
            continue
        total += n
        try:
            c = int(code)
        except (TypeError, ValueError):
            bad += n
            continue
        if c >= 500:
            bad += n
    if total <= 0:
        return 1.0
    return 1.0 - bad / total


def fraction_le(bounds: Sequence[float], counts: Sequence[int],
                threshold: float) -> float:
    """Fraction of observations <= ``threshold`` from fixed-bucket
    histogram state: ``bounds`` are the bucket upper bounds and
    ``counts`` the per-bucket (NON-cumulative) counts, one extra for
    the overflow bucket (``len(counts) == len(bounds) + 1`` — the
    layout :class:`~synapseml_tpu_torch.runtime.telemetry.Histogram`
    aggregates to). Inside the bucket that straddles the threshold,
    observations are assumed uniform (linear interpolation); the
    unbounded overflow bucket contributes nothing below the threshold
    (conservative: overflow observations count as bad). No data =
    1.0."""
    n = sum(counts)
    if n <= 0:
        return 1.0
    good = 0.0
    for i, c in enumerate(counts):
        if not c:
            continue
        lo = bounds[i - 1] if i > 0 else 0.0
        hi = bounds[i] if i < len(bounds) else math.inf
        if hi <= threshold:
            good += c
        elif lo < threshold and not math.isinf(hi):
            good += c * (threshold - lo) / (hi - lo)
    return min(1.0, good / n)


def burn_rate(good_fraction: float, target: float) -> float:
    """Error-budget burn rate: observed bad fraction over the allowed
    bad fraction. 0 when nothing is bad; with a degenerate 100% target
    (zero budget), any badness is an infinite burn."""
    bad = max(0.0, 1.0 - good_fraction)
    budget = 1.0 - target
    if budget <= 0.0:
        return 0.0 if bad <= 0.0 else math.inf
    return bad / budget
