"""Amplicon bias detection (AmpliconBiasCalculator.cs port).

Per-amplicon support/coverage proportion test: if a variant's observations on
some amplicon are far below what its best-amplicon frequency predicts
(Poisson), flag amplicon bias.
"""
from __future__ import annotations

from typing import Dict, Optional

from pisces_tpu_torch.ops import stats

MIN_NUM_OBSERVATIONS = 5
FREE_PASS_OBSERVATION_FREQ = 0.1


def calculate_amplicon_bias(support_by_amplicon: Dict[str, float],
                            coverage_by_amplicon: Dict[str, float],
                            acceptance_criteria: float,
                            max_qscore: int) -> Optional[dict]:
    """Returns {'bias_detected': bool, 'results': {name: {...}}} or None."""
    if not support_by_amplicon:
        return None
    if len(coverage_by_amplicon) < 2:
        return None

    results = {}
    max_freq = 0.0
    candidate_artifact = None
    for name, coverage in coverage_by_amplicon.items():
        support = support_by_amplicon.get(name, 0.0)
        freq = support / coverage if coverage > 0 else 0.0
        if freq >= max_freq:
            candidate_artifact = name
            max_freq = freq
        results[name] = {"frequency": freq, "support": support,
                         "coverage": coverage}

    should_fail = False
    for name, r in results.items():
        coverage, support, freq = r["coverage"], r["support"], r["frequency"]
        qscore = 0
        bias_detected = False
        expected = max_freq * coverage
        p_chance_real = 1.0
        if expected < MIN_NUM_OBSERVATIONS:
            qscore = max_qscore
        elif expected <= support or freq > FREE_PASS_OBSERVATION_FREQ:
            qscore = max_qscore
        else:
            p_chance_real = max(0.0, float(stats.poisson_cdf(support, expected)))
            qscore = int(stats.p_to_q(max(1.0 - p_chance_real, 1e-300)))
        if p_chance_real < acceptance_criteria:
            bias_detected = True
            should_fail = True
        r.update({"chance_its_real": p_chance_real, "qscore": qscore,
                  "bias_detected": bias_detected, "expected": expected})

    return {"bias_detected": should_fail, "results": results,
            "candidate_artifact": candidate_artifact}
