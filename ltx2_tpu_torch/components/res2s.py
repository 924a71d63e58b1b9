"""Res2s exponential-integrator RK coefficients (counterpart of
ltx2_tpu/components/res2s.py): host float math over the static sigma
schedule."""

from __future__ import annotations

import math
from typing import Dict, Tuple


def phi(j: int, neg_h: float) -> float:
    """phi_j(z), z = -h: (e^z - sum_{k<j} z^k / k!) / z^j, with the limit
    phi_j(0) = 1 / j!."""
    if abs(neg_h) < 1e-10:
        return 1.0 / math.factorial(j)
    remainder = sum(neg_h ** k / math.factorial(k) for k in range(j))
    return (math.exp(neg_h) - remainder) / (neg_h ** j)


def get_res2s_coefficients(h: float, phi_cache: Dict[Tuple[int, float], float], c2: float = 0.5
                           ) -> Tuple[float, float, float]:
    """(a21, b1, b2) of the two-stage RK step of log-space length h, the
    phi values memoised in `phi_cache`."""

    def get_phi(j: int, neg_h: float) -> float:
        key = (j, neg_h)
        if key not in phi_cache:
            phi_cache[key] = phi(j, neg_h)
        return phi_cache[key]

    a21 = c2 * get_phi(1, -h * c2)
    b2 = get_phi(2, -h) / c2
    b1 = get_phi(1, -h) - b2
    return a21, b1, b2
