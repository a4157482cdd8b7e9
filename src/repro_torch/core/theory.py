"""Theory-prescribed hyperparameters and complexity formulas (Section 6);
port of ``repro.core.theory`` (plain ``math``).

Everything here keeps the paper's exact constants — the benchmarks use these
(only the stepsize may be fine-tuned over powers of two, exactly as in
Appendix A of the paper).
"""
from __future__ import annotations

import dataclasses
import math

# a = 1/(2 omega + 1) (Theorems 6.1 / 6.4 / 6.7); single definition lives
# with the omega calculus in the compression spec layer.
from repro_torch.compress.spec import momentum_a  # noqa: F401


def gamma_dasha(L: float, L_hat: float, omega: float, n: int) -> float:
    """Theorem 6.1: gamma <= (L + sqrt(16 w (2w+1)/n) * L_hat)^{-1}."""
    return 1.0 / (L + math.sqrt(16.0 * omega * (2 * omega + 1) / n) * L_hat)


def gamma_dasha_page(L: float, L_hat: float, L_max: float, omega: float,
                     n: int, B: int, p: float) -> float:
    """Theorem 6.4."""
    inner = (48.0 * omega * (2 * omega + 1) / n
             * ((1 - p) * L_max**2 / B + L_hat**2)
             + 2.0 * (1 - p) * L_max**2 / (p * n * B))
    return 1.0 / (L + math.sqrt(inner))


def gamma_dasha_mvr(L: float, L_hat: float, L_sigma: float, omega: float,
                    n: int, B: int, b: float) -> float:
    """Theorem 6.7."""
    inner = (96.0 * omega * (2 * omega + 1) / n
             * ((1 - b) ** 2 * L_sigma**2 / B + L_hat**2)
             + 4.0 * (1 - b) ** 2 * L_sigma**2 / (b * n * B))
    return 1.0 / (L + math.sqrt(inner))


def gamma_sync_mvr(L: float, L_hat: float, L_sigma: float, omega: float,
                   n: int, B: int, p: float) -> float:
    """Theorem H.19."""
    inner = (12.0 * omega * (2 * omega + 1) * (1 - p) / n
             * (L_sigma**2 / B + L_hat**2)
             + 2.0 * (1 - p) * L_sigma**2 / (p * n * B))
    return 1.0 / (L + math.sqrt(inner))


def page_p(B: int, m: int) -> float:
    """Corollary 6.5: p = B / (m + B)."""
    return B / (m + B)


def mvr_b(omega: float, n: int, B: int, eps: float, sigma2: float) -> float:
    """Corollary 6.8: b = Theta(min{ (1/w) sqrt(n eps B / s2), n eps B / s2 })."""
    if sigma2 == 0:
        return 1.0
    r = n * eps * B / sigma2
    b = min(math.sqrt(r) / max(omega, 1e-12), r)
    return max(min(b, 1.0), 1e-8)


def sync_mvr_p(zeta: float, d: int, n: int, B: int, eps: float,
               sigma2: float) -> float:
    """Corollary 6.10: p = min{zeta/d, n eps B / sigma^2}."""
    if sigma2 == 0:
        return zeta / d
    return max(min(zeta / d, n * eps * B / sigma2), 1e-8)


def marina_p(zeta: float, d: int) -> float:
    """MARINA's sync probability p = zeta_C / d (Gorbunov et al. 2021)."""
    return zeta / d


def gamma_marina(L: float, omega: float, n: int, p: float) -> float:
    """MARINA stepsize (Gorbunov et al. 2021, Theorem 2.1):
    gamma <= (L (1 + sqrt((1-p) omega / (p n))))^{-1}."""
    return 1.0 / (L * (1.0 + math.sqrt((1.0 - p) * omega / (p * n))))


# ---------------------------------------------------------------------------
# Table 1 (general nonconvex) communication-round counts, up to constants.
# These power benchmarks/table1_complexity.py.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProblemConstants:
    eps: float
    n: int
    omega: float
    delta0: float = 1.0      # f(x0) - f*
    L: float = 1.0
    L_hat: float = 1.0
    L_max: float = 1.0
    L_sigma: float = 1.0
    m: int = 1
    B: int = 1
    sigma2: float = 0.0
    d: int = 1
    zeta: float = 1.0


def rounds_dasha(c: ProblemConstants) -> float:
    return c.delta0 * (c.L + c.omega / math.sqrt(c.n) * c.L_hat) / c.eps


def rounds_marina(c: ProblemConstants) -> float:
    return (1.0 + c.omega / math.sqrt(c.n)) * c.L * c.delta0 / c.eps


def rounds_dasha_page(c: ProblemConstants) -> float:
    t = (c.L + c.omega / math.sqrt(c.n) * c.L_hat
         + (c.omega / math.sqrt(c.n) + math.sqrt(c.m / (c.n * c.B)))
         * c.L_max / math.sqrt(c.B))
    return c.delta0 * t / c.eps


def rounds_vr_marina(c: ProblemConstants) -> float:
    return ((1.0 + c.omega / math.sqrt(c.n)) / c.eps
            + math.sqrt((1.0 + c.omega) * c.m) / (c.eps * math.sqrt(c.n) * c.B)
            ) * c.L_max * c.delta0


def rounds_dasha_mvr(c: ProblemConstants) -> float:
    t = (c.L + c.omega / math.sqrt(c.n) * c.L_hat
         + (c.omega / math.sqrt(c.n)
            + math.sqrt(c.sigma2 / (c.eps * c.n**2 * c.B)))
         * c.L_sigma / math.sqrt(c.B))
    return c.delta0 * t / c.eps + c.sigma2 / (c.n * c.eps * c.B)


def rounds_sync_mvr(c: ProblemConstants) -> float:
    t = (c.L + c.omega / math.sqrt(c.n) * c.L_hat
         + (c.omega / math.sqrt(c.n) + math.sqrt(c.d / (c.zeta * c.n))
            + math.sqrt(c.sigma2 / (c.eps * c.n**2 * c.B)))
         * c.L_sigma / math.sqrt(c.B))
    return c.delta0 * t / c.eps + c.sigma2 / (c.n * c.eps * c.B)


def rounds_vr_marina_online(c: ProblemConstants) -> float:
    return ((1.0 + c.omega / math.sqrt(c.n)) * c.L_sigma * c.delta0 / c.eps
            + c.sigma2 / (c.eps * c.n * c.B)
            + math.sqrt(1.0 + c.omega) * math.sqrt(c.sigma2)
            * c.L_sigma * c.delta0 / (c.eps**1.5 * c.n * c.B))


def comm_complexity(rounds: float, zeta: float, d: int) -> float:
    """O(d + zeta_C * T) coordinates per node."""
    return d + zeta * rounds


def oracle_complexity_page(rounds: float, m: int, B: int) -> float:
    """Corollary 6.5: O(m + B T)."""
    return m + B * rounds
