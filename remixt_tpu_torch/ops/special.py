"""Special functions and log-space primitives for the engine (torch).

Counterpart of ``remixt_tpu/ops/special.py``. All functions are
shape-polymorphic, dtype-preserving and safe under ``torch.autograd``:
domain-violating entries are double-``where``-guarded so masked-out values
cannot poison gradients with NaNs.

Distribution formulas follow the reference model: negative binomial over
total read counts, beta-binomial over allelic read counts.
"""

import torch


def logsumexp(x, dim=-1, keepdim=False):
    """Max-shifted logsumexp; -inf-safe."""
    vmax = torch.amax(x, dim=dim, keepdim=True)
    vmax = torch.where(torch.isfinite(vmax), vmax, torch.zeros_like(vmax))
    out = torch.log(torch.sum(torch.exp(x - vmax), dim=dim,
                              keepdim=True)) + vmax
    if not keepdim:
        out = out.squeeze(dim)
    return out


def exp_normalize(x, dim=-1):
    """softmax with explicit renormalization."""
    vmax = torch.amax(x, dim=dim, keepdim=True)
    y = torch.exp(x - vmax)
    return y / torch.sum(y, dim=dim, keepdim=True)


def plogp(p):
    """p*log(p) with 0 log 0 := 0."""
    safe = torch.where(p > 0, p, 1.0)
    return torch.where(p > 0, p * torch.log(safe), 0.0)


def negbin_log_likelihood(x, mu, r):
    """Negative binomial log pmf, mean-overdispersion parameterization.

    nb_p outside [0, 1] clamps to 0.5."""
    nb_p = mu / (r + mu)
    nb_p = torch.where((nb_p < 0.0) | (nb_p > 1.0), 0.5, nb_p)
    return (torch.lgamma(x + r) - torch.lgamma(x + 1.0) - torch.lgamma(r)
            + x * torch.log(nb_p) + r * torch.log1p(-nb_p))


def betabin_log_likelihood(k, n, p, M):
    """Beta-binomial log pmf; caller must supply p strictly inside (0, 1)."""
    Mp = M * p
    Mq = M * (1.0 - p)
    return (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
            - torch.lgamma(n - k + 1.0)
            + torch.lgamma(k + Mp) + torch.lgamma(n - k + Mq)
            - torch.lgamma(n + M)
            - torch.lgamma(Mp) - torch.lgamma(Mq)
            + torch.lgamma(M))


# Stirling tail of log-gamma: lgamma(z) = (z - 1/2) log z - z
# + log(2 pi)/2 + _stirling_phi(z); three series terms leave a remainder
# < 1e-15 for z >= 256 (the lgamma_shift crossover).
def _stirling_phi(z):
    z2 = z * z
    return ((1.0 / 12.0) / z - (1.0 / 360.0) / (z * z2)
            + (1.0 / 1260.0) / (z * z2 * z2))


LGAMMA_SHIFT_MIN_N = 256.0


def lgamma_shift(n, a):
    """``lgamma(n + a) - lgamma(n + 1)``, cancellation-free for large n.

    In float32 the two lgammas at n ~ 2e5 are each ~2e6, so their
    separately rounded difference carries an O(0.1) absolute error. For
    n >= 256 the large Stirling terms are combined analytically,

        (n + 1/2) log1p((a-1)/(n+1)) + (a-1) log(n+a) - (a-1)
            + phi(n+a) - phi(n+1),

    which keeps every intermediate at O(a log n). Below the crossover the
    plain difference is accurate and kept.
    """
    plain = torch.lgamma(n + a) - torch.lgamma(n + 1.0)
    n_safe = torch.clamp(n, min=LGAMMA_SHIFT_MIN_N)  # unused branch finite
    am1 = a - 1.0
    stable = ((n_safe + 0.5) * torch.log1p(am1 / (n_safe + 1.0))
              + am1 * torch.log(n_safe + a) - am1
              + _stirling_phi(n_safe + a) - _stirling_phi(n_safe + 1.0))
    return torch.where(n >= LGAMMA_SHIFT_MIN_N, stable, plain)
