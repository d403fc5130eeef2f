"""Float64 numpy oracle for the ReMixT variational model.

This module is the executable numerical specification of the inference core:
a vectorized, pure-numpy float64 mirror of the reference Cython engine
(ReMixT's ``remixt/bpmodel.pyx``, lines 397-1333). Every public method
matches a reference method's semantics exactly — update order, normalization,
special-case gating (hdel/LOH/masks), ELBO bookkeeping (the entropy uses the
transition matrix from the last chain update while the energy uses the one
recomputed after the breakpoint update) — so that

  * brute-force chain enumeration validates the oracle on tiny problems, and
  * the engine (:mod:`remixt_tpu_torch.models.engine`) is validated against
    the oracle in float64 to near machine precision.

The oracle is deliberately simple; the engine owes it numbers, not
structure.

The port's own copy of the JAX package's ``models/oracle.py``, held equal
to it by ``tests/test_torch_oracle.py``.
"""

import numpy as np
from scipy.special import gammaln, digamma as _digamma

from remixt_tpu_torch.models import states as _states


# ---------------------------------------------------------------------------
# log-space helpers
# ---------------------------------------------------------------------------

def logsumexp(x, axis=None):
    """Max-shifted logsumexp matching the reference's _logsum (bpmodel.pyx:77-107)."""
    x = np.asarray(x, dtype=np.float64)
    vmax = np.max(x, axis=axis, keepdims=True)
    vmax = np.where(np.isfinite(vmax), vmax, 0.0)
    out = np.log(np.sum(np.exp(x - vmax), axis=axis)) + np.squeeze(vmax, axis=axis)
    return out


def exp_normalize(x, axis=None):
    """exp(x - logsumexp) followed by re-normalization (bpmodel.pyx:120-159)."""
    x = np.asarray(x, dtype=np.float64)
    if axis is None:
        y = np.exp(x - logsumexp(x))
        return y / y.sum()
    vmax = np.max(x, axis=axis, keepdims=True)
    y = np.exp(x - vmax)
    y = y / np.sum(y, axis=axis, keepdims=True)
    return y


def plogp_entropy(p):
    """Sum of p*log(p) over entries with p > 0 (bpmodel.pyx:110-117)."""
    p = np.asarray(p, dtype=np.float64)
    mask = p > 0.0
    return float(np.sum(p[mask] * np.log(p[mask])))


# ---------------------------------------------------------------------------
# distribution log likelihoods (bpmodel.pyx:238-394)
# ---------------------------------------------------------------------------

def negbin_log_likelihood(x, mu, r):
    """Negative binomial log pmf with mean mu, overdispersion r.

    nb_p outside [0,1] clamps to 0.5 as the reference does (bpmodel.pyx:261-264).
    """
    x = np.asarray(x, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    nb_p = mu / (r + mu)
    nb_p = np.where((nb_p < 0.0) | (nb_p > 1.0), 0.5, nb_p)
    ll = (gammaln(x + r) - gammaln(x + 1) - gammaln(r)
          + x * np.log(nb_p) + r * np.log1p(-nb_p))
    if np.any(np.isnan(ll)):
        raise ValueError('negbin ll is nan')
    return ll


def negbin_log_likelihood_partial_mu(x, mu, r):
    """d/dmu of the negbin log pmf (bpmodel.pyx:275-301)."""
    x = np.asarray(x, dtype=np.float64)
    partial = x / mu - (r + x) / (r + mu)
    if np.any(np.isnan(partial)):
        raise ValueError('negbin partial_mu is nan')
    return partial


def betabin_log_likelihood(k, n, p, M):
    """Beta-binomial log pmf; requires p strictly inside (0,1) (bpmodel.pyx:304-347)."""
    k = np.asarray(k, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    M = np.asarray(M, dtype=np.float64)
    if np.any(p <= 0.0) or np.any(1.0 - p <= 0.0):
        raise ValueError('p <= 0 or (1 - p) <= 0')
    ll = (gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)
          + gammaln(k + M * p) + gammaln(n - k + M * (1.0 - p))
          - gammaln(n + M)
          - gammaln(M * p) - gammaln(M * (1.0 - p))
          + gammaln(M))
    if np.any(np.isnan(ll)):
        raise ValueError('betabin ll is nan')
    return ll


def betabin_log_likelihood_partial_p(k, n, p, M):
    """d/dp of the beta-binomial log pmf (bpmodel.pyx:350-394)."""
    k = np.asarray(k, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    if np.any(p <= 0.0) or np.any(1.0 - p <= 0.0):
        raise ValueError('p <= 0 or (1 - p) <= 0')
    partial = (M * _digamma(k + M * p)
               - M * _digamma(n - k + M * (1.0 - p))
               - M * _digamma(M * p)
               + M * _digamma(M * (1.0 - p)))
    if np.any(np.isnan(partial)):
        raise ValueError('betabin partial_p is nan')
    return partial


# ---------------------------------------------------------------------------
# chain message passing (bpmodel.pyx:1213-1333)
# ---------------------------------------------------------------------------

def sum_product(framelogprob, log_transmat):
    """Forward-backward in log space over a chain with per-pair transitions.

    Args:
        framelogprob: (N, S) emission log probabilities
        log_transmat: (N-1, S, S) per-adjacent-pair transition log weights

    Returns:
        alphas (N, S), betas (N, S)
    """
    framelogprob = np.asarray(framelogprob, dtype=np.float64)
    log_transmat = np.asarray(log_transmat, dtype=np.float64)
    N, S = framelogprob.shape

    alphas = np.empty((N, S))
    betas = np.empty((N, S))

    alphas[0] = framelogprob[0]
    for n in range(1, N):
        alphas[n] = logsumexp(alphas[n - 1][:, None] + log_transmat[n - 1], axis=0) + framelogprob[n]

    betas[N - 1] = 0.0
    for n in range(N - 2, -1, -1):
        betas[n] = logsumexp(log_transmat[n] + (framelogprob[n + 1] + betas[n + 1])[None, :], axis=1)

    return alphas, betas


def max_product(framelogprob, log_transmat):
    """Viterbi decoding; first-maximum tie-breaking like the reference.

    Returns:
        state_sequence (N,) int64, logprob float
    """
    framelogprob = np.asarray(framelogprob, dtype=np.float64)
    log_transmat = np.asarray(log_transmat, dtype=np.float64)
    N, S = framelogprob.shape

    lattice = np.empty((N, S))
    lattice[0] = framelogprob[0]
    for n in range(1, N):
        scores = lattice[n - 1][:, None] + log_transmat[n - 1]
        lattice[n] = scores.max(axis=0) + framelogprob[n]

    state_sequence = np.zeros(N, dtype=np.int64)
    state_sequence[-1] = int(np.argmax(lattice[-1]))
    logprob = float(lattice[-1, state_sequence[-1]])
    for n in range(N - 2, -1, -1):
        state_sequence[n] = int(np.argmax(lattice[n] + log_transmat[n, :, state_sequence[n + 1]]))

    return state_sequence, logprob


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class OracleModel:
    """Float64 mirror of the reference RemixtModel (bpmodel.pyx:397-1210).

    Construction arguments and attribute names match the reference so the two
    can be driven identically by the fit layer and compared field by field.
    """

    def __init__(self,
                 num_clones,
                 num_segments,
                 num_breakpoints,
                 normal_contamination,
                 cn_states,
                 brk_states,
                 h_init,
                 l,
                 x,
                 y,
                 is_telomere,
                 breakpoint_idx,
                 breakpoint_orient,
                 transition_penalty,
                 divergence_weight):
        self.num_clones = int(num_clones)
        self.num_segments = int(num_segments)
        self.num_breakpoints = int(num_breakpoints)
        self.normal_contamination = bool(normal_contamination)
        self.cn_states = np.asarray(cn_states, dtype=np.int64)
        self.brk_states = np.asarray(brk_states, dtype=np.int64)
        self.h = np.asarray(h_init, dtype=np.float64).copy()
        self.l = np.asarray(l, dtype=np.float64)
        self.x = np.asarray(x, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        self.num_alleles = 2
        self.cn_max = int(max(self.cn_states.max(), self.brk_states.max()))
        self.num_cn_states = self.cn_states.shape[1]
        self.num_brk_states = self.brk_states.shape[0]

        self.total_likelihood_mask = np.ones(self.num_segments, dtype=np.int64)
        self.allele_likelihood_mask = np.ones(self.num_segments, dtype=np.int64)

        self.cn_states_total = self.cn_states.sum(axis=-1)

        ind = _states.state_indicators(self.cn_states)
        self.num_alleles_subclonal = ind['num_alleles_subclonal']
        self.is_hdel = ind['is_hdel']
        self.is_loh = ind['is_loh']

        if self.cn_states.shape != (self.num_segments, self.num_cn_states, self.num_clones, 2):
            raise ValueError('cn_states must have shape (num_segments, num_cn_states, num_clones, num_alleles)')
        if self.brk_states.shape != (self.num_brk_states, self.num_clones):
            raise ValueError('brk_states must have shape (num_brk_states, num_clones)')
        if self.h.shape[0] != self.num_clones:
            raise ValueError('h must have length equal to num_clones')
        for name, arr in [('is_telomere', is_telomere), ('breakpoint_idx', breakpoint_idx),
                          ('breakpoint_orient', breakpoint_orient)]:
            if np.asarray(arr).shape[0] != self.num_segments:
                raise ValueError('{} must have length equal to num_segments'.format(name))
        if self.num_breakpoints > 0 and np.asarray(breakpoint_idx).max() + 1 != self.num_breakpoints:
            raise ValueError('breakpoint_idx must have maximum of num_breakpoints positive indices')

        self.is_telomere = np.asarray(is_telomere, dtype=np.int64)
        self.breakpoint_idx = np.asarray(breakpoint_idx, dtype=np.int64)
        self.breakpoint_orient = np.asarray(breakpoint_orient, dtype=np.int64)
        self.transition_penalty = abs(float(transition_penalty))
        self.divergence_weight = abs(float(divergence_weight))

        # order of breakend occurrence within each breakpoint (bpmodel.pyx:537-544)
        self.breakpoint_side = np.zeros(self.num_segments, dtype=np.int64)
        sides = np.zeros(max(self.num_breakpoints, 1), dtype=np.int64)
        for n in range(self.num_segments):
            k = self.breakpoint_idx[n]
            if k < 0:
                continue
            self.breakpoint_side[n] = sides[k]
            sides[k] += 1

        # p_breakpoint initialized to favour states with at most one copy
        # (bpmodel.pyx:547-554)
        self.p_breakpoint = np.zeros((self.num_breakpoints, self.num_brk_states))
        self.p_breakpoint[:, self.brk_states.max(axis=1) <= 1] = 1.0
        if self.num_breakpoints > 0:
            self.p_breakpoint /= self.p_breakpoint.sum(axis=-1, keepdims=True)

        self.hmm_log_norm_const = 0.0
        self.framelogprob = np.ones((self.num_segments, self.num_cn_states))
        self.log_transmat = np.zeros((self.num_segments - 1, self.num_cn_states, self.num_cn_states))
        self.posterior_marginals = np.full(
            (self.num_segments, self.num_cn_states), 1.0 / self.num_cn_states)
        self.joint_posterior_marginals = np.full(
            (self.num_segments - 1, self.num_cn_states, self.num_cn_states),
            1.0 / self.num_cn_states ** 2)

        self.p_allele_swap = np.full((self.num_segments, 2), 0.5)

        self.prior_outlier_total = 0.01
        self.prior_outlier_allele = 0.01
        self.p_outlier_total = np.tile(
            [1.0 - self.prior_outlier_total, self.prior_outlier_total], (self.num_segments, 1))
        self.p_outlier_allele = np.tile(
            [1.0 - self.prior_outlier_allele, self.prior_outlier_allele], (self.num_segments, 1))

        # likelihood parameter init (bpmodel.pyx:586-597)
        self.negbin_r_0 = 500.0
        self.negbin_r_1 = 10.0
        self.negbin_hdel_mu = 1e-5
        self.negbin_hdel_r_0 = 10.0
        self.negbin_hdel_r_1 = 1.0
        self.betabin_M_0 = 500.0
        self.betabin_M_1 = 10.0
        self.betabin_loh_p = 1e-3
        self.betabin_loh_M_0 = 10.0
        self.betabin_loh_M_1 = 1.0

        self.transition_model = 0

        self.cached_log_transmat = self.calculate_log_transmat()

    # -- transition structure ------------------------------------------------

    def calc_transition(self, cn_diff):
        """f(Δ): absolute difference (model 0) or 0/1 step (model 1)."""
        cn_diff = np.asarray(cn_diff, dtype=np.float64)
        if self.transition_model == 0:
            return np.abs(cn_diff)
        elif self.transition_model == 1:
            return (cn_diff != 0).astype(np.float64)
        raise ValueError('unknown transition model')

    def _breakpoint_w(self, k, m, orient):
        """w(d) = E_{p_brk[k]}[ f(d - orient*b_m) ] over d in [-cn_max-1, cn_max+1]."""
        d = np.arange(-self.cn_max - 1, self.cn_max + 2, dtype=np.int64)
        f = self.calc_transition(d[:, None] - orient * self.brk_states[None, :, m])
        return f @ self.p_breakpoint[k], d

    def calculate_log_transmat(self):
        """Per-pair transition log weights (bpmodel.pyx:639-684).

        Three parts per adjacent non-telomere pair (n, n+1): per-clone total
        copy-number change penalty (breakpoint-adjusted when a breakend is
        interposed), plus an allele-consistency penalty minimized over the
        global allele flip.
        """
        N, S, M = self.num_segments, self.num_cn_states, self.num_clones
        log_transmat = np.zeros((N - 1, S, S))

        for n in range(N - 1):
            if self.is_telomere[n] > 0:
                continue

            T1 = self.cn_states_total[n]      # (S, M)
            T2 = self.cn_states_total[n + 1]  # (S, M)
            dT = T1[:, None, :] - T2[None, :, :]  # (S, S, M)

            if self.breakpoint_idx[n] < 0:
                log_transmat[n] -= self.transition_penalty * self.calc_transition(dT).sum(axis=-1)
            else:
                k = self.breakpoint_idx[n]
                for m in range(M):
                    w, d = self._breakpoint_w(k, m, self.breakpoint_orient[n])
                    wd = w[dT[:, :, m] + self.cn_max + 1]
                    log_transmat[n] -= self.transition_penalty * wd

            # allele-consistency term (bpmodel.pyx:670-684)
            cn1 = self.cn_states[n]      # (S, M, 2)
            cn2 = self.cn_states[n + 1]  # (S, M, 2)
            total_term = self.calc_transition(dT).sum(axis=-1)  # (S, S)
            change_noflip = self.calc_transition(
                cn1[:, None, :, :] - cn2[None, :, :, :]).sum(axis=(-2, -1))
            change_flip = self.calc_transition(
                cn1[:, None, :, :] - cn2[None, :, :, ::-1]).sum(axis=(-2, -1))
            allele_term = np.minimum(change_noflip - total_term, change_flip - total_term)
            log_transmat[n] -= self.transition_penalty * allele_term

        return log_transmat

    # -- emission ------------------------------------------------------------

    def _expected_total_reads(self):
        """mu[n, s] = l_n * sum_m h_m * total_cn[n, s, m] (bpmodel.pyx:686-698)."""
        return self.l[:, None] * np.einsum('nsm,m->ns', self.cn_states_total, self.h)

    def _expected_allele_ratio(self):
        """p[n, s] = minor depth / total depth (bpmodel.pyx:709-724).

        Only valid where not hdel; caller gates.
        """
        minor = np.einsum('nsm,m->ns', self.cn_states[:, :, :, 0], self.h)
        total = np.einsum('nsm,m->ns', self.cn_states_total, self.h)
        with np.errstate(divide='ignore', invalid='ignore'):
            return np.where(total > 0, minor / np.where(total > 0, total, 1.0), 0.0)

    def log_likelihood_total(self):
        """ll_total[n, s, u] for u in {inlier, outlier} (bpmodel.pyx:751-776)."""
        N, S = self.num_segments, self.num_cn_states
        mu = self._expected_total_reads()
        hdel_override = (not self.normal_contamination) & (self.is_hdel == 1)
        mu = np.where(hdel_override, self.negbin_hdel_mu, mu)
        r0 = np.where(hdel_override, self.negbin_hdel_r_0, self.negbin_r_0)
        r1 = np.where(hdel_override, self.negbin_hdel_r_1, self.negbin_r_1)

        # the reference checks the mask before evaluating (bpmodel.pyx:757),
        # so masked lanes are never touched; make them eval-safe here
        masked = self.total_likelihood_mask[:, None] == 0
        mu = np.where(masked, 1.0, mu)

        ll = np.stack([
            negbin_log_likelihood(self.x[:, None], mu, r0),
            negbin_log_likelihood(self.x[:, None], mu, r1),
        ], axis=-1)
        ll = np.where(masked[..., None], 0.0, ll)
        return ll

    def log_likelihood_allele(self):
        """ll_allele[n, s, v, w] for outlier v, swap w (bpmodel.pyx:809-853)."""
        p = self._expected_allele_ratio()
        p = np.where(self.is_hdel == 1, 0.0, p)

        loh_override = (not self.normal_contamination) & (self.is_loh == 1)
        if np.any(loh_override & (p != 0.0) & (p != 1.0)):
            raise ValueError('expected p in {0, 1} for loh state')
        p_adj = np.where(loh_override,
                         np.where(p == 0.0, self.betabin_loh_p, 1.0 - self.betabin_loh_p),
                         p)
        M0 = np.where(loh_override, self.betabin_loh_M_0, self.betabin_M_0)
        M1 = np.where(loh_override, self.betabin_loh_M_1, self.betabin_M_1)

        total_reads = self.y[:, 0] + self.y[:, 1]  # (N,)
        nonzero = (total_reads > 0) & (self.allele_likelihood_mask == 1)

        # Restrict the betabin evaluation to rows where it is defined; the
        # reference early-returns 0 for zero-count or masked segments before
        # touching the p-domain check (bpmodel.pyx:815-845).
        ll = np.zeros((self.num_segments, self.num_cn_states, 2, 2))
        idx = np.where(nonzero)[0]
        if idx.size:
            pa = p_adj[idx]
            tr = total_reads[idx, None]
            for v, Mv in enumerate([M0, M1]):
                for w in range(2):
                    k = self.y[idx, w][:, None]
                    ll[idx, :, v, w] = betabin_log_likelihood(k, tr, pa, Mv[idx])
        return ll

    def log_prior_cn(self):
        """Divergence prior per (n, s) (bpmodel.pyx:746-749)."""
        return -1.0 * self.num_alleles_subclonal * self.l[:, None] * self.divergence_weight

    def update_framelogprob(self):
        """Mix likelihood tensors over the outlier/swap indicators (bpmodel.pyx:898-919)."""
        ll_tot = self.log_likelihood_total()       # (N, S, 2)
        ll_alle = self.log_likelihood_allele()     # (N, S, 2, 2)
        frame = np.einsum('nsu,nu->ns', ll_tot, self.p_outlier_total)
        frame += np.einsum('nsvw,nv,nw->ns', ll_alle, self.p_outlier_allele, self.p_allele_swap)
        frame += self.log_prior_cn()
        self.framelogprob = frame

    # -- variational updates -------------------------------------------------

    def update_p_cn(self):
        """Chain posterior update via forward-backward (bpmodel.pyx:921-962)."""
        self.update_framelogprob()
        assert not np.any(np.isnan(self.framelogprob))

        self.log_transmat = self.calculate_log_transmat()

        alphas, betas = sum_product(self.framelogprob, self.log_transmat)
        assert not np.any(np.isnan(alphas)) and not np.any(np.isnan(betas))
        self.alphas, self.betas = alphas, betas

        self.hmm_log_norm_const = float(logsumexp(alphas[-1]))

        self.posterior_marginals = exp_normalize(alphas + betas, axis=-1)

        log_joint = (alphas[:-1, :, None] + self.log_transmat
                     + self.framelogprob[1:, None, :] + betas[1:, None, :])
        flat = log_joint.reshape(log_joint.shape[0], -1)
        self.joint_posterior_marginals = exp_normalize(flat, axis=-1).reshape(log_joint.shape)
        assert not np.any(np.isnan(self.posterior_marginals))
        assert not np.any(np.isnan(self.joint_posterior_marginals))

    def update_p_breakpoint(self):
        """Breakpoint state update from pairwise marginals (bpmodel.pyx:964-985, 619-637)."""
        if self.num_breakpoints == 0:
            self.cached_log_transmat = self.calculate_log_transmat()
            return

        log_p = np.zeros((self.num_breakpoints, self.num_brk_states))
        d_range = np.arange(-self.cn_max - 1, self.cn_max + 2, dtype=np.int64)

        for n in range(self.num_segments - 1):
            k = self.breakpoint_idx[n]
            if k < 0:
                continue
            joint = self.joint_posterior_marginals[n]
            for m in range(self.num_clones):
                dT = (self.cn_states_total[n][:, None, m]
                      - self.cn_states_total[n + 1][None, :, m])
                p_d = np.zeros(d_range.shape[0])
                np.add.at(p_d, dT.ravel() + self.cn_max + 1, joint.ravel())
                f = self.calc_transition(
                    d_range[:, None] - self.breakpoint_orient[n] * self.brk_states[None, :, m])
                log_p[k] += -self.transition_penalty * (p_d @ f)

        self.p_breakpoint = exp_normalize(log_p, axis=-1)
        self.cached_log_transmat = self.calculate_log_transmat()

    def update_p_outlier_total(self):
        """(bpmodel.pyx:987-1003)"""
        ll_tot = self.log_likelihood_total()
        log_p = np.einsum('ns,nsu->nu', self.posterior_marginals, ll_tot)
        log_p[:, 0] += np.log(1.0 - self.prior_outlier_total)
        log_p[:, 1] += np.log(self.prior_outlier_total)
        self.p_outlier_total = exp_normalize(log_p, axis=-1)

    def update_p_outlier_allele(self):
        """(bpmodel.pyx:1005-1023)"""
        ll_alle = self.log_likelihood_allele()
        log_p = np.einsum('ns,nw,nsvw->nv', self.posterior_marginals, self.p_allele_swap, ll_alle)
        log_p[:, 0] += np.log(1.0 - self.prior_outlier_allele)
        log_p[:, 1] += np.log(self.prior_outlier_allele)
        self.p_outlier_allele = exp_normalize(log_p, axis=-1)

    def update_p_allele_swap(self):
        """(bpmodel.pyx:1025-1042)"""
        ll_alle = self.log_likelihood_allele()
        log_p = np.einsum('ns,nv,nsvw->nw', self.posterior_marginals, self.p_outlier_allele, ll_alle)
        self.p_allele_swap = exp_normalize(log_p, axis=-1)

    # -- objectives ----------------------------------------------------------

    def calculate_variational_entropy(self):
        """E_q[log q] (bpmodel.pyx:1044-1058); uses log_transmat from the last
        update_p_cn, not the breakpoint-refreshed cache."""
        entropy = -self.hmm_log_norm_const
        entropy += float(np.sum(self.posterior_marginals * self.framelogprob))
        entropy += float(np.sum(self.joint_posterior_marginals * self.log_transmat))
        entropy += plogp_entropy(self.p_breakpoint)
        entropy += plogp_entropy(self.p_outlier_total)
        entropy += plogp_entropy(self.p_outlier_allele)
        entropy += plogp_entropy(self.p_allele_swap)
        return entropy

    def calculate_variational_energy(self):
        """E_q[log p] (bpmodel.pyx:1060-1117); transitions use the cached
        (post-breakpoint-update) transition matrix."""
        ll_tot = self.log_likelihood_total()
        ll_alle = self.log_likelihood_allele()

        energy = float(np.sum(self.posterior_marginals * self.log_prior_cn()))
        energy += float(np.einsum('ns,nu,nsu->', self.posterior_marginals,
                                  self.p_outlier_total, ll_tot))
        energy += float(np.sum(self.p_outlier_total[:, 0]) * np.log(1.0 - self.prior_outlier_total))
        energy += float(np.sum(self.p_outlier_total[:, 1]) * np.log(self.prior_outlier_total))
        energy += float(np.einsum('ns,nv,nw,nsvw->', self.posterior_marginals,
                                  self.p_outlier_allele, self.p_allele_swap, ll_alle))
        energy += float(np.sum(self.p_outlier_allele[:, 0]) * np.log(1.0 - self.prior_outlier_allele))
        energy += float(np.sum(self.p_outlier_allele[:, 1]) * np.log(self.prior_outlier_allele))
        energy += float(np.sum(self.joint_posterior_marginals * self.cached_log_transmat))
        return energy

    def calculate_elbo(self):
        return self.calculate_variational_energy() - self.calculate_variational_entropy()

    def calculate_expected_log_likelihood(self, sample=None):
        """Likelihood-only expected log joint over sampled segments (bpmodel.pyx:1125-1157)."""
        ll_tot = self.log_likelihood_total()
        ll_alle = self.log_likelihood_allele()
        if sample is None:
            sample = np.ones(self.num_segments)
        sample = np.asarray(sample, dtype=np.float64)
        energy = float(np.einsum('n,ns,nu,nsu->', sample, self.posterior_marginals,
                                 self.p_outlier_total, ll_tot))
        energy += float(np.einsum('n,ns,nv,nw,nsvw->', sample, self.posterior_marginals,
                                  self.p_outlier_allele, self.p_allele_swap, ll_alle))
        return energy

    def calculate_expected_log_likelihood_partial_h(self, sample=None):
        """Analytic gradient of expected log likelihood wrt h (bpmodel.pyx:1159-1195)."""
        if sample is None:
            sample = np.ones(self.num_segments)
        sample = np.asarray(sample, dtype=np.float64)

        # total part
        mu = self._expected_total_reads()
        hdel_override = (not self.normal_contamination) & (self.is_hdel == 1)
        r = np.stack([np.full(mu.shape, self.negbin_r_0), np.full(mu.shape, self.negbin_r_1)], -1)
        dmu = negbin_log_likelihood_partial_mu(
            self.x[:, None, None], np.where(hdel_override, 1.0, mu)[..., None], r)
        dmu = np.where(hdel_override[..., None], 0.0, dmu)
        dmu = np.where(self.total_likelihood_mask[:, None, None] == 0, 0.0, dmu)
        dmu_dh = self.l[:, None, None] * self.cn_states_total  # (N, S, M)
        partial = np.einsum('n,ns,nu,nsu,nsm->m', sample, self.posterior_marginals,
                            self.p_outlier_total, dmu, dmu_dh)

        # allele part
        minor = np.einsum('nsm,m->ns', self.cn_states[:, :, :, 0], self.h)
        total = np.einsum('nsm,m->ns', self.cn_states_total, self.h)
        p = self._expected_allele_ratio()
        loh_override = (not self.normal_contamination) & (self.is_loh == 1)
        total_reads = self.y[:, 0] + self.y[:, 1]
        valid = ((self.allele_likelihood_mask == 1)[:, None]
                 & ~loh_override
                 & (total_reads > 0)[:, None])
        p_safe = np.where(valid & (p > 0) & (p < 1), p, 0.5)
        Mv = np.stack([np.full(p.shape, self.betabin_M_0), np.full(p.shape, self.betabin_M_1)], -1)
        dp_dh = (self.cn_states[:, :, :, 0] * total[..., None]
                 - minor[..., None] * self.cn_states_total) / np.where(
                     total > 0, total, 1.0)[..., None] ** 2  # (N, S, M)
        for v in range(2):
            for w in range(2):
                dll_dp = betabin_log_likelihood_partial_p(
                    self.y[:, w][:, None], total_reads[:, None], p_safe, Mv[..., v])
                dll_dp = np.where(valid & (p_safe == p), dll_dp, 0.0)
                partial += np.einsum('n,ns,n,n,ns,nsm->m', sample, self.posterior_marginals,
                                     self.p_outlier_allele[:, v], self.p_allele_swap[:, w],
                                     dll_dp, dp_dh)
        return partial

    # -- decoding ------------------------------------------------------------

    def infer_cn(self):
        """Viterbi decode of the optimal copy-number sequence (bpmodel.pyx:1197-1210).

        Uses the framelogprob/log_transmat stored by the last update_p_cn call
        (the reference does not refresh them after the final EM parameter
        updates). Note: the reference's allele-swap application loop reassigns
        its own loop variable and is therefore a no-op — states are emitted
        unswapped. We reproduce that behavior (and document it) for parity.
        """
        state_sequence, _ = max_product(self.framelogprob, self.log_transmat)
        cn = self.cn_states[np.arange(self.num_segments), state_sequence]
        return cn, state_sequence
