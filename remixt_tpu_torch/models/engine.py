"""Variational inference engine (torch), restart-batched.

Counterpart of ``remixt_tpu/models/engine.py``: the same model, the same
factored state space and transition banks, written for PyTorch.

* Every function takes tensors with an explicit leading restart axis R
  where the JAX engine vmaps over restarts; ``Params`` and ``VState`` are
  NamedTuples of such tensors.
* Segments fall into a few classes (distinct germline copy-number rows);
  per-class (C, S, ...) planes are gathered by a per-segment class id.
* The per-pair (S, S) transition log-weight matrices take ``1 + C² + J``
  distinct values: the zero matrix (telomere cut), one matrix per class
  pair, and one per breakend, which depends on q(brk).
* Each sweep builds ONE exp-space breakend bank (R, J, S, S), restart-major
  and unpadded, shared by the chain update (the forward-backward kernel of
  ``ops/fb_grouped.py``) and the breakpoint update — the structure of the
  JAX engine's kernel path.
* The single-restart API of the JAX engine (``update_p_cn``,
  ``variational_sweep(s)``, ``calculate_elbo``, ...) takes one restart's
  NamedTuples, without the restart axis, and runs as R=1 views of the
  batched functions; only its chain update has a kernel of its own
  (``ops/fb_chains.py``).
* ``ModelSpec.use_kernels`` picks the chain update's route, as the JAX
  ``spec.use_pallas`` does: the hand kernels' wrappers (CUDA tensors launch
  the kernel, CPU tensors take its plain version), or the plain scan of
  ``ops/fb_scan.py``, the JAX package's XLA scan, under the log-space bank.
  A float64 engine on the card takes the scan.

Emission special cases (hdel / LOH / masks / zero-count segments) are
encoded as boolean planes with double-``where`` guards, so
``torch.autograd`` stays NaN-free.
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from remixt_tpu_torch.device import resolve_device
from remixt_tpu_torch.models import states as states_mod
from remixt_tpu_torch.ops import fb_chains, fb_grouped, fb_scan
from remixt_tpu_torch.ops.special import (
    exp_normalize, lgamma_shift, plogp)


class Params(NamedTuple):
    """Model parameters; leading restart axis R on every field in the
    batched engine (scalars are (R,), h is (R, M), masks (R, N))."""
    h: Any
    negbin_r_0: Any
    negbin_r_1: Any
    negbin_hdel_mu: Any
    negbin_hdel_r_0: Any
    negbin_hdel_r_1: Any
    betabin_M_0: Any
    betabin_M_1: Any
    betabin_loh_p: Any
    betabin_loh_M_0: Any
    betabin_loh_M_1: Any
    divergence_weight: Any
    total_mask: Any
    allele_mask: Any


class VState(NamedTuple):
    """Variational distributions + cached chain quantities (leading R).

    ``chain_scale`` is 0 before the first chain update: the stored
    framelogprob/alphas/betas then reproduce the reference's
    construction-time state so the initial ELBO matches exactly.
    """
    p_breakpoint: Any            # (K, B)
    p_breakpoint_used: Any       # (K, B)
    posterior_marginals: Any     # (N, S)
    alphas: Any                  # (N, S)
    betas: Any                   # (N, S)
    framelogprob: Any            # (N, S)
    hmm_log_norm_const: Any      # scalar
    chain_scale: Any             # scalar 0.0 / 1.0
    p_allele_swap: Any           # (N, 2)
    p_outlier_total: Any         # (N, 2)
    p_outlier_allele: Any        # (N, 2)


def stack(items):
    """Stack single-restart NamedTuples on a new leading restart axis."""
    return type(items[0])(*[torch.stack(xs) for xs in zip(*items)])


def take(tree, r):
    """Restart ``r`` of a batched NamedTuple (no restart axis)."""
    return type(tree)(*[x[r] for x in tree])


def one(tree):
    """One restart's NamedTuple as a batch of one (a view)."""
    return type(tree)(*[x[None] for x in tree])


class ModelSpec:
    """Static per-problem data: state space, chain structure, data vectors.

    Built on the host from the same construction arguments as the JAX
    ``ModelSpec``; arrays live on ``device`` in ``dtype``. ``device=None``
    means CUDA and raises without a CUDA device, as every entry point.

    ``use_kernels``: ``None`` means the hand kernels, except for float64
    on CUDA, which takes the plain scan; ``False`` the scan on any device;
    ``True`` the kernels (a float64 CUDA tensor then raises in the
    wrapper).
    """

    def __init__(self,
                 cn_states,            # (N, S, M, 2) int
                 brk_states,           # (B, M) int
                 l, x, y,              # (N,), (N,), (N,2)
                 is_telomere,          # (N,)
                 breakpoint_idx,       # (N,)
                 breakpoint_orient,    # (N,)
                 transition_penalty,
                 normal_contamination,
                 transition_model=0,
                 dtype=torch.float32,
                 device=None,
                 xi_chunk=256,
                 use_kernels=None):
        cn_states = np.asarray(cn_states, dtype=np.int64)
        brk_states = np.asarray(brk_states, dtype=np.int64)
        N, S, M, _ = cn_states.shape
        B = brk_states.shape[0]
        is_telomere = np.asarray(is_telomere, dtype=np.int64)
        breakpoint_idx = np.asarray(breakpoint_idx, dtype=np.int64)
        breakpoint_orient = np.asarray(breakpoint_orient, dtype=np.int64)

        self.N, self.S, self.M, self.B = N, S, M, B
        self.K = (int(breakpoint_idx.max() + 1)
                  if np.any(breakpoint_idx >= 0) else 0)
        self.cn_max = int(max(cn_states.max(), brk_states.max()))
        self.normal_contamination = bool(normal_contamination)
        self.transition_model = int(transition_model)
        self.transition_penalty = float(abs(transition_penalty))
        self.dtype = dtype
        self.device = resolve_device(device)
        self.xi_chunk = int(xi_chunk)
        self.use_kernels = (
            not (dtype == torch.float64 and self.device.type == 'cuda')
            if use_kernels is None else bool(use_kernels))

        if np.any((breakpoint_idx >= 0) & (is_telomere == 1)):
            raise ValueError('a breakend junction cannot be a telomere')

        # ---- segment classes: distinct state tensors -----------------------
        tumour = cn_states[:, :, 1:, :]
        if not np.all(tumour == tumour[0]):
            raise ValueError('tumour state block must be segment-invariant')
        normal_rows = cn_states[:, 0, 0, :]
        uniq_rows, seg_class = np.unique(normal_rows, axis=0,
                                         return_inverse=True)
        seg_class = seg_class.reshape(-1)
        C = uniq_rows.shape[0]
        self.C = C
        self.seg_class_np = seg_class.astype(np.int32)

        class_cn = np.zeros((C, S, M, 2), dtype=np.int64)
        class_cn[:, :, 1:, :] = tumour[0][None]
        class_cn[:, :, 0, :] = uniq_rows[:, None, :]
        self.class_cn_np = class_cn
        class_total = class_cn.sum(axis=-1)          # (C, S, M)

        ind = states_mod.state_indicators(class_cn)
        class_is_hdel = ind['is_hdel'].astype(bool)  # (C, S)
        class_is_loh = ind['is_loh'].astype(bool)
        nas = ind['num_alleles_subclonal'][0]

        nc = self.normal_contamination
        hdel_override = (class_is_hdel[seg_class] if not nc
                         else np.zeros((N, S), dtype=bool))
        loh_override = (class_is_loh[seg_class] if not nc
                        else np.zeros((N, S), dtype=bool))

        be_n = np.where(breakpoint_idx[:N - 1] >= 0)[0]
        # breakends on the final segment have no following pair
        self.J = J = be_n.shape[0]

        # ---- transition tables --------------------------------------------
        T = self.cn_max + 1
        D = self.cn_max + 1
        d_vals = np.arange(-D, D + 1)
        self.T, self.Dn = T, d_vals.shape[0]

        def f_trans(dv):
            if self.transition_model == 0:
                return np.abs(dv).astype(np.float64)
            return (dv != 0).astype(np.float64)

        orient_vals = np.array([-1, 1])
        F = f_trans(d_vals[None, None, :, None]
                    - orient_vals[:, None, None, None]
                    * brk_states.T[None, :, None, :])    # (2, M, Dn, B)

        t = np.arange(T)
        dsel = t[:, None] - t[None, :] + D
        didx = np.zeros((T, T, self.Dn))
        didx[t[:, None].repeat(T, 1), t[None, :].repeat(T, 0),
             t[:, None] - t[None, :] + D] = 1.0

        Ecls = np.zeros((C, M, S, T))
        cc, ss, mm = np.meshgrid(np.arange(C), np.arange(S), np.arange(M),
                                 indexing='ij')
        Ecls[cc.transpose(0, 2, 1), mm.transpose(0, 2, 1),
             ss.transpose(0, 2, 1), class_total.transpose(0, 2, 1)] = 1.0

        # ---- static bank: telomere zeros + per-class-pair plain matrices ---
        tp = self.transition_penalty
        A = np.zeros((C, C, S, S))
        P = np.zeros((C, C, S, S))
        for c1 in range(C):
            for c2 in range(C):
                dT = class_total[c1][:, None, :] - class_total[c2][None, :, :]
                total_term = f_trans(dT).sum(axis=-1)
                cn1 = class_cn[c1]
                cn2 = class_cn[c2]
                noflip = f_trans(cn1[:, None, :, :]
                                 - cn2[None, :, :, :]).sum(axis=(-2, -1))
                flip = f_trans(cn1[:, None, :, :]
                               - cn2[None, :, :, ::-1]).sum(axis=(-2, -1))
                A[c1, c2] = -tp * np.minimum(noflip - total_term,
                                             flip - total_term)
                P[c1, c2] = -tp * total_term
        static_bank = np.zeros((1 + C * C, S, S))
        static_bank[1:] = (A + P).reshape(C * C, S, S)
        self.num_static_bank = 1 + C * C
        self.num_bank = self.num_static_bank + J

        bank_idx = np.zeros(N - 1, dtype=np.int32)
        plain = (is_telomere[:N - 1] == 0) & (breakpoint_idx[:N - 1] < 0)
        bank_idx[plain] = (1 + seg_class[:N - 1][plain] * C
                           + seg_class[1:][plain])
        bank_idx[be_n] = self.num_static_bank + np.arange(J)
        self.bank_idx_np = bank_idx
        # xi dots: breakend pairs point at the zero telomere entry (their
        # contributions come from the breakend-side pass)
        xi_static_idx = bank_idx.copy()
        xi_static_idx[be_n] = 0

        # ---- chain batching -------------------------------------------------
        tel_pairs = np.where(is_telomere[:N - 1] == 1)[0]
        bounds = np.concatenate([[0], tel_pairs + 1, [N]])
        starts, ends = bounds[:-1], bounds[1:]
        lengths = ends - starts
        Q, L = len(starts), int(lengths.max())
        self.Q, self.L = Q, L
        chain_seg_map = np.full((Q, L), N, dtype=np.int32)
        chain_bank_idx = np.zeros((Q, max(L - 1, 1)), dtype=np.int32)
        for q, (s, e) in enumerate(zip(starts, ends)):
            chain_seg_map[q, :e - s] = np.arange(s, e)
            if e - s > 1:
                chain_bank_idx[q, :e - s - 1] = bank_idx[s:e - 1]

        # ---- device arrays -----------------------------------------------
        dev = self.device

        def fl(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        def ix(a, dt=torch.long):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        def bl(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.bool,
                                   device=dev)

        self.num_alleles_subclonal = fl(nas)                  # (S,)
        self.hdel_override = bl(hdel_override)
        self.loh_override = bl(loh_override)
        self.is_hdel_plane = bl(class_is_hdel[seg_class])
        self.is_loh_plane = bl(class_is_loh[seg_class])
        self.seg_class = ix(seg_class)
        self.is_telomere = ix(is_telomere)
        self.be_n = ix(be_n)
        self.be_k = ix(breakpoint_idx[be_n])
        self.be_orient01 = ix((breakpoint_orient[be_n] > 0).astype(np.int64))
        self.be_c1 = ix(seg_class[be_n])
        self.be_c2 = ix(seg_class[be_n + 1])
        self.F = fl(F)
        self.dsel = ix(dsel)
        self.didx_onehot = fl(didx)
        self.Ecls = fl(Ecls)
        self.A = fl(A)
        self.expA = fl(np.exp(A))
        self.static_bank = fl(static_bank)
        self.bank_idx = ix(bank_idx)
        self.xi_static_idx = ix(xi_static_idx)
        self.restart_plan = fb_scan.build_restart_plan(
            chain_bank_idx, self.num_static_bank)
        self.chain_seg_map = ix(chain_seg_map)
        self.chain_bank_idx = ix(chain_bank_idx, torch.int32)
        self.chain_last = ix((lengths - 1).astype(np.int64))
        self.l = fl(l)
        self.x = fl(x)
        self.y = fl(y)
        self.total_reads = fl(np.asarray(y).sum(axis=-1))
        self.brk_states = ix(brk_states)
        self.class_total_f = fl(class_total)                  # (C, S, M)
        self.class_minor_f = fl(class_cn[:, :, :, 0])
        self.prior_outlier_total = 0.01
        self.prior_outlier_allele = 0.01

    # -- initial values (one restart; stack() adds the restart axis) --------

    def init_params(self, h_init, divergence_weight,
                    total_mask=None, allele_mask=None):
        def sc(v):
            return torch.tensor(v, dtype=self.dtype, device=self.device)

        ones = torch.ones(self.N, dtype=self.dtype, device=self.device)

        def mask(m):
            return ones if m is None else torch.as_tensor(
                np.asarray(m), dtype=self.dtype, device=self.device)

        return Params(
            h=torch.as_tensor(np.asarray(h_init), dtype=self.dtype,
                              device=self.device),
            negbin_r_0=sc(500.0),
            negbin_r_1=sc(10.0),
            negbin_hdel_mu=sc(1e-5),
            negbin_hdel_r_0=sc(10.0),
            negbin_hdel_r_1=sc(1.0),
            betabin_M_0=sc(500.0),
            betabin_M_1=sc(10.0),
            betabin_loh_p=sc(1e-3),
            betabin_loh_M_0=sc(10.0),
            betabin_loh_M_1=sc(1.0),
            divergence_weight=sc(abs(divergence_weight)),
            total_mask=mask(total_mask),
            allele_mask=mask(allele_mask),
        )

    def init_state(self, p_breakpoint=None):
        dt, dev = self.dtype, self.device
        N, S, K = self.N, self.S, self.K
        if p_breakpoint is None:
            # favour breakpoint states with at most one copy
            fav = (self.brk_states.cpu().numpy().max(axis=1) <= 1).astype(
                np.float64)
            p_breakpoint = np.tile(fav / fav.sum(), (K, 1))
        p_breakpoint = torch.as_tensor(np.asarray(p_breakpoint), dtype=dt,
                                       device=dev)

        def full(shape, v):
            return torch.full(shape, v, dtype=dt, device=dev)

        def prior(p):
            return torch.tensor([1 - p, p], dtype=dt, device=dev).repeat(N, 1)

        return VState(
            p_breakpoint=p_breakpoint,
            p_breakpoint_used=p_breakpoint.clone(),
            posterior_marginals=full((N, S), 1.0 / S),
            alphas=full((N, S), 0.0),
            betas=full((N, S), 0.0),
            framelogprob=full((N, S), 1.0),
            hmm_log_norm_const=full((), 0.0),
            chain_scale=full((), 0.0),
            p_allele_swap=full((N, 2), 0.5),
            p_outlier_total=prior(self.prior_outlier_total),
            p_outlier_allele=prior(self.prior_outlier_allele),
        )


# ===========================================================================
# emission model
# ===========================================================================
#
# Emission planes are evaluated for parameters with shape (R, *C) — C the
# candidate axes of the M-step grid searches (none in the sweeps) — over
# per-segment rows of shape (1 or R, n): all N segments, shared by the
# restarts, or a per-restart subsample. Rows get singleton candidate axes
# so everything broadcasts to planes of shape (R, *C, n, S).

def _rows(spec, params, idx=None, extra=0):
    """Per-segment arrays the emissions read, with ``extra`` singleton
    candidate axes after the restart axis. ``idx`` (R, k) gathers a
    per-restart subsample."""
    fields = dict(
        seg_class=spec.seg_class, l=spec.l, x=spec.x, y=spec.y,
        total_reads=spec.total_reads, hdel_override=spec.hdel_override,
        loh_override=spec.loh_override, is_hdel_plane=spec.is_hdel_plane)
    if idx is None:
        rows = {k: v[None] for k, v in fields.items()}
        rows['total_mask'] = params.total_mask
        rows['allele_mask'] = params.allele_mask
    else:
        rows = {k: v[idx] for k, v in fields.items()}
        rows['total_mask'] = torch.gather(params.total_mask, 1, idx)
        rows['allele_mask'] = torch.gather(params.allele_mask, 1, idx)
    return {k: v.reshape(v.shape[:1] + (1,) * extra + v.shape[1:])
            for k, v in rows.items()}


def _param(params, name, extra):
    """Scalar parameter (R, *c) → (R, *c, 1.., 1, 1) broadcasting against
    (R, *C, n, S) planes."""
    x = getattr(params, name)
    return x.reshape(x.shape + (1,) * (1 + extra - x.dim() + 2))


class _ClassGather(torch.autograd.Function):
    """``torch.gather`` of per-class rows (..., C, S) by a per-segment
    class index (..., n, S), whose gradient sums each class's segments by a
    one-hot contraction. ``torch.gather``'s own backward adds them with
    ``scatter_add_``, whose CUDA atomics add in another order on every run:
    with a few classes for hundreds of segments, the h update's gradient,
    and from it the fit, then changes from run to run."""

    @staticmethod
    def forward(ctx, per_class, index):
        ctx.save_for_backward(index)
        ctx.num_classes = per_class.shape[-2]
        return torch.gather(per_class, -2, index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        classes = torch.arange(ctx.num_classes, device=index.device)
        onehot = (index[..., :1] == classes).to(grad.dtype)    # (..., n, C)
        return torch.einsum('...nc,...ns->...cs', onehot, grad), None


def _class_plane(table, h, seg_class, extra):
    """Per-class depth table (C, S, M)·h → per-segment plane (R, *C, n, S)."""
    h = h.reshape(h.shape[:-1] + (1,) * (1 + extra - (h.dim() - 1))
                  + h.shape[-1:])
    per_class = torch.einsum('csm,...m->...cs', table, h)   # (R,*c,C,S)
    shape = torch.broadcast_shapes(per_class.shape[:-2], seg_class.shape[:-1])
    per_class = per_class.expand(shape + per_class.shape[-2:])
    index = seg_class[..., None].expand(
        shape + (seg_class.shape[-1], per_class.shape[-1]))
    return _ClassGather.apply(per_class, index)


def _total_emission_plane(spec, params, rows, u, extra=0):
    """One outlier component's negative-binomial plane (R, *C, n, S).

    Double-where guard: masked segments and zero-mean lanes (zero-length
    dummy segments) contribute exactly 0 and cannot poison gradients."""
    depth_total = _class_plane(spec.class_total_f, params.h,
                               rows['seg_class'], extra)
    hdel = rows['hdel_override']
    mu = rows['l'][..., None] * depth_total
    mu_eff = torch.where(hdel, _param(params, 'negbin_hdel_mu', extra), mu)
    zero_tot = (rows['total_mask'] == 0)[..., None] | (mu_eff <= 0.0)
    mu_safe = torch.where(zero_tot, 1.0, mu_eff)

    x = rows['x']
    xc = x[..., None]
    r_plain, r_hdel = (('negbin_r_0', 'negbin_hdel_r_0'),
                       ('negbin_r_1', 'negbin_hdel_r_1'))[u]
    r_plain = _param(params, r_plain, extra)
    r_hdel = _param(params, r_hdel, extra)
    r = torch.where(hdel, r_hdel, r_plain)
    nb_p = mu_safe / (r + mu_safe)
    nb_p = torch.where((nb_p < 0.0) | (nb_p > 1.0), 0.5, nb_p)
    lg_r = torch.where(hdel, torch.lgamma(r_hdel), torch.lgamma(r_plain))
    if spec.dtype == torch.float32:
        # float32: the count lgammas reach ~2e6 at whole-genome read
        # counts; lgamma_shift combines them cancellation-free and the log
        # terms are rewritten so nothing is evaluated near log(1) at huge x
        count_term = torch.where(hdel, lgamma_shift(xc, r_hdel),
                                 lgamma_shift(xc, r_plain)) - lg_r
        ll = (count_term - xc * torch.log1p(r / mu_safe)
              + r * (torch.log(r) - torch.log(r + mu_safe)))
    else:
        lg_x1 = torch.lgamma(x + 1.0)[..., None]
        lg_xr = torch.where(hdel, torch.lgamma(xc + r_hdel),
                            torch.lgamma(xc + r_plain))
        ll = (lg_xr - lg_x1 - lg_r
              + xc * torch.log(nb_p) + r * torch.log1p(-nb_p))
    return torch.where(zero_tot, 0.0, ll)


def _allele_emission_plane(spec, params, rows, k, extra=0):
    """One (outlier v, swap w) component's beta-binomial plane
    (R, *C, n, S), k = v·2 + w, with the hdel/LOH overrides."""
    depth_total = _class_plane(spec.class_total_f, params.h,
                               rows['seg_class'], extra)
    depth_minor = _class_plane(spec.class_minor_f, params.h,
                               rows['seg_class'], extra)
    loh_p = _param(params, 'betabin_loh_p', extra)

    safe_total = torch.where(depth_total > 0, depth_total, 1.0)
    p = torch.where(depth_total > 0, depth_minor / safe_total, 0.0)
    p = torch.where(rows['is_hdel_plane'], 0.0, p)
    p = torch.where(rows['loh_override'],
                    torch.where(p == 0.0, loh_p, 1.0 - loh_p), p)

    zero = ((rows['total_reads'] == 0)[..., None]
            | (rows['allele_mask'] == 0)[..., None]
            | (p <= 0.0) | (p >= 1.0))
    p_safe = torch.where(zero, 0.5, p)

    loh = rows['loh_override']
    tr = rows['total_reads'][..., None]
    v, w = divmod(k, 2)
    M_plain, M_loh = (('betabin_M_0', 'betabin_loh_M_0'),
                      ('betabin_M_1', 'betabin_loh_M_1'))[v]
    M_plain = _param(params, M_plain, extra)
    M_loh = _param(params, M_loh, extra)
    Mv = torch.where(loh, M_loh, M_plain)
    Mp = Mv * p_safe
    Mq = Mv * (1.0 - p_safe)
    lg_Mp = torch.lgamma(Mp)
    lg_Mq = torch.lgamma(Mq)
    lg_M = torch.where(loh, torch.lgamma(M_loh), torch.lgamma(M_plain))
    kk = rows['y'][..., w][..., None]
    if spec.dtype == torch.float32:
        # float32: pair each large-argument lgamma with its count lgamma
        # through the cancellation-free lgamma_shift (exact algebra)
        ll = (lgamma_shift(kk, Mp) - lg_Mp
              + lgamma_shift(tr - kk, Mq) - lg_Mq
              - torch.where(loh, lgamma_shift(tr, M_loh),
                            lgamma_shift(tr, M_plain)) + lg_M)
    else:
        lg_trM = torch.where(loh, torch.lgamma(tr + M_loh),
                             torch.lgamma(tr + M_plain))
        lg_tr1 = torch.lgamma(tr + 1.0)
        lg_k1 = torch.lgamma(kk + 1.0)
        lg_nk1 = torch.lgamma(tr - kk + 1.0)
        ll = (lg_tr1 - lg_k1 - lg_nk1
              + torch.lgamma(kk + Mp) + torch.lgamma(tr - kk + Mq)
              - lg_trM - lg_Mp - lg_Mq + lg_M)
    return torch.where(zero, 0.0, ll)


def emission_tensors(spec, params_b):
    """ll_total (R, 2, N, S) and ll_allele (R, 4, N, S), component-major."""
    rows = _rows(spec, params_b)
    ll_tot = torch.stack([_total_emission_plane(spec, params_b, rows, u)
                          for u in range(2)], dim=1)
    ll_alle = torch.stack([_allele_emission_plane(spec, params_b, rows, k)
                           for k in range(4)], dim=1)
    return ll_tot, ll_alle


def log_prior_cn(spec, params_b):
    """Divergence prior per (r, n, s)."""
    return (-spec.num_alleles_subclonal[None, None, :]
            * spec.l[None, :, None]
            * params_b.divergence_weight[:, None, None])


def _allele_mix_weights(p_outlier_allele, p_allele_swap):
    """(..., n, 4) outlier×swap mixture weights, k = v·2 + w."""
    w4 = p_outlier_allele[..., :, None] * p_allele_swap[..., None, :]
    return w4.reshape(w4.shape[:-2] + (4,))


def _mix_framelogprob(spec, params_b, state_b, ll_tot, ll_alle):
    frame = torch.einsum('runs,rnu->rns', ll_tot, state_b.p_outlier_total)
    frame = frame + torch.einsum(
        'rkns,rnk->rns', ll_alle,
        _allele_mix_weights(state_b.p_outlier_allele, state_b.p_allele_swap))
    return frame + log_prior_cn(spec, params_b)


# ===========================================================================
# transition banks
# ===========================================================================

def breakend_tot_expectation(spec, p_breakpoint_b):
    """Expected total-copy transition penalty per breakend, (R, J, S, S):
    w[r,j,m,d] = E_q(brk)[f(d − orient_j·b_m)], expanded to (S, S) through
    one-hot total matmuls."""
    pj = p_breakpoint_b[:, spec.be_k]                     # (R, J, B)
    Fj = spec.F[spec.be_orient01]                         # (J, M, Dn, B)
    w = torch.einsum('rjb,jmdb->rjmd', pj, Fj)            # (R, J, M, Dn)
    Wmat = w[:, :, :, spec.dsel]                          # (R, J, M, T, T)
    E1 = spec.Ecls[spec.be_c1]                            # (J, M, S, T)
    E2 = spec.Ecls[spec.be_c2]
    left = torch.einsum('jmst,rjmtu->rjsmu', E1, Wmat)
    R, J, S = left.shape[:3]
    right = E2.permute(0, 1, 3, 2).reshape(J, -1, S)      # (J, M·T, S)
    # a broadcast matmul writes the bank contiguous and restart-major, the
    # layout the chain kernel reads
    return torch.matmul(left.reshape(R, J, S, -1), right)


def breakend_tmats(spec, p_breakpoint_b):
    """Per-breakend transition log-weight matrices (R, J, S, S)."""
    R = p_breakpoint_b.shape[0]
    if spec.J == 0:
        return spec.static_bank.new_zeros((R, 0, spec.S, spec.S))
    tot = breakend_tot_expectation(spec, p_breakpoint_b)
    # in place: the bank is the only full-size buffer
    return tot.mul_(-spec.transition_penalty).add_(
        spec.A[spec.be_c1, spec.be_c2])


def breakend_tmats_exp(spec, p_breakpoint_b):
    """Exp-space breakend transition weights (R, J, S, S):
    ``exp(-tp·tot) * expA``, built in place so the bank is the only
    full-size buffer (2.4 GB at the whole-genome wave)."""
    R = p_breakpoint_b.shape[0]
    if spec.J == 0:
        return spec.static_bank.new_zeros((R, 0, spec.S, spec.S))
    tot = breakend_tot_expectation(spec, p_breakpoint_b)
    tot.mul_(-spec.transition_penalty).exp_()
    return tot.mul_(spec.expA[spec.be_c1, spec.be_c2])


def full_bank(spec, p_breakpoint):
    """Single-restart log bank (num_static + J, S, S)."""
    be = breakend_tmats(spec, p_breakpoint[None])[0]
    return torch.cat([spec.static_bank, be], dim=0)


# ===========================================================================
# pairwise marginal statistics
# ===========================================================================

def _breakend_u(spec, state_b):
    """Max-shifted linear left/right messages at every breakend pair,
    (R, J, S) each."""
    n = spec.be_n
    a = state_b.alphas[:, n]
    fb = state_b.framelogprob[:, n + 1] + state_b.betas[:, n + 1]
    u_a = torch.exp(a - a.amax(dim=-1, keepdim=True))
    u_fb = torch.exp(fb - fb.amax(dim=-1, keepdim=True))
    return u_a, u_fb


def _breakend_cmat(spec, u_a, u_fb, E):
    """Unnormalized per-clone total-copy joint histogram at every breakend
    pair, (R, J, M, T, T): E1ᵀ·diag(u_a)·E·diag(u_fb)·E2, without forming
    the pairwise marginals."""
    E1 = spec.Ecls[spec.be_c1]                            # (J, M, S, T)
    E2 = spec.Ecls[spec.be_c2]
    left = E1[None] * u_a[:, :, None, :, None]            # (R, J, M, S, T)
    right = E2[None] * u_fb[:, :, None, :, None]
    mid = torch.einsum('rjsz,rjmzu->rjmsu', E, right)
    return torch.einsum('rjmst,rjmsu->rjmtu', left, mid)


def breakend_cn_diff_marginals(spec, state_b, exp_tm_used_b):
    """Per-breakend histogram of total-copy differences under the pairwise
    chain marginals, (R, J, M, Dn), without materializing xi. Rows of E
    sum to one, so Σ_tu Cmat[j, m] = Σ_sz xi_j for every m recovers the
    normalizer."""
    u_a, u_fb = _breakend_u(spec, state_b)
    Cmat = _breakend_cmat(spec, u_a, u_fb, exp_tm_used_b)
    denom = Cmat[:, :, 0].sum(dim=(-2, -1))
    denom = torch.clamp(denom, min=torch.finfo(Cmat.dtype).tiny)
    p_d = torch.einsum('rjmtu,tud->rjmd', Cmat, spec.didx_onehot)
    return p_d / denom[:, :, None, None]


def xi_transition_dots_restarts(spec, state_b):
    """Transition contractions of the pairwise marginals, (R,) each:
    dot_used against the bank the chain ran under (entropy), dot_cur
    against the bank of the current q(brk) (energy).

    Static pairs gather the static bank once per chunk of pairs, shared by
    all restarts; the chunking bounds the transients. Breakend pairs go
    through the xi-free one-hot factoring. ``chain_scale`` ∈ {0, 1} per
    restart enters through selects."""
    R = state_b.alphas.shape[0]
    dtype = state_b.alphas.dtype
    scale = state_b.chain_scale
    tiny = torch.finfo(dtype).tiny
    npair = spec.N - 1
    if npair <= 0:
        zero = state_b.alphas.new_zeros(R)
        return zero, zero

    chunk = min(spec.xi_chunk, npair)
    a = state_b.alphas[:, :npair]
    fb = state_b.framelogprob[:, 1:] + state_b.betas[:, 1:]
    static_sel = state_b.alphas.new_zeros(R)
    for c0 in range(0, npair, chunk):
        ci = spec.xi_static_idx[c0:c0 + chunk]
        ca = a[:, c0:c0 + chunk]
        cfb = fb[:, c0:c0 + chunk]
        Bc = spec.static_bank[ci]                         # (c, S, S)
        expBc = torch.exp(Bc)
        Gc = expBc * Bc
        u_a = torch.exp(ca - ca.amax(dim=-1, keepdim=True))
        u_fb = torch.exp(cfb - cfb.amax(dim=-1, keepdim=True))
        sE = (u_a * torch.einsum('csz,rcz->rcs', expBc, u_fb)).sum(-1)
        sG = (u_a * torch.einsum('csz,rcz->rcs', Gc, u_fb)).sum(-1)
        sB = (u_a * torch.einsum('csz,rcz->rcs', Bc, u_fb)).sum(-1)
        s0 = u_a.sum(-1) * u_fb.sum(-1)
        # scale=1: xi under exp(B), numerator expB⊙B; scale=0: xi under
        # the ones bank, numerator B
        ratio = torch.where(scale[:, None] > 0,
                            sG / torch.clamp(sE, min=tiny),
                            sB / torch.clamp(s0, min=tiny))
        static_sel = static_sel + ratio.sum(-1)
    dot_used = scale * static_sel
    dot_cur = static_sel

    if spec.J:
        be_used, be_cur = _xi_breakend_dots_restarts(spec, state_b)
        dot_used = dot_used + be_used
        dot_cur = dot_cur + be_cur
    return dot_used, dot_cur


def _xi_breakend_dots_restarts(spec, state_b):
    """Breakend pairs' contribution to the xi transition dots, (R,) each:
    ⟨xi, tot⟩ from the per-clone total-difference marginals and the q(brk)
    penalty expectations, ⟨xi, A⟩ = u_aᵀ(E ⊙ A_j)u_fb / z. Both scale
    branches are evaluated and selected per restart."""
    dtype = state_b.alphas.dtype
    scale = state_b.chain_scale
    tiny = torch.finfo(dtype).tiny
    tp = spec.transition_penalty

    u_a, u_fb = _breakend_u(spec, state_b)
    E = breakend_tmats_exp(spec, state_b.p_breakpoint_used)   # (R, J, S, S)
    A_g = spec.A[spec.be_c1, spec.be_c2]                      # (J, S, S)

    z1 = (u_a * torch.einsum('rjsz,rjz->rjs', E, u_fb)).sum(-1)
    numA1 = (u_a * torch.einsum('rjsz,rjz->rjs', E * A_g[None], u_fb)).sum(-1)
    z0 = u_a.sum(-1) * u_fb.sum(-1)
    numA0 = (u_a * torch.einsum('jsz,rjz->rjs', A_g, u_fb)).sum(-1)
    ratioA = torch.where(scale[:, None] > 0,
                         numA1 / torch.clamp(z1, min=tiny),
                         numA0 / torch.clamp(z0, min=tiny)).sum(-1)

    Cmat1 = _breakend_cmat(spec, u_a, u_fb, E)
    del E
    p_d1 = (torch.einsum('rjmtu,tud->rjmd', Cmat1, spec.didx_onehot)
            / torch.clamp(z1, min=tiny)[:, :, None, None])
    E1 = spec.Ecls[spec.be_c1]
    E2 = spec.Ecls[spec.be_c2]
    left0 = torch.einsum('jmst,rjs->rjmt', E1, u_a)
    right0 = torch.einsum('jmzu,rjz->rjmu', E2, u_fb)
    p_d0 = (torch.einsum('rjmt,rjmu,tud->rjmd', left0, right0,
                         spec.didx_onehot)
            / torch.clamp(z0, min=tiny)[:, :, None, None])
    p_d = torch.where(scale[:, None, None, None] > 0, p_d1, p_d0)

    Fj = spec.F[spec.be_orient01]                             # (J, M, Dn, B)
    w_used = torch.einsum('rjb,jmdb->rjmd',
                          state_b.p_breakpoint_used[:, spec.be_k], Fj)
    w_cur = torch.einsum('rjb,jmdb->rjmd',
                         state_b.p_breakpoint[:, spec.be_k], Fj)
    tot_used = torch.einsum('rjmd,rjmd->r', p_d, w_used)
    tot_cur = torch.einsum('rjmd,rjmd->r', p_d, w_cur)

    dot_used = scale * (-tp * tot_used + ratioA)
    dot_cur = -tp * tot_cur + ratioA
    return dot_used, dot_cur


# ===========================================================================
# variational updates (reference update order)
# ===========================================================================

def update_p_allele_swap_restarts(spec, state_b, ll_alle):
    R, N = state_b.p_allele_swap.shape[:2]
    t4 = torch.einsum('rkns,rns->rnk', ll_alle,
                      state_b.posterior_marginals).reshape(R, N, 2, 2)
    log_p = torch.einsum('rnvw,rnv->rnw', t4, state_b.p_outlier_allele)
    return state_b._replace(p_allele_swap=exp_normalize(log_p, dim=-1))


def _with_chain(state, frame, alphas, betas, log_norm):
    """State after a chain update, batched or not: the posteriors, the
    messages and the potentials the chain ran under."""
    return state._replace(
        posterior_marginals=exp_normalize(alphas + betas, dim=-1),
        alphas=alphas,
        betas=betas,
        framelogprob=frame,
        hmm_log_norm_const=log_norm,
        chain_scale=torch.ones_like(log_norm),
        p_breakpoint_used=state.p_breakpoint,
    )


def update_p_cn_restarts(spec, params_b, state_b, ll_tot, ll_alle,
                         be_exp_b):
    """Chain update: mix the frames, run the restart-batched chain
    forward-backward: the kernel under the sweep's exp-space breakend bank,
    or the scan under the log-space bank of the same q(brk)."""
    frame_b = _mix_framelogprob(spec, params_b, state_b, ll_tot, ll_alle)
    if spec.use_kernels:
        alphas, betas, log_norm = fb_grouped.forward_backward_chains_grouped(
            frame_b, spec.static_bank, be_exp_b, spec.chain_bank_idx,
            spec.chain_seg_map, spec.chain_last)
    else:
        alphas, betas, log_norm = fb_scan.forward_backward_chains_restarts(
            frame_b, spec.static_bank,
            breakend_tmats(spec, state_b.p_breakpoint), spec.restart_plan,
            spec.chain_seg_map, spec.chain_last)
    return _with_chain(state_b, frame_b, alphas, betas, log_norm)


def update_p_breakpoint_restarts(spec, state_b, be_exp_b):
    """q(brk) update from the breakend pairwise marginals, consuming the
    bank the chain update of the same sweep ran under."""
    if spec.K == 0:
        return state_b
    R = state_b.p_breakpoint.shape[0]
    p_d = breakend_cn_diff_marginals(spec, state_b, be_exp_b)
    Fj = spec.F[spec.be_orient01]
    contrib = -spec.transition_penalty * torch.einsum(
        'rjmd,jmdb->rjb', p_d, Fj)
    log_p = contrib.new_zeros((R, spec.K, spec.B))
    log_p.index_add_(1, spec.be_k, contrib)
    return state_b._replace(p_breakpoint=exp_normalize(log_p, dim=-1))


def update_p_outlier_total_restarts(spec, state_b, ll_tot):
    log_p = torch.einsum('rns,runs->rnu', state_b.posterior_marginals, ll_tot)
    p = spec.prior_outlier_total
    prior = torch.log(torch.tensor([1.0 - p, p], dtype=log_p.dtype,
                                   device=log_p.device))
    return state_b._replace(
        p_outlier_total=exp_normalize(log_p + prior, dim=-1))


def update_p_outlier_allele_restarts(spec, state_b, ll_alle):
    R, N = state_b.p_allele_swap.shape[:2]
    t4 = torch.einsum('rkns,rns->rnk', ll_alle,
                      state_b.posterior_marginals).reshape(R, N, 2, 2)
    log_p = torch.einsum('rnvw,rnw->rnv', t4, state_b.p_allele_swap)
    p = spec.prior_outlier_allele
    prior = torch.log(torch.tensor([1.0 - p, p], dtype=log_p.dtype,
                                   device=log_p.device))
    return state_b._replace(
        p_outlier_allele=exp_normalize(log_p + prior, dim=-1))


def _sweep_restarts_with_emissions(spec, params_b, state_b, ll_tot, ll_alle):
    state_b = update_p_allele_swap_restarts(spec, state_b, ll_alle)
    # one exp-space breakend bank per sweep, shared by the chain update and
    # the breakpoint update (the chain ran under exactly these potentials)
    be_exp_b = breakend_tmats_exp(spec, state_b.p_breakpoint)
    state_b = update_p_cn_restarts(spec, params_b, state_b, ll_tot, ll_alle,
                                   be_exp_b)
    state_b = update_p_breakpoint_restarts(spec, state_b, be_exp_b)
    del be_exp_b
    state_b = update_p_outlier_total_restarts(spec, state_b, ll_tot)
    return update_p_outlier_allele_restarts(spec, state_b, ll_alle)


@torch.no_grad()
def variational_sweeps_restarts(spec, params_b, state_b, num_sweeps):
    """``num_sweeps`` restart-batched VI sweeps, emissions computed once."""
    ll_tot, ll_alle = emission_tensors(spec, params_b)
    for _ in range(num_sweeps):
        state_b = _sweep_restarts_with_emissions(
            spec, params_b, state_b, ll_tot, ll_alle)
    return state_b


# -- one restart: the JAX engine's single-restart API, as R=1 views ----------
#
# ``params`` and ``state`` carry no restart axis; ``ll_tot`` (2, N, S) and
# ``ll_alle`` (4, N, S) are one restart's emission planes.

def update_p_allele_swap(spec, params, state, ll_alle):
    return take(update_p_allele_swap_restarts(spec, one(state), ll_alle[None]),
                0)


def update_p_cn(spec, params, state, ll_tot, ll_alle, be_exp=None):
    """Chain update of one restart through the single-restart chain
    kernel, or the scan under the full log-space bank. ``be_exp`` (J, S,
    S) optionally supplies the kernel's exp-space breakend bank of
    ``state.p_breakpoint`` (the sweep builds it once and shares it with the
    breakpoint update)."""
    frame = _mix_framelogprob(spec, one(params), one(state), ll_tot[None],
                              ll_alle[None])[0]
    if not spec.use_kernels:
        alphas, betas, log_norm = fb_scan.forward_backward_chains(
            frame, full_bank(spec, state.p_breakpoint), spec.chain_bank_idx,
            spec.chain_seg_map, spec.chain_last)
        return _with_chain(state, frame, alphas, betas, log_norm)
    if be_exp is None:
        be_exp = breakend_tmats_exp(spec, state.p_breakpoint[None])[0]
    alphas, betas, log_norm = fb_chains.forward_backward_chains(
        frame, spec.static_bank, be_exp, spec.chain_bank_idx,
        spec.chain_seg_map, spec.chain_last)
    return _with_chain(state, frame, alphas, betas, log_norm)


def update_p_breakpoint(spec, params, state, exp_tm_used=None):
    """q(brk) update of one restart. Without ``exp_tm_used`` it builds
    the bank of ``state.p_breakpoint_used``, the ones bank before the first
    chain update (``chain_scale`` 0)."""
    if spec.K == 0:
        return state
    if exp_tm_used is None:
        exp_tm_used = breakend_tmats_exp(spec, state.p_breakpoint_used[None])[0]
        exp_tm_used = torch.where(state.chain_scale > 0, exp_tm_used,
                                  torch.ones_like(exp_tm_used))
    return take(update_p_breakpoint_restarts(spec, one(state),
                                             exp_tm_used[None]), 0)


def update_p_outlier_total(spec, params, state, ll_tot):
    return take(update_p_outlier_total_restarts(spec, one(state),
                                                ll_tot[None]), 0)


def update_p_outlier_allele(spec, params, state, ll_alle):
    return take(update_p_outlier_allele_restarts(spec, one(state),
                                                 ll_alle[None]), 0)


def _sweep_with_emissions(spec, params, state, ll_tot, ll_alle):
    state = update_p_allele_swap(spec, params, state, ll_alle)
    be_exp = breakend_tmats_exp(spec, state.p_breakpoint[None])[0]
    state = update_p_cn(spec, params, state, ll_tot, ll_alle, be_exp=be_exp)
    state = update_p_breakpoint(spec, params, state, exp_tm_used=be_exp)
    del be_exp
    state = update_p_outlier_total(spec, params, state, ll_tot)
    return update_p_outlier_allele(spec, params, state, ll_alle)


@torch.no_grad()
def variational_sweep(spec, params, state):
    """One sweep of one restart in the reference's update order: allele
    swap, chain, breakpoints, total outliers, allele outliers."""
    return variational_sweeps(spec, params, state, 1)


@torch.no_grad()
def variational_sweeps(spec, params, state, num_sweeps):
    """``num_sweeps`` VI sweeps of one restart, emissions computed once."""
    ll_tot, ll_alle = emission_tensors(spec, one(params))
    for _ in range(num_sweeps):
        state = _sweep_with_emissions(spec, params, state, ll_tot[0],
                                      ll_alle[0])
    return state


# ===========================================================================
# objectives
# ===========================================================================

def calculate_elbo_from_halves_restarts(spec, params_b, state_b,
                                        ll_total_half_b, ll_allele_half_b):
    """ELBO (R,) given the two emission-likelihood contractions. The
    entropy contracts the pairwise marginals with the bank they were
    computed under; the energy with the bank of the current q(brk)."""
    dot_used, dot_cur = xi_transition_dots_restarts(spec, state_b)
    marg = state_b.posterior_marginals
    pot, poa = state_b.p_outlier_total, state_b.p_outlier_allele
    po_t, po_a = spec.prior_outlier_total, spec.prior_outlier_allele

    entropy = -state_b.hmm_log_norm_const
    entropy = entropy + torch.einsum('rns,rns->r', marg, state_b.framelogprob)
    entropy = entropy + dot_used
    entropy = entropy + plogp(state_b.p_breakpoint).sum(dim=(1, 2))
    entropy = entropy + plogp(pot).sum(dim=(1, 2))
    entropy = entropy + plogp(poa).sum(dim=(1, 2))
    entropy = entropy + plogp(state_b.p_allele_swap).sum(dim=(1, 2))

    energy = -params_b.divergence_weight * torch.einsum(
        'rns,n,s->r', marg, spec.l, spec.num_alleles_subclonal)
    energy = energy + ll_total_half_b
    energy = energy + pot[:, :, 0].sum(dim=1) * np.log(1.0 - po_t)
    energy = energy + pot[:, :, 1].sum(dim=1) * np.log(po_t)
    energy = energy + ll_allele_half_b
    energy = energy + poa[:, :, 0].sum(dim=1) * np.log(1.0 - po_a)
    energy = energy + poa[:, :, 1].sum(dim=1) * np.log(po_a)
    energy = energy + dot_cur
    return energy - entropy


def _contract_total(marg, p_outlier_total, plane, u):
    """Σ_ns marg·p_outlier_total[:, u]·plane over the trailing (n, S)."""
    return (marg * p_outlier_total[..., u][..., None] * plane).sum(
        dim=(-2, -1))


def _contract_allele(marg, p_outlier_allele, p_allele_swap, plane, k):
    v, w = divmod(k, 2)
    wk = p_outlier_allele[..., v] * p_allele_swap[..., w]
    return (marg * wk[..., None] * plane).sum(dim=(-2, -1))


def expected_log_likelihood_components(spec, params_b, state_b, half,
                                       comps):
    """Per-component full-genome expected-log-likelihood contractions, a
    list of (R,) tensors. ``half='total'``: outlier planes u;
    ``half='allele'``: components k = v·2 + w."""
    rows = _rows(spec, params_b)
    marg = state_b.posterior_marginals
    if half == 'total':
        return [_contract_total(marg, state_b.p_outlier_total,
                                _total_emission_plane(spec, params_b, rows, u),
                                u) for u in comps]
    return [_contract_allele(marg, state_b.p_outlier_allele,
                             state_b.p_allele_swap,
                             _allele_emission_plane(spec, params_b, rows, k),
                             k) for k in comps]


def expected_log_likelihood_halves(spec, params_b, state_b):
    """(total, allele) halves of the full-genome expected log likelihood,
    (R,) each."""
    tot = expected_log_likelihood_components(
        spec, params_b, state_b, 'total', (0, 1))
    alle = expected_log_likelihood_components(
        spec, params_b, state_b, 'allele', (0, 1, 2, 3))
    return tot[0] + tot[1], alle[0] + alle[1] + alle[2] + alle[3]


@torch.no_grad()
def calculate_elbo_restarts(spec, params_b, state_b):
    """Restart-batched ELBO (R,)."""
    tot_b, alle_b = expected_log_likelihood_halves(spec, params_b, state_b)
    return calculate_elbo_from_halves_restarts(
        spec, params_b, state_b, tot_b, alle_b)


def _expected_log_likelihood_rows(spec, params, rows, marg, pot, poa, swap,
                                  extra):
    energy = 0.0
    for u in range(2):
        energy = energy + _contract_total(
            marg, pot, _total_emission_plane(spec, params, rows, u, extra), u)
    for k in range(4):
        energy = energy + _contract_allele(
            marg, poa, swap,
            _allele_emission_plane(spec, params, rows, k, extra), k)
    return energy


def _with_candidate_axes(x, extra):
    return x.reshape(x.shape[:1] + (1,) * extra + x.shape[1:])


def expected_log_likelihood_restarts(spec, params, state_b, extra=0):
    """Likelihood-only expected log joint over all segments, (R, *C) for
    parameters with ``extra`` candidate axes. Differentiable in params."""
    rows = _rows(spec, params, extra=extra)
    e = lambda x: _with_candidate_axes(x, extra)
    return _expected_log_likelihood_rows(
        spec, params, rows, e(state_b.posterior_marginals),
        e(state_b.p_outlier_total), e(state_b.p_outlier_allele),
        e(state_b.p_allele_swap), extra)


def expected_log_likelihood_indexed(spec, params, state_b, idx, extra=0):
    """expected_log_likelihood restricted to the per-restart subsample
    ``idx`` (R, k): the M-step objective at subsample cost."""
    rows = _rows(spec, params, idx, extra)

    def g(x):
        picked = torch.gather(
            x, 1, idx[:, :, None].expand(idx.shape + x.shape[2:]))
        return _with_candidate_axes(picked, extra)

    return _expected_log_likelihood_rows(
        spec, params, rows, g(state_b.posterior_marginals),
        g(state_b.p_outlier_total), g(state_b.p_outlier_allele),
        g(state_b.p_allele_swap), extra)


# -- one restart ---------------------------------------------------------

def calculate_elbo_from_halves(spec, params, state, ll_total_half,
                               ll_allele_half):
    """ELBO of one restart given its two emission-likelihood
    contractions (scalars)."""
    return calculate_elbo_from_halves_restarts(
        spec, one(params), one(state), ll_total_half[None],
        ll_allele_half[None])[0]


@torch.no_grad()
def calculate_elbo(spec, params, state):
    """ELBO of one restart (a scalar)."""
    return calculate_elbo_restarts(spec, one(params), one(state))[0]


def expected_log_likelihood(spec, params, state, sample=None):
    """Likelihood-only expected log joint of one restart over all
    segments, or over those a 0/1 ``sample`` indicator (N,) selects.
    Differentiable in params.

    The JAX engine weights every segment by the indicator; this sums over
    the selected segments only: the same terms in another order."""
    if sample is None:
        return expected_log_likelihood_restarts(spec, one(params),
                                                one(state))[0]
    sample = torch.as_tensor(sample, device=spec.device)
    if not bool(((sample == 0) | (sample == 1)).all()):
        raise ValueError('sample must be a 0/1 indicator')
    idx = torch.nonzero(sample).reshape(1, -1)
    return expected_log_likelihood_indexed(spec, one(params), one(state),
                                           idx)[0]


# ===========================================================================
# decoding
# ===========================================================================

@torch.no_grad()
def viterbi_decode(spec, params, state):
    """Viterbi decode of ONE restart with its stored chain potentials.

    Returns (state_sequence (N,), logprob). States are emitted unswapped,
    as in the reference."""
    bank = full_bank(spec, state.p_breakpoint_used) * state.chain_scale
    return fb_scan.viterbi_chains(
        state.framelogprob, bank, spec.chain_bank_idx, spec.chain_seg_map,
        spec.chain_last)
