"""BreakpointModel: the fit's model object (torch).

Counterpart of ``remixt_tpu/models/fit.py``: host-side segmentation remap
and likelihood masks, state-space construction, the EM × VI fit loop of
one restart with its snapshots, Viterbi decode and breakpoint copy-number
extraction. The restart grid is fitted by
:func:`remixt_tpu_torch.models.fit_batched.fit_restarts_batched`.
"""

import logging
import os
import pickle

import numpy as np
import torch

from remixt_tpu_torch.device import resolve_device, resolve_dtype
from remixt_tpu_torch.models import convert
from remixt_tpu_torch.models import em as em_mod
from remixt_tpu_torch.models import engine as eng
from remixt_tpu_torch.models import states as states_mod
from remixt_tpu_torch.models.remap import SegmentRemap

logger = logging.getLogger('remixt_tpu_torch.fit')


LIKELIHOOD_PARAM_BOUNDS = {
    'negbin_r_0': (10., 2000.),
    'negbin_r_1': (1., 2000.),
    'betabin_M_0': (10., 2000.),
    'betabin_M_1': (1., 2000.),
    'negbin_hdel_mu': (1e-9, 1e-4),
    'negbin_hdel_r_0': (10., 2000.),
    'negbin_hdel_r_1': (1., 200.),
    'betabin_loh_p': (1e-5, 1e-2),
    'betabin_loh_M_0': (10., 2000.),
    'betabin_loh_M_1': (1., 200.),
}


class BreakpointModel:
    """Joint segment + breakpoint copy-number model over one sample.

    Args:
        x (ndarray): observed (major, minor, total) read counts, (N, 3)
        l (ndarray): effective segment lengths, (N,)
        adjacencies (set of tuple): wild-type adjacent segment pairs
        breakpoints (dict): breakpoint id -> frozenset of (segment, side)

    KwArgs as the JAX ``BreakpointModel`` (max_copy_number,
    normal_contamination, divergence_weight, min_segment_length,
    min_proportion_genotyped, max_depth, transition_log_prob,
    disable_breakpoints, normal_copies, do_h_update, random_seed), plus
        device: torch device, ``None`` for CUDA (raises without one)
        dtype: engine dtype, a name or torch dtype (default float32)
        use_kernels: the chain update's route, ``ModelSpec.use_kernels``
    """

    def __init__(self, x, l, adjacencies, breakpoints, **kwargs):
        x = np.asarray(x)
        if not np.all(x[:, 1] <= x[:, 0]):
            raise ValueError('x must be ordered major, minor, total')

        self.N = x.shape[0]
        if len(breakpoints) > 0:
            self.breakpoint_ids, self.breakpoints = zip(*breakpoints.items())
        else:
            self.breakpoint_ids, self.breakpoints = (), ()

        self.device = resolve_device(kwargs.get('device'))
        self.dtype = resolve_dtype(kwargs.get('dtype', torch.float32))
        self.use_kernels = kwargs.get('use_kernels')
        self.max_copy_number = kwargs.get('max_copy_number', 6)
        self.max_copy_number_diff = kwargs.get('max_copy_number_diff', 1)
        self.normal_contamination = kwargs.get('normal_contamination', True)
        self.divergence_weight = kwargs.get('divergence_weight', 1e6)
        self.min_segment_length = kwargs.get('min_segment_length', 10000)
        self.min_proportion_genotyped = kwargs.get(
            'min_proportion_genotyped', 0.01)
        self.max_depth = kwargs.get('max_depth')
        self.transition_log_prob = kwargs.get('transition_log_prob', 10.)
        self.transition_model = kwargs.get('transition_model', 0)
        self.disable_breakpoints = kwargs.get('disable_breakpoints', False)
        self.breakpoint_init = kwargs.get('breakpoint_init', None)
        self.normal_copies = np.asarray(
            kwargs.get('normal_copies', np.array([[1, 1]] * self.N)))
        self.do_h_update = kwargs.get('do_h_update', True)
        self.random_seed = kwargs.get('random_seed', None)

        if self.max_depth is None:
            raise ValueError('must specify max depth')
        if not self.normal_contamination:
            self.normal_copies = self.normal_copies * 0

        self.remap = SegmentRemap(self.N, adjacencies, self.breakpoints)
        self.N1 = self.remap.N1
        self.seg_fwd_remap = self.remap.seg_fwd_remap
        self.seg_rev_remap = self.remap.seg_rev_remap
        self.num_breakpoints = self.remap.num_breakpoints
        self.is_telomere = self.remap.is_telomere
        self.breakpoint_idx = self.remap.breakpoint_idx
        self.breakpoint_orient = self.remap.breakpoint_orient

        self.x1, self.l1 = self.remap.expand_data(x, l)

        # likelihood masks: segments too short, or amplified past
        # max_depth, leave the likelihood; the allele term also needs
        # enough genotypable reads
        total_reads = self.x1[:, 2].astype(float)
        depth = total_reads / (self.l1.astype(float) + 1e-16)
        genotyped_fraction = (
            self.x1[:, :2].sum(axis=1).astype(float) / (total_reads + 1e-16))
        modellable = (
            (self.l1 >= self.min_segment_length) & (depth <= self.max_depth))
        self._total_likelihood_mask = modellable
        self._allele_likelihood_mask = modellable & (
            genotyped_fraction >= self.min_proportion_genotyped)

        if self.disable_breakpoints:
            self.num_breakpoints = 0
            self.breakpoint_idx = np.full_like(self.breakpoint_idx, -1)
            self.breakpoint_orient = np.zeros_like(self.breakpoint_orient)

        self.check_elbo = False
        self.prev_elbo = None
        self.prev_elbo_diff = None
        self._em_iter = 0
        self.num_em_iter = 1
        self.num_update_iter = 1

        self.likelihood_params = [
            'negbin_r_0',
            'negbin_r_1',
            'betabin_M_0',
            'betabin_M_1',
        ]
        if not self.normal_contamination:
            self.likelihood_params.extend([
                'negbin_hdel_mu',
                'negbin_hdel_r_0',
                'negbin_hdel_r_1',
                'betabin_loh_p',
                'betabin_loh_M_0',
                'betabin_loh_M_1',
            ])
        self.likelihood_param_bounds = dict(LIKELIHOOD_PARAM_BOUNDS)

        self.spec = None
        self.params = None
        self.state = None

    # -- model assembly ------------------------------------------------------

    def _build_spec(self, num_clones):
        cn_states_one = states_mod.enumerate_cn_states(
            num_clones, 2, self.max_copy_number, self.max_copy_number_diff)
        cn_states = np.tile(cn_states_one[None], (self.N, 1, 1, 1))
        cn_states[:, :, 0, :] = self.normal_copies[:, None, :]
        cn_states = cn_states[self.seg_rev_remap]

        brk_states = states_mod.enumerate_brk_states(
            num_clones, self.max_copy_number, self.max_copy_number_diff)

        return eng.ModelSpec(
            cn_states=cn_states,
            brk_states=brk_states,
            l=self.l1,
            x=self.x1[:, 2],
            y=self.x1[:, 0:2],
            is_telomere=self.is_telomere,
            breakpoint_idx=self.breakpoint_idx,
            breakpoint_orient=self.breakpoint_orient,
            transition_penalty=self.transition_log_prob,
            normal_contamination=self.normal_contamination,
            transition_model=self.transition_model,
            dtype=self.dtype,
            device=self.device,
            use_kernels=self.use_kernels,
        )

    def _init_p_breakpoint(self):
        """Optional informative q(brk) init."""
        if self.breakpoint_init is None or self.num_breakpoints == 0:
            return None
        brk_states = self.spec.brk_states.cpu().numpy()
        p_breakpoint = np.ones((self.num_breakpoints, brk_states.shape[0]))
        for k, bp in enumerate(self.breakpoints):
            cn = self.breakpoint_init[bp]
            match = np.all(brk_states == np.asarray(cn)[None, :], axis=1)
            p_breakpoint[k, match] = 1000.
        p_breakpoint /= p_breakpoint.sum(axis=-1, keepdims=True)
        return p_breakpoint

    # -- fitting -------------------------------------------------------------

    def reset_restart(self, max_depth=None, divergence_weight=None):
        """Re-point this model at a new restart's configuration, keeping its
        state space: masks and the divergence weight are Params fields."""
        if divergence_weight is not None:
            self.divergence_weight = divergence_weight
        if max_depth is not None:
            # the masks are rebuilt in the JAX package's order, which differs
            # slightly from the constructor's
            self.max_depth = max_depth
            self._total_likelihood_mask = np.ones(self.N1, dtype=bool)
            self._allele_likelihood_mask = np.ones(self.N1, dtype=bool)
            self._total_likelihood_mask &= (self.l1 >= self.min_segment_length)
            self._allele_likelihood_mask &= (self.l1 >= self.min_segment_length)
            p = self.x1[:, :2].sum(axis=1).astype(float) / (
                self.x1[:, 2].astype(float) + 1e-16)
            self._allele_likelihood_mask &= (p >= self.min_proportion_genotyped)
            depth = self.x1[:, 2].astype(float) / (
                self.l1.astype(float) + 1e-16)
            self._total_likelihood_mask &= (depth <= self.max_depth)
            self._allele_likelihood_mask &= (depth <= self.max_depth)
        self.prev_elbo = None
        self.prev_elbo_diff = None

    def _ensure_spec(self, num_clones):
        if self.spec is None or getattr(self, '_spec_num_clones',
                                        None) != num_clones:
            self.spec = self._build_spec(num_clones)
            self._spec_num_clones = num_clones

    def save_snapshot(self, filename):
        """Write a resumable snapshot: params and variational state as
        numpy dicts, the host RNG state and the fit loop's progress.
        Atomic (tmp + rename), so a kill mid-write leaves no truncated
        file."""
        def as_numpy(tree):
            return {k: v.cpu().numpy() for k, v in tree._asdict().items()}

        payload = {
            'params': as_numpy(self.params),
            'state': as_numpy(self.state),
            'rng_state': self._rng.get_state(),
            'em_iter': self._em_iter,
            'prev_elbo': (None if self.prev_elbo is None
                          else float(self.prev_elbo)),
            'prev_elbo_diff': (None if self.prev_elbo_diff is None
                               else float(self.prev_elbo_diff)),
            'num_clones': self._spec_num_clones,
        }
        tmp = filename + '.tmp'
        with open(tmp, 'wb') as f:
            pickle.dump(payload, f)
        os.replace(tmp, filename)

    def load_snapshot(self, filename):
        """Restore a snapshot written by save_snapshot; the spec is rebuilt
        from the problem."""
        with open(filename, 'rb') as f:
            payload = pickle.load(f)
        self._ensure_spec(payload['num_clones'])
        self.params = convert.params_from_numpy(payload['params'],
                                                self.device, self.dtype)
        self.state = convert.state_from_numpy(payload['state'], self.device,
                                              self.dtype)
        self._rng = np.random.RandomState()
        self._rng.set_state(payload['rng_state'])
        self._em_iter = payload['em_iter']
        self.prev_elbo = payload['prev_elbo']
        self.prev_elbo_diff = payload['prev_elbo_diff']

    def fit(self, h_init, snapshot_filename=None):
        """EM × VI fit loop of one restart.

        With ``snapshot_filename``, a snapshot is written after every EM
        iteration and, if the file exists, the fit resumes from it, with the
        same result as an uninterrupted run (the host RNG state rides the
        snapshot).
        """
        h_init = np.asarray(h_init, dtype=float)
        if snapshot_filename is not None and os.path.exists(snapshot_filename):
            self.load_snapshot(snapshot_filename)
            logger.info('resumed from snapshot at EM iteration %d',
                        self._em_iter)
        else:
            self._ensure_spec(h_init.shape[0])
            self.params = self.spec.init_params(
                h_init, self.divergence_weight,
                total_mask=self._total_likelihood_mask.astype(float),
                allele_mask=self._allele_likelihood_mask.astype(float))
            self.state = self.spec.init_state(self._init_p_breakpoint())
            self._rng = np.random.RandomState(self.random_seed)
            self._em_iter = 0

        if self.prev_elbo is None:
            self.prev_elbo = float(eng.calculate_elbo(
                self.spec, self.params, self.state))

        # the ELBO stays a device scalar inside the loop: one host pull at
        # the end, and per-iteration diagnostics only when logged
        verbose = logger.isEnabledFor(logging.INFO)
        while self._em_iter < self.num_em_iter:
            if self.check_elbo:
                for _ in range(self.num_update_iter):
                    self.variational_update()
            else:
                self.state = eng.variational_sweeps(
                    self.spec, self.params, self.state, self.num_update_iter)

            if self.do_h_update:
                self.em_update_h()

            elbo = self.em_update_params()
            if elbo is None:
                elbo = eng.calculate_elbo(self.spec, self.params, self.state)

            self.prev_elbo_diff = elbo - self.prev_elbo
            self.prev_elbo = elbo
            self._em_iter += 1

            if verbose:
                logger.info('completed iteration %d', self._em_iter - 1)
                logger.info('    elbo: %.10f', float(self.prev_elbo))
                logger.info('    elbo diff: %.10f', float(self.prev_elbo_diff))
                logger.info('    h = %s', self.h)
                for name, value in self.get_likelihood_param_values().items():
                    logger.info('    %s = %s', name, value)

            if snapshot_filename is not None:
                self.save_snapshot(snapshot_filename)

        self.prev_elbo = float(self.prev_elbo)
        self.prev_elbo_diff = (None if self.prev_elbo_diff is None
                               else float(self.prev_elbo_diff))

    def _elbo_guard(self, name, fn, threshold=-1e-6):
        """Run one update; under ``check_elbo``, raise if it lowered the
        ELBO by more than ``threshold``."""
        if not self.check_elbo:
            fn()
            return
        before = float(eng.calculate_elbo(self.spec, self.params, self.state))
        fn()
        after = float(eng.calculate_elbo(self.spec, self.params, self.state))
        logger.info('    %s elbo diff: %.10f', name, after - before)
        if after - before < threshold:
            raise RuntimeError('elbo error for step {}!'.format(name))

    def variational_update(self):
        """One sweep of all variational updates in the reference's order;
        stepwise and guarded under ``check_elbo``."""
        if not self.check_elbo:
            self.state = eng.variational_sweep(self.spec, self.params,
                                               self.state)
            return
        for name, fn in (('update_p_allele_swap', self._step_swap),
                         ('p_cn', self._step_cn),
                         ('p_breakpoint', self._step_breakpoint),
                         ('p_outlier_total', self._step_outlier_total),
                         ('p_outlier_allele', self._step_outlier_allele)):
            self._elbo_guard(name, fn)

    @torch.no_grad()
    def _emission(self):
        ll_tot, ll_alle = eng.emission_tensors(self.spec, eng.one(self.params))
        return ll_tot[0], ll_alle[0]

    @torch.no_grad()
    def _step_swap(self):
        _, ll_alle = self._emission()
        self.state = eng.update_p_allele_swap(self.spec, self.params,
                                              self.state, ll_alle)

    @torch.no_grad()
    def _step_cn(self):
        ll_tot, ll_alle = self._emission()
        self.state = eng.update_p_cn(self.spec, self.params, self.state,
                                     ll_tot, ll_alle)

    @torch.no_grad()
    def _step_breakpoint(self):
        self.state = eng.update_p_breakpoint(self.spec, self.params,
                                             self.state)

    @torch.no_grad()
    def _step_outlier_total(self):
        ll_tot, _ = self._emission()
        self.state = eng.update_p_outlier_total(self.spec, self.params,
                                                self.state, ll_tot)

    @torch.no_grad()
    def _step_outlier_allele(self):
        _, ll_alle = self._emission()
        self.state = eng.update_p_outlier_allele(self.spec, self.params,
                                                 self.state, ll_alle)

    def em_update_h(self):
        """The fused h update, also under ``check_elbo`` (the L-BFGS-B
        ``em.update_h`` is an alternative API, not a fit path)."""
        def step():
            self.params, accepted = em_mod.update_h_fused(
                self.spec, self.params, self.state, self._rng)
            if logger.isEnabledFor(logging.INFO) and not bool(accepted):
                logger.info('    h update rejected')
        self._elbo_guard('h', step)

    def em_update_params(self):
        """Update the scalar likelihood parameters. Returns the ELBO after
        the fused update as a device scalar, None after the stepwise one
        (``check_elbo``)."""
        if self.check_elbo:
            for name in self.likelihood_params:
                def step(name=name):
                    weights = em_mod.param_sample_weights(
                        self.spec, self.state, name)
                    self.params, accepted = em_mod.update_param(
                        self.spec, self.params, self.state, name,
                        self.likelihood_param_bounds[name], self._rng,
                        weights)
                    if not accepted:
                        logger.info('    %s update rejected', name)
                self._elbo_guard(name, step)
            return None

        weights_list = em_mod.param_sample_weights_all(
            self.spec, self.state, self.likelihood_params)
        self.params, accepts, elbo = em_mod.update_params_fused(
            self.spec, self.params, self.state, self.likelihood_params,
            self.likelihood_param_bounds, self._rng, weights_list)
        if logger.isEnabledFor(logging.INFO):
            for name, accepted in zip(self.likelihood_params,
                                      accepts.cpu().numpy()):
                if not accepted:
                    logger.info('    %s update rejected', name)
        return elbo

    # -- outputs -------------------------------------------------------------

    def get_likelihood_param_values(self):
        return {name: float(getattr(self.params, name))
                for name in self.likelihood_params}

    def optimal_cn(self):
        """Viterbi decode + breakpoint copy number of the current restart.

        Returns:
            cn (N, M, 2) in the ORIGINAL segmentation, brk_cn dict
        """
        seq, _ = eng.viterbi_decode(self.spec, self.params, self.state)
        seq = seq.cpu().numpy()

        class_cn = self.spec.class_cn_np          # (C, S, M, 2)
        seg_class = self.spec.seg_class_np
        cn1 = class_cn[seg_class, seq]            # (N1, M, 2)

        # int32, the dtype of the reference's decoded breakpoint copy number
        brk_states = self.spec.brk_states.cpu().numpy().astype(np.int32)
        num_brk_states = brk_states.shape[0]
        tp = self.transition_log_prob

        brk_cn = dict()
        if self.num_breakpoints > 0:
            # each junction n with breakpoint k contributes
            # -tp * |d_m - orient * brk_states| per clone to that
            # breakpoint's state score
            at_brk = np.flatnonzero(self.breakpoint_idx[:self.N1 - 1] >= 0)
            k_idx = self.breakpoint_idx[at_brk]
            d = (cn1[at_brk].sum(axis=2) - cn1[at_brk + 1].sum(axis=2))
            orient = self.breakpoint_orient[at_brk]
            score = -tp * np.abs(
                d[:, None, :] - orient[:, None, None] * brk_states[None, :, :]
            ).sum(axis=2)
            log_p = np.zeros((self.num_breakpoints, num_brk_states))
            np.add.at(log_p, k_idx, score)
            best = brk_states[log_p.argmax(axis=1)]
            brk_cn = {self.breakpoint_ids[k]: best[k]
                      for k in range(self.num_breakpoints)}

        cn = cn1[self.seg_fwd_remap]
        return cn, brk_cn

    def breakpoint_prob(self):
        return dict(zip(self.breakpoints, self.p_breakpoint))

    @property
    def h(self):
        return self.params.h.cpu().numpy()

    @property
    def p_breakpoint(self):
        return self.state.p_breakpoint.cpu().numpy()

    @property
    def p_outlier_total(self):
        return self.state.p_outlier_total.cpu().numpy()[self.seg_fwd_remap]

    @property
    def p_outlier_allele(self):
        return self.state.p_outlier_allele.cpu().numpy()[self.seg_fwd_remap]

    @property
    def total_likelihood_mask(self):
        return self._total_likelihood_mask[self.seg_fwd_remap]

    @property
    def allele_likelihood_mask(self):
        return self._allele_likelihood_mask[self.seg_fwd_remap]


def decode_breakpoints_naive(cn, adjacencies, breakpoints):
    """Breakpoint copy number from segment copy number alone, as the min
    residual copy-number flow at the two breakends. Used when integrated
    breakpoint inference is disabled."""
    cn = cn.sum(axis=-1)

    breakend_adj = dict()
    for seg_1, seg_2 in adjacencies:
        breakend_adj[(seg_1, 1)] = (seg_2, 0)
        breakend_adj[(seg_2, 0)] = (seg_1, 1)

    brk_cn = dict()
    for breakpoint_id, breakpoint in breakpoints.items():
        breakend_cn = dict()
        for breakend in breakpoint:
            n, side = breakend
            cn_self = cn[n, :]
            if breakend in breakend_adj:
                n_adj, _ = breakend_adj[breakend]
                cn_adj = cn[n_adj, :]
            else:
                cn_adj = 0
            breakend_cn[(n, side)] = np.maximum(cn_self - cn_adj, 0)

        ((n_1, side_1), (n_2, side_2)) = breakpoint
        brk_cn[breakpoint_id] = np.minimum(
            breakend_cn[(n_1, side_1)], breakend_cn[(n_2, side_2)])

    return brk_cn
