"""Chain message passing over per-pair transition banks, in plain PyTorch.

Counterpart of ``remixt_tpu/ops/fb_scan.py``, the JAX package's XLA scans:
the genome chain factorizes at free (telomere) junctions, so the
independent chains run together, looping over the longest chain's
positions.

* ``forward_backward_chains`` and ``forward_backward_chains_restarts``
  are the chain forward-backward of the float64 route (``engine_dtype:
  float64`` on the card, or ``ModelSpec(use_kernels=False)`` anywhere),
  which runs none of the hand kernels, as the JAX package's float64 engine
  runs none of its Pallas kernels. Each step shifts every lane by its
  maximum, multiplies ``exp(carry - max)`` by the lane's matrix and takes
  ``log(s) + max``: no floor on ``s``, so a state whose every incoming
  path underflows goes to ``-inf``, as in the JAX scan. The kernels'
  ``TINY`` floor (``fb_grouped.TINY``) is kernel semantics only.
* ``viterbi_chains`` decodes on every route.

The step loops read their schedules from tensors moved to the device once
per call and never wait on the device inside the loop.
"""

import numpy as np
import torch

from remixt_tpu_torch.ops import fb_grouped


def _scan(F, contract):
    """Forward and backward recursions over chain-major frames ``F`` (R, Q,
    L, S); ``contract(u, t, reverse)`` multiplies each lane's (R, Q, S)
    vector by its matrix of pair ``t``. Returns alphas, betas (R, Q, L, S).
    """
    L = F.shape[2]
    alphas = torch.empty_like(F)
    carry = F[:, :, 0]
    alphas[:, :, 0] = carry
    for t in range(1, L):
        amax = carry.amax(dim=-1, keepdim=True)
        s = contract(torch.exp(carry - amax), t - 1, False)
        carry = torch.log(s) + amax + F[:, :, t]
        alphas[:, :, t] = carry

    betas = torch.empty_like(F)
    carry = torch.zeros_like(F[:, :, 0])
    betas[:, :, L - 1] = carry
    for t in range(L - 1, 0, -1):
        fb = F[:, :, t] + carry
        bmax = fb.amax(dim=-1, keepdim=True)
        s = contract(torch.exp(fb - bmax), t - 1, True)
        carry = torch.log(s) + bmax
        betas[:, :, t - 1] = carry
    return alphas, betas


@torch.no_grad()
def forward_backward_chains(framelogprob, bank, chain_bank_idx, chain_seg_map,
                            chain_last):
    """Chain-batched log-space forward-backward of one restart.

    Args:
        framelogprob: (N, S) emission log probabilities
        bank: (num_bank, S, S) transition log-weights, entry 0 the cut
            (zero) matrix: the static classes, then one per breakend
        chain_bank_idx: (Q, max(L-1, 1)) bank index per within-chain pair
            (0 on pads)
        chain_seg_map: (Q, L) global segment index, N on pads
        chain_last: (Q,) index of each chain's last real position

    Returns alphas (N, S), betas (N, S), log_norm (scalar).
    """
    N = framelogprob.shape[0]
    F = fb_grouped.gather_frames(framelogprob[None], chain_seg_map)
    exp_bank = torch.exp(bank)
    cbi = chain_bank_idx.long().to(bank.device)

    def contract(u, t, reverse):
        P = exp_bank[cbi[:, t]]                                # (Q, S, S)
        eq = 'rqj,qij->rqi' if reverse else 'rqi,qij->rqj'
        return torch.einsum(eq, u, P)

    alphas, betas = _scan(F, contract)
    alphas, betas, log_norm = fb_grouped._scatter_and_norm(
        alphas, betas, chain_seg_map, chain_last, N)
    return alphas[0], betas[0], log_norm[0]


def build_restart_plan(chain_bank_idx_np, num_static_bank):
    """Host-side schedule for the restart-batched scan.

    Splits the per-pair bank indices into a static-class plane (breakend
    pairs mapped to the cut class 0) and a compact per-step breakend
    schedule: at most ``kmax`` (lane, breakend) fix-ups per step, -1
    padded. Returns dict with 'static_idx' (Q, T), 'sched_lane' and
    'sched_slot' (T, kmax) for T = chain_bank_idx.shape[1] steps, and
    'kmax'.
    """
    cls = np.asarray(chain_bank_idx_np)
    is_be = cls >= num_static_bank
    static_idx = np.where(is_be, 0, cls).astype(np.int32)

    T = cls.shape[1]
    counts = is_be.sum(axis=0)
    kmax = max(int(counts.max()) if T else 1, 1)
    sched_lane = -np.ones((T, kmax), dtype=np.int32)
    sched_slot = np.zeros((T, kmax), dtype=np.int32)
    for t in range(T):
        for j, q in enumerate(np.flatnonzero(is_be[:, t])):
            sched_lane[t, j] = q
            sched_slot[t, j] = cls[q, t] - num_static_bank
    return dict(static_idx=static_idx, sched_lane=sched_lane,
                sched_slot=sched_slot, kmax=kmax)


@torch.no_grad()
def forward_backward_chains_restarts(frame_b, static_bank, be_bank_b, plan,
                                     chain_seg_map, chain_last):
    """Restart-batched chain forward-backward.

    Each step contracts every lane with its static class matrix, gathered
    once and shared by the restarts (``'rqi,qij->rqj'``), then replaces
    the lanes whose pair is a breakend, at most ``kmax`` of them, by their
    product with that restart's breakend matrix, as the plan schedules.

    Args:
        frame_b: (R, N, S) per-restart emission log probs
        static_bank: (num_static, S, S) shared transition log-weights
        be_bank_b: (R, J, S, S) per-restart breakend log-weights
        plan: ``build_restart_plan`` output
        chain_seg_map: (Q, L) global segment index, N on pads
        chain_last: (Q,) last real position per chain

    Returns alphas (R, N, S), betas (R, N, S), log_norm (R,).
    """
    N = frame_b.shape[1]
    device = frame_b.device
    F = fb_grouped.gather_frames(frame_b, chain_seg_map)
    exp_static = torch.exp(static_bank)
    exp_be = torch.exp(be_bank_b)

    # the schedule, on the device once; each step's count of fix-ups is a
    # host number, so the loop never reads the device
    counts = (plan['sched_lane'] >= 0).sum(axis=1).tolist()
    static_idx = torch.as_tensor(plan['static_idx'].T, dtype=torch.long,
                                 device=device)                # (T, Q)
    lanes = torch.as_tensor(plan['sched_lane'], dtype=torch.long,
                            device=device)                     # (T, kmax)
    slots = torch.as_tensor(plan['sched_slot'], dtype=torch.long,
                            device=device)

    def contract(u, t, reverse):
        P = exp_static[static_idx[t]]                          # (Q, S, S)
        eq = 'rqj,qij->rqi' if reverse else 'rqi,qij->rqj'
        s = torch.einsum(eq, u, P)
        k = counts[t]
        if k:
            lane = lanes[t, :k]
            M = exp_be[:, slots[t, :k]]                        # (R, k, S, S)
            eqb = 'rkj,rkij->rki' if reverse else 'rki,rkij->rkj'
            s.index_copy_(1, lane, torch.einsum(eqb, u[:, lane], M))
        return s

    alphas, betas = _scan(F, contract)
    return fb_grouped._scatter_and_norm(alphas, betas, chain_seg_map,
                                        chain_last, N)


def viterbi_chains(framelogprob, bank, chain_bank_idx, chain_seg_map,
                   chain_last):
    """Chain-batched Viterbi with first-maximum tie-breaking.

    Args:
        framelogprob: (N, S) emission log probabilities
        bank: (num_bank, S, S) transition log-weights, entry 0 the cut matrix
        chain_bank_idx: (Q, max(L-1, 1)) bank index per within-chain pair
        chain_seg_map: (Q, L) global segment index, N on pads
        chain_last: (Q,) last real position per chain

    Returns (state_sequence (N,) long, logprob scalar).
    """
    N, S = framelogprob.shape
    Q, L = chain_seg_map.shape
    device = framelogprob.device
    seg = chain_seg_map.long()
    cbi = chain_bank_idx.long()
    last = chain_last.long()

    frame_ext = torch.cat([framelogprob, framelogprob.new_zeros((1, S))])
    F = frame_ext[seg]                                    # (Q, L, S)

    scores = [F[:, 0]]
    ptrs = []
    score = F[:, 0]
    for t in range(1, L):
        cand = score[:, :, None] + bank[cbi[:, t - 1]]    # (Q, S, S)
        best, ptr = torch.max(cand, dim=1)
        score = best + F[:, t]
        scores.append(score)
        ptrs.append(ptr)
    scores_b = torch.stack(scores, dim=1)                 # (Q, L, S)

    q_idx = torch.arange(Q, device=device)
    final = scores_b[q_idx, last]                         # (Q, S)
    logprob = final.max(dim=-1).values.sum()
    state = final.argmax(dim=-1)                          # (Q,)

    # walk back from each chain's true last position; pad pairs (t >= last)
    # leave the state where it is
    seq = [state]
    for t in range(L - 2, -1, -1):
        prev = ptrs[t][q_idx, state]
        state = torch.where(t < last, prev, state)
        seq.append(state)
    seq_b = torch.stack(seq[::-1], dim=1)                 # (Q, L)

    out = torch.zeros(N + 1, dtype=torch.long, device=device)
    out[seg.reshape(-1)] = seq_b.reshape(-1)
    return out[:N], logprob
