"""Blocked two-pass forward-backward: a chain's positions split into
blocks that can run on several devices (counterpart of
``remixt_tpu/ops/fb_blocked.py``, plain PyTorch as that file is plain
``jnp``; no kernel).

The chain-batched scan (``ops/fb_scan.py``) runs the chains side by side,
so its serial length is the longest chain and a chain never spans
devices. Here each chain's position axis splits into B blocks:

  Pass 1, over every block at once: each block folds its steps' operators
      M_t = P_t * diag(exp(f_{t+1})) into one S x S transfer matrix T_b
      (max-normalized, with a scalar log offset). The same T_b serves
      both directions: alpha_end = alpha_start @ T_b and
      beta_start = T_b @ beta_end.
  Boundary combine, serial in B: prefix products of the T_b give the
      exact alpha entering every block, suffix products the exact beta
      leaving it. With block devices, the (Q, B, S, S) stack of T_b is
      the one thing that crosses to a single device.
  Pass 2, over every block at once: the ordinary vector scan inside each
      block from its exact boundary messages.

``block_devices`` (a list of devices, or None) splits the block axis
into contiguous groups, one a device: passes 1 and 2 of a group run on
its device, the boundary combine on the device of the inputs, which also
receives the results. Results equal the serial scan's up to the
floating-point association of the products.
"""

import numpy as np
import torch

from remixt_tpu_torch.ops import fb_grouped
from remixt_tpu_torch.ops.special import logsumexp


def _fold_block_matrices(exp_bank, idx_blk, f_blk, valid_blk):
    """Per-block transfer matrices.

    Args:
        exp_bank: (num_bank, S, S) exp-space transition matrices
        idx_blk: (*lead, Lb) bank index per step
        f_blk: (*lead, Lb, S) emission of each step's target position
        valid_blk: (*lead, Lb) bool, False for padded steps (carry
            unchanged)

    Returns T (*lead, S, S) max-normalized transfers, off (*lead,) log
    offsets.
    """
    *lead, Lb, S = f_blk.shape
    T = torch.eye(S, dtype=f_blk.dtype, device=f_blk.device).expand(
        *lead, S, S)
    off = f_blk.new_zeros(lead)
    for t in range(Lb):
        f_next = f_blk[..., t, :]
        fmax = f_next.amax(dim=-1)
        M = exp_bank[idx_blk[..., t]] * torch.exp(
            f_next - fmax[..., None])[..., None, :]
        T2 = T @ M
        m = T2.amax(dim=(-2, -1))
        valid = valid_blk[..., t]
        T = torch.where(valid[..., None, None], T2 / m[..., None, None], T)
        off = torch.where(valid, off + torch.log(m) + fmax, off)
    return T, off


def _boundary_messages(T, off, alpha0):
    """Exact boundary vectors from the block transfers.

    Args:
        T: (*lead, B, S, S), off: (*lead, B), alpha0: (*lead, S) log alpha
            at the chain's start

    Returns alpha_in (*lead, B, S), the log alpha at each block's first
    position, and beta_in (*lead, B, S), the log beta at each block's last
    position + 1.
    """
    B = T.shape[-3]
    alpha_in = []
    carry = alpha0
    for b in range(B):
        alpha_in.append(carry)
        amax = carry.amax(dim=-1, keepdim=True)
        carry = (torch.log((torch.exp(carry - amax)[..., None, :]
                            @ T[..., b, :, :])[..., 0, :])
                 + amax + off[..., b, None])

    beta_in = [None] * B
    carry = torch.zeros_like(alpha0)
    for b in range(B - 1, -1, -1):
        beta_in[b] = carry
        bmax = carry.amax(dim=-1, keepdim=True)
        carry = (torch.log((T[..., b, :, :]
                            @ torch.exp(carry - bmax)[..., :, None])[..., 0])
                 + bmax + off[..., b, None])
    return torch.stack(alpha_in, dim=-2), torch.stack(beta_in, dim=-2)


def _vector_passes(exp_bank, idx_blk, f_blk, valid_blk, alpha_in, beta_in):
    """Pass 2: each block's vector scans from its exact boundary messages.

    Returns alphas (*lead, Lb, S) and betas (*lead, Lb, S) at each block's
    positions (alpha[..., i, :] at the block's start + i; beta likewise).
    """
    Lb = idx_blk.shape[-1]
    alphas = [alpha_in]
    alpha = alpha_in
    for t in range(Lb - 1):
        amax = alpha.amax(dim=-1, keepdim=True)
        nxt = (torch.log((torch.exp(alpha - amax)[..., None, :]
                          @ exp_bank[idx_blk[..., t]])[..., 0, :])
               + amax + f_blk[..., t, :])
        alpha = torch.where(valid_blk[..., t, None], nxt, alpha)
        alphas.append(alpha)

    betas = [None] * Lb
    beta = beta_in
    for t in range(Lb - 1, -1, -1):
        fb = f_blk[..., t, :] + beta
        bmax = fb.amax(dim=-1, keepdim=True)
        prv = (torch.log((exp_bank[idx_blk[..., t]]
                          @ torch.exp(fb - bmax)[..., :, None])[..., 0])
               + bmax)
        beta = torch.where(valid_blk[..., t, None], prv, beta)
        betas[t] = beta
    return torch.stack(alphas, dim=-2), torch.stack(betas, dim=-2)


def _by_block_group(fn, exp_bank, arrays, block_axis, block_devices):
    """``fn(exp_bank, *arrays)`` with the block axis of every array split
    into contiguous groups, one per device of ``block_devices``, each run
    on its device; the outputs come back to the arrays' device, joined
    along the block axis. Without devices, one call where the arrays
    are."""
    if not block_devices:
        return fn(exp_bank, *arrays)
    home = arrays[0].device
    B = arrays[0].shape[block_axis]
    outs = []
    for device, group in zip(block_devices,
                             np.array_split(np.arange(B), len(block_devices))):
        if not len(group):
            continue
        parts = [a.narrow(block_axis, int(group[0]), len(group)).to(device)
                 for a in arrays]
        outs.append([o.to(home) for o in fn(exp_bank.to(device), *parts)])
    return tuple(torch.cat(xs, dim=block_axis) for xs in zip(*outs))


def _blocked(exp_bank, idx_blk, f_blk, valid_blk, alpha0, block_axis,
             block_devices):
    """The two passes and the boundary combine; alphas and betas (*lead,
    B, Lb, S)."""
    T, off = _by_block_group(_fold_block_matrices, exp_bank,
                             (idx_blk, f_blk, valid_blk), block_axis,
                             block_devices)
    alpha_in, beta_in = _boundary_messages(T, off, alpha0)
    return _by_block_group(_vector_passes, exp_bank,
                           (idx_blk, f_blk, valid_blk, alpha_in, beta_in),
                           block_axis, block_devices)


@torch.no_grad()
def forward_backward_blocked(framelogprob, bank, bank_idx, num_blocks,
                             block_devices=None):
    """Blocked two-pass forward-backward on a single chain.

    Same contract as a one-chain scan: framelogprob (N, S), bank
    (num_bank, S, S) transition log-weights, bank_idx (N-1,) bank index
    per pair. Returns alphas (N, S), betas (N, S), log_norm.
    """
    N, S = framelogprob.shape
    B = num_blocks
    Lb = -(-N // B)
    Np = B * Lb

    f = torch.cat([framelogprob, framelogprob.new_zeros((Np - N, S))])
    # step p connects position p -> p+1; valid for p < N-1
    idx = torch.cat([bank_idx.long(),
                     bank_idx.new_zeros(Np - N + 1, dtype=torch.long)])
    step_valid = torch.arange(Np, device=f.device) < (N - 1)
    # emission of each step's target position
    f_next = torch.cat([f[1:], f.new_zeros((1, S))])

    alphas_blk, betas_blk = _blocked(
        torch.exp(bank), idx.reshape(B, Lb), f_next.reshape(B, Lb, S),
        step_valid.reshape(B, Lb), framelogprob[0], 0, block_devices)
    alphas = alphas_blk.reshape(Np, S)[:N]
    betas = betas_blk.reshape(Np, S)[:N]
    return alphas, betas, logsumexp(alphas[N - 1], dim=-1)


@torch.no_grad()
def forward_backward_chains_blocked(framelogprob, bank, chain_bank_idx,
                                    chain_seg_map, chain_last, num_blocks,
                                    block_devices=None):
    """Chain-batched blocked forward-backward: every chain is also split
    into ``num_blocks`` position blocks, so one chromosome can span
    devices. Same contract as ``fb_scan.forward_backward_chains``:
    alphas (N, S), betas (N, S), log_norm (the sum of the chains')."""
    S = framelogprob.shape[-1]
    Q, L = chain_seg_map.shape
    N = framelogprob.shape[0]
    B = num_blocks
    Lb = -(-L // B)
    Lp = B * Lb
    device = framelogprob.device
    seg = chain_seg_map.long().to(device)
    last = chain_last.long().to(device)

    frame_ext = torch.cat([framelogprob, framelogprob.new_zeros((1, S))])
    F = torch.cat([frame_ext[seg], frame_ext.new_zeros((Q, Lp - L, S))],
                  dim=1)                                      # (Q, Lp, S)
    cbi = chain_bank_idx.long().to(device)
    idx = torch.cat([cbi, cbi.new_zeros((Q, Lp - cbi.shape[1]))], dim=1)
    # step t of chain q is valid while t < chain_last[q]
    step_valid = torch.arange(Lp, device=device)[None, :] < last[:, None]
    f_next = torch.cat([F[:, 1:], F.new_zeros((Q, 1, S))], dim=1)

    alphas_blk, betas_blk = _blocked(
        torch.exp(bank), idx.reshape(Q, B, Lb), f_next.reshape(Q, B, Lb, S),
        step_valid.reshape(Q, B, Lb), F[:, 0, :], 1, block_devices)
    alphas_b = alphas_blk.reshape(1, Q, Lp, S)[:, :, :L]
    betas_b = betas_blk.reshape(1, Q, Lp, S)[:, :, :L]
    alphas, betas, log_norm = fb_grouped._scatter_and_norm(
        alphas_b, betas_b, seg, last, N)
    return alphas[0], betas[0], log_norm[0]
