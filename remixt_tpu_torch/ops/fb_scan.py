"""Chain-batched max-product decoding over per-pair transition banks.

Counterpart of ``viterbi_chains`` in ``remixt_tpu/ops/fb_scan.py``: the
genome chain factorizes at free (telomere) junctions, so the independent
chains decode together, looping over the longest chain's positions.
"""

import torch


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
