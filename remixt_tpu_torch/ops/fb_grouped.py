"""Restart-batched chain forward-backward: the CUDA kernel, its plain
version and the wrapper that picks between them by device.

Counterpart of ``forward_backward_chains_pallas_grouped``
(``remixt_tpu/ops/fb_pallas.py:1159``), whose TPU kernel is
``_fb_kernel_grouped`` (``fb_pallas.py:744``). The CUDA kernel is
``csrc/fb_grouped.cu``; its header says how it is laid out and what bounds
it. Contract, for R restarts, Q chains of L positions and S states:

* ``frame_b`` (R, N, S) per-restart emission log probabilities;
* ``static_bank`` (num_static, S, S) transition log-weights shared by all
  restarts, entry 0 the zero (cut) matrix;
* ``be_exp_b`` (R, J, S, S) per-restart exp-space breakend matrices;
* ``chain_bank_idx`` (Q, max(L-1, 1)) bank index per within-chain pair:
  below ``num_static`` a static class, ``num_static + j`` breakend j;
* ``chain_seg_map`` (Q, L) global segment per position, N on pads;
* ``chain_last`` (Q,) last real position per chain.

Returns alphas (R, N, S), betas (R, N, S) and log_norm (R,). Each step
shifts every lane by its maximum, multiplies ``exp(carry - max)`` by the
lane's matrix, and takes ``log(max(s, TINY)) + max``. The recursion runs
through the pad positions after a chain's end (cut steps with zero
frames), so the betas of real positions carry a per-chain constant shift
that cancels in every normalised consumer.
"""

import ctypes

import torch

from remixt_tpu_torch.ops.special import logsumexp

TINY = 1e-37

#: launches of the CUDA kernel (one launch runs both directions)
LAUNCHES = 0


def gather_frames(frame_b, chain_seg_map):
    """(R, N, S) → (R, Q, L, S) chain-major frames; pads take a zero row."""
    R, N, S = frame_b.shape
    Q, L = chain_seg_map.shape
    frame_ext = torch.cat(
        [frame_b, frame_b.new_zeros((R, 1, S))], dim=1)
    return frame_ext[:, chain_seg_map.reshape(-1).long()].reshape(R, Q, L, S)


def _scatter_and_norm(alphas_b, betas_b, chain_seg_map, chain_last, N):
    """(R, Q, L, S) chain outputs → (R, N, S) segment layout and the
    per-restart log normalizer (sum of per-chain log norms)."""
    R, Q, L, S = alphas_b.shape
    last = chain_last.long().to(alphas_b.device)
    alpha_last = alphas_b[:, torch.arange(Q, device=alphas_b.device), last]
    log_norm = logsumexp(alpha_last, dim=-1).sum(dim=-1)
    # every segment sits at exactly one chain position: gather, no scatter
    flat = chain_seg_map.reshape(-1).long()
    pos = torch.empty(N, dtype=torch.long, device=flat.device)
    real = flat < N
    pos[flat[real]] = torch.arange(Q * L, device=flat.device)[real]
    alphas = alphas_b.reshape(R, Q * L, S)[:, pos]
    betas = betas_b.reshape(R, Q * L, S)[:, pos]
    return alphas, betas, log_norm


def fb_grouped_reference(frames, static_exp, be_exp_b, chain_bank_idx):
    """Plain version of the kernel: chain-major frames (R, Q, L, S) in,
    chain-major alphas and betas (R, Q, L, S) out. A Python loop over the
    positions, batched over the R·Q lanes, each lane gathering its own
    matrix."""
    R, Q, L, S = frames.shape
    num_static = static_exp.shape[0]
    cbi = chain_bank_idx.long().to(frames.device)
    tiny = torch.tensor(TINY, dtype=frames.dtype, device=frames.device)

    def contract(u, b, reverse):
        is_be = b >= num_static
        M = static_exp[torch.where(is_be, 0, b)]             # (Q, S, S)
        eq = 'rqj,qij->rqi' if reverse else 'rqi,qij->rqj'
        s = torch.einsum(eq, u, M)
        lanes = torch.nonzero(is_be).flatten()
        if lanes.numel():
            Mb = be_exp_b[:, b[lanes] - num_static]          # (R, n, S, S)
            eqb = 'rnj,rnij->rni' if reverse else 'rni,rnij->rnj'
            s[:, lanes] = torch.einsum(eqb, u[:, lanes], Mb)
        return s

    alphas = torch.empty_like(frames)
    carry = frames[:, :, 0]
    alphas[:, :, 0] = carry
    for t in range(1, L):
        cmax = carry.amax(dim=-1, keepdim=True)
        s = contract(torch.exp(carry - cmax), cbi[:, t - 1], False)
        carry = torch.log(torch.maximum(s, tiny)) + cmax + frames[:, :, t]
        alphas[:, :, t] = carry

    betas = torch.empty_like(frames)
    carry = frames.new_zeros((R, Q, S))
    betas[:, :, L - 1] = carry
    for t in range(L - 1, 0, -1):
        c = carry + frames[:, :, t]
        cmax = c.amax(dim=-1, keepdim=True)
        s = contract(torch.exp(c - cmax), cbi[:, t - 1], True)
        carry = torch.log(torch.maximum(s, tiny)) + cmax
        betas[:, :, t - 1] = carry
    return alphas, betas


def _launch_threads(S):
    return min(1024, max(32, -(-S // 32) * 32))


def fb_grouped_cuda(frames, static_exp, be_exp_b, chain_bank_idx):
    """Launch the CUDA kernel on chain-major inputs; same contract as
    :func:`fb_grouped_reference`. Raises on anything it cannot serve."""
    global LAUNCHES
    from remixt_tpu_torch.ops import _build

    R, Q, L, S = frames.shape
    num_static = static_exp.shape[0]
    J = be_exp_b.shape[1]
    device = frames.device
    for name, x, dtype, shape in (
            ('frames', frames, torch.float32, (R, Q, L, S)),
            ('static_exp', static_exp, torch.float32, (num_static, S, S)),
            ('be_exp_b', be_exp_b, torch.float32, (R, J, S, S)),
            ('chain_bank_idx', chain_bank_idx, torch.int32,
             (Q, chain_bank_idx.shape[1]))):
        if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError('{}: expected {} {} on {}, got {} {} on {}'.format(
                name, dtype, shape, device, x.dtype, tuple(x.shape), x.device))
        if not x.is_contiguous():
            raise ValueError('{} must be contiguous'.format(name))
    if chain_bank_idx.shape[1] < L - 1:
        raise ValueError('chain_bank_idx has fewer than L-1 steps')
    if R * Q == 0:
        return torch.empty_like(frames), torch.empty_like(frames)

    lib = _build.load('fb_grouped')
    fn = lib.fb_grouped_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.fb_grouped_error_string.restype = ctypes.c_char_p
    lib.fb_grouped_error_string.argtypes = [ctypes.c_int]

    # a breakend-free problem still needs a valid pointer
    be = be_exp_b if J else frames.new_zeros(1)
    alphas = torch.empty_like(frames)
    betas = torch.empty_like(frames)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(frames.data_ptr(), static_exp.data_ptr(), be.data_ptr(),
                 chain_bank_idx.data_ptr(), alphas.data_ptr(),
                 betas.data_ptr(), R, Q, L, S, chain_bank_idx.shape[1],
                 num_static, J, _launch_threads(S), stream)
    if err != 0:
        raise RuntimeError('fb_grouped kernel launch failed: {}'.format(
            lib.fb_grouped_error_string(err).decode()))
    LAUNCHES += 1
    return alphas, betas


def forward_backward_chains_grouped(frame_b, static_bank, be_exp_b,
                                    chain_bank_idx, chain_seg_map,
                                    chain_last):
    """Restart-batched chain forward-backward (see the module docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    R, N, S = frame_b.shape
    frames = gather_frames(frame_b, chain_seg_map)
    static_exp = torch.exp(static_bank)
    if frame_b.device.type == 'cuda':
        alphas_b, betas_b = fb_grouped_cuda(
            frames.contiguous(), static_exp.contiguous(),
            be_exp_b.contiguous(), chain_bank_idx.to(torch.int32).contiguous())
    elif frame_b.device.type == 'cpu':
        alphas_b, betas_b = fb_grouped_reference(
            frames, static_exp, be_exp_b, chain_bank_idx)
    else:
        raise ValueError('unsupported device {}'.format(frame_b.device))
    return _scatter_and_norm(alphas_b, betas_b, chain_seg_map, chain_last, N)
