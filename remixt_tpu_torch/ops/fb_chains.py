"""Single-restart chain forward-backward: the CUDA kernel, its plain
version and the wrapper that picks between them by device.

Counterpart of ``forward_backward_chains_pallas``
(``remixt_tpu/ops/fb_pallas.py:488``), whose TPU kernel is
``_fb_kernel_wrapped`` (``fb_pallas.py:152``). The CUDA kernel is
``csrc/fb_chains.cu``: one thread block cluster per (chain, direction);
its header says why and what bounds it. Contract, for Q chains of L
positions and S states:

* ``framelogprob`` (N, S) emission log probabilities;
* ``static_bank`` (num_static, S, S) transition log-weights, entry 0 the
  zero (cut) matrix;
* ``be_exp`` (J, S, S) exp-space breakend matrices;
* ``chain_bank_idx`` (Q, max(L-1, 1)) bank index per within-chain pair:
  below ``num_static`` a static class, ``num_static + j`` breakend j;
* ``chain_seg_map`` (Q, L) global segment per position, N on pads;
* ``chain_last`` (Q,) last real position per chain.

Returns alphas (N, S), betas (N, S) and the scalar log_norm, with the
recursion and the per-chain beta shift of ``ops/fb_grouped.py``, whose
frame gather and output scatter it reuses at one restart.
"""

import ctypes

import torch

from remixt_tpu_torch.ops import fb_grouped

#: launches of the CUDA kernel (one launch runs both directions)
LAUNCHES = 0

#: thread blocks per (chain, direction) cluster on the main path
CLUSTER = 4


def fb_chains_reference(frames, static_exp, be_exp, chain_bank_idx):
    """Plain version of the kernel: chain-major frames (Q, L, S) in,
    chain-major alphas and betas (Q, L, S) out. The restart-batched plain
    version at one restart: the two compute the same function."""
    alphas, betas = fb_grouped.fb_grouped_reference(
        frames[None], static_exp, be_exp[None], chain_bank_idx)
    return alphas[0], betas[0]


def _launch_threads(S, cluster):
    """Threads per block: whole warps over the block's column slice, times
    as many row groups as give the cluster about 2048 threads (all 46
    clusters of the whole-genome problem then fit on the card at once)."""
    per = -(-S // cluster)
    span = -(-per // 32) * 32
    return min(1024, span * max(1, 2048 // cluster // span))


def fb_chains_cuda(frames, static_exp, be_exp, chain_bank_idx,
                   cluster=None):
    """Launch the CUDA kernel on chain-major inputs; same contract as
    :func:`fb_chains_reference`. ``cluster`` blocks (1 to 8) share each
    (chain, direction). Raises on anything it cannot serve, a cluster
    launch the card refuses included."""
    global LAUNCHES
    from remixt_tpu_torch.ops import _build

    cluster = CLUSTER if cluster is None else int(cluster)
    if not 1 <= cluster <= 8:
        raise ValueError('cluster must be 1 to 8, got {}'.format(cluster))
    Q, L, S = frames.shape
    num_static = static_exp.shape[0]
    J = be_exp.shape[0]
    device = frames.device
    for name, x, dtype, shape in (
            ('frames', frames, torch.float32, (Q, L, S)),
            ('static_exp', static_exp, torch.float32, (num_static, S, S)),
            ('be_exp', be_exp, torch.float32, (J, S, S)),
            ('chain_bank_idx', chain_bank_idx, torch.int32,
             (Q, chain_bank_idx.shape[1]))):
        if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError('{}: expected {} {} on {}, got {} {} on {}'.format(
                name, dtype, shape, device, x.dtype, tuple(x.shape), x.device))
        if not x.is_contiguous():
            raise ValueError('{} must be contiguous'.format(name))
    if chain_bank_idx.shape[1] < L - 1:
        raise ValueError('chain_bank_idx has fewer than L-1 steps')
    if Q == 0:
        return torch.empty_like(frames), torch.empty_like(frames)

    lib = _build.load('fb_chains')
    fn = lib.fb_chains_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.fb_chains_error_string.restype = ctypes.c_char_p
    lib.fb_chains_error_string.argtypes = [ctypes.c_int]

    # a breakend-free problem still needs a valid pointer
    be = be_exp if J else frames.new_zeros(1)
    alphas = torch.empty_like(frames)
    betas = torch.empty_like(frames)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(frames.data_ptr(), static_exp.data_ptr(), be.data_ptr(),
                 chain_bank_idx.data_ptr(), alphas.data_ptr(),
                 betas.data_ptr(), Q, L, S, chain_bank_idx.shape[1],
                 num_static, cluster, _launch_threads(S, cluster), stream)
    if err != 0:
        raise RuntimeError('fb_chains kernel launch failed: {}'.format(
            lib.fb_chains_error_string(err).decode()))
    LAUNCHES += 1
    return alphas, betas


def forward_backward_chains(framelogprob, static_bank, be_exp, chain_bank_idx,
                            chain_seg_map, chain_last):
    """Single-restart chain forward-backward (see the module docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    N = framelogprob.shape[0]
    frames = fb_grouped.gather_frames(framelogprob[None], chain_seg_map)[0]
    static_exp = torch.exp(static_bank)
    if framelogprob.device.type == 'cuda':
        alphas, betas = fb_chains_cuda(
            frames.contiguous(), static_exp.contiguous(), be_exp.contiguous(),
            chain_bank_idx.to(torch.int32).contiguous())
    elif framelogprob.device.type == 'cpu':
        alphas, betas = fb_chains_reference(
            frames, static_exp, be_exp, chain_bank_idx)
    else:
        raise ValueError('unsupported device {}'.format(framelogprob.device))
    alphas, betas, log_norm = fb_grouped._scatter_and_norm(
        alphas[None], betas[None], chain_seg_map, chain_last, N)
    return alphas[0], betas[0], log_norm[0]
