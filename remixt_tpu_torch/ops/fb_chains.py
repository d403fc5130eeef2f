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
frame gather and output scatter it reuses at one restart. The switch
``fb_grouped.SCALED_LINEAR`` selects the scaled-linear recursion here too:
the counterpart of ``_fb_kernel_scaled`` (``fb_pallas.py:260``), computed by
a second kernel of ``csrc/fb_chains.cu``.
"""

import torch

from remixt_tpu_torch.ops import fb_grouped

#: launches of the CUDA kernels (one launch runs both directions)
LAUNCHES = 0
LAUNCHES_SCALED = 0

#: thread blocks per (chain, direction) cluster on the main path
CLUSTER = 4


def fb_chains_reference(frames, static_exp, be_exp, chain_bank_idx):
    """Plain version of the kernel: chain-major frames (Q, L, S) in,
    chain-major alphas and betas (Q, L, S) out. The restart-batched plain
    version at one restart: the two compute the same function."""
    alphas, betas = fb_grouped.fb_grouped_reference(
        frames[None], static_exp, be_exp[None], chain_bank_idx)
    return alphas[0], betas[0]


def fb_chains_scaled_reference(frames, static_exp, be_exp, chain_bank_idx):
    """Plain version of the scaled kernel, same contract as
    :func:`fb_chains_reference`: the restart-batched plain scaled version
    at one restart."""
    alphas, betas = fb_grouped.fb_grouped_scaled_reference(
        frames[None], static_exp, be_exp[None], chain_bank_idx)
    return alphas[0], betas[0]


def _launch_threads(S, cluster):
    """Threads per block: whole warps over the block's column slice, times
    as many row groups as give the cluster about 2048 threads (all 46
    clusters of the whole-genome problem then fit on the card at once)."""
    per = -(-S // cluster)
    span = -(-per // 32) * 32
    return min(1024, span * max(1, 2048 // cluster // span))


def _launch(scaled, frames, static_exp, be_exp, chain_bank_idx, cluster):
    global LAUNCHES, LAUNCHES_SCALED
    cluster = CLUSTER if cluster is None else int(cluster)
    if not 1 <= cluster <= 8:
        raise ValueError('cluster must be 1 to 8, got {}'.format(cluster))
    Q, L, S = frames.shape
    fb_grouped.check_inputs(frames, static_exp, be_exp, chain_bank_idx)
    if Q == 0:
        return torch.empty_like(frames), torch.empty_like(frames)

    if scaled:
        fn, err_string = fb_grouped.load_launcher(
            'fb_chains', 'fb_chains_scaled_launch', 7, 7)
        fexp, fmax = fb_grouped.shift_frames(frames)
        frame_ptrs = (fexp.data_ptr(), fmax.data_ptr())
    else:
        fn, err_string = fb_grouped.load_launcher(
            'fb_chains', 'fb_chains_launch', 6, 7)
        frame_ptrs = (frames.data_ptr(),)
    # a breakend-free problem still needs a valid pointer
    be = be_exp if be_exp.shape[0] else frames.new_zeros(1)
    alphas = torch.empty_like(frames)
    betas = torch.empty_like(frames)
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    with torch.cuda.device(frames.device):
        err = fn(*frame_ptrs, static_exp.data_ptr(), be.data_ptr(),
                 chain_bank_idx.data_ptr(), alphas.data_ptr(),
                 betas.data_ptr(), Q, L, S, chain_bank_idx.shape[1],
                 static_exp.shape[0], cluster, _launch_threads(S, cluster),
                 stream)
    if err != 0:
        raise RuntimeError('fb_chains{} kernel launch failed: {}'.format(
            '_scaled' if scaled else '', err_string(err).decode()))
    if scaled:
        LAUNCHES_SCALED += 1
    else:
        LAUNCHES += 1
    return alphas, betas


def fb_chains_cuda(frames, static_exp, be_exp, chain_bank_idx,
                   cluster=None):
    """Launch the CUDA kernel on chain-major inputs; same contract as
    :func:`fb_chains_reference`. ``cluster`` blocks (1 to 8) share each
    (chain, direction). Raises on anything it cannot serve, a cluster
    launch the card refuses included."""
    return _launch(False, frames, static_exp, be_exp, chain_bank_idx,
                   cluster)


def fb_chains_scaled_cuda(frames, static_exp, be_exp, chain_bank_idx,
                          cluster=None):
    """Launch the scaled CUDA kernel on chain-major inputs; same contract
    as :func:`fb_chains_scaled_reference`, and the launch rules of
    :func:`fb_chains_cuda`. The frame shift runs here, in torch."""
    return _launch(True, frames, static_exp, be_exp, chain_bank_idx,
                   cluster)


def forward_backward_chains(framelogprob, static_bank, be_exp, chain_bank_idx,
                            chain_seg_map, chain_last, scaled=None):
    """Single-restart chain forward-backward (see the module docstring).

    ``scaled`` picks the scaled-linear recursion; ``None`` means
    ``fb_grouped.SCALED_LINEAR``. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    scaled = fb_grouped.SCALED_LINEAR if scaled is None else scaled
    N = framelogprob.shape[0]
    frames = fb_grouped.gather_frames(framelogprob[None], chain_seg_map)[0]
    static_exp = torch.exp(static_bank)
    if framelogprob.device.type == 'cuda':
        launch = fb_chains_scaled_cuda if scaled else fb_chains_cuda
        alphas, betas = launch(
            frames.contiguous(), static_exp.contiguous(), be_exp.contiguous(),
            chain_bank_idx.to(torch.int32).contiguous())
    elif framelogprob.device.type == 'cpu':
        plain = fb_chains_scaled_reference if scaled else fb_chains_reference
        alphas, betas = plain(frames, static_exp, be_exp, chain_bank_idx)
    else:
        raise ValueError('unsupported device {}'.format(framelogprob.device))
    alphas, betas, log_norm = fb_grouped._scatter_and_norm(
        alphas[None], betas[None], chain_seg_map, chain_last, N)
    return alphas[0], betas[0], log_norm[0]
