"""Restart-batched chain forward-backward: the CUDA kernel, its plain
version and the wrapper that picks between them by device.

Counterpart of ``forward_backward_chains_pallas_grouped``
(``remixt_tpu/ops/fb_pallas.py:1159``), whose TPU kernel is
``_fb_kernel_grouped`` (``fb_pallas.py:744``). The CUDA kernel is
``csrc/fb_grouped.cu``: one thread block cluster per (chain, direction,
tile of 8 restarts), which reads each static class matrix once per step
for the whole tile; its header says how it is laid out and what bounds it.
``fb_grouped_cuda`` takes ``cluster=`` (1 to 8 blocks; ``CLUSTER`` on the
main path) as ``fb_chains_cuda`` does, and ``launch_plan`` sizes its
blocks. Contract, for R restarts, Q chains of L positions and S states:

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

With ``SCALED_LINEAR`` (the ``REMIXT_TPU_SCALED_LINEAR=1`` switch of the
JAX package) the chain update takes the scaled-linear recursion instead,
the counterpart of ``_fb_kernel_grouped_scaled`` (``fb_pallas.py:911``):
the carry ``u`` stays linear, normalised by its maximum each step, with
a log scale beside it, and the frames enter as ``exp(frame - fmax)``. Its
messages are ``log(max(u, TINY)) + scale``; only the output is floored, so
states far below a lane's maximum differ from the log-space recursion,
which agrees with it on entries within 60 nats of the row maximum. Its
kernel is the second of ``csrc/fb_grouped.cu``, on the same clusters,
tiles and ``launch_plan`` (``scaled=True``); ``fb_grouped_scaled_cuda``
takes ``cluster=`` too.
"""

import ctypes
import os

import torch

from remixt_tpu_torch.ops.special import logsumexp

TINY = 1e-37

#: the scaled-linear recursion on both fit paths (read once at import, from
#: the switch the JAX package reads); ``scaled=None`` means this at call time
SCALED_LINEAR = os.environ.get('REMIXT_TPU_SCALED_LINEAR', '0') == '1'

#: launches of the CUDA kernels (one launch runs both directions)
LAUNCHES = 0
LAUNCHES_SCALED = 0

#: thread blocks per (chain, direction, restart tile) cluster of both
#: kernels on the main path
CLUSTER = 4
#: restarts per tile of both kernels (``RT`` in the source)
RESTART_TILE = 8
#: dynamic shared memory one block may take on the card (227 KB)
SMEM_LIMIT = 232448


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


def _contract(u, b, reverse, static_exp, be_exp_b):
    """Each lane's (R, Q, S) vector times its matrix at bank indices ``b``
    (Q,): ``u . M`` forward, ``M . u`` reverse."""
    num_static = static_exp.shape[0]
    is_be = b >= num_static
    M = static_exp[torch.where(is_be, 0, b)]                 # (Q, S, S)
    eq = 'rqj,qij->rqi' if reverse else 'rqi,qij->rqj'
    s = torch.einsum(eq, u, M)
    lanes = torch.nonzero(is_be).flatten()
    if lanes.numel():
        Mb = be_exp_b[:, b[lanes] - num_static]              # (R, n, S, S)
        eqb = 'rnj,rnij->rni' if reverse else 'rni,rnij->rnj'
        s[:, lanes] = torch.einsum(eqb, u[:, lanes], Mb)
    return s


def fb_grouped_reference(frames, static_exp, be_exp_b, chain_bank_idx):
    """Plain version of the kernel: chain-major frames (R, Q, L, S) in,
    chain-major alphas and betas (R, Q, L, S) out. A Python loop over the
    positions, batched over the R·Q lanes, each lane gathering its own
    matrix."""
    R, Q, L, S = frames.shape
    cbi = chain_bank_idx.long().to(frames.device)
    tiny = torch.tensor(TINY, dtype=frames.dtype, device=frames.device)

    alphas = torch.empty_like(frames)
    carry = frames[:, :, 0]
    alphas[:, :, 0] = carry
    for t in range(1, L):
        cmax = carry.amax(dim=-1, keepdim=True)
        s = _contract(torch.exp(carry - cmax), cbi[:, t - 1], False,
                      static_exp, be_exp_b)
        carry = torch.log(torch.maximum(s, tiny)) + cmax + frames[:, :, t]
        alphas[:, :, t] = carry

    betas = torch.empty_like(frames)
    carry = frames.new_zeros((R, Q, S))
    betas[:, :, L - 1] = carry
    for t in range(L - 1, 0, -1):
        c = carry + frames[:, :, t]
        cmax = c.amax(dim=-1, keepdim=True)
        s = _contract(torch.exp(c - cmax), cbi[:, t - 1], True, static_exp,
                      be_exp_b)
        carry = torch.log(torch.maximum(s, tiny)) + cmax
        betas[:, :, t - 1] = carry
    return alphas, betas


def shift_frames(frames):
    """The scaled recursion's frame input: ``fexp = exp(frames - fmax)``
    and ``fmax``, the maximum over the states (1 and 0 on pad positions)."""
    fmax = frames.amax(dim=-1)
    return torch.exp(frames - fmax[..., None]), fmax


def fb_grouped_scaled_reference(frames, static_exp, be_exp_b, chain_bank_idx):
    """Plain version of the scaled kernel, same contract as
    :func:`fb_grouped_reference`. Each step is ``s = (u . M) * fexp[t]``
    forward, ``s = M . (u * fexp[t])`` reverse (the cut class sums), then
    ``m = max(max(s), TINY)``, ``u = s / m``, ``scale += log(m) + fmax[t]``;
    the messages are ``log(max(u, TINY)) + scale``."""
    R, Q, L, S = frames.shape
    cbi = chain_bank_idx.long().to(frames.device)
    tiny = torch.tensor(TINY, dtype=frames.dtype, device=frames.device)
    fexp, fmax = shift_frames(frames)

    def normalise(s, scale, t):
        m = torch.maximum(s.amax(dim=-1, keepdim=True), tiny)
        return s * (1.0 / m), scale + torch.log(m) + fmax[:, :, t, None]

    def message(u, scale):
        return torch.log(torch.maximum(u, tiny)) + scale

    alphas = torch.empty_like(frames)
    u, scale = fexp[:, :, 0], fmax[:, :, 0, None]
    alphas[:, :, 0] = message(u, scale)
    for t in range(1, L):
        s = _contract(u, cbi[:, t - 1], False, static_exp, be_exp_b)
        u, scale = normalise(s * fexp[:, :, t], scale, t)
        alphas[:, :, t] = message(u, scale)

    betas = torch.empty_like(frames)
    u, scale = frames.new_ones((R, Q, S)), frames.new_zeros((R, Q, 1))
    betas[:, :, L - 1] = message(u, scale)
    for t in range(L - 1, 0, -1):
        s = _contract(u * fexp[:, :, t], cbi[:, t - 1], True, static_exp,
                      be_exp_b)
        u, scale = normalise(s, scale, t)
        betas[:, :, t - 1] = message(u, scale)
    return alphas, betas


def tile_base_floats(S, per):
    """Shared memory of the log-space kernel before its partial sums, in
    floats, as ``tile_base_floats`` of ``csrc/fb_grouped.cu`` counts it:
    the exchanged vectors (2 x S x RT), the carry and the double-buffered
    frame slices (3 x RT x per), the peers' (max, sum) (2 x 8 x RT x 2),
    each restart's maximum and sum (2 x RT), the staged classes (2)."""
    tile = RESTART_TILE
    return 2 * S * tile + 3 * tile * per + 32 * tile + 2 * tile + 2


def scaled_base_floats(S, per):
    """The same for the scaled kernel, as ``scaled_base_floats`` of
    ``csrc/fb_grouped.cu`` counts it: the product slice in place of the
    carry, and each restart's input sum, scale, inverse normaliser and
    double-buffered ``fmax`` (5 x RT) in place of its maximum and sum."""
    return tile_base_floats(S, per) + 3 * RESTART_TILE


def launch_plan(R, S, cluster, scaled=False):
    """Grid and block of the log-space kernel, or with ``scaled`` of the
    scaled one, for R restarts of S states on clusters of ``cluster``
    blocks: ``tiles`` of ``RESTART_TILE`` restarts (the grid is cluster ×
    Q × 2·tiles), ``threads`` a block and ``smem_bytes`` of dynamic shared
    memory. Each block owns ``per`` states, a multiple of 4 (the static
    product reads 4 columns at once). Threads: whole warps over the slice,
    times as many row groups as give the cluster about 2048 threads (as
    ``fb_chains``), and at least one warp per restart of a tile where a
    block can hold them. The static product's partial sums take as many of
    its row groups (``static_groups``) as fit in ``SMEM_LIMIT``."""
    tile = RESTART_TILE
    per = -(-S // cluster) + 3 & ~3
    span = -(-per // 32) * 32
    rows = max(1, 2048 // cluster // span, -(-tile * 32 // span))
    threads = min(1024, span * rows)
    base = (scaled_base_floats if scaled else tile_base_floats)(S, per)
    groups = min(threads // (per // 4), S)
    # red: the breakend and the static products' partial sums
    red = min(max(tile * threads, groups * tile * per),
              SMEM_LIMIT // 4 - base)
    groups = min(groups, red // (tile * per))
    if red < tile * threads or groups < 1:
        raise ValueError('{} states do not fit the kernel\'s shared memory '
                         'on clusters of {}'.format(S, cluster))
    return dict(tiles=-(-R // tile), threads=threads, per=per,
                static_groups=groups, smem_bytes=4 * (base + red))


def pad_statics(static_exp):
    """The static product's input: the static class matrices and their
    transposes, (2, num_static, S, Sp), rows zero-padded to Sp, a multiple
    of 4 floats."""
    n, S, _ = static_exp.shape
    statics = static_exp.new_zeros((2, n, S, -(-S // 4) * 4))
    statics[0, :, :, :S] = static_exp
    statics[1, :, :, :S] = static_exp.transpose(1, 2)
    return statics


def check_inputs(frames, static_exp, be_exp, chain_bank_idx):
    """Raise ``ValueError`` unless the kernel inputs are float32 (the
    schedule int32), contiguous, on one device and of matching shapes:
    ``frames`` (*lead, Q, L, S), ``be_exp`` (*lead, J, S, S)."""
    *lead, Q, L, S = frames.shape
    lead = tuple(lead)
    J = be_exp.shape[len(lead)] if be_exp.dim() == len(lead) + 3 else 0
    for name, x, dtype, shape in (
            ('frames', frames, torch.float32, lead + (Q, L, S)),
            ('static_exp', static_exp, torch.float32,
             (static_exp.shape[0], S, S)),
            ('be_exp', be_exp, torch.float32, lead + (J, S, S)),
            ('chain_bank_idx', chain_bank_idx, torch.int32,
             (Q, chain_bank_idx.shape[1]))):
        if (x.device != frames.device or x.dtype != dtype
                or tuple(x.shape) != shape):
            raise ValueError('{}: expected {} {} on {}, got {} {} on {}'.format(
                name, dtype, shape, frames.device, x.dtype, tuple(x.shape),
                x.device))
        if not x.is_contiguous():
            raise ValueError('{} must be contiguous'.format(name))
    if chain_bank_idx.shape[1] < L - 1:
        raise ValueError('chain_bank_idx has fewer than L-1 steps')


def load_launcher(unit, entry, num_ptrs, num_ints):
    """The ``extern "C"`` launch function ``entry`` of kernel library
    ``unit`` (built on first use) and its error-string accessor."""
    from remixt_tpu_torch.ops import _build
    lib = _build.load(unit)
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * num_ptrs + [ctypes.c_int] * num_ints
                   + [ctypes.c_void_p])
    err_string = getattr(lib, unit + '_error_string')
    err_string.restype = ctypes.c_char_p
    err_string.argtypes = [ctypes.c_int]
    return fn, err_string


def _launch(scaled, frames, static_exp, be_exp_b, chain_bank_idx,
            cluster=None):
    global LAUNCHES, LAUNCHES_SCALED
    cluster = CLUSTER if cluster is None else int(cluster)
    if not 1 <= cluster <= 8:
        raise ValueError('cluster must be 1 to 8, got {}'.format(cluster))
    R, Q, L, S = frames.shape
    check_inputs(frames, static_exp, be_exp_b, chain_bank_idx)
    J = be_exp_b.shape[1]
    if R * Q == 0:
        return torch.empty_like(frames), torch.empty_like(frames)

    plan = launch_plan(R, S, cluster, scaled)
    statics = pad_statics(static_exp)
    if scaled:
        fn, err_string = load_launcher('fb_grouped', 'fb_grouped_scaled_launch',
                                       7, 10)
        fexp, fmax = shift_frames(frames)
        inputs = (fexp.data_ptr(), fmax.data_ptr(), statics.data_ptr())
    else:
        fn, err_string = load_launcher('fb_grouped', 'fb_grouped_launch', 6,
                                       10)
        inputs = (frames.data_ptr(), statics.data_ptr())
    # a breakend-free problem still needs a valid pointer
    be = be_exp_b if J else frames.new_zeros(1)
    alphas = torch.empty_like(frames)
    betas = torch.empty_like(frames)
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    with torch.cuda.device(frames.device):
        err = fn(*inputs, be.data_ptr(),
                 chain_bank_idx.data_ptr(), alphas.data_ptr(),
                 betas.data_ptr(), R, Q, L, S, chain_bank_idx.shape[1],
                 static_exp.shape[0], J, cluster, plan['threads'],
                 plan['smem_bytes'], stream)
    if err != 0:
        raise RuntimeError('fb_grouped{} kernel launch failed: {}'.format(
            '_scaled' if scaled else '', err_string(err).decode()))
    if scaled:
        LAUNCHES_SCALED += 1
    else:
        LAUNCHES += 1
    return alphas, betas


def fb_grouped_cuda(frames, static_exp, be_exp_b, chain_bank_idx,
                    cluster=None):
    """Launch the CUDA kernel on chain-major inputs; same contract as
    :func:`fb_grouped_reference`. ``cluster`` blocks (1 to 8; ``None``
    means ``CLUSTER``) share each (chain, direction, restart tile). Raises
    on anything it cannot serve, a cluster launch the card refuses
    included."""
    return _launch(False, frames, static_exp, be_exp_b, chain_bank_idx,
                   cluster)


def fb_grouped_scaled_cuda(frames, static_exp, be_exp_b, chain_bank_idx,
                           cluster=None):
    """Launch the scaled CUDA kernel on chain-major inputs; same contract
    as :func:`fb_grouped_scaled_reference`, and the launch rules of
    :func:`fb_grouped_cuda`. The frame shift runs here, in torch, as the
    JAX wrapper runs it outside its kernel."""
    return _launch(True, frames, static_exp, be_exp_b, chain_bank_idx,
                   cluster)


def forward_backward_chains_grouped(frame_b, static_bank, be_exp_b,
                                    chain_bank_idx, chain_seg_map,
                                    chain_last, scaled=None):
    """Restart-batched chain forward-backward (see the module docstring).

    ``scaled`` picks the scaled-linear recursion; ``None`` means
    ``SCALED_LINEAR``. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    scaled = SCALED_LINEAR if scaled is None else scaled
    R, N, S = frame_b.shape
    frames = gather_frames(frame_b, chain_seg_map)
    static_exp = torch.exp(static_bank)
    if frame_b.device.type == 'cuda':
        launch = fb_grouped_scaled_cuda if scaled else fb_grouped_cuda
        alphas_b, betas_b = launch(
            frames.contiguous(), static_exp.contiguous(),
            be_exp_b.contiguous(), chain_bank_idx.to(torch.int32).contiguous())
    elif frame_b.device.type == 'cpu':
        plain = (fb_grouped_scaled_reference if scaled
                 else fb_grouped_reference)
        alphas_b, betas_b = plain(frames, static_exp, be_exp_b,
                                  chain_bank_idx)
    else:
        raise ValueError('unsupported device {}'.format(frame_b.device))
    return _scatter_and_norm(alphas_b, betas_b, chain_seg_map, chain_last, N)
