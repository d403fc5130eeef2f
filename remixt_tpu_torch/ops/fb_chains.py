"""Single-restart chain forward-backward: the CUDA kernel, its plain
version and the wrapper that picks between them by device.

Counterpart of ``forward_backward_chains_pallas``
(``remixt_tpu/ops/fb_pallas.py:488``), whose TPU kernel is
``_fb_kernel_wrapped`` (``fb_pallas.py:152``). The CUDA kernel is
``csrc/fb_chains.cu``: one thread block cluster per (chain, direction),
each block owning a slice of the states. Each chain's resident static
class (:func:`resident_classes`, its most used non-cut static class) stays
in the cluster's shared memory, a column slice a block, so that the steps
of that class read no matrix from L2. Warp 0 of each block keeps the
block's slice of the carry in registers and pushes the shifted slice into
every peer's shared memory with ``st.async``, counted on the peer's
transaction barrier, so that a step needs no cluster barrier; it loads
the next step's frame and class while a step runs. The source's header
says why and what bounds it; :func:`launch_plan` sizes its blocks and
shared memory and refuses a cluster size whose slice does not fit, and
:func:`trace` splits its steps on the card. Contract, for Q chains of L
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
a second kernel of ``csrc/fb_chains.cu`` on the same clusters, launch plan
and resident classes, which pushes its slice of each step's product and
writes each row one step late, once the product's normaliser is known.
"""

import ctypes

import numpy as np
import torch

from remixt_tpu_torch.ops import fb_grouped

#: launches of the CUDA kernels (one launch runs both directions), counted
#: under ``fb_grouped.COUNT_LOCK``
LAUNCHES = 0
LAUNCHES_SCALED = 0

#: thread blocks per (chain, direction) cluster of both kernels on the main
#: path: at whole-genome width the one size at which the card holds all 46
#: clusters at once (``chip_smoke.py`` phases 2b and 2d)
CLUSTER = 5


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


def chains_base_floats(S, per):
    """Shared memory of both kernels before their partial sums, in
    floats, as ``chains_base_floats`` of ``csrc/fb_chains.cu`` counts it:
    the resident slice (S x per), u (2 x Sp, S rounded up to a multiple of
    4), the peers' (max, sum, class) (2 x 8 x 4) and the two exchange
    barriers (2 x 8 bytes)."""
    return S * per + 2 * (-(-S // 4) * 4) + 2 * 8 * 4 + 4


def launch_plan(S, cluster):
    """Block and shared memory of both kernels for S states on
    clusters of ``cluster`` blocks (the grid is cluster x Q x 2). Each block
    owns ``per`` states, a multiple of 4 (the products read 4 columns at
    once), and holds the resident class's column slice of them. Threads:
    about 2560 a cluster in whole warps, at least the slice (320 at C=8, so
    that three blocks of 64 registers a thread share an SM). The products
    take ``row_groups`` row groups, the same number for each of the
    ``cluster`` parts of u (so that a thread's rows come from one block),
    as many as the threads give and their partial sums fit in
    ``SMEM_LIMIT``; ``smem_bytes`` is the dynamic shared memory a block.
    Raises ``ValueError`` for a cluster size outside 1 to 8 or one whose
    slice does not fit."""
    if not 1 <= cluster <= 8:
        raise ValueError('cluster must be 1 to 8, got {}'.format(cluster))
    per = -(-S // cluster) + 3 & ~3
    if per > 128:
        raise ValueError('a slice of {} states does not fit one warp\'s '
                         'quads (128 states) on clusters of {}'.format(
                             per, cluster))
    threads = min(1024, max(-(-per // 32) * 32, 2560 // cluster // 32 * 32))
    base = chains_base_floats(S, per)
    # the partial sums take per floats a row group
    per_part = min(threads // (per // 4) // cluster, per,
                   (fb_grouped.SMEM_LIMIT // 4 - base) // (per * cluster))
    if per_part < 1:
        raise ValueError('the resident slice of {} states does not fit a '
                         'block\'s shared memory on clusters of {}'.format(
                             S, cluster))
    groups = per_part * cluster
    return dict(per=per, threads=threads, row_groups=groups,
                smem_bytes=4 * (base + groups * per))


def resident_classes(chain_bank_idx, num_static, steps):
    """Each chain's resident class, (Q,) int32: the non-cut static class
    its first ``steps`` steps use most, the lowest on a tie, -1 where they
    use none. Device work only, no host sync."""
    Q = chain_bank_idx.shape[0]
    if num_static < 2 or steps < 1:
        return torch.full((Q,), -1, dtype=torch.int32,
                          device=chain_bank_idx.device)
    cbi = chain_bank_idx[:, :steps]
    classes = torch.arange(1, num_static, dtype=cbi.dtype, device=cbi.device)
    counts = (cbi[:, :, None] == classes).sum(dim=1)
    # the first of equal maxima: the lowest class
    most, best = counts.max(dim=1)
    return torch.where(most > 0, best + 1, -1).to(torch.int32)


def max_active_clusters(S, cluster, scaled=False):
    """How many clusters of the log-space kernel (or with ``scaled`` the
    scaled one) the card holds at once at ``launch_plan(S, cluster)``
    (``cudaOccupancyMaxActiveClusters``)."""
    from remixt_tpu_torch.ops import _build
    plan = launch_plan(S, cluster)
    fn = _build.load('fb_chains').fb_chains_max_active_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    count = ctypes.c_int(0)
    err = fn(int(scaled), cluster, plan['threads'], plan['smem_bytes'],
             ctypes.byref(count))
    if err != 0:
        raise RuntimeError('fb_chains occupancy query failed: error {}'.format(
            err))
    return count.value


def launcher(frames, static_exp, be_exp, chain_bank_idx, cluster=None,
             scaled=False, defines=()):
    """A kernel launch on chain-major inputs, prepared: ``(run, (alphas,
    betas))``, where each ``run()`` launches the log-space kernel (or with
    ``scaled`` the scaled one, from the library built with macros
    ``defines``) into the outputs and counts the launch. The checks, the
    launch plan, the padded statics, the resident classes and the outputs
    are made here, once. Raises on anything the kernel cannot serve."""
    cluster = CLUSTER if cluster is None else int(cluster)
    if not 1 <= cluster <= 8:
        raise ValueError('cluster must be 1 to 8, got {}'.format(cluster))
    Q, L, S = frames.shape
    fb_grouped.check_inputs(frames, static_exp, be_exp, chain_bank_idx)
    alphas = torch.empty_like(frames)
    betas = torch.empty_like(frames)
    if Q == 0:
        return (lambda: None), (alphas, betas)

    plan = launch_plan(S, cluster)
    num_static = static_exp.shape[0]
    if scaled:
        fn, err_string = fb_grouped.load_launcher(
            'fb_chains', 'fb_chains_scaled_launch', 8, 8, defines)
        inputs = fb_grouped.shift_frames(frames)
    else:
        fn, err_string = fb_grouped.load_launcher(
            'fb_chains', 'fb_chains_launch', 7, 8, defines)
        inputs = (frames,)
    # a breakend-free problem still needs a valid pointer
    be = be_exp if be_exp.shape[0] else frames.new_zeros(1)
    resident = resident_classes(chain_bank_idx, num_static, L - 1)
    args = tuple(inputs) + (
        fb_grouped.pad_statics(static_exp), be, chain_bank_idx, resident,
        alphas, betas, Q, L, S, chain_bank_idx.shape[1], num_static, cluster,
        plan['threads'], plan['smem_bytes'])
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    values = [x.data_ptr() if torch.is_tensor(x) else x for x in args]

    def run():
        global LAUNCHES, LAUNCHES_SCALED
        with torch.cuda.device(frames.device):
            err = fn(*values, stream)
        if err != 0:
            raise RuntimeError('fb_chains{} kernel launch failed: {}'.format(
                '_scaled' if scaled else '', err_string(err).decode()))
        with fb_grouped.COUNT_LOCK:
            if scaled:
                LAUNCHES_SCALED += 1
            else:
                LAUNCHES += 1
    # the prepared tensors live as long as the launch can run
    run.inputs = args
    return run, (alphas, betas)


def fb_chains_cuda(frames, static_exp, be_exp, chain_bank_idx,
                   cluster=None):
    """Launch the CUDA kernel on chain-major inputs; same contract as
    :func:`fb_chains_reference`. ``cluster`` blocks (1 to 8; ``None``
    means ``CLUSTER``) share each (chain, direction). Raises on anything it
    cannot serve: a cluster size whose resident slice does not fit
    (:func:`launch_plan`), a cluster launch the card refuses."""
    run, out = launcher(frames, static_exp, be_exp, chain_bank_idx, cluster)
    run()
    return out


def fb_chains_scaled_cuda(frames, static_exp, be_exp, chain_bank_idx,
                          cluster=None):
    """Launch the scaled CUDA kernel on chain-major inputs; same contract
    as :func:`fb_chains_scaled_reference`, and the launch rules of
    :func:`fb_chains_cuda`. The frame shift runs here, in torch."""
    run, out = launcher(frames, static_exp, be_exp, chain_bank_idx, cluster,
                        scaled=True)
    run()
    return out


#: the columns of :func:`trace`
TRACE_COLUMNS = ('loads', 'exchange', 'product', 'epilogue', 'cut',
                 'resident', 'static', 'breakend', 'start_ns', 'end_ns')


def trace(frames, static_exp, be_exp, chain_bank_idx, cluster=None,
          scaled=False):
    """One launch of the log-space kernel (or with ``scaled`` the scaled
    one) built with ``FB_CHAINS_TRACE`` on chain-major CUDA inputs: per
    (chain, direction), rows 2q and 2q + 1
    of a (2Q, 10) int64 array, the cycles its steps spent in each part
    (``TRACE_COLUMNS``: warp 0's loads of the next step's inputs, the
    exchange's wait, the product with its block barrier, warp 0's epilogue,
    shift and push; the scaled kernel's epilogue writes the last
    product's row there too), its number of cut, resident, other static
    and breakend steps, and the nanoseconds at its start and end. Chains
    past the 64th are not traced."""
    from remixt_tpu_torch.ops import _build
    defines = ('FB_CHAINS_TRACE',)
    run, out = launcher(frames, static_exp, be_exp, chain_bank_idx, cluster,
                        scaled=scaled, defines=defines)
    run()
    torch.cuda.synchronize(frames.device)
    fn = _build.load('fb_chains', defines).fb_chains_trace_read
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    parts = (ctypes.c_longlong * (2 * 64 * len(TRACE_COLUMNS)))()
    if fn(ctypes.addressof(parts)) != 0:
        raise RuntimeError('fb_chains trace read failed')
    rows = np.frombuffer(parts, dtype=np.int64).reshape(128, -1)
    return rows[:2 * min(frames.shape[0], 64)].copy()


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
