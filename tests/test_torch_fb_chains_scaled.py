"""The scaled single-restart chain kernel's exchange
(``fb_chains_scaled_kernel`` in ``remixt_tpu_torch/csrc/fb_chains.cu``)
on the CPU, where no kernel runs.

(a) a float64 emulation of the kernel's arithmetic, written here and not in
    the package: per-block slices of the states, each block pushing its
    slice of the product over ``max(m_c, TINY)`` with ``(m_c, sum)``, the
    common normaliser ``m`` taken after the exchange, each peer's part of
    the next product scaled by ``max(m_c, TINY) / m`` after its rows are
    summed, and each row written one step late, once its ``m`` is known.
    It matches the plain version ``fb_chains_scaled_reference`` at atol
    1e-10 on the log messages, on ``test_torch_fb_chains.py``'s problems
    (several static classes a chain, breakends) at two state counts and
    two cluster sizes, so the algebra holds before the card checks the
    kernel;
(b) the scaled CUDA route checks the cluster size, and refuses one whose
    resident slice does not fit, before any library load.

The kernel itself is held against the plain version on the card by
``chip_smoke.py`` phase 2d.
"""

import math

import numpy as np
import pytest
import torch

from remixt_tpu_torch.ops import _build, fb_chains, fb_grouped

from test_fb_pallas import build_problem
from test_torch_fb_chains import CASES

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

TINY = fb_grouped.TINY


def publish(s, blocks, weight):
    """Each block's push of its slice of the product s: ``(m_c, p_c,
    sum(p_c))`` with ``p_c = s_c / max(m_c, TINY)``, times ``weight`` (the
    reverse direction's next frame) where given."""
    pushed = []
    for rows in blocks:
        s_c = s[rows]
        m_c = float(s_c.max()) if s_c.numel() else 0.0
        p_c = s_c / max(m_c, TINY)
        if weight is not None:
            p_c = p_c * weight[rows]
        pushed.append((m_c, p_c, float(p_c.sum())))
    return pushed


def emulate_scaled(frames, static_exp, be_exp, cbi, cluster):
    """The scaled kernel's arithmetic on chain-major inputs (Q, L, S), its
    blocks of ``launch_plan(S, cluster)['per']`` states; returns alphas
    and betas (Q, L, S)."""
    Q, L, S = frames.shape
    per = fb_chains.launch_plan(S, cluster)['per']
    blocks = [slice(c * per, min(S, (c + 1) * per)) for c in range(cluster)]
    num_static = static_exp.shape[0]
    fexp, fmax = fb_grouped.shift_frames(frames)
    out = {False: torch.empty_like(frames), True: torch.empty_like(frames)}
    for q in range(Q):
        for reverse in (False, True):
            # the first vector goes through the same push: forward fexp[0]
            # at scale fmax[0], reverse 1 at scale 0
            s = frames.new_ones(S) if reverse else fexp[q, 0]
            pushed = publish(s, blocks, fexp[q, L - 1] if reverse else None)
            scale = 0.0
            for step in range(1, L + 1):
                t = L - step if reverse else step
                m = max(max(m_c for m_c, _, _ in pushed), TINY)
                factor = [max(m_c, TINY) / m for m_c, _, _ in pushed]
                # the last product's row, one step late
                if reverse:
                    fm = float(fmax[q, t + 1]) if step > 1 else 0.0
                else:
                    fm = float(fmax[q, step - 1])
                scale = scale + math.log(m) + fm
                out[reverse][q, t if reverse else t - 1] = (
                    torch.log(torch.clamp(s * (1.0 / m), min=TINY)) + scale)
                if step == L:
                    break
                b = int(cbi[q, t - 1])
                if b == 0:
                    total = sum(sum_c * f for (_, _, sum_c), f
                                in zip(pushed, factor))
                    s = frames.new_full((S,), total)
                elif b >= num_static and reverse:
                    # a reverse breakend step rescales the input first
                    M = be_exp[b - num_static]
                    s = M @ torch.cat([p_c * f for (_, p_c, _), f
                                       in zip(pushed, factor)])
                else:
                    M = static_exp[b] if b < num_static else (
                        be_exp[b - num_static])
                    if reverse:
                        M = M.T
                    # each peer's rows summed, then scaled by its factor
                    s = sum(f * (p_c @ M[rows]) for (_, p_c, _), f, rows
                            in zip(pushed, factor, blocks))
                if not reverse:
                    s = s * fexp[q, t]
                more = step + 1 < L
                pushed = publish(s, blocks, fexp[q, t - 1] if reverse and more
                                 else None)
    return out[False], out[True]


@pytest.mark.parametrize('cluster', [3, 4])
@pytest.mark.parametrize('S', [7, 26])
@pytest.mark.parametrize('case', sorted(CASES))
def test_emulated_exchange_matches_the_plain_version(case, S, cluster):
    seed, chains, be_frac = CASES[case]
    problem = build_problem(seed + 40, chains, S=S, be_frac=be_frac)
    J = problem['num_breakends']
    as64 = lambda k: torch.as_tensor(np.array(problem[k]), dtype=torch.float64)
    frames = fb_grouped.gather_frames(
        as64('framelogprob')[None],
        torch.as_tensor(np.array(problem['chain_seg_map'])))[0]
    static_exp = torch.exp(as64('static_bank'))
    be_exp = torch.exp(as64('be_bank')[:J])
    cbi = torch.as_tensor(np.array(problem['chain_bank_idx']))
    per = fb_chains.launch_plan(S, cluster)['per']
    # at S=7 some blocks own no state and push only zeros
    assert ((cluster - 1) * per >= S) == (S == 7)

    got = emulate_scaled(frames, static_exp, be_exp, cbi, cluster)
    ref = fb_chains.fb_chains_scaled_reference(frames, static_exp, be_exp,
                                               cbi)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-10)


@pytest.mark.parametrize('cluster', [0, 1, 2, 9])
def test_scaled_cuda_checks_the_cluster_first(monkeypatch, cluster):
    """At 355 states a cluster size outside 1 to 8, or one whose resident
    slice does not fit a block (1, 2), raises before any library load."""

    def no_library(*args, **kwargs):
        raise AssertionError('no library may be loaded')

    monkeypatch.setattr(_build, 'load', no_library)
    monkeypatch.setattr(fb_grouped, 'load_launcher', no_library)
    S = 355
    match = 'cluster must be' if cluster in (0, 9) else 'does not fit'
    with pytest.raises(ValueError, match=match):
        fb_chains.fb_chains_scaled_cuda(
            torch.zeros((2, 4, S)), torch.zeros((2, S, S)),
            torch.zeros((0, S, S)), torch.zeros((2, 3), dtype=torch.int32),
            cluster=cluster)
