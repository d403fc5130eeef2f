"""The port's blocked two-pass forward-backward
(``remixt_tpu_torch/ops/fb_blocked.py``) against the JAX package's
(``remixt_tpu/ops/fb_blocked.py``) on the same seeded inputs, in float64:
the cases of ``tests/test_fb_blocked.py`` (one chain at (N, B) ∈ {(24,
4), (23, 4), (17, 3), (30, 1), (9, 8)}; chains at B ∈ {2, 4}; normalized
posteriors), each also with its blocks split over virtual CPU devices.
Messages within atol 1e-9 of the JAX package's, log_norm at rtol 1e-12,
and the device split equal to the single-device run bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remixt_tpu.ops import fb_blocked as jblocked
from remixt_tpu.ops import fb_scan as jscan
from remixt_tpu_torch.ops import fb_blocked

from test_fb_pallas import build_problem

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

CPU3 = [torch.device('cpu')] * 3


def random_single_chain(seed, N, S=6, num_bank=4):
    rng = np.random.RandomState(seed)
    frame = -4.0 * rng.rand(N, S)
    bank = -3.0 * rng.rand(num_bank, S, S)
    bank[0] = 0.0
    bank_idx = rng.randint(num_bank, size=N - 1)
    return frame, bank, bank_idx


def assert_equal_runs(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize('N,B', [(24, 4), (23, 4), (17, 3), (30, 1), (9, 8)])
def test_blocked_matches_jax(N, B):
    frame, bank, bank_idx = random_single_chain(0, N)
    ref = jblocked.forward_backward_blocked(
        jnp.asarray(frame), jnp.asarray(bank), jnp.asarray(bank_idx), B)
    args = (torch.tensor(frame), torch.tensor(bank), torch.tensor(bank_idx),
            B)
    got = fb_blocked.forward_backward_blocked(*args)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-9)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-9)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-12)
    # and the serial scan's log normalizer
    _, _, ln = jscan.forward_backward(jnp.asarray(frame), jnp.asarray(bank),
                                      jnp.asarray(bank_idx))
    np.testing.assert_allclose(float(got[2]), float(ln), rtol=1e-12)
    assert_equal_runs(fb_blocked.forward_backward_blocked(
        *args, block_devices=CPU3), got)


def chains_problem():
    problem = build_problem(7, [19, 8, 3, 26], S=6, be_frac=0.3)
    return [np.asarray(problem[k]) for k in (
        'framelogprob', 'full_bank', 'chain_bank_idx', 'chain_seg_map',
        'chain_last')]


@pytest.mark.parametrize('B', [2, 4])
def test_chains_blocked_matches_jax(B):
    frame, bank, cbi, seg, last = chains_problem()
    frame, bank = frame.astype(np.float64), bank.astype(np.float64)
    ref = jblocked.forward_backward_chains_blocked(
        jnp.asarray(frame), jnp.asarray(bank), jnp.asarray(cbi),
        jnp.asarray(seg), jnp.asarray(last), B)
    args = [torch.tensor(x) for x in (frame, bank, cbi, seg, last)] + [B]
    got = fb_blocked.forward_backward_chains_blocked(*args)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-9)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-9)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-12)
    assert_equal_runs(fb_blocked.forward_backward_chains_blocked(
        *args, block_devices=CPU3[:2]), got)


@pytest.mark.parametrize('devices', [None, CPU3], ids=['one', 'three'])
def test_posteriors_from_blocked_are_normalized(devices):
    frame, bank, bank_idx = random_single_chain(5, 40, S=7)
    a, b, _ = fb_blocked.forward_backward_blocked(
        torch.tensor(frame), torch.tensor(bank), torch.tensor(bank_idx), 5,
        block_devices=devices)
    g = (a + b).numpy()
    g = g - g.max(axis=1, keepdims=True)
    p = np.exp(g)
    p /= p.sum(axis=1, keepdims=True)
    assert np.all(np.isfinite(p))
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-12)
    ja, jb, _ = jblocked.forward_backward_blocked(
        jnp.asarray(frame), jnp.asarray(bank), jnp.asarray(bank_idx), 5)
    jg = np.asarray(ja + jb)
    jg = jg - jg.max(axis=1, keepdims=True)
    jp = np.exp(jg)
    np.testing.assert_allclose(p, jp / jp.sum(axis=1, keepdims=True),
                               atol=1e-12)
