"""The port keeps its own copies of the JAX package's numpy-only modules;
they must give the same results: state enumeration, segmentation remap and
the count-level simulation."""

import numpy as np
import pytest

from remixt_tpu.models import remap as jremap
from remixt_tpu.models import states as jstates
from remixt_tpu.simulations import simple as jsim
from remixt_tpu_torch.models import remap as tremap
from remixt_tpu_torch.models import states as tstates
from remixt_tpu_torch.simulations import simple as tsim


@pytest.mark.parametrize('num_clones,cn_max', [(2, 3), (3, 4), (3, 6)])
def test_state_enumeration(num_clones, cn_max):
    cn = tstates.enumerate_cn_states(num_clones, 2, cn_max, 1)
    np.testing.assert_array_equal(
        cn, jstates.enumerate_cn_states(num_clones, 2, cn_max, 1))
    np.testing.assert_array_equal(
        tstates.enumerate_brk_states(num_clones, cn_max, 1),
        jstates.enumerate_brk_states(num_clones, cn_max, 1))
    for key, value in tstates.state_indicators(cn).items():
        np.testing.assert_array_equal(
            value, jstates.state_indicators(cn)[key], err_msg=key)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_simulation_and_remap(seed):
    kwargs = dict(N=120, M=3, cn_max=6, num_events=15, num_chains=3,
                  seed=seed)
    got, ref = tsim.simulate_experiment(**kwargs), \
        jsim.simulate_experiment(**kwargs)
    for key in ('cn', 'h', 'x', 'l'):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert got['adjacencies'] == ref['adjacencies']
    assert got['breakpoints'] == ref['breakpoints']

    breakpoints = list(ref['breakpoints'].values())
    t = tremap.SegmentRemap(120, ref['adjacencies'], breakpoints)
    j = jremap.SegmentRemap(120, ref['adjacencies'], breakpoints)
    for attr in ('seg_fwd_remap', 'seg_rev_remap', 'seg_is_original',
                 'is_telomere', 'breakpoint_idx', 'breakpoint_orient'):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr),
                                      err_msg=attr)
    for a, b in zip(t.expand_data(ref['x'], ref['l']),
                    j.expand_data(ref['x'], ref['l'])):
        np.testing.assert_array_equal(a, b)
