"""Carrying model state across from the JAX package.

The JAX package's ``Params`` and ``VState`` arrive as the NamedTuples
themselves or as dicts of numpy arrays — ``jax.tree.map(np.asarray,
x)._asdict()``, or the ``'params'`` / ``'state'`` entries of a fit snapshot
of either package — and become the port's NamedTuples of tensors. One
restart's trees and restart batches both convert; a leading restart axis is
kept where present.
"""

import numpy as np
import torch

from remixt_tpu_torch.models import engine as eng

#: ModelSpec arrays a port spec shares with a JAX spec, field by field
SPEC_ARRAYS = (
    'num_alleles_subclonal', 'hdel_override', 'loh_override',
    'is_hdel_plane', 'is_loh_plane', 'seg_class', 'is_telomere', 'be_n',
    'be_k', 'be_orient01', 'be_c1', 'be_c2', 'F', 'dsel', 'didx_onehot',
    'Ecls', 'A', 'expA', 'static_bank', 'bank_idx', 'chain_seg_map',
    'chain_bank_idx', 'chain_last', 'l', 'x', 'y', 'total_reads',
    'brk_states',
)

#: ModelSpec sizes a port spec shares with a JAX spec
SPEC_SIZES = ('N', 'S', 'M', 'B', 'K', 'C', 'J', 'T', 'Dn', 'Q', 'L',
              'num_static_bank', 'num_bank', 'cn_max')


def _tensor(value, device, dtype):
    a = np.array(value)
    if a.dtype.kind == 'f':
        return torch.as_tensor(a, dtype=dtype, device=device)
    return torch.as_tensor(a, device=device)


def _fields(d):
    return d._asdict() if hasattr(d, '_asdict') else d


def params_from_numpy(d, device, dtype):
    """JAX Params, or a dict of its numpy arrays → port Params."""
    d = _fields(d)
    return eng.Params(**{name: _tensor(d[name], device, dtype)
                         for name in eng.Params._fields})


def state_from_numpy(d, device, dtype):
    """JAX VState, or a dict of its numpy arrays → port VState."""
    d = _fields(d)
    return eng.VState(**{name: _tensor(d[name], device, dtype)
                         for name in eng.VState._fields})


def spec_arrays(spec):
    """The port spec's arrays as numpy, keyed as in the JAX spec."""
    return {name: getattr(spec, name).cpu().numpy() for name in SPEC_ARRAYS}
