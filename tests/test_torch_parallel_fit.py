"""The port's production fit on a device mesh against the JAX package's,
on the CPU (the JAX side on its 8 virtual CPU devices, the port on
``[torch.device('cpu')] * 8``; float64): R = 11 restarts (the pad path)
at 5 EM × 5 VI on an 8-device mesh must equal the port's single-device
fit at the per-device wave bit for bit, and the JAX mesh fit of the same
shape at the tolerances of ``tests/test_parallel.py`` (h rtol 1e-5,
posteriors atol 1e-5, ELBO rtol 1e-6, grid points rtol 1e-9), with the
same decoded states. Never against the JAX single-device fit at rtol
1e-9: the JAX mesh fit is not that (``tests/test_pipeline.py``'s mesh
test, a known defect of the reference).
"""

import jax.numpy as jnp
import numpy as np
import torch

from remixt_tpu.models.fit import BreakpointModel as JaxModel
from remixt_tpu.models.fit_batched import fit_restarts_batched as jax_fit
from remixt_tpu.parallel import distributed as jax_distributed
from remixt_tpu.simulations import simple as sim
from remixt_tpu_torch.models.fit import BreakpointModel as TorchModel
from remixt_tpu_torch.models.fit_batched import fit_restarts_batched
from remixt_tpu_torch.parallel import distributed

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

CPU = torch.device('cpu')


def fit_data(seed):
    return sim.simulate_experiment(
        N=36, M=3, h=(0.08, 0.05, 0.025), cn_max=2, num_events=4,
        num_chains=2, seed=seed)


def build_models(data, depth):
    def jax_model():
        model = JaxModel(
            data['x'], data['l'], data['adjacencies'], data['breakpoints'],
            max_copy_number=2, max_depth=1e9, min_segment_length=1.0,
            min_proportion_genotyped=0.0, divergence_weight=1e-7,
            dtype=jnp.float64, random_seed=1234)
        model.num_em_iter = model.num_update_iter = depth
        return model

    def torch_model():
        model = TorchModel(
            data['x'], data['l'], data['adjacencies'], data['breakpoints'],
            max_copy_number=2, max_depth=1e9, min_segment_length=1.0,
            min_proportion_genotyped=0.0, divergence_weight=1e-7,
            dtype=torch.float64, random_seed=1234, device='cpu')
        model.num_em_iter = model.num_update_iter = depth
        return model
    return jax_model, torch_model


def assert_fits_equal(got, ref):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        for tree in ('params', 'state'):
            for name, x in g[tree]._asdict().items():
                assert torch.equal(x, getattr(r[tree], name)), (i, name)
        assert g['elbo'] == r['elbo'] and g['elbo_diff'] == r['elbo_diff']


def assert_fits_close(got, ref, marginals_atol):
    """``tests/test_parallel.py``'s tolerances."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        msg = 'restart {}'.format(i)
        np.testing.assert_allclose(g['params'].h.numpy(),
                                   np.asarray(r['params'].h), rtol=1e-5,
                                   err_msg=msg)
        marg = g['state'].posterior_marginals.numpy()
        ref_marg = np.asarray(r['state'].posterior_marginals)
        np.testing.assert_allclose(marg, ref_marg, atol=marginals_atol,
                                   err_msg=msg)
        np.testing.assert_array_equal(marg.argmax(axis=1),
                                      ref_marg.argmax(axis=1), err_msg=msg)
        np.testing.assert_allclose(g['elbo'], r['elbo'], rtol=1e-6,
                                   err_msg=msg)
        for name in ('negbin_r_0', 'negbin_r_1', 'betabin_M_0',
                     'betabin_M_1', 'betabin_loh_p'):
            np.testing.assert_allclose(
                getattr(g['params'], name).numpy(),
                np.asarray(getattr(r['params'], name)), rtol=1e-9,
                err_msg=msg + ' ' + name)


def test_production_fit_on_a_mesh():
    """R = 11 on 8 devices at 5 EM × 5 VI: the wave of 12 rounds up to 16,
    2 restarts a device, the last shards all padding."""
    data = fit_data(5)
    jax_model, torch_model = build_models(data, 5)
    R = 11
    h_inits = [data['h'] * (1.0 + 0.02 * i) for i in range(R)]
    weights = ([1e-7, 1e-8] * 6)[:R]

    mesh = distributed.make_training_mesh([CPU] * 8)
    assert mesh.shape['restart'] == 8
    model = torch_model()
    meshed = fit_restarts_batched(model, h_inits, weights, chunk_size=12,
                                  mesh=mesh)
    # the mesh leaves the model's spec as it was
    assert model.spec.chain_devices is None and spec_free(mesh, model.spec)
    single = fit_restarts_batched(torch_model(), h_inits, weights,
                                  chunk_size=2)
    assert_fits_equal(meshed, single)

    ref = jax_fit(jax_model(), h_inits, weights, chunk_size=12,
                  mesh=jax_distributed.make_training_mesh())
    assert_fits_close(meshed, ref, marginals_atol=1e-5)


def spec_free(mesh, spec):
    return spec not in mesh.replicas
