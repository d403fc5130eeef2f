"""The port's grid and cohort fits on device meshes against the JAX
package's, on the CPU (the JAX side on its 8 virtual CPU devices, the
port on ``[torch.device('cpu')] * 8``; float64):

* a grid smaller than the device count fits on the restart × chain mesh
  ``_production_mesh`` factors (4 × 2), against the JAX fit on its mesh
  at the tolerances of ``tests/test_parallel.py`` and against the port's
  single-device fit, on the plain scan and on the kernel's route;
* ``fit_many_cohort`` splits the devices into groups (two samples: two
  groups of 4) and fits each sample on its group's production mesh,
  against the JAX cohort fit on its 8 devices.
"""

import numpy as np
import torch

from remixt_tpu.analysis import pipeline as jax_pipeline
from remixt_tpu.config import get_sample_config as jax_sample_config
from remixt_tpu.models.fit_batched import fit_restarts_batched as jax_fit
from remixt_tpu_torch.analysis import pipeline as torch_pipeline
from remixt_tpu_torch.models.fit_batched import fit_restarts_batched

from test_torch_cohort import CONFIG as COHORT_CONFIG, SAMPLES, load
from test_torch_cohort import write_experiments
from test_torch_parallel_fit import assert_fits_close, build_models, fit_data

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)


# the port's default is off, the JAX package's on
MESH_ON = {'use_device_mesh': True}


def cpus(n):
    return [torch.device('cpu')] * n


def test_production_fit_small_grid_uses_a_2d_mesh():
    """R = 4 on 8 devices factors restart × chain (4 × 2): each restart
    shard scans its chains over its two devices."""
    data = fit_data(9)
    jax_model, torch_model = build_models(data, 3)
    R = 4
    h_inits = [data['h'] * (1.0 + 0.02 * i) for i in range(R)]
    weights = [1e-7, 1e-8, 1e-7, 1e-8]

    mesh = torch_pipeline._production_mesh(MESH_ON, num_restarts=R,
                                           devices=cpus(8))
    assert (mesh.shape['restart'], mesh.shape['chain']) == (4, 2)
    meshed = fit_restarts_batched(torch_model(), h_inits, weights,
                                  chunk_size=4, mesh=mesh)
    ref = jax_fit(jax_model(), h_inits, weights, chunk_size=4,
                  mesh=jax_pipeline._production_mesh({}, num_restarts=R))
    assert_fits_close(meshed, ref, marginals_atol=1e-6)
    single = fit_restarts_batched(torch_model(), h_inits, weights,
                                  chunk_size=1)
    assert_fits_close(meshed, single, marginals_atol=1e-9)


def test_production_fit_small_grid_on_a_2d_mesh_keeps_the_kernel():
    """The same 4 × 2 mesh fit with ``use_kernels``: each restart shard's
    two chain groups go through the ``fb_grouped`` kernel's route (its
    plain version on the CPU), against the JAX fit on its mesh and the
    port's single-device fit on the kernel's route."""
    from remixt_tpu_torch.ops import fb_grouped
    data = fit_data(9)
    jax_model, torch_model = build_models(data, 3)
    R = 4
    h_inits = [data['h'] * (1.0 + 0.02 * i) for i in range(R)]
    weights = [1e-7, 1e-8, 1e-7, 1e-8]

    def kernel_model():
        model = torch_model()
        model.use_kernels = True
        return model

    calls = []
    chain_major = fb_grouped.chain_major

    def counted(frames, *args, **kwargs):
        calls.append(frames.shape[1])
        return chain_major(frames, *args, **kwargs)

    mesh = torch_pipeline._production_mesh(MESH_ON, num_restarts=R,
                                           devices=cpus(8))
    fb_grouped.chain_major = counted
    try:
        meshed = fit_restarts_batched(kernel_model(), h_inits, weights,
                                      chunk_size=4, mesh=mesh)
    finally:
        fb_grouped.chain_major = chain_major
    # two chains, one a group, on each of 4 shards
    assert calls and set(calls) == {1} and len(calls) % 8 == 0
    ref = jax_fit(jax_model(), h_inits, weights, chunk_size=4,
                  mesh=jax_pipeline._production_mesh({}, num_restarts=R))
    assert_fits_close(meshed, ref, marginals_atol=1e-6)
    single = fit_restarts_batched(kernel_model(), h_inits, weights,
                                  chunk_size=1)
    assert_fits_close(meshed, single, marginals_atol=1e-9)


def test_fit_many_cohort_device_groups_match_jax(tmp_path):
    """Two samples on 8 devices: groups of 4, each sample fitted on its
    group's production mesh (sampleA's 4 restarts on 4 × 1, sampleB's 2
    on 2 × 2), against the JAX cohort fit on its 8 devices."""
    files = write_experiments(tmp_path, SAMPLES)
    jax_experiments = {s: load(f[0]) for s, f in files.items()}
    experiments = {s: load(f[1]) for s, f in files.items()}
    grids = {s: jax_pipeline.init(str(tmp_path / '{}_init.h5'.format(s)),
                                  files[s][0],
                                  jax_sample_config(COHORT_CONFIG, s))
             for s in SAMPLES}
    meshes = []
    production_mesh = torch_pipeline._production_mesh

    def recording(*args, **kwargs):
        mesh = production_mesh(*args, **kwargs)
        meshes.append(mesh.shape)
        return mesh

    torch_pipeline._production_mesh = recording
    try:
        got = torch_pipeline.fit_many_cohort(
            experiments, grids, dict(COHORT_CONFIG, **MESH_ON),
            devices=cpus(8))
    finally:
        torch_pipeline._production_mesh = production_mesh
    assert sorted((m['restart'], m['chain']) for m in meshes) == \
        [(2, 2), (4, 1)]
    ref = jax_pipeline.fit_many_cohort(jax_experiments, grids, COHORT_CONFIG)
    assert list(got) == sorted(SAMPLES)
    for sample_id in SAMPLES:
        assert set(got[sample_id]) == set(ref[sample_id])
        for init_id, r in ref[sample_id].items():
            g = got[sample_id][init_id]
            msg = '{} restart {}'.format(sample_id, init_id)
            np.testing.assert_allclose(g['h'], r['h'], rtol=1e-5,
                                       err_msg=msg)
            np.testing.assert_allclose(g['stats']['elbo'],
                                       r['stats']['elbo'], rtol=1e-6,
                                       err_msg=msg)
            np.testing.assert_array_equal(g['cn'], r['cn'], err_msg=msg)
