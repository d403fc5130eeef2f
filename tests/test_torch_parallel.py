"""The port's multi-device fitting against the JAX package's, on the CPU:
the JAX side on its 8 virtual CPU devices (``tests/conftest.py``), the
port on ``[torch.device('cpu')] * n``, both in float64.

* ``factor_devices`` (a verbatim copy), ``make_training_mesh`` and
  ``_production_mesh`` against the JAX meshes' shapes;
* the restart-sharded sweep and the 2D (restart × chain) training step
  against the JAX functions on the same mesh shapes, at atol / rtol 1e-9;
* the blocked sweep on a block mesh against the JAX blocked sweep and the
  port's chain-batched sweep;
* the chain-sharded route: each chain group through the ``fb_grouped``
  kernel's route, or through the plain scan without ``use_kernels``;
* ``tools/dryrun_multichip`` on 4 virtual devices.

The production fit on a mesh is in ``test_torch_parallel_fit.py``, the
small grid's restart × chain mesh and the cohort's device groups in
``test_torch_parallel_cohort.py``.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from remixt_tpu.analysis import pipeline as jax_pipeline
from remixt_tpu.models import engine as jeng
from remixt_tpu.models.fit import BreakpointModel as JaxModel
from remixt_tpu.parallel import chain as jax_chain
from remixt_tpu.parallel import distributed as jax_distributed
from remixt_tpu.parallel import restarts as jax_par
from remixt_tpu.simulations import simple as sim
from remixt_tpu_torch.analysis import pipeline as torch_pipeline
from remixt_tpu_torch.models import engine as teng
from remixt_tpu_torch.models.fit import BreakpointModel as TorchModel
from remixt_tpu_torch.models.fit_batched import fit_restarts_batched
from remixt_tpu_torch.parallel import chain as par_chain
from remixt_tpu_torch.parallel import distributed
from remixt_tpu_torch.parallel import restarts as par
from remixt_tpu_torch.tools import dryrun_multichip

from test_torch_parallel_fit import build_models, fit_data

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

CPU = torch.device('cpu')


def cpus(n):
    return [CPU] * n


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

FACTOR_CASES = [(8, 2, 2), (8, None, None), (8, 4, 1), (7, 2, 2), (8, 4, 2),
                (6, 4, None), (1, None, None), (12, 3, 2), (5, 1, 8)]


@pytest.mark.parametrize('n,restarts,blocks', FACTOR_CASES)
def test_factor_devices_matches_jax(n, restarts, blocks):
    assert distributed.factor_devices(n, restarts, blocks) == \
        jax_distributed.factor_devices(n, restarts, blocks)


def test_factor_devices_cases():
    assert distributed.factor_devices(8, num_restarts=2, num_blocks=2) == \
        (2, 2, 2)
    assert distributed.factor_devices(8) == (8, 1, 1)
    assert distributed.factor_devices(8, num_restarts=4, num_blocks=1) == \
        (4, 2, 1)
    assert distributed.factor_devices(7, num_restarts=2, num_blocks=2) == \
        (1, 7, 1)


@pytest.mark.parametrize('restarts,blocks', [(2, 2), (None, None), (4, 1),
                                             (3, None)])
def test_make_training_mesh_matches_jax(restarts, blocks):
    mesh = distributed.make_training_mesh(cpus(8), num_restarts=restarts,
                                          num_blocks=blocks)
    ref = jax_distributed.make_training_mesh(num_restarts=restarts,
                                             num_blocks=blocks)
    assert mesh.axis_names == ('restart', 'chain', 'block')
    assert mesh.shape == dict(ref.shape)
    assert mesh.size == ref.devices.size <= 8
    assert mesh.addressable_devices == cpus(mesh.size)


def test_make_training_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        distributed.make_training_mesh()


def test_mesh_shards_and_axes():
    devices = [torch.device('cpu')] * 8
    mesh = distributed.Mesh(np.asarray(devices, dtype=object).reshape(
        2, 2, 2), ('restart', 'chain', 'block'),
        processes=[0, 0, 0, 0, 1, 1, 1, 1])
    assert mesh.shape == {'restart': 2, 'chain': 2, 'block': 2}
    shards = mesh.restart_shards()
    assert [s.shape['restart'] for s in shards] == [1, 1]
    assert shards[1].axis_devices('chain') == devices[:2]
    assert len(mesh.addressable_devices) == 4
    with pytest.raises(ValueError, match='axis names'):
        distributed.Mesh(devices, ('restart', 'chain'))


@pytest.mark.parametrize('use_mesh', [True, False])
def test_production_mesh_matches_jax(use_mesh):
    config = {'use_device_mesh': use_mesh}
    mesh = torch_pipeline._production_mesh(config, num_restarts=4,
                                           devices=cpus(8))
    ref = jax_pipeline._production_mesh(config, num_restarts=4)
    if not use_mesh:
        assert mesh is None and ref is None
        return
    assert mesh.shape == dict(ref.shape) == {'restart': 4, 'chain': 2,
                                             'block': 1}
    assert torch_pipeline._production_mesh(config, num_restarts=4,
                                           devices=cpus(1)) is None
    assert torch_pipeline._production_mesh(config, devices=cpus(8)).shape[
        'restart'] == 8
    # the port's default is off, the JAX package's on
    assert torch_pipeline._production_mesh({}, devices=cpus(8)) is None


# ---------------------------------------------------------------------------
# the sharded sweep and training steps against the JAX functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def problem():
    """test_parallel.py's problem, built by both packages: (JAX spec,
    params, state), (port spec, params, state)."""
    data = sim.simulate_experiment(
        N=48, M=3, h=(0.08, 0.05, 0.025), cn_max=4, num_events=5,
        num_chains=4, seed=3)
    out = []
    for model in (
            JaxModel(data['x'], data['l'], data['adjacencies'],
                     data['breakpoints'], max_copy_number=4, max_depth=1e9,
                     min_segment_length=1.0, min_proportion_genotyped=0.0,
                     divergence_weight=1e-7, dtype=jnp.float64,
                     random_seed=0),
            TorchModel(data['x'], data['l'], data['adjacencies'],
                       data['breakpoints'], max_copy_number=4, max_depth=1e9,
                       min_segment_length=1.0, min_proportion_genotyped=0.0,
                       divergence_weight=1e-7, dtype=torch.float64,
                       random_seed=0, device='cpu')):
        spec = model._build_spec(3)
        params = spec.init_params(
            data['h'], 1e-7,
            total_mask=model._total_likelihood_mask.astype(float),
            allele_mask=model._allele_likelihood_mask.astype(float))
        out.append((spec, params, spec.init_state()))
    return out


def scaled(params, i):
    return params._replace(h=params.h * (1.0 + 0.05 * i))


def test_restart_sharded_sweep_matches_jax(problem):
    (jspec, jparams, jstate), (spec, params, state) = problem
    R = 4
    jmesh = jax_par.make_restart_mesh(jax.devices()[:4])
    jparams_b = jax_par.shard_restarts(jmesh, jax_par.stack_pytrees(
        [scaled(jparams, i) for i in range(R)]))
    jstate_b = jax_par.shard_restarts(jmesh, jax_par.stack_pytrees(
        [jstate] * R))
    with jmesh:
        ref = jax_par.make_sharded_sweep(jspec, jmesh)(jparams_b, jstate_b)

    mesh = par.make_restart_mesh(cpus(4))
    got = par.make_sharded_sweep(spec, mesh)(
        par.stack_pytrees([scaled(params, i) for i in range(R)]),
        par.stack_pytrees([state] * R))
    assert isinstance(got.posterior_marginals, par.ShardedTensor)
    assert got.posterior_marginals.sizes == [1] * 4
    got = par.gather(got, CPU)
    np.testing.assert_allclose(got.posterior_marginals.numpy(),
                               np.asarray(ref.posterior_marginals),
                               atol=1e-9)
    np.testing.assert_allclose(got.hmm_log_norm_const.numpy(),
                               np.asarray(ref.hmm_log_norm_const),
                               rtol=1e-9)
    np.testing.assert_allclose(got.p_breakpoint.numpy(),
                               np.asarray(ref.p_breakpoint), atol=1e-9)


@pytest.mark.parametrize('h_step', [0.0, 1e-6])
def test_2d_train_step_matches_jax(problem, h_step):
    """The 2D step on a 2 × 4 (restart × chain) mesh: posteriors,
    q(brk) and the ELL of each restart, and the h its step takes (a
    fixed-step ascent on the production objective), against the JAX
    step on the same mesh shape."""
    (jspec, jparams, jstate), (spec, params, state) = problem
    R = 2
    jmesh = JaxMesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                    ('restart', 'chain'))
    jparams_b = jax_par.shard_restarts(jmesh, jax_par.stack_pytrees(
        [scaled(jparams, i) for i in range(R)]))
    jstate_b = jax_par.shard_restarts(jmesh, jax_par.stack_pytrees(
        [jstate] * R))
    try:
        with jmesh:
            ref = jax_chain.make_2d_train_step(jspec, jmesh, h_step=h_step)(
                jparams_b, jstate_b)
    finally:
        jspec.chain_constraint = None

    mesh = distributed.Mesh(np.asarray(cpus(8), dtype=object).reshape(2, 4),
                            ('restart', 'chain'))
    try:
        step = par_chain.make_2d_train_step(spec, mesh, h_step=h_step)
        replicas = mesh.replicas[spec]
        assert [len(r.chain_groups) for r in replicas] == [4, 4]
        assert replicas[0] is not replicas[1] and spec not in replicas
        got = par.gather(step(par.stack_pytrees(
            [scaled(params, i) for i in range(R)]),
            par.stack_pytrees([state] * R)), CPU)
    finally:
        par_chain.enable_chain_sharding(spec, None)
    params_out, state_out, ell = got
    np.testing.assert_allclose(state_out.posterior_marginals.numpy(),
                               np.asarray(ref[1].posterior_marginals),
                               atol=1e-9)
    np.testing.assert_allclose(state_out.p_breakpoint.numpy(),
                               np.asarray(ref[1].p_breakpoint), atol=1e-9)
    np.testing.assert_allclose(ell.numpy(), np.asarray(ref[2]), rtol=1e-9)
    np.testing.assert_allclose(params_out.h.numpy(), np.asarray(ref[0].h),
                               rtol=1e-9)


def test_blocked_sweep_on_a_block_mesh_matches_jax(problem):
    """Every chain in 8 blocks over an 8-device block mesh: the sweep
    equals the JAX blocked sweep and stays within 1e-9 of the
    chain-batched sweep (``test_parallel.py``'s bound)."""
    (jspec, jparams, jstate), (spec, params, state) = problem
    jmesh = JaxMesh(np.asarray(jax.devices()), ('block',))
    jax_chain.enable_block_sharding(jspec, jmesh, num_blocks=8)
    jspec._jit_cache = {}
    try:
        with jmesh:
            ref = jax.jit(lambda p, s: jeng.variational_sweep(jspec, p, s))(
                jparams, jstate)
    finally:
        jax_chain.enable_block_sharding(jspec, None, num_blocks=1)
        jspec._jit_cache = {}

    plain = teng.variational_sweep(spec, params, state)
    par_chain.enable_block_sharding(
        spec, distributed.Mesh(cpus(8), ('block',)), num_blocks=8)
    try:
        assert spec.block_devices == cpus(8)
        got = teng.variational_sweep(spec, params, state)
    finally:
        par_chain.enable_block_sharding(spec, None, num_blocks=1)
    assert spec.num_chain_blocks == 1 and spec.block_devices is None
    np.testing.assert_allclose(got.posterior_marginals.numpy(),
                               np.asarray(ref.posterior_marginals),
                               atol=1e-9)
    # the emissions of the two packages agree to about 1e-12 relative
    np.testing.assert_allclose(float(got.hmm_log_norm_const),
                               float(ref.hmm_log_norm_const), rtol=1e-10)
    np.testing.assert_allclose(float(got.hmm_log_norm_const),
                               float(plain.hmm_log_norm_const), rtol=1e-12)
    assert float((got.posterior_marginals
                  - plain.posterior_marginals).abs().max()) < 1e-9


def test_chain_sharded_route_takes_no_kernel(problem, monkeypatch):
    """A chain-sharded spec without ``use_kernels`` takes the plain scan
    over its chain groups on both chain updates, as the JAX engine does
    under a chain constraint."""
    from remixt_tpu_torch.ops import fb_chains, fb_grouped
    _, (spec, params, state) = problem

    def refuse(*args, **kwargs):
        raise AssertionError('a kernel wrapper was called')

    monkeypatch.setattr(fb_grouped, 'forward_backward_chains_grouped', refuse)
    monkeypatch.setattr(fb_grouped, 'chain_major', refuse)
    monkeypatch.setattr(fb_chains, 'forward_backward_chains', refuse)
    assert not spec.use_kernels
    par_chain.enable_chain_sharding(
        spec, distributed.Mesh(cpus(3), ('chain',)))
    try:
        assert [g.rows for g in spec.chain_groups] == [
            slice(0, 2), slice(2, 3), slice(3, 4)]
        one = teng.variational_sweep(spec, params, state)
        both = teng.variational_sweeps_restarts(
            spec, par.stack_pytrees([params] * 2),
            par.stack_pytrees([state] * 2), 1)
    finally:
        par_chain.enable_chain_sharding(spec, None)
    monkeypatch.undo()
    ref = teng.variational_sweep(spec, params, state)
    for got in (one.posterior_marginals, both.posterior_marginals[1]):
        np.testing.assert_allclose(got.numpy(),
                                   ref.posterior_marginals.numpy(),
                                   atol=1e-12)


def test_chain_sharded_route_keeps_the_kernel(problem, monkeypatch):
    """A chain-sharded spec with ``use_kernels`` runs the ``fb_grouped``
    kernel's route once a chain group on both chain updates (its plain
    version on the CPU, each group under its renumbered breakend bank),
    and equals the unsharded kernel route and the plain scan."""
    from remixt_tpu_torch.ops import fb_chains, fb_grouped
    _, (spec, params, state) = problem
    params_b = par.stack_pytrees([scaled(params, i) for i in range(2)])
    state_b = par.stack_pytrees([state] * 2)
    plain = teng.variational_sweeps_restarts(spec, params_b, state_b, 1)
    monkeypatch.setattr(spec, 'use_kernels', True)
    whole = teng.variational_sweeps_restarts(spec, params_b, state_b, 1)
    whole_one = teng.variational_sweep(spec, params, state)

    calls = []
    chain_major = fb_grouped.chain_major

    def counted(frames, static_exp, be_exp_b, chain_bank_idx, scaled=None):
        calls.append((frames.shape[1], be_exp_b.shape[1],
                      int(chain_bank_idx.max())))
        return chain_major(frames, static_exp, be_exp_b, chain_bank_idx,
                           scaled)

    def refuse(*args, **kwargs):
        raise AssertionError('the unsharded kernel route was called')

    monkeypatch.setattr(fb_grouped, 'chain_major', counted)
    monkeypatch.setattr(fb_grouped, 'forward_backward_chains_grouped', refuse)
    monkeypatch.setattr(fb_chains, 'forward_backward_chains', refuse)
    par_chain.enable_chain_sharding(
        spec, distributed.Mesh(cpus(3), ('chain',)))
    try:
        groups = spec.chain_groups
        got = teng.variational_sweeps_restarts(spec, params_b, state_b, 1)
        got_one = teng.variational_sweep(spec, params, state)
    finally:
        par_chain.enable_chain_sharding(spec, None)
    num_static = spec.static_bank.shape[0]
    expect = [(g.rows.stop - g.rows.start, len(g.slots),
               int(g.bank_idx.max())) for g in groups]
    assert calls == expect * 2
    for q, j, top in expect:
        assert top < num_static + j
    for sharded, ref in ((got, whole), (got_one, whole_one)):
        np.testing.assert_allclose(sharded.posterior_marginals.numpy(),
                                   ref.posterior_marginals.numpy(),
                                   atol=1e-12)
        np.testing.assert_allclose(sharded.hmm_log_norm_const.numpy(),
                                   ref.hmm_log_norm_const.numpy(),
                                   rtol=1e-12)
    np.testing.assert_allclose(got.posterior_marginals.numpy(),
                               plain.posterior_marginals.numpy(), atol=1e-9)


def test_a_worker_error_is_raised(problem):
    _, (spec, params, state) = problem
    mesh = par.make_restart_mesh(cpus(2))

    def fail(params_b):
        raise ValueError('shard failed')

    with pytest.raises(ValueError, match='shard failed'):
        par.shard_restart_fn(mesh, fail, 1)(par.stack_pytrees([params] * 2))
    with pytest.raises(ValueError, match='do not split'):
        par.shard_restart_fn(mesh, lambda p: p, 1)(
            par.stack_pytrees([params] * 3))


def test_pad_restarts_repeats_the_last():
    tree = (torch.arange(6.).reshape(3, 2), torch.arange(3))
    padded = par.pad_restarts(tree, 5)
    assert padded[0].tolist() == [[0, 1], [2, 3], [4, 5], [4, 5], [4, 5]]
    assert padded[1].tolist() == [0, 1, 2, 2, 2]
    ref = jax_par.pad_restarts((jnp.arange(6.).reshape(3, 2),
                                jnp.arange(3)), 5)
    for got, want in zip(padded, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dryrun_multichip_on_four_virtual_devices(capsys):
    out = dryrun_multichip.dryrun_multichip(cpus(4))
    assert out['posterior_max_abs_diff'] < dryrun_multichip.SPOT_BAR
    assert out['blocked_posterior_max_abs_diff'] < \
        dryrun_multichip.BLOCKED_BAR
    assert len(out['ell']) == 2 and np.all(np.isfinite(out['ell']))
    printed = capsys.readouterr().out
    assert 'restart' in printed and 'blocked intra-chain sweep' in printed


def test_results_pickle_without_the_mesh():
    """A mesh fit's results are plain tensors on the model's device."""
    data = fit_data(5)
    _, torch_model = build_models(data, 1)
    fitted = fit_restarts_batched(
        torch_model(), [data['h']] * 3, [1e-7] * 3, chunk_size=2,
        mesh=par.make_restart_mesh(cpus(2)))
    assert len(fitted) == 3
    for f in fitted:
        assert all(torch.is_tensor(x) and x.device == CPU
                   for x in f['params'] + f['state'])
    pickle.loads(pickle.dumps(fitted))
