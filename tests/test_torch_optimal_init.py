"""The optimal-initialization fit (breakpoint posteriors seeded from the
simulated truth, ``pipeline.fit`` with ``optimal_initialization``) of one
restart of a simulation's restart grid, in both packages, float64 on the
CPU: h, ELBO and the decoded copy number side by side.

The test runs it at a tiny simulation (N=150, max copy number 6, 1 EM × 2
VI) from the grid's last restart, the deepest minor-depth mode, and holds
the port to the JAX fit at ``test_torch_pipeline.py``'s bars: h rtol 1e-7,
ELBO rtol 1e-8, copy number exact.

As a script it makes the same comparison at the accuracy benchmark's first
simulation (``accuracy_0_0`` of ``benchmark/accuracy_sim_defs.yaml``,
N=5000, S=355) at the default depth, 5 EM × 5 VI, and prints it as JSON:

    env JAX_PLATFORMS=cpu python tests/test_torch_optimal_init.py \\
        [--restart 72]

``--num_em_iter`` cuts the depth; ``--plain`` fits without
``optimal_initialization``; ``--batched`` fits the restart's wave of 8
through both packages' batched ``fit_many``; ``--scan`` puts the port on
the scan route (``use_kernels=False``) instead of the CPU default, the
kernels' plain versions; ``--perturb EPS`` compares the JAX fit with the
JAX fit from the restart's normal depth scaled by 1 + EPS instead of with
the port's, which says how far the fit itself amplifies a difference of
that size.
"""

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def simulate(params, root):
    """The simulation in both packages, each pickled in ``root`` and read
    back as the workflow reads it: the JAX experiment and the port's, which
    equals it bit for bit. Both are read back from their pickles because
    the segment remap places the breakends of one junction in the
    iteration order of the breakpoints' frozensets, which a pickle round
    trip can change."""
    import remixt_tpu.simulations.pipeline as jax_sim
    from remixt_tpu_torch.simulations import pipeline as torch_sim

    experiments = []
    for name, sim in (('experiment.pickle', jax_sim),
                      ('port_experiment.pickle', torch_sim)):
        filename = os.path.join(root, name)
        sim.simulate_experiment(filename, None, params)
        with open(filename, 'rb') as f:
            experiments.append(pickle.load(f))
    return (os.path.join(root, 'experiment.pickle'),) + tuple(experiments)


def fit_both(params, init_id, config, root, perturb=None, use_kernels=None):
    """The JAX and the port's fits of restart ``init_id`` of the JAX
    package's grid for the simulation, and the restart's parameters. With
    ``perturb``, the second fit is the JAX fit from the restart's normal
    depth scaled by ``1 + perturb``; ``use_kernels`` is the port model's
    chain route."""
    from remixt_tpu.analysis import pipeline as jax_pipeline
    from remixt_tpu_torch.analysis import pipeline as torch_pipeline

    experiment_file, jax_experiment, experiment = simulate(params, root)
    init_params = jax_pipeline.init(os.path.join(root, 'init.h5'),
                                    experiment_file, config)[init_id]
    times = {}
    t0 = time.time()
    jax_fit = jax_pipeline.fit(jax_experiment, init_params, config)
    times['jax_seconds'] = time.time() - t0
    t0 = time.time()
    if perturb is None:
        model = torch_pipeline.build_model(experiment, init_params, config,
                                           device='cpu')
        model.use_kernels = use_kernels
        torch_fit = torch_pipeline.fit_with_model(model, experiment,
                                                  init_params, config)
    else:
        torch_fit = jax_pipeline.fit(
            jax_experiment, dict(init_params, h_normal=init_params[
                'h_normal'] * (1.0 + perturb)), config)
    times['port_seconds'] = time.time() - t0
    return jax_fit, torch_fit, init_params, times


def fit_wave_both(params, init_id, config, root, use_kernels=None,
                  wave=8):
    """Both packages' batched ``fit_many`` over the wave of ``wave``
    restarts of the JAX package's grid that holds ``init_id``; returns
    the two fits of ``init_id``, its parameters and the wall times."""
    from remixt_tpu.analysis import pipeline as jax_pipeline
    from remixt_tpu_torch.analysis import pipeline as torch_pipeline

    experiment_file, jax_experiment, experiment = simulate(params, root)
    grid = jax_pipeline.init(os.path.join(root, 'init.h5'), experiment_file,
                             config)
    first = init_id - init_id % wave
    chunk = {i: grid[i] for i in range(first, min(first + wave, len(grid)))}
    config = dict(config, batch_restarts=True, restart_chunk_size=wave)
    times = {}
    t0 = time.time()
    jax_fits = jax_pipeline.fit_many(jax_experiment, chunk, config)
    times['jax_seconds'] = time.time() - t0
    build_model = torch_pipeline.build_model

    def routed(*args, **kwargs):
        model = build_model(*args, **kwargs)
        model.use_kernels = use_kernels
        return model
    torch_pipeline.build_model = routed
    try:
        t0 = time.time()
        torch_fits = torch_pipeline.fit_many(experiment, chunk, config,
                                             device='cpu')
        times['port_seconds'] = time.time() - t0
    finally:
        torch_pipeline.build_model = build_model
    return jax_fits[init_id], torch_fits[init_id], grid[init_id], times


def compare(jax_fit, torch_fit):
    """h, ELBO and copy number of the two fits, and how far apart."""
    h_j, h_t = np.asarray(jax_fit['h']), np.asarray(torch_fit['h'])
    elbo_j, elbo_t = jax_fit['stats']['elbo'], torch_fit['stats']['elbo']
    return {
        'h_jax': h_j.tolist(), 'h_port': h_t.tolist(),
        'h_max_rel_diff': float(np.max(np.abs(h_t - h_j) / np.abs(h_j))),
        'elbo_jax': float(elbo_j), 'elbo_port': float(elbo_t),
        'elbo_rel_diff': float(abs(elbo_t - elbo_j) / abs(elbo_j)),
        'cn_equal_share': float(np.all(
            np.asarray(torch_fit['cn']) == np.asarray(jax_fit['cn']),
            axis=(1, 2)).mean()),
        'brk_cn_equal': bool(
            set(torch_fit['brk_cn']) == set(jax_fit['brk_cn'])
            and all(np.array_equal(torch_fit['brk_cn'][k], v)
                    for k, v in jax_fit['brk_cn'].items())),
    }


TINY_PARAMS = dict(
    h_total=0.1, N=150, M=3, frac_normal=0.4, frac_clone_1=0.4,
    num_false_breakpoints=5, proportion_breakpoints_detected=0.9,
    num_ancestral_events=8, num_descendent_events=4,
    proportion_subclonal=0.3, random_seed=1234,
    chromosome_lengths={'1': 60000000, '2': 50000000, '3': 40000000},
    chromosomes=['1', '2', '3'])
TINY_CONFIG = {'num_em_iter': 1, 'num_update_iter': 2, 'max_copy_number': 6,
               'engine_dtype': 'float64', 'use_device_mesh': False}


def test_optimal_initialization_from_the_deepest_mode_matches_jax(tmp_path):
    torch.set_num_threads(1)
    from remixt_tpu.analysis import pipeline as jax_pipeline

    experiment_file, _, _ = simulate(TINY_PARAMS, str(tmp_path))
    last = max(jax_pipeline.init(str(tmp_path / 'grid.h5'), experiment_file,
                                 TINY_CONFIG))
    jax_fit, torch_fit, init_params, _ = fit_both(
        TINY_PARAMS, last, dict(TINY_CONFIG, optimal_initialization=True),
        str(tmp_path))
    assert init_params['mode_idx'] > 0
    np.testing.assert_allclose(torch_fit['h'], jax_fit['h'], rtol=1e-7)
    np.testing.assert_allclose(torch_fit['stats']['elbo'],
                               jax_fit['stats']['elbo'], rtol=1e-8)
    result = compare(jax_fit, torch_fit)
    assert result['cn_equal_share'] == 1.0 and result['brk_cn_equal']


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--sim_id', default='accuracy_0_0')
    parser.add_argument('--restart', type=int, default=72)
    parser.add_argument('--num_em_iter', type=int, default=5)
    parser.add_argument('--perturb', type=float, default=None)
    parser.add_argument('--scan', action='store_true',
                        help='the port on the scan route (use_kernels=False)')
    parser.add_argument('--plain', action='store_true',
                        help='without optimal_initialization')
    parser.add_argument('--batched', action='store_true',
                        help='the restart within its wave of 8 through '
                        'the batched fit_many (implies --plain)')
    parser.add_argument('--work', default=os.path.join(
        REPO, 'build', 'optimal_init'))
    args = parser.parse_args(argv)

    import jax
    jax.config.update('jax_enable_x64', True)
    from remixt_tpu_torch.simulations import pipeline as torch_sim

    sim_defs = torch_sim.create_simulations(
        os.path.join(REPO, 'benchmark', 'accuracy_sim_defs.yaml'), {}, None)
    os.makedirs(args.work, exist_ok=True)
    config = {'engine_dtype': 'float64', 'use_device_mesh': False,
              'num_em_iter': args.num_em_iter,
              'optimal_initialization': not args.plain}
    use_kernels = False if args.scan else None
    if args.batched:
        jax_fit, other_fit, init_params, times = fit_wave_both(
            sim_defs[args.sim_id], args.restart,
            dict(config, optimal_initialization=False), args.work,
            use_kernels=use_kernels)
    else:
        jax_fit, other_fit, init_params, times = fit_both(
            sim_defs[args.sim_id], args.restart, config, args.work,
            perturb=args.perturb, use_kernels=use_kernels)
    print(json.dumps(dict(sim_id=args.sim_id, restart=args.restart,
                          num_em_iter=args.num_em_iter, perturb=args.perturb,
                          scan=args.scan, plain=args.plain,
                          batched=args.batched,
                          init_params=init_params, **times,
                          **compare(jax_fit, other_fit))))


if __name__ == '__main__':
    sys.path.insert(0, REPO)
    main()
