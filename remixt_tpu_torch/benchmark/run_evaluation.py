"""Count-level accuracy benchmark: simulate experiments → fit → evaluate.

Counterpart of the JAX package's ``benchmark/run_evaluation.py``, with the
same arguments: simulates an experiment pickle for every simulation of the
definition grid, fits each with the ``fit`` workflow over its whole
restart grid on ``--device`` (CUDA by default), evaluates the chosen
solution against the truth and merges the evaluations into one store.
Every step is a task of the port's scheduler, so a rerun skips what is on
disk and a run that was cut resumes.

Where h5py is installed the stores are HDF5 files in the JAX package's
layout (``results.h5``, ``evaluation.h5``); where it is not, they are
directories of TSV tables (``results``, ``evaluation``, ``io/store.py``).
The merged store is the ``table`` argument: an HDF5 file if its name ends
in ``.h5``, else a directory of TSV tables. ``export_evaluation`` reads
either.

Usage:
    python -m remixt_tpu_torch.benchmark.run_evaluation <sim_defs.yaml> \\
        <raw_data_dir> <table> [--config CONFIG] [--simulate_only] \\
        [--device DEVICE]

Simulations need ``chromosome_lengths`` in the sim defs: reading them from
a reference dataset (``--ref_data_dir``) is not ported yet.

Each task's start is logged with its time. The last line printed is a JSON
object: the run's wall time, the device with its peak memory (CUDA), and
each simulation's chosen restart and its ELBO.
"""

import argparse
import json
import logging
import os
import time

import torch

import remixt_tpu_torch.workflow
from remixt_tpu_torch.analysis import pipeline
from remixt_tpu_torch.device import resolve_device
from remixt_tpu_torch.io.store import read_store, store_name
from remixt_tpu_torch.scheduler import Workflow
from remixt_tpu_torch.simulations import pipeline as sim_pipeline


def create_workflow(sim_defs, raw_data_dir, table, config, ref_data_dir=None,
                    simulate_only=False, device=None):
    """The benchmark's tasks: per simulation ``simulate_experiment_<id>``,
    the fit workflow ``fit_<id>/...`` and ``evaluate_<id>``; then
    ``merge_evaluations`` into ``table``."""
    workflow = Workflow('evaluation_benchmark')

    evaluation_files = {}
    for sim_id, params in sim_defs.items():
        sim_dir = os.path.join(raw_data_dir, sim_id)
        os.makedirs(sim_dir, exist_ok=True)

        experiment_file = os.path.join(sim_dir, 'experiment.pickle')
        results_file = os.path.join(sim_dir, store_name('results'))
        evaluation_file = os.path.join(sim_dir, store_name('evaluation'))
        evaluation_files[sim_id] = evaluation_file

        workflow.transform(
            'simulate_experiment_{}'.format(sim_id),
            sim_pipeline.simulate_experiment,
            args=(experiment_file, None, params),
            outputs=[experiment_file],
        )

        if simulate_only:
            continue

        workflow.subworkflow(
            'fit_{}'.format(sim_id),
            remixt_tpu_torch.workflow.create_fit_model_workflow(
                experiment_file, results_file, config, ref_data_dir,
                os.path.join(sim_dir, 'fit'), device=device))

        workflow.transform(
            'evaluate_{}'.format(sim_id),
            sim_pipeline.evaluate_results_task,
            args=(evaluation_file, results_file),
            kwargs={'experiment_filename': experiment_file},
            inputs=[results_file, experiment_file],
            outputs=[evaluation_file],
        )

    if not simulate_only:
        workflow.transform(
            'merge_evaluations',
            sim_pipeline.merge_evaluations,
            args=(table, sim_defs, evaluation_files, ['sim_id']),
            inputs=list(evaluation_files.values()),
            outputs=[table],
        )
    return workflow


def chosen_restarts(sim_defs, raw_data_dir, config):
    """{sim_id: {init_id, elbo}} of each simulation's chosen solution."""
    chosen = {}
    for sim_id in sim_defs:
        stats = read_store(os.path.join(raw_data_dir, sim_id,
                                        store_name('results')),
                           keys=['stats'])['stats']
        init_id = pipeline.optimal_init_id(stats, config)
        row = list(stats['init_id']).index(init_id)
        chosen[sim_id] = {'init_id': int(init_id),
                          'elbo': float(stats['elbo'][row])}
    return chosen


def main(argv=None):
    argparser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    argparser.add_argument('sim_defs', help='Simulation definition filename')
    argparser.add_argument('raw_data_dir', help='Raw data directory')
    argparser.add_argument('table', help='Output table filename')
    argparser.add_argument('--ref_data_dir', default=None,
                           help='Reference dataset directory')
    argparser.add_argument('--config', required=False,
                           help='Configuration filename')
    argparser.add_argument('--simulate_only', action='store_true',
                           help='Simulate experiments then stop')
    argparser.add_argument('--maxjobs', type=int, default=1)
    argparser.add_argument('--device', default=None,
                           help='torch device of the fits (default: cuda)')

    args = vars(argparser.parse_args(argv))

    config = {}
    if args['config'] is not None:
        import yaml
        with open(args['config']) as f:
            config = yaml.safe_load(f)

    sim_defs = sim_pipeline.create_simulations(
        args['sim_defs'], config, args['ref_data_dir'])

    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(name)s %(message)s')
    device = (None if args['simulate_only']
              else resolve_device(args['device']))
    if device is not None and device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    os.makedirs(args['raw_data_dir'], exist_ok=True)
    t0 = time.time()
    workflow = create_workflow(
        sim_defs, args['raw_data_dir'], args['table'], config,
        ref_data_dir=args['ref_data_dir'],
        simulate_only=args['simulate_only'], device=args['device'])
    workflow.run(os.path.join(args['raw_data_dir'], 'work'),
                 max_jobs=args['maxjobs'])
    summary = {'wall_seconds': time.time() - t0}
    if device is not None:
        summary['device'] = device.type
        if device.type == 'cuda':
            summary['device_name'] = torch.cuda.get_device_name(0)
            summary['max_memory_allocated_gb'] = (
                torch.cuda.max_memory_allocated() / 1e9)
        summary['chosen'] = chosen_restarts(sim_defs, args['raw_data_dir'],
                                            config)
    print(json.dumps(summary), flush=True)


if __name__ == '__main__':
    main()
