"""Read-level accuracy benchmark: simulated reads → run → fit → evaluate.

Counterpart of the JAX package's ``benchmark/run_read_benchmark.py``, with
its arguments and ``--device``: for every simulation of the definition
file, simulates the germline alleles (from the reference's impute2
panel), the genome mixture and the normal and tumour reads as seqdata;
runs each tool of the catalog on them (this package's ``run`` path from
seqdata, its fit on ``--device``, CUDA by default); evaluates the chosen
solution against the truth and merges the evaluations into ``table``.

Where h5py is installed the stores are HDF5 files (``normal.h5``,
``tumour.h5``, ``results_remixt.h5``, ``evaluation_remixt.h5``); where it
is not, directories (``io/store.store_name``). Chromosome lengths come from
the sim defs or, where they have none, from the reference's FASTA index.

Usage:
    python -m remixt_tpu_torch.benchmark.run_read_benchmark <ref_data_dir> \\
        <sim_defs.yaml> <raw_data_dir> <table> [--tools remixt] \\
        [--config CONFIG] [--maxjobs N] [--device DEVICE]

The last line printed is a JSON object: the run's wall time and the
device with its peak memory (CUDA).
"""

import argparse
import json
import logging
import os
import time

import torch

from remixt_tpu_torch import wrappers
from remixt_tpu_torch.device import resolve_device
from remixt_tpu_torch.io.store import store_name
from remixt_tpu_torch.scheduler import Workflow
from remixt_tpu_torch.simulations import pipeline as sim_pipeline
from remixt_tpu_torch.simulations import workflow as sim_workflow


def add_tool_tasks(workflow, sim_id, tools, seqdata, mixture_file,
                   breakpoints_file, paths, config, ref_data_dir, device,
                   evaluation_files):
    """Each tool's run on a simulation's seqdata ``{'normal', 'tumour'}``
    and its evaluation; ``paths(tool)`` gives (results, evaluation,
    work directory)."""
    for tool_name in tools:
        tool = wrappers.catalog[tool_name](config, ref_data_dir,
                                           device=device)
        results_file, evaluation_file, tool_dir = paths(tool_name)
        evaluation_files[(sim_id, tool_name)] = evaluation_file

        workflow.subworkflow(
            'run_{}_{}'.format(tool_name, sim_id),
            tool.create_workflow(seqdata, breakpoints_file, results_file,
                                 tool_dir, normal_id='normal'))

        workflow.transform(
            'evaluate_{}_{}'.format(tool_name, sim_id),
            sim_pipeline.evaluate_results_task,
            args=(evaluation_file, results_file),
            kwargs={'mixture_filename': mixture_file},
            inputs=[results_file, mixture_file],
            outputs=[evaluation_file],
        )


def create_workflow(sim_defs, raw_data_dir, table, config, ref_data_dir,
                    tools=('remixt',), device=None):
    """Per simulation the subworkflow ``simulate_<id>``, each tool's
    ``run_<tool>_<id>`` and ``evaluate_<tool>_<id>``; then
    ``merge_evaluations`` into ``table``."""
    workflow = Workflow('read_benchmark')
    evaluation_files = {}
    for sim_id, params in sim_defs.items():
        sim_dir = os.path.join(raw_data_dir, sim_id)
        os.makedirs(sim_dir, exist_ok=True)

        seqdata = {name: store_name(os.path.join(sim_dir, name))
                   for name in ('normal', 'tumour')}
        mixture_file = os.path.join(sim_dir, 'mixture.pickle')
        breakpoints_file = os.path.join(sim_dir, 'breakpoints.tsv')

        workflow.subworkflow(
            'simulate_{}'.format(sim_id),
            sim_workflow.create_read_simulation_workflow(
                params, seqdata['normal'], seqdata['tumour'], mixture_file,
                breakpoints_file, config, ref_data_dir,
                os.path.join(sim_dir, 'sim')))

        add_tool_tasks(
            workflow, sim_id, tools, seqdata, mixture_file,
            breakpoints_file, lambda tool: (
                store_name(os.path.join(sim_dir, 'results_' + tool)),
                store_name(os.path.join(sim_dir, 'evaluation_' + tool)),
                os.path.join(sim_dir, tool)),
            config, ref_data_dir, device, evaluation_files)

    workflow.transform(
        'merge_evaluations',
        sim_pipeline.merge_evaluations,
        args=(table, sim_defs, evaluation_files, ['sim_id', 'tool']),
        inputs=list(evaluation_files.values()),
        outputs=[table],
    )
    return workflow


def add_arguments(argparser):
    """The arguments both read-level runners share, after their own
    positional ones."""
    argparser.add_argument('raw_data_dir', help='Raw data directory')
    argparser.add_argument('table', help='Output table filename')
    argparser.add_argument('--tools', nargs='+', default=['remixt'],
                           choices=list(wrappers.catalog.keys()))
    argparser.add_argument('--config', required=False)
    argparser.add_argument('--maxjobs', type=int, default=1)
    argparser.add_argument('--device', default=None,
                           help='torch device of the fits (default: cuda)')


def run(args, create):
    """Read the config and the sim defs, check the device, run the
    workflow ``create(sim_defs, config)`` and print the summary line."""
    config = {}
    if args['config'] is not None:
        import yaml
        with open(args['config']) as f:
            config = yaml.safe_load(f)

    sim_defs = sim_pipeline.create_simulations(
        args['sim_defs'], config, args['ref_data_dir'])

    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(name)s %(message)s')
    device = resolve_device(args['device'])
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    os.makedirs(args['raw_data_dir'], exist_ok=True)
    t0 = time.time()
    create(sim_defs, config).run(
        os.path.join(args['raw_data_dir'], 'work'), max_jobs=args['maxjobs'])
    summary = {'wall_seconds': time.time() - t0, 'device': device.type}
    if device.type == 'cuda':
        summary['device_name'] = torch.cuda.get_device_name(0)
        summary['max_memory_allocated_gb'] = (
            torch.cuda.max_memory_allocated() / 1e9)
    print(json.dumps(summary), flush=True)


def main(argv=None):
    argparser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    argparser.add_argument('ref_data_dir', help='Reference dataset directory')
    argparser.add_argument('sim_defs', help='Simulation definition filename')
    add_arguments(argparser)
    args = vars(argparser.parse_args(argv))
    run(args, lambda sim_defs, config: create_workflow(
        sim_defs, args['raw_data_dir'], args['table'], config,
        args['ref_data_dir'], tools=args['tools'], device=args['device']))


if __name__ == '__main__':
    main()
