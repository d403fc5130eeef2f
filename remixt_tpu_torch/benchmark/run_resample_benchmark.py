"""Read-resampling accuracy benchmark: real reads resampled → run → fit →
evaluate.

Counterpart of the JAX package's ``benchmark/run_resample_benchmark.py``,
with its arguments and ``--device``: for every simulation of the
definition file, simulates the germline alleles and the genome mixture,
resamples a source normal and tumour seqdata to the mixture's per-segment
depths, runs each tool of the catalog on the result (the fit on
``--device``, CUDA by default), evaluates against the truth and merges.
Stores as in ``run_read_benchmark``: HDF5 where h5py is installed, else
directories.

Usage:
    python -m remixt_tpu_torch.benchmark.run_resample_benchmark \\
        <ref_data_dir> <sim_defs.yaml> <normal_seqdata> <tumour_seqdata> \\
        <raw_data_dir> <table> [--tools remixt] [--config CONFIG] \\
        [--maxjobs N] [--device DEVICE]
"""

import argparse
import os

from remixt_tpu_torch.benchmark import run_read_benchmark as read_benchmark
from remixt_tpu_torch.io.store import store_name
from remixt_tpu_torch.scheduler import Workflow
from remixt_tpu_torch.simulations import pipeline as sim_pipeline
from remixt_tpu_torch.simulations import workflow as sim_workflow


def create_workflow(sim_defs, source_normal, source_tumour, raw_data_dir,
                    table, config, ref_data_dir, tools=('remixt',),
                    device=None):
    """Per simulation the subworkflow ``resample_<id>``, each tool's
    ``run_<tool>_<id>`` and ``evaluate_<tool>_<id>``; then
    ``merge_evaluations`` into ``table``."""
    workflow = Workflow('resample_benchmark')
    evaluation_files = {}
    for sim_id, params in sim_defs.items():
        sim_dir = os.path.join(raw_data_dir, sim_id)
        os.makedirs(sim_dir, exist_ok=True)

        mixture_file = os.path.join(sim_dir, 'mixture.pickle')
        breakpoints_file = os.path.join(sim_dir, 'breakpoints.tsv')
        seqdata = {name: store_name(os.path.join(
            sim_dir, '{}_seqdata'.format(name)))
            for name in ('normal', 'tumour')}

        workflow.subworkflow(
            'resample_{}'.format(sim_id),
            sim_workflow.create_resample_simulation_workflow(
                params, source_normal, source_tumour, seqdata['normal'],
                seqdata['tumour'], mixture_file, breakpoints_file, config,
                ref_data_dir, os.path.join(sim_dir, 'sim_tmp')))

        def paths(tool, sim_dir=sim_dir):
            tool_dir = os.path.join(sim_dir, tool)
            return (store_name(os.path.join(tool_dir, 'results')),
                    store_name(os.path.join(tool_dir, 'evaluation')),
                    tool_dir)

        read_benchmark.add_tool_tasks(
            workflow, sim_id, tools, seqdata, mixture_file,
            breakpoints_file, paths, config, ref_data_dir, device,
            evaluation_files)

    workflow.transform(
        'merge_evaluations',
        sim_pipeline.merge_evaluations,
        args=(table, sim_defs, evaluation_files, ['sim_id', 'tool']),
        inputs=list(evaluation_files.values()),
        outputs=[table],
    )
    return workflow


def main(argv=None):
    argparser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    argparser.add_argument('ref_data_dir', help='Reference dataset directory')
    argparser.add_argument('sim_defs', help='Simulation definition filename')
    argparser.add_argument('normal_seqdata', help='Source normal seqdata')
    argparser.add_argument('tumour_seqdata', help='Source tumour seqdata')
    read_benchmark.add_arguments(argparser)
    args = vars(argparser.parse_args(argv))
    read_benchmark.run(args, lambda sim_defs, config: create_workflow(
        sim_defs, args['normal_seqdata'], args['tumour_seqdata'],
        args['raw_data_dir'], args['table'], config, args['ref_data_dir'],
        tools=args['tools'], device=args['device']))


if __name__ == '__main__':
    main()
