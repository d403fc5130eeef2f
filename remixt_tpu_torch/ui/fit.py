"""``fit``: count table + breakpoint table → results store.

Counterpart of ``remixt_tpu/ui/fit.py``. Starts from a prepared count table
(columns chromosome, start, end, length, major_readcount, minor_readcount,
readcount) and a breakpoint prediction table, runs the full restart grid
on the GPU and writes the results store in the JAX package's HDF5 schema
(needs h5py; PyYAML only for ``--config``).
"""

import os

from remixt_tpu_torch import workflow
from remixt_tpu_torch.analysis.experiment import create_experiment
from remixt_tpu_torch.device import resolve_device


def fit(count_file, breakpoint_file, results_file, work_dir, config=None,
        min_length=None, device=None):
    """Fit one sample from its TSVs into ``results_file``.

    Args:
        count_file, breakpoint_file: input TSVs
        results_file: the results store to write
        work_dir: intermediate files; a rerun skips the tasks done there
        config: a YAML config file overlaying the defaults, or None
        min_length: keep only segments longer than this
        device: torch device of the fit; ``None`` means CUDA, and raises
            before anything is written when there is none
    """
    resolve_device(device)
    params = {}
    if config is not None:
        import yaml
        with open(config) as f:
            params = yaml.safe_load(f) or {}

    os.makedirs(work_dir, exist_ok=True)
    experiment_filename = os.path.join(work_dir, 'experiment.pickle')
    create_experiment(count_file, breakpoint_file, experiment_filename,
                      min_length=min_length)

    workflow.create_fit_model_workflow(
        experiment_filename, results_file, params, None,
        os.path.join(work_dir, 'fit'), device=device,
    ).run(work_dir)


def add_arguments(argparser):
    argparser.add_argument('count_file',
                           help='Input segment count table filename (TSV)')
    argparser.add_argument('breakpoint_file',
                           help='Input breakpoint prediction table filename '
                                '(TSV)')
    argparser.add_argument('results_file',
                           help='Output results filename (HDF5)')
    argparser.add_argument('work_dir',
                           help='Working directory for intermediate files')
    argparser.add_argument('--config', required=False,
                           help='Configuration filename (YAML)')
    argparser.add_argument('--min_length', type=float, default=None,
                           help='Minimum segment length filter')
    argparser.set_defaults(func=fit)
