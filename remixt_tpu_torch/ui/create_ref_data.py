"""``remixt-tpu-torch create_ref_data``: download and build the reference
dataset.

Counterpart of ``remixt_tpu/ui/create_ref_data.py``; delegates to
:mod:`remixt_tpu_torch.ref_data`, which resumes past the steps whose
sentinel files exist under the dataset directory.
"""

import os

import remixt_tpu_torch.ref_data


def run(**args):
    config = {}
    if args['config'] is not None:
        import yaml
        with open(args['config']) as config_file:
            config = yaml.safe_load(config_file) or {}

    dataset_dir = args['ref_data_dir']
    remixt_tpu_torch.ref_data.create_ref_data(
        config, dataset_dir,
        os.path.join(dataset_dir, 'sentinal'),
        bwa_index_genome=args['bwa_index_genome'])


def add_arguments(argparser):
    argparser.set_defaults(func=run)

    argparser.add_argument(
        'ref_data_dir', help='Reference dataset directory')
    argparser.add_argument(
        '-c', '--config', help='Configuration filename')
    argparser.add_argument(
        '-b', '--bwa_index_genome', action='store_true',
        help='Index the genome for bwa, used for tests/benchmarking')
