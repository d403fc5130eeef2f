"""``remixt-tpu-torch mappability_bwa``: build the bwa mappability store of
a reference dataset. Counterpart of ``remixt_tpu/ui/mappability_bwa.py``.
"""

import os

import remixt_tpu_torch.mappability.bwa.workflow


def run(**args):
    ref_data_dir = args['ref_data_dir']

    config = {}
    if args['config'] is not None:
        import yaml
        with open(args['config']) as config_file:
            config = yaml.safe_load(config_file) or {}

    tmpdir = args.get('tmpdir') or os.path.join(ref_data_dir,
                                                'mappability_bwa_tmp')

    workflow = remixt_tpu_torch.mappability.bwa.workflow.\
        create_bwa_mappability_workflow(config, ref_data_dir, tmpdir)

    workflow.run(tmpdir, max_jobs=args['maxjobs'])


def add_arguments(argparser):
    argparser.add_argument('ref_data_dir',
                           help='Reference dataset directory')

    argparser.add_argument('--config', required=False,
                           help='Configuration Filename')

    argparser.add_argument('--tmpdir', required=False,
                           help='Temporary directory')

    argparser.add_argument('--maxjobs', type=int, default=1,
                           help='Maximum concurrent host jobs')

    argparser.set_defaults(func=run)
