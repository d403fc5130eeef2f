"""``remixt-tpu-torch`` console entry point.

    python3 -m remixt_tpu_torch.ui.main fit counts.tsv breakpoints.tsv \\
        results.h5 work/ [--config config.yaml] [--min_length L]
    python3 -m remixt_tpu_torch.ui.main run ref_data/ raw/ breakpoints.tsv \\
        --tumour_sample_ids t --tumour_bam_files t.bam \\
        --results_files results.h5 \\
        [--normal_sample_id n --normal_bam_file n.bam] [--config c.yaml]

Registers the ``fit`` and ``run`` subcommands.
"""

import argparse

import remixt_tpu_torch.ui.fit
import remixt_tpu_torch.ui.run


def main(argv=None):
    argparser = argparse.ArgumentParser(prog='remixt-tpu-torch')
    subparsers = argparser.add_subparsers(required=True)
    for name, module in (('fit', remixt_tpu_torch.ui.fit),
                         ('run', remixt_tpu_torch.ui.run)):
        module.add_arguments(subparsers.add_parser(name))
    args = vars(argparser.parse_args(argv))
    func = args.pop('func')
    func(**args)


if __name__ == '__main__':
    main()
