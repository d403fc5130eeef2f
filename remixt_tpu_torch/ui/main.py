"""``remixt-tpu-torch`` console entry point.

    python3 -m remixt_tpu_torch.ui.main fit counts.tsv breakpoints.tsv \\
        results.h5 work/ [--config config.yaml] [--min_length L]
    python3 -m remixt_tpu_torch.ui.main run ref_data/ raw/ breakpoints.tsv \\
        --tumour_sample_ids t [t2 ...] --tumour_bam_files t.bam [t2.bam ...] \\
        --results_files results.h5 [results2.h5 ...] \\
        [--normal_sample_id n --normal_bam_file n.bam] [--config c.yaml]
    python3 -m remixt_tpu_torch.ui.main write_results results.h5 cn.tsv \\
        brk_cn.tsv meta.yaml [--max_ploidy P] [--min_ploidy P] \\
        [--max_proportion_divergent D]
    python3 -m remixt_tpu_torch.ui.main visualize_solutions results.h5 \\
        report.html
    python3 -m remixt_tpu_torch.ui.main create_ref_data ref_data/ \\
        [-c config.yaml] [-b]
    python3 -m remixt_tpu_torch.ui.main mappability_bwa ref_data/ \\
        [--config config.yaml] [--tmpdir tmp/] [--maxjobs J]

Registers the ``fit``, ``run``, ``write_results``,
``visualize_solutions``, ``create_ref_data`` and ``mappability_bwa``
subcommands.
"""

import argparse

import remixt_tpu_torch.ui.create_ref_data
import remixt_tpu_torch.ui.fit
import remixt_tpu_torch.ui.mappability_bwa
import remixt_tpu_torch.ui.run
import remixt_tpu_torch.ui.visualize_solutions
import remixt_tpu_torch.ui.write_results

MODULES = {
    'fit': remixt_tpu_torch.ui.fit,
    'run': remixt_tpu_torch.ui.run,
    'write_results': remixt_tpu_torch.ui.write_results,
    'visualize_solutions': remixt_tpu_torch.ui.visualize_solutions,
    'create_ref_data': remixt_tpu_torch.ui.create_ref_data,
    'mappability_bwa': remixt_tpu_torch.ui.mappability_bwa,
}


def main(argv=None):
    argparser = argparse.ArgumentParser(prog='remixt-tpu-torch')
    subparsers = argparser.add_subparsers(required=True)
    for name, module in MODULES.items():
        module.add_arguments(subparsers.add_parser(name))
    args = vars(argparser.parse_args(argv))
    func = args.pop('func')
    func(**args)


if __name__ == '__main__':
    main()
