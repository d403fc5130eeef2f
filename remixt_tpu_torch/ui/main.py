"""``remixt-tpu-torch`` console entry point.

    python3 -m remixt_tpu_torch.ui.main fit counts.tsv breakpoints.tsv \\
        results.h5 work/ [--config config.yaml] [--min_length L]

Registers the ``fit`` subcommand, the one the port has so far.
"""

import argparse

import remixt_tpu_torch.ui.fit


def main(argv=None):
    argparser = argparse.ArgumentParser(prog='remixt-tpu-torch')
    subparsers = argparser.add_subparsers(required=True)
    for name, module in (('fit', remixt_tpu_torch.ui.fit),):
        module.add_arguments(subparsers.add_parser(name))
    args = vars(argparser.parse_args(argv))
    func = args.pop('func')
    func(**args)


if __name__ == '__main__':
    main()
