"""Write a segmentation TSV: the port's CLI over
``analysis.segment.create_segments`` (a regular grid of
``segment_length``, cut at the reference's gaps and, with
``--breakpoint_filename``, at the breakends). Run:

    python -m remixt_tpu_torch.tools.create_segments REF_DATA_DIR segments.tsv [--breakpoint_filename b.tsv] [--config c.yaml]
"""

import argparse

from remixt_tpu_torch.analysis import segment


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('ref_data_dir')
    ap.add_argument('segment_filename')
    ap.add_argument('--breakpoint_filename', default=None)
    ap.add_argument('--config', default=None)
    args = ap.parse_args(argv)

    config = {}
    if args.config is not None:
        import yaml
        with open(args.config) as f:
            config = yaml.safe_load(f)

    segment.create_segments(args.segment_filename, config, args.ref_data_dir,
                            breakpoint_filename=args.breakpoint_filename)


if __name__ == '__main__':
    main()
