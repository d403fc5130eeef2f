"""``write_results``: the best solution's tables and metadata.

Counterpart of ``remixt_tpu/ui/write_results.py``: restarts are filtered
by divergent proportion and an optional ploidy window, the highest-ELBO
survivor's cn and brk_cn tables go to TSV as pandas' ``to_csv(sep='\\t',
index=False)`` writes them, and its statistics with its h and mix go to a
metadata YAML. The results store is an HDF5 file or a directory of TSV
tables (``io/store.py``).

    python3 -m remixt_tpu_torch.ui.main write_results results.h5 cn.tsv \\
        brk_cn.tsv meta.yaml [--max_ploidy P] [--min_ploidy P] \\
        [--max_proportion_divergent D]
"""

import numpy as np

from remixt_tpu_torch.io.store import read_store
from remixt_tpu_torch.io.table import write_tsv


def select_solution(stats, max_proportion_divergent, min_ploidy=None,
                    max_ploidy=None):
    """The row of the highest-ELBO restart among those with
    ``proportion_divergent <= max_proportion_divergent``, ``ploidy <
    max_ploidy`` and ``ploidy > min_ploidy`` (the first such row on a
    tie; NaN ELBOs skipped); ValueError when none passes."""
    passing = stats['proportion_divergent'] <= max_proportion_divergent
    if max_ploidy is not None:
        passing &= stats['ploidy'] < max_ploidy
    if min_ploidy is not None:
        passing &= stats['ploidy'] > min_ploidy
    if not passing.any():
        raise ValueError('filters too restrictive, no solutions')
    rows = np.flatnonzero(passing)
    return int(rows[np.nanargmax(stats['elbo'][rows])])


def _plain(value):
    """A YAML-safe scalar: numpy scalars unwrapped to Python scalars."""
    return value.item() if isinstance(value, np.generic) else value


def write_results_tables(**args):
    results = args['results_filename']
    stats = read_store(results, keys=['stats'])['stats']
    row = select_solution(
        stats, args['max_proportion_divergent'], args.get('min_ploidy'),
        args.get('max_ploidy'))
    solution_key = 'solutions/solution_{}'.format(stats['init_id'][row])
    tables = {key.rsplit('/', 1)[1]: table for key, table in read_store(
        results, keys=['{}/{}'.format(solution_key, name)
                       for name in ('cn', 'brk_cn', 'h', 'mix')]).items()}

    write_tsv(tables['cn'], args['cn_filename'])
    write_tsv(tables['brk_cn'], args['brk_cn_filename'])

    metadata = {name: _plain(values[row]) for name, values in stats.items()}
    metadata['h'] = tables['h'].values.tolist()
    metadata['mix'] = tables['mix'].values.tolist()
    import yaml
    with open(args['meta_filename'], 'w') as meta_file:
        yaml.dump(metadata, meta_file, default_flow_style=False)


def add_arguments(argparser):
    for name, help_text in (
            ('results_filename', 'Results filename'),
            ('cn_filename', 'Output segment copy number table filename'),
            ('brk_cn_filename',
             'Output breakpoint copy number table filename'),
            ('meta_filename', 'Output meta data filename')):
        argparser.add_argument(name, help=help_text)

    argparser.add_argument('--max_ploidy', type=float, default=None,
                           help='Maximum ploidy')
    argparser.add_argument('--min_ploidy', type=float, default=None,
                           help='Minimum ploidy')
    argparser.add_argument('--max_proportion_divergent', type=float,
                           default=0.5,
                           help='Maximum proportion of the genome divergent')
    argparser.set_defaults(func=write_results_tables)
