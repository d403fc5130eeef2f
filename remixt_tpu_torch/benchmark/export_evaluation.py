"""Export a merged evaluation store to JSON, and compare it with the JAX
package's.

Counterpart of the JAX package's ``benchmark/export_evaluation.py``
without pandas: writes the five tables' records and a ``summary`` (each
configuration's mean, std with ddof 1, min, max and n over its replicates
for ``SUMMARY_METRICS``; sim ids are ``<config>_<sim>_<rep>``) in the
schema of ``benchmark/ACCURACY_BENCH.json``, so that the two files compare
row by row. The store is an HDF5 file or a directory of TSV tables
(``io/store.py``), as ``run_evaluation`` wrote it.

Usage:
    python -m remixt_tpu_torch.benchmark.export_evaluation <merged> <out.json>
        [--compare benchmark/ACCURACY_BENCH.json]

``--compare`` prints each simulation's metrics beside its row of the
given file, with ``ACCURACY_BARS``, and marks each metric outside its bar.
"""

import argparse
import json
import sys

import numpy as np

from remixt_tpu_torch.io.store import read_store
from remixt_tpu_torch.io.table import Table

TABLES = ('cn_evaluation', 'brk_cn_evaluation', 'mix_results',
          'outlier_evaluation', 'simulations')

SUMMARY_METRICS = {
    'cn_evaluation': ['proportion_cn_correct', 'proportion_dom_cn_correct',
                      'proportion_clonal_correct',
                      'proportion_subclonal_correct'],
    'brk_cn_evaluation': ['brk_cn_correct_proportion'],
    'mix_results': ['mix_abs_error'],
}

#: each metric within this of the JAX package's evaluation of the same
#: simulation at the default config
ACCURACY_BARS = {
    'proportion_cn_correct': 0.03, 'proportion_dom_cn_correct': 0.03,
    'brk_cn_correct_proportion': 0.08,
    'mix_pred_0': 0.02, 'mix_pred_1': 0.02, 'mix_pred_2': 0.02,
    'correct_outlier_total_proportion': 0.01,
    'correct_outlier_allele_proportion': 0.01}


def _config_of(sim_id):
    """``<config>_<sim_idx>_<rep_idx>`` -> config name."""
    return sim_id.rsplit('_', 2)[0]


def _records(table):
    """A table's rows as dicts of Python values, without its index."""
    columns = [(name, values.tolist()) for name, values in table.items()]
    return [{name: values[i] for name, values in columns}
            for i in range(len(table))]


def summarize(tables):
    """{config: {metric: {mean, std, min, max, n}}} over replicates, the
    configurations in sorted order."""
    summary = {}
    for table_name, metrics in SUMMARY_METRICS.items():
        if table_name not in tables:
            continue
        records = tables[table_name]
        names = dict.fromkeys(k for r in records for k in r)
        columns = {k: np.array([r.get(k, np.nan) for r in records])
                   for k in names}
        if table_name == 'mix_results':
            true_cols = sorted(c for c in columns if c.startswith('mix_true_'))
            pred_cols = sorted(c for c in columns if c.startswith('mix_pred_'))
            columns['mix_abs_error'] = np.abs(
                np.stack([columns[c] for c in true_cols], axis=1)
                - np.stack([columns[c] for c in pred_cols], axis=1)
            ).mean(axis=1)
        configs = np.array([_config_of(s) for s in columns['sim_id']])
        for config in sorted(set(configs.tolist())):
            rows = configs == config
            entry = summary.setdefault(config, {})
            for metric in metrics:
                if metric not in columns:
                    continue
                values = columns[metric][rows].astype(float)
                entry[metric] = {
                    'mean': float(values.mean()),
                    'std': float(values.std(ddof=1)) if len(values) > 1
                    else 0.0,
                    'min': float(values.min()),
                    'max': float(values.max()),
                    'n': int(len(values)),
                }
    return summary


def export(store_path):
    """The JSON document of the merged store at ``store_path``."""
    tables = read_store(store_path)
    out = {name: _records(tables[name]) for name in TABLES
           if name in tables and isinstance(tables[name], Table)}
    out['summary'] = summarize(out)
    return out


def rows_by_sim(document):
    """{sim_id: every metric of the simulation's evaluation rows}."""
    rows = {}
    for name in TABLES[:-1]:
        for record in document.get(name, []):
            rows.setdefault(record['sim_id'], {}).update(
                {k: v for k, v in record.items() if k != 'sim_id'})
    return rows


def compare(document, reference):
    """Lines of each simulation's metrics beside the reference's, with the
    bar and whether the metric is outside it; and the count outside."""
    got, ref = rows_by_sim(document), rows_by_sim(reference)
    lines, outside = [], 0
    for sim_id in sorted(got):
        if sim_id not in ref:
            lines.append('{}: no row in the reference'.format(sim_id))
            continue
        for metric, bar in ACCURACY_BARS.items():
            if metric not in got[sim_id] or metric not in ref[sim_id]:
                continue
            diff = got[sim_id][metric] - ref[sim_id][metric]
            miss = not abs(diff) <= bar
            outside += miss
            lines.append('{} {:<34s} {:.6f}  reference {:.6f}  diff {:+.6f}'
                         '  bar {:.2f}{}'.format(
                             sim_id, metric, got[sim_id][metric],
                             ref[sim_id][metric], diff, bar,
                             '  OUTSIDE' if miss else ''))
    return lines, outside


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('store', help='merged evaluation store')
    parser.add_argument('out', help='JSON file to write')
    parser.add_argument('--compare', default=None,
                        help='a JSON file of the same schema to compare with')
    args = parser.parse_args(argv)

    document = export(args.store)
    with open(args.out, 'w') as f:
        json.dump(document, f, indent=2, default=str)
    print('wrote', args.out)

    if args.compare is not None:
        with open(args.compare) as f:
            reference = json.load(f)
        lines, outside = compare(document, reference)
        for line in lines:
            print(line)
        print('{} metric(s) outside their bars'.format(outside))
    return 0


if __name__ == '__main__':
    sys.exit(main())
