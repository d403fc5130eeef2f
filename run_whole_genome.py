#!/usr/bin/env python3
"""Where a user's time goes before and in the fit, on a whole synthetic
genome, on one GPU: the ``run`` CLI of the PyTorch/CUDA port from BAMs, or
with ``--read-benchmark`` the read-level simulation benchmark.

    python3 run_whole_genome.py [--tumour-depth 1.0] [--normal-depth 0.5]
        [--chromosomes 1,2,...] [--out FILE]
    python3 run_whole_genome.py --read-benchmark [--h-total 0.005]
        [--segments 5000] [--chromosomes 1,2,...] [--out FILE]

The ``run`` CLI: makes ``chip_smoke.py`` phase 11's inputs from its seeds
on the chosen GRCh37 autosomes (all 22 by default, 2.88 Gb): a synthetic
reference, the accuracy benchmark's tumour mixture scaled to the genome, a
tumour and a normal BAM at the given depths (bases of read per base of
genome); runs the CLI on them with the stand-in phasing tools, the default
config and the fit on the card.

The read benchmark: makes phase 12's inputs (the same reference, an
impute2 panel at its SNPs, ``benchmark/sim_defs.yaml``'s simulation at
``--h-total`` with ``--segments`` segments) and runs
``remixt_tpu_torch.benchmark.run_read_benchmark`` on them: simulated
germline alleles and reads, the run from seqdata, the fit on the card and
the evaluation against the truth.

Either checks finite ELBOs and one ``fb_grouped`` launch per sweep of
every wave, and prints the wall time of every step, the peak device memory
and the peak host resident set beside the card's name and power limit, as
a JSON line last (also written to ``--out``).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

import chip_smoke as cs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--tumour-depth', type=float, default=1.0)
    parser.add_argument('--normal-depth', type=float, default=0.5)
    parser.add_argument('--read-benchmark', action='store_true')
    parser.add_argument('--h-total', type=float, default=0.005)
    parser.add_argument('--segments', type=int, default=5000)
    parser.add_argument('--chromosomes', default=','.join(cs.AUTOSOMES))
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('run_whole_genome: no CUDA device', file=sys.stderr)
        return 1
    from remixt_tpu_torch import config as config_mod
    from remixt_tpu_torch.device import resolve_device
    from remixt_tpu_torch.io.store import read_store
    resolve_device('cuda')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    cs.log('card: ' + smi)

    chromosomes = {c: cs.AUTOSOMES[c] for c in args.chromosomes.split(',')}
    here = os.path.dirname(os.path.abspath(__file__))
    peak = cs.HostPeak()
    t0 = time.time()
    if args.read_benchmark:
        run = cs.read_benchmark(
            'whole genome read benchmark',
            os.path.join(here, 'build', 'whole_genome_reads'), chromosomes,
            args.h_total, N=args.segments)
        counts, results = run['counts'], run['results']
        inputs = dict(h_total=args.h_total, simulated_segments=args.segments,
                      inputs_s=run['fixture']['times'])
    else:
        run = cs.run_cli('whole genome',
                         os.path.join(here, 'build', 'whole_genome'),
                         chromosomes, {'tumour': args.tumour_depth,
                                       'normal': args.normal_depth})
        counts = os.path.join(run['raw'], 'counts', 'sample_tumour.tsv')
        results = run['results']['tumour']
        inputs = dict(depths=dict(tumour=args.tumour_depth,
                                  normal=args.normal_depth),
                      pairs=run['fixture']['pairs'],
                      inputs_s=run['fixture']['times'])
    device_gb = torch.cuda.max_memory_allocated() / 1e9
    cs.log_run_steps('whole genome', run)

    stats = read_store(results, keys=['stats'])['stats']
    if not np.all(np.isfinite(stats['elbo'])):
        raise AssertionError('non-finite ELBO')
    sweeps = (config_mod.get_param({}, 'num_em_iter')
              * config_mod.get_param({}, 'num_update_iter'))
    expected = -(-len(stats['elbo']) // cs.WAVE) * sweeps
    cs.expect_launches('whole genome', run['launches'], 'fb_grouped',
                       expected)
    with open(counts) as f:
        segments = sum(1 for _ in f) - 1
    summary = dict(
        card=smi, chromosomes=list(chromosomes),
        genome_mb=sum(chromosomes.values()) / 1e6, **inputs,
        steps_s={k: sum(v) for k, v in run['times'].items()},
        extract_s=run['times'].get('extract'), waves_s=run['waves'],
        segments=segments, restarts=len(stats['elbo']),
        fb_grouped_launches=expected, run_s=run['whole'],
        total_s=time.time() - t0, device_peak_gb=device_gb,
        host_peak_gb=peak.stop(),
        host_peak_since='start of the run, sampled every 50 ms')
    if args.read_benchmark:
        summary.update(
            seqdata={sample: cs.seqdata_digest(path)
                     for sample, path in run['seqdata'].items()},
            evaluation=cs.evaluation_metrics(read_store(run['evaluation'])))
    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line)
    return 0


if __name__ == '__main__':
    sys.exit(main())
