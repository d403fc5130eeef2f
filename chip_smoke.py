#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``remixt_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Environment: the card's name and power limit, the torch and CUDA
   versions; builds the CUDA kernels from ``remixt_tpu_torch/csrc`` into
   ``build/remixt_tpu_torch/`` (one nvcc per source, all at once) and
   prints the build time.
2. Kernel vs plain, restart-batched: the whole-genome problem (N=6000
   segments at 500 kb, M=3 clones, max copy number 12 → S=355 states, 300
   events, 23 chains) with one wave of R=8 restarts. Forward-backward
   through the ``fb_grouped`` kernel at each cluster size in ``CLUSTERS``
   and once through its plain PyTorch version, all on the card in
   float32, compared on entries within 60 nats of their row maximum at
   atol 2e-4 / rtol 1e-5 and on log_norm at rtol 1e-5. Times each, prints
   the bound beside the design's floor (the breakend bank read once per
   direction), and times the kernel once more with its breakend steps
   made static.
2b. Kernel vs plain, one restart: the same problem with restart 0's state
   through the ``fb_chains`` kernel at every cluster size whose resident
   slice fits (``CHAIN_CLUSTERS``) and its plain version, at the same
   tolerances, with two launches on the same inputs bit-identical; again
   with two non-cut static classes on some chains, so that static steps
   of a class that is not resident run too. Times both, prints the launch
   plan and the card's co-resident clusters at each size, times
   ``fb_grouped`` (at its default cluster size) on the same inputs at R=1
   and the kernel with its breakend steps made static, as phase 2 does.
2c. The scaled-linear kernel, restart-batched: phase 2's inputs through
   ``fb_grouped_scaled`` at each cluster size in ``CLUSTERS`` and its
   plain version, at phase 2's tolerances; its posteriors within 1e-3 of
   the log-space ``fb_grouped``'s on the same inputs, and two launches on
   the same inputs bit-identical. Times each, prints the bound beside the
   design's floor, and times the kernel with its breakend steps made
   static, as phase 2 does.
2d. Phase 2b's checks and times for ``fb_chains_scaled`` on its inputs,
   at every size in ``CHAIN_CLUSTERS``, its trace included, and its
   posteriors within 1e-3 of the log-space ``fb_chains``' at each size.
3. The batched path at full width: ``analysis.pipeline.fit_many`` on that
   experiment with the 8 restarts, 2 EM iterations × 2 VI sweeps (the one
   cut: the defaults are 5 × 5). Checks finite ELBOs, the decoded copy
   number's shape, and that every chain forward-backward of the run went
   through the ``fb_grouped`` kernel. Then fits the wave again under
   ``torch.use_deterministic_algorithms(True, warn_only=True)``: its h,
   ELBOs and posteriors must equal the first fit's bit for bit.
4. float32 on the card vs float64 on the CPU at a small size (N=60, max
   copy number 4, 5 sweeps), restart-batched (R=4) and one restart, each
   with the log-space and with the scaled-linear chain forward-backward:
   posterior max-abs-diff ≤ 1e-3 each.
5. Where the time goes: the batched fit once more (1 EM × 2 VI) under
   ``torch.profiler``: the device's busy share, device time per fit stage,
   and the kernels with the most device time.
5b. The measurement tools of ``remixt_tpu_torch/tools`` through their
   ``main(argv)`` on phase 2's problem (N=6000, 300 events, S=355, 23
   chains; each tool builds it anew), their JSON under
   ``build/chip_smoke/tools/``: (a) ``sweep_budget`` at R=8 and at one
   restart: each sweep part's device time by the engine's named ranges,
   the block's wall and device time; all seven parts must show device
   time, the parts and the unattributed time must sum to the block's
   device time within 1 %, and the chain update a sweep must take at least
   0.75 × phase 2's ``fb_grouped`` time through its wrapper (R=8) or
   phase 2b's ``fb_chains`` kernel alone on inputs the wrapper prepared
   (one restart: the wrapper's own time there is held up by the host, by
   1.34 to 2.04 ms on runs whose kernel alone took 1.17 to 1.22 ms, and
   the range counts device time only); (b) ``fit_budget --trace``: one batched EM iteration's
   device time by its 13 ranges; (c) ``fit_budget``: the phase timings of
   the single and the batched fit; (d) ``probe_restart_scaling`` at
   ``PROBE_WAVES`` and its optimal wave; (e) ``profile_engine`` on the
   single-restart sweep and ``summarize_trace --top 10`` of its trace.
   The chain kernels' launches of 5b count into the kernel table's.
6. The single-restart path at full width: the sequential ``fit_many``
   (``batch_restarts: false``) over the first 2 restarts of phase 3's grid,
   2 EM × 2 VI. Checks finite ELBOs, the copy number's shape, and that every
   chain forward-backward went through the ``fb_chains`` kernel; reports its
   stage times and, per restart, the share of segments whose decoded copy
   number equals phase 3's. Then fits restart 0 twice more, as it was and
   under ``torch.use_deterministic_algorithms(True, warn_only=True)``, and
   prints the max abs difference of h, ELBO and posteriors of each from
   the first fit, and the ops torch names as nondeterministic; this only
   reports. Last, restart 0 through ``pipeline.fit`` with a snapshot file,
   stopped after one EM iteration and resumed from the snapshot to the
   same depth: its h, ELBO, posteriors and decoded copy number must equal
   the first fit's bit for bit.
7. Both paths with the scaled-linear switch on (``fb_grouped.SCALED_LINEAR``,
   the ``REMIXT_TPU_SCALED_LINEAR=1`` of the JAX package): phase 3's wave
   through the batched ``fit_many`` and restart 0 through the sequential
   one, at the depth of phases 3 and 6 (2 EM × 2 VI) so that their decoded
   copy number compares with theirs (≥ 0.99 of the segments). Checks that
   every chain forward-backward went through the scaled kernels.
8. The ``fit`` workflow at full width: phase 3's problem written as count
   and breakpoint TSVs (``write_tables``), ``create_experiment``, the
   restart grid of ``init`` (the defaults' grid), the grid's fit through
   the workflow's fit task on the card, and ``collate`` into the results
   tables, at phase 3's depth (2 EM × 2 VI). Prints the grid, the waves,
   the wall time of each step and of each wave, and the peak device memory.
   Checks that every chain forward-backward went through ``fb_grouped``,
   finite ELBOs, every key of the results, that the chosen solution is the
   one ``stats`` picks, that each solution's copy number is the fit's, and
   that the workflow run again skips every task in under 10 s. Then the same
   workflow at phase 4's small size (its depths pinned to the truth: the
   default grid's max depth is refused there) in float32 on the card and in
   float64 on the CPU: the same keys and grid, and the chosen solutions' copy
   number equal on at least ``SAME_CN_SHARE`` of the segments. Where h5py
   is missing, the results store cannot be written: the workflow's fit task
   runs alone, ``init`` and ``collate`` run through their table builders in
   memory, every check but the file's is made, and a line says so.
9. Simulate → fit → evaluate at full width and depth: the first simulation
   of ``benchmark/accuracy_sim_defs.yaml`` (``accuracy_0_0``: N=5000, M=3,
   22 autosomes) through the port's ``create_simulations`` and
   ``simulate_experiment`` on the host, which must be the JAX package's
   simulation (``ACCURACY_SIM``: N, detected breakpoints, h, digests of x
   and l); the ``fit`` workflow over init's grid (84 restarts) at the
   defaults, 5 EM × 5 VI, as in phase 8, with every chain forward-backward
   through ``fb_grouped`` (275 launches) and finite ELBOs; the evaluation
   against the truth (``evaluate_tables``, the outlier evaluation
   included), every metric printed beside ``benchmark/ACCURACY_BENCH.json``'s
   row and each of ``ACCURACY_BARS`` held to it; then the grid's restart
   nearest the true h fitted through ``pipeline.fit`` with
   ``optimal_initialization`` (25 ``fb_chains`` launches, a finite ELBO)
   and evaluated. Prints the wall time of each step and the peak device
   memory.

10. The float64 route and the accuracy gate
   (``remixt_tpu_torch.tools.accuracy_gate``) at phase 2's problem: (a) the
   float64 engine on the card, which takes the plain chain scan
   (``ops/fb_scan.py``) and launches no kernel, against the float64 plain
   kernel versions on the CPU at phase 4's size, R=4 and one restart, 5
   sweeps, posteriors within ``F64_SCAN_BAR``, and the device time of
   both float64 scans at phase 3's width, one restart and its wave of 8,
   with the wave call's peak memory; (b) the gate's ``--oracle``
   with the float64 card engine as the reference: 5 sweeps of the float32
   kernel route from the same initialization, every figure per sweep
   beside the JAX package's (``JAX_F32_VS_F64_SWEEPS``) and the gate's
   thresholds held on the last sweep; (c) its ``--em``: the float32 and the
   float64 single-restart fits, 5 EM × 5 VI, the figures beside the JAX
   package's (``JAX_F32_VS_F64_FIT``), finite ELBOs, the decoded copy
   number differing on at most ``DECODE_DISAGREEMENT_BAR`` of the segments,
   no kernel launched by the float64 fit, and its wall time, EM iteration
   and peak memory; (d) its ``--kernels``: the float32 kernel route
   against the float32 scan route, 5 sweeps, posteriors within
   ``KERNELS_VS_SCAN_BAR``.

11. The ``run`` CLI from BAMs to a results store (``ui.main.main(['run',
   ...])``): the script makes, from seeds, a synthetic reference of
   chromosomes 20–22 at their GRCh37 lengths (FASTA and index, gap table,
   SNP panel, mappability store as a directory), the accuracy benchmark's
   tumour mixture on it with its breakpoint table, and a tumour BAM at 2×
   and a normal BAM at 1× (``make_run_fixture``, with phase 13's second
   tumour BAM); writes stand-ins of the
   phasing tools first on the PATH (``write_standin_tools``); runs the
   CLI at the default config from numpy's global state seeded with
   ``RUN_NUMPY_SEED``, the fit on the card. Holds the count table to the
   JAX package's digests (``RUN_JAX``: integer columns exactly, float
   sums at rtol 1e-12), the grid to the JAX package's size, every
   ``fb_grouped`` launch to one per sweep of every wave, the ELBOs to
   finite values and the results store to the JAX keys (TSV tables where
   h5py is absent), and the evaluation against the truth of the
   solution the card's fit chose to ``ACCURACY_BARS`` of a JAX float32
   fit that chose the same restart: the JAX fit, or a JAX refit from
   inputs moved by one float32 ulp (``check_chosen_restart``). Prints
   the wall time of every step, the peak device memory and the host's
   peak resident set.

12. The read-level simulation benchmark
   (``remixt_tpu_torch.benchmark.run_read_benchmark.main``) and the
   results CLI: phase 11's synthetic reference with an impute2 panel of
   ``PANEL_HAPLOTYPES`` haplotypes at its SNPs, ``benchmark/
   sim_defs.yaml``'s simulation on chromosomes 20–22 (N=282,
   ``READ_H_TOTAL``), lengths from the reference's FASTA index
   (``make_read_fixture``). The run reads that reference as the port's
   ``create_ref_data`` builds it (``build_read_reference``): its upstream
   sources (one gzipped Ensembl FASTA a chromosome, UCSC's gap table with
   chr-prefixed names, the impute2 tarball) written into a mirror that
   the ``wget`` stand-in serves, ``ui.main.main(['create_ref_data', ...,
   '--bwa_index_genome'])`` on GRCh37 through the stand-in tools, and the
   built FASTA, its index, the gap table and the SNP positions checked
   equal to ``write_reference``'s byte for byte; the mappability store
   stays ``write_reference``'s. Germline alleles, normal and tumour seqdata
   simulated, the run from seqdata with the stand-in phasing tools (their
   truth written from the simulated germline, ``with_germline_truth``),
   the fit on the card at the defaults, the
   evaluation and the merge. Holds both seqdata stores and the count table
   to the JAX package's digests (``READ_JAX``), every ``fb_grouped``
   launch to one per sweep of every wave, the evaluation of the solution
   the card's fit chose as phase 11 holds it (``check_chosen_restart``);
   then runs ``write_results`` and
   ``visualize_solutions`` through ``ui.main.main`` on the results store
   and checks the solution they pick (``results_cli``). Prints the wall
   time of every step, the peak device memory and the host's peak
   resident set.

13. The multi-tumour ``run`` CLI: phase 11's inputs with a second tumour
   BAM at 2×, ``tumour_b``, drawn from the same genomes with the two
   tumour clones' fractions swapped (a second region of the same
   patient; ``make_run_fixture(..., tumour_b=True)``), the CLI with
   ``--tumour_sample_ids tumour tumour_b`` from numpy's global state
   seeded with ``RUN_NUMPY_SEED``, one cohort fit on the card. Holds both
   count tables to the JAX package's digests (``COHORT_JAX``), every
   ``fb_grouped`` launch to one per sweep of every wave of both fits
   (Σ ⌈Rᵢ / 8⌉ × 25), both results stores to the JAX keys with finite
   ELBOs, and each tumour's own choice as phase 11 holds its one
   (``check_chosen_restart``); then fits ``tumour_b``'s grid alone
   through ``fit_many``, which must equal the cohort's fit of it (the
   second on the card) bit for bit. Prints each step's wall time per
   tumour, each fit's waves, the peak device memory and the host's peak
   resident set.

   The order, for the time limit (the runs of phases 11–13 are host work
   most of the time, and hosts differ by up to 1.5× in it): phase 11's
   and 13's inputs are made once, after phase 8, and phase 13 starts
   then in a process of its own, beside phases 9–12, 14 and 15; after
   phase 10 phase 11 starts in another, and this process runs phases 12,
   14 and 15. Phases 9–15 are timed with the other processes running.

14. The reference build and the bwa mappability workflow, host only, in
   the main process after phase 12 (phases 11 and 13 may still run): on
   a genome made from ``REFBUILD_SEED`` (chromosomes 1, 2 and X of 240,
   180 and 120 kb with runs of N, soft-masked stretches, a 110 kb repeat
   between 1 and 2, a 3 kb one and a tandem repeat), its upstream GRCh38
   sources in a mirror (Ensembl FASTAs, UCSC gap table, a 1000 Genomes VCF
   a chromosome, the genetic maps' tarball); ``ui.main.main(
   ['create_ref_data', ...])`` through the stand-ins, its directory equal
   to the JAX package's by digest (``REFBUILD_JAX``); then
   ``ui.main.main(['mappability_bwa', ...])`` on it at k=100 with
   ``REFBUILD_CHUNK_LINES`` lines a chunk (11 chunks, one wholly in the
   repeat's second copy, whose bedgraph is empty where the JAX step
   raises), the store a directory: its indicator must equal the truth of
   the ``bwa`` stand-in (the positions whose k-mer is unique) and its
   arrays the JAX package's with that chunk left out. Both again must
   call no tool. Prints each step's wall time and the peak resident set.

15. Multi-device fitting, on virtual devices (the one card listed more
   than once in a mesh; no scaling is measured), in the main process after
   phase 14, at phase 2's width (N=6000, S=355, 300 events, 23 chains),
   float32: (a) ``fit_restarts_batched`` over ``MESH_RESTARTS`` restarts,
   2 EM × 5 VI, on a 2-device mesh (a wave of 8 on each, the shards one
   after another) must equal the single-device fit at waves of 8 bit for
   bit, both under ``torch.use_deterministic_algorithms(True,
   warn_only=True)``, each ``fb_grouped`` launch counted; (b) 2 restarts
   on the restart × chain mesh (2 × 2), ``fb_grouped`` launched once a
   chain group, against the single-device fit, within ``MESH_2D_BARS``;
   (c) one sweep of restart 0 with every chain in ``BLOCKS``
   blocks over 2 devices (``ops/fb_blocked.py``), in float64 within
   ``BLOCKED_F64_BAR`` and in float32 within ``F32_VS_F64_BAR`` of the
   float64 chain-batched sweep; (d) ``tools.measure_scaling`` at 1 and 2
   devices (``tools.dryrun_multichip`` is left out for time: its parts
   run above at full width); (e) ``parallel.distributed
   .initialize`` of a one-process NCCL group, read by ``cohort_partition``
   and an ``all_reduce``, then destroyed. Prints each part's wall and peak
   device memory.

The line before the last holds the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import csv
import hashlib
import importlib.util
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks: HBM bandwidth, fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

N_FULL, EVENTS_FULL, CHAINS_FULL, CN_MAX_FULL = 6000, 300, 23, 12
WAVE = 8
NUM_EM_ITER, NUM_UPDATE_ITER = 2, 2
SEQUENTIAL_RESTARTS = 2
# the kernel libraries: (source, macros); fb_chains also with its clock64
# marks, for phase 2b's trace
BUILDS = (('fb_grouped', ()), ('fb_chains', ()),
          ('fb_chains', ('FB_CHAINS_TRACE',)))
CLUSTERS = (4, 8)
# every cluster size whose resident slice fits fb_chains at S=355
CHAIN_CLUSTERS = (3, 4, 5, 6, 7, 8)
# the scaled fits decode the copy number of the log-space fits on at
# least this share of the segments
SAME_CN_SHARE = 0.99
# phase 9: the first simulation of benchmark/accuracy_sim_defs.yaml and
# what the JAX package makes of it on the CPU: its simulate_experiment
# gives N segments, the detected breakpoints, h and the sha256 of x and l
# (float64, C order; first 16 hex digits), and its init the grid's
# restarts
ACCURACY_SIM = dict(name='accuracy_0_0', N=5000, breakpoints=276,
                    h=(0.04, 0.04, 0.02), x='73f71b1c8ae16383',
                    l='e363e17a94417e0d', restarts=84)
# phase 10 (b) and (c): the JAX package's float32 figures at this width
# (ACCURACY.json: float32_engine_vs_f64_oracle, the max over 5 sweeps and
# the last sweep's argmax disagreement; f32_vs_f64_full_fit)
JAX_F32_VS_F64_SWEEPS = dict(posterior_max_abs_diff=6.0e-4,
                             posterior_argmax_disagreement=1.8e-3)
JAX_F32_VS_F64_FIT = dict(posterior_max_abs_diff=3.2e-3,
                          p_breakpoint_max_abs_diff=9.1e-6,
                          h_max_rel_diff=2.2e-8, elbo_rel_diff=3.9e-5,
                          decode_disagreement_fraction=0.0)
# phase 10: the float64 scan route on the card against the float64 plain
# kernel versions on the CPU; the float32 kernel route against the float32
# scan route (phase 4's bar); the decode of the float32 fit against the
# float64 fit's
F64_SCAN_BAR = 1e-9
KERNELS_VS_SCAN_BAR = 1e-3
DECODE_DISAGREEMENT_BAR = 1e-2
# phase 5b: the sweep's parts (the engine's ranges less their prefix) and
# the probe's wave sizes
SWEEP_PARTS = ('emissions', 'p_allele_swap', 'be_bank', 'p_cn_chain',
               'p_breakpoint', 'p_outlier_total', 'p_outlier_allele')
PROBE_WAVES = (1, 8, 16, 24, 48)
# phase 15: the restarts and depth of the mesh fits (a: a wave of 8 on
# each of 2 virtual devices; b: the restart x chain mesh), the blocked
# scan's block count, and the bounds: tests/test_parallel.py's for a
# restart x chain fit against one device, its blocked sweep's in float64,
# phase 4's float32 against float64
MESH_RESTARTS, MESH_2D_RESTARTS = 16, 2
MESH_EM_ITER, MESH_UPDATE_ITER = 2, 5
MESH_2D_BARS = dict(h_rtol=1e-5, posterior_atol=1e-6, elbo_rtol=1e-6)
BLOCKS = 8
BLOCKED_F64_BAR = 1e-9
F32_VS_F64_BAR = 1e-3
# phase 15's device, listed several times in its meshes
CARD = 'cuda:0'


START = time.time()


def log(msg):
    """Print ``msg`` with the seconds since the script started."""
    print('[{:6.1f} s] {}'.format(time.time() - START, msg), flush=True)


def simulate(N, cn_max, num_events, num_chains, seed):
    from remixt_tpu_torch.simulations import simple as sim
    return sim.simulate_experiment(
        N=N, M=3, h=(0.08, 0.05, 0.025), cn_max=cn_max,
        num_events=num_events, num_chains=num_chains, seed=seed)


def make_model(data, cn_max, device, dtype, use_kernels=None):
    from remixt_tpu_torch.models.fit import BreakpointModel
    return BreakpointModel(
        data['x'], data['l'], data['adjacencies'], data['breakpoints'],
        max_copy_number=cn_max, max_depth=1e9, min_segment_length=1.0,
        min_proportion_genotyped=0.0, divergence_weight=1e-7,
        random_seed=1234, device=device, dtype=dtype,
        use_kernels=use_kernels)


def restart_grid(h, num_restarts, seed=1):
    """h initializations spread around the truth, and divergence weights."""
    rng = np.random.RandomState(seed)
    h_inits = [h * (1.0 + 0.1 * rng.rand(3)) for _ in range(num_restarts)]
    weights = [10.0 ** -rng.randint(6, 9) for _ in range(num_restarts)]
    return h_inits, weights


def initial_batch(model, h_inits, weights):
    from remixt_tpu_torch.models import engine as eng
    spec = model._build_spec(3)
    params_b = eng.stack([
        spec.init_params(h, w,
                         total_mask=model._total_likelihood_mask.astype(float),
                         allele_mask=model._allele_likelihood_mask.astype(
                             float))
        for h, w in zip(h_inits, weights)])
    state_b = eng.stack([spec.init_state()] * len(h_inits))
    return spec, params_b, state_b


def cuda_ms(fn, reps):
    """Median device time of ``fn`` over ``reps`` runs, after a warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_environment():
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from remixt_tpu_torch.ops import _build
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    log('torch {} cuda {} python {}'.format(
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    log('card: ' + smi)
    t0 = time.time()
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        list(pool.map(lambda b: _build.build(*b), BUILDS))
    for build in BUILDS:
        _build.load(*build)
    names = ['+'.join((name,) + defines) for name, defines in BUILDS]
    log('phase 1: built {} in {:.2f} s'.format(', '.join(names),
                                              time.time() - t0))
    for name, (unit, defines) in zip(names, BUILDS):
        for line in _build.build_logs.get((unit,) + defines, '').splitlines():
            if 'registers' in line or 'spill' in line or 'smem' in line:
                log('  ptxas {}: {}'.format(name, line.strip()))
    return smi


def check_messages(pairs):
    """Kernel against plain messages: entries within 60 nats of the row
    maximum at atol 2e-4 / rtol 1e-5. Returns the max abs difference."""
    import torch
    max_err = 0.0
    for got, ref in pairs:
        if not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
            raise AssertionError('non-finite forward-backward messages')
        significant = ref > ref.amax(dim=-1, keepdim=True) - 60.0
        diff = (got - ref).abs()[significant]
        tol = 2e-4 + 1e-5 * ref.abs()[significant]
        max_err = max(max_err, float(diff.max()))
        if not bool((diff <= tol).all()):
            raise AssertionError(
                'kernel disagrees with its plain version: max abs '
                'diff {:.3e}'.format(float(diff.max())))
    return max_err


def check_log_norm(spec, kernel, plain):
    """log_norm of the kernel's and the plain messages (R, Q, L, S), rtol
    1e-5."""
    from remixt_tpu_torch.ops import fb_grouped
    ln = [fb_grouped._scatter_and_norm(a, b, spec.chain_seg_map,
                                       spec.chain_last, spec.N)[2]
          for a, b in (kernel, plain)]
    np.testing.assert_allclose(ln[0].cpu().numpy(), ln[1].cpu().numpy(),
                               rtol=1e-5)


def bound(spec, R, inputs, outputs):
    """The least time of one forward-backward of R restarts: each input
    and output array moved once over the HBM rate, or the fp32 work over
    the fp32 rate, whichever is larger. Returns (ms, 'bytes' or
    'operations', bytes_ms, flops_ms, bytes, flops)."""
    S, L = spec.S, spec.L
    nbytes = 4 * sum(x.numel() for x in tuple(inputs) + tuple(outputs))
    steps = spec.chain_bank_idx[:, :L - 1].cpu().numpy()
    matvec_steps = int((steps != 0).sum())
    cut_steps = int((steps == 0).sum())
    # per direction and restart: a 2·S² flop matvec per non-cut step, an
    # S-add sum per cut step, and ~4 flops per state per step around them
    flops = 2 * R * (matvec_steps * 2 * S * S + cut_steps * S
                     + (matvec_steps + cut_steps) * 4 * S)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    flops_ms = 1e3 * flops / PEAK_FP32_FLOP_PER_S
    by = 'bytes' if bytes_ms >= flops_ms else 'operations'
    return max(bytes_ms, flops_ms), by, bytes_ms, flops_ms, nbytes, flops


def kernel_inputs(data, num_restarts):
    """The chain forward-backward's inputs at the main path's shapes: the
    first restarts of phase 3's wave, before their first sweep. Returns
    (spec, frames (R, Q, L, S), static_exp, be_exp_b (R, J, S, S), cbi)."""
    import torch
    from remixt_tpu_torch.models import engine as eng
    from remixt_tpu_torch.ops import fb_grouped

    model = make_model(data, CN_MAX_FULL, 'cuda', torch.float32)
    h_inits, weights = restart_grid(data['h'], WAVE)
    spec, params_b, state_b = initial_batch(model, h_inits[:num_restarts],
                                            weights[:num_restarts])
    with torch.no_grad():
        ll_tot, ll_alle = eng.emission_tensors(spec, params_b)
        frame_b = eng._mix_framelogprob(spec, params_b, state_b, ll_tot,
                                        ll_alle)
        del ll_tot, ll_alle
        be_exp_b = eng.breakend_tmats_exp(spec, state_b.p_breakpoint)
        frames = fb_grouped.gather_frames(frame_b, spec.chain_seg_map)
    return (spec, frames.contiguous(), torch.exp(spec.static_bank).contiguous(),
            be_exp_b, spec.chain_bank_idx.contiguous())


def posterior_diff(spec, messages, reference):
    """Max abs difference of the segment posteriors of two (alphas, betas)
    pairs, chain-major (R, Q, L, S)."""
    from remixt_tpu_torch.ops import fb_grouped
    from remixt_tpu_torch.ops.special import exp_normalize
    post = []
    for a, b in (messages, reference):
        alphas, betas, _ = fb_grouped._scatter_and_norm(
            a, b, spec.chain_seg_map, spec.chain_last, spec.N)
        post.append(exp_normalize(alphas + betas, dim=-1))
    return float((post[0] - post[1]).abs().max())


def made_static(cbi, num_static):
    """The schedule with every breakend step turned into the last static
    class: a kernel timed on it shows what reading the bank costs."""
    import torch
    return torch.where(cbi >= num_static,
                       torch.full_like(cbi, num_static - 1), cbi)


def log_floor(label, spec, cbi, num_static, be_exp_b, nbytes, static_ms,
              cluster):
    """The design's floor, the breakend bank read once per direction, and
    the made-static probe's time."""
    floor_bytes = nbytes + 4 * be_exp_b.numel()
    breakend_steps = (cbi[:, :spec.L - 1] >= num_static).sum(dim=1)
    log('{}: the design\'s floor, the bank once per direction: {:.3f} GB = '
        '{:.3f} ms'.format(label, floor_bytes / 1e9,
                           1e3 * floor_bytes / PEAK_BYTES_PER_S))
    log('{}: with its {} breakend steps (at most {} of a chain\'s {}) made '
        'static (cluster size {}): {:.3f} ms'.format(
            label, int(breakend_steps.sum()), int(breakend_steps.max()),
            spec.L - 1, cluster, static_ms))


def phase_kernel(inputs):
    """The kernel against its plain version at the main path's shapes, at
    each cluster size; also the kernel with every breakend step turned into
    a static one, which shows what reading the per-restart bank costs."""
    import torch
    from remixt_tpu_torch.ops import fb_grouped

    spec, frames, static_exp, be_exp_b, cbi = inputs
    log('phase 2: N={} S={} M={} K={} J={} Q={} L={} R={}'.format(
        spec.N, spec.S, spec.M, spec.K, spec.J, spec.Q, spec.L, WAVE))
    num_static = static_exp.shape[0]
    static_only = made_static(cbi, num_static)
    with torch.no_grad():
        a_p, b_p = fb_grouped.fb_grouped_reference(frames, static_exp,
                                                   be_exp_b, cbi)
        torch.cuda.synchronize()
        cluster_ms, messages, max_err = {}, {}, 0.0
        for cluster in CLUSTERS:
            a_k, b_k = messages[cluster] = fb_grouped.fb_grouped_cuda(
                frames, static_exp, be_exp_b, cbi, cluster=cluster)
            torch.cuda.synchronize()
            max_err = max(max_err, check_messages(((a_k, a_p), (b_k, b_p))))
            check_log_norm(spec, (a_k, b_k), (a_p, b_p))
            cluster_ms[cluster] = cuda_ms(
                lambda: fb_grouped.fb_grouped_cuda(
                    frames, static_exp, be_exp_b, cbi, cluster=cluster),
                reps=7)
        del a_p, b_p
        plain_ms = cuda_ms(lambda: fb_grouped.fb_grouped_reference(
            frames, static_exp, be_exp_b, cbi), reps=5)
        static_ms = cuda_ms(lambda: fb_grouped.fb_grouped_cuda(
            frames, static_exp, be_exp_b, static_only), reps=7)

    bound_ms, bound_by, _, _, nbytes, flops = bound(
        spec, WAVE, (frames, static_exp, be_exp_b, cbi), messages[CLUSTERS[0]])
    log('phase 2: fb_grouped ms by cluster size {}; plain {:.3f} ms; max abs '
        'diff {:.3e}, J={}'.format(
            json.dumps({c: round(t, 4) for c, t in cluster_ms.items()}),
            plain_ms, max_err, be_exp_b.shape[1]))
    log('phase 2: bound {:.3f} ms ({}; {:.3f} GB, {:.3f} GFLOP)'.format(
        bound_ms, bound_by, nbytes / 1e9, flops / 1e9))
    log_floor('phase 2', spec, cbi, num_static, be_exp_b, nbytes, static_ms,
              fb_grouped.CLUSTER)
    return dict(max_abs_err=max_err, ms=cluster_ms[fb_grouped.CLUSTER],
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by), messages[fb_grouped.CLUSTER]


def two_static_classes(static_exp, cbi, seed=5):
    """A schedule with two non-cut static classes on some chains: a copy of
    class 1 perturbed by up to 10 % appended to ``static_exp``, the
    breakend indices moved past it, and every fifth class-1 step of every
    sixth chain pointed at it. Those chains keep class 1 resident and
    stream the new class's steps. Returns (statics, cbi, steps moved)."""
    import torch
    num_static = static_exp.shape[0]
    rng = np.random.RandomState(seed)
    noise = torch.as_tensor(1.0 + 0.1 * rng.rand(*static_exp.shape[1:]),
                            dtype=static_exp.dtype, device=static_exp.device)
    statics = torch.cat([static_exp, (static_exp[1] * noise)[None]])
    steps = cbi.cpu().numpy()
    steps = np.where(steps >= num_static, steps + 1, steps)
    moved = 0
    for q in range(0, steps.shape[0], 6):
        ones = np.flatnonzero(steps[q] == 1)[::5]
        steps[q, ones] = num_static
        moved += len(ones)
    return (statics.contiguous(),
            torch.as_tensor(steps, dtype=cbi.dtype, device=cbi.device), moved)


def phase_kernel_chains(label, inputs, scaled=False, log_space=None):
    """The single-restart kernel (with ``scaled`` the scaled one) against
    its plain version at the main path's shapes: restart 0 of phase 2's
    wave, at every cluster size in ``CHAIN_CLUSTERS``, with two launches
    bit-identical and the card's co-resident clusters at each; again with
    two non-cut static classes on some chains (``two_static_classes``);
    and timed with its breakend steps made static. The scaled kernel's
    posteriors must lie within 1e-3 of the log-space kernel's messages
    ``log_space`` on the same inputs at each size."""
    import torch
    from remixt_tpu_torch.ops import fb_chains, fb_grouped

    spec, frames, static_exp, be_exp, cbi = inputs
    suffix = '_scaled' if scaled else ''
    kernel = getattr(fb_chains, 'fb_chains{}_cuda'.format(suffix))
    plain_fn = getattr(fb_chains, 'fb_chains{}_reference'.format(suffix))
    grouped = getattr(fb_grouped, 'fb_grouped{}_cuda'.format(suffix))
    num_static = static_exp.shape[0]
    statics2, cbi2, moved = two_static_classes(static_exp, cbi)
    with torch.no_grad():
        plain = plain_fn(frames, static_exp, be_exp, cbi)
        plain2 = plain_fn(frames, statics2, be_exp, cbi2)
        torch.cuda.synchronize()
        cluster_ms, kernel_ms, messages, resident_clusters = {}, {}, {}, {}
        max_err = max_err2 = post_diff = 0.0
        for cluster in CHAIN_CLUSTERS:
            k = messages[cluster] = kernel(frames, static_exp, be_exp, cbi,
                                           cluster=cluster)
            again = kernel(frames, static_exp, be_exp, cbi, cluster=cluster)
            k2 = kernel(frames, statics2, be_exp, cbi2, cluster=cluster)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(k, again)):
                raise AssertionError('{}: two launches at cluster size {} '
                                     'differ'.format(label, cluster))
            del again
            max_err = max(max_err, check_messages(zip(k, plain)))
            check_log_norm(spec, tuple(x[None] for x in k),
                           tuple(x[None] for x in plain))
            max_err2 = max(max_err2, check_messages(zip(k2, plain2)))
            check_log_norm(spec, tuple(x[None] for x in k2),
                           tuple(x[None] for x in plain2))
            del k2
            if scaled:
                post_diff = max(post_diff, posterior_diff(
                    spec, tuple(x[None] for x in k),
                    tuple(x[None] for x in log_space)))
                if not post_diff <= 1e-3:
                    raise AssertionError('{}: posteriors differ from the '
                                         'log-space kernel\'s by {}'.format(
                                             label, post_diff))
            resident_clusters[cluster] = fb_chains.max_active_clusters(
                spec.S, cluster, scaled)
            cluster_ms[cluster] = cuda_ms(
                lambda: kernel(frames, static_exp, be_exp, cbi,
                               cluster=cluster), reps=7)
            kernel_ms[cluster] = cuda_ms(fb_chains.launcher(
                frames, static_exp, be_exp, cbi, cluster=cluster,
                scaled=scaled)[0], reps=7)
        del plain, plain2
        plain_ms = cuda_ms(lambda: plain_fn(frames, static_exp, be_exp, cbi),
                           reps=5)
        grouped_ms = cuda_ms(lambda: grouped(
            frames[None], static_exp, be_exp[None], cbi), reps=7)
        static_only = made_static(cbi, num_static)
        static_ms = cuda_ms(lambda: kernel(
            frames, static_exp, be_exp, static_only), reps=7)
        static_kernel_ms = cuda_ms(fb_chains.launcher(
            frames, static_exp, be_exp, static_only, scaled=scaled)[0],
            reps=7)
        resident = fb_chains.resident_classes(cbi, num_static, spec.L - 1)
        traces = {sched_label: fb_chains.trace(frames, static_exp, be_exp,
                                               sched, scaled=scaled)
                  for sched_label, sched in (('main', cbi),
                                             ('made static', static_only))}
        # the scaled kernel reads fexp and fmax in place of the frames
        moved_inputs = (frames,)
        if scaled:
            shift_ms = cuda_ms(lambda: fb_grouped.shift_frames(frames),
                               reps=7)
            moved_inputs = fb_grouped.shift_frames(frames)

    k = messages[fb_chains.CLUSTER]
    bound_ms, bound_by, bytes_ms, flops_ms, nbytes, flops = bound(
        spec, 1, moved_inputs + (static_exp, be_exp, cbi), k)
    log('{}: one restart, Q={} L={} S={} J={}; resident classes {}; '
        'max abs diff {:.3e}; two launches bit-identical at each size'.format(
            label, spec.Q, spec.L, spec.S, be_exp.shape[0],
            json.dumps(resident.cpu().tolist()), max_err))
    log('{}: {} ms by cluster size {} (the kernel alone, on inputs the '
        'wrapper prepared: {}); plain {:.3f} ms; {} at R=1 {:.3f} ms{}'.format(
            label, 'fb_chains' + suffix,
            json.dumps({c: round(t, 4) for c, t in cluster_ms.items()}),
            json.dumps({c: round(t, 4) for c, t in kernel_ms.items()}),
            plain_ms, 'fb_grouped' + suffix, grouped_ms,
            '; the frame shift in torch, in the times through the wrapper, '
            '{:.3f} ms'.format(shift_ms) if scaled else ''))
    log('{}: launch plans {}'.format(label, json.dumps(
        {c: fb_chains.launch_plan(spec.S, c) for c in CHAIN_CLUSTERS})))
    log('{}: co-resident clusters by cluster size {} ({} clusters on '
        'the main path)'.format(label, json.dumps(resident_clusters),
                                2 * spec.Q))
    log('{}: two non-cut static classes ({} steps of every sixth chain '
        'moved to a perturbed copy of class 1): max abs diff {:.3e} at '
        'each size'.format(label, moved, max_err2))
    log('{}: bound {:.4f} ms ({}): bytes {:.4f} GB = {:.4f} ms, '
        'fp32 {:.3f} GFLOP = {:.4f} ms'.format(
            label, bound_ms, bound_by, nbytes / 1e9, bytes_ms, flops / 1e9,
            flops_ms))
    if scaled:
        log('{}: posterior max abs diff vs the log-space kernel {:.3e} '
            '(worst size)'.format(label, post_diff))
    log_floor(label, spec, cbi, num_static, be_exp, nbytes, static_ms,
              fb_chains.CLUSTER)
    log('{}: made static, the kernel alone: {:.4f} ms'.format(
        label, static_kernel_ms))
    for sched_label, rows in traces.items():
        log_trace('{} {}'.format(label, sched_label), rows)
    return dict(max_abs_err=max_err, ms=cluster_ms[fb_chains.CLUSTER],
                kernel_ms=kernel_ms[fb_chains.CLUSTER], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by), k


def log_trace(label, rows):
    """The kernel's clock64 marks (``fb_chains.trace``): per direction, the
    mean cycles a step of each part over the chains, the card's clock, and
    the slowest (chain, direction) with its steps' span."""
    from remixt_tpu_torch.ops import fb_chains
    cols = fb_chains.TRACE_COLUMNS
    steps = rows[:, 4:8].sum(axis=1)
    span_ns = rows[:, 9] - rows[:, 8]
    cycles = rows[:, :4].sum(axis=1)
    ghz = float(np.median(cycles / span_ns))
    for d, name in ((0, 'forward'), (1, 'reverse')):
        part = rows[d::2]
        kinds = dict(zip(cols[4:8], part[:, 4:8].sum(axis=0).tolist()))
        log('{}: {} mean cycles a step {}; steps {}'.format(
            label, name, json.dumps({
                cols[k]: round(float((part[:, k] / steps[d::2]).mean()), 1)
                for k in range(4)}), json.dumps(kinds)))
    worst = int(cycles.argmax())
    log('{}: {:.3f} GHz; slowest chain {} {}: {:.1f} us, {} cycles; the '
        'steps of all chains end within {:.1f} us of the first start'.format(
            label, ghz, worst // 2, ('forward', 'reverse')[worst % 2],
            span_ns[worst] / 1e3, int(cycles[worst]),
            (rows[:, 9].max() - rows[:, 8].min()) / 1e3))


def phase_kernel_scaled(inputs, log_space):
    """The restart-batched scaled kernel against its plain version on phase
    2's inputs at each cluster size in ``CLUSTERS``; its time is the main
    path's cluster size's. Also its posteriors against the log-space
    kernel's ``log_space`` messages on the same inputs, ≤ 1e-3, two
    launches on the same inputs bit-identical, and the made-static probe
    and the design's floor, as phase 2 prints them."""
    import torch
    from remixt_tpu_torch.ops import fb_grouped

    label = 'phase 2c'
    spec, frames, static_exp, be_exp, cbi = inputs
    kernel = fb_grouped.fb_grouped_scaled_cuda
    plain = fb_grouped.fb_grouped_scaled_reference
    cluster_ms, max_err, post_diff = {}, 0.0, 0.0
    with torch.no_grad():
        p = plain(frames, static_exp, be_exp, cbi)
        torch.cuda.synchronize()
        for cluster in CLUSTERS:
            k = kernel(frames, static_exp, be_exp, cbi, cluster=cluster)
            again = kernel(frames, static_exp, be_exp, cbi, cluster=cluster)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(k, again)):
                raise AssertionError('{}: two launches at cluster size {} '
                                     'differ'.format(label, cluster))
            del again
            max_err = max(max_err, check_messages(zip(k, p)))
            check_log_norm(spec, k, p)
            post_diff = max(post_diff, posterior_diff(spec, k, log_space))
            if not post_diff <= 1e-3:
                raise AssertionError('{}: posteriors differ from the '
                                     'log-space kernel\'s by {}'.format(
                                         label, post_diff))
            cluster_ms[cluster] = cuda_ms(
                lambda: kernel(frames, static_exp, be_exp, cbi,
                               cluster=cluster), reps=7)
        del p
        plain_ms = cuda_ms(lambda: plain(frames, static_exp, be_exp, cbi),
                           reps=5)
        shift_ms = cuda_ms(lambda: fb_grouped.shift_frames(frames), reps=7)
        static_only = made_static(cbi, static_exp.shape[0])
        static_ms = cuda_ms(lambda: kernel(
            frames, static_exp, be_exp, static_only), reps=7)
        fexp, fmax = fb_grouped.shift_frames(frames)

    bound_ms, bound_by, bytes_ms, flops_ms, nbytes, flops = bound(
        spec, frames.shape[0], (fexp, fmax, static_exp, be_exp, cbi), k)
    log('{}: kernel ms by cluster size {} (each with the frame shift in '
        'torch, {:.3f} ms), plain {:.3f} ms, max abs diff {:.3e}; two '
        'launches bit-identical at each'.format(
            label, json.dumps({c: round(t, 4) for c, t in cluster_ms.items()}),
            shift_ms, plain_ms, max_err))
    log('{}: bound {:.4f} ms ({}): bytes {:.4f} GB = {:.4f} ms, fp32 {:.3f} '
        'GFLOP = {:.4f} ms; posterior max abs diff vs the log-space kernel '
        '{:.3e}'.format(label, bound_ms, bound_by, nbytes / 1e9, bytes_ms,
                        flops / 1e9, flops_ms, post_diff))
    log_floor(label, spec, cbi, static_exp.shape[0], be_exp, nbytes,
              static_ms, fb_grouped.CLUSTER)
    return dict(max_abs_err=max_err, ms=cluster_ms[fb_grouped.CLUSTER],
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


@contextlib.contextmanager
def scaled_switch(on):
    """The scaled-linear switch of both chain wrappers, restored after."""
    from remixt_tpu_torch.ops import fb_grouped
    before = fb_grouped.SCALED_LINEAR
    fb_grouped.SCALED_LINEAR = on
    try:
        yield
    finally:
        fb_grouped.SCALED_LINEAR = before


def chain_launches():
    """The launch counters of the four chain kernels, by kernel name."""
    from remixt_tpu_torch.ops import fb_chains, fb_grouped
    return {'fb_grouped': fb_grouped.LAUNCHES,
            'fb_chains': fb_chains.LAUNCHES,
            'fb_grouped_scaled': fb_grouped.LAUNCHES_SCALED,
            'fb_chains_scaled': fb_chains.LAUNCHES_SCALED}


def reset_chain_launches():
    from remixt_tpu_torch.ops import fb_chains, fb_grouped
    fb_grouped.LAUNCHES = fb_chains.LAUNCHES = 0
    fb_grouped.LAUNCHES_SCALED = fb_chains.LAUNCHES_SCALED = 0


def timed_fit(data, num_restarts, batched):
    """``fit_many`` over the first ``num_restarts`` of phase 3's grid,
    batched or one restart at a time, 2 EM × 2 VI, with per-stage wall
    times. Returns the results, each with its segment posteriors under
    ``'posteriors'``, the stages, the wall time and the chain kernels'
    launches during the fit."""
    import torch
    from remixt_tpu_torch.analysis import pipeline
    from remixt_tpu_torch.models import em, engine as eng

    init_params, config, experiment = fit_inputs(
        data, NUM_EM_ITER, num_restarts=num_restarts)
    config['batch_restarts'] = batched
    # the batched functions carry these suffixes
    e, m = ('_restarts', '_batched') if batched else ('', '')
    stages = {}
    timed = stage_timer(stages)
    extract = pipeline._extract_results

    def with_posteriors(model, *args):
        out = extract(model, *args)
        out['posteriors'] = model.state.posterior_marginals.cpu().numpy()
        return out

    pipeline._extract_results = with_posteriors
    originals = [
        (pipeline, '_extract_results', extract),
        (eng, 'variational_sweeps' + e,
         timed(eng, 'variational_sweeps' + e, 'sweeps')),
        (eng, 'calculate_elbo' + e,
         timed(eng, 'calculate_elbo' + e, 'initial_elbo')),
        (em, 'update_h_fused' + m, timed(em, 'update_h_fused' + m,
                                         'h_update')),
        (em, 'param_sample_weights_all' + m,
         timed(em, 'param_sample_weights_all' + m, 'sample_weights')),
        (em, 'update_params_fused' + m,
         timed(em, 'update_params_fused' + m, 'params_update_elbo')),
    ]
    torch.cuda.reset_peak_memory_stats()
    reset_chain_launches()
    t0 = time.time()
    try:
        results = pipeline.fit_many(experiment, init_params, config)
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
    torch.cuda.synchronize()
    return results, stages, time.time() - t0, chain_launches()


def expect_launches(label, launches, name, expected):
    """Kernel ``name`` launched ``expected`` times in the run, every other
    chain kernel never."""
    want = {k: expected if k == name else 0 for k in launches}
    if launches != want:
        raise AssertionError('{}: chain kernel launches {}, expected {}'
                             .format(label, launches, want))


def em_iterations(stages, n_em):
    return [sum(stages[k][i] for k in ('sweeps', 'h_update',
                                       'sample_weights',
                                       'params_update_elbo'))
            for i in range(n_em)]


def log_fit(label, stages, wall, n_em, results):
    import torch
    per_sweep = [x / NUM_UPDATE_ITER for x in stages['sweeps']]
    log('{}: wall {:.3f} s; per EM iteration {} s; per sweep {} s'.format(
        label, wall, ['{:.3f}'.format(x) for x in em_iterations(stages, n_em)],
        ['{:.4f}'.format(x) for x in per_sweep]))
    log('{}: stages '.format(label) + json.dumps(
        {k: [round(x, 4) for x in v] for k, v in stages.items()}))
    log('{}: max_memory_allocated {:.3f} GB, ELBOs {}'.format(
        label, torch.cuda.max_memory_allocated() / 1e9,
        np.array2string(check_results(results), precision=2)))


def phase_fit(data):
    """fit_many at full width, with per-stage wall times."""
    results, stages, wall, launches = timed_fit(data, WAVE, batched=True)
    waves = -(-len(results) // WAVE)
    expected = waves * NUM_EM_ITER * NUM_UPDATE_ITER
    expect_launches('phase 3', launches, 'fb_grouped', expected)
    log('phase 3: fit_many, {} restarts in {} wave(s), {} EM x {} VI '
        '(depth cut from the 5 x 5 defaults), fb_grouped launches {}'.format(
            len(results), waves, NUM_EM_ITER, NUM_UPDATE_ITER, expected))
    log_fit('phase 3', stages, wall, NUM_EM_ITER, results)
    truth = data['cn'][:, 1:, :]
    best = max(results.values(), key=lambda r: r['stats']['elbo'])
    dec = best['cn'][:, 1:, :]
    exact = (np.all(dec == truth, axis=(1, 2))
             | np.all(dec == truth[:, :, ::-1], axis=(1, 2)))
    log('phase 3: best restart h {}, exact tumour cn on {:.3f} of segments'
        .format(np.array2string(best['h'], precision=5), exact.mean()))
    repeat_wave(data, results)
    return expected, results


def fit_differences(first, again):
    """Per restart, the max abs difference of h, ELBO and posteriors of a
    refit from the first fit."""
    return {key: max(float(np.abs(np.asarray(pick(first[i]))
                                  - np.asarray(pick(again[i]))).max())
                     for i in first)
            for key, pick in (('h', lambda r: r['h']),
                              ('elbo', lambda r: r['stats']['elbo']),
                              ('posteriors', lambda r: r['posteriors']))}


def deterministic_fit(fit):
    """``fit()`` under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``; returns its result and the ops torch names as
    nondeterministic in it."""
    import warnings
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            out = fit()
    finally:
        torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split('. ')[0] for w in caught
                  if 'deterministic' in str(w.message).lower()})
    return out, ops


def repeat_wave(data, first):
    """Phase 3's wave fitted again under torch's deterministic algorithms
    with warnings only: its h, ELBOs and posteriors must equal the first
    fit's bit for bit."""
    again, ops = deterministic_fit(
        lambda: timed_fit(data, WAVE, batched=True)[0])
    diff = fit_differences(first, again)
    log('phase 3: the wave fitted again under torch.use_deterministic_'
        'algorithms(True, warn_only=True): max abs diff from the first fit '
        '{}; ops torch names as nondeterministic: {}'.format(
            json.dumps(diff), json.dumps(ops) if ops else 'none'))
    if any(diff.values()):
        raise AssertionError('phase 3: the batched refit differs from the '
                             'first fit: {}'.format(diff))


def check_results(results):
    """Finite ELBOs and h, copy number of the full width; returns the
    ELBOs."""
    elbos = np.array([r['stats']['elbo'] for r in results.values()])
    if not np.all(np.isfinite(elbos)):
        raise AssertionError('non-finite ELBO: {}'.format(elbos))
    for r in results.values():
        if r['cn'].shape != (N_FULL, 3, 2):
            raise AssertionError('cn shape {}'.format(r['cn'].shape))
        if not np.all(np.isfinite(r['h'])):
            raise AssertionError('non-finite h')
    return elbos


def fit_inputs(data, num_em_iter, num_restarts=WAVE):
    """Phase 3's restart grid, config and experiment."""
    from remixt_tpu_torch.analysis.experiment import Experiment
    h_inits, weights = restart_grid(data['h'], WAVE)
    init_params = {
        i: dict(mode_idx=0, h_normal=h[0], h_tumour=h[1] + h[2],
                mix_frac=h[1] / (h[1] + h[2]), divergence_weight=w,
                max_depth=1e9)
        for i, (h, w) in enumerate(zip(h_inits[:num_restarts],
                                       weights[:num_restarts]))}
    config = dict(max_copy_number=CN_MAX_FULL, num_em_iter=num_em_iter,
                  num_update_iter=NUM_UPDATE_ITER,
                  likelihood_min_segment_length=1.0,
                  likelihood_min_proportion_genotyped=0.0,
                  restart_chunk_size=WAVE, random_seed=1234)
    experiment = Experiment(data['x'], data['l'], data['adjacencies'],
                            data['breakpoints'])
    return init_params, config, experiment


def stage_timer(stages):
    """``timed(module, name, label)`` swaps ``module.name`` for a wrapper
    that appends its synchronized wall time to ``stages[label]``, and
    returns the original."""
    import torch

    def timed(module, name, label):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages.setdefault(label, []).append(time.time() - t0)
            return out
        setattr(module, name, wrapper)
        return fn
    return timed


def same_cn(results, reference):
    """Per restart, the share of segments whose decoded copy number equals
    the reference fit's."""
    return {i: float(np.all(r['cn'] == reference[i]['cn'],
                            axis=(1, 2)).mean())
            for i, r in results.items()}


def phase_sequential_fit(data, batched_results):
    """The single-restart path at full width: the sequential fit_many over
    the first restarts of phase 3's grid, with per-stage wall times."""
    results, stages, wall, launches = timed_fit(
        data, SEQUENTIAL_RESTARTS, batched=False)
    expected = SEQUENTIAL_RESTARTS * NUM_EM_ITER * NUM_UPDATE_ITER
    expect_launches('phase 6', launches, 'fb_chains', expected)
    log('phase 6: sequential fit_many, {} restarts one at a time, {} EM x {} '
        'VI, fb_chains launches {}'.format(
            SEQUENTIAL_RESTARTS, NUM_EM_ITER, NUM_UPDATE_ITER, expected))
    log_fit('phase 6', stages, wall, SEQUENTIAL_RESTARTS * NUM_EM_ITER,
            results)
    log('phase 6: share of segments whose cn equals the batched fit of '
        'phase 3, per restart: ' + json.dumps(same_cn(results,
                                                      batched_results)))
    repeat_fit(data, results[0])
    resume_fit(data, results[0])
    return expected, results


def repeat_fit(data, first):
    """Restart 0 fitted twice more: as it was, and under torch's
    deterministic algorithms with warnings only. Prints the max abs
    difference of h, ELBO and posteriors of each from phase 6's fit, and
    the ops that torch names as nondeterministic. Reports only; a
    difference fails nothing."""
    def diff(again):
        return fit_differences({0: first}, again)

    log('phase 6: restart 0 fitted again: max abs diff from the first fit '
        '{}'.format(json.dumps(diff(timed_fit(data, 1, batched=False)[0]))))
    again, ops = deterministic_fit(
        lambda: timed_fit(data, 1, batched=False)[0])
    log('phase 6: restart 0 fitted again under torch.use_deterministic_'
        'algorithms(True, warn_only=True): max abs diff from the first fit '
        '{}'.format(json.dumps(diff(again))))
    log('phase 6: ops torch names as nondeterministic in that fit: {}'.format(
        json.dumps(ops) if ops else 'none'))


def resume_fit(data, first):
    """Restart 0 through ``pipeline.fit`` with a snapshot file, stopped
    after one EM iteration and resumed from the snapshot to phase 6's
    depth, as a killed ``fit_task`` job resumes. Prints the max abs
    difference of h, ELBO, posteriors and decoded copy number (segments
    and breakpoints) from phase 6's uninterrupted fit; any nonzero
    difference fails."""
    import os
    from remixt_tpu_torch.analysis import pipeline

    init_params, config, experiment = fit_inputs(data, 1, num_restarts=1)
    snapshot = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'build', 'chip_smoke', 'restart0.ckpt')
    os.makedirs(os.path.dirname(snapshot), exist_ok=True)
    if os.path.exists(snapshot):
        os.remove(snapshot)
    extract = pipeline._extract_results

    def with_posteriors(model, *args):
        out = extract(model, *args)
        out['posteriors'] = model.state.posterior_marginals.cpu().numpy()
        return out

    pipeline._extract_results = with_posteriors
    try:
        pipeline.fit(experiment, init_params[0], config,
                     snapshot_filename=snapshot)
        config['num_em_iter'] = NUM_EM_ITER
        resumed = pipeline.fit(experiment, init_params[0], config,
                               snapshot_filename=snapshot)
    finally:
        pipeline._extract_results = extract
        if os.path.exists(snapshot):
            os.remove(snapshot)

    def max_diff(a, b):
        return float(np.abs(np.asarray(a, dtype=float)
                            - np.asarray(b, dtype=float)).max())

    diff = {key: max_diff(pick(first), pick(resumed))
            for key, pick in (('h', lambda r: r['h']),
                              ('elbo', lambda r: r['stats']['elbo']),
                              ('posteriors', lambda r: r['posteriors']),
                              ('cn', lambda r: r['cn']))}
    brk, brk_ref = resumed['brk_cn'], first['brk_cn']
    diff['brk_cn'] = (max([max_diff(brk[k], brk_ref[k]) for k in brk_ref]
                          + [0.0]) if set(brk) == set(brk_ref)
                      else float('inf'))
    log('phase 6: restart 0 through pipeline.fit stopped after 1 EM '
        'iteration and resumed from its snapshot to {}: max abs diff from '
        'the uninterrupted fit {}'.format(NUM_EM_ITER, json.dumps(diff)))
    if any(v != 0.0 for v in diff.values()):
        raise AssertionError('phase 6: the resumed fit differs from the '
                             'uninterrupted one: {}'.format(diff))


def phase_scaled_fits(data, batched_results, sequential_results):
    """Both fit paths at full width with the scaled-linear switch on:
    phase 3's wave batched and restart 0 one at a time, against the
    log-space fits of phases 3 and 6."""
    sweeps = NUM_EM_ITER * NUM_UPDATE_ITER
    launches = {}
    with scaled_switch(True):
        for label, num_restarts, batched, name, reference in (
                ('phase 7 batched', WAVE, True, 'fb_grouped_scaled',
                 batched_results),
                ('phase 7 sequential', 1, False, 'fb_chains_scaled',
                 sequential_results)):
            results, stages, wall, counts = timed_fit(data, num_restarts,
                                                      batched)
            expected = -(-num_restarts // WAVE) * sweeps if batched else (
                num_restarts * sweeps)
            expect_launches(label, counts, name, expected)
            launches[name] = expected
            log('{}: fit_many, {} restart(s), {} EM x {} VI, scaled-linear '
                'switch on, {} launches {}'.format(
                    label, num_restarts, NUM_EM_ITER, NUM_UPDATE_ITER, name,
                    expected))
            log_fit(label, stages, wall, (1 if batched else num_restarts)
                    * NUM_EM_ITER, results)
            shares = same_cn(results, reference)
            log('{}: share of segments whose cn equals the log-space fit '
                '(phase {}), per restart: {}'.format(
                    label, 3 if batched else 6, json.dumps(shares)))
            if min(shares.values()) < SAME_CN_SHARE:
                raise AssertionError('{}: scaled fit decodes another copy '
                                     'number on more than {:.0%} of the '
                                     'segments'.format(
                                         label, 1 - SAME_CN_SHARE))
    return launches


def phase_profile(data):
    """One more full-width fit (1 EM × 2 VI) under torch.profiler: the
    device's busy share of the wall time, device time per fit stage, and
    the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from remixt_tpu_torch.analysis import pipeline
    from remixt_tpu_torch.models import em, engine as eng

    init_params, config, experiment = fit_inputs(data, 1)

    def labelled(module, name, label):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            with record_function('stage:' + label):
                return fn(*args, **kwargs)
        setattr(module, name, wrapper)
        return module, name, fn

    originals = [
        labelled(eng, 'variational_sweeps_restarts', 'sweeps'),
        labelled(eng, 'calculate_elbo_restarts', 'initial_elbo'),
        labelled(em, 'update_h_fused_batched', 'h_update'),
        labelled(em, 'update_params_fused_batched', 'params_update_elbo'),
        labelled(eng, 'viterbi_decode', 'viterbi_decode'),
    ]
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            torch.cuda.synchronize()
            t0 = time.time()
            pipeline.fit_many(experiment, init_params, config)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.time() - t0)
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)

    # device activity: kernels, copies and sets, not the annotations the
    # profiler mirrors onto the device timeline (the stage labels and the
    # model's own ranges)
    ranges = eng.SWEEP_RANGES + em.EM_RANGES

    def annotation(name, event):
        return (name.startswith('stage:') or name in ranges
                or getattr(event, 'is_user_annotation', False))

    intervals = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA and not annotation(e.name, e))
    busy, end = 0.0, -np.inf
    for s, e in intervals:
        if e > end:
            busy += e - max(s, end)
            end = e
    if not intervals:
        log('phase 5: the profiler saw no device time: busy share not '
            'measured')
        return
    log('phase 5: profiled fit (1 EM x {} VI): wall {:.1f} ms, device busy '
        '{:.1f} ms ({:.1%}), {} device events'.format(
            NUM_UPDATE_ITER, wall_us / 1e3, busy / 1e3, busy / wall_us,
            len(intervals)))

    def device_us(row):
        return getattr(row, 'device_time_total',
                       getattr(row, 'cuda_time_total', 0.0))

    def self_device_us(row):
        return getattr(row, 'self_device_time_total',
                       getattr(row, 'self_cuda_time_total', 0.0))

    rows = prof.key_averages()
    # a stage's host-side row: its wall time on the host and the device
    # time of the kernels it launched
    for row in sorted((r for r in rows if r.key.startswith('stage:')
                       and r.cpu_time_total > 0),
                      key=lambda r: r.cpu_time_total, reverse=True):
        log('phase 5: {:<26s} calls {:2d}  host {:8.1f} ms  kernels '
            '{:8.1f} ms'.format(row.key[6:], row.count,
                                row.cpu_time_total / 1e3,
                                device_us(row) / 1e3))
    kernels = [r for r in rows if r.device_type == DeviceType.CUDA
               and not annotation(r.key, r)]
    for row in sorted(kernels, key=self_device_us, reverse=True)[:8]:
        log('phase 5: kernel {:<56.56s} calls {:6d}  device {:8.2f} ms'
            .format(row.key, row.count, self_device_us(row) / 1e3))


def run_tool(out_dir, label, name, argv):
    """``remixt_tpu_torch.tools.<name>.main(argv)`` with its stdout in
    ``<label>.log`` under ``out_dir``; returns what main returned."""
    module = importlib.import_module('remixt_tpu_torch.tools.' + name)
    t0 = time.time()
    with open(os.path.join(out_dir, label + '.log'), 'w') as f, \
            contextlib.redirect_stdout(f):
        out = module.main(argv)
    log('phase 5b: {} {} took {:.1f} s'.format(name, ' '.join(argv),
                                               time.time() - t0))
    return out


def check_sweep_budget(out, kernel, kernel_ms):
    """Phase 5b (a)'s gates on one ``sweep_budget`` output."""
    R = out['restarts']
    missing = [c for c in SWEEP_PARTS if out[c + '_ms_per_block'] <= 0]
    if missing:
        raise AssertionError('phase 5b: R={}: no device time under {}'
                             .format(R, missing))
    parts = (out['sum_components_ms_per_block']
             + out['unattributed_ms_per_block'])
    if abs(parts - out['block_device_ms']) > 0.01 * out['block_device_ms']:
        raise AssertionError(
            'phase 5b: R={}: parts {:.3f} + unattributed {:.3f} ms against '
            'the block\'s {:.3f} ms'.format(
                R, out['sum_components_ms_per_block'],
                out['unattributed_ms_per_block'], out['block_device_ms']))
    if out['p_cn_chain_ms_per_sweep'] < 0.75 * kernel_ms:
        raise AssertionError(
            'phase 5b: R={}: the chain update {:.3f} ms a sweep is under '
            '0.75 x {}\'s {:.3f} ms'.format(
                R, out['p_cn_chain_ms_per_sweep'], kernel, kernel_ms))


def phase_tools(grouped_ms, chains_kernel_ms):
    """The measurement tools at full width through their ``main(argv)``;
    returns the ``fb_grouped`` and ``fb_chains`` launches they made.
    ``grouped_ms`` is phase 2's ``fb_grouped`` through its wrapper,
    ``chains_kernel_ms`` phase 2b's ``fb_chains`` kernel alone."""
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, 'build', 'chip_smoke', 'tools')
    os.makedirs(out_dir, exist_ok=True)
    width = ['--n', str(N_FULL), '--events', str(EVENTS_FULL)]

    def out_file(label):
        return ['--out', os.path.join(out_dir, label + '.json')]

    torch.cuda.empty_cache()
    reset_chain_launches()
    t0 = time.time()
    # (a) a sweep's parts, a wave and one restart
    for R, kernel, kernel_ms in ((WAVE, 'fb_grouped', grouped_ms),
                                 (0, 'fb_chains alone', chains_kernel_ms)):
        label = 'sweep_budget_R{}'.format(R)
        out = run_tool(out_dir, label, 'sweep_budget', width + [
            '--restarts', str(R), '--iters', '2'] + out_file(label))
        log('phase 5b: sweep_budget --restarts {}: device ms a sweep by '
            'range {}'.format(R, json.dumps(
                {c: out[c + '_ms_per_sweep'] for c in SWEEP_PARTS})))
        log('phase 5b: sweep_budget --restarts {}: the 5-sweep block: wall '
            '{:.3f} ms, device {:.3f} ms (the device busy {:.1%} of the '
            'wall), in the ranges {:.3f} ms, unattributed {:.3f} ms'.format(
                R, out['block_wall_ms'], out['block_device_ms'],
                out['block_device_ms'] / out['block_wall_ms'],
                out['sum_components_ms_per_block'],
                out['unattributed_ms_per_block']))
        check_sweep_budget(out, kernel, kernel_ms)
        log('phase 5b: sweep_budget --restarts {}: the chain update {:.3f} '
            'ms a sweep, {} {:.3f} ms'.format(
                R, out['p_cn_chain_ms_per_sweep'], kernel, kernel_ms))

    # (b) one batched EM iteration by range
    out = run_tool(out_dir, 'fit_budget_trace', 'fit_budget', width + [
        '--trace', '--restarts', str(WAVE), '--iters', '3']
        + out_file('fit_budget_trace'))
    log('phase 5b: fit_budget --trace, one batched EM iteration (R={}, {} '
        'VI sweeps): wall {:.3f} ms, device {:.3f} ms ({:.1%})'.format(
            WAVE, 5, out['em_iter_wall_ms'], out['em_iter_device_ms'],
            out['em_iter_device_ms'] / out['em_iter_wall_ms']))
    log('phase 5b: fit_budget --trace: device ms by range ' + json.dumps(
        {k[:-3]: v for k, v in out.items() if k.endswith('_ms')
         and not k.startswith('em_iter_')}))

    # (c) the phase timings
    out = run_tool(out_dir, 'fit_budget', 'fit_budget', width + [
        '--restarts', str(WAVE), '--iters', '1'] + out_file('fit_budget'))
    log('phase 5b: fit_budget: ' + json.dumps(
        {k: v for k, v in out.items() if k.endswith(('_s', '_ms'))}))

    # (d) the restart axis
    rows = run_tool(out_dir, 'probe_restart_scaling',
                    'probe_restart_scaling',
                    width + ['--iters', '1']
                    + out_file('probe_restart_scaling')
                    + [str(r) for r in PROBE_WAVES])
    for row in rows:
        log('phase 5b: probe_restart_scaling ' + json.dumps(row))

    # (e) the single-restart sweep's profile
    trace_dir = os.path.join(out_dir, 'profile_engine')
    out = run_tool(out_dir, 'profile_engine', 'profile_engine',
                   width + ['--outdir', trace_dir])
    log('phase 5b: profile_engine, one restart: {:.3f} ms a sweep ({:.0f} '
        'segments/s) under the profiler'.format(out['ms_per_sweep'],
                                                out['segments_per_s']))
    kind, total, top = run_tool(out_dir, 'summarize_trace',
                                'summarize_trace',
                                [trace_dir, '--top', '10'])
    if kind != 'device':
        raise AssertionError('phase 5b: the single-restart trace holds no '
                             'device event')
    log('phase 5b: summarize_trace --top 10: device total {:.1f} us over '
        '5 sweeps'.format(total))
    for name, us, n in top:
        log('phase 5b:   {:10.1f} us {:5.1f} % {:6d}  {}'.format(
            us, 100 * us / total, n, name[:90]))

    launches = chain_launches()
    if (launches['fb_grouped_scaled'] or launches['fb_chains_scaled']
            or not launches['fb_grouped'] or not launches['fb_chains']):
        raise AssertionError('phase 5b: chain kernel launches {}'.format(
            launches))
    log('phase 5b: chain kernel launches {}; the phase took {:.1f} s'.format(
        json.dumps(launches), time.time() - t0))
    return launches['fb_grouped'], launches['fb_chains']


def phase_small_f32_vs_f64():
    import torch
    from remixt_tpu_torch.models import engine as eng

    data = simulate(60, 4, 8, 2, seed=2)
    h_inits, weights = restart_grid(data['h'], 4, seed=3)
    for scaled in (False, True):
        marg = {}
        with scaled_switch(scaled):
            for device, dtype in (('cuda', torch.float32),
                                  ('cpu', torch.float64)):
                model = make_model(data, 4, device, dtype)
                spec, params_b, state_b = initial_batch(model, h_inits,
                                                        weights)
                swept_b = eng.variational_sweeps_restarts(spec, params_b,
                                                          state_b, 5)
                swept = eng.variational_sweeps(spec, eng.take(params_b, 0),
                                               eng.take(state_b, 0), 5)
                marg[device] = [s.posterior_marginals.double().cpu().numpy()
                                for s in (swept_b, swept)]
        recursion = 'scaled-linear' if scaled else 'log-space'
        for label, card, cpu in zip(('R=4', 'one restart'), marg['cuda'],
                                    marg['cpu']):
            diff = float(np.abs(card - cpu).max())
            log('phase 4: {}, f32 card vs f64 CPU, N=60 S={} {}, 5 sweeps: '
                'posterior max abs diff {:.3e}'.format(
                    recursion, cpu.shape[-1], label, diff))
            if not diff <= 1e-3:
                raise AssertionError('f32 posteriors ({}, {}) differ from '
                                     'f64 by {}'.format(recursion, label,
                                                        diff))


def time_float64_scans():
    """Both float64 scans at whole-genome width on the card, on the
    frames and q(brk) of phase 3's wave before its first sweep: one restart
    and the R=8 wave, each call's device time and the wave's peak memory
    above what was allocated before it, and each held to the same scan on
    the CPU (posteriors within ``F64_SCAN_BAR``, log_norm rtol 1e-12)."""
    import torch
    from remixt_tpu_torch.models import engine as eng
    from remixt_tpu_torch.ops import fb_scan

    data = simulate(N_FULL, CN_MAX_FULL, EVENTS_FULL, CHAINS_FULL, seed=0)
    model = make_model(data, CN_MAX_FULL, 'cuda', torch.float64)
    h_inits, weights = restart_grid(data['h'], WAVE)
    spec, params_b, state_b = initial_batch(model, h_inits, weights)
    ll_tot, ll_alle = eng.emission_tensors(spec, params_b)
    frame_b = eng._mix_framelogprob(spec, params_b, state_b, ll_tot, ll_alle)
    del ll_tot, ll_alle
    layout = (spec.chain_bank_idx, spec.chain_seg_map, spec.chain_last)
    bank = eng.full_bank(spec, state_b.p_breakpoint[0])
    one_ms = cuda_ms(lambda: fb_scan.forward_backward_chains(
        frame_b[0], bank, *layout), 3)
    be_bank_b = eng.breakend_tmats(spec, state_b.p_breakpoint)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wave_ms = cuda_ms(lambda: fb_scan.forward_backward_chains_restarts(
        frame_b, spec.static_bank, be_bank_b, spec.restart_plan,
        spec.chain_seg_map, spec.chain_last), 3)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9

    def cpu(x):
        return x.cpu() if torch.is_tensor(x) else x

    for label, run, args in (
            ('one restart', fb_scan.forward_backward_chains,
             (frame_b[0], bank) + layout),
            ('R={}'.format(WAVE), fb_scan.forward_backward_chains_restarts,
             (frame_b, spec.static_bank, be_bank_b, spec.restart_plan,
              spec.chain_seg_map, spec.chain_last))):
        card = [x.cpu() for x in run(*args)]
        host = run(*[cpu(x) for x in args])
        diff = float((eng.exp_normalize(card[0] + card[1], dim=-1)
                      - eng.exp_normalize(host[0] + host[1], dim=-1)
                      ).abs().max())
        norm = float(((card[2] - host[2]) / host[2]).abs().max())
        log('phase 10 (a): float64 scan, {}, card vs CPU at N={}: posterior '
            'max abs diff {:.3e}, log_norm rel diff {:.3e}'.format(
                label, spec.N, diff, norm))
        if not (diff <= F64_SCAN_BAR and norm <= 1e-12):
            raise AssertionError('phase 10 (a): the card\'s float64 scan '
                                 '({}) differs from the CPU\'s'.format(label))
    log('phase 10 (a): float64 scans at N={} S={} J={} Q={} L={} (kmax {}): '
        'one restart {:.3f} ms, R={} {:.3f} ms; the wave call\'s peak above '
        'its inputs {:.3f} GB (the log-space bank {:.3f} GB)'.format(
            spec.N, spec.S, spec.J, spec.Q, spec.L,
            spec.restart_plan['kmax'], one_ms, WAVE, wave_ms, peak_gb,
            be_bank_b.numel() * 8 / 1e9))


def phase_float64():
    """The float64 route on the card (the plain chain scan,
    ``ops/fb_scan.py``) and the accuracy gate's three checks at
    whole-genome width."""
    import torch
    from remixt_tpu_torch.models import engine as eng
    from remixt_tpu_torch.tools import accuracy_gate as gate

    # (a) the scan route on the card (the float64 default) against the
    # plain kernel versions on the CPU (asked for: float64 takes the scan
    # there too by default), both float64, at phase 4's size
    data = simulate(60, 4, 8, 2, seed=2)
    h_inits, weights = restart_grid(data['h'], 4, seed=3)
    marg = {}
    for device in ('cuda', 'cpu'):
        before = chain_launches()
        model = make_model(data, 4, device, torch.float64,
                           use_kernels=True if device == 'cpu' else None)
        spec, params_b, state_b = initial_batch(model, h_inits, weights)
        if spec.use_kernels != (device == 'cpu'):
            raise AssertionError('phase 10: float64 on {} takes the {} '
                                 'route'.format(device, 'kernel' if
                                                spec.use_kernels else 'scan'))
        swept_b = eng.variational_sweeps_restarts(spec, params_b, state_b, 5)
        swept = eng.variational_sweeps(spec, eng.take(params_b, 0),
                                       eng.take(state_b, 0), 5)
        marg[device] = [s.posterior_marginals.cpu().numpy()
                        for s in (swept_b, swept)]
        if device == 'cuda' and chain_launches() != before:
            raise AssertionError('phase 10: the float64 scan route '
                                 'launched a kernel')
    for label, card, cpu in zip(('R=4', 'one restart'), marg['cuda'],
                                marg['cpu']):
        diff = float(np.abs(card - cpu).max())
        log('phase 10 (a): float64 scan on the card vs float64 plain kernel '
            'versions on the CPU, N=60 S={} {}, 5 sweeps: posterior max abs '
            'diff {:.3e} (bar {:.0e})'.format(cpu.shape[-1], label, diff,
                                               F64_SCAN_BAR))
        if not diff <= F64_SCAN_BAR:
            raise AssertionError('phase 10 (a): {} differs by {}'.format(
                label, diff))

    time_float64_scans()

    # (b) the gate's --oracle at whole-genome width, the float64 engine on
    # the card in the oracle's place
    reset_chain_launches()
    entry = gate.gate_oracle(N_FULL, num_sweeps=5, dtype='float32',
                             device='cuda', reference='engine')
    expect_launches('phase 10 (b)', chain_launches(), 'fb_chains', 5)
    last = entry['per_sweep'][-1]
    log('phase 10 (b): f32 kernel route vs f64 scan route on the card (the '
        'sweeps above), N={} S={} K={}: posterior max abs diff {:.3e} over '
        '5 sweeps (JAX f32 vs f64 oracle {:.1e}), argmax disagreement '
        '{:.3e} settled (JAX {:.1e}); thresholds {}'.format(
            entry['N'], entry['S'], entry['K'],
            entry['posterior_max_abs_diff'],
            JAX_F32_VS_F64_SWEEPS['posterior_max_abs_diff'],
            last['posterior_argmax_disagreement'],
            JAX_F32_VS_F64_SWEEPS['posterior_argmax_disagreement'],
            json.dumps(gate.ORACLE_GATE_THRESHOLDS)))
    failures = gate.check_thresholds(entry)
    if failures:
        raise AssertionError('phase 10 (b): ' + '; '.join(failures))

    # (c) the gate's --em: the float32 and float64 5 x 5 fits
    fit = gate.gate_em(N_FULL, device='cuda')
    log('phase 10 (c): f32 vs f64 single-restart fit, {} EM x {} VI: '.format(
        fit['num_em_iter'], fit['num_update_iter']) + ', '.join(
            '{} {:.3e} (JAX {:.1e})'.format(k, fit[k], v)
            for k, v in JAX_F32_VS_F64_FIT.items()))
    log('phase 10 (c): ELBO f32 {:.6f}, f64 {:.6f}; f64 fit wall {:.3f} s, '
        'EM iteration {:.3f} s, max_memory_allocated {:.3f} GB, kernel '
        'launches {}; f32 fit wall {:.3f} s, EM iteration {:.3f} s, '
        'max_memory_allocated {:.3f} GB, kernel launches {}'.format(
            fit['elbo_f32'], fit['elbo_f64'], fit['f64_fit_seconds'],
            fit['f64_em_iteration_seconds'], fit['f64_peak_gb'],
            fit['f64_kernel_launches'], fit['f32_fit_seconds'],
            fit['f32_em_iteration_seconds'], fit['f32_peak_gb'],
            fit['f32_kernel_launches']))
    if fit['f64_kernel_launches']:
        raise AssertionError('phase 10 (c): the float64 fit launched {} '
                             'kernels'.format(fit['f64_kernel_launches']))
    if not np.isfinite([fit['elbo_f32'], fit['elbo_f64']]).all():
        raise AssertionError('phase 10 (c): non-finite ELBO')
    if not fit['decode_disagreement_fraction'] <= DECODE_DISAGREEMENT_BAR:
        raise AssertionError('phase 10 (c): decode disagreement {}'.format(
            fit['decode_disagreement_fraction']))

    # (d) the gate's --kernels
    reset_chain_launches()
    entry = gate.gate_kernels(N_FULL, num_sweeps=5, device='cuda')
    expect_launches('phase 10 (d)', chain_launches(), 'fb_chains', 5)
    log('phase 10 (d): f32 kernel route vs f32 scan route on the card, 5 '
        'sweeps: ' + json.dumps(entry))
    if not entry['posterior_max_abs_diff'] <= KERNELS_VS_SCAN_BAR:
        raise AssertionError('phase 10 (d): posteriors differ by {}'.format(
            entry['posterior_max_abs_diff']))


def write_tables(data, directory, segment_length=500000):
    """Count and breakpoint TSVs of a simulated experiment in the reference
    schema; chains become chromosomes (positions restart per chromosome),
    as in ``tests/test_pipeline.make_tables``. Returns their paths."""
    N = data['x'].shape[0]
    chrom = np.zeros(N, dtype=int)
    pos = np.zeros(N, dtype=int)
    for n in range(1, N):
        adjacent = (n - 1, n) in data['adjacencies']
        chrom[n] = chrom[n - 1] + (0 if adjacent else 1)
        pos[n] = pos[n - 1] + 1 if adjacent else 0
    start = pos * segment_length + 1
    end = (pos + 1) * segment_length
    count_file = os.path.join(directory, 'counts.tsv')
    breakpoint_file = os.path.join(directory, 'breakpoints.tsv')
    with open(count_file, 'w', newline='') as f:
        out = csv.writer(f, delimiter='\t', lineterminator='\n')
        out.writerow(['chromosome', 'start', 'end', 'length',
                      'major_readcount', 'minor_readcount', 'readcount',
                      'major_is_allele_a'])
        for n in range(N):
            out.writerow([str(chrom[n] + 1), start[n], end[n],
                          repr(float(data['l'][n]))]
                         + [int(v) for v in data['x'][n]] + [1])
    with open(breakpoint_file, 'w', newline='') as f:
        out = csv.writer(f, delimiter='\t', lineterminator='\n')
        out.writerow(['prediction_id', 'chromosome_1', 'strand_1',
                      'position_1', 'chromosome_2', 'strand_2', 'position_2'])
        for bp_id, bp in data['breakpoints'].items():
            row = [bp_id]
            for n, side in sorted(bp):
                row += [str(chrom[n] + 1), '+' if side == 1 else '-',
                        end[n] if side == 1 else start[n]]
            out.writerow(row)
    return count_file, breakpoint_file


HAVE_H5PY = importlib.util.find_spec('h5py') is not None


def tsv_experiment(data, root):
    """A fresh ``root`` with ``data`` written as count and breakpoint TSVs
    and ``create_experiment`` run on them. Returns the experiment file and
    the seconds ``create_experiment`` took."""
    from remixt_tpu_torch.analysis import experiment as experiment_mod
    fresh_directory(root)
    count_file, breakpoint_file = write_tables(data, root)
    experiment_file = os.path.join(root, 'experiment.pickle')
    t0 = time.time()
    experiment_mod.create_experiment(count_file, breakpoint_file,
                                     experiment_file)
    return experiment_file, time.time() - t0


def fresh_directory(root):
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)


def fit_workflow(label, experiment_file, config, device, root):
    """One sample's pickled experiment through the ``fit`` workflow in
    ``root``: ``init``, the fit task, ``collate``, then the workflow run
    again on its work directory. Without h5py the fit task runs alone in
    the workflow and ``init`` and ``collate`` through their table builders.

    Returns dict(init_params, tables, fits {init_id: pickled results},
    times {step: seconds, 'whole' from init to the tables}, waves [seconds
    of each wave of the batched fit], launches, rerun seconds, rerun
    launches).
    """
    import torch
    from remixt_tpu_torch import workflow
    from remixt_tpu_torch.analysis import pipeline
    from remixt_tpu_torch.io import hdf5
    from remixt_tpu_torch.models import engine as eng
    from remixt_tpu_torch.scheduler import Workflow

    results_file = os.path.join(root, 'results.h5')
    tempdir = os.path.join(root, 'fit')
    stages, captured, marks = {}, {}, []
    timed = stage_timer(stages)
    init_tables = pipeline.init_tables
    elbo0, batched = eng.calculate_elbo_restarts, pipeline.fit_restarts_batched

    def capture_init(*args, **kwargs):
        captured['init'] = init_tables(*args, **kwargs)
        return captured['init']

    def wave_start(*args, **kwargs):
        torch.cuda.synchronize()
        marks.append(time.time())
        return elbo0(*args, **kwargs)

    def waves(*args, **kwargs):
        out = batched(*args, **kwargs)
        torch.cuda.synchronize()
        marks.append(time.time())
        return out

    pipeline.init_tables = capture_init
    eng.calculate_elbo_restarts = wave_start
    pipeline.fit_restarts_batched = waves
    originals = [(pipeline, 'init_tables', init_tables),
                 (eng, 'calculate_elbo_restarts', elbo0),
                 (pipeline, 'fit_restarts_batched', batched)]
    originals += [(module, name, timed(module, name, step)) for module, name,
                  step in ((pipeline, 'init_tables', 'init'),
                           (pipeline, 'fit_many', 'fit'),
                           (pipeline, 'collate_tables', 'collate'))]

    def build():
        if HAVE_H5PY:
            return workflow.create_fit_model_workflow(
                experiment_file, results_file, config, None, tempdir,
                device=device)
        flow = Workflow('fit_model')
        flow.transform('fit', workflow.fit_all_restarts,
                       args=(os.path.join(tempdir, 'fit_results'),
                             experiment_file, captured['init'][0], config),
                       kwargs={'device': device}, inputs=[experiment_file])
        return flow

    try:
        if device is None:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        if not HAVE_H5PY:
            with open(experiment_file, 'rb') as f:
                experiment = pickle.load(f)
            pipeline.init_tables(experiment, config)
        reset_chain_launches()
        build().run(root)
        launches = chain_launches()
        init_params, init_store = captured['init']
        fits = {}
        for init_id in init_params:
            with open(os.path.join(tempdir, 'fit_results',
                                   'fit_{}.pickle'.format(init_id)),
                      'rb') as f:
                fits[init_id] = pickle.load(f)
        if HAVE_H5PY:
            tables = hdf5.read_store(results_file)
        else:
            tables = pipeline.collate_tables(experiment, fits, init_store,
                                             config)
            try:
                hdf5.write_store(results_file, tables)
            except ImportError as error:
                log('{}: h5py is absent: the results store is not written '
                    '({}); init and collate ran through their table '
                    'builders in memory and every check but the file\'s is '
                    'made'.format(label, error))
            else:
                raise AssertionError('write_store wrote without h5py')
        stages['whole'] = [time.time() - t0]
        t1 = time.time()
        reset_chain_launches()
        build().run(root)
        rerun, rerun_launches = time.time() - t1, chain_launches()
    finally:
        for module, name, fn in reversed(originals):
            setattr(module, name, fn)
    return dict(init_params=init_params, tables=tables, fits=fits,
                times={k: v[0] for k, v in stages.items()},
                waves=np.diff(marks).tolist(),
                launches=launches, rerun=rerun,
                rerun_launches=rerun_launches)


def check_rerun(label, run):
    """The workflow run again skipped every task in under 10 s."""
    if run['rerun'] >= 10.0 or any(run['rerun_launches'].values()):
        raise AssertionError('{}: the workflow run again took {:.3f} s '
                             'and launched {}'.format(
                                 label, run['rerun'], run['rerun_launches']))
    log('{}: the workflow run again skipped every task in {:.3f} s'
        .format(label, run['rerun']))


def check_results_tables(label, run, config, N):
    """The results tables of a workflow run against its fits: every key,
    finite ELBOs, the chosen solution the one ``stats`` picks (the first
    largest ELBO among restarts under ``max_prop_diverge``, else among all),
    and each solution's copy number the fit's."""
    from remixt_tpu_torch import config as config_mod
    tables, fits = run['tables'], run['fits']
    keys = {'stats', 'read_depth', 'minor_modes', 'cn', 'mix', 'brk_cn'}
    for init_id in run['init_params']:
        keys |= {'solutions/solution_{}/{}'.format(init_id, name)
                 for name in ('cn', 'brk_cn', 'h', 'mix')}
    if set(tables) != keys:
        raise AssertionError('{}: results keys {} missing, {} extra'.format(
            label, sorted(keys - set(tables)), sorted(set(tables) - keys)))
    stats = tables['stats']
    if not np.all(np.isfinite(stats['elbo'])):
        raise AssertionError('{}: non-finite ELBO'.format(label))
    if sorted(stats['init_id'].tolist()) != sorted(run['init_params']):
        raise AssertionError('{}: stats rows are not the grid'.format(label))
    passing = np.flatnonzero(stats['proportion_divergent'] < config_mod
                             .get_param(config, 'max_prop_diverge'))
    if len(passing) == 0:
        passing = np.arange(len(stats['elbo']))
    best = stats['init_id'][passing[np.argmax(stats['elbo'][passing])]]
    for name in ('cn', 'mix', 'brk_cn'):
        if not same_table(tables[name], tables[
                'solutions/solution_{}/{}'.format(best, name)]):
            raise AssertionError('{}: /{} is not solution {}\'s'.format(
                label, name, best))
    for init_id, fit in fits.items():
        table = tables['solutions/solution_{}/cn'.format(init_id)]
        if fit['cn'].shape[0] != N or not all(
                np.array_equal(table['{}_{}'.format(allele, m)],
                               fit['cn'][:, m, a])
                for m in range(fit['cn'].shape[1])
                for a, allele in enumerate(('major', 'minor'))):
            raise AssertionError('{}: solution {}\'s copy number is not the '
                                 'fit\'s'.format(label, init_id))
    return best


def same_table(a, b):
    """Two Tables or Series with equal columns, values and index."""
    if hasattr(a, 'columns'):
        return (a.columns == b.columns and np.array_equal(a.index, b.index)
                and all(np.array_equal(a[c], b[c]) for c in a.columns))
    return (np.array_equal(a.values, b.values)
            and np.array_equal(a.index, b.index))


def chosen_cn(run):
    """The chosen solution's (N, M, 2) copy number from the /cn table."""
    cn = run['tables']['cn']
    M = sum(1 for c in cn.columns if c.startswith('major_')
            and c[6:].isdigit())
    return np.stack([np.stack([cn['major_{}'.format(m)],
                               cn['minor_{}'.format(m)]], axis=1)
                     for m in range(M)], axis=1)


def phase_workflow(data):
    """The fit workflow at full width on the card, then the small-size
    float32 card / float64 CPU comparison. Returns the fb_grouped launches
    of both card runs."""
    import torch
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                        'chip_smoke', 'workflow')
    config = dict(num_em_iter=NUM_EM_ITER, num_update_iter=NUM_UPDATE_ITER)
    experiment_file, experiment_s = tsv_experiment(data, root)
    run = fit_workflow('phase 8', experiment_file, config, None, root)
    restarts = len(run['init_params'])
    waves = -(-restarts // WAVE)
    expected = waves * NUM_EM_ITER * NUM_UPDATE_ITER
    expect_launches('phase 8', run['launches'], 'fb_grouped', expected)
    best = check_results_tables('phase 8', run, config, data['x'].shape[0])
    depths = sorted({p['max_depth'] for p in run['init_params'].values()})
    log('phase 8: fit workflow, grid of {} restarts ({} modes) in {} waves '
        'of {}, max_depth {}, {} EM x {} VI; fb_grouped launches {}'.format(
            restarts, len({p['mode_idx'] for p in
                           run['init_params'].values()}),
            waves, WAVE, json.dumps(depths), NUM_EM_ITER, NUM_UPDATE_ITER,
            expected))
    times = run['times']
    log('phase 8: wall s: experiment {:.3f}, init {:.3f}, fit {:.3f} (waves '
        '{:.3f}, decode and results {:.3f}), collate {:.3f}, whole {:.3f}; '
        'per wave {}'.format(
            experiment_s, times['init'], times['fit'], sum(run['waves']),
            times['fit'] - sum(run['waves']), times['collate'],
            experiment_s + times['whole'],
            json.dumps([round(w, 3) for w in run['waves']])))
    log('phase 8: max_memory_allocated {:.3f} GB; chosen solution {}; '
        'ELBOs {:.6g} to {:.6g}'.format(
            torch.cuda.max_memory_allocated() / 1e9, best,
            float(np.min(run['tables']['stats']['elbo'])),
            float(np.max(run['tables']['stats']['elbo']))))
    check_rerun('phase 8', run)

    # the default grid's common max depth at max copy number 4 leaves 65 %
    # of this problem unmodellable, which init refuses (as the JAX
    # package's does): pin the depths to the truth, as tests/test_cli.py
    # does for its tiny problem, which makes a grid of one mode
    small = simulate(60, 4, 8, 2, seed=2)
    small_config = dict(config, max_copy_number=4,
                        h_normal=float(small['h'][0]),
                        h_tumour=float(small['h'][1:].sum()))
    runs, chosen, whole = {}, {}, {}
    for name, device, dtype in (('card f32', None, 'float32'),
                                ('CPU f64', 'cpu', 'float64')):
        experiment_file, experiment_s = tsv_experiment(small, root + '_small')
        runs[name] = fit_workflow(
            'phase 8 small ' + name, experiment_file,
            dict(small_config, engine_dtype=dtype), device, root + '_small')
        whole[name] = experiment_s + runs[name]['times']['whole']
        chosen[name] = check_results_tables('phase 8 small ' + name,
                                            runs[name], small_config, 60)
    card, cpu = runs['card f32'], runs['CPU f64']
    small_waves = -(-len(card['init_params']) // WAVE)
    expect_launches('phase 8 small card f32', card['launches'], 'fb_grouped',
                    small_waves * NUM_EM_ITER * NUM_UPDATE_ITER)
    if set(card['tables']) != set(cpu['tables']):
        raise AssertionError('phase 8 small: card and CPU results keys '
                             'differ')
    if card['init_params'] != cpu['init_params']:
        raise AssertionError('phase 8 small: card and CPU grids differ')
    share = float(np.all(chosen_cn(card) == chosen_cn(cpu),
                         axis=(1, 2)).mean())
    log('phase 8 small (N=60, max copy number 4): grid of {} restarts; '
        'chosen solution card {} / CPU {}; share of segments whose chosen '
        'cn is equal {:.4f}; card workflow whole {:.3f} s, CPU {:.3f} s'
        .format(len(card['init_params']), chosen['card f32'],
                chosen['CPU f64'], share, whole['card f32'],
                whole['CPU f64']))
    if share < SAME_CN_SHARE:
        raise AssertionError('phase 8 small: the card\'s chosen copy number '
                             'differs from the CPU\'s on more than {:.0%} of '
                             'the segments'.format(1 - SAME_CN_SHARE))
    return expected + small_waves * NUM_EM_ITER * NUM_UPDATE_ITER


def bench_row(sim_id):
    """Every metric of ``sim_id``'s rows in the accuracy benchmark's
    checked-in results (the JAX package's fit at the default config)."""
    from remixt_tpu_torch.benchmark.export_evaluation import rows_by_sim
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'benchmark', 'ACCURACY_BENCH.json')
    with open(path) as f:
        return rows_by_sim(json.load(f))[sim_id]


def evaluation_metrics(evaluation):
    """{metric: value} over the evaluation's series (the outlier
    evaluation where there is one)."""
    metrics = {}
    for name in ('cn_evaluation', 'brk_cn_evaluation', 'mix_results',
                 'outlier_evaluation'):
        if name in evaluation:
            metrics.update(evaluation[name].to_dict())
    return metrics


def sha256_prefix(values):
    data = np.ascontiguousarray(values, dtype=np.float64).tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


def check_simulation(experiment):
    """The simulation equals the JAX package's for the same definition."""
    found = dict(N=experiment.N, breakpoints=len(experiment.breakpoints),
                 h=[float(v) for v in experiment.h],
                 x=sha256_prefix(experiment.x), l=sha256_prefix(experiment.l))
    want = dict(N=ACCURACY_SIM['N'], breakpoints=ACCURACY_SIM['breakpoints'],
                h=list(ACCURACY_SIM['h']), x=ACCURACY_SIM['x'],
                l=ACCURACY_SIM['l'])
    # h is frac * h_total, a rounding away from the decimals
    same_h = np.allclose(found['h'], want['h'], rtol=1e-12, atol=0.0)
    if not same_h or dict(found, h=None) != dict(want, h=None):
        raise AssertionError('phase 9: the simulation is not the JAX '
                             'package\'s: {} against {}'.format(found, want))
    return found


def phase_accuracy():
    """The simulate → fit → evaluate path at full width and depth: the
    accuracy benchmark's first simulation, the fit workflow over init's
    grid at the default depth, the evaluation against the truth held to the
    benchmark's row, and one fit seeded from the truth. Returns the
    fb_grouped and fb_chains launches."""
    import networkx
    import torch
    from remixt_tpu_torch import config as config_mod
    from remixt_tpu_torch.analysis import pipeline
    from remixt_tpu_torch.benchmark.export_evaluation import ACCURACY_BARS
    from remixt_tpu_torch.simulations import pipeline as sim_pipeline

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, 'build', 'chip_smoke', 'accuracy')
    fresh_directory(root)
    sim_defs = sim_pipeline.create_simulations(
        os.path.join(here, 'benchmark', 'accuracy_sim_defs.yaml'), {}, None)
    params = sim_defs[ACCURACY_SIM['name']]
    experiment_file = os.path.join(root, 'experiment.pickle')
    times = {}
    t0 = time.time()
    sim_pipeline.simulate_experiment(experiment_file, None, params)
    times['simulate'] = time.time() - t0
    t0 = time.time()
    with open(experiment_file, 'rb') as f:
        experiment = pickle.load(f)
    times['experiment'] = time.time() - t0
    found = check_simulation(experiment)
    log('phase 9: {} simulated on the host, the JAX package\'s simulation: '
        '{}; {} chains; networkx {}'.format(
            ACCURACY_SIM['name'], json.dumps(found),
            len(list(experiment.chains)), networkx.__version__))

    config = {}
    num_em = config_mod.get_param(config, 'num_em_iter')
    num_vi = config_mod.get_param(config, 'num_update_iter')
    run = fit_workflow('phase 9', experiment_file, config, None, root)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    restarts = len(run['init_params'])
    if restarts != ACCURACY_SIM['restarts']:
        raise AssertionError('phase 9: init\'s grid has {} restarts, the '
                             'JAX package\'s {}'.format(
                                 restarts, ACCURACY_SIM['restarts']))
    waves = -(-restarts // WAVE)
    expected = waves * num_em * num_vi
    expect_launches('phase 9', run['launches'], 'fb_grouped', expected)
    best = check_results_tables('phase 9', run, config, experiment.N)
    check_rerun('phase 9', run)
    t0 = time.time()
    evaluation = sim_pipeline.evaluate_tables(experiment, run['tables'])
    times['evaluate'] = time.time() - t0

    stats = run['tables']['stats']
    log('phase 9: fit workflow at the defaults, {} EM x {} VI: grid of {} '
        'restarts in {} waves of {}, max_depth {}; fb_grouped launches {}; '
        'chosen solution {} with h {}; ELBOs {:.6g} to {:.6g}'.format(
            num_em, num_vi, restarts, waves, WAVE, json.dumps(sorted(
                {p['max_depth'] for p in run['init_params'].values()})),
            expected, best, np.array2string(run['fits'][best]['h'],
                                            precision=6),
            float(np.min(stats['elbo'])), float(np.max(stats['elbo']))))
    fit_s, waves_s = run['times']['fit'], sum(run['waves'])
    log('phase 9: wall s: simulate {:.3f}, experiment {:.3f}, init {:.3f}, '
        'fit {:.3f} (waves {:.3f}, decode and results {:.3f}), collate '
        '{:.3f}, evaluate {:.3f}; init to collate {:.3f}; per wave {}'.format(
            times['simulate'], times['experiment'], run['times']['init'],
            fit_s, waves_s, fit_s - waves_s, run['times']['collate'],
            times['evaluate'], run['times']['whole'],
            json.dumps([round(w, 3) for w in run['waves']])))
    log('phase 9: max_memory_allocated {:.3f} GB'.format(peak_gb))

    metrics, reference = evaluation_metrics(evaluation), bench_row(
        ACCURACY_SIM['name'])
    misses = []
    for name, value in metrics.items():
        bar = ACCURACY_BARS.get(name)
        line = '{:<36s} {:12.6f}  benchmark {:12.6f}'.format(
            name, value, reference[name])
        if bar is not None:
            ok = abs(value - reference[name]) <= bar
            line += '  bar ±{} {}'.format(bar, 'ok' if ok else 'MISS')
            if not ok:
                misses.append(name)
        log('phase 9: ' + line)
    if misses:
        raise AssertionError('phase 9: outside the benchmark\'s bars: '
                             '{}'.format(misses))

    # the restart whose h is nearest the truth (Euclidean), fitted once more
    # with its breakpoint posteriors seeded from the true breakpoint copy
    # number
    def distance(init_id):
        return float(np.linalg.norm(pipeline._restart_h_init(
            run['init_params'][init_id]) - experiment.h))
    nearest = min(run['init_params'], key=distance)
    reset_chain_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    fit = pipeline.fit(experiment, run['init_params'][nearest],
                       dict(config, optimal_initialization=True))
    torch.cuda.synchronize()
    optimal_s = time.time() - t0
    expect_launches('phase 9 optimal initialization', chain_launches(),
                    'fb_chains', num_em * num_vi)
    if not np.isfinite(fit['stats']['elbo']):
        raise AssertionError('phase 9: optimal initialization: non-finite '
                             'ELBO')
    tables = {}
    pipeline.store_fit_results(tables, experiment, fit, 'optimal')
    optimal = evaluation_metrics(sim_pipeline.evaluate_tables(
        experiment, tables, 'optimal'))
    log('phase 9: optimal initialization from restart {} (mode {}, h {}, '
        '{:.6f} from the truth): {} EM x {} VI through pipeline.fit in {:.3f} '
        's, fb_chains launches {}, ELBO {:.6g}, h {}'.format(
            nearest, run['init_params'][nearest]['mode_idx'],
            np.array2string(pipeline._restart_h_init(
                run['init_params'][nearest]), precision=6), distance(nearest),
            num_em, num_vi, optimal_s, num_em * num_vi, fit['stats']['elbo'],
            np.array2string(fit['h'], precision=6)))
    log('phase 9: optimal initialization evaluation ' + json.dumps(
        {k: round(v, 6) for k, v in optimal.items()}))
    return expected, num_em * num_vi


# ---------------------------------------------------------------------------
# phase 11: the run CLI from BAMs, on a synthetic reference and sample
# ---------------------------------------------------------------------------

# GRCh37 lengths of the three chromosomes of phase 11 (162.4 Mb in all)
RUN_CHROMOSOMES = {'20': 63025520, '21': 48129895, '22': 51304566}
# the 22 GRCh37 autosomes (2.88 Gb), for the whole-genome run
AUTOSOMES = {
    '1': 249250621, '2': 243199373, '3': 198022430, '4': 191154276,
    '5': 180915260, '6': 171115067, '7': 159138663, '8': 146364022,
    '9': 141213431, '10': 135534747, '11': 135006516, '12': 133851895,
    '13': 115169878, '14': 107349540, '15': 102531392, '16': 90354753,
    '17': 81195210, '18': 78077248, '19': 59128983, '20': 63025520,
    '21': 48129895, '22': 51304566}
RUN_SEED = 20
# read depth (bases of read per base of genome) of each sample
RUN_DEPTH = {'tumour': 2.0, 'normal': 1.0}
READ_LENGTH = 100
FRAGMENT_MEAN, FRAGMENT_SD = 300.0, 30.0
SNP_SPACING = 1000
# the global numpy seed set before the run, which sample_gc draws from
RUN_NUMPY_SEED = 2024
# the stand-in phasing: every SWITCH_EVERY-th het site of a chromosome is
# one where a drawn phasing switches with probability SWITCH_RATE, so the
# consensus breaks its blocks there
SWITCH_EVERY, SWITCH_RATE = 200, 0.3

# what the JAX package makes of phase 11's inputs on the CPU
# (``python tests/test_torch_run.py --phase11 WORKDIR``): the digest of its
# count table (``count_table_digest``), its restart grid's size, the
# restart its fit (5 EM x 5 VI, float32) chose, every restart's ELBO and
# proportion divergent by init_id, the evaluation against the truth of the
# solution it chose, and its refits of the restarts near that one, in
# float64 and in float32 from inputs moved by one ulp (``float64``,
# ``perturbed``: ``jax_near_references`` of that file; ``--near`` makes
# them alone)
RUN_JAX = {'counts': {'rows': 551,
                      'columns': ['chromosome', 'start', 'end', 'readcount',
                                  'allele_b_readcount', 'allele_a_readcount',
                                  'major_readcount', 'minor_readcount',
                                  'major_is_allele_a', 'bias', 'length'],
                      'ints': {'chromosome': '3e316fd309216215',
                               'start': 'bebdc95662a32ae9',
                               'end': '67f47485e7eea11c',
                               'allele_b_readcount': '157ae8137f330e47',
                               'allele_a_readcount': '3de894e2452074fe',
                               'major_readcount': '3de894e2452074fe',
                               'minor_readcount': '157ae8137f330e47',
                               'major_is_allele_a': 'e4dec168a8a19b23'},
                      'floats': {'readcount': [1558638.0, 441475513.0],
                                 'bias': [0.9999999999999734, 272.8879090214796],
                                 'length': [161175535.0, 43982854731.56945]}},
           'restarts': 60,
           'segments': 551,
           'chosen': 2,
           'elbo': {0: -4022.5205078125, 1: -3921.84765625,
                    2: -3908.82958984375, 3: -4051.346435546875,
                    4: -3958.365478515625, 5: -3919.93994140625,
                    6: -4037.7158203125, 7: -3883.103271484375,
                    8: -3885.6591796875, 9: -4047.390380859375,
                    10: -3913.6337890625, 11: -3874.62841796875,
                    12: -4224.4404296875, 13: -4101.29443359375,
                    14: -4081.48388671875, 15: -4219.19873046875,
                    16: -4076.74560546875, 17: -4043.95263671875,
                    18: -4213.74462890625, 19: -4166.9931640625,
                    20: -4169.03662109375, 21: -4268.8076171875,
                    22: -4201.29150390625, 23: -4186.8349609375,
                    24: -4315.67578125, 25: -4256.87890625,
                    26: -4204.01904296875, 27: -4241.17578125,
                    28: -4112.82763671875, 29: -4102.00634765625,
                    30: -4307.720703125, 31: -4181.2470703125,
                    32: -4180.0341796875, 33: -4300.77099609375,
                    34: -4206.03271484375, 35: -4193.7529296875,
                    36: -4546.888671875, 37: -4522.22216796875,
                    38: -4483.82763671875, 39: -4584.10546875,
                    40: -4397.18408203125, 41: -4368.55126953125,
                    42: -4578.40625, 43: -4385.21875, 44: -4385.203125,
                    45: -4593.4404296875, 46: -4438.88427734375,
                    47: -4408.29541015625, 48: -4186.14501953125,
                    49: -4025.021240234375, 50: -4022.979248046875,
                    51: -4149.11181640625, 52: -3995.52587890625,
                    53: -3986.565185546875, 54: -4195.8359375,
                    55: -4034.107177734375, 56: -4008.076904296875,
                    57: -4170.6640625, 58: -4039.1845703125,
                    59: -4045.192626953125},
           'proportion_divergent': {0: 0.21547449440603794,
                                    1: 0.3903233702405111,
                                    2: 0.46595984952415087,
                                    3: 0.3158173102242745,
                                    4: 0.5216772015343972,
                                    5: 0.5494512709497514,
                                    6: 0.32251381574659205,
                                    7: 0.5230905059288002,
                                    8: 0.5504694252857247,
                                    9: 0.29090955942229957,
                                    10: 0.4785251348541303,
                                    11: 0.5777946641081926,
                                    12: 0.315056212273839,
                                    13: 0.4481835894758033,
                                    14: 0.484386701144431,
                                    15: 0.38324995381758525,
                                    16: 0.5228451961113763,
                                    17: 0.5257376775055065,
                                    18: 0.398982538259623,
                                    19: 0.5597489154730924,
                                    20: 0.543253068779577,
                                    21: 0.4061541557866813,
                                    22: 0.565018099353326,
                                    23: 0.5787205651353491,
                                    24: 0.2826559897230892,
                                    25: 0.33974938687167827,
                                    26: 0.3399415448181657,
                                    27: 0.32327509824650635,
                                    28: 0.47382984944305817,
                                    29: 0.5081505689306579,
                                    30: 0.4014752833105983,
                                    31: 0.5128607771868359,
                                    32: 0.5304013727247072,
                                    33: 0.3776424903943041,
                                    34: 0.5367943110857256,
                                    35: 0.5713674090763436,
                                    36: 0.4380079123412152,
                                    37: 0.5336149662925497,
                                    38: 0.5441635940368984,
                                    39: 0.5037836639741416,
                                    40: 0.6417645901402552,
                                    41: 0.636735528149879,
                                    42: 0.5200466616652103,
                                    43: 0.6462641117447101,
                                    44: 0.6536888091618432,
                                    45: 0.48627616858462963,
                                    46: 0.5600895045096831,
                                    47: 0.5902599972354495,
                                    48: 0.29492120495355595,
                                    49: 0.5404719329329029,
                                    50: 0.5903469893517032,
                                    51: 0.3359216720838619,
                                    52: 0.6107697642791847,
                                    53: 0.6253528722428158,
                                    54: 0.346326653187371,
                                    55: 0.6257146940459903,
                                    56: 0.6535367047638682,
                                    57: 0.39835662698064533,
                                    58: 0.6500240222267872,
                                    59: 0.6797799144746048},
           'evaluation': {'proportion_cn_correct': 0.0,
                          'proportion_dom_cn_correct': 0.0,
                          'proportion_clonal_correct': 0.5634057861200833,
                          'proportion_subclonal_correct': 0.5634057861200833,
                          'pred_ploidy': 4.708467780175199,
                          'pred_ploidy_1': 4.860935898242869,
                          'pred_ploidy_2': 4.555999662107528,
                          'pred_proportion_divergent': 0.41875256378084924,
                          'true_ploidy': 2.555011239764149,
                          'true_ploidy_1': 2.5901589841162926,
                          'true_ploidy_2': 2.519863495412005,
                          'true_proportion_divergent': 0.29931625168795,
                          'brk_cn_correct_proportion': 0.3488372093023256,
                          'brk_cn_present_num_true': 97.0,
                          'brk_cn_present_num_pos': 148.0,
                          'brk_cn_present_num_true_pos': 86.0,
                          'brk_cn_subclonal_num_true': 75.0,
                          'brk_cn_subclonal_num_pos': 12.0,
                          'brk_cn_subclonal_num_true_pos': 2.0,
                          'mix_true_0': 0.4,
                          'mix_true_1': 0.4,
                          'mix_true_2': 0.19999999999999996,
                          'mix_pred_0': 0.5257605910301208,
                          'mix_pred_1': 0.2821291983127594,
                          'mix_pred_2': 0.19211022555828094},
           'float64': {'chosen': 2,
                       'elbo': {2: -3908.707464435314, 7: -3878.7371759162043,
                                8: -3887.071117850756, 10: -3915.0173702291654,
                                11: -3882.587071414043},
                       'proportion_divergent': {2: 0.46595348770987866,
                                                7: 0.5131491841885649,
                                                8: 0.5457213664341275,
                                                10: 0.46433539075906904,
                                                11: 0.5827625579627793},
                       'evaluation': {'proportion_cn_correct': 0.0,
                                      'proportion_dom_cn_correct': 0.0,
                                      'proportion_clonal_correct': 0.5634196653977293,
                                      'proportion_subclonal_correct': 0.5634196653977293,
                                      'pred_ploidy': 4.708475023830385,
                                      'pred_ploidy_1': 4.860950385553242,
                                      'pred_ploidy_2': 4.555999662107528,
                                      'pred_proportion_divergent': 0.41874562414202626,
                                      'true_ploidy': 2.555011239764149,
                                      'true_ploidy_1': 2.5901589841162926,
                                      'true_ploidy_2': 2.519863495412005,
                                      'true_proportion_divergent': 0.29931625168795,
                                      'brk_cn_correct_proportion': 0.34418604651162793,
                                      'brk_cn_present_num_true': 97.0,
                                      'brk_cn_present_num_pos': 149.0,
                                      'brk_cn_present_num_true_pos': 86.0,
                                      'brk_cn_subclonal_num_true': 75.0,
                                      'brk_cn_subclonal_num_pos': 12.0,
                                      'brk_cn_subclonal_num_true_pos': 2.0,
                                      'mix_true_0': 0.4,
                                      'mix_true_1': 0.4,
                                      'mix_true_2': 0.19999999999999996,
                                      'mix_pred_0': 0.5300488280715518,
                                      'mix_pred_1': 0.2791233400065709,
                                      'mix_pred_2': 0.19082783192187722}},
           'perturbed': {'chosen': {1: 10, 2: 10, 3: 2, 4: 10, 5: 2, 6: 2,
                                    7: 2, 8: 2},
                         'elbo': {1: {2: -3908.34765625, 7: -3883.419189453125,
                                      8: -3885.66015625,
                                      10: -3907.787841796875,
                                      11: -3880.316162109375},
                                  2: {2: -3908.13818359375,
                                      7: -3878.30517578125, 8: -3885.658203125,
                                      10: -3904.696533203125,
                                      11: -3880.31640625},
                                  3: {2: -3909.10205078125,
                                      7: -3878.27490234375, 8: -3885.662109375,
                                      10: -3915.0361328125,
                                      11: -3880.3251953125},
                                  4: {2: -3908.92333984375,
                                      7: -3878.1494140625, 8: -3885.6845703125,
                                      10: -3907.2177734375,
                                      11: -3875.80029296875},
                                  5: {2: -3908.187255859375,
                                      7: -3877.501708984375, 8: -3885.66015625,
                                      10: -3913.6259765625,
                                      11: -3874.479736328125},
                                  6: {2: -3909.013671875, 7: -3878.2939453125,
                                      8: -3885.656005859375,
                                      10: -3913.99462890625,
                                      11: -3877.78076171875},
                                  7: {2: -3908.254150390625,
                                      7: -3878.322021484375, 8: -3885.66015625,
                                      10: -3913.62548828125,
                                      11: -3873.3427734375},
                                  8: {2: -3909.1416015625,
                                      7: -3878.34326171875,
                                      8: -3885.6552734375,
                                      10: -3910.164794921875,
                                      11: -3880.328369140625}},
                         'proportion_divergent': {1: {2: 0.45481915210484103,
                                                      7: 0.523090506503347,
                                                      8: 0.5504694259985461,
                                                      10: 0.47852513963743615,
                                                      11: 0.5753926601863654},
                                                  2: {2: 0.4548191523490648,
                                                      7: 0.5087720593943885,
                                                      8: 0.5504694267605122,
                                                      10: 0.45771831726391216,
                                                      11: 0.5753926596558403},
                                                  3: {2: 0.46595984861444256,
                                                      7: 0.5087720579861505,
                                                      8: 0.5504694249842311,
                                                      10: 0.46433539439201305,
                                                      11: 0.575392659007417},
                                                  4: {2: 0.46595984903072885,
                                                      7: 0.5087720582801696,
                                                      8: 0.550469425354492,
                                                      10: 0.4785251342594166,
                                                      11: 0.577794662671449},
                                                  5: {2: 0.4548191512304514,
                                                      7: 0.5087720589427943,
                                                      8: 0.5504694245322126,
                                                      10: 0.47852513577246614,
                                                      11: 0.5777946655069005},
                                                  6: {2: 0.4659598492382437,
                                                      7: 0.5087720562632986,
                                                      8: 0.5504694239245131,
                                                      10: 0.46193464642177495,
                                                      11: 0.5693005927437943},
                                                  7: {2: 0.4548191504667969,
                                                      7: 0.5087720580474062,
                                                      8: 0.55046942299858,
                                                      10: 0.4785251306973346,
                                                      11: 0.5816303513001753},
                                                  8: {2: 0.46595984726712253,
                                                      7: 0.5131491824909188,
                                                      8: 0.550469422499173,
                                                      10: 0.4785251301937902,
                                                      11: 0.575392655002399}},
                         'evaluation': {1: {'proportion_cn_correct': 0.0,
                                            'proportion_dom_cn_correct': 0.0,
                                            'brk_cn_correct_proportion': 0.26976744186046514,
                                            'mix_pred_0': 0.5095041990280151,
                                            'mix_pred_1': 0.43509119749069214,
                                            'mix_pred_2': 0.055404629558324814},
                                        2: {'proportion_cn_correct': 0.0,
                                            'proportion_dom_cn_correct': 0.0,
                                            'brk_cn_correct_proportion': 0.26976744186046514,
                                            'mix_pred_0': 0.5356796979904175,
                                            'mix_pred_1': 0.39841756224632263,
                                            'mix_pred_2': 0.06590273976325989},
                                        3: {'proportion_cn_correct': 0.0,
                                            'proportion_dom_cn_correct': 0.0,
                                            'brk_cn_correct_proportion': 0.3488372093023256,
                                            'mix_pred_0': 0.5268863439559937,
                                            'mix_pred_1': 0.280436635017395,
                                            'mix_pred_2': 0.19267703592777252},
                                        4: {'proportion_cn_correct': 0.0,
                                            'proportion_dom_cn_correct': 0.0,
                                            'brk_cn_correct_proportion': 0.26976744186046514,
                                            'mix_pred_0': 0.5100485682487488,
                                            'mix_pred_1': 0.43353724479675293,
                                            'mix_pred_2': 0.056414153426885605},
                                        5: {'proportion_cn_correct': 0.0,
                                            'proportion_dom_cn_correct': 0.0,
                                            'brk_cn_correct_proportion': 0.3488372093023256,
                                            'mix_pred_0': 0.5378163456916809,
                                            'mix_pred_1': 0.27732476592063904,
                                            'mix_pred_2': 0.18485890328884125},
                                        6: {'proportion_cn_correct': 0.0,
                                            'proportion_dom_cn_correct': 0.0,
                                            'brk_cn_correct_proportion': 0.3488372093023256,
                                            'mix_pred_0': 0.5273695588111877,
                                            'mix_pred_1': 0.28119802474975586,
                                            'mix_pred_2': 0.19143244624137878},
                                        7: {'proportion_cn_correct': 0.0,
                                            'proportion_dom_cn_correct': 0.0,
                                            'brk_cn_correct_proportion': 0.3488372093023256,
                                            'mix_pred_0': 0.5372313857078552,
                                            'mix_pred_1': 0.27748847007751465,
                                            'mix_pred_2': 0.18528014421463013},
                                        8: {'proportion_cn_correct': 0.0,
                                            'proportion_dom_cn_correct': 0.0,
                                            'brk_cn_correct_proportion': 0.3488372093023256,
                                            'mix_pred_0': 0.5293048620223999,
                                            'mix_pred_1': 0.28120675683021545,
                                            'mix_pred_2': 0.18948835134506226}}}}

STANDIN_TOOLS = ('bgzip', 'tabix', 'bcftools', 'shapeit4', 'bingraphsample',
                 'shapeit', 'wget', 'samtools', 'bwa')
# the file of a stand-in bin directory that logs every call, one line each
STANDIN_CALLS = 'calls.log'
STANDIN_SOURCE = r"""
# A stand-in for the external tools of the port: the phasing tools of the
# run path (bgzip, tabix, bcftools, shapeit4 and bingraphsample for GRCh38,
# shapeit for GRCh37), for a synthetic sample whose true phase the
# reference directory's truth file (TRUTH) holds, and the tools of the
# reference build (wget, samtools faidx, bwa index and mem, bcftools view
# and index). It implements only the calls that remixt_tpu_torch makes.
# Its "BCF" files are plain-text VCF and its shapeit graph a text file of
# its own; its phasings are the true phase with switches drawn at every
# SWITCH_EVERY-th het site with probability SWITCH_RATE. Its wget copies
# from the local directory MIRROR and never touches the network. Every call
# is logged to CALLS beside the tool.
import gzip
import os
import random
import shutil
import sys

SWITCH_EVERY, SWITCH_RATE = @SWITCH_EVERY@, @SWITCH_RATE@
TRUTH = '@TRUTH@'
MIRROR = @MIRROR@
CALLS = '@CALLS@'


def lines(path):
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as f:
        return f.read().splitlines()


def touch(path):
    open(path, 'w').close()


def records(path):
    return [line.split('\t') for line in lines(path)
            if line and not line.startswith('#')]


def option(args, name):
    return args[args.index(name) + 1]


def read_truth(path):
    truth = {}
    for line in lines(path):
        position, allele1 = line.split('\t')[:2]
        truth[position] = allele1
    return truth


def shapeit_graph(args):
    # -M map -R haplotypes legend sample -G gen sample --output-graph graph
    # [--chrX] --no-mcmc -L log --seed s: the inputs must exist, as shapeit
    # needs them; the graph holds each .gen row with the genotype called,
    # the true first allele of a het row and whether a switch may fall there
    inputs = [option(args, '-M')]
    inputs += args[args.index('-R') + 1:args.index('-R') + 4]
    inputs += args[args.index('-G') + 1:args.index('-G') + 3]
    missing = [path for path in inputs if not os.path.exists(path)]
    if missing:
        sys.exit('shapeit stand-in: no such file {}'.format(missing))
    gen = [line.split(' ') for line in lines(option(args, '-G'))]
    if not gen:
        sys.exit('shapeit stand-in: no SNP in the .gen file')
    ref_dir = os.path.dirname(os.path.dirname(option(args, '-R')))
    truth = read_truth(TRUTH.format(ref_dir=ref_dir, chromosome=gen[0][0]))
    with open(option(args, '--output-graph'), 'w') as f:
        het = 0
        for row in gen:
            genotype = row[5:8].index('1')
            weak = 0
            if genotype == 1:
                weak = int(het % SWITCH_EVERY == SWITCH_EVERY - 1)
                het += 1
            f.write(' '.join(row[:5] + [str(genotype),
                                        truth.get(row[2], '0'),
                                        str(weak)]) + '\n')
    with open(option(args, '-L'), 'w') as f:
        f.write('shapeit stand-in ' + ' '.join(args) + '\n')


def shapeit_convert(args):
    # -convert --input-graph graph --output-sample prefix --seed s -L log:
    # writes prefix.haps (chromosome id position a0 a1 allele1 allele2,
    # no header), prefix.sample and the log, as shapeit2 lays them out
    rng = random.Random(int(option(args, '--seed')))
    prefix = option(args, '--output-sample')
    flip, rows = 0, []
    for line in lines(option(args, '--input-graph')):
        chrom, name, pos, a0, a1, genotype, allele1, weak = line.split(' ')
        if genotype == '1':
            if weak == '1' and rng.random() < SWITCH_RATE:
                flip ^= 1
            h1 = int(allele1) ^ flip
            h2 = 1 - h1
        else:
            h1 = h2 = int(genotype) // 2
        rows.append(' '.join([chrom, name, pos, a0, a1, str(h1), str(h2)]))
    with open(prefix + '.haps', 'w') as f:
        f.writelines(row + '\n' for row in rows)
    with open(prefix + '.sample', 'w') as f:
        f.write('ID_1 ID_2 missing\n0 0 0\nUNR1 UNR1 0\n')
    with open(option(args, '-L'), 'w') as f:
        f.write('shapeit stand-in ' + ' '.join(args) + '\n')


def write_vcf(path, rows):
    with open(path, 'w') as f:
        f.write('##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t'
                'FILTER\tINFO\tFORMAT\tNORMAL\n')
        f.writelines('\t'.join(row) + '\n' for row in rows)


def wget(args):
    # url -c -O path: the mirror's file named as the URL's last path
    # component, its query dropped; wget's server-error code without one
    url = args[0]
    name = url.split('?', 1)[0].rstrip('/').rsplit('/', 1)[-1]
    source = os.path.join(MIRROR, name) if MIRROR else None
    if source is None or not os.path.isfile(source):
        sys.stderr.write('wget stand-in: no mirror file for {}\n'.format(url))
        sys.exit(8)
    shutil.copyfile(source, option(args, '-O'))


def faidx(path):
    # path.fai: per record name, bases, offset of the first base, bases
    # and bytes of its first line, as samtools writes them
    with open(path, 'rb') as f:
        data = f.read()
    rows, start = [], data.find(b'>')
    while start != -1:
        body = data.index(b'\n', start) + 1
        name = data[start + 1:body].split()[0].decode()
        following = data.find(b'\n>', body)
        end = len(data) if following == -1 else following + 1
        first = data.find(b'\n', body, end)
        line_bases = (end if first == -1 else first) - body
        length = end - body - data.count(b'\n', body, end)
        rows.append('{}\t{}\t{}\t{}\t{}\n'.format(
            name, length, body, line_bases, line_bases + 1))
        start = -1 if following == -1 else following + 1
    with open(path + '.fai', 'w') as f:
        f.writelines(rows)


def read_genome(path):
    # [(name, upper-case bases)] of a FASTA
    genome, name, parts = [], None, []
    with open(path, 'rb') as f:
        for line in f:
            line = line.strip()
            if line.startswith(b'>'):
                if name is not None:
                    genome.append((name, b''.join(parts).upper()))
                name, parts = line[1:].split()[0].decode(), []
            elif line:
                parts.append(line)
    if name is not None:
        genome.append((name, b''.join(parts).upper()))
    return genome


def bwa_mem(genome_path, kmers_path):
    # SAM of k-mers (a FASTA of chromosome:start names) on the forward
    # strand: a k-mer that occurs once in the genome at its origin, MAPQ 60;
    # one that occurs more than once at its first occurrence, MAPQ 0; one
    # that does not occur unmapped
    kmers = lines(kmers_path)
    names, seqs = kmers[0::2], [seq.encode() for seq in kmers[1::2]]
    genome = read_genome(genome_path)
    out = ['@HD\tVN:1.6\n'] + ['@SQ\tSN:{}\tLN:{}\n'.format(n, len(g))
                                for n, g in genome]
    out.append('@PG\tID:bwa\tPN:bwa\tCL:bwa mem -M {} {}\n'.format(
        genome_path, kmers_path))
    k = len(seqs[0]) if seqs else 0
    first, repeated, places = {}, set(), []
    for name, bases in genome if seqs else ():
        offset = len(places)
        places += [(name, pos) for pos in range(len(bases) - k + 1)]
        for pos in range(len(bases) - k + 1):
            window = bases[pos:pos + k]
            if first.setdefault(window, offset + pos) != offset + pos:
                repeated.add(window)
    for name, seq in zip(names, seqs):
        if seq in first:
            chrom, pos = places[first[seq]]
            out.append('{}\t0\t{}\t{}\t{}\t{}M\t*\t0\t0\t{}\t*\n'.format(
                name[1:], chrom, pos + 1, 0 if seq in repeated else 60, k,
                seq.decode()))
        else:
            out.append('{}\t4\t*\t0\t0\t*\t*\t0\t0\t{}\t*\n'.format(
                name[1:], seq.decode()))
    sys.stdout.write(''.join(out))


def main(tool, args):
    with open(CALLS, 'a') as f:
        f.write(' '.join([tool] + args) + '\n')
    if tool == 'wget':
        wget(args)
    elif tool == 'samtools' and args[0] == 'faidx':
        faidx(args[1])
    elif tool == 'bwa' and args[0] == 'index':
        for extension in ('amb', 'ann', 'bwt', 'pac', 'sa'):
            touch(args[-1] + '.' + extension)
    elif tool == 'bwa' and args[0] == 'mem':
        bwa_mem(args[-2], args[-1])
    elif tool == 'bgzip':
        path = args[-1]
        with open(path, 'rb') as src, gzip.open(path + '.gz', 'wb') as dst:
            dst.write(src.read())
        os.remove(path)
    elif tool == 'tabix':
        touch(args[-1] + '.tbi')
    elif tool == 'bcftools' and args[0] == 'index':
        touch(args[-1] + '.csi')
    elif tool == 'bcftools' and args[0] == 'view' and '-H' in args:
        sys.stdout.write(''.join('\t'.join(row) + '\n'
                                 for row in records(args[-1])))
    elif tool == 'bcftools' and args[0] == 'view':
        source = [a for i, a in enumerate(args[1:], 1)
                  if not a.startswith('-') and args[i - 1] not in ('-O', '-o')]
        write_vcf(option(args, '-o'), records(source[0]))
    elif tool == 'shapeit4':
        truth = read_truth(option(args, '--reference'))
        with open(option(args, '--bingraph'), 'w') as f:
            for i, row in enumerate(records(option(args, '--input'))):
                weak = int(i % SWITCH_EVERY == SWITCH_EVERY - 1)
                f.write('\t'.join(row[:5] + [truth.get(row[1], '0'),
                                             str(weak)]) + '\n')
    elif tool == 'bingraphsample':
        rng = random.Random(int(option(args, '--seed')))
        flip, rows = 0, []
        for line in lines(option(args, '--input')):
            chrom, pos, name, ref, alt, allele1, weak = line.split('\t')
            if weak == '1' and rng.random() < SWITCH_RATE:
                flip ^= 1
            a1 = int(allele1) ^ flip
            rows.append([chrom, pos, name, ref, alt, '.', '.', '.', 'GT',
                         '{}|{}'.format(a1, 1 - a1)])
        write_vcf(option(args, '--output'), rows)
    elif tool == 'shapeit' and args[0] == '-convert':
        shapeit_convert(args)
    elif tool == 'shapeit' and '--output-graph' in args:
        shapeit_graph(args)
    else:
        sys.exit('stand-in {}: unsupported call {}'.format(tool, args))


main(os.path.basename(sys.argv[0]), sys.argv[1:])
"""


# the external callers of the benchmarks' tool comparison (TITAN through
# Rscript, THetA2's binary and octave's BAF model, filterHD and cloneHD),
# whose stand-ins ``write_standin_tools`` writes beside the others
CALLER_STANDIN_TOOLS = ('Rscript', 'RunTHetA', 'octave', 'filterHD',
                        'cloneHD')
# TITAN's run script, which only the Rscript stand-in reads
TITAN_RUN_SCRIPT = 'titan_run.R'
CALLER_STANDIN_SOURCE = r"""
# A stand-in for the external callers of the benchmarks' tool comparison:
# TITAN's Rscript (given a TitanCNA run script), THetA2's binary, octave's
# runBAFGaussianModel, filterHD and cloneHD. It implements only the calls
# that the wrappers make: it checks that the files it is handed exist and
# have the tool's columns, exits non-zero otherwise, and writes the tool's
# outputs in the tool's format, computed deterministically from those
# files (per chromosome in sorted order, so that the order of the input
# rows' chromosomes does not matter). Every call is logged to CALLS.
import os
import re
import sys

import numpy as np

CALLS = '@CALLS@'
# bins of a segment of the TITAN and cloneHD stand-ins, het SNPs of a
# cloneHD BAF segment, the least bins or SNPs between two cloneHD breaks
SEGMENT_BINS, SEGMENT_SNPS, MIN_BREAK = 500, 200, 50
TOOL = os.path.basename(sys.argv[0])


def fail(message):
    sys.stderr.write('{} stand-in: {}\n'.format(TOOL, message))
    sys.exit(2)


def option(args, name):
    if name not in args:
        fail('no {} in {}'.format(name, args))
    return args[args.index(name) + 1]


def rows(path, columns, header=False):
    # the fields of a table's lines, each line with ``columns`` fields
    if not os.path.isfile(path):
        fail('no such file {}'.format(path))
    with open(path) as f:
        lines = [line.split() for line in f if line.strip()]
    if header:
        lines = lines[1:]
    for i, fields in enumerate(lines):
        if len(fields) != columns:
            fail('{}: line {} has {} fields, not {}'.format(
                path, i + 1, len(fields), columns))
    return lines


def by_chromosome(lines, columns):
    # {chromosome: int64 array of the named columns}, chromosomes sorted
    grouped = {}
    for fields in lines:
        grouped.setdefault(fields[0], []).append(
            [int(fields[c]) for c in columns])
    return {c: np.array(grouped[c], dtype=np.int64).reshape(-1, len(columns))
            for c in sorted(grouped)}


def read_wig(path):
    # (step, {chromosome: counts}) of a fixed-step WIG track
    if not os.path.isfile(path):
        fail('no such file {}'.format(path))
    tracks, chromosome, step = {}, None, None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith('fixedStep'):
                fields = dict(field.split('=', 1)
                              for field in line.split()[1:])
                if sorted(fields) != ['chrom', 'span', 'start', 'step']:
                    fail('{}: bad header {!r}'.format(path, line))
                chromosome, step = fields['chrom'], int(fields['step'])
                tracks[chromosome] = []
            elif line:
                if chromosome is None or not line.isdigit():
                    fail('{}: bad line {!r}'.format(path, line))
                tracks[chromosome].append(int(line))
    return step, {c: np.array(tracks[c], dtype=np.int64)
                  for c in sorted(tracks)}


def ratio(part, whole, ref_part, ref_whole):
    # (part / whole) / (ref_part / ref_whole), from integers
    if not ref_part or not whole:
        return 1.0
    return (part * ref_whole) / (ref_part * whole)


def titan(args):
    # script alleles tumour.wig normal.wig clusters ploidy normal_init
    # cn.tsv params.txt
    if len(args) != 9:
        fail('{} arguments, not 9'.format(len(args)))
    script, alleles, tumour_wig, normal_wig = args[:4]
    clusters, ploidy, normal_init = int(args[4]), float(args[5]), float(
        args[6])
    if not os.path.isfile(script):
        fail('no run script {}'.format(script))
    het = by_chromosome(rows(alleles, 6), (1, 3, 5))
    step, tumour = read_wig(tumour_wig)
    normal_step, normal = read_wig(normal_wig)
    if step != normal_step or list(tumour) != list(normal) or any(
            len(tumour[c]) != len(normal[c]) for c in tumour):
        fail('the tumour and normal tracks differ in their bins')
    T = sum(int(t.sum()) for t in tumour.values())
    N = sum(int(n.sum()) for n in normal.values())
    minor_all = sum(int(np.minimum(h[:, 1], h[:, 2]).sum())
                    for h in het.values())
    reads_all = sum(int(h[:, 1:].sum()) for h in het.values())
    segments, residuals = [], []
    for chromosome in tumour:
        t, n = tumour[chromosome], normal[chromosome]
        h = het.get(chromosome, np.zeros((0, 3), dtype=np.int64))
        for b0 in range(0, len(t), SEGMENT_BINS):
            b1 = min(b0 + SEGMENT_BINS, len(t))
            level = ploidy * ratio(int(t[b0:b1].sum()), T,
                                   int(n[b0:b1].sum()), N)
            total = int(min(max(round(level), 0), 8))
            inside = (h[:, 0] >= b0 * step) & (h[:, 0] < b1 * step)
            reads = int(h[inside, 1:].sum())
            baf = (int(np.minimum(h[inside, 1], h[inside, 2]).sum()) / reads
                   if reads else 0.5)
            minor = min(int(round(total * baf)), total // 2)
            k = len(segments)
            cluster = ('' if k % 4 == 3 else
                       '2' if clusters == 2 and k % 4 == 1 else '1')
            segments.append((chromosome, b0 * step + 1, b1 * step, total,
                             total - minor, minor, cluster))
            residuals.append(abs(level - total))
    with open(args[7], 'w') as f:
        f.write('Chromosome\tStart_Position(bp)\tEnd_Position(bp)\t'
                'Copy_Number\tMajorCN\tMinorCN\tClonal_Cluster\n')
        f.writelines('\t'.join(map(str, row)) + '\n' for row in segments)
    normal_est = min(max(normal_init * 2 * N / (N + T), 0.05), 0.95)
    prevalence = min(0.5 + (minor_all / reads_all if reads_all else 0.25),
                     0.99)
    prevalences = [prevalence, prevalence * (0.35 + 0.05 * ploidy)]
    sdbw = (sum(residuals) / max(len(residuals), 1) + 0.1 / clusters
            + 0.01 * ploidy)
    with open(args[8], 'w') as f:
        f.write('Normal contamination estimate: {:.6f}\n'.format(normal_est))
        f.write('Average tumour ploidy estimate: {:.6f}\n'.format(
            ploidy * T / max(N, 1)))
        f.write('Clonal cluster cellular prevalence Z={}: {}\n'.format(
            clusters, ' '.join('{:.6f}'.format(p)
                               for p in prevalences[:clusters])))
        f.write('S_Dbw validity index: {:.6f}\n'.format(sdbw))


def theta_counts(path):
    # (chromosome index, tumour, normal, upper bound) columns of THetA's
    # interval counts
    table = np.array([[int(v) for v in fields]
                      for fields in rows(path, 8)], dtype=np.int64)
    return table.reshape(-1, 8)[:, [1, 4, 5, 6]]


def theta(args):
    # counts --FORCE --NUM_INTERVALS n --OUTPUT_PREFIX prefix: n2 and n3
    # results, the n3 file with three candidate solutions of two clones
    counts = theta_counts(args[0])
    if '--FORCE' not in args or int(option(args, '--NUM_INTERVALS')) < 1:
        fail('unexpected arguments {}'.format(args))
    prefix = option(args, '--OUTPUT_PREFIX')
    T, N = int(counts[:, 1].sum()), int(counts[:, 2].sum())
    level = np.array([2 * ratio(int(t), T, int(n), N)
                      for t, n in counts[:, 1:3]])
    clone_1 = np.minimum(np.maximum(np.round(level), 0),
                         counts[:, 3]).astype(int)
    header = '#NLL\tmu\tC\tp*\n'
    with open(prefix + '.n2.results', 'w') as f:
        nll = float(((level - clone_1) ** 2).sum())
        f.write(header + '{:.6f}\t{:.6f},{:.6f}\t{}\t-\n'.format(
            nll, N / (N + T), T / (N + T), ':'.join(map(str, clone_1))))
    lines = []
    for r in range(3):
        mu_n = min(max(N / (N + T) + 0.1 * (r - 1), 0.05), 0.9)
        clone_2 = np.where((np.arange(len(clone_1)) + r) % 3 == 0, 2,
                           clone_1)
        nll = float(((level - 0.6 * clone_1 - 0.4 * clone_2) ** 2).sum()
                    * 100 + 0.5 * r)
        lines.append('{:.6f}\t{:.6f},{:.6f},{:.6f}\t{}\t-\n'.format(
            nll, mu_n, (1 - mu_n) * 0.6, (1 - mu_n) * 0.4,
            ':'.join('{},{}'.format(a, b) for a, b in zip(clone_1, clone_2))))
    with open(prefix + '.n3.results', 'w') as f:
        f.write(header + ''.join(lines))


def minor_fraction(table):
    # the share of minor-allele reads of THetA allele rows
    ref, alt = table[:, 7], table[:, 8]
    total = int((ref + alt).sum())
    return int(np.minimum(ref, alt).sum()) / total if total else 0.5


def octave(args):
    # --eval "cd DIR; runBAFGaussianModel(tumour, normal, counts, results,
    # [chromosomes], prefix, [11,8], 'none')": prefix.BAF.NLL.results, the
    # results' rows with a BAF_NLL column
    match = re.fullmatch(r"cd (\S+); runBAFGaussianModel\((.*)\)",
                         args[1] if len(args) == 2 else '')
    if args[:1] != ['--eval'] or match is None:
        fail('unexpected arguments {}'.format(args))
    if not os.path.isdir(match.group(1)):
        fail('no directory {}'.format(match.group(1)))
    tokens = match.group(2).split(', ')
    if len(tokens) != 8 or tokens[6:] != ['[11,8]', "'none'"]:
        fail('unexpected model arguments {}'.format(tokens))
    tumour, normal, counts, results = [t.strip("'") for t in tokens[:4]]
    fractions = []
    for path in (tumour, normal):
        table = np.array([[int(v) for v in fields]
                          for fields in rows(path, 9)], dtype=np.int64)
        fractions.append(minor_fraction(table.reshape(-1, 9)))
    chromosomes = sorted(set(theta_counts(counts)[:, 0].tolist()))
    if tokens[4] != '[' + ','.join(map(str, chromosomes)) + ']':
        fail('chromosomes {} are not those of {}'.format(tokens[4], counts))
    solutions = rows(results, 4, header=True)
    with open(tokens[5].strip("'") + '.BAF.NLL.results', 'w') as f:
        f.write('#NLL\tmu\tC\tp*\tBAF_NLL\n')
        for nll, mu, copies, p in solutions:
            mu_n = float(mu.split(',')[0])
            baf_nll = 1000 * abs(fractions[0] - fractions[1] * (
                mu_n + (1 - mu_n) * 0.8)) + 0.01 * copies.count(':')
            f.write('\t'.join([nll, mu, copies, p,
                               '{:.6f}'.format(baf_nll)]) + '\n')


def smooth(values, window=25):
    kernel = np.ones(window)
    return (np.convolve(values, kernel, 'same')
            / np.convolve(np.ones(len(values)), kernel, 'same'))


def filterhd(args):
    # --data track --mode 3|1 --pre prefix [--bias posterior] [--jumps 1]
    # [--reflect 1]: prefix.posterior-1.txt (chromosome, locus, smoothed
    # value) and, with jumps, prefix.jumps.txt (chromosome, locus, jump
    # probability)
    data = by_chromosome(rows(option(args, '--data'), 4), (1, 2, 3))
    mode, prefix = option(args, '--mode'), option(args, '--pre')
    if mode not in ('1', '3') or option(args, '--rnd') != '0':
        fail('unexpected arguments {}'.format(args))
    bias = {}
    if '--bias' in args:
        for fields in rows(option(args, '--bias'), 3):
            bias[(fields[0], int(fields[1]))] = float(fields[2])
    posterior, jumps = [], []
    for chromosome, table in data.items():
        loci = table[:, 0]
        if mode == '3':
            values = table[:, 1].astype(float)
        else:
            values = table[:, 1] / np.maximum(table[:, 2], 1)
            if option(args, '--reflect') == '1':
                values = np.minimum(values, 1 - values)
        if bias:
            values = values / np.array([
                max(bias.get((chromosome, int(locus)), 1.0), 1e-3)
                for locus in loci])
        smoothed = smooth(values)
        step = np.abs(np.diff(smoothed, prepend=smoothed[:1]))
        jump = step > 0.2 * max(float(smoothed.mean()), 1e-9)
        posterior += ['{}\t{}\t{:.6g}\n'.format(chromosome, locus, value)
                      for locus, value in zip(loci, smoothed)]
        jumps += ['{}\t{}\t{}\n'.format(chromosome, locus, float(j))
                  for locus, j in zip(loci, jump)]
    with open(prefix + '.posterior-1.txt', 'w') as f:
        f.writelines(posterior)
    if '--jumps' in args and option(args, '--jumps') == '1':
        with open(prefix + '.jumps.txt', 'w') as f:
            f.writelines(jumps)


def breaks(loci, jump_loci, size):
    # segment starts: every ``size`` loci, and at a jump at least
    # MIN_BREAK loci past the last start
    starts = [0]
    for i in range(1, len(loci)):
        if i - starts[-1] >= size or (
                loci[i] in jump_loci and i - starts[-1] >= MIN_BREAK):
            starts.append(i)
    return starts + [len(loci)]


def posterior_line(chromosome, first, last, nloci, call, k, columns):
    # a posterior row peaked at ``call``: on every 7th segment a tie with
    # the next column (the first wins), on every 4th a NaN cell
    p = [0.02] * columns
    p[call] = 0.8
    if k % 7 == 5 and call + 1 < columns:
        p[call + 1] = 0.8
    if k % 4 == 2 and call != columns - 1:
        p[columns - 1] = float('nan')
    return '{} {} {} {} {}\n'.format(chromosome, first, last, nloci, ' '.join(
        'nan' if v != v else '{:.4f}'.format(v) for v in p))


def clonehd(args):
    # --cna --baf --pre --bias --cna-jumps --baf-jumps ... --max-tcn n:
    # prefix.summary.txt and each clone's CNA and BAF posteriors
    cna = by_chromosome(rows(option(args, '--cna'), 4), (1, 2))
    baf = by_chromosome(rows(option(args, '--baf'), 4), (1, 2, 3))
    bias = {}
    for fields in rows(option(args, '--bias'), 3):
        bias[(fields[0], int(fields[1]))] = float(fields[2])
    jump_loci = []
    for name in ('--cna-jumps', '--baf-jumps'):
        found = {}
        for fields in rows(option(args, name), 3):
            if float(fields[2]) >= 0.5:
                found.setdefault(fields[0], set()).add(int(fields[1]))
        jump_loci.append(found)
    prefix, max_tcn = option(args, '--pre'), int(option(args, '--max-tcn'))
    columns = max_tcn + 1
    T = sum(int(t[:, 1].sum()) for t in cna.values())
    B = sum(bias.values())
    minor_all = sum(int(b[:, 1].sum()) for b in baf.values())
    reads_all = sum(int(b[:, 2].sum()) for b in baf.values())
    header = '#chr first-locus last-locus nloci {}\n'.format(
        ' '.join(map(str, range(columns))))
    clones = [dict(cna=[header], baf=[header]) for _ in range(2)]
    k = 0
    for chromosome, table in cna.items():
        loci, counts = table[:, 0], table[:, 1]
        starts = breaks(loci.tolist(), jump_loci[0].get(chromosome, ()),
                        SEGMENT_BINS)
        for a, b in zip(starts[:-1], starts[1:]):
            expected = sum(bias.get((chromosome, int(locus)), 0.0)
                           for locus in loci[a:b])
            level = 2 * ((int(counts[a:b].sum()) / T) / (expected / B)
                         if expected and T else 1.0)
            total = int(min(max(round(level), 0), max_tcn))
            for clone, call in ((0, total), (1, total if k % 3 else 2)):
                clones[clone]['cna'].append(posterior_line(
                    chromosome, loci[a], loci[b - 1], b - a, call, k,
                    columns))
            k += 1
    for chromosome, table in baf.items():
        loci = table[:, 0]
        starts = breaks(loci.tolist(), jump_loci[1].get(chromosome, ()),
                        SEGMENT_SNPS)
        for a, b in zip(starts[:-1], starts[1:]):
            reads = int(table[a:b, 2].sum())
            fraction = int(table[a:b, 1].sum()) / reads if reads else 0.5
            allele = (max_tcn if k % 5 == 2 else
                      int(min(max(round(4 * fraction), 0), max_tcn)))
            for clone, call in ((0, allele), (1, allele if k % 3 else 1)):
                clones[clone]['baf'].append(posterior_line(
                    chromosome, loci[a], loci[b - 1], b - a, call, k,
                    columns))
            k += 1
    for clone, tables in enumerate(clones, 1):
        for kind, lines in tables.items():
            with open('{}.{}.subclone-{}.txt'.format(prefix, kind, clone),
                      'w') as f:
                f.writelines(lines)
    fraction_all = minor_all / reads_all if reads_all else 0.25
    with open(prefix + '.summary.txt', 'w') as f:
        f.write('# 2 clones\n{:.6f} {:.6f} {:.6f}\n'.format(
            T / max(sum(len(t) for t in cna.values()), 1),
            0.3 + 0.3 * fraction_all, 0.15 + 0.1 * fraction_all))


def main(args):
    with open(CALLS, 'a') as f:
        f.write(' '.join([TOOL] + args) + '\n')
    {'Rscript': titan, 'RunTHetA': theta, 'octave': octave,
     'filterHD': filterhd, 'cloneHD': clonehd}[TOOL](args)


main(sys.argv[1:])
"""


def write_standin_tools(bin_dir, mirror_dir=None):
    """Executable stand-ins of ``STANDIN_TOOLS`` and of the external callers
    ``CALLER_STANDIN_TOOLS`` in ``bin_dir`` (for the front of PATH), with
    TITAN's run script ``TITAN_RUN_SCRIPT``, logging every call to
    ``bin_dir/STANDIN_CALLS``; their ``wget`` serves the files of
    ``mirror_dir`` (none without one). Returns ``bin_dir``."""
    os.makedirs(bin_dir, exist_ok=True)
    source = '#!{} -S\n'.format(sys.executable) + STANDIN_SOURCE.replace(
        '@SWITCH_EVERY@', str(SWITCH_EVERY)).replace(
            '@SWITCH_RATE@', str(SWITCH_RATE)).replace(
                '@TRUTH@', panel_truth_path('{ref_dir}', '{chromosome}')
    ).replace('@MIRROR@', repr(mirror_dir and os.path.abspath(mirror_dir))
              ).replace('@CALLS@', os.path.abspath(os.path.join(
                  bin_dir, STANDIN_CALLS)))
    calls = os.path.abspath(os.path.join(bin_dir, STANDIN_CALLS))
    callers = '#!{}\n'.format(sys.executable) + CALLER_STANDIN_SOURCE.replace(
        '@CALLS@', calls)
    for tools, text in ((STANDIN_TOOLS, source),
                        (CALLER_STANDIN_TOOLS, callers)):
        for tool in tools:
            path = os.path.join(bin_dir, tool)
            with open(path, 'w') as f:
                f.write(text)
            os.chmod(path, 0o755)
    with open(os.path.join(bin_dir, TITAN_RUN_SCRIPT), 'w') as f:
        f.write('# TitanCNA run script: the Rscript stand-in reads only '
                'its arguments\n')
    return bin_dir


def caller_config(bin_dir, segments_filename):
    """The config keys of the external callers for the stand-ins of
    ``bin_dir``, THetA on the segmentation ``segments_filename``."""
    bin_dir = os.path.abspath(bin_dir)
    return {
        'titan': {'run_script': os.path.join(bin_dir, TITAN_RUN_SCRIPT)},
        'theta': {'bin': os.path.join(bin_dir, 'RunTHetA'),
                  'octave_bin_directory': bin_dir,
                  'segments_filename': os.path.abspath(segments_filename)},
        'clonehd': {'filterhd_bin': os.path.join(bin_dir, 'filterHD'),
                    'clonehd_bin': os.path.join(bin_dir, 'cloneHD')},
    }


def write_window_segments(path, chromosome_lengths, window):
    """A segmentation of fixed windows of ``window`` bases over the
    chromosomes, the last of each cut at its end, as a TSV of chromosome,
    start and end (THetA's ``segments_filename``)."""
    with open(path, 'w') as f:
        f.write('chromosome\tstart\tend\n')
        for chromosome, length in chromosome_lengths.items():
            for start in range(0, length, window):
                f.write('{}\t{}\t{}\n'.format(
                    chromosome, start, min(start + window, length)))
    return path


BGZF_EOF = bytes([
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00])
BGZF_PAYLOAD = 65280
# BAM's 4-bit base codes ('=ACMGRSVTWYHKDBN') of the ASCII bases
BASE_CODE = np.full(256, 15, dtype=np.uint8)
for _code, _base in ((1, 'A'), (2, 'C'), (4, 'G'), (8, 'T')):
    BASE_CODE[ord(_base)] = BASE_CODE[ord(_base.lower())] = _code
BAM_RECORD = np.dtype([
    ('block_size', '<i4'), ('refid', '<i4'), ('pos', '<i4'),
    ('l_read_name', 'u1'), ('mapq', 'u1'), ('bin', '<u2'),
    ('n_cigar', '<u2'), ('flag', '<u2'), ('l_seq', '<i4'),
    ('next_refid', '<i4'), ('next_pos', '<i4'), ('tlen', '<i4'),
    ('name', 'u1', (11,)), ('cigar', '<u4'),
    ('seq', 'u1', (READ_LENGTH // 2,)), ('qual', 'u1', (READ_LENGTH,))])


def bgzf_block(payload):
    import struct
    import zlib
    compressor = zlib.compressobj(1, zlib.DEFLATED, -15)
    data = compressor.compress(payload) + compressor.flush()
    header = struct.pack('<BBBBIBBHBBHH', 0x1f, 0x8b, 8, 4, 0, 0, 0xff, 6,
                         66, 67, 2, len(data) + 25)
    footer = struct.pack('<II', zlib.crc32(payload) & 0xffffffff,
                         len(payload))
    return header + data + footer


def reg2bin(beg, end):
    """The BAM bin of [beg, end) (the specification's reg2bin)."""
    end = end - 1
    out = np.zeros(len(beg), dtype=np.int64)
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        same = (beg >> shift) == (end >> shift)
        out = np.where(same, base + (beg >> shift), out)
    return out.astype(np.uint16)


def bam_records(refid, pos1, length, mapq, names, seq1, seq2):
    """The two records (first mate forward at ``pos1``, second mate reverse
    at ``pos1 + length - READ_LENGTH``) of each fragment, sorted by
    position."""
    n = len(pos1)
    pos2 = pos1 + length - READ_LENGTH
    rec = np.zeros(2 * n, dtype=BAM_RECORD)
    rec['block_size'] = BAM_RECORD.itemsize - 4
    rec['refid'] = rec['next_refid'] = refid
    rec['pos'] = np.concatenate([pos1, pos2])
    rec['next_pos'] = np.concatenate([pos2, pos1])
    rec['tlen'] = np.concatenate([length, -length])
    rec['flag'] = np.repeat([0x1 | 0x2 | 0x20 | 0x40, 0x1 | 0x2 | 0x10 | 0x80],
                            n)
    rec['l_read_name'] = 11
    rec['mapq'] = np.tile(mapq, 2)
    rec['bin'] = reg2bin(rec['pos'].astype(np.int64),
                         rec['pos'].astype(np.int64) + READ_LENGTH)
    rec['n_cigar'] = 1
    rec['cigar'] = READ_LENGTH << 4
    rec['l_seq'] = READ_LENGTH
    rec['name'] = np.tile(names, (2, 1))
    codes = np.concatenate([seq1, seq2])
    rec['seq'] = (codes[:, 0::2] << 4) | codes[:, 1::2]
    rec['qual'] = 30
    return rec[np.argsort(rec['pos'], kind='stable')]


def fragment_names(first, n):
    """'f' and nine digits, NUL-terminated, for fragments first..first+n."""
    idx = np.arange(first, first + n, dtype=np.int64)
    digits = (idx[:, None] // 10 ** np.arange(8, -1, -1)) % 10 + ord('0')
    names = np.zeros((n, 11), dtype=np.uint8)
    names[:, 0] = ord('f')
    names[:, 1:10] = digits
    return names


def write_bam(path, chromosome_lengths, record_batches):
    """A BGZF BAM of the records (one array per reference, in its order)
    and its .bai: a linear index of one interval per reference, at the
    block its records start."""
    import struct
    from concurrent.futures import ThreadPoolExecutor
    header = b'BAM\x01' + struct.pack('<ii', 0, len(chromosome_lengths))
    for name, length in chromosome_lengths.items():
        header += struct.pack('<i', len(name) + 1) + name.encode() + b'\0' \
            + struct.pack('<i', length)
    offsets = []
    with open(path, 'wb') as bam, ThreadPoolExecutor(8) as pool:
        bam.write(bgzf_block(header))
        for records in record_batches:
            payload = records.tobytes()
            offsets.append(bam.tell() if len(payload) else 0)
            for block in pool.map(bgzf_block, [
                    payload[i:i + BGZF_PAYLOAD]
                    for i in range(0, len(payload), BGZF_PAYLOAD)]):
                bam.write(block)
        bam.write(BGZF_EOF)
    with open(path + '.bai', 'wb') as bai:
        bai.write(b'BAI\x01' + struct.pack('<I', len(offsets)))
        for offset in offsets:
            bai.write(struct.pack('<II', 0, 1) + struct.pack('<Q',
                                                             offset << 16))


def panel_truth_path(ref_dir, chromosome):
    """The file where the stand-in phasing tools read the sample's true
    phase on a chromosome, for either build: lines of position (1-based)
    and the alt flag of each haplotype. It lies under the name of the
    chromosome's GRCh38 panel file, which shapeit4's stand-in is given as
    the panel; shapeit's stand-in finds it in the reference directory, the
    parent of the impute2 panel's directory."""
    return os.path.join(ref_dir, '1kGP_high_coverage_Illumina.chr{}.'
                        'filtered.SNV_INDEL_SV_phased_panel.bcf'.format(
                            chromosome))


def write_reference(ref_dir, chromosome_lengths, rng, with_hdf5):
    """The synthetic reference of the run path: the FASTA (GC content
    varying by 100 kb block) with its .fai, the gzipped gap table (a
    telomere gap and two internal gaps a chromosome, N in the FASTA), the
    SNP panel (a SNP about every SNP_SPACING bases, no header, 1-based),
    the mappability store as a directory (and as the JAX package's HDF5
    store with ``with_hdf5``; unmappable stretches of 2-30 kb about every
    500 kb, and the gaps), and per chromosome the true germline genotype
    of every SNP. Returns {chromosome: (bases, mappable, snp positions
    (0-based), alt bases, genotype (n, 2) of alt on each haplotype)}."""
    import gzip
    os.makedirs(ref_dir, exist_ok=True)
    fasta = os.path.join(ref_dir, 'genome.fa')
    truth = {}
    gaps = []
    with open(fasta, 'wb') as fa, open(fasta + '.fai', 'w') as fai, \
            open(os.path.join(ref_dir, 'thousand_genomes_snps.tsv'),
                 'w') as snps:
        for chrom, length in chromosome_lengths.items():
            blocks = -(-length // 100000)
            gc = np.repeat(rng.uniform(0.35, 0.6, blocks), 100000)[:length]
            strong = rng.random_sample(length) < gc
            pick = rng.randint(0, 2, length).astype(bool)
            bases = np.where(strong, np.where(pick, ord('G'), ord('C')),
                             np.where(pick, ord('A'), ord('T'))).astype(
                                 np.uint8)
            mappable = np.ones(length, dtype=np.uint8)
            chrom_gaps = [(0, 10000)]
            for _ in range(2):
                start = int(rng.randint(length // 10, length - length // 10))
                chrom_gaps.append((start, start + int(rng.randint(50000,
                                                                  500000))))
            for start, end in chrom_gaps:
                bases[start:end] = ord('N')
                mappable[start:end] = 0
                gaps.append((chrom, start, end))
            for _ in range(length // 500000):
                start = int(rng.randint(0, length))
                mappable[start:start + int(rng.randint(2000, 30000))] = 0

            offset = fa.tell() + len(chrom) + 2
            fa.write('>{}\n'.format(chrom).encode())
            lines = -(-length // 60)
            padded = np.full(lines * 61, ord('\n'), dtype=np.uint8)
            grid = padded.reshape(lines, 61)
            body = np.zeros(lines * 60, dtype=np.uint8)
            body[:length] = bases
            grid[:, :60] = body.reshape(lines, 60)
            out = padded[:length + lines]
            out[-1] = ord('\n')
            fa.write(out.tobytes())
            fai.write('{}\t{}\t{}\t60\t61\n'.format(chrom, length, offset))

            positions = np.unique(rng.randint(0, length,
                                              length // SNP_SPACING))
            positions = positions[bases[positions] != ord('N')]
            ref = bases[positions]
            choices = np.array([ord(b) for b in 'ACGT'], dtype=np.uint8)
            alt = choices[(np.searchsorted(choices, ref)
                           + rng.randint(1, 4, len(ref))) % 4]
            kind = rng.choice(3, len(ref), p=[0.3, 0.5, 0.2])
            first = rng.randint(0, 2, len(ref))
            genotype = np.stack([np.where(kind == 1, first, kind // 2),
                                 np.where(kind == 1, 1 - first, kind // 2)],
                                axis=1)
            snps.writelines('{}\t{}\t{}\t{}\n'.format(chrom, p + 1, chr(r),
                                                      chr(a))
                            for p, r, a in zip(positions.tolist(),
                                               ref.tolist(), alt.tolist()))
            with open(panel_truth_path(ref_dir, chrom), 'w') as panel:
                panel.writelines('{}\t{}\t{}\n'.format(p + 1, g0, g1)
                                 for p, (g0, g1) in zip(
                                     positions.tolist(), genotype.tolist()))
            truth[chrom] = (bases, mappable, positions, alt, genotype)
    with gzip.open(os.path.join(ref_dir, 'gap.txt.gz'), 'wt') as f:
        for i, (chrom, start, end) in enumerate(gaps):
            f.write('{}\t{}\t{}\t{}\t{}\tN\t{}\tcontig\tno\n'.format(
                i, chrom, start, end, i + 1, end - start))
    write_mappability(os.path.join(ref_dir, 'mappability'),
                      {c: t[1] for c, t in truth.items()}, with_hdf5)
    return truth


def write_impute_panel(panel_dir, chromosome, positions, a0, a1,
                       num_haplotypes, rng):
    """A synthetic 1000 Genomes impute2 panel of one chromosome under the
    default names (``legend_template``, ``haplotypes_template`` and
    ``genetic_map_template`` with ``panel_dir`` as the panel directory): a
    gzipped legend (id position a0 a1), a gzipped ``.hap`` of
    ``num_haplotypes`` 0/1 columns drawn from ``rng`` at an alternate
    allele frequency per row uniform in [0.05, 0.5], and a genetic map at
    every 100th position at 1 cM/Mb."""
    import gzip
    os.makedirs(panel_dir, exist_ok=True)
    with open(os.path.join(panel_dir, 'genetic_map_chr{}_combined_b37.txt'
                           .format(chromosome)), 'w') as f:
        f.write('position COMBINED_rate(cM/Mb) Genetic_Map(cM)\n')
        f.writelines('{} 1.0 {!r}\n'.format(p, p / 1e6)
                     for p in positions[::100].tolist())
    stem = os.path.join(panel_dir, 'ALL_1000G_phase1integrated_v3_chr{}_'
                        'impute'.format(chromosome))
    with gzip.open(stem + '.legend.gz', 'wt', compresslevel=1) as f:
        f.write('id position a0 a1\n')
        f.writelines('snp{}_{} {} {} {}\n'.format(chromosome, p, p, r, a)
                     for p, r, a in zip(positions.tolist(), list(a0),
                                        list(a1)))
    frequency = rng.uniform(0.05, 0.5, len(positions))
    grid = np.full((len(positions), 2 * num_haplotypes), ord(' '),
                   dtype=np.uint8)
    grid[:, 0::2] = ord('0') + (rng.random_sample(
        (len(positions), num_haplotypes)) < frequency[:, None])
    grid[:, -1] = ord('\n')
    with gzip.open(stem + '.hap.gz', 'wb', compresslevel=1) as f:
        f.write(grid.tobytes())


def write_panel_sample(panel_dir, num_haplotypes):
    """The impute2 panel's sample file under the default name
    (``sample_template``): one individual for every two haplotypes."""
    with open(os.path.join(panel_dir, 'ALL_1000G_phase1integrated_v3.sample'),
              'w') as f:
        f.write('ID POP GROUP SEX\n')
        f.writelines('SIM{} SIM SIM {}\n'.format(i, 1 + i % 2)
                     for i in range(num_haplotypes // 2))


def write_mappability(stem, mappable, with_hdf5):
    """The mappability store of per-chromosome 0/1 arrays: mappable runs at
    quality 60, unmappable ones at 0; a directory of .npy files at
    ``stem``, and the JAX package's HDF5 store at ``stem.h5`` with
    ``with_hdf5``."""
    tables = {}
    for chrom, flags in mappable.items():
        change = np.flatnonzero(np.diff(flags.astype(np.int8))) + 1
        start = np.concatenate([[0], change]).astype(np.int64)
        end = np.concatenate([change, [len(flags)]]).astype(np.int64)
        quality = np.where(flags[start] > 0, 60, 0).astype(np.int64)
        tables[chrom] = (start, end, quality)
        path = os.path.join(stem, 'chromosome_' + chrom)
        os.makedirs(path, exist_ok=True)
        for name, values in zip(('start', 'end', 'quality'), tables[chrom]):
            np.save(os.path.join(path, name + '.npy'), values)
    if with_hdf5:
        import h5py
        with h5py.File(stem + '.h5', 'w') as store:
            for chrom, columns in tables.items():
                group = store.create_group('chromosome_' + chrom)
                for name, values in zip(('start', 'end', 'quality'),
                                        columns):
                    group.create_dataset(name, data=values)


# the Ensembl release and the UCSC build of each genome version's mirror
BUILD_NAMES = {'GRCh37': ('75', 'hg19'), 'GRCh38': ('93', 'hg38')}


def gzip_writer(path, mode='wb'):
    """A gzip file at level 1 with no time stamp: the same bytes at every
    run."""
    import gzip
    import io
    stream = gzip.GzipFile(path, 'wb', compresslevel=1, mtime=0)
    return stream if mode == 'wb' else io.TextIOWrapper(stream,
                                                        newline='')


def fasta_lines(bases, width=60):
    """The body of a FASTA record: ``bases`` (bytes) in lines of
    ``width``."""
    return b''.join(bases[i:i + width] + b'\n'
                    for i in range(0, len(bases), width))


def write_fasta_mirror(mirror, genome_version, records):
    """One gzipped Ensembl FASTA a chromosome, under the name that
    ``ensembl_assembly_url_template`` ends in for the assembly
    ``chromosome.<name>``: an Ensembl header and the body of ``records``
    ((name, length, body bytes of 60-base lines))."""
    os.makedirs(mirror, exist_ok=True)
    for chrom, length, body in records:
        name = 'Homo_sapiens.{}.dna.chromosome.{}.fa.gz'.format(
            genome_version, chrom)
        with gzip_writer(os.path.join(mirror, name)) as f:
            f.write('>{0} dna:chromosome chromosome:{1}:{0}:1:{2}:1 REF\n'
                    .format(chrom, genome_version, length).encode())
            f.write(body)


def write_gap_mirror(mirror, rows):
    """UCSC's ``gap.txt.gz`` of the rows (bin, chromosome, start, end, ix,
    type, bridge), chromosome names ``chr``-prefixed."""
    os.makedirs(mirror, exist_ok=True)
    with gzip_writer(os.path.join(mirror, 'gap.txt.gz'), 'wt') as f:
        for i, chrom, start, end, ix, kind, bridge in rows:
            f.write('{}\tchr{}\t{}\t{}\t{}\tN\t{}\t{}\t{}\n'.format(
                i, chrom, start, end, ix, int(end) - int(start), kind,
                bridge))


def write_tar_mirror(path, members):
    """A gzipped tarball at ``path`` of ``members`` ((file or directory,
    its name in the archive))."""
    import tarfile
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with tarfile.open(path, 'w:gz', compresslevel=1) as tar:
        for source, name in members:
            tar.add(source, arcname=name)


def same_file(a, b):
    """Whether two files hold the same bytes, a .gz file's decompressed."""
    import gzip
    contents = []
    for path in (a, b):
        opener = gzip.open if path.endswith('.gz') else open
        with opener(path, 'rb') as f:
            contents.append(f.read())
    return contents[0] == contents[1]


def tree_digest(root):
    """{path under ``root``: the sha256 (first 16 hex digits) of its bytes,
    a .gz file's decompressed} of every file under ``root``."""
    import gzip
    digest = {}
    for directory, _, files in os.walk(root):
        for name in files:
            path = os.path.join(directory, name)
            opener = gzip.open if name.endswith('.gz') else open
            with opener(path, 'rb') as f:
                digest[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()[:16]
    return dict(sorted(digest.items()))


def build_config(genome_version, chromosomes):
    """The config of a reference build of ``chromosomes`` on
    ``genome_version``: its Ensembl release and UCSC build
    (``BUILD_NAMES``), an assembly a chromosome, and the chromosomes."""
    ensembl_version, ucsc_version = BUILD_NAMES[genome_version]
    return dict(ensembl_genome_version=genome_version,
                ensembl_version=ensembl_version,
                ucsc_genome_version=ucsc_version,
                ensembl_assemblies=['chromosome.' + c for c in chromosomes],
                chromosomes=list(chromosomes))


@contextlib.contextmanager
def timed_steps():
    """Swaps ``utils.AutoSentinal.run`` for one that appends (step name,
    seconds, whether it ran) of each step to the list it yields."""
    from remixt_tpu_torch import utils
    steps, run = [], utils.AutoSentinal.run

    def timed(sentinal, step):
        t0 = time.time()
        ran = not os.path.exists(sentinal.sentinal_prefix + step.__name__)
        run(sentinal, step)
        steps.append((step.__name__, time.time() - t0, ran))
    utils.AutoSentinal.run = timed
    try:
        yield steps
    finally:
        utils.AutoSentinal.run = run


def check_standin_wget(bin_dir):
    """Raise unless the ``wget`` on the PATH is the stand-in of
    ``bin_dir``: the reference build must never reach the network."""
    found = shutil.which('wget')
    if found is None or os.path.realpath(found) != os.path.realpath(
            os.path.join(bin_dir, 'wget')):
        raise RuntimeError('the wget on the PATH is {}, not the stand-in of '
                           '{}'.format(found, bin_dir))


def create_ref_data_cli(built_dir, config, bin_dir):
    """``create_ref_data`` through ``ui.main.main`` on ``config`` (written
    beside ``built_dir``), with ``--bwa_index_genome`` and the stand-ins
    of ``bin_dir`` first on the PATH. Returns the steps' (name, seconds,
    ran), the whole call's seconds and the config file."""
    from remixt_tpu_torch.ui import main as cli
    config_file = built_dir.rstrip('/') + '.config.yaml'
    with open(config_file, 'w') as f:
        json.dump(config, f)
    with timed_steps() as steps, first_on_path(bin_dir):
        check_standin_wget(bin_dir)
        t0 = time.time()
        cli.main(['create_ref_data', built_dir, '--config', config_file,
                  '--bwa_index_genome'])
        whole = time.time() - t0
    return steps, whole, config_file


def write_read_mirror(ref_dir, genome_version, mirror_dir):
    """The upstream sources of ``write_reference``'s reference in
    ``ref_dir`` with its impute2 panel, written into ``mirror_dir``: its
    FASTA as one Ensembl FASTA a chromosome, its gap table with UCSC's
    chr-prefixed names, its impute2 panel as the tarball. Draws from no
    generator."""
    import gzip
    fasta = os.path.join(ref_dir, 'genome.fa')
    with open(fasta, 'rb') as fa, open(fasta + '.fai') as fai:
        records = []
        for line in fai:
            chrom, length, offset = line.split('\t')[:3]
            full, rest = divmod(int(length), 60)
            fa.seek(int(offset))
            records.append((chrom, int(length),
                            fa.read(full * 61 + (rest + 1 if rest else 0))))
    write_fasta_mirror(mirror_dir, genome_version, records)
    del records
    with gzip.open(os.path.join(ref_dir, 'gap.txt.gz'), 'rt') as f:
        gaps = [line.rstrip('\n').split('\t') for line in f]
    write_gap_mirror(mirror_dir, [row[:5] + row[7:] for row in gaps])
    panel = 'ALL_1000G_phase1integrated_v3_impute'
    write_tar_mirror(os.path.join(mirror_dir, panel + '.tgz'),
                     [(os.path.join(ref_dir, panel), panel)])


def build_read_reference(label, fixture, chromosome_lengths, root, bin_dir,
                         mirror_dir):
    """The read benchmark's reference as the port builds it: the upstream
    sources of ``fixture``'s reference written into ``mirror_dir``
    (``write_read_mirror``), then ``create_ref_data`` into ``root`` through
    the stand-ins of ``bin_dir``. The FASTA, its index, the gap table
    (decompressed) and the SNP positions must equal ``write_reference``'s
    byte for byte; the stand-ins' truth files are copied, and the run's
    config (the build's, with the fixture's mappability store) rewritten.
    Returns the fixture on the built reference."""
    from remixt_tpu_torch import config as config_mod

    ref_dir = fixture['ref_data_dir']
    genome_version = fixture['config']['ensembl_genome_version']
    t0 = time.time()
    write_read_mirror(ref_dir, genome_version, mirror_dir)
    mirror_s = time.time() - t0

    config = build_config(genome_version, chromosome_lengths)
    steps, whole, _ = create_ref_data_cli(root, config, bin_dir)
    built = {name: config_mod.get_filename(config, root, name)
             for name in ('genome_fasta', 'genome_fai', 'gap_table',
                          'snp_positions')}
    fasta = os.path.join(ref_dir, 'genome.fa')
    made = dict(genome_fasta=fasta, genome_fai=fasta + '.fai',
                gap_table=os.path.join(ref_dir, 'gap.txt.gz'),
                snp_positions=os.path.join(ref_dir,
                                           'thousand_genomes_snps.tsv'))
    for name, path in built.items():
        if not same_file(path, made[name]):
            raise AssertionError('{}: the built {} ({}) is not '
                                 'write_reference\'s'.format(label, name,
                                                             path))
    for chrom in chromosome_lengths:
        shutil.copyfile(panel_truth_path(ref_dir, chrom),
                        panel_truth_path(root, chrom))
    log('{}: reference built by create_ref_data ({}): mirror written in '
        '{:.1f} s, the build {:.1f} s ({}); FASTA, .fai, gap table and SNP '
        'positions equal to write_reference\'s'.format(
            label, genome_version, mirror_s, whole, ', '.join(
                '{} {:.1f} s'.format(name, sec) for name, sec, _ in steps)))
    run_config = dict(config, mappability_filename=fixture['config'][
        'mappability_filename'])
    with open(fixture['config_file'], 'w') as f:
        json.dump(run_config, f)
    times = dict(fixture['times'], mirror=mirror_s, create_ref_data=whole)
    return dict(fixture, ref_data_dir=root, config=run_config, times=times,
                build_steps=steps)


def run_mixture_params(chromosome_lengths):
    """The accuracy benchmark's simulation parameters
    (``benchmark/accuracy_sim_defs.yaml``, ``accuracy_0_0``, seed 1234) on
    the given chromosomes, with N scaled to their share of the
    autosomes."""
    from remixt_tpu_torch.simulations import pipeline as sim_pipeline
    here = os.path.dirname(os.path.abspath(__file__))
    params = dict(sim_pipeline.create_simulations(
        os.path.join(here, 'benchmark', 'accuracy_sim_defs.yaml'), {},
        None)['accuracy_0_0'])
    share = sum(chromosome_lengths.values()) / float(sum(
        params['chromosome_lengths'].values()))
    params.update(chromosome_lengths=dict(chromosome_lengths),
                  chromosomes=list(chromosome_lengths),
                  N=int(round(params['N'] * share)))
    return params


def sample_reads(rng, chromosome_lengths, segments, weights, depth):
    """Fragments of ``depth``: per (segment, allele) in proportion to its
    length times its weight (the mixture's allele copy number), with a
    uniform start in the segment and a normal length. Returns {chromosome:
    (start, length, allele)} sorted by start."""
    chrom, seg_start, seg_end = segments
    total = int(round(depth * sum(chromosome_lengths.values())
                      / (2 * READ_LENGTH)))
    mass = (seg_end - seg_start)[:, None] * weights
    counts = rng.multinomial(total, (mass / mass.sum()).ravel()).reshape(
        mass.shape)
    out = {}
    for name, length in chromosome_lengths.items():
        on = np.flatnonzero(chrom == name)
        n = counts[on].ravel()
        seg = np.repeat(np.repeat(on, 2), n)
        allele = np.repeat(np.tile([0, 1], len(on)), n)
        start = seg_start[seg] + (rng.random_sample(len(seg))
                                  * (seg_end - seg_start)[seg]).astype(
                                      np.int64)
        frag = np.clip(np.round(rng.normal(FRAGMENT_MEAN, FRAGMENT_SD,
                                           len(seg))), 2 * READ_LENGTH,
                       1000 - 1).astype(np.int64)
        keep = start + frag <= length
        order = np.argsort(start[keep], kind='stable')
        out[name] = (start[keep][order], frag[keep][order],
                     allele[keep][order])
    return out


def read_codes(truth, start, allele):
    """Each read's base codes: the reference with the alternate base of
    every SNP that the read's haplotype carries."""
    from remixt_tpu_torch.segalg import vrange
    bases, _, positions, alt, genotype = truth
    codes = BASE_CODE[bases[start[:, None] + np.arange(READ_LENGTH)]]
    lo = np.searchsorted(positions, start)
    hi = np.searchsorted(positions, start + READ_LENGTH)
    read = np.repeat(np.arange(len(start)), hi - lo)
    snp = vrange(lo, hi - lo)
    carried = genotype[snp, allele[read]] == 1
    read, snp = read[carried], snp[carried]
    codes[read, positions[snp] - start[read]] = BASE_CODE[alt[snp]]
    return codes


def write_sample_bam(path, chromosome_lengths, truth, fragments):
    """The BAM of a sample's fragments; a pair with a read starting in an
    unmappable stretch gets mapping quality 0."""
    batches, first = [], 0
    for refid, name in enumerate(chromosome_lengths):
        start, frag, allele = fragments[name]
        mappable = truth[name][1]
        pos2 = start + frag - READ_LENGTH
        mapq = np.where((mappable[start] > 0) & (mappable[pos2] > 0), 60,
                        0).astype(np.uint8)
        batches.append(bam_records(
            refid, start.astype(np.int32), frag.astype(np.int32), mapq,
            fragment_names(first, len(start)),
            read_codes(truth[name], start, allele),
            read_codes(truth[name], pos2, allele)))
        first += len(start)
    write_bam(path, chromosome_lengths, batches)
    return first


def count_table_digest(path):
    """A count table's digest: its rows and columns, the sha256 (first 16
    hex digits) of each integer or string column, and of each float column
    its sum and its sum weighted by row number (1..n)."""
    from remixt_tpu_torch.io.table import read_tsv
    table = read_tsv(path, str_columns=('chromosome',))
    weights = np.arange(1, len(table) + 1, dtype=np.float64)
    digest = dict(rows=len(table), columns=table.columns, ints={}, floats={})
    for name, values in table.items():
        if values.dtype.kind == 'f':
            digest['floats'][name] = [float(values.sum()),
                                      float(values @ weights)]
        else:
            data = ('\n'.join(values).encode() if values.dtype == object
                    else values.astype(np.int64).tobytes())
            digest['ints'][name] = hashlib.sha256(data).hexdigest()[:16]
    return digest


def make_run_fixture(root, chromosome_lengths, depths=None, with_hdf5=False,
                     mixture_params=None, tumour_b=False):
    """The run path's inputs, made from seeds: the synthetic reference, the
    tumour mixture of ``run_mixture_params`` (the port's
    ``simulate_genome_mixture``), its breakpoint table, and a tumour and a
    normal BAM at ``depths``; ``mixture_params`` overrides simulation
    parameters (the tests' small genomes take fewer segments and events).
    With ``tumour_b`` a third BAM, ``tumour_b``, is drawn after those two
    (which it leaves as they were) at the tumour's depth unless ``depths``
    gives its own: a second region of the same tumour, its two clones'
    fractions swapped and the normal's kept; its truth, the mixture with
    that ``frac``, is pickled beside the mixture.
    Returns dict(ref_data_dir, bams {sample:
    path}, breakpoint_file, mixture_file, pairs {sample: fragments},
    config: the overrides of the defaults, times {step: seconds}, and with
    ``tumour_b`` mixture_files {tumour sample: its truth's pickle})."""
    from remixt_tpu_torch.simulations import pipeline as sim_pipeline
    depths = dict(RUN_DEPTH if depths is None else depths)
    rng = np.random.RandomState(RUN_SEED)
    ref_dir = os.path.join(root, 'ref')
    times = {}
    t0 = time.time()
    truth = write_reference(ref_dir, chromosome_lengths, rng, with_hdf5)
    times['reference'] = time.time() - t0

    t0 = time.time()
    mixture_file = os.path.join(root, 'mixture.pickle')
    params = run_mixture_params(chromosome_lengths)
    params.update(mixture_params or {})
    sim_pipeline.simulate_genome_mixture(mixture_file, None, params)
    breakpoint_file = os.path.join(root, 'breakpoints.tsv')
    sim_pipeline.write_breakpoints(breakpoint_file, mixture_file)
    with open(mixture_file, 'rb') as f:
        mixture = pickle.load(f)
    times['mixture'] = time.time() - t0

    segments = (np.asarray(mixture.segment_chromosome_id).astype(str),
                np.asarray(mixture.segment_start, dtype=np.int64),
                np.asarray(mixture.segment_end, dtype=np.int64))
    cn = np.asarray(mixture.cn, dtype=float)
    weights = {
        'tumour': np.einsum('m,nma->na', np.asarray(mixture.frac), cn),
        'normal': np.ones((len(segments[0]), 2))}
    extra = {}
    if tumour_b:
        mixture.frac = np.asarray(mixture.frac)[[0, 2, 1]]
        weights['tumour_b'] = np.einsum('m,nma->na', mixture.frac, cn)
        depths.setdefault('tumour_b', depths['tumour'])
        mixture_files = {'tumour': mixture_file, 'tumour_b': os.path.join(
            root, 'mixture_tumour_b.pickle')}
        with open(mixture_files['tumour_b'], 'wb') as f:
            pickle.dump(mixture, f)
        extra['mixture_files'] = mixture_files
    bams, pairs = {}, {}
    t0 = time.time()
    for sample in weights:
        fragments = sample_reads(rng, chromosome_lengths, segments,
                                 weights[sample], depths[sample])
        bams[sample] = os.path.join(root, sample + '.bam')
        pairs[sample] = write_sample_bam(bams[sample], chromosome_lengths,
                                         truth, fragments)
    times['bams'] = time.time() - t0
    return dict(ref_data_dir=ref_dir, bams=bams,
                breakpoint_file=breakpoint_file, mixture_file=mixture_file,
                pairs=pairs, config=reference_config(ref_dir,
                                                     chromosome_lengths),
                times=times, **extra)


def reference_config(ref_dir, chromosome_lengths):
    """The overrides of the defaults that point a run at the synthetic
    reference."""
    return {
        'chromosomes': list(chromosome_lengths),
        'genome_fasta_filename': os.path.join(ref_dir, 'genome.fa'),
        'genome_fai_filename': os.path.join(ref_dir, 'genome.fa.fai'),
        'gap_table_filename': os.path.join(ref_dir, 'gap.txt.gz'),
        'mappability_filename': os.path.join(ref_dir, 'mappability'),
    }


def host_rss_bytes():
    """The process's resident set now (VmRSS of /proc/self/status)."""
    with open('/proc/self/status') as f:
        for line in f:
            if line.startswith('VmRSS:'):
                return int(line.split()[1]) * 1024
    raise RuntimeError('/proc/self/status has no VmRSS')


class HostPeak:
    """The process's peak resident set from its making on, sampled every
    ``interval`` seconds by a thread that only reads
    ``/proc/self/status``; ``stop()`` ends the sampling and returns the
    peak in GB. ``start`` is the resident set at the making, in bytes."""

    def __init__(self, interval=0.05):
        import threading
        self.interval = interval
        self.start = self.peak = host_rss_bytes()
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    def _sample(self):
        while not self._done.wait(self.interval):
            self.peak = max(self.peak, host_rss_bytes())

    def stop(self):
        self._done.set()
        self._thread.join()
        self.peak = max(self.peak, host_rss_bytes())
        return self.peak / 1e9


RUN_STEPS = (
    ('seqdataio', 'create_chromosome_seqdata', 'extract'),
    ('seqdataio', 'merge_seqdata', 'merge'),
    ('analysis.haplotype', 'infer_snp_genotype_from_normal', 'genotype'),
    ('analysis.haplotype', 'infer_haps', 'phase'),
    ('analysis.segment', 'create_segments', 'segments'),
    ('analysis.readcount', 'segment_readcount', 'segment counts'),
    ('analysis.readcount', 'haplotype_allele_readcount', 'allele counts'),
    ('analysis.readcount', 'phase_segments', 'phase segments'),
    ('analysis.readcount', 'prepare_readcount_table', 'count table'),
    ('analysis.stats', 'calculate_fragment_stats', 'fragment stats'),
    ('analysis.gcbias', 'sample_gc', 'sample_gc'),
    ('analysis.gcbias', 'gc_lowess', 'gc_lowess'),
    ('analysis.gcbias', 'gc_map_bias', 'gc_map_bias'),
    ('analysis.gcbias', 'biased_length', 'biased_length'),
    ('analysis.experiment', 'create_experiment', 'experiment'),
    ('analysis.pipeline', 'init', 'init'),
    ('analysis.pipeline', 'fit_many', 'fit'),
    ('analysis.pipeline', 'collate', 'collate'),
)


@contextlib.contextmanager
def instrumented(steps, patches=()):
    """Swaps the module functions of ``steps`` ((module under
    ``remixt_tpu_torch``, name, label) triples) for timers, and marks the
    start of every wave and the end of the waves; applies ``patches``
    ((module, name, function) triples) first, so timers wrap them. Yields
    (stages {label: [seconds]}, marks [times]); puts every function back.
    """
    import importlib
    import torch
    from remixt_tpu_torch.models import engine as eng
    from remixt_tpu_torch.analysis import pipeline

    stages, marks = {}, []
    timed = stage_timer(stages)
    elbo0, batched = eng.calculate_elbo_restarts, pipeline.fit_restarts_batched

    def wave_start(*args, **kwargs):
        torch.cuda.synchronize()
        marks.append(time.time())
        return elbo0(*args, **kwargs)

    def waves(*args, **kwargs):
        out = batched(*args, **kwargs)
        torch.cuda.synchronize()
        marks.append(time.time())
        return out

    originals = []
    for module, name, fn in patches:
        originals.append((module, name, getattr(module, name)))
        setattr(module, name, fn)
    eng.calculate_elbo_restarts = wave_start
    pipeline.fit_restarts_batched = waves
    originals += [(eng, 'calculate_elbo_restarts', elbo0),
                  (pipeline, 'fit_restarts_batched', batched)]
    for module, name, step in steps:
        module = importlib.import_module('remixt_tpu_torch.' + module)
        originals.append((module, name, timed(module, name, step)))
    try:
        yield stages, marks
    finally:
        for module, name, fn in reversed(originals):
            setattr(module, name, fn)


@contextlib.contextmanager
def first_on_path(bin_dir):
    path = os.environ['PATH']
    os.environ['PATH'] = bin_dir + os.pathsep + path
    try:
        yield
    finally:
        os.environ['PATH'] = path


def sample_of(args):
    """The one sample (``normal``, ``tumour`` or ``tumour_b``) whose files
    a step's call ``args`` name, else None."""
    names = set()

    def scan(value):
        if isinstance(value, str):
            names.update(re.findall(r'(?<![A-Za-z0-9])(normal|tumour_b|'
                                    r'tumour)(?![A-Za-z0-9])', value))
        elif isinstance(value, (list, tuple)):
            for v in value:
                scan(v)
        elif isinstance(value, dict):
            for v in list(value) + list(value.values()):
                scan(v)
    scan(args)
    return names.pop() if len(names) == 1 else None


def sample_recorders(steps, samples):
    """Patches for ``instrumented``: each call of a step of ``steps``
    appends to ``samples[label]`` the sample it works on (``sample_of``),
    beside the seconds its timer appends."""
    import importlib
    patches = []
    for module, name, label in steps:
        module = importlib.import_module('remixt_tpu_torch.' + module)

        def recorder(*args, _fn=getattr(module, name), _label=label,
                     **kwargs):
            samples.setdefault(_label, []).append(
                sample_of((args, kwargs)))
            return _fn(*args, **kwargs)
        patches.append((module, name, recorder))
    return patches


def make_cli_inputs(label, root, chromosome_lengths, depths,
                    tumour_b=False):
    """Phase 11's inputs, made in ``root``, with ``tumour_b`` the second
    tumour's BAM of phase 13."""
    fresh_directory(root)
    fixture = make_run_fixture(root, chromosome_lengths, depths=depths,
                               tumour_b=tumour_b)
    log('{}: inputs made: reference {:.1f} s, mixture {:.1f} s, BAMs {:.1f} '
        's; read pairs {} over {} chromosomes ({:.1f} Mb)'.format(
            label, fixture['times']['reference'],
            fixture['times']['mixture'], fixture['times']['bams'],
            json.dumps(fixture['pairs']), len(chromosome_lengths),
            sum(chromosome_lengths.values()) / 1e6))
    return fixture


def run_cli(label, root, chromosome_lengths, depths, fixture=None,
            tumours=('tumour',)):
    """Phase 11's inputs made in ``root`` (``fixture``, where they were
    made before), then the ``run`` CLI on them
    (``remixt_tpu_torch.ui.main.main``) for the ``tumours`` and the
    normal, from numpy's global state seeded with ``RUN_NUMPY_SEED``, the
    stand-in phasing tools first on the PATH.
    Returns dict(fixture, raw, results {tumour: store}, times {step:
    [seconds]}, samples {step: [the sample of each call]}, marks (the
    start of every wave and the end of each fit's waves), waves, launches,
    whole)."""
    import torch
    from remixt_tpu_torch.io import store
    from remixt_tpu_torch.ui import main as cli

    fresh_directory(root)
    if fixture is None:
        fixture = make_cli_inputs(label, os.path.join(root, 'inputs'),
                                  chromosome_lengths, depths)
    bin_dir = write_standin_tools(os.path.join(root, 'bin'))
    log('{}: the phasing tools ({}) are stand-ins written by this script '
        '(the true phase with seeded switches), first on the PATH'.format(
            label, ', '.join(STANDIN_TOOLS)))
    config_file = os.path.join(root, 'config.yaml')
    with open(config_file, 'w') as f:
        json.dump(fixture['config'], f)
    raw = os.path.join(root, 'raw')
    results = {t: store.store_name(os.path.join(
        root, 'results' if len(tumours) == 1 else 'results_' + t))
        for t in tumours}

    argv = ['run', fixture['ref_data_dir'], raw, fixture['breakpoint_file'],
            '--tumour_sample_ids', *tumours,
            '--tumour_bam_files', *[fixture['bams'][t] for t in tumours],
            '--results_files', *[results[t] for t in tumours],
            '--normal_sample_id', 'normal',
            '--normal_bam_file', fixture['bams']['normal'],
            '--config', config_file]
    samples = {}
    with instrumented(RUN_STEPS, sample_recorders(RUN_STEPS, samples)) as \
            (stages, marks), first_on_path(bin_dir):
        torch.cuda.reset_peak_memory_stats()
        reset_chain_launches()
        np.random.seed(RUN_NUMPY_SEED)
        t0 = time.time()
        cli.main(argv)
        whole = time.time() - t0
        launches = chain_launches()
    return dict(fixture=fixture, raw=raw, results=results, times=stages,
                samples=samples, marks=marks, waves=np.diff(marks).tolist(),
                launches=launches, whole=whole)


def log_run_steps(label, run):
    times = run['times']
    log('{}: wall s per step: {}'.format(label, json.dumps(
        {k: round(sum(v), 3) for k, v in times.items()})))
    if 'extract' in times:
        log('{}: extract per chromosome and sample: {}'.format(
            label, json.dumps([round(t, 3) for t in times['extract']])))
    waves = run['waves']
    log('{}: fit: {} waves {:.3f} s ({}), decode and results {:.3f} s'
        .format(label, len(waves), sum(waves),
                json.dumps([round(w, 3) for w in waves]),
                sum(times.get('fit', [0.0])) - sum(waves)))


def check_counts_digest(label, count_file, want):
    """The count table against the JAX package's digest: rows, columns and
    integer columns exactly, float columns' sums at rtol 1e-12."""
    got = count_table_digest(count_file)
    misses = [k for k in ('rows', 'columns', 'ints') if got[k] != want[k]]
    if set(got['floats']) != set(want['floats']):
        misses.append('floats')
    else:
        for name, values in want['floats'].items():
            if not np.allclose(got['floats'][name], values, rtol=1e-12,
                               atol=0.0):
                misses.append(name)
    if misses:
        raise AssertionError('{}: the count table is not the JAX package\'s '
                             '({}): {} against {}'.format(
                                 label, misses, got, want))
    return got


def check_evaluation(label, evaluation, reference):
    """Print every metric beside the JAX package's; fail when one of
    ``ACCURACY_BARS`` is missed."""
    misses = evaluation_misses(label, evaluation, reference)
    if misses:
        raise AssertionError('{}: outside the bars of the JAX package\'s '
                             'evaluation: {}'.format(label, misses))


def evaluation_misses(label, evaluation, reference):
    """Print every metric beside the JAX package's; return the names of
    those outside ``ACCURACY_BARS``."""
    from remixt_tpu_torch.benchmark.export_evaluation import ACCURACY_BARS
    misses = []
    for name, value in evaluation.items():
        line = '{:<36s} {:12.6f}'.format(name, value)
        if name in reference:
            line += '  JAX {:12.6f}'.format(reference[name])
        bar = ACCURACY_BARS.get(name)
        if bar is not None:
            ok = abs(value - reference[name]) <= bar
            line += '  bar ±{} {}'.format(bar, 'ok' if ok else 'MISS')
            if not ok:
                misses.append(name)
        log('{}: {}'.format(label, line))
    return misses


def check_chosen_restart(label, mixture, tables, reference):
    """The solution this fit chose (``optimal_init_id``, the top of its
    results store), evaluated against the truth and held within
    ``ACCURACY_BARS`` to the JAX package's float32 fits of the same inputs.

    A float32 fit turns on rounding: its M-step draws its subsamples from
    float32 weights, so the JAX package's own refits of the restarts near
    its choice, from inputs moved by one float32 ulp
    (``reference['perturbed']``), choose among near-tied restarts and
    land within a restart on solutions that part by more than a bar. So
    the solution passes when some JAX float32 fit chose the same restart
    (the fit itself, ``reference['chosen']``, or a perturbed refit) and
    it lies within the bars of that fit's evaluation; where this fit's
    choice is not the JAX fit's, its solution of the JAX choice must pass
    the same way. Prints both restarts' ELBOs and proportions divergent
    in both fits, in the JAX float64 refit and in every perturbed refit."""
    from remixt_tpu_torch.analysis.pipeline import optimal_init_id
    from remixt_tpu_torch.simulations import pipeline as sim_pipeline

    perturbed = reference['perturbed']
    fits = [('the JAX fit', reference['chosen'], reference['evaluation'])]
    fits += [('its refit {}'.format(seed), perturbed['chosen'][seed],
              perturbed['evaluation'][seed]) for seed in perturbed['chosen']]

    def check(init_id, key_prefix=''):
        evaluation = evaluation_metrics(sim_pipeline.evaluate_tables(
            mixture, tables, key_prefix))
        same = [(name, ev) for name, chose, ev in fits if chose == init_id]
        if not same:
            raise AssertionError(
                '{}: no float32 fit of the JAX package chose restart {}: '
                'the JAX fit chose {}, its refits from inputs moved by one '
                'ulp {}'.format(label, init_id, reference['chosen'],
                                list(perturbed['chosen'].values())))
        for name, ev in same:
            if not evaluation_misses('{}, restart {} against {}\'s'.format(
                    label, init_id, name), evaluation, ev):
                return
        raise AssertionError(
            '{}: restart {} lies outside the bars of every JAX float32 fit '
            'that chose it ({})'.format(label, init_id,
                                        [name for name, _ in same]))

    stats = tables['stats']
    ids = list(stats['init_id'])
    own, chosen = int(optimal_init_id(stats, {})), reference['chosen']
    float64 = reference['float64']
    log('{}: this fit chose restart {}, the JAX fit restart {}, its '
        'float64 refit of restarts {} restart {}, its perturbed refits {}'
        .format(label, own, chosen, sorted(float64['elbo']),
                float64['chosen'], list(perturbed['chosen'].values())))
    for init_id in sorted({own, chosen}):
        row = ids.index(init_id)
        log('{}: restart {}: ELBO {:.6f} here, {:.6f} in the JAX fit, {} in '
            'its float64 refit, {} in its perturbed refits; proportion '
            'divergent {:.6f}, {:.6f}, {}, {}'.format(
                label, init_id, stats['elbo'][row],
                reference['elbo'][init_id], float64['elbo'].get(init_id),
                [elbo.get(init_id) for elbo in perturbed['elbo'].values()],
                stats['proportion_divergent'][row],
                reference['proportion_divergent'][init_id],
                float64['proportion_divergent'].get(init_id),
                [value.get(init_id) for value in
                 perturbed['proportion_divergent'].values()]))
    if own != chosen:
        check(chosen, 'solutions/solution_{}'.format(chosen))
    check(own)


def results_keys(stats):
    """The keys of a results store of the restarts in ``stats``."""
    keys = {'stats', 'read_depth', 'minor_modes', 'cn', 'mix', 'brk_cn'}
    for init_id in stats['init_id']:
        keys |= {'solutions/solution_{}/{}'.format(init_id, name)
                 for name in ('cn', 'brk_cn', 'h', 'mix')}
    return keys


def phase_run(smi, fixture):
    """Phase 11: the run CLI from two synthetic BAMs over RUN_CHROMOSOMES
    (``fixture``, made by ``make_cli_inputs``) to a results store, the fit
    on the card. Returns the fb_grouped launches."""
    import torch
    from remixt_tpu_torch import config as config_mod
    from remixt_tpu_torch.io.store import read_store
    from remixt_tpu_torch.simulations import pipeline as sim_pipeline

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, 'build', 'chip_smoke', 'run')
    t_phase = time.time()
    peak = HostPeak()
    run = run_cli('phase 11', root, RUN_CHROMOSOMES, RUN_DEPTH,
                  fixture=fixture)
    device_gb = torch.cuda.max_memory_allocated() / 1e9
    log_run_steps('phase 11', run)

    digest = check_counts_digest(
        'phase 11', os.path.join(run['raw'], 'counts', 'sample_tumour.tsv'),
        RUN_JAX['counts'])
    log('phase 11: the count table ({} segments, {} reads) is the JAX '
        'package\'s for the same inputs and seed: {}'.format(
            digest['rows'], int(digest['floats']['readcount'][0]),
            json.dumps(digest)))

    results = run['results']['tumour']
    tables = read_store(results)
    stats = tables['stats']
    restarts = len(stats['init_id'])
    if restarts != RUN_JAX['restarts']:
        raise AssertionError('phase 11: init\'s grid has {} restarts, the '
                             'JAX package\'s {}'.format(
                                 restarts, RUN_JAX['restarts']))
    num_em = config_mod.get_param({}, 'num_em_iter')
    num_vi = config_mod.get_param({}, 'num_update_iter')
    expected = -(-restarts // WAVE) * num_em * num_vi
    expect_launches('phase 11', run['launches'], 'fb_grouped', expected)
    keys = results_keys(stats)
    if set(tables) != keys:
        raise AssertionError('phase 11: results keys {} missing, {} extra'
                             .format(sorted(keys - set(tables)),
                                     sorted(set(tables) - keys)))
    if not np.all(np.isfinite(stats['elbo'])):
        raise AssertionError('phase 11: non-finite ELBO')
    log('phase 11: results store {} ({}): {} keys, grid of {} restarts, {} '
        'EM x {} VI, fb_grouped launches {}; ELBOs {:.6g} to {:.6g}'.format(
            os.path.relpath(results, here),
            'HDF5' if results.endswith('.h5') else
            'TSV tables: h5py is absent', len(tables), restarts, num_em,
            num_vi, expected, float(np.min(stats['elbo'])),
            float(np.max(stats['elbo']))))

    with open(run['fixture']['mixture_file'], 'rb') as f:
        mixture = pickle.load(f)
    check_chosen_restart('phase 11', mixture, tables, RUN_JAX)
    log('phase 11: run CLI {:.1f} s, phase {:.1f} s; max_memory_allocated '
        '{:.3f} GB; host peak RSS {:.3f} GB ({}); {}'.format(
            run['whole'], time.time() - t_phase, device_gb, peak.stop(),
            'sampled every 50 ms since the phase began',
            smi))
    return expected


# ---------------------------------------------------------------------------
# phase 12: the read-level simulation benchmark and the results CLI
# ---------------------------------------------------------------------------

# the haploid read depth of phase 12's simulation (benchmark/sim_defs.yaml
# has 0.1; cut for the run's time)
READ_H_TOTAL = 0.02
# haplotypes of each chromosome's synthetic impute2 panel, and its seed
PANEL_HAPLOTYPES, PANEL_SEED = 40, 13
# the build of phase 12's reference: the read benchmark's germline comes
# from the GRCh37 impute2 panel, and its sample is phased through shapeit2
READ_GENOME_VERSION = 'GRCh37'
# the one simulation of benchmark/sim_defs.yaml
READ_SIM_ID = 'test_proportion_subclonal_0_0'
# the read benchmark's own steps, timed with those of the run from seqdata
READ_STEPS = (
    ('simulations.pipeline', 'simulate_germline_alleles', 'germline'),
    ('simulations.pipeline', 'simulate_genome_mixture', 'mixture'),
    ('simulations.pipeline', 'simulate_normal_data', 'normal reads'),
    ('simulations.pipeline', 'simulate_tumour_data', 'tumour reads'),
    ('simulations.pipeline', 'evaluate_results_task', 'evaluate'),
) + RUN_STEPS[2:] + tuple(
    ('wrappers.wrapexternal', '_{}_{}'.format(tool, stage),
     '{} {}'.format(tool, stage.split('_')[0]))
    for tool in ('titan', 'theta', 'clonehd')
    for stage in ('prepare', 'run_all' if tool == 'titan' else 'run',
                  'report'))
# the external callers the read benchmark compares with ReMixT, each run by
# its wrapper through the stand-ins of ``write_standin_tools``; THetA on
# fixed windows of READ_THETA_WINDOW bases
READ_TOOLS = ('titan', 'theta', 'clonehd')
READ_THETA_WINDOW = 1000000
# each external tool's stand-ins, and the files its wrapper writes for them
TOOL_STANDINS = {'titan': ('Rscript',), 'theta': ('RunTHetA', 'octave'),
                 'clonehd': ('filterHD', 'cloneHD')}
TOOL_INPUTS = {
    'titan': ('alleles.tsv', 'normal.wig', 'tumour.wig'),
    'theta': ('chrom_names.tsv', 'counts.tsv', 'normal_alleles.tsv',
              'tumour_alleles.tsv'),
    'clonehd': ('normal.cna.txt', 'tumour.cna.txt', 'tumour.baf.txt'),
}
# what the JAX package makes of phase 12's inputs on the CPU, on the
# GRCh37 reference (``python tests/test_torch_read_benchmark.py --phase12
# WORKDIR``): the digests of its simulated seqdata (``seqdata_digest``) and
# count table (``count_table_digest``), then what ``RUN_JAX`` holds of its
# fit. The GRCh38 route gives the same values: the stand-ins draw the same
# switches at the same het sites from the same seeds, so the blocks differ
# only in their labels and in which allele each block calls first, which
# the allele counts' phasing across samples does not see.
READ_JAX = {'seqdata': {'normal': {'fragments': {'rows': 6498399,
                                                 'fragment_id': 'a504ea286409ff17',
                                                 'start': 'ec8036d810f5c9ac',
                                                 'end': 'afbc4d7848be33a8',
                                                 'mapping_quality': 'bfc79824d28553c6',
                                                 'is_duplicate': '8ec192e664c6b486'},
                                   'alleles': {'rows': 1286912,
                                               'fragment_id': '82619ab384c753a6',
                                               'position': '304732efb2c81ba2',
                                               'is_alt': 'bf5129eb4ad90964'}},
                        'tumour': {'fragments': {'rows': 7489992,
                                                 'fragment_id': '01f7affc772e8ab4',
                                                 'start': '369bc9dc7e9d76ff',
                                                 'end': '9fa2ab8955008bf5',
                                                 'mapping_quality': '8ddb5fdcc9492f09',
                                                 'is_duplicate': '26d5f4c94fa54b2c'},
                                   'alleles': {'rows': 1486676,
                                               'fragment_id': '0cbc97b7f372b26e',
                                               'position': 'a175f6ddd3311ca1',
                                               'is_alt': 'ffead781a5e57c2c'}}},
            'counts': {'rows': 541,
                       'columns': ['chromosome', 'start', 'end', 'readcount',
                                   'allele_b_readcount', 'allele_a_readcount',
                                   'major_readcount', 'minor_readcount',
                                   'major_is_allele_a', 'bias', 'length'],
                       'ints': {'chromosome': '5e7375ae997942a7',
                                'start': '5767b952a001b981',
                                'end': '5b9072ec0cd0896c',
                                'allele_b_readcount': '5c0bd4430153ce12',
                                'allele_a_readcount': '43b8d1c53155371d',
                                'major_readcount': '43b8d1c53155371d',
                                'minor_readcount': '5c0bd4430153ce12',
                                'major_is_allele_a': 'cb8960c255bda83b'},
                       'floats': {'readcount': [7428508.0, 1871872962.0],
                                  'bias': [0.9999999999999734,
                                           268.6589273398567],
                                  'length': [161175535.0, 43301246346.52868]}},
            'restarts': 72,
            'segments': 541,
            'chosen': 14,
            'elbo': {0: -6424.67626953125, 1: -6349.46337890625,
                     2: -6324.91650390625, 3: -6418.8427734375,
                     4: -6350.6279296875, 5: -6350.41650390625,
                     6: -6497.486328125, 7: -6398.50048828125,
                     8: -6396.79541015625, 9: -6615.50830078125,
                     10: -6542.80419921875, 11: -6477.03662109375,
                     12: -6366.95849609375, 13: -6227.8671875,
                     14: -6222.4560546875, 15: -6346.822265625,
                     16: -6231.9580078125, 17: -6217.3486328125,
                     18: -6374.54931640625, 19: -6260.47802734375,
                     20: -6263.298828125, 21: -6387.939453125,
                     22: -6251.35546875, 23: -6244.39599609375,
                     24: -6464.5302734375, 25: -6392.90771484375,
                     26: -6369.70947265625, 27: -6627.81640625,
                     28: -6498.068359375, 29: -6484.56103515625,
                     30: -6730.00732421875, 31: -6573.767578125,
                     32: -6543.14306640625, 33: -6731.7099609375,
                     34: -6665.86376953125, 35: -6671.3583984375,
                     36: -6385.19580078125, 37: -6269.25732421875,
                     38: -6255.876953125, 39: -6431.14208984375,
                     40: -6264.85107421875, 41: -6232.697265625,
                     42: -6413.57763671875, 43: -6288.2177734375,
                     44: -6281.58154296875, 45: -6402.359375,
                     46: -6308.90576171875, 47: -6284.7353515625,
                     48: -6882.83544921875, 49: -6728.9189453125,
                     50: -6703.7587890625, 51: -6831.6494140625,
                     52: -6621.90625, 53: -6596.8271484375,
                     54: -6887.71337890625, 55: -6751.900390625,
                     56: -6742.33984375, 57: -6901.091796875,
                     58: -6770.830078125, 59: -6720.9765625, 60: -6514.3984375,
                     61: -6340.2333984375, 62: -6318.05712890625,
                     63: -6585.9052734375, 64: -6448.177734375,
                     65: -6416.82958984375, 66: -6616.4091796875,
                     67: -6427.234375, 68: -6367.18896484375, 69: -6653.78125,
                     70: -6529.05712890625, 71: -6514.1689453125},
            'proportion_divergent': {0: 0.272506148904462,
                                     1: 0.3047719317555191,
                                     2: 0.33410851853022383,
                                     3: 0.3065485500302845,
                                     4: 0.38252527037306955,
                                     5: 0.38376024495085875,
                                     6: 0.39045868257913696,
                                     7: 0.4527244899410879,
                                     8: 0.441336563374981,
                                     9: 0.4023826653011562,
                                     10: 0.5267235841287833,
                                     11: 0.5235646272540249,
                                     12: 0.3487208748216361,
                                     13: 0.4750958496482489,
                                     14: 0.47544761392042906,
                                     15: 0.33840409427119217,
                                     16: 0.5323306687152587,
                                     17: 0.5072269068458917,
                                     18: 0.3488286017096217,
                                     19: 0.5502608898631324,
                                     20: 0.5676982511654444,
                                     21: 0.24930824760014064,
                                     22: 0.49090439997961977,
                                     23: 0.5602016466581278,
                                     24: 0.3068260300789937,
                                     25: 0.34280098809824616,
                                     26: 0.3475787663278805,
                                     27: 0.40690279489943415,
                                     28: 0.4515853195786222,
                                     29: 0.4618572230285729,
                                     30: 0.44907871739375665,
                                     31: 0.5771608254076032,
                                     32: 0.5806980451441021,
                                     33: 0.4160670220851448,
                                     34: 0.5906211550127065,
                                     35: 0.6289100343442792,
                                     36: 0.3329177696621278,
                                     37: 0.43418232424950814,
                                     38: 0.45499749629566977,
                                     39: 0.4342103468603875,
                                     40: 0.5239039900647475,
                                     41: 0.5555170273828561,
                                     42: 0.42944611413304384,
                                     43: 0.577550628250363,
                                     44: 0.5814510540003587,
                                     45: 0.3433916815287902,
                                     46: 0.6089933721960124,
                                     47: 0.662417315902114,
                                     48: 0.5259047580052103,
                                     49: 0.5477961508242494,
                                     50: 0.5894130807551164,
                                     51: 0.5611958217931815,
                                     52: 0.6300876719070359,
                                     53: 0.6455169177030237,
                                     54: 0.5987562707674755,
                                     55: 0.649533046521118,
                                     56: 0.6486527615266021,
                                     57: 0.6223494988262467,
                                     58: 0.6672166325439048,
                                     59: 0.6770462636032274,
                                     60: 0.5523826768541417,
                                     61: 0.6161500485633014,
                                     62: 0.6236934200988298,
                                     63: 0.6537787609339845,
                                     64: 0.6540949595028884,
                                     65: 0.686652084019892,
                                     66: 0.6469449442268722,
                                     67: 0.7210895095126467,
                                     68: 0.7303385398738761,
                                     69: 0.5988540334355654,
                                     70: 0.6974600505970642,
                                     71: 0.6988802001706368},
            'evaluation': {'proportion_cn_correct': 0.0,
                           'proportion_dom_cn_correct': 0.0,
                           'proportion_clonal_correct': 0.6836080922579224,
                           'proportion_subclonal_correct': 0.6836080922579224,
                           'pred_ploidy': 5.3842690052184405,
                           'pred_ploidy_1': 5.281909987145381,
                           'pred_ploidy_2': 5.4866280232915,
                           'pred_proportion_divergent': 0.4409236581718187,
                           'true_ploidy': 2.518175345284258,
                           'true_ploidy_1': 2.4966881481113123,
                           'true_ploidy_2': 2.5396625424572035,
                           'true_proportion_divergent': 0.34928632003610227,
                           'brk_cn_correct_proportion': 0.38461538461538464,
                           'brk_cn_present_num_true': 102.0,
                           'brk_cn_present_num_pos': 153.0,
                           'brk_cn_present_num_true_pos': 91.0,
                           'brk_cn_subclonal_num_true': 68.0,
                           'brk_cn_subclonal_num_pos': 22.0,
                           'brk_cn_subclonal_num_true_pos': 6.0,
                           'mix_true_0': 0.4,
                           'mix_true_1': 0.4,
                           'mix_true_2': 0.19999999999999996,
                           'mix_pred_0': 0.5929194688796997,
                           'mix_pred_1': 0.3023572564125061,
                           'mix_pred_2': 0.10472332686185837},
            'float64': {'chosen': 14,
                        'elbo': {13: -6242.93466405054, 14: -6213.422488416634,
                                 16: -6233.187339066961, 17: -6215.695283495541},
                        'proportion_divergent': {13: 0.46809229937989505,
                                                 14: 0.48293151327185596,
                                                 16: 0.5376716670447098,
                                                 17: 0.5015424701944867},
                        'evaluation': {'proportion_cn_correct': 0.0,
                                       'proportion_dom_cn_correct': 0.0,
                                       'proportion_clonal_correct': 0.7057640106483902,
                                       'proportion_subclonal_correct': 0.7057640106483902,
                                       'pred_ploidy': 5.352838859818272,
                                       'pred_ploidy_1': 5.250917591184047,
                                       'pred_ploidy_2': 5.454760128452498,
                                       'pred_proportion_divergent': 0.4482625728526355,
                                       'true_ploidy': 2.518175345284258,
                                       'true_ploidy_1': 2.4966881481113123,
                                       'true_ploidy_2': 2.5396625424572035,
                                       'true_proportion_divergent': 0.34928632003610227,
                                       'brk_cn_correct_proportion': 0.38009049773755654,
                                       'brk_cn_present_num_true': 102.0,
                                       'brk_cn_present_num_pos': 153.0,
                                       'brk_cn_present_num_true_pos': 91.0,
                                       'brk_cn_subclonal_num_true': 68.0,
                                       'brk_cn_subclonal_num_pos': 19.0,
                                       'brk_cn_subclonal_num_true_pos': 5.0,
                                       'mix_true_0': 0.4,
                                       'mix_true_1': 0.4,
                                       'mix_true_2': 0.19999999999999996,
                                       'mix_pred_0': 0.5914001881796422,
                                       'mix_pred_1': 0.2793240168747952,
                                       'mix_pred_2': 0.12927579494556252}},
            'perturbed': {'chosen': {1: 14, 2: 14, 3: 14, 4: 14, 5: 14, 6: 14,
                                     7: 14, 8: 14},
                          'elbo': {1: {13: -6237.71630859375, 14: -6230.4375,
                                       16: -6232.43603515625,
                                       17: -6215.9560546875},
                                   2: {13: -6244.23388671875,
                                       14: -6226.15087890625,
                                       16: -6233.28173828125,
                                       17: -6225.03564453125},
                                   3: {13: -6241.91796875, 14: -6226.3125,
                                       16: -6232.88134765625,
                                       17: -6215.0634765625},
                                   4: {13: -6242.18701171875,
                                       14: -6225.99951171875,
                                       16: -6231.6064453125,
                                       17: -6220.490234375},
                                   5: {13: -6238.08740234375,
                                       14: -6220.00634765625,
                                       16: -6233.5185546875, 17: -6215.5546875},
                                   6: {13: -6243.8349609375,
                                       14: -6233.03955078125,
                                       16: -6232.16845703125,
                                       17: -6215.41357421875},
                                   7: {13: -6234.91455078125,
                                       14: -6221.91259765625,
                                       16: -6232.0732421875,
                                       17: -6217.73974609375},
                                   8: {13: -6239.24462890625,
                                       14: -6228.1044921875,
                                       16: -6232.55859375, 17: -6215.064453125}},
                          'proportion_divergent': {1: {13: 0.47003074784425325,
                                                       14: 0.49349555224315117,
                                                       16: 0.5376716672007389,
                                                       17: 0.507226906564597},
                                                   2: {13: 0.4650141726804513,
                                                       14: 0.4860102104339658,
                                                       16: 0.5376716682763152,
                                                       17: 0.5260166569654183},
                                                   3: {13: 0.4781744365056255,
                                                       14: 0.48013397378938283,
                                                       16: 0.537671667606236,
                                                       17: 0.5072269085719816},
                                                   4: {13: 0.47297239241728956,
                                                       14: 0.48601021184578524,
                                                       16: 0.5323306688054993,
                                                       17: 0.5190919294274361},
                                                   5: {13: 0.47003074210644974,
                                                       14: 0.4978317746705915,
                                                       16: 0.5376716624404858,
                                                       17: 0.5072269027806502},
                                                   6: {13: 0.468092300538816,
                                                       14: 0.4753668058474376,
                                                       16: 0.5323306736388325,
                                                       17: 0.507226910321435},
                                                   7: {13: 0.47340738331131677,
                                                       14: 0.4846857372556085,
                                                       16: 0.5384110022555548,
                                                       17: 0.5021244619620102},
                                                   8: {13: 0.4747979119050303,
                                                       14: 0.4707702011710207,
                                                       16: 0.5376716636341121,
                                                       17: 0.5072269036902357}},
                          'evaluation': {1: {'proportion_cn_correct': 0.0,
                                             'proportion_dom_cn_correct': 0.0,
                                             'brk_cn_correct_proportion': 0.38009049773755654,
                                             'mix_pred_0': 0.5850666761398315,
                                             'mix_pred_1': 0.27146637439727783,
                                             'mix_pred_2': 0.14346696436405182},
                                         2: {'proportion_cn_correct': 0.0,
                                             'proportion_dom_cn_correct': 0.0,
                                             'brk_cn_correct_proportion': 0.38009049773755654,
                                             'mix_pred_0': 0.5911553502082825,
                                             'mix_pred_1': 0.28525516390800476,
                                             'mix_pred_2': 0.12358952313661575},
                                         3: {'proportion_cn_correct': 0.0,
                                             'proportion_dom_cn_correct': 0.0,
                                             'brk_cn_correct_proportion': 0.38009049773755654,
                                             'mix_pred_0': 0.592732846736908,
                                             'mix_pred_1': 0.2772553861141205,
                                             'mix_pred_2': 0.13001172244548798},
                                         4: {'proportion_cn_correct': 0.0,
                                             'proportion_dom_cn_correct': 0.0,
                                             'brk_cn_correct_proportion': 0.38009049773755654,
                                             'mix_pred_0': 0.5909252762794495,
                                             'mix_pred_1': 0.28203973174095154,
                                             'mix_pred_2': 0.1270349621772766},
                                         5: {'proportion_cn_correct': 0.0,
                                             'proportion_dom_cn_correct': 0.0,
                                             'brk_cn_correct_proportion': 0.3891402714932127,
                                             'mix_pred_0': 0.5911967754364014,
                                             'mix_pred_1': 0.3008854389190674,
                                             'mix_pred_2': 0.10791775584220886},
                                         6: {'proportion_cn_correct': 0.0,
                                             'proportion_dom_cn_correct': 0.0,
                                             'brk_cn_correct_proportion': 0.38461538461538464,
                                             'mix_pred_0': 0.5849400162696838,
                                             'mix_pred_1': 0.26414331793785095,
                                             'mix_pred_2': 0.1509166955947876},
                                         7: {'proportion_cn_correct': 0.0,
                                             'proportion_dom_cn_correct': 0.0,
                                             'brk_cn_correct_proportion': 0.38461538461538464,
                                             'mix_pred_0': 0.5931635499000549,
                                             'mix_pred_1': 0.2865559756755829,
                                             'mix_pred_2': 0.12028045952320099},
                                         8: {'proportion_cn_correct': 0.0,
                                             'proportion_dom_cn_correct': 0.0,
                                             'brk_cn_correct_proportion': 0.38009049773755654,
                                             'mix_pred_0': 0.58798748254776,
                                             'mix_pred_1': 0.2834046185016632,
                                             'mix_pred_2': 0.12860794365406036}}}}

# the external tools of phase 12's read benchmark as the JAX runner runs
# them through the stand-ins on the same inputs (``python
# tests/test_torch_read_benchmark.py --phase12 WORKDIR --tools``;
# ``tool_record``: input digests, stand-in calls, results, evaluation)
READ_JAX['tools'] = {'titan': {'inputs': {'alleles.tsv': '5aae403a3e50fffb',
                                          'normal.wig': '0baec12c2682895b',
                                          'tumour.wig': '445678bc27fc1680'},
                               'calls': ['Rscript @BIN@/titan_run.R '
                                         '@SIM@/titan/alleles.tsv @SIM@/titan/tumour.wig '
                                         '@SIM@/titan/normal.wig 1 2.0 0.5 '
                                         '@SIM@/titan/restart_0/cn.tsv '
                                         '@SIM@/titan/restart_0/params.txt',
                                         'Rscript @BIN@/titan_run.R '
                                         '@SIM@/titan/alleles.tsv @SIM@/titan/tumour.wig '
                                         '@SIM@/titan/normal.wig 2 2.0 0.5 '
                                         '@SIM@/titan/restart_1/cn.tsv '
                                         '@SIM@/titan/restart_1/params.txt',
                                         'Rscript @BIN@/titan_run.R '
                                         '@SIM@/titan/alleles.tsv @SIM@/titan/tumour.wig '
                                         '@SIM@/titan/normal.wig 1 4.0 0.5 '
                                         '@SIM@/titan/restart_2/cn.tsv '
                                         '@SIM@/titan/restart_2/params.txt',
                                         'Rscript @BIN@/titan_run.R '
                                         '@SIM@/titan/alleles.tsv @SIM@/titan/tumour.wig '
                                         '@SIM@/titan/normal.wig 2 4.0 0.5 '
                                         '@SIM@/titan/restart_3/cn.tsv '
                                         '@SIM@/titan/restart_3/params.txt'],
                               'cn': {'rows': 327,
                                      'columns': ['chromosome',
                                                  'start',
                                                  'end',
                                                  'total_1',
                                                  'major_1',
                                                  'minor_1',
                                                  'total_2',
                                                  'major_2',
                                                  'minor_2'],
                                      'sha256': '3c7266c99913e936'},
                               'mix': [0.464546, 0.201473134764, 0.24624512097399998],
                               'evaluation': {'proportion_cn_correct': 0.24433650461917147,
                                              'proportion_dom_cn_correct': 0.44161852025118803,
                                              'proportion_clonal_correct': 0.4087115992503591,
                                              'proportion_subclonal_correct': 0.4087115992503591,
                                              'pred_ploidy': 2.0027418099757863,
                                              'pred_ploidy_1': 2.0073583315645864,
                                              'pred_ploidy_2': 1.9981252883869862,
                                              'pred_proportion_divergent': 0.050781737476801474,
                                              'true_ploidy': 2.515513728719378,
                                              'true_ploidy_1': 2.4948783899293545,
                                              'true_ploidy_2': 2.5361490675094016,
                                              'true_proportion_divergent': 0.34749374450840576,
                                              'brk_cn_correct_proportion': 0.5384615384615384,
                                              'brk_cn_present_num_true': 102.0,
                                              'brk_cn_present_num_pos': 0.0,
                                              'brk_cn_present_num_true_pos': 0.0,
                                              'brk_cn_subclonal_num_true': 68.0,
                                              'brk_cn_subclonal_num_pos': 0.0,
                                              'brk_cn_subclonal_num_true_pos': 0.0,
                                              'mix_true_0': 0.4,
                                              'mix_true_1': 0.4,
                                              'mix_true_2': 0.19999999999999996,
                                              'mix_pred_0': 0.464546,
                                              'mix_pred_1': 0.24624512097399998,
                                              'mix_pred_2': 0.201473134764}},
                     'theta': {'inputs': {'chrom_names.tsv': 'f55f66a6f77cb815',
                                          'counts.tsv': '2d4422c1be21f6c6',
                                          'normal_alleles.tsv': 'ef740181f2051e86',
                                          'tumour_alleles.tsv': 'bf195378d67cd678'},
                               'calls': ['RunTHetA @SIM@/theta/counts.tsv --FORCE '
                                         '--NUM_INTERVALS 15 --OUTPUT_PREFIX '
                                         '@SIM@/theta/theta',
                                         'octave --eval cd @BIN@; '
                                         "runBAFGaussianModel('@SIM@/theta/tumour_alleles.tsv', "
                                         "'@SIM@/theta/normal_alleles.tsv', "
                                         "'@SIM@/theta/counts.tsv', "
                                         "'@SIM@/theta/theta.n3.results', [0,1,2], "
                                         "'@SIM@/theta/theta2', [11,8], 'none')"],
                               'cn': {'rows': 165,
                                      'columns': ['chromosome',
                                                  'start',
                                                  'end',
                                                  'total_1',
                                                  'total_2'],
                                      'sha256': '4992015d5a4d847a'},
                               'mix': [0.464558, 0.321265, 0.214177],
                               'evaluation': {'proportion_cn_correct': 0.25442526058155823,
                                              'proportion_dom_cn_correct': 0.48806322955312914,
                                              'proportion_clonal_correct': 0.4311248996145088,
                                              'proportion_subclonal_correct': 0.4311248996145088,
                                              'pred_ploidy': 1.986751918923344,
                                              'pred_ploidy_1': 1.985814561925869,
                                              'pred_ploidy_2': 1.987689275920819,
                                              'pred_proportion_divergent': 0.04402489127460873,
                                              'true_ploidy': 2.5155137375031456,
                                              'true_ploidy_1': 2.4948783971604676,
                                              'true_ploidy_2': 2.5361490778458236,
                                              'true_proportion_divergent': 0.27766171534884027,
                                              'brk_cn_correct_proportion': 0.5384615384615384,
                                              'brk_cn_present_num_true': 102.0,
                                              'brk_cn_present_num_pos': 0.0,
                                              'brk_cn_present_num_true_pos': 0.0,
                                              'brk_cn_subclonal_num_true': 68.0,
                                              'brk_cn_subclonal_num_pos': 0.0,
                                              'brk_cn_subclonal_num_true_pos': 0.0,
                                              'mix_true_0': 0.4,
                                              'mix_true_1': 0.4,
                                              'mix_true_2': 0.19999999999999996,
                                              'mix_pred_0': 0.464558,
                                              'mix_pred_1': 0.321265,
                                              'mix_pred_2': 0.214177}},
                     'clonehd': {'inputs': {'normal.cna.txt': '043fe463ec19d6d0',
                                            'tumour.cna.txt': '5e004e0c80ff4e44',
                                            'tumour.baf.txt': '3f1e9a26d88ef6bb'},
                                 'calls': ['filterHD --data @SIM@/clonehd/normal.cna.txt '
                                           '--mode 3 --pre @SIM@/clonehd/normal.cna --rnd '
                                           '0',
                                           'filterHD --data @SIM@/clonehd/tumour.cna.txt '
                                           '--mode 3 --pre @SIM@/clonehd/tumour.cna --rnd '
                                           '0',
                                           'filterHD --data @SIM@/clonehd/tumour.cna.txt '
                                           '--mode 3 --pre @SIM@/clonehd/tumour.cna.bias '
                                           '--bias '
                                           '@SIM@/clonehd/normal.cna.posterior-1.txt '
                                           '--sigma 0 --jumps 1 --rnd 0',
                                           'filterHD --data @SIM@/clonehd/tumour.baf.txt '
                                           '--mode 1 --pre @SIM@/clonehd/tumour.baf '
                                           '--sigma 0 --jumps 1 --reflect 1 --dist 1 --rnd '
                                           '0',
                                           'cloneHD --cna @SIM@/clonehd/tumour.cna.txt '
                                           '--baf @SIM@/clonehd/tumour.baf.txt --pre '
                                           '@SIM@/clonehd/tumour --bias '
                                           '@SIM@/clonehd/normal.cna.posterior-1.txt '
                                           '--seed 123 --trials 2 --nmax 3 --force 2 '
                                           '--max-tcn 4 --cna-jumps '
                                           '@SIM@/clonehd/tumour.cna.bias.jumps.txt '
                                           '--baf-jumps @SIM@/clonehd/tumour.baf.jumps.txt '
                                           '--min-jump 0.01 --restarts 10 --mass-gauging '
                                           '1'],
                                 'cn': {'rows': 585,
                                        'columns': ['chromosome',
                                                    'start',
                                                    'end',
                                                    'major_1',
                                                    'minor_1',
                                                    'total_1',
                                                    'major_2',
                                                    'minor_2',
                                                    'total_2'],
                                        'sha256': '1a076c66fbeab6bc'},
                                 'mix': [0.41554100000000005, 0.400844, 0.183615],
                                 'evaluation': {'proportion_cn_correct': 0.16088084121392746,
                                                'proportion_dom_cn_correct': 0.34145724306990466,
                                                'proportion_clonal_correct': 0.4195519308190693,
                                                'proportion_subclonal_correct': 0.4195519308190693,
                                                'pred_ploidy': 2.3335109316531786,
                                                'pred_ploidy_1': 2.394204500998897,
                                                'pred_ploidy_2': 2.27281736230746,
                                                'pred_proportion_divergent': 0.10963545442254068,
                                                'true_ploidy': 2.515812055997883,
                                                'true_ploidy_1': 2.4953441812183312,
                                                'true_ploidy_2': 2.536279930777435,
                                                'true_proportion_divergent': 0.34754929510562865,
                                                'brk_cn_correct_proportion': 0.5384615384615384,
                                                'brk_cn_present_num_true': 102.0,
                                                'brk_cn_present_num_pos': 0.0,
                                                'brk_cn_present_num_true_pos': 0.0,
                                                'brk_cn_subclonal_num_true': 68.0,
                                                'brk_cn_subclonal_num_pos': 0.0,
                                                'brk_cn_subclonal_num_true_pos': 0.0,
                                                'mix_true_0': 0.4,
                                                'mix_true_1': 0.4,
                                                'mix_true_2': 0.19999999999999996,
                                                'mix_pred_0': 0.41554100000000005,
                                                'mix_pred_1': 0.400844,
                                                'mix_pred_2': 0.183615}}}

def read_sim_defs(chromosome_lengths, h_total, N=None, overrides=None):
    """``benchmark/sim_defs.yaml`` on the given chromosomes: ``h_total``,
    and N scaled to their share of the autosomes unless given, the
    settings of ``overrides`` in every simulation; the chromosome lengths
    left to the reference's FASTA index."""
    import yaml
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, 'benchmark', 'sim_defs.yaml')) as f:
        sim_defs = yaml.safe_load(f)
    defaults = sim_defs['defaults']
    share = sum(chromosome_lengths.values()) / float(sum(AUTOSOMES.values()))
    defaults.update(h_total=h_total, chromosomes=list(chromosome_lengths),
                    N=int(round(defaults['N'] * share)) if N is None else N)
    for block in sim_defs['simulations'].values():
        block.update(overrides or {})
    return sim_defs


def make_read_fixture(root, chromosome_lengths, h_total, N=None,
                      with_hdf5=False, sim_overrides=None,
                      genome_version=READ_GENOME_VERSION):
    """The read benchmark's inputs, made from seeds: phase 11's synthetic
    reference with an impute2 panel per chromosome at its SNPs
    (``PANEL_HAPLOTYPES`` haplotypes, with the panel's sample file and
    genetic maps), the sim defs of ``read_sim_defs`` (with
    ``sim_overrides``) and the config, on the build ``genome_version``, as
    files. Returns dict(ref_data_dir, sim_defs, config, config_file,
    times)."""
    ref_dir = os.path.join(root, 'ref')
    panel_dir = os.path.join(ref_dir, 'ALL_1000G_phase1integrated_v3_impute')
    t0 = time.time()
    truth = write_reference(ref_dir, chromosome_lengths,
                            np.random.RandomState(RUN_SEED), with_hdf5)
    panel_rng = np.random.RandomState(PANEL_SEED)
    for chrom, (bases, _, positions, alt, _) in truth.items():
        write_impute_panel(
            panel_dir, chrom, positions + 1,
            list(bases[positions].tobytes().decode()),
            list(alt.tobytes().decode()), PANEL_HAPLOTYPES, panel_rng)
    write_panel_sample(panel_dir, PANEL_HAPLOTYPES)
    sim_defs = read_sim_defs(chromosome_lengths, h_total, N, sim_overrides)
    sim_defs_file = os.path.join(root, 'sim_defs.yaml')
    with open(sim_defs_file, 'w') as f:
        json.dump(sim_defs, f)
    config = dict(reference_config(ref_dir, chromosome_lengths),
                  ensembl_genome_version=genome_version)
    config_file = os.path.join(root, 'config.yaml')
    with open(config_file, 'w') as f:
        json.dump(config, f)
    return dict(ref_data_dir=ref_dir, sim_defs=sim_defs_file, config=config,
                config_file=config_file,
                times={'reference and panel': time.time() - t0})


def write_germline_truth(germline_file, ref_dir, chromosomes):
    """The stand-in phasing tools' truth (``panel_truth_path``) from a
    germline allele store of either package, in either form."""
    from remixt_tpu_torch.simulations.pipeline import load_germline_alleles
    for chrom in chromosomes:
        alleles = load_germline_alleles(germline_file, chrom)
        with open(panel_truth_path(ref_dir, chrom), 'w') as f:
            f.writelines('{}\t{}\t{}\n'.format(*row) for row in zip(
                alleles['position'].tolist(), alleles['is_alt_0'].tolist(),
                alleles['is_alt_1'].tolist()))


def with_germline_truth(simulate, ref_dir):
    """``simulate_germline_alleles`` followed by ``write_germline_truth``:
    the sample's true phase is its simulated germline, known only once
    that task has run, and phasing runs after it."""
    def wrapper(germline_file, params, config, ref_data_dir):
        simulate(germline_file, params, config, ref_data_dir)
        write_germline_truth(germline_file, ref_dir, params['chromosomes'])
    return wrapper


def seqdata_digest(path):
    """A seqdata store's digest: per record type its rows and the sha256
    (first 16 hex digits) of each column over the chromosomes in sorted
    order, as int64."""
    from remixt_tpu_torch import seqdataio
    chromosomes = sorted(seqdataio.read_chromosomes(path))
    digest = {}
    for record_type, columns in seqdataio.COLUMNS.items():
        hashes = {col: hashlib.sha256() for col in columns}
        rows = 0
        for chrom in chromosomes:
            table = seqdataio.read_seq_data(path, record_type, chrom)
            rows += len(table)
            for col in columns:
                hashes[col].update(np.ascontiguousarray(
                    table[col], dtype=np.int64).tobytes())
        digest[record_type] = dict(
            rows=rows, **{col: h.hexdigest()[:16] for col, h in
                          hashes.items()})
    return digest


def read_benchmark_paths(raw):
    """The stores a read benchmark run writes for ``READ_SIM_ID``, in the
    form ``io/store.store_name`` picks."""
    from remixt_tpu_torch.io.store import store_name
    sim_dir = os.path.join(raw, READ_SIM_ID)
    return dict(
        sim_dir=sim_dir, mixture=os.path.join(sim_dir, 'mixture.pickle'),
        seqdata={name: store_name(os.path.join(sim_dir, name))
                 for name in ('normal', 'tumour')},
        counts=os.path.join(sim_dir, 'remixt', 'counts',
                            'sample_tumour.tsv'),
        results=store_name(os.path.join(sim_dir, 'results_remixt')),
        evaluation=store_name(os.path.join(sim_dir, 'evaluation_remixt')),
        tools={tool: dict(
            workdir=os.path.join(sim_dir, tool),
            results=store_name(os.path.join(sim_dir, 'results_' + tool)),
            evaluation=store_name(os.path.join(sim_dir,
                                               'evaluation_' + tool)))
            for tool in READ_TOOLS})


def input_digest(path):
    """The sha256 (first 16 hex digits) of a tool input file with its
    chromosomes' blocks in sorted order (a WIG track's block begins at
    its header, a table's is the run of lines of one first field): the
    wrappers write the chromosomes in the order of a set of names, which
    differs between processes."""
    with open(path, 'rb') as f:
        lines = f.read().splitlines(keepends=True)
    blocks = []
    for line in lines:
        if line.startswith(b'fixedStep'):
            key = line.split(b'chrom=')[1].split()[0]
        elif lines[0].startswith(b'fixedStep'):
            key = blocks[-1][0]
        else:
            key = line.split(b'\t')[0]
        if not blocks or blocks[-1][0] != key or line.startswith(
                b'fixedStep'):
            blocks.append((key, []))
        blocks[-1][1].append(line)
    digest = hashlib.sha256()
    for _, block in sorted(blocks, key=lambda kv: kv[0]):
        digest.update(b''.join(block))
    return digest.hexdigest()[:16]


def tool_calls_of(calls, tool, places):
    """A tool's stand-in calls among ``calls`` (lines of the call log),
    each path under a directory of ``places`` ({directory: placeholder})
    written with the placeholder."""
    out = []
    for call in calls:
        if call.split(' ', 1)[0] in TOOL_STANDINS[tool]:
            for directory, placeholder in places.items():
                call = call.replace(os.path.abspath(directory), placeholder)
            out.append(call)
    return out


def tool_record(paths, calls, places):
    """What a read benchmark run made of one external tool (``paths``: its
    work directory, results and evaluation stores, of either package):
    the digests of the files its wrapper wrote for it (``input_digest``),
    its stand-in calls (``tool_calls_of``), its results store's cn table
    (rows, columns, the sha256 of its rows' text) and mix, and its
    evaluation's metrics."""
    from remixt_tpu_torch.io.store import read_store
    tool = os.path.basename(paths['workdir'])
    results = read_store(paths['results'])
    cn = results['cn']
    text = '\n'.join('\t'.join(str(v) for v in row)
                     for row in zip(*(cn[c].tolist() for c in cn.columns)))
    return dict(
        inputs={name: input_digest(os.path.join(paths['workdir'], name))
                for name in TOOL_INPUTS[tool]},
        calls=tool_calls_of(calls, tool, places),
        cn=dict(rows=len(cn), columns=cn.columns,
                sha256=hashlib.sha256(text.encode()).hexdigest()[:16]),
        mix=results['mix'].values.tolist(),
        evaluation=evaluation_metrics(read_store(paths['evaluation'])))


def check_tool_record(label, tool, got, want):
    """A tool's record (``tool_record``) against the JAX package's: all of
    it equal, the evaluation's metrics at rtol 1e-12."""
    for key in ('inputs', 'calls', 'cn', 'mix'):
        if got[key] != want[key]:
            raise AssertionError('{}: {}\'s {} are not the JAX package\'s: '
                                 '{} against {}'.format(label, tool, key,
                                                        got[key], want[key]))
    metrics = want['evaluation']
    if sorted(got['evaluation']) != sorted(metrics) or not all(np.isclose(
            got['evaluation'][k], v, rtol=1e-12, atol=0)
            for k, v in metrics.items()):
        raise AssertionError('{}: {}\'s evaluation is not the JAX '
                             'package\'s: {} against {}'.format(
                                 label, tool, got['evaluation'], metrics))


def read_benchmark(label, root, chromosome_lengths, h_total, N=None):
    """The read benchmark's inputs made in ``root``, its reference built
    from them by the port's ``create_ref_data`` (``build_read_reference``),
    then its runner
    (``remixt_tpu_torch.benchmark.run_read_benchmark.main``) on them with
    ``--tools remixt`` and READ_TOOLS: the fit on the card at the default
    config, the external callers through their stand-ins (``caller_config``;
    THetA on READ_THETA_WINDOW windows), the stand-in tools first on the
    PATH, the phasing tools' truth written from the simulated germline
    alleles. Returns dict(fixture, table, the paths of
    ``read_benchmark_paths``, times {step: [seconds]}, waves, launches,
    whole, calls (the callers' stand-in calls), places ({directory:
    placeholder} for ``tool_record``))."""
    import torch
    from remixt_tpu_torch.benchmark import run_read_benchmark
    from remixt_tpu_torch.io import store
    from remixt_tpu_torch.simulations import pipeline as sim_pipeline

    fresh_directory(root)
    fixture = make_read_fixture(os.path.join(root, 'inputs'),
                                chromosome_lengths, h_total, N=N)
    log('{}: inputs made: reference and impute2 panel of {} chromosomes '
        '({:.1f} Mb) in {:.1f} s; h_total {}'.format(
            label, len(chromosome_lengths),
            sum(chromosome_lengths.values()) / 1e6,
            fixture['times']['reference and panel'], h_total))
    mirror_dir = os.path.join(root, 'mirror')
    bin_dir = write_standin_tools(os.path.join(root, 'bin'), mirror_dir)
    fixture = build_read_reference(label, fixture, chromosome_lengths,
                                   os.path.join(root, 'built'), bin_dir,
                                   mirror_dir)
    segments = write_window_segments(
        os.path.join(root, 'inputs', 'theta_segments.tsv'),
        chromosome_lengths, READ_THETA_WINDOW)
    fixture['config'] = dict(fixture['config'],
                             **caller_config(bin_dir, segments))
    with open(fixture['config_file'], 'w') as f:
        json.dump(fixture['config'], f)
    raw = os.path.join(root, 'raw')
    table = store.store_name(os.path.join(root, 'evaluation'))
    argv = [fixture['ref_data_dir'], fixture['sim_defs'], raw, table,
            '--config', fixture['config_file'],
            '--tools', 'remixt'] + list(READ_TOOLS)
    patches = [
        (sim_pipeline, 'simulate_germline_alleles', with_germline_truth(
            sim_pipeline.simulate_germline_alleles, fixture['ref_data_dir']))]
    tool_calls(bin_dir)
    with instrumented(READ_STEPS, patches) as (stages, marks), \
            first_on_path(bin_dir):
        torch.cuda.reset_peak_memory_stats()
        reset_chain_launches()
        t0 = time.time()
        run_read_benchmark.main(argv)
        whole = time.time() - t0
        launches = chain_launches()
    paths = read_benchmark_paths(raw)
    return dict(fixture=fixture, table=table, times=stages,
                waves=np.diff(marks).tolist(), launches=launches,
                whole=whole, calls=tool_calls(bin_dir),
                places={bin_dir: '@BIN@', paths['sim_dir']: '@SIM@'},
                **paths)


def results_cli(label, results, out_dir):
    """``write_results`` and ``visualize_solutions`` through
    ``ui.main.main`` on a results store. The solution written is the
    workflow's chosen one (``optimal_init_id``), and the report's ``best``
    is the restart of the highest ELBO, which is the chosen one unless
    that restart is divergent beyond ``max_prop_diverge``. Returns the
    seconds of each."""
    import yaml
    from remixt_tpu_torch.analysis.pipeline import optimal_init_id
    from remixt_tpu_torch.io.store import read_store
    from remixt_tpu_torch.io.table import read_tsv
    from remixt_tpu_torch.ui import main as cli

    os.makedirs(out_dir, exist_ok=True)
    cn, brk_cn, meta, html = (os.path.join(out_dir, name) for name in (
        'cn.tsv', 'brk_cn.tsv', 'meta.yaml', 'solutions.html'))
    t0 = time.time()
    cli.main(['write_results', results, cn, brk_cn, meta])
    t_write = time.time() - t0
    t0 = time.time()
    cli.main(['visualize_solutions', results, html])
    t_report = time.time() - t0

    tables = read_store(results, keys=['stats', 'cn'])
    stats = tables['stats']
    with open(meta) as f:
        metadata = yaml.safe_load(f)
    chosen = int(optimal_init_id(stats, {}))
    if metadata['init_id'] != chosen:
        raise AssertionError('{}: write_results wrote solution {}, the '
                             'workflow chose {}'.format(
                                 label, metadata['init_id'], chosen))
    written = read_tsv(cn, str_columns=('chromosome',))
    if written.columns != tables['cn'].columns or \
            len(written) != len(tables['cn']):
        raise AssertionError('{}: the cn TSV is not the chosen solution\'s '
                             'table'.format(label))
    with open(html) as f:
        report = json.loads(f.read().split('const DATA = ', 1)[1].split(
            ';\n', 1)[0])
    top = int(stats['init_id'][np.nanargmax(stats['elbo'])])
    if report['best'] != str(top) or str(top) not in report['solutions']:
        raise AssertionError('{}: the report\'s best is {}, the highest '
                             'ELBO restart {}'.format(label, report['best'],
                                                      top))
    if top != chosen and stats['proportion_divergent'][
            list(stats['init_id']).index(top)] < 0.5:
        raise AssertionError('{}: the report\'s best {} is not the chosen '
                             'solution {}'.format(label, top, chosen))
    log('{}: write_results {:.3f} s wrote solution {} (the workflow\'s '
        'choice; {} segments); visualize_solutions {:.3f} s, a report of '
        '{:.1f} kB, {} solutions embedded, best {}{}'.format(
            label, t_write, chosen, len(written), t_report,
            os.path.getsize(html) / 1e3, len(report['solutions']),
            report['best'], '' if top == chosen else
            ' (the highest ELBO, divergent beyond 0.5)'))
    return {'write_results': t_write, 'visualize_solutions': t_report}


def check_shapeit2_phasing(label, sim_dir, chromosomes):
    """That the run phased every chromosome through shapeit's stand-in:
    one shapeit graph a chromosome, made with the reference's seed, and no
    shapeit4 graph. Returns the graphs' count."""
    graphs, bingraphs = [], []
    for directory, _, files in os.walk(sim_dir):
        if 'phased.hgraph' in files:
            graphs.append(os.path.join(directory, 'phased.hgraph'))
        if 'phasing.bingraph' in files:
            bingraphs.append(os.path.join(directory, 'phasing.bingraph'))
    if len(graphs) != len(chromosomes) or bingraphs:
        raise AssertionError('{}: {} shapeit graphs and {} shapeit4 graphs '
                             'for {} chromosomes'.format(
                                 label, len(graphs), len(bingraphs),
                                 len(chromosomes)))
    for path in graphs:
        with open(path + '.log') as f:
            argv = f.read()
        if not argv.startswith('shapeit stand-in -M ') or \
                not argv.rstrip().endswith('--seed 12345'):
            raise AssertionError('{}: {} is not the shapeit graph call: '
                                 '{}'.format(label, path, argv))
    return len(graphs)


def phase_read_benchmark(smi):
    """Phase 12: the read benchmark over RUN_CHROMOSOMES at READ_H_TOTAL on
    a GRCh37 reference (READ_GENOME_VERSION), phased through shapeit's
    stand-in, the fit on the card, TITAN, THetA2 and cloneHD through their
    wrappers and stand-ins (each held to ``READ_JAX['tools']``), the four
    evaluations merged; then the results CLI on ReMixT's results store.
    Returns the fb_grouped launches."""
    import torch
    from remixt_tpu_torch import config as config_mod
    from remixt_tpu_torch.io.store import read_store

    if READ_JAX is None:
        raise AssertionError('phase 12: READ_JAX is not set; run python '
                             'tests/test_torch_read_benchmark.py --phase12 '
                             'WORKDIR')
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, 'build', 'chip_smoke', 'read')
    t_phase = time.time()
    peak = HostPeak()
    run = read_benchmark('phase 12', root, RUN_CHROMOSOMES, READ_H_TOTAL)
    device_gb = torch.cuda.max_memory_allocated() / 1e9
    log_run_steps('phase 12', run)
    build = run['fixture']['config']['ensembl_genome_version']
    graphs = check_shapeit2_phasing('phase 12', run['sim_dir'],
                                    RUN_CHROMOSOMES)
    log('phase 12: phased through the shapeit stand-in '
        '(ensembl_genome_version {}): {} graphs, {} draws each; phasing '
        '{:.1f} s of the read benchmark\'s {:.1f} s; {}'.format(
            build, graphs, config_mod.get_param({}, 'shapeit_num_samples'),
            sum(run['times']['phase']), run['whole'], smi))

    for sample, path in run['seqdata'].items():
        digest = seqdata_digest(path)
        if digest != READ_JAX['seqdata'][sample]:
            raise AssertionError('phase 12: the {} seqdata is not the JAX '
                                 'package\'s: {} against {}'.format(
                                     sample, digest,
                                     READ_JAX['seqdata'][sample]))
        log('phase 12: {} seqdata ({}) is the JAX package\'s for the same '
            'seed: {} fragments, {} allele reads'.format(
                sample, 'HDF5' if path.endswith('.h5') else '.npy directory',
                digest['fragments']['rows'], digest['alleles']['rows']))
    digest = check_counts_digest('phase 12', run['counts'],
                                 READ_JAX['counts'])
    log('phase 12: the count table ({} segments, {} reads) is the JAX '
        'package\'s'.format(digest['rows'],
                             int(digest['floats']['readcount'][0])))

    stats = read_store(run['results'], keys=['stats'])['stats']
    restarts = len(stats['init_id'])
    if restarts != READ_JAX['restarts']:
        raise AssertionError('phase 12: init\'s grid has {} restarts, the '
                             'JAX package\'s {}'.format(
                                 restarts, READ_JAX['restarts']))
    sweeps = (config_mod.get_param({}, 'num_em_iter')
              * config_mod.get_param({}, 'num_update_iter'))
    expected = -(-restarts // WAVE) * sweeps
    expect_launches('phase 12', run['launches'], 'fb_grouped', expected)
    if not np.all(np.isfinite(stats['elbo'])):
        raise AssertionError('phase 12: non-finite ELBO')
    log('phase 12: grid of {} restarts in {} waves, fb_grouped launches {}'
        .format(restarts, len(run['waves']), expected))

    with open(run['mixture'], 'rb') as f:
        mixture = pickle.load(f)
    check_chosen_restart('phase 12', mixture, read_store(run['results']),
                         READ_JAX)
    merged = read_store(run['table'])
    if len(merged.get('simulations', ())) != 1:
        raise AssertionError('phase 12: the merged evaluation has no row of '
                             'the simulation')
    tools = ['remixt'] + list(READ_TOOLS)
    for name in ('cn_evaluation', 'brk_cn_evaluation', 'mix_results'):
        if name not in merged or merged[name]['tool'].tolist() != tools:
            raise AssertionError('phase 12: the merged evaluation\'s {} has '
                                 'not one row for each of {}'.format(
                                     name, tools))
    if 'tools' not in READ_JAX:
        raise AssertionError('phase 12: READ_JAX has no tools; run python '
                             'tests/test_torch_read_benchmark.py --phase12 '
                             'WORKDIR --tools')
    for tool in READ_TOOLS:
        record = tool_record(run['tools'][tool], run['calls'], run['places'])
        check_tool_record('phase 12', tool, record, READ_JAX['tools'][tool])
        steps = {stage: sum(run['times'].get('{} {}'.format(tool, stage),
                                             [0.0]))
                 for stage in ('prepare', 'run', 'report')}
        log('phase 12: {}: its {} input files, {} stand-in calls, results '
            '({} segments, mix {}) and evaluation (proportion_cn_correct '
            '{:.4f}) are the JAX package\'s; prepare {:.3f} s, run {:.3f} '
            's, report {:.3f} s'.format(
                tool, len(record['inputs']), len(record['calls']),
                record['cn']['rows'], record['mix'],
                record['evaluation']['proportion_cn_correct'],
                steps['prepare'], steps['run'], steps['report']))
    log('phase 12: the merged evaluation has one row for each of {}; the '
        'external tools ran on the host: fb_grouped launches stay {}'.format(
            ', '.join(tools), expected))
    cli_times = results_cli('phase 12', run['results'],
                            os.path.join(root, 'results_cli'))
    log('phase 12 ({}): read benchmark {:.1f} s, results CLI {:.1f} s, '
        'phase {:.1f} s; max_memory_allocated {:.3f} GB; host peak RSS '
        '{:.3f} GB ({}); {}'.format(
            build, run['whole'], sum(cli_times.values()),
            time.time() - t_phase, device_gb, peak.stop(),
            'sampled every 50 ms since the phase began',
            smi))
    return expected


# ---------------------------------------------------------------------------
# phase 14: the reference build on GRCh38 and the bwa mappability workflow
# ---------------------------------------------------------------------------

# phase 14's synthetic genome (``refbuild_genome``), made from REFBUILD_SEED
REFBUILD_CHROMOSOMES = {'1': 240000, '2': 180000, 'X': 120000}
REFBUILD_SEED = 14
# the k-mer length (the defaults' mappability_length) and the lines of the
# k-mer FASTA a chunk of the mappability workflow (50,000 k-mers; the
# defaults' 4,000,000 lines would make one chunk of this genome)
REFBUILD_K = 100
REFBUILD_CHUNK_LINES = 100000
# what the JAX package makes of phase 14's mirror on the CPU (``python
# tests/test_torch_ref_data.py --phase14 WORKDIR`` and ``python
# tests/test_torch_mappability.py --phase14 WORKDIR``): the digest of its
# create_ref_data directory (``tree_digest``), and of its mappability store
# (``store_digest``) with the chunks whose create_bedgraph raises left out
# (``empty_chunks``: the chunks that lie wholly in the second copy of the
# planted repeat, where no k-mer realigns to its origin)
REFBUILD_JAX = {
    'create_ref_data': {
        '1kGP_high_coverage_Illumina.chr1.filtered.SNV_INDEL_SV_phased_panel.bcf':
            'd232233c90d5b23c',
        '1kGP_high_coverage_Illumina.chr1.filtered.SNV_INDEL_SV_phased_panel.bcf.csi':
            'e3b0c44298fc1c14',
        '1kGP_high_coverage_Illumina.chr1.filtered.SNV_INDEL_SV_phased_panel.vcf.gz':
            '20c0b151fedcf3eb',
        '1kGP_high_coverage_Illumina.chr2.filtered.SNV_INDEL_SV_phased_panel.bcf':
            'ae941cff78a426d9',
        '1kGP_high_coverage_Illumina.chr2.filtered.SNV_INDEL_SV_phased_panel.bcf.csi':
            'e3b0c44298fc1c14',
        '1kGP_high_coverage_Illumina.chr2.filtered.SNV_INDEL_SV_phased_panel.vcf.gz':
            '8f389edd2cee78a5',
        '1kGP_high_coverage_Illumina.chrX.filtered.SNV_INDEL_SV_phased_panel.bcf':
            '2d9d77d9f0ad6225',
        '1kGP_high_coverage_Illumina.chrX.filtered.SNV_INDEL_SV_phased_panel.bcf.csi':
            'e3b0c44298fc1c14',
        '1kGP_high_coverage_Illumina.chrX.filtered.SNV_INDEL_SV_phased_panel.vcf.gz':
            '3280e9d95288d636',
        'Homo_sapiens.GRCh38.93.dna.chromosomes.fa':
            'a23bf38a171fae26',
        'Homo_sapiens.GRCh38.93.dna.chromosomes.fa.amb':
            'e3b0c44298fc1c14',
        'Homo_sapiens.GRCh38.93.dna.chromosomes.fa.ann':
            'e3b0c44298fc1c14',
        'Homo_sapiens.GRCh38.93.dna.chromosomes.fa.bwt':
            'e3b0c44298fc1c14',
        'Homo_sapiens.GRCh38.93.dna.chromosomes.fa.fai':
            '649f20d5b4a2a2bb',
        'Homo_sapiens.GRCh38.93.dna.chromosomes.fa.pac':
            'e3b0c44298fc1c14',
        'Homo_sapiens.GRCh38.93.dna.chromosomes.fa.sa':
            'e3b0c44298fc1c14',
        'chr1.b38.gmap.gz':
            '29135251a232bbbd',
        'chr2.b38.gmap.gz':
            '1bae3dce738d2cc0',
        'chrX.b38.gmap.gz':
            '0fd9c18feea6b3af',
        'hg38_gap.txt.gz':
            'eed3b92a8ed86f49',
        'sentinal':
            'e3b0c44298fc1c14',
        'sentinal.bwa_index':
            'e3b0c44298fc1c14',
        'sentinal.convert_bcf':
            'e3b0c44298fc1c14',
        'sentinal.create_snp_positions':
            'e3b0c44298fc1c14',
        'sentinal.get_genetic_maps':
            'e3b0c44298fc1c14',
        'sentinal.samtools_faidx':
            'e3b0c44298fc1c14',
        'sentinal.wget_gap_table':
            'e3b0c44298fc1c14',
        'sentinal.wget_genome_fasta':
            'e3b0c44298fc1c14',
        'sentinal.wget_thousand_genomes':
            'e3b0c44298fc1c14',
        'thousand_genomes_snps.tsv':
            'b47b8321946fbd0c',
        'tmp/dna.assembly.chromosome.1.fa':
            '2e22afb0f5dfc239',
        'tmp/dna.assembly.chromosome.2.fa':
            '0571af23ee689b58',
        'tmp/dna.assembly.chromosome.X.fa':
            'ae0936f5cdafcee8'},
    'mappability': {
        '1': {'rows': 10, 'start': '1a406b3a36b7b34d',
              'end': 'f5caf2b4c1852a25',
              'quality': '44adec403a800d82'},
        '2': {'rows': 6, 'start': '378b7746d43c2dee',
              'end': '67e4df6068d1b842',
              'quality': 'b9548bf90252aeed'},
        'X': {'rows': 6, 'start': '60c97425f5e2d2db',
              'end': '06d1c578dcbfb4a5',
              'quality': 'edd2aba94bbbd191'}},
    'empty_chunks': [6]}


def refbuild_genome():
    """Phase 14's genome, made from REFBUILD_SEED: {chromosome: bases}
    (bytes, upper and lower case) of REFBUILD_CHROMOSOMES, and its gaps
    [(chromosome, start, end, type)] (runs of N). Chromosome 2 holds a
    copy of 110 kb of chromosome 1, which is soft-masked there (lower
    case), and a copy of 3 kb of it; X a tandem repeat of 40 units of 50
    bases and a soft-masked stretch."""
    rng = np.random.RandomState(REFBUILD_SEED)
    acgt = np.frombuffer(b'ACGT', dtype=np.uint8)
    genome = {chrom: acgt[rng.choice(4, length, p=[0.3, 0.2, 0.2, 0.3])]
              for chrom, length in REFBUILD_CHROMOSOMES.items()}
    one, two, x = genome['1'], genome['2'], genome['X']
    two[40000:150000] = one[60000:170000]
    two[160000:163000] = one[200000:203000]
    one[60000:170000] += 32
    x[30000:32000] = np.tile(x[30000:30050], 40)
    x[90000:100000] += 32
    gaps = [('1', 0, 5000, 'telomere'), ('1', 220000, 222500, 'contig'),
            ('2', 0, 5000, 'telomere'), ('2', 170000, 171000, 'contig'),
            ('X', 0, 5000, 'telomere'), ('X', 80000, 83000, 'contig')]
    for chrom, start, end, _ in gaps:
        genome[chrom][start:end] = ord('N')
    return {chrom: bases.tobytes() for chrom, bases in genome.items()}, gaps


def refbuild_config(built_dir, mappability):
    """Phase 14's config: the GRCh38 build of its chromosomes, their 1000
    Genomes panels, REFBUILD_K and the mappability store ``mappability``
    under ``built_dir``."""
    config = build_config('GRCh38', REFBUILD_CHROMOSOMES)
    config.update(grch38_1kg_chromosomes=['chr' + c
                                          for c in REFBUILD_CHROMOSOMES],
                  mappability_length=REFBUILD_K,
                  mappability_filename=os.path.join(built_dir, mappability))
    return config


def write_refbuild_mirror(mirror):
    """Phase 14's upstream sources in ``mirror``, made from REFBUILD_SEED:
    the genome's Ensembl FASTAs, its gap table, a 1000 Genomes VCF a
    chromosome (a SNP about every 700 bases, some multi-allelic, indels,
    symbolic alleles and SNPs in gaps among them; X under its own name)
    and the genetic maps' tarball. Returns the genome and its gaps."""
    import tempfile
    genome, gaps = refbuild_genome()
    write_fasta_mirror(mirror, 'GRCh38', [
        (chrom, len(bases), fasta_lines(bases))
        for chrom, bases in genome.items()])
    write_gap_mirror(mirror, [(i, chrom, start, end, i + 1, kind, 'no')
                              for i, (chrom, start, end, kind)
                              in enumerate(gaps)])
    rng = np.random.RandomState(REFBUILD_SEED + 1)
    for chrom, bases in genome.items():
        name = ('1kGP_high_coverage_Illumina.chr{}.filtered.SNV_INDEL_SV_'
                'phased_panel{}.vcf.gz'.format(chrom,
                                               '.v2' if chrom == 'X' else ''))
        positions = np.arange(1000, len(bases) - 1000, 700)
        positions += rng.randint(0, 300, len(positions))
        with gzip_writer(os.path.join(mirror, name), 'wt') as f:
            f.write('##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\t'
                    'QUAL\tFILTER\tINFO\tFORMAT\tHG00096\n')
            for i, pos in enumerate(positions.tolist()):
                ref = chr(bases[pos - 1]).upper()
                alts = [b for b in 'ACGT' if b != ref]
                alt = alts[rng.randint(0, len(alts))]
                if i % 11 == 3:
                    alt += ',' + alts[0]
                elif i % 13 == 5:
                    ref, alt = ref + chr(bases[pos]).upper(), ref
                elif i % 17 == 7:
                    alt = '<DEL>'
                f.write('chr{}\t{}\t.\t{}\t{}\t.\tPASS\t.\tGT\t0|1\n'
                        .format(chrom, pos, ref, alt))
    with tempfile.TemporaryDirectory(dir=mirror) as maps:
        members = []
        for chrom, bases in genome.items():
            path = os.path.join(maps, 'chr{}.b38.gmap.gz'.format(chrom))
            with gzip_writer(path, 'wt') as f:
                f.write('pos\tchr\tcM\n')
                f.writelines('{}\t{}\t{!r}\n'.format(p, chrom, p / 1e6)
                             for p in range(1, len(bases), 10000))
            members.append((path, os.path.basename(path)))
        write_tar_mirror(os.path.join(mirror, 'genetic_maps.b38.tar.gz'),
                         members)
    return genome, gaps


def unique_kmer_truth(genome, k):
    """{chromosome: 0/1 per position}: 1 where the k-mer starting there
    (upper case) holds no N and occurs once in the genome; what the
    ``bwa`` stand-in's alignments make the mappability indicator."""
    import collections
    upper = {chrom: bases.upper() for chrom, bases in genome.items()}
    counts = collections.Counter(
        bases[p:p + k] for bases in upper.values()
        for p in range(len(bases) - k + 1))
    truth = {}
    for chrom, bases in upper.items():
        flags = np.zeros(len(bases), dtype=np.uint8)
        flags[:len(bases) - k + 1] = [
            counts[bases[p:p + k]] == 1 and b'N' not in bases[p:p + k]
            for p in range(len(bases) - k + 1)]
        truth[chrom] = flags
    return truth


def store_arrays(path):
    """{chromosome: {column: int64 array}} of a mappability store, the
    JAX package's HDF5 file or the port's directory."""
    from remixt_tpu_torch.mappability.tasks import STORE_COLUMNS
    if path.endswith('.h5'):
        import h5py
        with h5py.File(path, 'r') as store:
            return {group[len('chromosome_'):]: {
                column: store[group][column][()] for column in STORE_COLUMNS}
                for group in store}
    return {group[len('chromosome_'):]: {
        column: np.load(os.path.join(path, group, column + '.npy'))
        for column in STORE_COLUMNS} for group in sorted(os.listdir(path))}


def store_digest(path):
    """A mappability store's digest: per chromosome its rows and the
    sha256 (first 16 hex digits) of each column as int64."""
    return {chrom: dict(rows=len(columns['start']), **{
        column: hashlib.sha256(np.ascontiguousarray(
            values, dtype=np.int64).tobytes()).hexdigest()[:16]
        for column, values in columns.items()})
        for chrom, columns in sorted(store_arrays(path).items())}


@contextlib.contextmanager
def host_timers(targets):
    """Swaps the module functions of ``targets`` ((module under
    ``remixt_tpu_torch``, name, label)) for wrappers that append their
    wall time to ``stages[label]``; yields ``stages`` and puts every
    function back."""
    import importlib
    stages, originals = {}, []
    for module, name, label in targets:
        module = importlib.import_module('remixt_tpu_torch.' + module)
        fn = getattr(module, name)

        def wrapper(*args, _fn=fn, _label=label, **kwargs):
            t0 = time.time()
            out = _fn(*args, **kwargs)
            stages.setdefault(_label, []).append(time.time() - t0)
            return out
        originals.append((module, name, fn))
        setattr(module, name, wrapper)
    try:
        yield stages
    finally:
        for module, name, fn in reversed(originals):
            setattr(module, name, fn)


MAPPABILITY_STEPS = (
    ('mappability.tasks', 'create_kmers', 'create_kmers'),
    ('mappability.bwa.workflow', '_align_and_bedgraph', 'align_and_bedgraph'),
    ('mappability.bwa.workflow', '_bwa_mem_to_file', 'bwa mem'),
    ('mappability.tasks', 'create_bedgraph', 'create_bedgraph'),
    ('mappability.tasks', 'merge_files_by_line', 'merge_bedgraph'),
)


def mappability_cli(built_dir, config_file, bin_dir):
    """``mappability_bwa`` through ``ui.main.main`` with
    REFBUILD_CHUNK_LINES lines a chunk and the stand-ins of ``bin_dir``
    first on the PATH. Returns {step: [seconds]} and the whole call's
    seconds."""
    from remixt_tpu_torch.mappability.bwa import workflow as bwa_workflow
    from remixt_tpu_torch.ui import main as cli
    chunk_lines = bwa_workflow.KMERS_PER_CHUNK
    bwa_workflow.KMERS_PER_CHUNK = REFBUILD_CHUNK_LINES
    try:
        with host_timers(MAPPABILITY_STEPS) as stages, \
                first_on_path(bin_dir):
            check_standin_wget(bin_dir)
            t0 = time.time()
            cli.main(['mappability_bwa', built_dir, '--config', config_file])
            whole = time.time() - t0
    finally:
        bwa_workflow.KMERS_PER_CHUNK = chunk_lines
    return stages, whole


def tool_calls(bin_dir):
    """The calls the stand-ins of ``bin_dir`` logged since the last look,
    emptying the log."""
    path = os.path.join(bin_dir, STANDIN_CALLS)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        calls = f.read().splitlines()
    os.remove(path)
    return calls


def phase_reference_build(smi, root=None):
    """Phase 14 (in ``root``, by default under ``build/chip_smoke``): on
    phase 14's genome, ``create_ref_data`` on GRCh38 (the genome's FASTA,
    gap table, bwa and samtools indexes, VCFs converted to BCFs, SNP
    positions and genetic maps) through ``ui.main.main``, its directory
    equal to the JAX package's (``REFBUILD_JAX``); then ``mappability_bwa``
    on the built reference at REFBUILD_K with REFBUILD_CHUNK_LINES a
    chunk, its store a directory, whose indicator must be the stand-in's
    truth at every
    position and whose arrays must be the JAX package's, the chunks of the
    repeat's second copy giving empty bedgraphs; both again must call no
    tool. Host only; prints each step's wall time and the peak resident
    set. Returns the digests."""
    from remixt_tpu_torch.analysis.gcbias import read_mappability_indicator

    here = os.path.dirname(os.path.abspath(__file__))
    root = root or os.path.join(here, 'build', 'chip_smoke', 'refbuild')
    fresh_directory(root)
    peak = HostPeak()
    t_phase = time.time()
    mirror = os.path.join(root, 'mirror')
    genome, gaps = write_refbuild_mirror(mirror)
    mirror_s = time.time() - t_phase
    bin_dir = write_standin_tools(os.path.join(root, 'bin'), mirror)
    built = os.path.join(root, 'built')
    config = refbuild_config(built, 'hg38.{}.bwa.mappability'.format(
        REFBUILD_K))
    steps, build_s, config_file = create_ref_data_cli(built, config,
                                                      bin_dir)
    digest = tree_digest(built)
    if digest != REFBUILD_JAX['create_ref_data']:
        raise AssertionError('phase 14: the create_ref_data directory is not '
                             'the JAX package\'s: {} against {}'.format(
                                 digest, REFBUILD_JAX['create_ref_data']))
    calls = tool_calls(bin_dir)
    log('phase 14: create_ref_data (GRCh38, {} chromosomes, {:.0f} kb, {} '
        'gaps; mirror {:.2f} s) {:.2f} s, equal to the JAX package\'s '
        '({} files, {} tool calls): {}'.format(
            len(genome), sum(map(len, genome.values())) / 1e3, len(gaps),
            mirror_s, build_s, len(digest), len(calls), ', '.join(
                '{} {:.2f} s'.format(name, sec) for name, sec, _ in steps)))

    stages, map_s = mappability_cli(built, config_file, bin_dir)
    calls = tool_calls(bin_dir)
    tmp = os.path.join(built, 'mappability_bwa_tmp')
    bedgraphs = sorted((int(name[len('bedgraph_'):-len('.tsv')]),
                        os.path.getsize(os.path.join(tmp, name)))
                       for name in os.listdir(tmp)
                       if name.startswith('bedgraph_'))
    empty = [chunk for chunk, size in bedgraphs if size == 0]
    aligned = [call for call in calls if call.startswith('bwa mem')]
    if empty != REFBUILD_JAX['empty_chunks'] or len(aligned) != len(bedgraphs):
        raise AssertionError('phase 14: empty bedgraphs of chunks {} of {} '
                             '({} bwa mem calls), the JAX run raised on {}'
                             .format(empty, len(bedgraphs), len(aligned),
                                     REFBUILD_JAX['empty_chunks']))
    store = config['mappability_filename']
    truth = unique_kmer_truth(genome, REFBUILD_K)
    for chrom, flags in truth.items():
        indicator = read_mappability_indicator(store, chrom, len(flags), 1)
        if not np.array_equal(indicator, flags):
            raise AssertionError('phase 14: chromosome {}\'s mappability '
                                 'differs from the truth at {} positions'
                                 .format(chrom, int(np.sum(indicator
                                                           != flags))))
    mappability = store_digest(store)
    if mappability != REFBUILD_JAX['mappability']:
        raise AssertionError('phase 14: the mappability store is not the JAX '
                             'package\'s: {} against {}'.format(
                                 mappability, REFBUILD_JAX['mappability']))
    log('phase 14: mappability_bwa (k={}, {} chunks of {} k-mers, chunks {} '
        'wholly repeat: empty bedgraphs) {:.2f} s: {}; its indicator is the '
        'truth at all {} positions ({} unique), its arrays the JAX '
        'package\'s ({} intervals)'.format(
            REFBUILD_K, len(bedgraphs), REFBUILD_CHUNK_LINES // 2, empty,
            map_s, ', '.join('{} {:.2f} s'.format(
                label, sum(stages.get(label, [])))
                for _, _, label in MAPPABILITY_STEPS),
            sum(map(len, truth.values())),
            int(sum(f.sum() for f in truth.values())),
            sum(c['rows'] for c in mappability.values())))

    t0 = time.time()
    create_ref_data_cli(built, config, bin_dir)
    mappability_cli(built, config_file, bin_dir)
    rerun_s = time.time() - t0
    calls = tool_calls(bin_dir)
    if calls:
        raise AssertionError('phase 14: the rerun called {}'.format(calls))
    log('phase 14: both again in {:.2f} s, no tool called; phase {:.1f} s, '
        'host peak RSS {:.3f} GB (sampled every 50 ms since the phase '
        'began, {:.3f} GB at its start); {}'.format(
            rerun_s, time.time() - t_phase, peak.stop(), peak.start / 1e9,
            smi))
    return dict(create_ref_data=digest, mappability=mappability,
                empty_chunks=empty)


# ---------------------------------------------------------------------------
# phase 13: the multi-tumour run CLI, one cohort fit on the card
# ---------------------------------------------------------------------------

# the tumour samples of phase 13: phase 11's and a second region of the
# same tumour, its two clones' fractions swapped (``make_run_fixture``)
COHORT = ('tumour', 'tumour_b')

# what the JAX package makes of phase 13's inputs on the CPU (``python
# tests/test_torch_cohort.py --phase13 WORKDIR``), per tumour what
# ``RUN_JAX`` holds for phase 11's one
COHORT_JAX = {'tumour': {'counts': {'rows': 551,
                                    'columns': ['chromosome',
                                                'start',
                                                'end',
                                                'readcount',
                                                'allele_b_readcount',
                                                'allele_a_readcount',
                                                'major_readcount',
                                                'minor_readcount',
                                                'major_is_allele_a',
                                                'bias',
                                                'length'],
                                    'ints': {'chromosome': '3e316fd309216215',
                                             'start': 'bebdc95662a32ae9',
                                             'end': '67f47485e7eea11c',
                                             'allele_b_readcount': 'a4a2abc34a9cd350',
                                             'allele_a_readcount': 'a04311ebef438d10',
                                             'major_readcount': 'c5e1dc134bd0f2cf',
                                             'minor_readcount': 'e4e9f533f4b94235',
                                             'major_is_allele_a': '6c4df12b4ca6c10b'},
                                    'floats': {'readcount': [1558638.0,
                                                             441475513.0],
                                               'bias': [0.9999999999999734,
                                                        272.8879090214796],
                                               'length': [161175535.0,
                                                          43982854731.56945]}},
                         'segments': 551,
                         'evaluation': {'proportion_cn_correct': 0.0,
                                        'proportion_dom_cn_correct': 0.0,
                                        'proportion_clonal_correct': 0.5724340235631915,
                                        'proportion_subclonal_correct': 0.5724340235631915,
                                        'pred_ploidy': 4.708467780175199,
                                        'pred_ploidy_1': 4.855205406949634,
                                        'pred_ploidy_2': 4.561730153400763,
                                        'pred_proportion_divergent': 0.403190754105454,
                                        'true_ploidy': 2.555011239764149,
                                        'true_ploidy_1': 2.5901589841162926,
                                        'true_ploidy_2': 2.519863495412005,
                                        'true_proportion_divergent': 0.29931625168795,
                                        'brk_cn_correct_proportion': 0.3488372093023256,
                                        'brk_cn_present_num_true': 97.0,
                                        'brk_cn_present_num_pos': 148.0,
                                        'brk_cn_present_num_true_pos': 86.0,
                                        'brk_cn_subclonal_num_true': 75.0,
                                        'brk_cn_subclonal_num_pos': 12.0,
                                        'brk_cn_subclonal_num_true_pos': 2.0,
                                        'mix_true_0': 0.4,
                                        'mix_true_1': 0.4,
                                        'mix_true_2': 0.19999999999999996,
                                        'mix_pred_0': 0.5316380262374878,
                                        'mix_pred_1': 0.2732788026332855,
                                        'mix_pred_2': 0.19508324563503265},
                         'restarts': 72,
                         'chosen': 2,
                         'elbo': {0: -4016.868408203125,
                                  1: -3915.84375,
                                  2: -3913.057861328125,
                                  3: -4059.875,
                                  4: -3954.11572265625,
                                  5: -3941.62158203125,
                                  6: -4045.37109375,
                                  7: -3887.95751953125,
                                  8: -3887.640625,
                                  9: -4043.450439453125,
                                  10: -3924.648193359375,
                                  11: -3908.501953125,
                                  12: -4230.064453125,
                                  13: -4150.0166015625,
                                  14: -4124.54638671875,
                                  15: -4209.25244140625,
                                  16: -4106.166015625,
                                  17: -4091.230224609375,
                                  18: -4281.12744140625,
                                  19: -4113.2060546875,
                                  20: -4094.8818359375,
                                  21: -4313.22216796875,
                                  22: -4211.60302734375,
                                  23: -4207.14794921875,
                                  24: -4317.38916015625,
                                  25: -4268.8154296875,
                                  26: -4244.498046875,
                                  27: -4289.07568359375,
                                  28: -4172.18017578125,
                                  29: -4193.9521484375,
                                  30: -4267.6875,
                                  31: -4222.4150390625,
                                  32: -4213.64013671875,
                                  33: -4351.03369140625,
                                  34: -4152.78076171875,
                                  35: -4138.19287109375,
                                  36: -4069.021484375,
                                  37: -3954.71728515625,
                                  38: -3944.38720703125,
                                  39: -4053.8779296875,
                                  40: -3940.7861328125,
                                  41: -3863.419677734375,
                                  42: -4053.8349609375,
                                  43: -3897.48291015625,
                                  44: -3897.04296875,
                                  45: -4073.11181640625,
                                  46: -3902.272216796875,
                                  47: -3868.45166015625,
                                  48: -4519.818359375,
                                  49: -4463.5234375,
                                  50: -4494.42138671875,
                                  51: -4642.02880859375,
                                  52: -4409.69384765625,
                                  53: -4377.4541015625,
                                  54: -4594.68115234375,
                                  55: -4418.43359375,
                                  56: -4402.435546875,
                                  57: -4612.333984375,
                                  58: -4492.7529296875,
                                  59: -4514.45361328125,
                                  60: -4165.11328125,
                                  61: -4055.34912109375,
                                  62: -4039.41845703125,
                                  63: -4164.1494140625,
                                  64: -4023.351318359375,
                                  65: -3992.773681640625,
                                  66: -4190.11181640625,
                                  67: -4016.83935546875,
                                  68: -3983.861572265625,
                                  69: -4177.09716796875,
                                  70: -4043.965576171875,
                                  71: -4034.121826171875},
                         'proportion_divergent': {0: 0.23709736076956217,
                                                  1: 0.3882051125924175,
                                                  2: 0.46578492997444826,
                                                  3: 0.3037022418391329,
                                                  4: 0.5258647374128373,
                                                  5: 0.5576977103867355,
                                                  6: 0.31660064663118376,
                                                  7: 0.5415622130006018,
                                                  8: 0.5625271425637913,
                                                  9: 0.2817289690069832,
                                                  10: 0.4909737842188068,
                                                  11: 0.5652745295215491,
                                                  12: 0.33517323484635714,
                                                  13: 0.4591305414769552,
                                                  14: 0.4700199313849428,
                                                  15: 0.3822517666236959,
                                                  16: 0.49352340883731033,
                                                  17: 0.49044781940163135,
                                                  18: 0.3794408122107636,
                                                  19: 0.5686985394183561,
                                                  20: 0.5817421134905713,
                                                  21: 0.3917115418875625,
                                                  22: 0.6003692884968733,
                                                  23: 0.6260920608272015,
                                                  24: 0.276178733926683,
                                                  25: 0.3655924697187174,
                                                  26: 0.372344667704705,
                                                  27: 0.3238468225804263,
                                                  28: 0.49153246294520797,
                                                  29: 0.5006002116973072,
                                                  30: 0.3527724999972485,
                                                  31: 0.4688701822341996,
                                                  32: 0.4761680068509608,
                                                  33: 0.40070102914620426,
                                                  34: 0.5318690492723616,
                                                  35: 0.5496363727578838,
                                                  36: 0.167585309459271,
                                                  37: 0.5081993700491011,
                                                  38: 0.5277449358843473,
                                                  39: 0.255214670620389,
                                                  40: 0.5182963587100681,
                                                  41: 0.5402973106884436,
                                                  42: 0.29770430666966763,
                                                  43: 0.5249359281525185,
                                                  44: 0.547291829901579,
                                                  45: 0.34389025458682926,
                                                  46: 0.5451550758059178,
                                                  47: 0.6059112813861957,
                                                  48: 0.45142468160288945,
                                                  49: 0.5358903784528518,
                                                  50: 0.5475647608316581,
                                                  51: 0.5122853892811899,
                                                  52: 0.6134764267396657,
                                                  53: 0.623299607746886,
                                                  54: 0.5431743447892627,
                                                  55: 0.6464206632404005,
                                                  56: 0.6601189509513524,
                                                  57: 0.46570626188033587,
                                                  58: 0.5749489464611003,
                                                  59: 0.5909558339157251,
                                                  60: 0.281666102428531,
                                                  61: 0.5118521500931508,
                                                  62: 0.5680840764464173,
                                                  63: 0.31175878516829825,
                                                  64: 0.5745409464296007,
                                                  65: 0.6160337642457845,
                                                  66: 0.3965978925879638,
                                                  67: 0.5877971431970209,
                                                  68: 0.5890129534780325,
                                                  69: 0.4289744139697705,
                                                  70: 0.618937369902361,
                                                  71: 0.6283344515528501},
                         'float64': {'chosen': 2,
                                     'elbo': {1: -3914.986665015934,
                                              2: -3914.1281441748547,
                                              7: -3887.837560780227,
                                              8: -3887.9548915074047,
                                              11: -3919.117358927324,
                                              41: -3886.380381091758,
                                              43: -3897.7968277678306,
                                              44: -3897.2994481748547,
                                              46: -3904.5477258859264,
                                              47: -3869.7680003588143},
                                     'proportion_divergent': {1: 0.3882051125924175,
                                                              2: 0.46058113214972496,
                                                              7: 0.5553784369390758,
                                                              8: 0.5625271425637913,
                                                              11: 0.5663441105393799,
                                                              41: 0.5509830354055129,
                                                              43: 0.5249359281525185,
                                                              44: 0.5420629444444979,
                                                              46: 0.5423218884337442,
                                                              47: 0.6059112813861957},
                                     'evaluation': {'proportion_cn_correct': 0.0,
                                                    'proportion_dom_cn_correct': 0.0,
                                                    'proportion_clonal_correct': 0.5588140346486208,
                                                    'proportion_subclonal_correct': 0.5588140346486208,
                                                    'pred_ploidy': 4.708475023830385,
                                                    'pred_ploidy_1': 4.855219894260006,
                                                    'pred_ploidy_2': 4.561730153400763,
                                                    'pred_proportion_divergent': 0.41199574736947514,
                                                    'true_ploidy': 2.555011239764149,
                                                    'true_ploidy_1': 2.5901589841162926,
                                                    'true_ploidy_2': 2.519863495412005,
                                                    'true_proportion_divergent': 0.29931625168795,
                                                    'brk_cn_correct_proportion': 0.34418604651162793,
                                                    'brk_cn_present_num_true': 97.0,
                                                    'brk_cn_present_num_pos': 149.0,
                                                    'brk_cn_present_num_true_pos': 86.0,
                                                    'brk_cn_subclonal_num_true': 75.0,
                                                    'brk_cn_subclonal_num_pos': 12.0,
                                                    'brk_cn_subclonal_num_true_pos': 2.0,
                                                    'mix_true_0': 0.4,
                                                    'mix_true_1': 0.4,
                                                    'mix_true_2': 0.19999999999999996,
                                                    'mix_pred_0': 0.5249584626127873,
                                                    'mix_pred_1': 0.2875301611572322,
                                                    'mix_pred_2': 0.18751137622998051}},
                         'perturbed': {'chosen': {1: 2,
                                                  2: 1,
                                                  3: 1,
                                                  4: 1,
                                                  5: 2,
                                                  6: 2,
                                                  7: 2,
                                                  8: 2},
                                       'elbo': {1: {1: -3918.770263671875,
                                                    2: -3917.85302734375,
                                                    7: -3887.3671875,
                                                    8: -3887.7822265625,
                                                    11: -3915.99072265625,
                                                    41: -3861.71728515625,
                                                    43: -3897.205078125,
                                                    44: -3897.03564453125,
                                                    46: -3903.54443359375,
                                                    47: -3865.6005859375},
                                                2: {1: -3922.378173828125,
                                                    2: -3917.578125,
                                                    7: -3887.61474609375,
                                                    8: -3887.64599609375,
                                                    11: -3908.780029296875,
                                                    41: -3888.952392578125,
                                                    43: -3896.48779296875,
                                                    44: -3897.0546875,
                                                    46: -3900.4130859375,
                                                    47: -3867.572265625},
                                                3: {1: -3923.950927734375,
                                                    2: -3918.38037109375,
                                                    7: -3887.5029296875,
                                                    8: -3887.6455078125,
                                                    11: -3916.2236328125,
                                                    41: -3861.611083984375,
                                                    43: -3896.5283203125,
                                                    44: -3902.80712890625,
                                                    46: -3901.313232421875,
                                                    47: -3865.96728515625},
                                                4: {1: -3918.02392578125,
                                                    2: -3918.72607421875,
                                                    7: -3887.78466796875,
                                                    8: -3887.65185546875,
                                                    11: -3919.5341796875,
                                                    41: -3889.48291015625,
                                                    43: -3897.459716796875,
                                                    44: -3897.146484375,
                                                    46: -3902.5927734375,
                                                    47: -3865.3369140625},
                                                5: {1: -3923.807861328125,
                                                    2: -3914.087890625,
                                                    7: -3887.4912109375,
                                                    8: -3887.787109375,
                                                    11: -3909.31640625,
                                                    41: -3885.728515625,
                                                    43: -3896.367431640625,
                                                    44: -3898.9765625,
                                                    46: -3901.9580078125,
                                                    47: -3865.406982421875},
                                                6: {1: -3924.4462890625,
                                                    2: -3918.7939453125,
                                                    7: -3887.5556640625,
                                                    8: -3887.6484375,
                                                    11: -3918.7607421875,
                                                    41: -3889.572509765625,
                                                    43: -3897.2578125,
                                                    44: -3897.615966796875,
                                                    46: -3901.517578125,
                                                    47: -3866.0458984375},
                                                7: {1: -3918.605224609375,
                                                    2: -3911.16845703125,
                                                    7: -3892.87255859375,
                                                    8: -3887.64453125,
                                                    11: -3916.298828125,
                                                    41: -3885.63232421875,
                                                    43: -3896.22509765625,
                                                    44: -3896.63623046875,
                                                    46: -3903.73779296875,
                                                    47: -3867.366455078125},
                                                8: {1: -3915.513671875,
                                                    2: -3914.69482421875,
                                                    7: -3889.7236328125,
                                                    8: -3887.789306640625,
                                                    11: -3906.92041015625,
                                                    41: -3867.1357421875,
                                                    43: -3895.6533203125,
                                                    44: -3896.8720703125,
                                                    46: -3902.444580078125,
                                                    47: -3865.01220703125}},
                                       'proportion_divergent': {1: {1: 0.39859037653439683,
                                                                    2: 0.4986900853391252,
                                                                    7: 0.5415622129937703,
                                                                    8: 0.5625271432180075,
                                                                    11: 0.5713082533165548,
                                                                    41: 0.5402973100387423,
                                                                    43: 0.5249359280117312,
                                                                    44: 0.5472918295259525,
                                                                    46: 0.5514635004151424,
                                                                    47: 0.612604028381108},
                                                                2: {1: 0.42978892372197575,
                                                                    2: 0.5023839235958749,
                                                                    7: 0.5415622144755449,
                                                                    8: 0.5625271433746108,
                                                                    11: 0.5656651815128848,
                                                                    41: 0.5673988028311588,
                                                                    43: 0.5249359308987608,
                                                                    44: 0.5472918318786102,
                                                                    46: 0.545155074740851,
                                                                    47: 0.6145808445547399},
                                                                3: {1: 0.42978892226006726,
                                                                    2: 0.5004606960668466,
                                                                    7: 0.5415622125410003,
                                                                    8: 0.562527140505954,
                                                                    11: 0.5678851753896088,
                                                                    41: 0.5411472080949663,
                                                                    43: 0.524935928538361,
                                                                    44: 0.550966268232158,
                                                                    46: 0.5442911678602024,
                                                                    47: 0.6074529332341629},
                                                                4: {1: 0.3985903728330466,
                                                                    2: 0.5036462640861578,
                                                                    7: 0.5415622137490084,
                                                                    8: 0.5625271431881612,
                                                                    11: 0.5713082518045138,
                                                                    41: 0.5673988029330003,
                                                                    43: 0.5249359296504849,
                                                                    44: 0.5472918311147249,
                                                                    46: 0.5450137472118863,
                                                                    47: 0.6126040287019154},
                                                                5: {1: 0.42978891982194806,
                                                                    2: 0.4714876924734633,
                                                                    7: 0.541562211770216,
                                                                    8: 0.5625271419810384,
                                                                    11: 0.5634780902402167,
                                                                    41: 0.5673988037412979,
                                                                    43: 0.5249359272371933,
                                                                    44: 0.5590971016817742,
                                                                    46: 0.5430274427668887,
                                                                    47: 0.6145808443878304},
                                                                6: {1: 0.42978892039807215,
                                                                    2: 0.481033414072402,
                                                                    7: 0.5415622103936304,
                                                                    8: 0.5625271393222706,
                                                                    11: 0.5713082507862333,
                                                                    41: 0.5673988000291748,
                                                                    43: 0.5249359269186087,
                                                                    44: 0.5590971002005105,
                                                                    46: 0.5442911645126831,
                                                                    47: 0.6126040258734554},
                                                                7: {1: 0.40332609683074244,
                                                                    2: 0.4769256278591481,
                                                                    7: 0.5558580952329414,
                                                                    8: 0.5625271420788189,
                                                                    11: 0.5678851716070911,
                                                                    41: 0.5673988016527836,
                                                                    43: 0.5249359255561522,
                                                                    44: 0.5472918283408825,
                                                                    46: 0.5430274429102896,
                                                                    47: 0.6145808427184587},
                                                                8: {1: 0.3985903732852502,
                                                                    2: 0.48158402215520735,
                                                                    7: 0.5558580930521059,
                                                                    8: 0.5625271393000217,
                                                                    11: 0.5656651767336982,
                                                                    41: 0.5552700267546564,
                                                                    43: 0.5249359278149246,
                                                                    44: 0.5420629434910477,
                                                                    46: 0.5365776893905537,
                                                                    47: 0.6126040254008646}},
                                       'evaluation': {1: {'proportion_cn_correct': 0.0,
                                                          'proportion_dom_cn_correct': 0.0,
                                                          'brk_cn_correct_proportion': 0.3488372093023256,
                                                          'mix_pred_0': 0.5167535543441772,
                                                          'mix_pred_1': 0.2884379029273987,
                                                          'mix_pred_2': 0.19480860233306885},
                                                      2: {'proportion_cn_correct': 0.0,
                                                          'proportion_dom_cn_correct': 0.0,
                                                          'brk_cn_correct_proportion': 0.3488372093023256,
                                                          'mix_pred_0': 0.5239952802658081,
                                                          'mix_pred_1': 0.27717819809913635,
                                                          'mix_pred_2': 0.19882649183273315},
                                                      3: {'proportion_cn_correct': 0.0,
                                                          'proportion_dom_cn_correct': 0.0,
                                                          'brk_cn_correct_proportion': 0.3488372093023256,
                                                          'mix_pred_0': 0.51580411195755,
                                                          'mix_pred_1': 0.2762809097766876,
                                                          'mix_pred_2': 0.20791493356227875},
                                                      4: {'proportion_cn_correct': 0.0,
                                                          'proportion_dom_cn_correct': 0.0,
                                                          'brk_cn_correct_proportion': 0.3488372093023256,
                                                          'mix_pred_0': 0.5225006341934204,
                                                          'mix_pred_1': 0.2782987952232361,
                                                          'mix_pred_2': 0.19920065999031067},
                                                      5: {'proportion_cn_correct': 0.0,
                                                          'proportion_dom_cn_correct': 0.0,
                                                          'brk_cn_correct_proportion': 0.3488372093023256,
                                                          'mix_pred_0': 0.5284746289253235,
                                                          'mix_pred_1': 0.2832315266132355,
                                                          'mix_pred_2': 0.18829385936260223},
                                                      6: {'proportion_cn_correct': 0.0,
                                                          'proportion_dom_cn_correct': 0.0,
                                                          'brk_cn_correct_proportion': 0.3488372093023256,
                                                          'mix_pred_0': 0.5162782669067383,
                                                          'mix_pred_1': 0.29023903608322144,
                                                          'mix_pred_2': 0.19348275661468506},
                                                      7: {'proportion_cn_correct': 0.0,
                                                          'proportion_dom_cn_correct': 0.0,
                                                          'brk_cn_correct_proportion': 0.3488372093023256,
                                                          'mix_pred_0': 0.5310206413269043,
                                                          'mix_pred_1': 0.2859811782836914,
                                                          'mix_pred_2': 0.1829981654882431},
                                                      8: {'proportion_cn_correct': 0.0,
                                                          'proportion_dom_cn_correct': 0.0,
                                                          'brk_cn_correct_proportion': 0.3488372093023256,
                                                          'mix_pred_0': 0.5230980515480042,
                                                          'mix_pred_1': 0.2788161337375641,
                                                          'mix_pred_2': 0.19808582961559296}}}},
              'tumour_b': {'counts': {'rows': 551,
                                      'columns': ['chromosome',
                                                  'start',
                                                  'end',
                                                  'readcount',
                                                  'allele_b_readcount',
                                                  'allele_a_readcount',
                                                  'major_readcount',
                                                  'minor_readcount',
                                                  'major_is_allele_a',
                                                  'bias',
                                                  'length'],
                                      'ints': {'chromosome': '3e316fd309216215',
                                               'start': 'bebdc95662a32ae9',
                                               'end': '67f47485e7eea11c',
                                               'allele_b_readcount': '054728972fcac1b4',
                                               'allele_a_readcount': 'e8cb37d48db065fc',
                                               'major_readcount': '9a5362793c9f449a',
                                               'minor_readcount': 'b35fc354e47e558c',
                                               'major_is_allele_a': '14e8e84df4e2cf16'},
                                      'floats': {'readcount': [1558486.0,
                                                               446584480.0],
                                                 'bias': [0.9999999999999729,
                                                          272.7892329935776],
                                                 'length': [161175535.0,
                                                            43966950569.98075]}},
                           'segments': 551,
                           'evaluation': {'proportion_cn_correct': 0.0,
                                          'proportion_dom_cn_correct': 0.00020279132313722427,
                                          'proportion_clonal_correct': 0.4185142366674942,
                                          'proportion_subclonal_correct': 0.4185142366674942,
                                          'pred_ploidy': 4.830980182569271,
                                          'pred_ploidy_1': 4.731693479410508,
                                          'pred_ploidy_2': 4.930266885728035,
                                          'pred_proportion_divergent': 0.4750490606406239,
                                          'true_ploidy': 2.555011239764149,
                                          'true_ploidy_1': 2.519863495412005,
                                          'true_ploidy_2': 2.5901589841162926,
                                          'true_proportion_divergent': 0.29931625168795,
                                          'brk_cn_correct_proportion': 0.3395348837209302,
                                          'brk_cn_present_num_true': 97.0,
                                          'brk_cn_present_num_pos': 165.0,
                                          'brk_cn_present_num_true_pos': 90.0,
                                          'brk_cn_subclonal_num_true': 75.0,
                                          'brk_cn_subclonal_num_pos': 46.0,
                                          'brk_cn_subclonal_num_true_pos': 20.0,
                                          'mix_true_0': 0.4,
                                          'mix_true_1': 0.4,
                                          'mix_true_2': 0.19999999999999996,
                                          'mix_pred_0': 0.4663347899913788,
                                          'mix_pred_1': 0.41115397214889526,
                                          'mix_pred_2': 0.12251130491495132},
                           'restarts': 60,
                           'chosen': 31,
                           'elbo': {0: -4232.68798828125,
                                    1: -4070.08349609375,
                                    2: -4031.65966796875,
                                    3: -4143.169921875,
                                    4: -4028.004638671875,
                                    5: -4054.56201171875,
                                    6: -4158.74365234375,
                                    7: -4085.8095703125,
                                    8: -4092.80029296875,
                                    9: -4183.6513671875,
                                    10: -4100.583984375,
                                    11: -4070.00732421875,
                                    12: -4264.90380859375,
                                    13: -4194.87939453125,
                                    14: -4188.935546875,
                                    15: -4343.2255859375,
                                    16: -4238.521484375,
                                    17: -4239.447265625,
                                    18: -4311.8466796875,
                                    19: -4195.5927734375,
                                    20: -4193.98046875,
                                    21: -4340.6669921875,
                                    22: -4227.5693359375,
                                    23: -4193.93212890625,
                                    24: -4053.970703125,
                                    25: -3954.244384765625,
                                    26: -3944.1845703125,
                                    27: -3990.595703125,
                                    28: -3891.628173828125,
                                    29: -3868.7197265625,
                                    30: -3963.1669921875,
                                    31: -3869.935791015625,
                                    32: -3852.44482421875,
                                    33: -4014.074951171875,
                                    34: -3904.41357421875,
                                    35: -3911.72314453125,
                                    36: -4474.12060546875,
                                    37: -4374.0888671875,
                                    38: -4375.466796875,
                                    39: -4544.24267578125,
                                    40: -4446.40234375,
                                    41: -4396.61962890625,
                                    42: -4538.64111328125,
                                    43: -4443.10888671875,
                                    44: -4440.68017578125,
                                    45: -4543.1513671875,
                                    46: -4440.9375,
                                    47: -4443.83642578125,
                                    48: -4118.28271484375,
                                    49: -4024.02490234375,
                                    50: -4003.53955078125,
                                    51: -4150.271484375,
                                    52: -3967.8837890625,
                                    53: -3956.43603515625,
                                    54: -4155.609375,
                                    55: -4039.376220703125,
                                    56: -4022.446533203125,
                                    57: -4150.78125,
                                    58: -4008.355712890625,
                                    59: -3996.5947265625},
                           'proportion_divergent': {0: 0.3500567127640459,
                                                    1: 0.5798717858998286,
                                                    2: 0.5760551016202416,
                                                    3: 0.38209340793203517,
                                                    4: 0.6009812987607582,
                                                    5: 0.6160310503707481,
                                                    6: 0.46551621791728015,
                                                    7: 0.646719340983241,
                                                    8: 0.6697705183682621,
                                                    9: 0.4323916629932792,
                                                    10: 0.6101377469829602,
                                                    11: 0.6147971434100448,
                                                    12: 0.3030990534537333,
                                                    13: 0.35675805352257,
                                                    14: 0.3654670908590651,
                                                    15: 0.33635906090147305,
                                                    16: 0.41100296670442826,
                                                    17: 0.4523216662706793,
                                                    18: 0.42603825326386574,
                                                    19: 0.5597130380923402,
                                                    20: 0.5369205918259747,
                                                    21: 0.41390376937578865,
                                                    22: 0.5392235172564863,
                                                    23: 0.596350802482757,
                                                    24: 0.20701925406860422,
                                                    25: 0.43665440889223767,
                                                    26: 0.4760483393226245,
                                                    27: 0.30809729367834876,
                                                    28: 0.5085353774440758,
                                                    29: 0.5477083099300308,
                                                    30: 0.3448771765170887,
                                                    31: 0.47763084075103046,
                                                    32: 0.5337658530113689,
                                                    33: 0.36041191573910014,
                                                    34: 0.5734703714110133,
                                                    35: 0.602790740026259,
                                                    36: 0.3290575128164531,
                                                    37: 0.5149242166377151,
                                                    38: 0.5199967516062328,
                                                    39: 0.341875651928836,
                                                    40: 0.5297637740538227,
                                                    41: 0.552901001004531,
                                                    42: 0.4186712464573752,
                                                    43: 0.5421524357853424,
                                                    44: 0.5942012228802102,
                                                    45: 0.41769190372350595,
                                                    46: 0.5503942040687446,
                                                    47: 0.5750537586812542,
                                                    48: 0.2949318208836835,
                                                    49: 0.5559115532246739,
                                                    50: 0.5995705859072155,
                                                    51: 0.3078893057728515,
                                                    52: 0.5795950402997733,
                                                    53: 0.5964210780487207,
                                                    54: 0.338769970550173,
                                                    55: 0.534707263713135,
                                                    56: 0.6169475048373536,
                                                    57: 0.3689753081008589,
                                                    58: 0.553196482543913,
                                                    59: 0.6128710227934586},
                           'float64': {'chosen': 31,
                                       'elbo': {29: -3869.3804628021553,
                                                31: -3870.8711355052574,
                                                32: -3854.8836993763516},
                                       'proportion_divergent': {29: 0.5477083099300308,
                                                                31: 0.4962720357065897,
                                                                32: 0.5377675265473826},
                                       'evaluation': {'proportion_cn_correct': 0.0,
                                                      'proportion_dom_cn_correct': 0.00020279132313722427,
                                                      'proportion_clonal_correct': 0.4559319378092959,
                                                      'proportion_subclonal_correct': 0.4559319378092959,
                                                      'pred_ploidy': 4.802234877023985,
                                                      'pred_ploidy_1': 4.736285100589242,
                                                      'pred_ploidy_2': 4.868184653458727,
                                                      'pred_proportion_divergent': 0.494201626195936,
                                                      'true_ploidy': 2.555011239764149,
                                                      'true_ploidy_1': 2.519863495412005,
                                                      'true_ploidy_2': 2.5901589841162926,
                                                      'true_proportion_divergent': 0.29931625168795,
                                                      'brk_cn_correct_proportion': 0.3302325581395349,
                                                      'brk_cn_present_num_true': 97.0,
                                                      'brk_cn_present_num_pos': 165.0,
                                                      'brk_cn_present_num_true_pos': 90.0,
                                                      'brk_cn_subclonal_num_true': 75.0,
                                                      'brk_cn_subclonal_num_pos': 41.0,
                                                      'brk_cn_subclonal_num_true_pos': 16.0,
                                                      'mix_true_0': 0.4,
                                                      'mix_true_1': 0.4,
                                                      'mix_true_2': 0.19999999999999996,
                                                      'mix_pred_0': 0.4677095702891856,
                                                      'mix_pred_1': 0.4159351212832052,
                                                      'mix_pred_2': 0.11635530842760919}},
                           'perturbed': {'chosen': {1: 31,
                                                    2: 31,
                                                    3: 31,
                                                    4: 31,
                                                    5: 31,
                                                    6: 31,
                                                    7: 31,
                                                    8: 31},
                                         'elbo': {1: {29: -3869.520751953125,
                                                      31: -3869.96728515625,
                                                      32: -3853.2509765625},
                                                  2: {29: -3869.9130859375,
                                                      31: -3868.406494140625,
                                                      32: -3855.2607421875},
                                                  3: {29: -3865.77392578125,
                                                      31: -3870.85693359375,
                                                      32: -3853.107666015625},
                                                  4: {29: -3868.890625,
                                                      31: -3870.6376953125,
                                                      32: -3853.79345703125},
                                                  5: {29: -3868.28466796875,
                                                      31: -3869.883544921875,
                                                      32: -3855.3505859375},
                                                  6: {29: -3869.681640625,
                                                      31: -3868.685546875,
                                                      32: -3853.76171875},
                                                  7: {29: -3869.66162109375,
                                                      31: -3873.4775390625,
                                                      32: -3853.5634765625},
                                                  8: {29: -3869.391357421875,
                                                      31: -3868.60107421875,
                                                      32: -3853.068115234375}},
                                         'proportion_divergent': {1: {29: 0.547708308191898,
                                                                      31: 0.4877104510464018,
                                                                      32: 0.5377675237900874},
                                                                  2: {29: 0.5288426057800298,
                                                                      31: 0.48695065197219195,
                                                                      32: 0.5434901900235364},
                                                                  3: {29: 0.5264025352558465,
                                                                      31: 0.4916019811836578,
                                                                      32: 0.5377675259903185},
                                                                  4: {29: 0.5492726236277676,
                                                                      31: 0.49654087769809374,
                                                                      32: 0.5377675280668822},
                                                                  5: {29: 0.5499903114246965,
                                                                      31: 0.4877104524995966,
                                                                      32: 0.5377675256994868},
                                                                  6: {29: 0.5477083096803101,
                                                                      31: 0.4869506556761432,
                                                                      32: 0.5377675279369283},
                                                                  7: {29: 0.5477083099437854,
                                                                      31: 0.47763083995267824,
                                                                      32: 0.5377675272492712},
                                                                  8: {29: 0.5477083085595307,
                                                                      31: 0.48695065651929276,
                                                                      32: 0.5377675290560288}},
                                         'evaluation': {1: {'proportion_cn_correct': 0.0,
                                                            'proportion_dom_cn_correct': 0.00020279132313722427,
                                                            'brk_cn_correct_proportion': 0.3395348837209302,
                                                            'mix_pred_0': 0.4668251872062683,
                                                            'mix_pred_1': 0.41302239894866943,
                                                            'mix_pred_2': 0.12015241384506226},
                                                        2: {'proportion_cn_correct': 0.0,
                                                            'proportion_dom_cn_correct': 0.00020279132313722427,
                                                            'brk_cn_correct_proportion': 0.33488372093023255,
                                                            'mix_pred_0': 0.4674440622329712,
                                                            'mix_pred_1': 0.40749603509902954,
                                                            'mix_pred_2': 0.12505990266799927},
                                                        3: {'proportion_cn_correct': 0.0,
                                                            'proportion_dom_cn_correct': 0.00020279132313722427,
                                                            'brk_cn_correct_proportion': 0.3302325581395349,
                                                            'mix_pred_0': 0.46522486209869385,
                                                            'mix_pred_1': 0.41064292192459106,
                                                            'mix_pred_2': 0.12413221597671509},
                                                        4: {'proportion_cn_correct': 0.0,
                                                            'proportion_dom_cn_correct': 0.00020279132313722427,
                                                            'brk_cn_correct_proportion': 0.33488372093023255,
                                                            'mix_pred_0': 0.481781929731369,
                                                            'mix_pred_1': 0.4014759063720703,
                                                            'mix_pred_2': 0.11674218624830246},
                                                        5: {'proportion_cn_correct': 0.0,
                                                            'proportion_dom_cn_correct': 0.00020279132313722427,
                                                            'brk_cn_correct_proportion': 0.3395348837209302,
                                                            'mix_pred_0': 0.46715790033340454,
                                                            'mix_pred_1': 0.4127117693424225,
                                                            'mix_pred_2': 0.12013033777475357},
                                                        6: {'proportion_cn_correct': 0.0,
                                                            'proportion_dom_cn_correct': 0.00020279132313722427,
                                                            'brk_cn_correct_proportion': 0.33488372093023255,
                                                            'mix_pred_0': 0.46690845489501953,
                                                            'mix_pred_1': 0.40822145342826843,
                                                            'mix_pred_2': 0.12487014383077621},
                                                        7: {'proportion_cn_correct': 0.0,
                                                            'proportion_dom_cn_correct': 0.00020279132313722427,
                                                            'brk_cn_correct_proportion': 0.3395348837209302,
                                                            'mix_pred_0': 0.4589441120624542,
                                                            'mix_pred_1': 0.4199380576610565,
                                                            'mix_pred_2': 0.12111779302358627},
                                                        8: {'proportion_cn_correct': 0.0,
                                                            'proportion_dom_cn_correct': 0.00020279132313722427,
                                                            'brk_cn_correct_proportion': 0.33488372093023255,
                                                            'mix_pred_0': 0.4668024480342865,
                                                            'mix_pred_1': 0.4083036780357361,
                                                            'mix_pred_2': 0.12489382922649384}}}}}


def per_sample_times(run, tumours):
    """{step: {sample: seconds}} of a ``run_cli`` run; a call that names
    no one sample counts under ``all``, but for the fit's, which
    ``fit_many_cohort`` makes one a tumour in the cohort's order."""
    out = {}
    for label, seconds in run['times'].items():
        names = run['samples'].get(label, [None] * len(seconds))
        if label == 'fit' and names == [None] * len(tumours):
            names = sorted(tumours, key=str)
        step = out.setdefault(label, {})
        for name, value in zip(names, seconds):
            step[name or 'all'] = step.get(name or 'all', 0.0) + value
    return out


def split_waves(marks, restarts):
    """Each fit's wave times from a ``run_cli`` run's marks (the start of
    each of its ⌈R / WAVE⌉ waves and the end of the last), fits in turn
    with ``restarts`` restarts."""
    out, first = [], 0
    for count in restarts:
        waves = -(-count // WAVE)
        out.append(np.diff(marks[first:first + waves + 1]).tolist())
        first += waves + 1
    return out


def fits_differ(got, ref):
    """The restarts whose fit results differ in h, ELBO, copy number or
    breakpoint copy number, bit for bit, between {init_id: fit_results}
    ``got`` and ``ref``."""
    if list(got) != list(ref):
        return ['restarts {} against {}'.format(list(got), list(ref))]
    differ = []
    for init_id, want in ref.items():
        have = got[init_id]
        same = (np.array_equal(have['h'], want['h'])
                and have['stats']['elbo'] == want['stats']['elbo']
                and np.array_equal(have['cn'], want['cn'])
                and set(have['brk_cn']) == set(want['brk_cn'])
                and all(np.array_equal(have['brk_cn'][k], v)
                        for k, v in want['brk_cn'].items()))
        if not same:
            differ.append(init_id)
    return differ


def phase_cohort(smi, fixture):
    """Phase 13: the run CLI with two tumour samples (phase 11's inputs
    ``fixture``, which hold the second tumour's BAM) to two results
    stores, one cohort fit on the card; then ``tumour_b``'s grid fitted
    alone through ``fit_many``, which must equal the cohort's fit of it
    bit for bit. Returns the run's fb_grouped launches."""
    import torch
    from remixt_tpu_torch import config as config_mod
    from remixt_tpu_torch.analysis import pipeline
    from remixt_tpu_torch.io.store import read_store

    if COHORT_JAX is None:
        raise AssertionError('phase 13: COHORT_JAX is not set; run python '
                             'tests/test_torch_cohort.py --phase13 WORKDIR')
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, 'build', 'chip_smoke', 'cohort')
    t_phase = time.time()
    peak = HostPeak()
    run = run_cli('phase 13', root, RUN_CHROMOSOMES, RUN_DEPTH,
                  fixture=fixture, tumours=COHORT)
    device_gb = torch.cuda.max_memory_allocated() / 1e9
    log('phase 13: wall s per step and sample: {}'.format(json.dumps({
        step: {name: round(value, 3) for name, value in samples.items()}
        for step, samples in per_sample_times(run, COHORT).items()})))

    sweeps = (config_mod.get_param({}, 'num_em_iter')
              * config_mod.get_param({}, 'num_update_iter'))
    failures, restarts, expected = [], {}, 0
    for tumour in COHORT:
        label = 'phase 13, ' + tumour
        want = COHORT_JAX[tumour]
        digest = check_counts_digest(label, os.path.join(
            run['raw'], 'counts', 'sample_{}.tsv'.format(tumour)),
            want['counts'])
        tables = read_store(run['results'][tumour])
        stats = tables['stats']
        restarts[tumour] = len(stats['init_id'])
        if restarts[tumour] != want['restarts']:
            raise AssertionError('{}: init\'s grid has {} restarts, the JAX '
                                 'package\'s {}'.format(
                                     label, restarts[tumour],
                                     want['restarts']))
        keys = results_keys(stats)
        if set(tables) != keys:
            raise AssertionError('{}: results keys {} missing, {} extra'
                                 .format(label, sorted(keys - set(tables)),
                                         sorted(set(tables) - keys)))
        if not np.all(np.isfinite(stats['elbo'])):
            raise AssertionError('{}: non-finite ELBO'.format(label))
        expected += -(-restarts[tumour] // WAVE) * sweeps
        log('{}: the count table ({} segments, {} reads) is the JAX '
            'package\'s; results store {}: {} keys, grid of {} restarts, '
            'ELBOs {:.6g} to {:.6g}'.format(
                label, digest['rows'], int(digest['floats']['readcount'][0]),
                os.path.relpath(run['results'][tumour], here), len(tables),
                restarts[tumour], float(np.min(stats['elbo'])),
                float(np.max(stats['elbo']))))
        with open(fixture['mixture_files'][tumour], 'rb') as f:
            mixture = pickle.load(f)
        try:
            check_chosen_restart(label, mixture, tables, want)
        except AssertionError as error:
            log('{}: FAILED: {}'.format(label, error))
            failures.append(str(error))
    for tumour, waves in zip(COHORT, split_waves(
            run['marks'], [restarts[t] for t in COHORT])):
        log('phase 13, {}: fit: {} waves {:.3f} s ({})'.format(
            tumour, len(waves), sum(waves),
            json.dumps([round(w, 3) for w in waves])))
    expect_launches('phase 13', run['launches'], 'fb_grouped', expected)
    log('phase 13: fb_grouped launches {} = sum over the tumours of '
        'ceil(restarts / {}) x {} sweeps ({})'.format(
            expected, WAVE, sweeps, json.dumps(restarts)))

    # the cohort fit adds nothing: tumour_b, fitted second on the card,
    # fitted again alone
    tumour = COHORT[-1]
    config = config_mod.get_sample_config(fixture['config'], tumour)
    with open(os.path.join(run['raw'], 'experiment',
                           'sample_{}.pickle'.format(tumour)), 'rb') as f:
        experiment = pickle.load(f)
    grid = pipeline.init_tables(experiment, config)[0]
    reset_chain_launches()
    t0 = time.time()
    alone = pipeline.fit_many(experiment, grid, config)
    torch.cuda.synchronize()
    refit_s = time.time() - t0
    expect_launches('phase 13 refit', chain_launches(), 'fb_grouped',
                    -(-len(grid) // WAVE) * sweeps)
    fit_dir = os.path.join(run['raw'], 'tmp', 'fit', 'fit_results', tumour)
    cohort_fits = {}
    for init_id in grid:
        with open(os.path.join(fit_dir, 'fit_{}.pickle'.format(init_id)),
                  'rb') as f:
            cohort_fits[init_id] = pickle.load(f)
    differ = fits_differ(alone, cohort_fits)
    if differ:
        failures.append('phase 13: {} fitted alone differs from the '
                        'cohort\'s fit of it in restarts {}'.format(
                            tumour, differ))
        log(failures[-1])
    else:
        log('phase 13: {} fitted alone ({} restarts, {:.1f} s): h, ELBOs and '
            'copy number equal to the cohort\'s bit for bit'.format(
                tumour, len(grid), refit_s))
    import resource
    log('phase 13: run CLI {:.1f} s, phase {:.1f} s; max_memory_allocated '
        '{:.3f} GB; host peak RSS {:.3f} GB ({}; this process\'s rusage '
        'maximum {:.3f} GB); {}'.format(
            run['whole'], time.time() - t_phase, device_gb, peak.stop(),
            'sampled every 50 ms since the phase began',
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
            smi))
    if failures:
        raise AssertionError('phase 13: {}'.format(failures))
    return expected


def mesh_model(data, use_kernels=None):
    """Phase 15's model: phase 2's problem on the card in float32 at
    MESH_EM_ITER x MESH_UPDATE_ITER."""
    import torch
    model = make_model(data, CN_MAX_FULL, CARD, torch.float32,
                       use_kernels=use_kernels)
    model.num_em_iter = MESH_EM_ITER
    model.num_update_iter = MESH_UPDATE_ITER
    return model


def timed_mesh_fit(label, data, h_inits, weights, chunk_size, mesh=None,
                   use_kernels=None):
    """``fit_restarts_batched`` under torch's deterministic algorithms
    (warnings only); returns its results and the chain kernels' launches
    during it, and logs its wall."""
    from remixt_tpu_torch.models.fit_batched import fit_restarts_batched
    import torch
    model = mesh_model(data, use_kernels=use_kernels)
    torch.cuda.synchronize()
    reset_chain_launches()
    t0 = time.time()
    results, ops = deterministic_fit(lambda: fit_restarts_batched(
        model, h_inits, weights, chunk_size=chunk_size, mesh=mesh))
    torch.cuda.synchronize()
    launches = chain_launches()
    log('phase 15 {}: {} restarts{} in {:.2f} s; launches {}; ops torch '
        'names as nondeterministic: {}'.format(
            label, len(results), '' if mesh is None else ' on {}'.format(
                mesh), time.time() - t0, json.dumps(launches),
            json.dumps(ops) if ops else 'none'))
    return results, launches


def fits_equal(got, ref):
    """The names of the fields of two restart lists that differ in any
    bit."""
    import torch
    differ = set()
    for g, r in zip(got, ref):
        for tree in ('params', 'state'):
            for name, x in g[tree]._asdict().items():
                if not torch.equal(x, getattr(r[tree], name)):
                    differ.add(tree + '.' + name)
        for key in ('elbo', 'elbo_diff'):
            if g[key] != r[key]:
                differ.add(key)
    return sorted(differ)


def phase_mesh_fits(data):
    """Phase 15 (a) and (b); returns the fb_grouped launches."""
    import torch
    from remixt_tpu_torch.parallel import distributed
    card = torch.device(CARD)
    h_inits, weights = restart_grid(data['h'], MESH_RESTARTS, seed=15)

    # (a) a wave of WAVE on each of two virtual devices against one device
    mesh = distributed.make_training_mesh([card] * 2)
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    meshed, launches = timed_mesh_fit('(a) mesh', data, h_inits, weights,
                                      2 * WAVE, mesh=mesh)
    waves = -(-MESH_RESTARTS // (2 * WAVE))
    expect_launches('phase 15 (a) mesh', launches, 'fb_grouped',
                    waves * 2 * MESH_EM_ITER * MESH_UPDATE_ITER)
    grouped = launches['fb_grouped']
    single, launches = timed_mesh_fit('(a) one device', data, h_inits,
                                      weights, WAVE)
    expect_launches('phase 15 (a) one device', launches, 'fb_grouped',
                    -(-MESH_RESTARTS // WAVE) * MESH_EM_ITER
                    * MESH_UPDATE_ITER)
    grouped += launches['fb_grouped']
    elbos = np.array([r['elbo'] for r in meshed])
    differ = fits_equal(meshed, single)
    log('phase 15 (a): {} restarts, {} EM x {} VI, on 2 virtual devices of '
        'the card (a wave of {} each) against one device (waves of {}): '
        'fields that differ in any bit: {}; ELBOs {}; part wall {:.2f} s, '
        'max_memory_allocated {:.3f} GB'.format(
            MESH_RESTARTS, MESH_EM_ITER, MESH_UPDATE_ITER, WAVE, WAVE,
            differ or 'none', np.array2string(elbos, precision=2),
            time.time() - t0, torch.cuda.max_memory_allocated() / 1e9))
    if differ or not np.all(np.isfinite(elbos)):
        raise AssertionError('phase 15 (a): the mesh fit differs from one '
                             'device in {}'.format(differ))
    del meshed, single

    # (b) restart x chain, the kernel on each chain group, against one
    # device
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    mesh = distributed.make_training_mesh(
        [card] * 4, num_restarts=MESH_2D_RESTARTS)
    if (mesh.shape['restart'], mesh.shape['chain']) != (2, 2):
        raise AssertionError('phase 15 (b): mesh {}'.format(mesh))
    h2, w2 = h_inits[:MESH_2D_RESTARTS], weights[:MESH_2D_RESTARTS]
    meshed, launches = timed_mesh_fit('(b) mesh', data, h2, w2,
                                      MESH_2D_RESTARTS, mesh=mesh)
    # one launch a chain group of each restart shard a sweep
    expect_launches('phase 15 (b) mesh', launches, 'fb_grouped',
                    MESH_2D_RESTARTS * 2 * MESH_EM_ITER * MESH_UPDATE_ITER)
    grouped += launches['fb_grouped']
    single, launches = timed_mesh_fit('(b) one device', data, h2, w2, 1)
    expect_launches('phase 15 (b) one device', launches, 'fb_grouped',
                    MESH_2D_RESTARTS * MESH_EM_ITER * MESH_UPDATE_ITER)
    grouped += launches['fb_grouped']
    figures = {
        'h_max_rel_diff': max(float(((g['params'].h - r['params'].h).abs()
                                     / r['params'].h.abs()).max())
                              for g, r in zip(meshed, single)),
        'posterior_max_abs_diff': max(
            float((g['state'].posterior_marginals
                   - r['state'].posterior_marginals).abs().max())
            for g, r in zip(meshed, single)),
        'elbo_max_rel_diff': max(abs(g['elbo'] - r['elbo']) / abs(r['elbo'])
                                 for g, r in zip(meshed, single))}
    log('phase 15 (b): {} restarts on {} (each restart shard\'s chains '
        'over its 2 devices, the kernel on each group), {} EM x {} VI, '
        'against one device: '
        '{}; bars {}; part wall {:.2f} s, max_memory_allocated {:.3f} GB'
        .format(MESH_2D_RESTARTS, mesh, MESH_EM_ITER, MESH_UPDATE_ITER,
                json.dumps(figures), json.dumps(MESH_2D_BARS),
                time.time() - t0, torch.cuda.max_memory_allocated() / 1e9))
    if not (figures['h_max_rel_diff'] <= MESH_2D_BARS['h_rtol']
            and figures['posterior_max_abs_diff']
            <= MESH_2D_BARS['posterior_atol']
            and figures['elbo_max_rel_diff'] <= MESH_2D_BARS['elbo_rtol']):
        raise AssertionError('phase 15 (b): the restart x chain fit is off '
                             'one device\'s: {}'.format(figures))
    return grouped


def phase_blocked_sweep(data):
    """Phase 15 (c): one blocked sweep of restart 0 at BLOCKS blocks over 2
    virtual devices, float64 and float32, against the float64
    chain-batched sweep."""
    import torch
    from remixt_tpu_torch.models import engine as eng
    from remixt_tpu_torch.parallel import chain, distributed
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    block_mesh = distributed.Mesh([torch.device(CARD)] * 2, ('block',))
    marg = {}
    reset_chain_launches()
    for name, dtype in (('ref', torch.float64), ('f64', torch.float64),
                        ('f32', torch.float32)):
        spec, params_b, state_b = initial_batch(
            make_model(data, CN_MAX_FULL, CARD, dtype), [data['h']],
            [1e-7])
        if name != 'ref':
            chain.enable_block_sharding(spec, block_mesh, BLOCKS)
        torch.cuda.synchronize()
        t1 = time.time()
        swept = eng.variational_sweep(spec, eng.take(params_b, 0),
                                      eng.take(state_b, 0))
        marg[name] = swept.posterior_marginals.double()
        torch.cuda.synchronize()
        log('phase 15 (c): {} sweep in {:.3f} s'.format(
            {'ref': 'float64 chain-batched', 'f64': 'float64 blocked',
             'f32': 'float32 blocked'}[name], time.time() - t1))
    expect_launches('phase 15 (c)', chain_launches(), 'fb_grouped', 0)
    diffs = {k: float((marg[k] - marg['ref']).abs().max())
             for k in ('f64', 'f32')}
    log('phase 15 (c): blocked sweep, {} blocks over 2 virtual devices, '
        'posterior max abs diff from the float64 chain-batched sweep: '
        'float64 {:.3e} (bar {:.0e}), float32 {:.3e} (bar {:.0e}); part '
        'wall {:.2f} s, max_memory_allocated {:.3f} GB'.format(
            BLOCKS, diffs['f64'], BLOCKED_F64_BAR, diffs['f32'],
            F32_VS_F64_BAR, time.time() - t0,
            torch.cuda.max_memory_allocated() / 1e9))
    if not (diffs['f64'] < BLOCKED_F64_BAR and diffs['f32'] <= F32_VS_F64_BAR):
        raise AssertionError('phase 15 (c): blocked sweep off: {}'.format(
            diffs))


def phase_mesh_tools():
    """Phase 15 (d): measure_scaling at 1 and 2 virtual devices of the
    card; returns its fb_grouped launches."""
    from remixt_tpu_torch.tools import measure_scaling
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, 'build', 'chip_smoke', 'tools')
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    reset_chain_launches()
    with open(os.path.join(out_dir, 'measure_scaling.log'), 'w') as f, \
            contextlib.redirect_stdout(f):
        out = measure_scaling.main([
            '--devices', CARD, CARD, '--n', str(N_FULL), '--events',
            str(EVENTS_FULL), '--iters', '3', '--out',
            os.path.join(out_dir, 'measure_scaling.json')])
    for row in out['rows']:
        log('phase 15 (d): measure_scaling ' + json.dumps(row))
    # one warm-up and 3 loops of 3 sweeps, one launch a shard each
    expected = sum(row['num_devices'] * (1 + 3 * 3) for row in out['rows'])
    expect_launches('phase 15 (d) measure_scaling', chain_launches(),
                    'fb_grouped', expected)
    if out['meaningful'] or [r['num_devices'] for r in out['rows']] != [1, 2]:
        raise AssertionError('phase 15 (d): rows {}'.format(out['rows']))
    log('phase 15 (d): part wall {:.2f} s'.format(time.time() - t0))
    return expected


def phase_process_group():
    """Phase 15 (e): a one-process NCCL group up, read and down (gloo
    without CUDA, as ``initialize`` picks)."""
    import socket
    import torch
    import torch.distributed as dist
    from remixt_tpu_torch.parallel import distributed
    t0 = time.time()
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    distributed.initialize(coordinator_address='localhost:{}'.format(port),
                           num_processes=1, process_id=0, timeout_s=120)
    try:
        total = torch.ones(1, device=CARD)
        dist.all_reduce(total)
        got = (dist.get_backend(), distributed.rank(),
               distributed.world_size(),
               distributed.cohort_partition(['tumour_b', 'tumour']),
               float(total))
    finally:
        dist.destroy_process_group()
    log('phase 15 (e): process group (backend, rank, size, cohort share, '
        'all_reduce of 1) {}; torn down: {}; part wall {:.2f} s'.format(
            got, not dist.is_initialized(), time.time() - t0))
    backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if got != (backend, 0, 1, ['tumour', 'tumour_b'], 1.0) or \
            dist.is_initialized():
        raise AssertionError('phase 15 (e): {}'.format(got))


def phase_multi_device(smi):
    """Phase 15: multi-device fitting on virtual devices of the one card;
    returns the fb_grouped launches."""
    t0 = time.time()
    data = simulate(N_FULL, CN_MAX_FULL, EVENTS_FULL, CHAINS_FULL, seed=0)
    grouped = phase_mesh_fits(data)
    phase_blocked_sweep(data)
    grouped += phase_mesh_tools()
    phase_process_group()
    log('phase 15: {:.1f} s, fb_grouped launches {}; the mesh rows share '
        'one card: no scaling is measured; {}'.format(
            time.time() - t0, grouped, smi))
    return grouped


def _phase_child(conn, phase, args, start):
    """``phase(*args)`` in a process of its own; sends ('ok', its result)
    or ('failed', the error) through ``conn``."""
    global START
    START = start
    try:
        conn.send(('ok', phase(*args)))
    except BaseException as error:
        conn.send(('failed', repr(error)))
        raise
    finally:
        conn.close()


def start_phase(label, phase, *args):
    """Start ``phase(*args)`` in a process of its own (``spawn``), beside
    the phases that follow in this one, for the script's time limit: the
    runs of phases 11–13 are host work most of the time. Returns a
    function that waits for it and returns its result (the fb_grouped
    launches), or raises."""
    import multiprocessing
    context = multiprocessing.get_context('spawn')
    receiver, sender = context.Pipe(duplex=False)
    process = context.Process(target=_phase_child,
                              args=(sender, phase, args, START))
    process.start()
    sender.close()
    log('{}: started in process {}'.format(label, process.pid))

    def wait():
        try:
            outcome = receiver.recv()
        except EOFError:
            outcome = ('failed', 'its process ended without a result')
        process.join()
        if outcome[0] != 'ok' or process.exitcode != 0:
            raise AssertionError('{} failed (exit code {}): {}'.format(
                label, process.exitcode, outcome[1]))
        return outcome[1]
    return wait


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from remixt_tpu_torch.device import resolve_device
    resolve_device('cuda')   # TF32 off

    smi = phase_environment()
    data = simulate(N_FULL, CN_MAX_FULL, EVENTS_FULL, CHAINS_FULL, seed=0)
    inputs = kernel_inputs(data, WAVE)
    spec, frames, static_exp, be_exp_b, cbi = inputs
    one = (spec, frames[0], static_exp, be_exp_b[0], cbi)
    grouped, grouped_messages = phase_kernel(inputs)
    chains, chains_messages = phase_kernel_chains('phase 2b', one)
    grouped_scaled = phase_kernel_scaled(inputs, grouped_messages)
    chains_scaled, _ = phase_kernel_chains('phase 2d', one, scaled=True,
                                           log_space=chains_messages)
    del inputs, one, frames, be_exp_b, grouped_messages, chains_messages
    grouped['launches'], batched_results = phase_fit(data)
    phase_small_f32_vs_f64()
    phase_profile(data)
    tools_grouped, tools_chains = phase_tools(grouped['ms'], chains['kernel_ms'])
    grouped['launches'] += tools_grouped
    chains['launches'], sequential_results = phase_sequential_fit(
        data, batched_results)
    chains['launches'] += tools_chains
    scaled_launches = phase_scaled_fits(data, batched_results,
                                        sequential_results)
    grouped_scaled['launches'] = scaled_launches['fb_grouped_scaled']
    chains_scaled['launches'] = scaled_launches['fb_chains_scaled']
    grouped['launches'] += phase_workflow(data)
    del data, batched_results, sequential_results
    here = os.path.dirname(os.path.abspath(__file__))
    fixture = make_cli_inputs(
        'phases 11 and 13', os.path.join(here, 'build', 'chip_smoke',
                                         'inputs'),
        RUN_CHROMOSOMES, RUN_DEPTH, tumour_b=True)
    phase_cohort_launches = start_phase('phase 13', phase_cohort, smi,
                                        fixture)
    accuracy_grouped, accuracy_chains = phase_accuracy()
    grouped['launches'] += accuracy_grouped
    chains['launches'] += accuracy_chains
    phase_float64()
    phase_run_launches = start_phase('phase 11', phase_run, smi, fixture)
    grouped['launches'] += phase_read_benchmark(smi)
    phase_reference_build(smi)
    grouped['launches'] += phase_multi_device(smi)
    grouped['launches'] += phase_run_launches()
    grouped['launches'] += phase_cohort_launches()

    print(smi)
    table = {'kernels': [
        dict(name=name, route='cuda',
             source='remixt_tpu_torch/csrc/{}.cu'.format(source),
             replaces=replaces, launches=k['launches'],
             max_abs_err=k['max_abs_err'], ms=k['ms'],
             plain_ms=k['plain_ms'], bound_ms=k['bound_ms'],
             bound_by=k['bound_by'], library_ms=None)
        for name, source, replaces, k in (
            ('fb_grouped', 'fb_grouped', 'remixt_tpu/ops/fb_pallas.py:744',
             grouped),
            ('fb_chains', 'fb_chains', 'remixt_tpu/ops/fb_pallas.py:152',
             chains),
            ('fb_grouped_scaled', 'fb_grouped',
             'remixt_tpu/ops/fb_pallas.py:911', grouped_scaled),
            ('fb_chains_scaled', 'fb_chains',
             'remixt_tpu/ops/fb_pallas.py:260', chains_scaled))]}
    print(json.dumps(table))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
