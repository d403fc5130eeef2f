"""Workflow factories: BAM extraction, haplotype inference, GC bias,
count preparation, the fit (init → the restart-grid fit → collate), and
the composed seqdata and BAM pipelines of ``run``.

Counterpart of ``remixt_tpu/workflow.py`` on the port's make-style
scheduler. Chromosomes and samples fan out as independent tasks; every
task but the fit is host numpy and C++, and the fit task reaches the
device through ``fit_many(..., device)``, or, for a run of several
tumour samples, one cohort fit task through ``fit_many_cohort(...,
devices)``. Seqdata stores are HDF5 files where h5py is installed, else
directories (``io/store.store_name``). The ploidy plots are not made (they
need matplotlib).
"""

import os
import pickle

import remixt_tpu_torch.config
from remixt_tpu_torch import seqdataio, utils
from remixt_tpu_torch.analysis import (experiment, gcbias, haplotype,
                                       pipeline, readcount, segment, stats)
from remixt_tpu_torch.io import store
from remixt_tpu_torch.scheduler import Workflow


def _temp(tempdir, *parts):
    path = os.path.join(tempdir, *[str(p) for p in parts])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def create_fit_model_workflow(experiment_filename, results_filename, config,
                              ref_data_dir, tempdir, tumour_id=None,
                              device=None):
    """The three tasks of one sample's fit, ``init``, ``fit`` and
    ``collate``, with the sample's config; ``device`` (``None`` means
    CUDA) is where the fit runs. ``ref_data_dir`` is unused, as in the JAX
    package's count-table workflow. The init store is an HDF5 file when the
    results store is one, else a directory of TSV tables
    (``io/store.py``)."""
    config = remixt_tpu_torch.config.get_sample_config(config, tumour_id)

    workflow = Workflow('fit_model')

    init_results_file = _temp(tempdir, 'init_results' + (
        '.h5' if store.is_hdf5(results_filename) else ''))
    init_ret = workflow.transform(
        'init',
        pipeline.init,
        args=(init_results_file, experiment_filename, config),
        inputs=[experiment_filename],
        outputs=[init_results_file],
    )

    fit_results_dir = os.path.dirname(_temp(tempdir, 'fit_results', 'x'))
    fit_ret = workflow.transform(
        'fit',
        fit_all_restarts,
        args=(fit_results_dir, experiment_filename, init_ret, config),
        kwargs={'device': device},
        inputs=[experiment_filename],
    )

    workflow.transform(
        'collate',
        pipeline.collate,
        args=(results_filename, experiment_filename, init_results_file,
              fit_ret, config),
        inputs=[experiment_filename, init_results_file],
        outputs=[results_filename],
    )
    return workflow


def fit_all_restarts(fit_results_dir, experiment_filename, init_params, config,
                     device=None):
    """Fit the whole restart grid in this process on one shared model
    (``pipeline.fit_many``) and pickle each restart's results.

    Returns {init_id: results filename}.
    """
    os.makedirs(fit_results_dir, exist_ok=True)
    with open(experiment_filename, 'rb') as f:
        experiment = pickle.load(f)

    all_results = pipeline.fit_many(experiment, init_params, config,
                                    device=device)

    fit_results_filenames = {}
    for init_id, fit_results in all_results.items():
        results_filename = os.path.join(fit_results_dir,
                                        'fit_{}.pickle'.format(init_id))
        with open(results_filename, 'wb') as f:
            pickle.dump(fit_results, f)
        fit_results_filenames[init_id] = results_filename
    return fit_results_filenames


def create_fit_cohort_workflow(experiment_filenames, results_filenames,
                               config, ref_data_dir, tempdir, device=None):
    """The fit of several samples: each sample's ``init`` with its config,
    one ``fit_cohort`` task fitting every sample's grid
    (``pipeline.fit_many_cohort`` on ``device``: ``None`` means every local
    CUDA device, one device or a list of devices), then each sample's
    ``collate``. ``ref_data_dir`` is unused, as in the JAX package. The
    fit task declares no outputs: on a rerun the scheduler skips it by its
    done sentinel and its return pickle, which holds the names of the
    pickled fit results."""
    workflow = Workflow('fit_cohort')

    init_results_files = {}
    init_rets = {}
    for sample_id, experiment_filename in experiment_filenames.items():
        sample_config = remixt_tpu_torch.config.get_sample_config(
            config, sample_id)
        init_results_files[sample_id] = _temp(
            tempdir, 'init_results_{}'.format(sample_id) + (
                '.h5' if store.is_hdf5(results_filenames[sample_id])
                else ''))
        init_rets[sample_id] = workflow.transform(
            'init_{}'.format(sample_id),
            pipeline.init,
            args=(init_results_files[sample_id], experiment_filename,
                  sample_config),
            inputs=[experiment_filename],
            outputs=[init_results_files[sample_id]],
        )

    fit_results_dir = os.path.dirname(_temp(tempdir, 'fit_results', 'x'))
    fit_ret = workflow.transform(
        'fit_cohort',
        fit_cohort_restarts,
        args=(fit_results_dir, dict(experiment_filenames), init_rets,
              config),
        kwargs={'device': device},
        inputs=list(experiment_filenames.values()),
    )

    for sample_id, experiment_filename in experiment_filenames.items():
        workflow.transform(
            'collate_{}'.format(sample_id),
            pipeline.collate,
            args=(results_filenames[sample_id], experiment_filename,
                  init_results_files[sample_id], fit_ret[sample_id],
                  remixt_tpu_torch.config.get_sample_config(
                      config, sample_id)),
            inputs=[experiment_filename, init_results_files[sample_id]],
            outputs=[results_filenames[sample_id]],
        )
    return workflow


def fit_cohort_restarts(fit_results_dir, experiment_filenames,
                        init_params_per_sample, config, device=None):
    """Fit every sample's grid (``pipeline.fit_many_cohort`` on
    ``device``: ``None`` means every local CUDA device, one device a list
    of that one) and pickle each restart's results under
    ``<sample>/fit_<init_id>.pickle``.

    Returns {sample_id: {init_id: results filename}}.
    """
    experiments = {}
    for sample_id, filename in experiment_filenames.items():
        with open(filename, 'rb') as f:
            experiments[sample_id] = pickle.load(f)

    if device is not None and not isinstance(device, (list, tuple)):
        device = [device]
    all_results = pipeline.fit_many_cohort(
        experiments, init_params_per_sample, config, devices=device)

    out = {}
    for sample_id, sample_results in all_results.items():
        sample_dir = os.path.join(fit_results_dir, str(sample_id))
        os.makedirs(sample_dir, exist_ok=True)
        out[sample_id] = {}
        for init_id, fit_results in sample_results.items():
            results_filename = os.path.join(
                sample_dir, 'fit_{}.pickle'.format(init_id))
            with open(results_filename, 'wb') as f:
                pickle.dump(fit_results, f)
            out[sample_id][init_id] = results_filename
    return out


def create_extract_seqdata_workflow(bam_filename, seqdata_filename, config,
                                    ref_data_dir, tempdir,
                                    no_parallelism=False):
    """BAM → seqdata: one extraction task per chromosome, then the merge
    (or one task for all with ``no_parallelism``)."""
    get = lambda name: remixt_tpu_torch.config.get_param(config, name)
    chromosomes = remixt_tpu_torch.config.get_chromosomes(config,
                                                          ref_data_dir)
    snp_positions_filename = remixt_tpu_torch.config.get_filename(
        config, ref_data_dir, 'snp_positions')
    bam_args = (get('bam_max_fragment_length'), get('bam_max_soft_clipped'),
                get('bam_check_proper_pair'))

    workflow = Workflow('extract_seqdata')

    if no_parallelism:
        workflow.transform(
            'create_seqdata',
            seqdataio.create_seqdata,
            args=(seqdata_filename, bam_filename, snp_positions_filename)
            + bam_args + (_temp(tempdir, 'seqdata_temp'), chromosomes),
            inputs=[bam_filename],
            outputs=[seqdata_filename],
        )
        return workflow

    suffix = '.h5' if store.is_hdf5(seqdata_filename) else ''
    chrom_files = {}
    for chromosome in chromosomes:
        chrom_file = _temp(tempdir, 'seqdata', chromosome + suffix)
        chrom_files[chromosome] = chrom_file
        workflow.transform(
            'create_chromosome_seqdata_{}'.format(chromosome),
            seqdataio.create_chromosome_seqdata,
            args=(chrom_file, bam_filename, snp_positions_filename,
                  chromosome) + bam_args,
            inputs=[bam_filename],
            outputs=[chrom_file],
        )

    workflow.transform(
        'merge_seqdata',
        seqdataio.merge_seqdata,
        args=(seqdata_filename, chrom_files),
        inputs=list(chrom_files.values()),
        outputs=[seqdata_filename],
    )
    return workflow


def create_infer_haps_workflow(seqdata_filenames, haps_filename, config,
                               ref_data_dir, tempdir, normal_id=None):
    """SNP genotyping (from the normal, else pooled over the tumours) and
    phasing, per chromosome, then the merged haplotype table."""
    chromosomes = remixt_tpu_torch.config.get_chromosomes(config,
                                                          ref_data_dir)
    workflow = Workflow('infer_haps')

    haps_files = {}
    for chromosome in chromosomes:
        snp_genotype_file = _temp(tempdir, 'snp_genotype',
                                  '{}.tsv'.format(chromosome))
        if normal_id is not None:
            workflow.transform(
                'infer_snp_genotype_from_normal_{}'.format(chromosome),
                haplotype.infer_snp_genotype_from_normal,
                args=(snp_genotype_file, seqdata_filenames[normal_id],
                      chromosome, config),
                inputs=[seqdata_filenames[normal_id]],
                outputs=[snp_genotype_file],
            )
        else:
            workflow.transform(
                'infer_snp_genotype_from_tumour_{}'.format(chromosome),
                haplotype.infer_snp_genotype_from_tumour,
                args=(snp_genotype_file, seqdata_filenames, chromosome,
                      config),
                inputs=list(seqdata_filenames.values()),
                outputs=[snp_genotype_file],
            )

        haps_file = _temp(tempdir, 'haps', '{}.tsv'.format(chromosome))
        haps_files[chromosome] = haps_file
        workflow.transform(
            'infer_haps_{}'.format(chromosome),
            haplotype.infer_haps,
            args=(haps_file, snp_genotype_file, chromosome,
                  _temp(tempdir, 'haplotyping', chromosome),
                  config, ref_data_dir),
            inputs=[snp_genotype_file],
            outputs=[haps_file],
        )

    workflow.transform(
        'merge_haps',
        utils.merge_tables,
        args=tuple([haps_filename] + list(haps_files.values())),
        inputs=list(haps_files.values()),
        outputs=[haps_filename],
    )
    return workflow


def create_calc_bias_workflow(tumour_seqdata_filename, segment_filename,
                              segment_length_filename, config, ref_data_dir,
                              tempdir):
    """Fragment stats → GC sampling → LOWESS → per-segment bias → biased
    segment length."""
    workflow = Workflow('calc_bias')

    fragstats = workflow.transform(
        'calc_fragment_stats',
        stats.calculate_fragment_stats,
        args=(tumour_seqdata_filename, config),
        inputs=[tumour_seqdata_filename],
    )

    gcsamples_file = _temp(tempdir, 'gcsamples.tsv')
    workflow.transform(
        'sample_gc',
        gcbias.sample_gc,
        args=(gcsamples_file, tumour_seqdata_filename,
              fragstats.prop('fragment_mean'), config, ref_data_dir),
        inputs=[tumour_seqdata_filename],
        outputs=[gcsamples_file],
    )

    gcloess_file = _temp(tempdir, 'gcloess.tsv')
    gctable_file = _temp(tempdir, 'gctable.tsv')
    workflow.transform(
        'gc_lowess',
        gcbias.gc_lowess,
        args=(gcsamples_file, gcloess_file, gctable_file),
        inputs=[gcsamples_file],
        outputs=[gcloess_file, gctable_file],
    )

    biases_file = _temp(tempdir, 'biases.tsv')
    workflow.transform(
        'gc_map_bias',
        gcbias.gc_map_bias,
        args=(segment_filename, fragstats.prop('fragment_mean'),
              fragstats.prop('fragment_stddev'), gcloess_file, biases_file,
              config, ref_data_dir),
        inputs=[segment_filename, gcloess_file],
        outputs=[biases_file],
    )

    workflow.transform(
        'biased_length',
        gcbias.biased_length,
        args=(segment_length_filename, biases_file),
        inputs=[biases_file],
        outputs=[segment_length_filename],
    )
    return workflow


def create_prepare_counts_workflow(segment_filename, haplotypes_filename,
                                   tumour_filenames, count_filenames, config,
                                   tempdir):
    """Segment and allele read counts per tumour, phased across tumours,
    merged into each tumour's count table."""
    workflow = Workflow('prepare_counts')

    segment_counts_files = {}
    allele_counts_files = {}
    phased_counts_files = {}
    for tumour_id, seqdata_filename in tumour_filenames.items():
        segment_counts_file = _temp(tempdir, 'segment_counts',
                                    '{}.tsv'.format(tumour_id))
        segment_counts_files[tumour_id] = segment_counts_file
        workflow.transform(
            'segment_readcount_{}'.format(tumour_id),
            readcount.segment_readcount,
            args=(segment_counts_file, segment_filename, seqdata_filename,
                  config),
            inputs=[segment_filename, seqdata_filename],
            outputs=[segment_counts_file],
        )

        allele_counts_file = _temp(tempdir, 'allele_counts',
                                   '{}.tsv'.format(tumour_id))
        allele_counts_files[tumour_id] = allele_counts_file
        workflow.transform(
            'haplotype_allele_readcount_{}'.format(tumour_id),
            readcount.haplotype_allele_readcount,
            args=(allele_counts_file, segment_filename, seqdata_filename,
                  haplotypes_filename, config),
            inputs=[segment_filename, seqdata_filename, haplotypes_filename],
            outputs=[allele_counts_file],
        )

        phased_counts_files[tumour_id] = _temp(
            tempdir, 'phased_allele_counts', '{}.tsv'.format(tumour_id))

    workflow.transform(
        'phase_segments',
        readcount.phase_segments,
        args=(allele_counts_files, phased_counts_files),
        inputs=list(allele_counts_files.values()),
        outputs=list(phased_counts_files.values()),
    )

    for tumour_id in tumour_filenames:
        workflow.transform(
            'prepare_readcount_table_{}'.format(tumour_id),
            readcount.prepare_readcount_table,
            args=(segment_counts_files[tumour_id],
                  phased_counts_files[tumour_id],
                  count_filenames[tumour_id]),
            inputs=[segment_counts_files[tumour_id],
                    phased_counts_files[tumour_id]],
            outputs=[count_filenames[tumour_id]],
        )
    return workflow


def create_remixt_seqdata_workflow(breakpoint_filename, seqdata_filenames,
                                   results_filenames, raw_data_directory,
                                   config, ref_data_dir, normal_id=None,
                                   device=None):
    """seqdata → results: segments, haplotypes, counts, bias, the
    experiments, and the fit: one tumour sample's through its own fit
    workflow on ``device`` (``None`` means CUDA), several tumour samples'
    through one cohort fit on ``device`` (``None`` means every local CUDA
    device). The tasks and their names are the JAX package's, so the
    scheduler runs them in its order: each tumour's ``sample_gc`` draws
    from numpy's global state where the JAX package's does."""
    tumour_ids = [sample_id for sample_id in seqdata_filenames
                  if sample_id != normal_id]

    segment_filename = os.path.join(raw_data_directory, 'segments.tsv')
    haplotypes_filename = os.path.join(raw_data_directory, 'haplotypes.tsv')
    counts_table_template = os.path.join(raw_data_directory, 'counts',
                                         'sample_{tumour_id}.tsv')
    experiment_template = os.path.join(raw_data_directory, 'experiment',
                                       'sample_{tumour_id}.pickle')
    tempdir = os.path.join(raw_data_directory, 'tmp')

    os.makedirs(raw_data_directory, exist_ok=True)

    workflow = Workflow('remixt_seqdata')

    workflow.transform(
        'create_segments',
        segment.create_segments,
        args=(segment_filename, config, ref_data_dir),
        kwargs={'breakpoint_filename': breakpoint_filename},
        inputs=[breakpoint_filename],
        outputs=[segment_filename],
    )

    workflow.subworkflow('infer_haps_workflow', create_infer_haps_workflow(
        seqdata_filenames, haplotypes_filename, config, ref_data_dir,
        os.path.join(tempdir, 'haps'), normal_id=normal_id))

    raw_counts_files = {
        tumour_id: _temp(tempdir, 'rawcounts', '{}.tsv'.format(tumour_id))
        for tumour_id in tumour_ids}
    workflow.subworkflow(
        'prepare_counts_workflow', create_prepare_counts_workflow(
            segment_filename, haplotypes_filename,
            {tid: seqdata_filenames[tid] for tid in tumour_ids},
            raw_counts_files, config, os.path.join(tempdir, 'counts')))

    for tumour_id in tumour_ids:
        counts_file = counts_table_template.format(tumour_id=tumour_id)
        os.makedirs(os.path.dirname(counts_file), exist_ok=True)
        workflow.subworkflow(
            'calc_bias_workflow_{}'.format(tumour_id),
            create_calc_bias_workflow(
                seqdata_filenames[tumour_id], raw_counts_files[tumour_id],
                counts_file, config, ref_data_dir,
                os.path.join(tempdir, 'bias', str(tumour_id))))

        experiment_file = experiment_template.format(tumour_id=tumour_id)
        os.makedirs(os.path.dirname(experiment_file), exist_ok=True)
        workflow.transform(
            'create_experiment_{}'.format(tumour_id),
            experiment.create_experiment,
            args=(counts_file, breakpoint_filename, experiment_file),
            inputs=[counts_file, breakpoint_filename],
            outputs=[experiment_file],
        )

    # several tumour samples: one cohort fit; one keeps its own fit
    if len(tumour_ids) > 1:
        workflow.subworkflow(
            'fit_cohort_workflow', create_fit_cohort_workflow(
                {tid: experiment_template.format(tumour_id=tid)
                 for tid in tumour_ids},
                {tid: results_filenames[tid] for tid in tumour_ids},
                config, ref_data_dir, os.path.join(tempdir, 'fit'),
                device=device))
    else:
        for tumour_id in tumour_ids:
            workflow.subworkflow(
                'fit_model_{}'.format(tumour_id), create_fit_model_workflow(
                    experiment_template.format(tumour_id=tumour_id),
                    results_filenames[tumour_id], config, ref_data_dir,
                    os.path.join(tempdir, 'fit', str(tumour_id)),
                    tumour_id=tumour_id, device=device))
    return workflow


def create_remixt_bam_workflow(breakpoint_filename, bam_filenames,
                               results_filenames, raw_data_directory, config,
                               ref_data_dir, normal_id=None, device=None):
    """BAM → results: extraction of every sample, then the seqdata
    pipeline, the fit on ``device`` (``None`` means CUDA: the one device,
    or every local one for a cohort of tumour samples)."""
    tempdir = os.path.join(raw_data_directory, 'tmp')
    os.makedirs(raw_data_directory, exist_ok=True)

    workflow = Workflow('remixt_bam')

    seqdata_filenames = {}
    for sample_id in bam_filenames:
        seqdata_file = store.store_name(os.path.join(
            raw_data_directory, 'seqdata', 'sample_{}'.format(sample_id)))
        os.makedirs(os.path.dirname(seqdata_file), exist_ok=True)
        seqdata_filenames[sample_id] = seqdata_file
        workflow.subworkflow(
            'extract_seqdata_workflow_{}'.format(sample_id),
            create_extract_seqdata_workflow(
                bam_filenames[sample_id], seqdata_file, config, ref_data_dir,
                os.path.join(tempdir, 'extract', str(sample_id))))

    workflow.subworkflow(
        'remixt_seqdata_workflow', create_remixt_seqdata_workflow(
            breakpoint_filename, seqdata_filenames, results_filenames,
            raw_data_directory, config, ref_data_dir, normal_id=normal_id,
            device=device))
    return workflow
