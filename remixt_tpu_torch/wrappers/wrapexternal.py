"""The external callers (TITAN, THetA2, cloneHD) as benchmark wrappers
(counterpart of ``remixt_tpu/wrappers/wrapexternal.py``).

Each tool class puts its input preparation and result conversion
(``wraptitan.py``, ``wraptheta.py``, ``wrapclonehd.py``, which stand
alone) around a stage that runs the tool, as three tasks of the
scheduler, and writes the results store the evaluation reads
(``simulations/pipeline.evaluate_results_task``): ``cn``, ``mix`` and an
empty ``brk_cn``. The tools run on the host; no task uses a device.

The tools' locations come from the config, under the tool's name::

    titan:
      run_script: /path/to/titan_run.R
    theta:
      bin: /path/to/RunTHetA
      octave_bin_directory: /path/to/theta/matlab
      segments_filename: /path/to/segments.tsv
    clonehd:
      filterhd_bin: /path/to/filterHD
      clonehd_bin: /path/to/cloneHD

``check_available`` raises an informative error where a tool's binaries
are not on the PATH.
"""

import os
import shutil

import numpy as np

from remixt_tpu_torch import config as config_mod
from remixt_tpu_torch.io import store
from remixt_tpu_torch.io.table import Series, Table, read_tsv, write_tsv
from remixt_tpu_torch.scheduler import Workflow


def _write_results_store(results_filename, cn_filename, mix_filename):
    """Pack a tool's cn and mix TSV outputs into the common results store
    (HDF5 or a directory, ``io/store.py``)."""
    cn_table = read_tsv(cn_filename, str_columns=('chromosome',))
    with open(mix_filename) as f:
        mix = np.array([float(v) for v in f.read().split()])
    store.write_store(results_filename, {
        'cn': cn_table,
        'mix': Series(mix, index=np.arange(len(mix))),
        'brk_cn': Table([(name, np.array([], dtype=object))
                         for name in ('prediction_id', 'cn_1', 'cn_2')]),
    })


# ---------------------------------------------------------------------------
# Stage functions live at module level: the scheduler's spawn pool pickles
# the task functions, and a closure cannot be pickled.

def _titan_prepare(workdir, normal, tumour, chromosome_lengths):
    from remixt_tpu_torch.wrappers import wraptitan
    wraptitan.prepare_inputs(workdir, normal, tumour, chromosome_lengths)


def _titan_run_all(workdir, run_script, restarts, done_filename):
    from remixt_tpu_torch.wrappers import wraptitan
    for idx, (clusters, ploidy, frac_normal) in enumerate(restarts):
        wraptitan.run(workdir, run_script, clusters, ploidy, frac_normal,
                      'restart_{}'.format(idx))
    open(done_filename, 'w').close()


def _titan_report(workdir, restarts, results_filename):
    from remixt_tpu_torch.wrappers import wraptitan
    restart_dirs = {idx: os.path.join(workdir, 'restart_{}'.format(idx))
                    for idx in range(len(restarts))}
    clusters = {idx: r[0] for idx, r in enumerate(restarts)}
    cn_tsv = os.path.join(workdir, 'cn.tsv')
    mix_tsv = os.path.join(workdir, 'mix.tsv')
    wraptitan.report(restart_dirs, cn_tsv, mix_tsv, clusters)
    _write_results_store(results_filename, cn_tsv, mix_tsv)


def _theta_prepare(workdir, normal, tumour, segments_filename,
                   chrom_names_filename):
    from remixt_tpu_torch.wrappers import wraptheta
    segments = read_tsv(segments_filename, str_columns=('chromosome',))
    paths = wraptheta.prepare_inputs(workdir, normal, tumour, segments)
    write_tsv(Table([
        ('chromosome', np.array(list(paths['chrom_idx']), dtype=object)),
        ('idx', np.array(list(paths['chrom_idx'].values()),
                         dtype=np.int64)),
    ]), chrom_names_filename)


def _theta_run(workdir, theta_bin, octave_bin_directory, done_filename):
    from remixt_tpu_torch.wrappers import wraptheta
    wraptheta.run(workdir, theta_bin, octave_bin_directory)
    open(done_filename, 'w').close()


def _theta_report(workdir, chrom_names_filename, results_filename):
    from remixt_tpu_torch.wrappers import wraptheta
    mapping = read_tsv(chrom_names_filename, str_columns=('chromosome',))
    chrom_names = dict(zip(mapping['idx'].tolist(),
                           mapping['chromosome'].tolist()))
    cn_tsv = os.path.join(workdir, 'cn.tsv')
    mix_tsv = os.path.join(workdir, 'mix.tsv')
    wraptheta.report(workdir, cn_tsv, mix_tsv, chrom_names)
    _write_results_store(results_filename, cn_tsv, mix_tsv)


def _clonehd_prepare(workdir, normal, tumour, chromosome_lengths):
    from remixt_tpu_torch.wrappers import wrapclonehd
    wrapclonehd.prepare_inputs(workdir, normal, tumour, chromosome_lengths)


def _clonehd_run(workdir, filterhd_bin, clonehd_bin, done_filename):
    from remixt_tpu_torch.wrappers import wrapclonehd
    wrapclonehd.run(workdir, filterhd_bin, clonehd_bin)
    open(done_filename, 'w').close()


def _clonehd_report(workdir, results_filename):
    from remixt_tpu_torch.wrappers import wrapclonehd
    cn_tsv = os.path.join(workdir, 'cn.tsv')
    mix_tsv = os.path.join(workdir, 'mix.tsv')
    wrapclonehd.report(workdir, cn_tsv, mix_tsv)
    _write_results_store(results_filename, cn_tsv, mix_tsv)


class ExternalTool:
    """A wrapper of an external caller.

    Unlike the JAX package's, each tool's prepare task names the seqdata
    stores among its inputs, so that a benchmark runner's scheduler runs
    it after the simulation that writes them.

    ``device`` is accepted because the benchmark runners pass it to every
    tool of the catalog; the external tools run on the host and use no
    device.
    """

    name = None
    required_binaries = ()

    def __init__(self, config, ref_data_dir, device=None):
        self.config = config
        self.ref_data_dir = ref_data_dir
        self.tool_config = config.get(self.name, {})

    def check_available(self):
        missing = [b for b in self.required_binaries
                   if shutil.which(b) is None]
        if missing:
            raise RuntimeError(
                '{} requires binaries not on PATH: {}. Install the tool '
                '(see benchmark/tool_defs.yaml) to include it in '
                'comparisons.'.format(self.name, ', '.join(missing)))

    def chromosome_lengths(self):
        return config_mod.get_chromosome_lengths(
            self.config, self.ref_data_dir)

    def create_workflow(self, seqdata_filenames, breakpoints_filename,
                        results_filename, workdir, normal_id=None):
        self.check_available()
        os.makedirs(workdir, exist_ok=True)
        normal = seqdata_filenames[normal_id]
        tumours = {k: v for k, v in seqdata_filenames.items()
                   if k != normal_id}
        if len(tumours) != 1:
            raise ValueError(
                '{} supports exactly one tumour sample'.format(self.name))
        (tumour,) = tumours.values()

        workflow = Workflow('{}_analysis'.format(self.name))
        self._add_stages(workflow, normal, tumour, results_filename, workdir)
        return workflow

    def _add_stages(self, workflow, normal, tumour, results_filename,
                    workdir):
        """The prepare, run and report tasks of the tool."""
        raise NotImplementedError


class TitanTool(ExternalTool):
    name = 'titan'
    required_binaries = ('Rscript',)

    #: (num_clusters, ploidy_init, normal_init) restart grid
    restarts = [(1, 2.0, 0.5), (2, 2.0, 0.5), (1, 4.0, 0.5), (2, 4.0, 0.5)]

    def _add_stages(self, workflow, normal, tumour, results_filename,
                    workdir):
        alleles = os.path.join(workdir, 'alleles.tsv')
        normal_wig = os.path.join(workdir, 'normal.wig')
        tumour_wig = os.path.join(workdir, 'tumour.wig')
        done = os.path.join(workdir, 'run.done')
        workflow.transform(
            'prepare', _titan_prepare,
            args=(workdir, normal, tumour, self.chromosome_lengths()),
            inputs=[normal, tumour],
            outputs=[alleles, normal_wig, tumour_wig])
        workflow.transform(
            'run', _titan_run_all,
            args=(workdir, self.tool_config['run_script'],
                  self.restarts, done),
            inputs=[alleles, normal_wig, tumour_wig], outputs=[done])
        workflow.transform(
            'report', _titan_report,
            args=(workdir, self.restarts, results_filename),
            inputs=[done], outputs=[results_filename])


class ThetaTool(ExternalTool):
    """THetA2 on the segmentation of the config's
    ``theta.segments_filename`` (a TSV of chromosome, start and end), which
    it needs: ``create_workflow`` raises ValueError without it."""

    name = 'theta'
    required_binaries = ('octave',)

    def _add_stages(self, workflow, normal, tumour, results_filename,
                    workdir):
        segments_filename = self.tool_config.get('segments_filename')
        if segments_filename is None:
            raise ValueError(
                'theta needs a segmentation: set the config key '
                'theta.segments_filename to a TSV of chromosome, start and '
                'end')
        counts = os.path.join(workdir, 'counts.tsv')
        normal_alleles = os.path.join(workdir, 'normal_alleles.tsv')
        tumour_alleles = os.path.join(workdir, 'tumour_alleles.tsv')
        done = os.path.join(workdir, 'run.done')
        chrom_names_file = os.path.join(workdir, 'chrom_names.tsv')

        workflow.transform(
            'prepare', _theta_prepare,
            args=(workdir, normal, tumour, segments_filename,
                  chrom_names_file),
            inputs=[normal, tumour, segments_filename],
            outputs=[counts, normal_alleles, tumour_alleles,
                     chrom_names_file])
        workflow.transform(
            'run', _theta_run,
            args=(workdir, self.tool_config['bin'],
                  self.tool_config['octave_bin_directory'], done),
            inputs=[counts, normal_alleles, tumour_alleles], outputs=[done])
        workflow.transform(
            'report', _theta_report,
            args=(workdir, chrom_names_file, results_filename),
            inputs=[done, chrom_names_file], outputs=[results_filename])


class CloneHDTool(ExternalTool):
    name = 'clonehd'
    required_binaries = ('filterHD', 'cloneHD')

    def _add_stages(self, workflow, normal, tumour, results_filename,
                    workdir):
        normal_cna = os.path.join(workdir, 'normal.cna.txt')
        tumour_cna = os.path.join(workdir, 'tumour.cna.txt')
        baf = os.path.join(workdir, 'tumour.baf.txt')
        done = os.path.join(workdir, 'run.done')

        workflow.transform(
            'prepare', _clonehd_prepare,
            args=(workdir, normal, tumour, self.chromosome_lengths()),
            inputs=[normal, tumour],
            outputs=[normal_cna, tumour_cna, baf])
        workflow.transform(
            'run', _clonehd_run,
            args=(workdir,
                  self.tool_config.get('filterhd_bin', 'filterHD'),
                  self.tool_config.get('clonehd_bin', 'cloneHD'), done),
            inputs=[normal_cna, tumour_cna, baf], outputs=[done])
        workflow.transform(
            'report', _clonehd_report,
            args=(workdir, results_filename),
            inputs=[done], outputs=[results_filename])
