"""The bwa mappability workflow: the genome's k-mers, their realignment
with ``bwa mem`` chunk by chunk, each chunk's bedgraph, and the merged
mappability store. Counterpart of ``remixt_tpu/mappability/bwa/workflow.py``
on the port's scheduler.
"""

import importlib.util
import os
import subprocess

import remixt_tpu_torch.config
import remixt_tpu_torch.mappability.tasks
from remixt_tpu_torch.io.store import is_hdf5
from remixt_tpu_torch.scheduler import Workflow

# lines of the k-mer FASTA a chunk (two lines a k-mer), as in the JAX package
KMERS_PER_CHUNK = 4000000


def _bwa_mem_to_file(genome_fasta, kmers_filename, alignment_filename):
    with open(alignment_filename, 'w') as out:
        subprocess.check_call(
            ['bwa', 'mem', '-M', genome_fasta, kmers_filename], stdout=out)


def _split_kmers(kmers_filename, chunk_template):
    filenames = []

    def callback(file_number):
        filename = chunk_template.format(file_number)
        filenames.append(filename)
        return filename

    remixt_tpu_torch.mappability.tasks.split_file_byline(
        kmers_filename, KMERS_PER_CHUNK, callback)
    return filenames


def _align_and_bedgraph(genome_fasta, kmers_filename, tempdir):
    """Per chunk: align, then the bedgraph, then drop the chunk and its
    alignments, so that no more than one chunk's SAM is ever on disk.
    Returns {chunk: bedgraph filename}."""
    chunk_template = os.path.join(tempdir, 'kmers_chunk_{}.fa')
    chunk_files = _split_kmers(kmers_filename, chunk_template)

    bedgraph_files = {}
    for idx, chunk_file in enumerate(chunk_files):
        alignment_file = os.path.join(tempdir, f'alignments_{idx}.sam')
        _bwa_mem_to_file(genome_fasta, chunk_file, alignment_file)
        bedgraph_file = os.path.join(tempdir, f'bedgraph_{idx}.tsv')
        remixt_tpu_torch.mappability.tasks.create_bedgraph(alignment_file,
                                                           bedgraph_file)
        os.remove(alignment_file)
        os.remove(chunk_file)
        bedgraph_files[idx] = bedgraph_file
    return bedgraph_files


def create_bwa_mappability_workflow(config, ref_data_dir, tempdir):
    """The workflow that writes the config's ``mappability`` store from its
    ``genome_fasta``. An HDF5 store (a name ending in ``.h5``, as the
    default's) needs h5py: without it this raises at once, before any
    work."""
    mappability_length = remixt_tpu_torch.config.get_param(
        config, 'mappability_length')
    genome_fasta = remixt_tpu_torch.config.get_filename(
        config, ref_data_dir, 'genome_fasta')
    mappability_filename = remixt_tpu_torch.config.get_filename(
        config, ref_data_dir, 'mappability')
    if is_hdf5(mappability_filename) and not importlib.util.find_spec(
            'h5py'):
        raise ImportError(
            'the mappability store {} is an HDF5 file, which needs h5py; '
            'set mappability_filename in the config to a name without .h5 '
            'to write it as a directory'.format(mappability_filename))

    os.makedirs(tempdir, exist_ok=True)
    kmers_filename = os.path.join(tempdir, 'kmers.fa')

    workflow = Workflow('bwa_mappability')

    workflow.transform(
        'create_kmers',
        remixt_tpu_torch.mappability.tasks.create_kmers,
        args=(genome_fasta, mappability_length, kmers_filename),
        inputs=[genome_fasta],
        outputs=[kmers_filename],
    )

    bedgraphs = workflow.transform(
        'align_and_bedgraph',
        _align_and_bedgraph,
        args=(genome_fasta, kmers_filename, tempdir),
        inputs=[kmers_filename],
    )

    workflow.transform(
        'merge_bedgraph',
        remixt_tpu_torch.mappability.tasks.merge_files_by_line,
        args=(bedgraphs, mappability_filename),
        outputs=[mappability_filename],
    )

    return workflow
