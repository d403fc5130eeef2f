"""Simulation workflows: read simulation and real-read resampling.

Counterpart of ``remixt_tpu/simulations/workflow.py`` on the port's
scheduler. The germline allele store in ``tempdir`` is an HDF5 file where
h5py is installed, else a directory (``io/store.store_name``).
"""

import os

from remixt_tpu_torch.io.store import store_name
from remixt_tpu_torch.scheduler import Workflow
from remixt_tpu_torch.simulations import pipeline as sim_pipeline


def _mixture_tasks(workflow, sim_defs, mixture_filename, breakpoint_filename,
                   config, ref_data_dir, tempdir):
    """The germline alleles, the genome mixture and its breakpoint table;
    returns the germline allele store's name."""
    os.makedirs(tempdir, exist_ok=True)
    germline_alleles_file = store_name(
        os.path.join(tempdir, 'germline_alleles'))
    workflow.transform(
        'simulate_germline_alleles',
        sim_pipeline.simulate_germline_alleles,
        args=(germline_alleles_file, sim_defs, config, ref_data_dir),
        outputs=[germline_alleles_file],
    )
    workflow.transform(
        'simulate_genome_mixture',
        sim_pipeline.simulate_genome_mixture,
        args=(mixture_filename, None, sim_defs),
        outputs=[mixture_filename],
    )
    workflow.transform(
        'write_breakpoints',
        sim_pipeline.write_breakpoints,
        args=(breakpoint_filename, mixture_filename),
        inputs=[mixture_filename],
        outputs=[breakpoint_filename],
    )
    return germline_alleles_file


def create_read_simulation_workflow(sim_defs, normal_filename, tumour_filename,
                                    mixture_filename, breakpoint_filename,
                                    config, ref_data_dir, tempdir):
    """Simulate the genome mixture, the germline alleles and the normal
    and tumour seqdata."""
    workflow = Workflow('read_simulation')
    germline_alleles_file = _mixture_tasks(
        workflow, sim_defs, mixture_filename, breakpoint_filename, config,
        ref_data_dir, tempdir)
    for name, func, filename in (
            ('simulate_normal_data', sim_pipeline.simulate_normal_data,
             normal_filename),
            ('simulate_tumour_data', sim_pipeline.simulate_tumour_data,
             tumour_filename)):
        workflow.transform(
            name, func,
            args=(filename, mixture_filename, germline_alleles_file,
                  sim_defs),
            inputs=[mixture_filename, germline_alleles_file],
            outputs=[filename],
        )
    return workflow


def create_resample_simulation_workflow(sim_defs, source_normal_filename,
                                        source_tumour_filename,
                                        normal_filename, tumour_filename,
                                        mixture_filename, breakpoint_filename,
                                        config, ref_data_dir, tempdir):
    """Resample real seqdata to a simulated mixture's depths."""
    workflow = Workflow('resample_simulation')
    germline_alleles_file = _mixture_tasks(
        workflow, sim_defs, mixture_filename, breakpoint_filename, config,
        ref_data_dir, tempdir)
    for name, func, source, filename in (
            ('resample_normal_data', sim_pipeline.resample_normal_data,
             source_normal_filename, normal_filename),
            ('resample_tumour_data', sim_pipeline.resample_tumour_data,
             source_tumour_filename, tumour_filename)):
        workflow.transform(
            name, func,
            args=(filename, source, mixture_filename, germline_alleles_file,
                  sim_defs),
            inputs=[source, mixture_filename, germline_alleles_file],
            outputs=[filename],
        )
    return workflow
