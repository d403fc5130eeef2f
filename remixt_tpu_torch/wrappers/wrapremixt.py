"""The benchmark wrapper of this package's own run: seqdata → counts →
fit → results (counterpart of ``remixt_tpu/wrappers/wrapremixt.py``)."""

import os

from remixt_tpu_torch import workflow


class ReMixTTool:
    """``device`` is the torch device of the fit (``None`` means CUDA,
    which raises without one)."""

    def __init__(self, config, ref_data_dir, device=None):
        self.config = config
        self.ref_data_dir = ref_data_dir
        self.device = device

    def create_workflow(self, seqdata_filenames, breakpoints_filename,
                        results_filename, workdir, normal_id=None):
        os.makedirs(workdir, exist_ok=True)
        tumour_ids = [k for k in seqdata_filenames if k != normal_id]
        # the wrapper protocol hands us ONE results file; mapping several
        # tumours onto it would make the fits overwrite each other
        if len(tumour_ids) != 1:
            raise ValueError(
                'remixt wrapper supports exactly one tumour sample per '
                'results file; got {}'.format(sorted(tumour_ids)))
        return workflow.create_remixt_seqdata_workflow(
            breakpoints_filename,
            seqdata_filenames,
            {tumour_ids[0]: results_filename},
            workdir,
            self.config,
            self.ref_data_dir,
            normal_id=normal_id,
            device=self.device,
        )
