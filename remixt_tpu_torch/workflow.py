"""The fit workflow: init → the restart-grid fit → collate.

Counterpart of ``create_fit_model_workflow`` and ``fit_all_restarts`` of
``remixt_tpu/workflow.py``. ``init`` and ``collate`` are host-only numpy;
the fit task reaches the device, through ``fit_many(..., device)``.
"""

import os
import pickle

import remixt_tpu_torch.config
from remixt_tpu_torch.analysis import pipeline
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
    package's count-table workflow."""
    config = remixt_tpu_torch.config.get_sample_config(config, tumour_id)

    workflow = Workflow('fit_model')

    init_results_file = _temp(tempdir, 'init_results.h5')
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
