"""Layered configuration access: module defaults overlaid by the user's
config dict, with per-sample overrides under ``sample_specific``.
Counterpart of ``remixt_tpu/config.py`` (the parts the fit reads)."""

import remixt_tpu_torch.defaults


def _default_params():
    return {name: value
            for name, value in vars(remixt_tpu_torch.defaults).items()
            if not name.startswith('_')}


def get_param(config, name):
    """One parameter, user value or default; KeyError when unknown."""
    if name in config:
        return config[name]
    return _default_params()[name]


def get_sample_config(config, sample_id):
    """Config with this sample's ``sample_specific`` overrides applied."""
    merged = dict(config)
    merged.update(config.get('sample_specific', {}).get(sample_id, {}))
    return merged
