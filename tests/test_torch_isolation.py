"""The port stands alone: importing every module of ``remixt_tpu_torch``
loads neither JAX nor the JAX package, nor pandas, scikit-learn, h5py,
PyYAML, networkx or matplotlib (which the GPU machine may lack); no source
of the port, of ``chip_smoke.py`` or of ``run_whole_genome.py`` imports
JAX, the JAX package, pandas or scikit-learn, nor h5py, PyYAML or networkx
outside a function; and the
entry points, the measurement tools among them, refuse to fall back to the
CPU when no CUDA device was asked for and none exists."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import remixt_tpu_torch

# the tensors are tiny: one intra-op thread is faster, and the suite runs
# several test workers on the machine's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, 'remixt_tpu_torch')


def port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            remixt_tpu_torch.__path__, prefix='remixt_tpu_torch.'))


def test_importing_every_module_loads_no_jax():
    modules = port_modules()
    assert 'remixt_tpu_torch.models.engine' in modules
    assert 'remixt_tpu_torch.ops.fb_grouped' in modules
    assert 'remixt_tpu_torch.ops.fb_chains' in modules
    assert 'remixt_tpu_torch.tools.sweep_budget' in modules
    code = (
        'import importlib, sys\n'
        'for name in {!r}:\n'
        '    importlib.import_module(name)\n'
        'bad = sorted(m for m in sys.modules\n'
        '             if m.split(".")[0] in ("jax", "jaxlib")\n'
        '             or m == "remixt_tpu" or m.startswith("remixt_tpu."))\n'
        'assert not bad, bad\n').format(modules)
    subprocess.run([sys.executable, '-c', code], check=True, cwd=REPO)


def test_importing_every_module_loads_no_optional_package():
    """pandas, scikit-learn and matplotlib are never used; h5py, PyYAML and
    networkx are imported only inside the functions that need them."""
    modules = port_modules()
    assert 'remixt_tpu_torch.simulations.balanced' in modules
    for name in ('seqdataio', 'io.bamreader', 'analysis.haplotype',
                 'analysis.gcbias', 'analysis.segment', 'ui.run'):
        assert 'remixt_tpu_torch.' + name in modules, name
    code = (
        'import importlib, sys\n'
        'for name in {!r}:\n'
        '    importlib.import_module(name)\n'
        'bad = sorted(m for m in sys.modules if m.split(".")[0] in\n'
        '             ("pandas", "sklearn", "h5py", "yaml", "networkx",\n'
        '              "matplotlib"))\n'
        'assert not bad, bad\n').format(modules)
    subprocess.run([sys.executable, '-c', code], check=True, cwd=REPO)


def source_files():
    files = [os.path.join(REPO, 'chip_smoke.py'),
             os.path.join(REPO, 'run_whole_genome.py')]
    for root, _, names in os.walk(PACKAGE):
        files += [os.path.join(root, n) for n in names
                  if n.endswith(('.py', '.cu'))]
    return files


@pytest.mark.parametrize('path', source_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    with open(path) as f:
        text = f.read()
    assert not re.search(r'^\s*(?:import|from)\s+jax', text, re.M), path
    assert not re.search(r'\bremixt_tpu\.', text), path


@pytest.mark.parametrize('path', source_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_pandas_or_sklearn(path):
    with open(path) as f:
        text = f.read()
    assert not re.search(r'^\s*(?:import|from)\s+(?:pandas|sklearn)\b',
                         text, re.M), path
    assert not re.search(r'\bimport\s+(?:pandas|sklearn)\b', text), path


@pytest.mark.parametrize('path', source_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_optional_packages_inside_functions(path):
    """h5py, PyYAML and networkx only in an indented import; matplotlib
    nowhere."""
    with open(path) as f:
        text = f.read()
    assert not re.search(r'^(?:import|from)\s+(?:h5py|yaml|networkx)\b',
                         text, re.M), path
    assert not re.search(r'\bimport\s+matplotlib\b', text), path


def test_cli_fit_without_device_raises_without_cuda(monkeypatch, tmp_path):
    """The fit CLI without a device raises before it writes anything."""
    import remixt_tpu_torch.ui.fit

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    work_dir = tmp_path / 'work'
    results_file = tmp_path / 'results.h5'
    with pytest.raises(RuntimeError, match='CUDA'):
        remixt_tpu_torch.ui.fit.fit(
            str(tmp_path / 'counts.tsv'), str(tmp_path / 'breakpoints.tsv'),
            str(results_file), str(work_dir), config=None, min_length=None)
    assert not work_dir.exists() and not results_file.exists()


def test_fit_many_without_device_raises_without_cuda(monkeypatch):
    from remixt_tpu_torch.analysis import pipeline
    from remixt_tpu_torch.analysis.experiment import Experiment

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    experiment = Experiment([[3, 1, 10]] * 4, [1e5] * 4,
                            {(0, 1), (1, 2), (2, 3)}, {})
    init = {i: dict(mode_idx=0, h_normal=0.1, h_tumour=0.1, mix_frac=0.5,
                    divergence_weight=1e-7, max_depth=1e9) for i in range(2)}
    with pytest.raises(RuntimeError, match='CUDA'):
        pipeline.fit_many(experiment, init, {})


def test_single_restart_fit_without_device_raises_without_cuda(monkeypatch):
    from remixt_tpu_torch.analysis import pipeline
    from remixt_tpu_torch.analysis.experiment import Experiment

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    experiment = Experiment([[3, 1, 10]] * 4, [1e5] * 4,
                            {(0, 1), (1, 2), (2, 3)}, {})
    init = dict(mode_idx=0, h_normal=0.1, h_tumour=0.1, mix_frac=0.5,
                divergence_weight=1e-7, max_depth=1e9)
    with pytest.raises(RuntimeError, match='CUDA'):
        pipeline.fit(experiment, init, {})
    with pytest.raises(RuntimeError, match='CUDA'):
        pipeline.fit_many(experiment, {0: init}, {})


def test_model_spec_without_device_raises_without_cuda(monkeypatch):
    from remixt_tpu_torch.models import engine

    from helpers import make_problem

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    prob = make_problem(seed=0, N=12, M=2, cn_max=2, num_breakpoints=2)
    kwargs = {k: prob[k] for k in (
        'cn_states', 'brk_states', 'l', 'x', 'y', 'is_telomere',
        'breakpoint_idx', 'breakpoint_orient', 'transition_penalty',
        'normal_contamination')}
    with pytest.raises(RuntimeError, match='CUDA'):
        engine.ModelSpec(**kwargs)
    assert engine.ModelSpec(device='cpu', **kwargs).device.type == 'cpu'


@pytest.mark.parametrize('tool, argv', [
    ('sweep_budget', []), ('sweep_budget', ['--standalone']),
    ('fit_budget', []), ('fit_budget', ['--trace']),
    ('probe_restart_scaling', ['8']),
    ('profile_engine', ['--outdir', 'trace'])])
def test_measurement_tools_without_device_raise_without_cuda(
        monkeypatch, tmp_path, tool, argv):
    """The measurement tools without ``--device`` raise before they build
    their problem or write anything."""
    import importlib

    module = importlib.import_module('remixt_tpu_torch.tools.' + tool)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='CUDA'):
        module.main(['--n', '30', '--events', '2'] + argv)
    assert os.listdir(tmp_path) == []
