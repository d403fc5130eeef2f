"""The port's multi-process entry points on the CPU, with gloo: two
processes bring up ``parallel.distributed.initialize``, build the global
(restart, chain, block) mesh over both processes' devices
(``global_devices``, two CPU devices a process), and each checks the
shards it holds of a restart-sharded sweep against the port's and the JAX
package's single-device sweeps of the same inputs (float64, atol 1e-9),
as ``tests/test_multihost.py`` and ``tests/multihost_worker.py`` do for
the JAX package. The worker is this file run as a script:

    python tests/test_torch_multihost.py PROCESS_ID NUM_PROCESSES PORT

Also a one-process group brought up and torn down in this process, as
``chip_smoke.py`` phase 15 (e) does with NCCL on the card.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each worker process's wait for the other and its sweep
WORKER_TIMEOUT_S = 120


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def worker(process_id, num_processes, port):
    """One process: the group, the global mesh, the sweep of its shards."""
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    from helpers import make_problem
    from remixt_tpu_torch.models import engine as eng
    from remixt_tpu_torch.parallel import distributed
    from remixt_tpu_torch.parallel import restarts as par
    import torch.distributed as dist

    distributed.initialize(
        coordinator_address='localhost:{}'.format(port),
        num_processes=num_processes, process_id=process_id,
        timeout_s=WORKER_TIMEOUT_S)
    assert dist.get_backend() == 'gloo'
    assert distributed.world_size() == num_processes
    assert distributed.rank() == process_id
    # a group that is up stays as it is
    distributed.initialize(coordinator_address='localhost:1',
                           num_processes=5, process_id=3)
    assert distributed.world_size() == num_processes
    assert distributed.cohort_partition(['b', 'a', 'c', 'd']) == \
        ['a', 'b', 'c', 'd'][process_id::num_processes]

    local = [torch.device('cpu')] * 2
    mesh = distributed.make_training_mesh(
        devices=distributed.global_devices(local))
    n_global = mesh.size
    assert n_global == num_processes * len(local)
    assert mesh.shape['restart'] == n_global
    assert len(mesh.addressable_devices) == len(local)
    assert mesh.processes.reshape(-1).tolist() == sorted(
        list(range(num_processes)) * len(local))

    prob = make_problem(seed=2, N=18, M=2, cn_max=2, num_breakpoints=3,
                        num_telomeres=2)
    kwargs = dict(
        cn_states=prob['cn_states'], brk_states=prob['brk_states'],
        l=prob['l'], x=prob['x'], y=prob['y'],
        is_telomere=prob['is_telomere'],
        breakpoint_idx=prob['breakpoint_idx'],
        breakpoint_orient=prob['breakpoint_orient'],
        transition_penalty=prob['transition_penalty'],
        normal_contamination=prob['normal_contamination'])
    spec = eng.ModelSpec(dtype=torch.float64, device='cpu', **kwargs)

    R = n_global
    h_inits = [prob['h_init'] * (1.0 + 0.05 * r) for r in range(R)]
    params_list = [spec.init_params(h, prob['divergence_weight'])
                   for h in h_inits]
    jax_marginals = jax_sweeps(kwargs, h_inits, prob['divergence_weight'])
    # every process holds the whole host copy and keeps its shards of it
    params_b = par.shard_restarts(mesh, eng.stack(params_list))
    state_b = par.shard_restarts(mesh, eng.stack([spec.init_state()] * R))
    out = par.make_sharded_sweep(spec, mesh)(params_b, state_b)

    shards = out.posterior_marginals.addressable_shards
    assert len(shards) == len(local)
    for lo, got in shards:
        for row, r in enumerate(range(lo, lo + got.shape[0])):
            expected = eng.variational_sweep(spec, params_list[r],
                                             spec.init_state())
            np.testing.assert_allclose(
                got[row].numpy(), expected.posterior_marginals.numpy(),
                atol=1e-9)
            np.testing.assert_allclose(got[row].numpy(), jax_marginals[r],
                                       atol=1e-9)
    with pytest.raises(ValueError, match='another process'):
        par.gather(out.posterior_marginals, 'cpu')
    dist.barrier()
    dist.destroy_process_group()
    print('MULTIHOST_WORKER_OK process={}'.format(process_id), flush=True)


def jax_sweeps(spec_kwargs, h_inits, divergence_weight):
    """The JAX package's single-device sweep of each restart on the same
    inputs, float64: its posterior marginals."""
    import jax
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp
    from remixt_tpu.models import engine as jeng
    jspec = jeng.ModelSpec(dtype=jnp.float64, **spec_kwargs)
    sweep = jax.jit(lambda p, s: jeng.variational_sweep(jspec, p, s))
    return [np.asarray(sweep(jspec.init_params(h, divergence_weight),
                             jspec.init_state()).posterior_marginals)
            for h in h_inits]


def test_two_process_distributed_sweep():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS='cpu')
    env.pop('WORLD_SIZE', None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(pid), '2',
             str(port)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outputs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=WORKER_TIMEOUT_S)
            outputs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for pid, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, 'worker {} failed:\n{}'.format(pid, out)
        assert 'MULTIHOST_WORKER_OK process={}'.format(pid) in out


def test_one_process_group_up_and_down(monkeypatch):
    import torch.distributed as dist
    from remixt_tpu_torch.parallel import distributed

    monkeypatch.delenv('WORLD_SIZE', raising=False)
    # a single process without a coordinator brings nothing up
    distributed.initialize()
    assert not dist.is_initialized()
    distributed.initialize(coordinator_address='localhost:{}'.format(
        _free_port()), num_processes=1, process_id=0, timeout_s=60)
    try:
        assert dist.is_initialized() and dist.get_backend() == 'gloo'
        assert (distributed.rank(), distributed.world_size()) == (0, 1)
        assert distributed.cohort_partition(['y', 'x']) == ['x', 'y']
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
    assert distributed.cohort_partition(['y', 'x']) == ['x', 'y']


if __name__ == '__main__':
    sys.path.insert(0, REPO)
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
