"""Processes and device meshes (counterpart of
``remixt_tpu/parallel/distributed.py``).

* :func:`initialize` brings up a ``torch.distributed`` process group (NCCL
  where CUDA is present, gloo otherwise), as the JAX package brings up
  ``jax.distributed``.
* :class:`Mesh` holds devices on named axes, as ``jax.sharding.Mesh``
  does: an ndarray of ``torch.device``, the process that owns each, and the
  axis names. :func:`make_training_mesh` lays the framework's mesh out
  over ``(restart, chain, block)``: restarts outermost (fully independent
  fits), chains next (no communication inside the scan), blocks innermost
  (the blocked scan's transfer-matrix exchange, ``ops/fb_blocked.py``).
* :func:`cohort_partition` deals a sample cohort to the processes: the
  sample ids sorted by ``str`` and dealt round-robin, so every process
  computes the same assignment without communication. The rank and the
  number of processes come from the process group when one is
  initialized, else this is the only process.
"""

import datetime
import os
import weakref

import numpy as np


def _group():
    """The initialized default process group's module, or None."""
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def rank():
    """This process's rank: 0 without a process group."""
    dist = _group()
    return dist.get_rank() if dist is not None else 0


def world_size():
    """The number of processes: 1 without a process group."""
    dist = _group()
    return dist.get_world_size() if dist is not None else 1


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               timeout_s=300):
    """Bring up the ``torch.distributed`` process group (no-op if one is
    up already).

    With ``coordinator_address`` (``host:port`` of rank 0), the group has
    ``num_processes`` processes and this one is ``process_id``; a failed
    bring-up raises. Without it, a launcher's environment (``WORLD_SIZE``
    above 1 with ``MASTER_ADDR``, ``MASTER_PORT`` and ``RANK``, as
    ``torchrun`` sets them) is read; a single process does nothing. The
    backend is NCCL when CUDA is available, else gloo.
    """
    import torch
    import torch.distributed as dist

    if _group() is not None:
        return
    if coordinator_address is None:
        if int(os.environ.get('WORLD_SIZE', '1')) <= 1:
            return
        init_method = 'env://'
    else:
        init_method = (coordinator_address if '://' in coordinator_address
                       else 'tcp://' + coordinator_address)
    backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


def factor_devices(n_devices, num_restarts=None, num_blocks=None):
    """Split a device count into (restart, chain, block) extents.

    Preference order: fill the block axis up to ``num_blocks`` (innermost,
    ICI), then restarts up to ``num_restarts``, remainder to chains.
    """
    def largest_divisor_leq(n, cap):
        best = 1
        for d in range(1, n + 1):
            if n % d == 0 and d <= cap:
                best = d
        return best

    n_block = largest_divisor_leq(n_devices, num_blocks or 1)
    remaining = n_devices // n_block
    n_restart = largest_divisor_leq(remaining, num_restarts or remaining)
    n_chain = remaining // n_restart
    return n_restart, n_chain, n_block


def _object_array(items, shape):
    out = np.empty(len(items), dtype=object)
    out[:] = items
    return out.reshape(shape)


class Mesh:
    """Devices on named axes.

    ``devices`` is an ndarray of ``torch.device`` (a device may appear more
    than once: virtual devices, one card or CPU listed several times);
    ``processes`` the rank that owns each entry; ``shape`` maps each axis
    name to its extent, as ``jax.sharding.Mesh.shape`` does. An entry is
    addressable when this process owns it.
    """

    def __init__(self, devices, axis_names, processes=None):
        import torch
        devices = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in devices.reshape(-1)]
        self.devices = _object_array(flat, devices.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError('{} axis names for a {}-d device array'.format(
                len(self.axis_names), self.devices.ndim))
        self.processes = (np.zeros(self.devices.shape, dtype=np.int64)
                          if processes is None else
                          np.asarray(processes, dtype=np.int64).reshape(
                              self.devices.shape))
        self.process_index = rank()
        # per-spec replicas made by parallel.restarts.replicate_spec
        self.replicas = weakref.WeakKeyDictionary()

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return self.devices.size

    @property
    def addressable_devices(self):
        """This process's entries, in the mesh's order."""
        return [d for d, p in zip(self.devices.reshape(-1),
                                  self.processes.reshape(-1))
                if p == self.process_index]

    def axis_devices(self, axis):
        """The devices along ``axis`` at index 0 of every other axis; the
        first device alone when the mesh has no such axis."""
        if axis not in self.axis_names:
            return [self.devices.reshape(-1)[0]]
        k = self.axis_names.index(axis)
        line = np.moveaxis(self.devices, k, 0).reshape(
            self.devices.shape[k], -1)[:, 0]
        return list(line)

    def restart_shards(self, axis='restart'):
        """One sub-mesh per index of ``axis`` (the whole mesh when it has
        no such axis), each with that axis of extent 1."""
        if axis not in self.axis_names:
            return [self]
        k = self.axis_names.index(axis)
        return [Mesh(np.take(self.devices, [i], axis=k), self.axis_names,
                     np.take(self.processes, [i], axis=k))
                for i in range(self.devices.shape[k])]

    def __repr__(self):
        return 'Mesh({}, {})'.format(self.shape, [
            str(d) for d in self.devices.reshape(-1)])


def global_devices(local_devices):
    """Every process's ``local_devices`` as ``(rank, device)`` pairs in
    rank order, gathered over the process group; this process's alone
    without one."""
    import torch
    local = [str(torch.device(d)) for d in local_devices]
    dist = _group()
    if dist is None:
        return [(0, torch.device(d)) for d in local]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    return [(r, torch.device(d)) for r, names in enumerate(gathered)
            for d in names]


def local_cuda_devices():
    """Every local CUDA device, ``cuda:0`` to ``cuda:{n-1}``; raises
    without one."""
    import torch
    from remixt_tpu_torch.device import resolve_device
    resolve_device('cuda')
    return [torch.device('cuda', i)
            for i in range(torch.cuda.device_count())]


def make_training_mesh(devices=None, num_restarts=None, num_blocks=None):
    """The (restart, chain, block) mesh over ``devices``.

    ``devices``: torch devices (or names) of this process, a device may
    repeat; or ``(rank, device)`` pairs for a mesh over several processes,
    as :func:`global_devices` gives them. ``None`` means every process's
    local CUDA devices (raises without one): this process's alone without
    a process group. Extents from :func:`factor_devices`; the devices
    beyond their product are left out.
    """
    if devices is None:
        devices = global_devices(local_cuda_devices())
    devices = list(devices)
    if not devices:
        raise ValueError('a mesh needs at least one device')
    if all(isinstance(d, tuple) for d in devices):
        processes = [rank for rank, _ in devices]
        devices = [d for _, d in devices]
    else:
        processes = [rank()] * len(devices)
    n_restart, n_chain, n_block = factor_devices(
        len(devices), num_restarts, num_blocks)
    n = n_restart * n_chain * n_block
    shape = (n_restart, n_chain, n_block)
    return Mesh(_object_array(devices[:n], shape),
                ('restart', 'chain', 'block'),
                np.asarray(processes[:n]).reshape(shape))


def cohort_partition(sample_ids, process_id=None, process_count=None):
    """This process's share of the samples ``sample_ids``, in the order
    it fits them."""
    if process_id is None:
        process_id = rank()
    if process_count is None:
        process_count = world_size()
    ordered = sorted(sample_ids, key=str)
    return ordered[process_id::process_count]
