"""Restart fan-out over a device mesh (counterpart of
``remixt_tpu/parallel/restarts.py``).

The restart axis (depth modes × mixture fractions × divergence weights)
is embarrassingly parallel. A restart-stacked pytree (NamedTuples, tuples,
lists and dicts of tensors with a leading restart axis) is split over the
``restart`` axis of a :class:`~remixt_tpu_torch.parallel.distributed.Mesh`
into contiguous blocks, one per restart shard, each on its shard's first
device: its leaves become :class:`ShardedTensor`, as ``P('restart')``
makes them global arrays in the JAX package.

:func:`shard_restart_fn` runs a restart-batched function on each shard
this process can address, one after another in the calling thread, each
under its first device's context. A CUDA shard's launches return before
its card finishes, so shards on several cards overlap their device work.
Every shard runs the single-device program at the shard's restart extent,
on its own replica of the model spec (:func:`replicate_spec`): restarts
never interact, so a restart's result is the single-device fit's at
that extent, bit for bit on the same device. JAX's ``restart_sharding``
(``NamedSharding`` objects) has no counterpart.
"""

import numpy as np
import torch

from remixt_tpu_torch.models import engine as eng
from remixt_tpu_torch.parallel.distributed import Mesh, local_cuda_devices


# ---------------------------------------------------------------------------
# pytrees
# ---------------------------------------------------------------------------

def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, '_fields')


def tree_map(fn, *trees):
    """``fn`` over the leaves of same-structured trees (NamedTuples,
    tuples, lists and dicts; anything else is a leaf)."""
    first = trees[0]
    if _is_namedtuple(first):
        return type(first)(*[tree_map(fn, *xs) for xs in zip(*trees)])
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(first, dict):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in first}
    return fn(*trees)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _tree_unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# a list of same-structured pytrees stacked on a new leading axis
stack_pytrees = eng.stack


def pad_restarts(pytree, total, axis=0):
    """Pad a restart-stacked pytree to ``total`` entries by repeating the
    last restart (device-count divisibility for sharding; padded entries
    are discarded by the caller)."""
    def pad_leaf(x):
        r = x.shape[axis]
        if r >= total:
            return x
        last = x.new_full((total - r,), r - 1, dtype=torch.long)
        return torch.cat([x, torch.index_select(x, axis, last)], dim=axis)
    return tree_map(pad_leaf, pytree)


# ---------------------------------------------------------------------------
# sharded restart-stacked tensors
# ---------------------------------------------------------------------------

class ShardedTensor:
    """A restart-stacked tensor split over a mesh's restart shards:
    ``blocks[i]`` holds shard i's contiguous restarts on its first device,
    or is None where another process holds them; ``sizes[i]`` is its
    restart count."""

    def __init__(self, mesh, blocks, sizes):
        self.mesh = mesh
        self.blocks = list(blocks)
        self.sizes = list(sizes)

    @property
    def addressable_shards(self):
        """(first restart, block) of each block this process holds."""
        starts = np.concatenate([[0], np.cumsum(self.sizes)[:-1]])
        return [(int(s), b) for s, b in zip(starts, self.blocks)
                if b is not None]


def _shards(mesh, axis):
    """The restart shards of ``mesh``: (sub-mesh, first device, whether
    this process owns it)."""
    out = []
    for shard in mesh.restart_shards(axis):
        mine = shard.processes == shard.process_index
        if mine.any() and not mine.all():
            raise ValueError('a restart shard spans processes: {}'.format(
                shard))
        out.append((shard, shard.devices.reshape(-1)[0], bool(mine.all())))
    return out


def make_restart_mesh(devices=None, axis='restart'):
    """A 1-d mesh over ``devices`` (None: every local CUDA device)."""
    if devices is None:
        devices = local_cuda_devices()
    return Mesh(list(devices), (axis,))


def shard_restarts(mesh, pytree, axis='restart'):
    """Split a restart-stacked pytree over the restart shards of ``mesh``,
    each block on its shard's first device. The restart count must divide
    by the number of shards; leaves that are sharded already stay as they
    are."""
    shards = _shards(mesh, axis)
    n = len(shards)

    def split(x):
        if isinstance(x, ShardedTensor):
            return x
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError('{} restarts do not split over {} shards'.format(
                x.shape[0], n))
        k = x.shape[0] // n
        return ShardedTensor(
            mesh, [x[i * k:(i + 1) * k].to(home) if mine else None
                   for i, (_, home, mine) in enumerate(shards)], [k] * n)

    return tree_map(split, pytree)


def gather(pytree, device):
    """A sharded pytree whole on ``device`` (every shard must be this
    process's); unsharded leaves are moved there."""
    def cat(x):
        if not isinstance(x, ShardedTensor):
            return x.to(device)
        if any(b is None for b in x.blocks):
            raise ValueError('a shard of this tensor is another process\'s')
        return torch.cat([b.to(device) for b in x.blocks])
    return tree_map(cat, pytree)


# ---------------------------------------------------------------------------
# spec replicas
# ---------------------------------------------------------------------------

def replicate_spec(mesh, spec, axis='restart'):
    """Make and keep on ``mesh`` one replica of ``spec`` per restart shard
    this process owns (None for the others): its tensors on the shard's
    first device, and, where ``spec`` shards its chains or blocks, those
    over the shard's own devices. Returns the list."""
    from remixt_tpu_torch.parallel import chain
    replicas = []
    for shard, home, mine in _shards(mesh, axis):
        if not mine:
            replicas.append(None)
            continue
        replica = eng.replicate(spec, home)
        if spec.chain_devices is not None:
            chain.enable_chain_sharding(replica, shard)
        if spec.block_devices is not None:
            chain.enable_block_sharding(replica, shard,
                                        spec.num_chain_blocks)
        replicas.append(replica)
    mesh.replicas[spec] = replicas
    return replicas


def spec_replicas(mesh, spec, axis='restart'):
    """The replicas of ``spec`` kept on ``mesh``, made on first use."""
    replicas = mesh.replicas.get(spec)
    return (replicas if replicas is not None
            else replicate_spec(mesh, spec, axis))


# ---------------------------------------------------------------------------
# running a restart-batched function per shard
# ---------------------------------------------------------------------------

def _replicate(value, index, home, mesh, axis):
    """A replicated argument as shard ``index`` sees it."""
    def leaf(x):
        if isinstance(x, eng.ModelSpec):
            return spec_replicas(mesh, x, axis)[index]
        if torch.is_tensor(x):
            return x.to(home)
        return x
    return tree_map(leaf, value)


def _run_on(home, fn, args):
    """``fn(*args)``, under ``home``'s context on a CUDA device."""
    if home.type != 'cuda':
        return fn(*args)
    with torch.cuda.device(home):
        return fn(*args)


def shard_restart_fn(mesh, fn, n_batched, n_replicated=0, axis='restart'):
    """Run a restart-batched function on every restart shard of ``mesh``
    this process owns.

    The first ``n_batched`` arguments are restart-stacked pytrees, split
    over the shards (``shard_restarts``) unless sharded already; the next
    ``n_replicated`` go to every shard whole: tensors moved to the shard's
    first device, a ``ModelSpec`` as the shard's replica, anything else as
    it is. Every output leaf is restart-stacked and comes back as a
    :class:`ShardedTensor`. The shards run one after another.
    """
    def run(*args):
        if len(args) != n_batched + n_replicated:
            raise TypeError('expected {} arguments, got {}'.format(
                n_batched + n_replicated, len(args)))
        shards = _shards(mesh, axis)
        batched = shard_restarts(mesh, tuple(args[:n_batched]), axis)
        sizes = tree_leaves(batched)[0].sizes
        outputs = {}
        for i, (_, home, mine) in enumerate(shards):
            if mine:
                outputs[i] = _run_on(home, fn, tree_map(
                    lambda x, i=i: x.blocks[i], batched) + tuple(
                        _replicate(a, i, home, mesh, axis)
                        for a in args[n_batched:]))
        template = next(iter(outputs.values()))
        per_leaf = {i: tree_leaves(out) for i, out in outputs.items()}
        leaves = [ShardedTensor(mesh, [per_leaf[i][k] if i in per_leaf
                                       else None
                                       for i in range(len(shards))], sizes)
                  for k in range(len(tree_leaves(template)))]
        return _tree_unflatten(template, leaves)

    return run


def spec_fn(mesh, fn, n_batched):
    """``fn(spec, *batched, *rest)`` as it is without a mesh, or per
    restart shard of ``mesh``, each shard with its replica of ``spec``
    and ``rest`` replicated: the port's form of the JAX package's
    ``shard_restart_fn(mesh, partial(fn, spec), n_batched)``."""
    if mesh is None:
        return fn

    def run(spec, *args):
        rest = args[n_batched:]
        sharded = shard_restart_fn(
            mesh, lambda *a: fn(a[n_batched], *a[:n_batched],
                                *a[n_batched + 1:]),
            n_batched, 1 + len(rest))
        return sharded(*args[:n_batched], spec, *rest)

    return run


# ---------------------------------------------------------------------------
# the JAX package's sharded steps
# ---------------------------------------------------------------------------

def make_sharded_sweep(spec, mesh, axis='restart'):
    """Restart-sharded variational sweep: (params_b, state_b) -> state_b,
    the restart-batched sweep (``engine.variational_sweeps_restarts``)
    on every shard."""
    run = shard_restart_fn(
        mesh, lambda p, s, sp: eng.variational_sweeps_restarts(sp, p, s, 1),
        2, 1, axis)
    return lambda params_b, state_b: run(params_b, state_b, spec)


def train_step(spec, params_b, state_b, h_step=0.0):
    """One training step of a restart batch on one device: each restart's
    variational sweep through the single-restart route, then its expected
    log likelihood and h gradient (``torch.autograd``), as the JAX
    package vmaps ``variational_sweep`` and ``value_and_grad`` of
    ``expected_log_likelihood``. With ``h_step`` > 0, a projected
    gradient-ascent step on h. Returns (params_b, state_b, ell)."""
    states, ells, grads = [], [], []
    for r in range(params_b.h.shape[0]):
        params = eng.take(params_b, r)
        state = eng.variational_sweep(spec, params, eng.take(state_b, r))
        h = params.h.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            ell = eng.expected_log_likelihood(spec, params._replace(h=h),
                                              state)
            (grad,) = torch.autograd.grad(ell, h)
        states.append(state)
        ells.append(ell.detach())
        grads.append(grad)
    state_b = eng.stack(states)
    if h_step > 0.0:
        params_b = params_b._replace(h=torch.clamp(
            params_b.h + h_step * torch.stack(grads), 1e-8, 10.0))
    return params_b, state_b, torch.stack(ells)


def make_sharded_train_step(spec, mesh, axis='restart', h_step=0.0):
    """Restart-sharded training step (:func:`train_step` on every shard):
    (params_b, state_b) -> (params_b, state_b, ell). The production fit
    uses the backtracking h update of :mod:`remixt_tpu_torch.models.em`;
    the fixed step serves the multichip dry run."""
    run = shard_restart_fn(
        mesh, lambda p, s, sp: train_step(sp, p, s, h_step), 2, 1, axis)
    return lambda params_b, state_b: run(params_b, state_b, spec)
