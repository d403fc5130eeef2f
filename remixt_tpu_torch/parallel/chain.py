"""Chain-axis and block-axis sharding (counterpart of
``remixt_tpu/parallel/chain.py``).

The genome chain factorizes exactly at telomere junctions, so the
batched chain axis (Q chromosomes) splits over devices with no exchange
inside the forward-backward scan: :func:`enable_chain_sharding` gives a
``ModelSpec`` contiguous groups of chains, one per device of the mesh's
``chain`` axis, and both chain updates then run each group on its device
(``ops/fb_scan.forward_backward_chain_groups``): through the
``fb_grouped`` kernel, or through the plain scan where the spec's
``use_kernels`` is off, as the JAX engine takes its XLA scan under a
chain constraint. Only the per-group log normalizers and the messages
come back to the spec's device.

:func:`enable_block_sharding` splits every chain's positions into blocks
(``ops/fb_blocked.py``) over the mesh's ``block`` axis: one chromosome
then spans devices, and only the (Q, B, S, S) transfer stack crosses
them. With the restart axis (``parallel/restarts.py``) this gives the 2D
(restart × chain) training step, :func:`make_2d_train_step`.
"""

from remixt_tpu_torch.ops import fb_scan
from remixt_tpu_torch.parallel import restarts as par


def enable_chain_sharding(spec, mesh, axis='chain'):
    """Split the spec's chains over the devices of ``mesh``'s ``axis``
    (at index 0 of its other axes; a restart shard's sub-mesh gives its
    own). ``mesh=None`` restores the plain route. Returns the spec."""
    if mesh is None:
        spec.chain_devices = spec.chain_groups = None
        return spec
    devices = mesh.axis_devices(axis)
    spec.chain_groups = fb_scan.chain_groups(
        spec.chain_bank_idx.cpu().numpy(), spec.chain_last.cpu().numpy(),
        spec.num_static_bank, devices, spec.device)
    spec.chain_devices = devices
    return spec


def enable_block_sharding(spec, mesh, num_blocks, axis='block'):
    """Scan every chain of the single-restart chain update in
    ``num_blocks`` position blocks (``ops/fb_blocked.py``), the blocks
    over the devices of ``mesh``'s ``axis``. ``mesh=None`` keeps the
    blocking on the spec's device; ``num_blocks=1`` restores the plain
    chain-batched scan. Returns the spec."""
    spec.num_chain_blocks = int(num_blocks)
    spec.block_devices = (None if mesh is None or num_blocks <= 1
                          else mesh.axis_devices(axis))
    return spec


def make_2d_train_step(spec, mesh, restart_axis='restart',
                       chain_axis='chain', h_step=0.0):
    """Training step over a 2D (restart × chain) mesh: restart shards run
    at once (``parallel/restarts.train_step`` on each), and each shard's
    replica of ``spec`` scans its chains over its row of the chain axis.
    Returns ``step(params_b, state_b) -> (params_b, state_b, ell)``, like
    ``parallel.restarts.make_sharded_train_step``; with ``mesh=None`` the
    plain route on the spec's device."""
    enable_chain_sharding(spec, mesh, axis=chain_axis)
    if mesh is None:
        return lambda params_b, state_b: par.train_step(
            spec, params_b, state_b, h_step)
    par.replicate_spec(mesh, spec, restart_axis)
    return par.make_sharded_train_step(spec, mesh, axis=restart_axis,
                                       h_step=h_step)
