"""Per-component budget of one VI sweep of the port.

Two modes:

--trace (the default): profiles the production 5-sweep block
  (``engine.variational_sweeps_restarts`` over a wave of ``--restarts``
  restarts, or ``engine.variational_sweeps`` at ``--restarts 0``) under
  ``torch.profiler`` and buckets its device time by the engine's ``sweep_*``
  ranges (``engine.SWEEP_RANGES``): emissions, allele swap, breakend bank,
  chain update, q(brk), outlier updates. A range's time is that of the
  device events (kernels, copies, sets) inside its annotation on the
  device timeline (``attribute``); the block's device time is every
  device event of the window but those annotations; what no range holds
  is ``unattributed``, so the components and ``unattributed`` sum to the
  block's device time. On the CPU (tests) the buckets are CPU time, under
  keys that say ``cpu`` where the card's say ``device``. A profile on the
  card that shows no device time raises.

--standalone: times each piece as its own call, the host clock around the
  work ended by ``torch.cuda.synchronize()``. A piece called alone pays
  launch and allocation costs the block shares, so these are upper bounds,
  to compare runs of the same shape only. The chain update is timed
  under a prebuilt breakend bank, the bank being a piece of its own.

Prints the JSON and writes it only to ``--out``. Run:

    python -m remixt_tpu_torch.tools.sweep_budget [--n 6000] [--events 300] [--restarts 8]
    python -m remixt_tpu_torch.tools.sweep_budget --standalone [...]
    python -m remixt_tpu_torch.tools.sweep_budget --device cpu --n 260 --events 10
"""

import argparse
import bisect
import json
import platform
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from remixt_tpu_torch.device import resolve_device
from remixt_tpu_torch.models import engine as eng
from remixt_tpu_torch.tools.problem import build_problem, restart_wave


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def timeit(fn, device, iters=10, warmup=2):
    """Seconds per call of ``fn``: the host clock around ``iters`` calls
    after ``warmup``, ended by a device synchronise."""
    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / iters


def device_record(device):
    if device.type == 'cuda':
        return {'platform': 'gpu',
                'kind': torch.cuda.get_device_name(device)}
    return {'platform': 'cpu',
            'kind': platform.processor() or platform.machine()}


def profiled(device):
    """A ``torch.profiler.profile`` of the host and, on the card, the
    device."""
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def time_key(device):
    """The word of the keys that hold a profile's time: ``device`` on the
    card, ``cpu`` on the CPU."""
    return 'device' if device.type == 'cuda' else 'cpu'


def attribute(prof, ranges, device):
    """Split a profile's time by named range.

    On the card the time is device time, and a device event (a kernel, a
    copy, a set) falls in the range whose annotation holds it: the
    annotation the profiler mirrors onto the device timeline over the
    device work launched inside the range. That takes the kernels the port
    launches through ``ctypes``, which no operator row of
    ``key_averages()`` carries, and those the autograd engine launches from
    a thread of its own (the h update's backward), which run on the one
    stream between the range's own. The annotations are no device time.
    On the CPU the time is CPU time: a range's is the inclusive time of
    its occurrences.

    Returns ({range: us}, unattributed us, total us). The unattributed time
    is that of the events under no range, found apart from the ranges'
    time, so the two sum to the total only if no event falls under two
    ranges. Raises on the card for a window without device time.
    """
    events = [e for e in prof.events() if not e.is_async]
    buckets = {r: 0.0 for r in ranges}
    if device.type == 'cuda':
        on_device = [e for e in events if e.device_type == DeviceType.CUDA]
        spans = [e for e in on_device if e.name in ranges]
        work = sorted((e for e in on_device if e.name not in ranges
                       and not getattr(e, 'is_user_annotation', False)),
                      key=lambda e: e.time_range.start)
        total = sum(e.time_range.elapsed_us() for e in work)
        if total <= 0:
            raise RuntimeError('the profile shows no device time')
        starts = [e.time_range.start for e in work]
        held = [False] * len(work)
        for span in spans:
            start, end = span.time_range.start, span.time_range.end
            for i in range(bisect.bisect_left(starts, start),
                           bisect.bisect_right(starts, end)):
                if work[i].time_range.end <= end:
                    buckets[span.name] += work[i].time_range.elapsed_us()
                    held[i] = True
        unattributed = sum(e.time_range.elapsed_us()
                           for e, h in zip(work, held) if not h)
        return buckets, unattributed, total

    cpu_events = [e for e in events if e.device_type == DeviceType.CPU]
    under = set()
    for e in cpu_events:
        if e.name in ranges:
            buckets[e.name] += e.cpu_time_total
            stack = [e]
            while stack:
                child = stack.pop()
                under.add(id(child))
                stack.extend(child.cpu_children)
    total = sum(e.self_cpu_time_total for e in cpu_events)
    unattributed = sum(e.self_cpu_time_total for e in cpu_events
                       if id(e) not in under)
    return buckets, unattributed, total


def trace_attribution(spec, params, state, R, device, num_sweeps=5,
                      iters=5):
    """Bucket the production sweep block's time by sweep component (the
    engine's ranges)."""
    if R > 0:
        params, state = restart_wave(params, state, R)

        def block(s):
            return eng.variational_sweeps_restarts(spec, params, s,
                                                   num_sweeps)
    else:
        def block(s):
            return eng.variational_sweeps(spec, params, s, num_sweeps)

    state0 = block(state)
    sync(device)

    t0 = time.perf_counter()
    s = state0
    for _ in range(iters):
        s = block(s)
    sync(device)
    wall_block_ms = (time.perf_counter() - t0) / iters * 1e3

    with profiled(device) as prof:
        s = state0
        for _ in range(iters):
            s = block(s)
        sync(device)
    buckets, other, total = attribute(prof, eng.SWEEP_RANGES, device)

    # the window ran iters blocks of num_sweeps sweeps (emissions once a
    # block)
    scale = 1e-3 / iters
    key = time_key(device)
    out = {'N': spec.N, 'S': spec.S, 'K': spec.K, 'J': spec.J,
           'Q': spec.Q, 'L': spec.L, 'restarts': R,
           'use_kernels': bool(spec.use_kernels),
           'mode': 'trace',
           'num_sweeps_per_block': num_sweeps,
           'block_wall_ms': round(wall_block_ms, 3),
           'block_{}_ms'.format(key): round(total * scale, 3),
           'per_sweep_{}_ms'.format(key): round(
               total * scale / num_sweeps, 3)}
    for scope, us in buckets.items():
        name = scope.replace('sweep_', '')
        per_block = us * scale
        out[name + '_ms_per_block'] = round(per_block, 3)
        out[name + '_ms_per_sweep'] = round(per_block / num_sweeps, 3)
    out['unattributed_ms_per_block'] = round(other * scale, 3)
    # the ranges only; attributed + unattributed == the block's time
    out['sum_components_ms_per_block'] = round(
        sum(buckets.values()) * scale, 3)
    out['device'] = device_record(device)
    return out


@torch.no_grad()
def standalone_pieces(spec, params, state, R):
    """{piece: zero-argument call}: each sweep component at a settled
    (post-chain) state, and the whole sweep."""
    if R > 0:
        params, state = restart_wave(params, state, R)
        ll_tot, ll_alle = eng.emission_tensors(spec, params)
        state = eng.variational_sweeps_restarts(spec, params, state, 1)
        be_exp = eng.breakend_tmats_exp(spec, state.p_breakpoint)
        return {
            'emissions': lambda: eng.emission_tensors(spec, params),
            'p_allele_swap': lambda: eng.update_p_allele_swap_restarts(
                spec, state, ll_alle),
            'p_cn_chain': lambda: eng.update_p_cn_restarts(
                spec, params, state, ll_tot, ll_alle, be_exp),
            'be_bank': lambda: eng.breakend_tmats_exp(
                spec, state.p_breakpoint),
            'p_breakpoint': lambda: eng.update_p_breakpoint_restarts(
                spec, state, be_exp),
            'p_outlier_total': lambda: eng.update_p_outlier_total_restarts(
                spec, state, ll_tot),
            'p_outlier_allele': lambda: eng.update_p_outlier_allele_restarts(
                spec, state, ll_alle),
            'full_sweep': lambda: eng.variational_sweeps_restarts(
                spec, params, state, 1),
        }
    ll_tot, ll_alle = (x[0] for x in eng.emission_tensors(spec,
                                                          eng.one(params)))
    state = eng.variational_sweep(spec, params, state)
    be_exp = eng.breakend_tmats_exp(spec, state.p_breakpoint[None])[0]
    return {
        'emissions': lambda: eng.emission_tensors(spec, eng.one(params)),
        'p_allele_swap': lambda: eng.update_p_allele_swap(
            spec, params, state, ll_alle),
        'p_cn_chain': lambda: eng.update_p_cn(
            spec, params, state, ll_tot, ll_alle, be_exp=be_exp),
        'be_bank': lambda: eng.breakend_tmats_exp(
            spec, state.p_breakpoint[None]),
        'p_breakpoint': lambda: eng.update_p_breakpoint(
            spec, params, state, exp_tm_used=be_exp),
        'p_outlier_total': lambda: eng.update_p_outlier_total(
            spec, params, state, ll_tot),
        'p_outlier_allele': lambda: eng.update_p_outlier_allele(
            spec, params, state, ll_alle),
        'full_sweep': lambda: eng.variational_sweep(spec, params, state),
    }


def standalone(spec, params, state, R, device, iters=10):
    out = {'N': spec.N, 'S': spec.S, 'K': spec.K, 'J': spec.J,
           'Q': spec.Q, 'L': spec.L, 'restarts': R,
           'use_kernels': bool(spec.use_kernels),
           'mode': 'standalone_upper_bounds'}
    with torch.no_grad():
        for name, fn in standalone_pieces(spec, params, state, R).items():
            print('timing', name, '...', file=sys.stderr, flush=True)
            out[name + '_ms'] = round(
                timeit(fn, device, iters=iters) * 1e3, 3)
    # emissions amortize over the sweeps of a block
    out['sum_updates_ms'] = round(sum(
        v for k, v in out.items()
        if k.endswith('_ms') and k not in ('full_sweep_ms',
                                           'emissions_ms')), 3)
    out['device'] = device_record(device)
    return out


def write_json(out, path, indent=2):
    """Print ``out`` as JSON and, with ``path``, write it there too."""
    text = json.dumps(out, indent=indent)
    print(text)
    if path is not None:
        with open(path, 'w') as f:
            f.write(text + '\n')


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--n', type=int, default=6000)
    ap.add_argument('--events', type=int, default=300)
    ap.add_argument('--restarts', type=int, default=8)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--standalone', action='store_true',
                    help='per-component calls of their own (upper bounds) '
                         'instead of the block\'s attribution')
    ap.add_argument('--sweeps', type=int, default=5)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--out', default=None, help='write the JSON here too')
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec, params, state, _ = build_problem(args.n, args.events,
                                           device=device)
    if args.standalone:
        out = standalone(spec, params, state, args.restarts, device,
                         iters=args.iters)
    else:
        out = trace_attribution(spec, params, state, args.restarts, device,
                                num_sweeps=args.sweeps, iters=args.iters)
    write_json(out, args.out)
    return out


if __name__ == '__main__':
    main()
