"""Summarize a Chrome trace of ``torch.profiler``: its top events.

Reads the trace ``profile_engine`` writes (the file, or the directory that
holds its ``trace.json``) and prints the ``--top`` heaviest events by
name, with their time in us, their share and their occurrences:

* a card's trace: the device events (kernels, copies and sets, which do
  not nest), ranked by summed duration;
* a CPU trace: the ``cpu_op`` events and the ``record_function`` ranges
  (``user_annotation``), ranked by self time: an event's duration less
  that of the events nested directly inside it on its thread.

The header says which of the two it read. The JAX tool's ``GB/s`` and
``bound`` columns come from XLA's ``hlo_stats``, which has no counterpart
in a Chrome trace; they are left out. Run:

    python -m remixt_tpu_torch.tools.summarize_trace build/trace [--top 30]
"""

import argparse
import collections
import json
import os

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATEGORIES = ('cpu_op', 'user_annotation')


def self_times(events):
    """[(name, self us)] of complete events that nest by time on each
    (pid, tid); times are taken to the nanosecond, as the trace prints
    them."""
    by_thread = collections.defaultdict(list)
    for e in events:
        start = round(float(e['ts']) * 1000)
        by_thread[(e['pid'], e['tid'])].append(
            (start, start + round(float(e['dur']) * 1000), e['name']))
    out = []
    for spans in by_thread.values():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack = []    # [end ns, name, duration ns, nested ns]
        for start, end, name in spans:
            while stack and stack[-1][0] <= start:
                done = stack.pop()
                out.append((done[1], (done[2] - done[3]) / 1000))
            if stack:
                stack[-1][3] += end - start
            stack.append([end, name, end - start, 0])
        out += [(s[1], (s[2] - s[3]) / 1000) for s in stack]
    return out


def summarize(trace, top=30):
    """(kind, total us, [(name, us, occurrences)] of the ``top`` heaviest
    names), ``kind`` being ``'device'`` or ``'cpu'``."""
    events = [e for e in trace['traceEvents']
              if e.get('ph') == 'X' and 'dur' in e]
    device = [e for e in events if e.get('cat') in DEVICE_CATEGORIES]
    if device:
        kind, times = 'device', [(e['name'], float(e['dur']))
                                 for e in device]
    else:
        kind = 'cpu'
        times = self_times([e for e in events
                            if e.get('cat') in HOST_CATEGORIES])
    us = collections.defaultdict(float)
    occurrences = collections.Counter()
    for name, t in times:
        us[name] += t
        occurrences[name] += 1
    ranked = sorted(us, key=lambda name: -us[name])[:top]
    return (kind, sum(us.values()),
            [(name, us[name], occurrences[name]) for name in ranked])


def load(path):
    if os.path.isdir(path):
        path = os.path.join(path, 'trace.json')
    with open(path) as f:
        return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('trace', help='a Chrome trace, or the directory that '
                                  'holds its trace.json')
    ap.add_argument('--top', type=int, default=30)
    args = ap.parse_args(argv)

    kind, total, rows = summarize(load(args.trace), args.top)
    if kind == 'device':
        print('device total: {:.1f} us (kernels, copies and sets, by '
              'summed duration)'.format(total))
    else:
        print('cpu self total: {:.1f} us (cpu_op events and ranges, by '
              'self time)'.format(total))
    print('{:>11} {:>5} {:>6}  name'.format('us', '%', 'occ'))
    for name, t, n in rows:
        print('{:11.1f} {:5.1f} {:6d}  {}'.format(
            t, 100 * t / total if total else 0.0, n, name[:100]))
    return kind, total, rows


if __name__ == '__main__':
    main()
