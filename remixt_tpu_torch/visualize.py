"""Self-contained HTML report of a results store's solutions.

Counterpart of ``remixt_tpu/visualize.py`` on the port's tables: the
solutions' segments, chromosome marks, breakpoint arcs, h, statistics and
read-depth densities (``scipy.stats.gaussian_kde``) go into one HTML page
as JSON and are drawn by inline JavaScript on HTML canvas: a solution
selector and clickable statistics rows, a chromosome zoom selector, a
drag-brush x-range shared by all tracks, hover tooltips, toggleable
breakpoint arcs and a major-vs-minor scatter whose box-select highlights
segments on every track. No external network or library dependencies.
The results store is an HDF5 file or a directory of TSV tables
(``io/store.py``).
"""

import json

import numpy as np

from remixt_tpu_torch import utils
from remixt_tpu_torch.io.store import read_store

_SEGMENT_COLUMNS = ('major_raw', 'minor_raw', 'major_1', 'minor_1',
                    'major_2', 'minor_2', 'length')


def _segment_payload(cn):
    """Reduce a cn table to the per-segment fields the viewer needs."""
    chromosome = np.array([str(c) for c in cn['chromosome']], dtype=object)
    chromosomes = utils.sort_chromosome_names(
        list(dict.fromkeys(chromosome.tolist())))
    offsets, lengths = {}, {}
    offset = 0
    for name in chromosomes:
        offsets[name] = offset
        lengths[name] = int(cn['end'][chromosome == name].max())
        offset += lengths[name]
    genome_length = offset

    columns = [col for col in _SEGMENT_COLUMNS if col in cn]
    segments = []
    for i, chrom in enumerate(chromosome.tolist()):
        seg = {
            'x0': int(cn['start'][i]) + offsets[chrom],
            'x1': int(cn['end'][i]) + offsets[chrom],
            'start': int(cn['start'][i]),
            'end': int(cn['end'][i]),
            'chrom': chrom,
        }
        for col in columns:
            value = cn[col][i]
            seg[col] = (None if not np.isfinite(value)
                        else round(float(value), 4))
        segments.append(seg)

    chrom_marks = [{'name': c, 'x': offsets[c], 'len': lengths[c]}
                   for c in chromosomes]
    return segments, chrom_marks, genome_length


def _brk_payload(brk_cn, offsets):
    brks = []
    if brk_cn is None or len(brk_cn) == 0:
        return brks
    cn_cols = [c for c in brk_cn.columns if c.startswith('cn_')]
    for i in range(len(brk_cn)):
        try:
            c0 = str(brk_cn['chromosome_1'][i])
            c1 = str(brk_cn['chromosome_2'][i])
            if c0 not in offsets or c1 not in offsets:
                continue
            brks.append({
                'x0': int(brk_cn['position_1'][i]) + offsets[c0],
                'x1': int(brk_cn['position_2'][i]) + offsets[c1],
                'cn': [round(float(brk_cn[c][i]), 3) for c in cn_cols],
            })
        except (KeyError, ValueError):
            continue
    return brks


def _weighted_density(xs, data, weights, bw_method=0.01):
    """Weighted KDE evaluated at xs, endpoints pinned to zero so the curve
    closes as a filled patch."""
    import scipy.stats
    density = scipy.stats.gaussian_kde(
        np.asarray(data, dtype=float),
        weights=np.asarray(weights, dtype=float), bw_method=bw_method)
    ys = density(xs)
    ys[0] = 0.0
    ys[-1] = 0.0
    return ys


def _read_depth_payload(tables):
    """Read-depth density curves for the solutions panel: minor, major and
    total segment depth as length-weighted KDEs over [0, the 95th
    length-weighted percentile of the total]."""
    read_depth = tables.get('read_depth')
    if read_depth is None or len(read_depth) == 0:
        return None
    depth_max = float(utils.weighted_percentile(
        read_depth['total'], read_depth['length'], 95))
    xs = np.concatenate([[0.0], np.linspace(0.0, depth_max, 500),
                         [depth_max]])
    payload = {'x': [round(float(v), 6) for v in xs]}
    for col in ['minor', 'major', 'total']:
        ys = _weighted_density(xs, read_depth[col], read_depth['length'])
        payload[col] = [round(float(v), 4) for v in ys]
    minor_modes = tables.get('minor_modes')
    payload['minor_modes'] = [] if minor_modes is None else [
        round(float(v), 6) for v in minor_modes.values]
    return payload


def sort_descending(values):
    """Row order of ``values`` sorted descending as pandas'
    ``sort_values(ascending=False)`` orders it (its ``nargsort``: numpy's
    quicksort of the reversed non-NaN values, reversed back, NaN last)."""
    values = np.asarray(values)
    missing = np.isnan(values)
    rows = np.flatnonzero(~missing)[::-1]
    order = rows[values[~missing][::-1].argsort(kind='quicksort')][::-1]
    return np.concatenate([order, np.flatnonzero(missing)])


_HTML_TEMPLATE = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>remixt-tpu solutions</title>
<style>
body {{ font-family: sans-serif; margin: 20px; }}
canvas {{ border: 1px solid #ccc; display: block; margin-bottom: 10px; }}
table {{ border-collapse: collapse; font-size: 12px; }}
td, th {{ border: 1px solid #ccc; padding: 3px 8px; text-align: right; }}
tr.selectable {{ cursor: pointer; }}
tr.selected {{ background: #e6f2ff; }}
.legend span {{ margin-right: 16px; }}
#tooltip {{ position: absolute; background: #fffbe6; border: 1px solid #aaa;
           padding: 4px 6px; font-size: 11px; pointer-events: none;
           display: none; }}
.controls > * {{ margin-right: 14px; }}
</style>
</head>
<body>
<h2>remixt-tpu solutions</h2>
<div class="controls">
  solution: <select id="solution"></select>
  chromosome: <select id="chromosome"></select>
  <label><input type="checkbox" id="arcs" checked> breakpoint arcs</label>
  <span style="color:#666;font-size:11px">drag to zoom, double-click to reset</span>
</div>
<div class="legend">
  <span style="color:#d62728">&#9632; major</span>
  <span style="color:#1f77b4">&#9632; minor</span>
  <span style="color:#999">&#9474; chromosome boundary</span>
</div>
<h3>raw copy number</h3>
<canvas id="raw" width="1200" height="240"></canvas>
<h3>clone copy number</h3>
<canvas id="clone1" width="1200" height="180"></canvas>
<canvas id="clone2" width="1200" height="180"></canvas>
<h3>raw major vs minor <span style="font-size:11px;color:#666">(drag a box to highlight segments on the tracks, double-click to clear)</span></h3>
<canvas id="scatter" width="620" height="420"></canvas>
<div id="depth_section" style="display:none">
<h3>major/minor/total read depth <span style="font-size:11px;color:#666">(length-weighted density; &#9650; haploid normal, &#9650; haploid tumour, dashed: minor-depth modes)</span></h3>
<canvas id="depth" width="1200" height="240"></canvas>
</div>
<h3>solution statistics <span style="font-size:11px;color:#666">(click a row to select)</span></h3>
<div id="stats"></div>
<div id="tooltip"></div>
<script>
const DATA = {data_json};
const PAD = 30;
const view = {{ solution: DATA.best, x0: 0, x1: DATA.genome_length,
               selected: null }};

function chromColor(sol, chrom) {{
  const idx = sol.chrom_marks.findIndex(m => m.name === chrom);
  const hue = (idx * 360 / Math.max(sol.chrom_marks.length, 1)) % 360;
  return 'hsl(' + hue + ', 65%, 45%)';
}}

function visibleSegments(segments) {{
  return segments.filter(s => s.x1 > view.x0 && s.x0 < view.x1);
}}

function scales(canvas, maxCopies) {{
  const W = canvas.width, H = canvas.height;
  const sx = x => PAD + (W - 2 * PAD) * (x - view.x0) / (view.x1 - view.x0);
  const sy = y => H - PAD - (H - 2 * PAD) *
      Math.min(Math.max(y, -0.4), maxCopies * 1.1) / (maxCopies * 1.1);
  return [sx, sy];
}}

function drawTrack(canvas, sol, majorCol, minorCol, maxCopies, withArcs) {{
  const ctx = canvas.getContext('2d');
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  const [sx, sy] = scales(canvas, maxCopies);

  ctx.font = '9px sans-serif';
  for (const mark of sol.chrom_marks) {{
    if (mark.x < view.x0 - 1 || mark.x > view.x1) continue;
    ctx.strokeStyle = '#ddd';
    ctx.fillStyle = '#666';
    ctx.beginPath();
    ctx.moveTo(sx(mark.x), PAD);
    ctx.lineTo(sx(mark.x), canvas.height - PAD);
    ctx.stroke();
    ctx.fillText(mark.name, sx(mark.x) + 2, PAD - 4);
  }}
  ctx.fillStyle = '#666';
  for (let y = 0; y <= maxCopies; y++) {{
    ctx.strokeStyle = y === 0 ? '#999' : '#eee';
    ctx.beginPath();
    ctx.moveTo(PAD, sy(y)); ctx.lineTo(canvas.width - PAD, sy(y));
    ctx.stroke();
    ctx.fillText(y, 6, sy(y) + 3);
  }}

  for (const [col, color] of [[majorCol, '#d62728'], [minorCol, '#1f77b4']]) {{
    ctx.strokeStyle = color;
    ctx.lineWidth = 1.6;
    for (const seg of visibleSegments(sol.segments)) {{
      if (seg[col] === null || seg[col] === undefined) continue;
      ctx.beginPath();
      ctx.moveTo(sx(Math.max(seg.x0, view.x0)), sy(seg[col]));
      ctx.lineTo(sx(Math.min(seg.x1, view.x1)), sy(seg[col]));
      ctx.stroke();
    }}
    ctx.lineWidth = 1.0;
  }}

  if (view.selected && view.selected.size) {{
    ctx.strokeStyle = '#111';
    ctx.lineWidth = 3.0;
    for (const i of view.selected) {{
      const seg = sol.segments[i];
      if (!seg || seg.x1 <= view.x0 || seg.x0 >= view.x1) continue;
      for (const col of [majorCol, minorCol]) {{
        if (seg[col] === null || seg[col] === undefined) continue;
        ctx.beginPath();
        ctx.moveTo(sx(Math.max(seg.x0, view.x0)), sy(seg[col]));
        ctx.lineTo(sx(Math.min(seg.x1, view.x1)), sy(seg[col]));
        ctx.stroke();
      }}
    }}
    ctx.lineWidth = 1.0;
  }}

  if (withArcs && document.getElementById('arcs').checked) {{
    ctx.strokeStyle = 'rgba(80,80,80,0.55)';
    for (const brk of sol.breakpoints || []) {{
      if (Math.max(brk.x0, brk.x1) < view.x0 ||
          Math.min(brk.x0, brk.x1) > view.x1) continue;
      const xa = sx(brk.x0), xb = sx(brk.x1);
      const mid = (xa + xb) / 2;
      ctx.beginPath();
      ctx.moveTo(xa, PAD + 6);
      ctx.quadraticCurveTo(mid, PAD - 18, xb, PAD + 6);
      ctx.stroke();
    }}
  }}
}}

function renderStats() {{
  let html = '<table><tr>';
  const cols = DATA.stats_columns;
  for (const c of cols) html += '<th>' + c + '</th>';
  html += '</tr>';
  for (const row of DATA.stats) {{
    const sel = String(row.init_id) === String(view.solution);
    html += '<tr class="selectable' + (sel ? ' selected' : '') +
            '" data-id="' + row.init_id + '">';
    for (const c of cols) {{
      let v = row[c];
      if (typeof v === 'number' && !Number.isInteger(v)) v = v.toPrecision(6);
      html += '<td>' + v + '</td>';
    }}
    html += '</tr>';
  }}
  html += '</table>';
  const el = document.getElementById('stats');
  el.innerHTML = html;
  for (const tr of el.querySelectorAll('tr.selectable')) {{
    tr.addEventListener('click', () => {{
      if (DATA.solutions[tr.dataset.id]) {{
        view.solution = tr.dataset.id;
        view.selected = null;
        document.getElementById('solution').value = tr.dataset.id;
        render();
      }}
    }});
  }}
}}

// raw major (y) vs minor (x) scatter, point area ~ segment length,
// colored by chromosome (reference visualize.py:40-61)
const SCAT = {{ xmin: -0.5, xmax: 6.5, ymin: -0.5, ymax: 4.5 }};

function scatterScales(canvas) {{
  // clamp into the axes box: high-amplification segments (copy number
  // up to max_copy_number=12) pin to the box edge instead of rendering
  // over the heading / off-canvas; hover and box-select share these
  // scales so they hit the same clamped coordinates
  const cl = (v, lo, hi) => Math.min(Math.max(v, lo), hi);
  const sx = x => PAD + (canvas.width - 2 * PAD)
      * (cl(x, SCAT.xmin, SCAT.xmax) - SCAT.xmin) / (SCAT.xmax - SCAT.xmin);
  const sy = y => canvas.height - PAD - (canvas.height - 2 * PAD)
      * (cl(y, SCAT.ymin, SCAT.ymax) - SCAT.ymin) / (SCAT.ymax - SCAT.ymin);
  return [sx, sy];
}}

function drawScatter(canvas, sol) {{
  const ctx = canvas.getContext('2d');
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  const [sx, sy] = scatterScales(canvas);
  ctx.font = '9px sans-serif';
  ctx.fillStyle = '#666';
  for (let v = 0; v <= 6; v++) {{
    ctx.strokeStyle = '#eee';
    ctx.beginPath();
    ctx.moveTo(sx(v), PAD); ctx.lineTo(sx(v), canvas.height - PAD);
    ctx.stroke();
    ctx.fillText(v, sx(v) - 2, canvas.height - PAD + 12);
    if (v <= 4) {{
      ctx.beginPath();
      ctx.moveTo(PAD, sy(v)); ctx.lineTo(canvas.width - PAD, sy(v));
      ctx.stroke();
      ctx.fillText(v, 6, sy(v) + 3);
    }}
  }}
  ctx.fillText('minor_raw', canvas.width / 2 - 20, canvas.height - 6);
  const maxLen = Math.max(...sol.segments.map(s => s.length || 0), 1);
  sol.segments.forEach((seg, i) => {{
    if (seg.major_raw === null || seg.major_raw === undefined ||
        seg.minor_raw === null || seg.minor_raw === undefined) return;
    const r = 1.5 + 6 * Math.sqrt((seg.length || 0) / maxLen);
    ctx.beginPath();
    ctx.arc(sx(seg.minor_raw), sy(seg.major_raw), r, 0, 2 * Math.PI);
    const sel = view.selected && view.selected.has(i);
    ctx.globalAlpha = sel ? 0.9 : 0.45;
    ctx.fillStyle = chromColor(sol, seg.chrom);
    ctx.fill();
    if (sel) {{
      ctx.globalAlpha = 1.0;
      ctx.strokeStyle = '#111';
      ctx.stroke();
    }}
  }});
  ctx.globalAlpha = 1.0;
}}

// read depth density panel (reference solutions view): minor/major/total
// length-weighted KDE patches, minor-mode dashed lines, and the selected
// solution's haploid normal / haploid tumour depth markers
function drawDepth(canvas, sol) {{
  const rd = DATA.read_depth;
  if (!rd) return;
  const ctx = canvas.getContext('2d');
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  const xmax = rd.x[rd.x.length - 1] || 1;
  const ymax = Math.max(...rd.minor, ...rd.major, ...rd.total, 1e-9);
  const sx = x => PAD + (canvas.width - 2 * PAD) * x / xmax;
  const sy = y => canvas.height - PAD - (canvas.height - 2 * PAD) * y / (ymax * 1.05);
  ctx.font = '9px sans-serif';
  ctx.fillStyle = '#666';
  const xticks = 8;
  for (let i = 0; i <= xticks; i++) {{
    const xv = xmax * i / xticks;
    ctx.strokeStyle = '#eee';
    ctx.beginPath();
    ctx.moveTo(sx(xv), PAD); ctx.lineTo(sx(xv), canvas.height - PAD);
    ctx.stroke();
    ctx.fillText(xv.toPrecision(3), sx(xv) - 10, canvas.height - PAD + 12);
  }}
  ctx.fillText('read depth', canvas.width / 2 - 25, canvas.height - 4);
  for (const [col, color] of [['minor', 'rgba(31,119,180,0.45)'],
                              ['major', 'rgba(214,39,40,0.45)'],
                              ['total', 'rgba(120,120,120,0.45)']]) {{
    ctx.fillStyle = color;
    ctx.beginPath();
    ctx.moveTo(sx(rd.x[0]), sy(0));
    rd.x.forEach((xv, i) => ctx.lineTo(sx(xv), sy(rd[col][i])));
    ctx.closePath();
    ctx.fill();
  }}
  ctx.strokeStyle = '#555';
  ctx.setLineDash([4, 3]);
  for (const mode of rd.minor_modes || []) {{
    if (mode > xmax) continue;
    ctx.beginPath();
    ctx.moveTo(sx(mode), PAD); ctx.lineTo(sx(mode), canvas.height - PAD);
    ctx.stroke();
  }}
  ctx.setLineDash([]);
  if (sol.h && sol.h.length) {{
    const hNormal = sol.h[0];
    const hTumour = sol.h.slice(1).reduce((a, b) => a + b, 0);
    for (const [xv, color, label] of [[hNormal, 'orange', 'h normal'],
                                      [hNormal + hTumour, 'green', 'h normal + tumour']]) {{
      if (xv > xmax) continue;
      ctx.fillStyle = color;
      ctx.beginPath();
      ctx.moveTo(sx(xv), canvas.height - PAD);
      ctx.lineTo(sx(xv) - 5, canvas.height - PAD + 9);
      ctx.lineTo(sx(xv) + 5, canvas.height - PAD + 9);
      ctx.closePath();
      ctx.fill();
      ctx.fillText(label, sx(xv) + 6, canvas.height - PAD + 9);
    }}
  }}
}}

function render() {{
  const sol = DATA.solutions[view.solution];
  if (!sol) return;
  drawTrack(document.getElementById('raw'), sol, 'major_raw', 'minor_raw', 4, true);
  drawTrack(document.getElementById('clone1'), sol, 'major_1', 'minor_1', 4, false);
  drawTrack(document.getElementById('clone2'), sol, 'major_2', 'minor_2', 4, false);
  drawScatter(document.getElementById('scatter'), sol);
  if (DATA.read_depth) {{
    document.getElementById('depth_section').style.display = 'block';
    drawDepth(document.getElementById('depth'), sol);
  }}
  renderStats();
}}

// scatter box-select -> highlight segments on all tracks (linked brushing)
(function () {{
  const canvas = document.getElementById('scatter');
  let start = null;
  canvas.addEventListener('mousedown', e => {{
    start = [e.offsetX, e.offsetY];
  }});
  canvas.addEventListener('mouseup', e => {{
    if (!start) return;
    const [ax, ay] = start;
    start = null;
    const bx = e.offsetX, by = e.offsetY;
    if (Math.abs(bx - ax) < 4 && Math.abs(by - ay) < 4) return;
    const sol = DATA.solutions[view.solution];
    if (!sol) return;
    const [sx, sy] = scatterScales(canvas);
    const x0 = Math.min(ax, bx), x1 = Math.max(ax, bx);
    const y0 = Math.min(ay, by), y1 = Math.max(ay, by);
    const sel = new Set();
    sol.segments.forEach((seg, i) => {{
      if (seg.major_raw === null || seg.major_raw === undefined ||
          seg.minor_raw === null || seg.minor_raw === undefined) return;
      const px = sx(seg.minor_raw), py = sy(seg.major_raw);
      if (px >= x0 && px <= x1 && py >= y0 && py <= y1) sel.add(i);
    }});
    view.selected = sel.size ? sel : null;
    render();
  }});
  canvas.addEventListener('dblclick', () => {{
    view.selected = null;
    render();
  }});
  canvas.addEventListener('mousemove', e => {{
    const sol = DATA.solutions[view.solution];
    if (!sol) return;
    const [sx, sy] = scatterScales(canvas);
    let best = null, bestD = 64;
    sol.segments.forEach(seg => {{
      if (seg.major_raw === null || seg.major_raw === undefined ||
          seg.minor_raw === null || seg.minor_raw === undefined) return;
      const dx = sx(seg.minor_raw) - e.offsetX;
      const dy = sy(seg.major_raw) - e.offsetY;
      const d = dx * dx + dy * dy;
      if (d < bestD) {{ best = seg; bestD = d; }}
    }});
    if (!best) {{ tooltip.style.display = 'none'; return; }}
    tooltip.innerHTML = best.chrom + ':' + best.start + '-' + best.end +
        '<br>major_raw = ' + best.major_raw +
        '<br>minor_raw = ' + best.minor_raw;
    tooltip.style.left = (e.pageX + 12) + 'px';
    tooltip.style.top = (e.pageY + 12) + 'px';
    tooltip.style.display = 'block';
  }});
  canvas.addEventListener('mouseleave', () => {{
    tooltip.style.display = 'none';
  }});
}})();

// solution selector
const select = document.getElementById('solution');
for (const id of Object.keys(DATA.solutions)) {{
  const opt = document.createElement('option');
  opt.value = id;
  opt.textContent = 'solution ' + id +
    (String(id) === String(DATA.best) ? ' (best)' : '');
  select.appendChild(opt);
}}
select.value = DATA.best;
select.addEventListener('change', () => {{
  view.solution = select.value; view.selected = null; render();
}});

// chromosome zoom selector
const chromSel = document.getElementById('chromosome');
const firstSol = DATA.solutions[DATA.best] || Object.values(DATA.solutions)[0];
const allOpt = document.createElement('option');
allOpt.value = 'all'; allOpt.textContent = 'all';
chromSel.appendChild(allOpt);
for (const mark of (firstSol ? firstSol.chrom_marks : [])) {{
  const opt = document.createElement('option');
  opt.value = mark.name; opt.textContent = mark.name;
  chromSel.appendChild(opt);
}}
chromSel.addEventListener('change', () => {{
  if (chromSel.value === 'all') {{ view.x0 = 0; view.x1 = DATA.genome_length; }}
  else {{
    const mark = firstSol.chrom_marks.find(m => m.name === chromSel.value);
    view.x0 = mark.x; view.x1 = mark.x + mark.len;
  }}
  render();
}});
document.getElementById('arcs').addEventListener('change', render);

// shared drag-brush zoom + hover tooltips
const tooltip = document.getElementById('tooltip');
for (const id of ['raw', 'clone1', 'clone2']) {{
  const canvas = document.getElementById(id);
  let dragStart = null;
  canvas.addEventListener('mousedown', e => {{ dragStart = e.offsetX; }});
  canvas.addEventListener('mouseup', e => {{
    if (dragStart === null) return;
    const a = Math.min(dragStart, e.offsetX), b = Math.max(dragStart, e.offsetX);
    dragStart = null;
    if (b - a < 5) return;
    const toGenome = px => view.x0 + (px - PAD) / (canvas.width - 2 * PAD)
                           * (view.x1 - view.x0);
    const nx0 = Math.max(0, toGenome(a)), nx1 = Math.min(DATA.genome_length, toGenome(b));
    if (nx1 > nx0) {{ view.x0 = nx0; view.x1 = nx1; render(); }}
  }});
  canvas.addEventListener('dblclick', () => {{
    view.x0 = 0; view.x1 = DATA.genome_length;
    chromSel.value = 'all';
    render();
  }});
  canvas.addEventListener('mousemove', e => {{
    const sol = DATA.solutions[view.solution];
    if (!sol) return;
    const gx = view.x0 + (e.offsetX - PAD) / (canvas.width - 2 * PAD)
               * (view.x1 - view.x0);
    const seg = sol.segments.find(s => gx >= s.x0 && gx < s.x1);
    if (!seg) {{ tooltip.style.display = 'none'; return; }}
    const fields = ['major_raw', 'minor_raw', 'major_1', 'minor_1',
                    'major_2', 'minor_2'];
    let text = seg.chrom + ':' + seg.start + '-' + seg.end;
    for (const f of fields) {{
      if (seg[f] !== undefined && seg[f] !== null) text += '<br>' + f + ' = ' + seg[f];
    }}
    tooltip.innerHTML = text;
    tooltip.style.left = (e.pageX + 12) + 'px';
    tooltip.style.top = (e.pageY + 12) + 'px';
    tooltip.style.display = 'block';
  }});
  canvas.addEventListener('mouseleave', () => {{ tooltip.style.display = 'none'; }});
}}

render();
</script>
</body>
</html>
"""


def _write_report(data, html_filename):
    with open(html_filename, 'w') as f:
        f.write(_HTML_TEMPLATE.format(data_json=json.dumps(data)))


def create_genome_visualization(cn, brk_cn, html_filename, stats=None):
    """Single-solution genome view as self-contained HTML; ``stats`` a
    list of dicts, or None."""
    segments, chrom_marks, genome_length = _segment_payload(cn)
    offsets = {m['name']: m['x'] for m in chrom_marks}
    data = {
        'solutions': {'0': {
            'segments': segments,
            'chrom_marks': chrom_marks,
            'breakpoints': _brk_payload(brk_cn, offsets),
        }},
        'genome_length': genome_length,
        'best': '0',
        'stats': [] if stats is None else stats,
        'stats_columns': [] if stats is None else list(stats[0].keys()),
        'read_depth': None,
    }
    _write_report(data, html_filename)


def _stats_value(value):
    if isinstance(value, np.generic):
        value = value.item()
    if isinstance(value, float) and not np.isfinite(value):
        value = str(value)
    return value


def create_solutions_visualization(results_filename, html_filename,
                                   max_solutions=12):
    """Multi-solution comparison report from a results store.

    Only the ``max_solutions`` best solutions by ELBO embed their genome
    tracks (large restart grids would otherwise make a report too big for
    the browser); the statistics table lists every restart.
    """
    stats = read_store(results_filename, keys=['stats'])['stats']
    by_elbo = sort_descending(stats['elbo'])
    embedded = stats['init_id'][by_elbo][:max_solutions]
    tables = read_store(results_filename, keys=[
        'read_depth', 'minor_modes'] + [
        'solutions/solution_{}/{}'.format(init_id, name)
        for init_id in embedded for name in ('cn', 'brk_cn', 'h')])

    solutions = {}
    genome_length = 0
    for init_id in embedded:
        key = 'solutions/solution_{}/'.format(init_id)
        if key + 'cn' not in tables:
            continue
        segments, chrom_marks, genome_length = _segment_payload(
            tables[key + 'cn'])
        offsets = {m['name']: m['x'] for m in chrom_marks}
        h = tables.get(key + 'h')
        solutions[str(init_id)] = {
            'segments': segments,
            'chrom_marks': chrom_marks,
            'breakpoints': _brk_payload(tables.get(key + 'brk_cn'), offsets),
            'h': [] if h is None else [round(float(v), 6) for v in h.values],
        }

    data = {
        'solutions': solutions,
        'genome_length': genome_length,
        'best': str(stats['init_id'][by_elbo[0]]),
        'stats': [{col: _stats_value(values[i])
                   for col, values in stats.items()}
                  for i in range(len(stats))],
        'stats_columns': stats.columns,
        'read_depth': _read_depth_payload(tables),
    }
    _write_report(data, html_filename)
