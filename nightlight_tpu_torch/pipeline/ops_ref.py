"""Reference-frame selection, frame filtering and the stats report
(reference: internal/ops/ref/), mirror of nightlight_tpu/pipeline/ops_ref.py.

Reference selection modes: "%starsHFR", "%location", "%rgb", an integer
frame ID, or the name of an external reference file.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np

from nightlight_tpu_torch.image import Image
from nightlight_tpu_torch.pipeline.context import Context
from nightlight_tpu_torch.pipeline.operators import (
    OpLoad, Operator, UnaryOperator, materialize_all, register)


class SelRefTarget(IntEnum):
    """Reference selection target (refframe.go:32-37)."""

    Align = 0
    Histo = 1


_TARGET_STRINGS = ["alignment", "histogram"]


@register
class OpSelectReference(Operator):
    """Reference frame selection (refframe.go:41-210).

    The first promise to run materializes ALL inputs, scores them and posts
    the reference into the context; every promise then hands out its
    materialized image."""

    TYPE = "selectRef"
    PARAMS = {
        "target": ("target", int(SelRefTarget.Align)),
        "mode": ("mode", "%starsHFR"),
        "star_detect": ("starDetect", None),
    }

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._materialized: list | None = None

    def make_promises(self, ins, c):
        if not ins:
            raise ValueError(f"{self.TYPE} operator needs inputs")
        return [self._apply_single(i, ins, c) for i in range(len(ins))]

    def _have_reference(self, c: Context) -> bool:
        t = SelRefTarget(self.target)
        return (t == SelRefTarget.Align and c.align_stars is not None) or (
            t == SelRefTarget.Histo and c.match_histo is not None)

    def _apply_single(self, i: int, ins, c: Context):
        def promise():
            if c.ref_frame_error is not None:
                raise RuntimeError("same error")
            if not self._have_reference(c):
                try:
                    self._select_reference(ins, c)
                except Exception as e:
                    c.ref_frame_error = e
                    raise
            materialized = self._materialized
            if materialized is not None and i < len(materialized) and materialized[i] is not None:
                mat = materialized[i]
                materialized[i] = None  # free the reference (refframe.go:108)
                return mat
            return ins[i]()

        return promise

    def _select_reference(self, ins, c: Context) -> None:
        mode = self.mode
        file_id = None
        try:
            file_id = int(mode)
        except (TypeError, ValueError):
            pass
        # an external reference file: loaded (ID -3) and star-detected
        # without materializing the inputs (refframe.go:118-151)
        if mode not in ("%starsHFR", "%location", "%rgb") and file_id is None:
            if not mode:
                return
            promises = OpLoad(id=-3, file_name=mode).make_promises([], c)
            if self.star_detect is not None:
                promises = self.star_detect.make_promises(promises, c)
            ref_frame = promises[0]()
            self._assign_results(c, ref_frame)
            c.logf("using loaded image %d as %s reference\n", ref_frame.id,
                   _TARGET_STRINGS[self.target])
            return

        materialized, err = materialize_all(ins)
        if err is not None:
            raise err
        self._materialized = list(materialized)

        if mode == "%rgb":
            if len(materialized) > 3:
                mode, file_id = "3", 3
            else:
                mode = "%starsHFR"

        if mode == "%starsHFR":
            ref_frame, ref_score = _select_stars_over_hfr(materialized)
        elif mode == "%location":
            ref_frame, ref_score = _select_median_loc(materialized)
        elif file_id is not None:
            if file_id < 0 or file_id >= len(materialized):
                raise ValueError(f"invalid reference file ID {file_id}")
            ref_frame, ref_score = materialized[file_id], 0.0
        else:
            raise ValueError(f"Unknown refrence selection mode '{self.mode}'")
        if ref_frame is None:
            raise ValueError("Unable to select reference image.")
        c.logf("Using image %d with score %.4g as %s reference.\n",
               ref_frame.id, ref_score, _TARGET_STRINGS[self.target])
        self._assign_results(c, ref_frame)
        c.flush_log()

    def _assign_results(self, c: Context, ref_frame: Image) -> None:
        """Post reference data into the context (refframe.go:200-210)."""
        t = SelRefTarget(self.target)
        if t == SelRefTarget.Align:
            c.align_naxisn = list(ref_frame.naxisn)
            c.align_stars = ref_frame.stars
            c.align_hfr = ref_frame.hfr
        elif t == SelRefTarget.Histo:
            c.match_histo = ref_frame.stats


def _select_stars_over_hfr(lights):
    """Best #stars/HFR score (refframe.go:212-227)."""
    ref, score = None, -1.0
    for f in lights:
        if f is None:
            continue
        s = 0.0
        if f.stars is not None and len(f.stars) > 0 and f.hfr != 0:
            s = len(f.stars) / f.hfr
        if s > score:
            ref, score = f, s
    return ref, score


def _select_median_loc(lights):
    """Frame with location closest to the median location
    (refframe.go:229-258); NaN locations never win."""
    by_frame = [(f, float(f.stats.location)) for f in lights if f is not None]
    locs = [v for _, v in by_frame if not np.isnan(v)]
    if not locs:
        raise ValueError("Unable to select reference frame with median location")
    median_loc = float(np.median(np.array(locs, np.float32)))
    best, best_d = None, float("inf")
    for f, v in by_frame:
        d = (v - median_loc) ** 2
        if d < best_d:
            best, best_d = f, d
    return best, median_loc


@register
class OpFilter(UnaryOperator):
    """Drop frames with too few stars (ref/filter.go:12-53)."""

    TYPE = "filter"
    PARAMS = {"min_stars": ("minStars", 0)}
    SHARDED = True  # reads the star list only

    def apply(self, f: Image, c: Context):
        if self.min_stars <= 0:
            return f
        n = len(f.stars) if f.stars is not None else 0
        if n < self.min_stars:
            c.logf("%d: Stars=%d below threshold %d, skipping frame\n", f.id, n, self.min_stars)
            return None
        return f


@register
class OpExportStats(UnaryOperator):
    """Incremental per-frame statistics HTML report (ref/exportstats.go)."""

    TYPE = "exportStats"
    PARAMS = {"file_name": ("fileName", "out.html")}
    SHARDED = True  # reads the statistics only

    def is_noop(self) -> bool:
        return not self.file_name

    def apply(self, f: Image, c: Context) -> Image:
        if not self.file_name:
            c.logf("%d: exportStats empty fileName\n", f.id)
            return f
        if c.stats_processed == 0:
            self._write_header(c)
        self._write_stats(f, c)
        c.stats_processed += 1
        if c.stats_processed == c.stats_total:
            self._write_footer(c)
        c.flush_log()
        return f

    def _write_header(self, c: Context) -> None:
        c.logf("Writing statistics header to file %s ...\n", self.file_name)
        c.stats_file = open(self.file_name, "w")
        c.stats_file.write(_SESSION_STATS_HEADER)
        c.stats_file.write("[  ['ID','Min','Mean','Max','Location','Scale','Stars','HFR']\n")

    def _write_stats(self, f: Image, c: Context) -> None:
        c.logf("%d: writing statistics to file %s ...\n", f.id, self.file_name)
        s = f.stats
        n_stars = len(f.stars) if f.stars is not None else 0
        c.stats_file.write("  ,[%d,%f,%f,%f,%f,%f,%d,%f]\n"
                           % (f.id, s.min, s.mean, s.max, s.location, s.scale, n_stars, f.hfr))

    def _write_footer(self, c: Context) -> None:
        c.logf("Writing statistics footer to file %s ...\n", self.file_name)
        c.stats_file.write("]")
        c.stats_file.write(_SESSION_STATS_TRAILER)
        c.stats_file.close()
        c.stats_file = None


# Interactive chart page around the data rows. The data-row format (header
# row of column names followed by per-frame numeric rows, incrementally
# appended as frames finish) is the compatibility contract with the
# reference's report (exportstats.go); the page itself is an original,
# dependency-free inline-SVG renderer that works fully offline.
_SESSION_STATS_HEADER = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>Session statistics</title>
<style>
  :root { color-scheme: dark; }
  body { margin: 0; background: #14161a; color: #d7dae0;
         font: 13px/1.4 system-ui, sans-serif; }
  #wrap { display: flex; height: 100vh; }
  #plot { flex: 1 1 auto; min-width: 0; }
  #side { flex: 0 0 11em; padding: 1em; border-left: 1px solid #2a2d33; }
  #side h1 { font-size: 14px; margin: 0 0 .8em; }
  #side label { display: flex; align-items: center; gap: .4em;
                margin: .25em 0; cursor: pointer; user-select: none; }
  .swatch { width: 1em; height: 3px; border-radius: 2px; }
  #readout { margin-top: 1em; white-space: pre; font-family: monospace;
             font-size: 11px; color: #9aa0a8; }
  svg text { fill: #9aa0a8; font: 11px system-ui, sans-serif; }
  svg .grid { stroke: #24272d; }
  svg .axis { stroke: #3a3e45; }
</style>
</head>
<body>
<div id="wrap">
  <svg id="plot" preserveAspectRatio="none"></svg>
  <div id="side">
    <h1>Session statistics</h1>
    <label><input type="checkbox" id="norm" checked> relative to median</label>
    <div id="series"></div>
    <div id="readout"></div>
  </div>
</div>
<script>
"use strict";
const SESSION_STATS =
"""

_SESSION_STATS_TRAILER = """;

// ---- original inline-SVG session chart (no external libraries) ----
const COLORS = ["#6ea8fe", "#f2c078", "#7bd88f", "#ef7b7b",
                "#c79bf2", "#6fd6d2", "#f2a0d3"];
const header = SESSION_STATS[0];
const rows = SESSION_STATS.slice(1).sort((a, b) => a[0] - b[0]);
const nSeries = header.length - 1;           // column 0 is the frame ID
const enabled = new Array(nSeries).fill(true);

const med = col => {
  const v = rows.map(r => r[col]).sort((a, b) => a - b);
  const h = v.length >> 1;
  return v.length % 2 ? v[h] : 0.5 * (v[h - 1] + v[h]);
};
const medians = header.map((_, c) => (c ? med(c) : 0));

const svg = document.getElementById("plot");
const sideBox = document.getElementById("series");
const normBox = document.getElementById("norm");
const readout = document.getElementById("readout");

header.slice(1).forEach((name, i) => {
  const lab = document.createElement("label");
  const cb = document.createElement("input");
  cb.type = "checkbox"; cb.checked = true;
  cb.addEventListener("change", () => { enabled[i] = cb.checked; draw(); });
  const sw = document.createElement("span");
  sw.className = "swatch";
  sw.style.background = COLORS[i % COLORS.length];
  lab.append(cb, sw, document.createTextNode(name));
  sideBox.append(lab);
});
normBox.addEventListener("change", draw);

const el = (tag, attrs, text) => {
  const n = document.createElementNS("http://www.w3.org/2000/svg", tag);
  for (const k in attrs) n.setAttribute(k, attrs[k]);
  if (text !== undefined) n.textContent = text;
  return n;
};

const val = (row, c) =>
  normBox.checked && medians[c] !== 0 ? row[c] / medians[c] : row[c];

function draw() {
  const W = svg.clientWidth || 800, H = svg.clientHeight || 500;
  const m = { l: 56, r: 12, t: 12, b: 28 };
  svg.setAttribute("viewBox", `0 0 ${W} ${H}`);
  svg.textContent = "";
  if (!rows.length) return;

  let lo = Infinity, hi = -Infinity;
  for (const r of rows)
    for (let c = 1; c <= nSeries; c++)
      if (enabled[c - 1]) { const v = val(r, c); lo = Math.min(lo, v); hi = Math.max(hi, v); }
  if (!isFinite(lo)) { lo = 0; hi = 1; }
  if (lo === hi) { lo -= 0.5; hi += 0.5; }
  const pad = 0.04 * (hi - lo); lo -= pad; hi += pad;

  const ids = rows.map(r => r[0]);
  const x0 = Math.min(...ids), x1 = Math.max(...ids) || 1;
  const X = id => m.l + (W - m.l - m.r) * (x1 === x0 ? 0.5 : (id - x0) / (x1 - x0));
  const Y = v => H - m.b - (H - m.t - m.b) * ((v - lo) / (hi - lo));

  for (let i = 0; i <= 5; i++) {                       // horizontal grid + labels
    const v = lo + (hi - lo) * i / 5, y = Y(v);
    svg.append(el("line", { class: "grid", x1: m.l, x2: W - m.r, y1: y, y2: y }));
    svg.append(el("text", { x: m.l - 6, y: y + 4, "text-anchor": "end" },
                  v.toPrecision(4)));
  }
  const step = Math.max(1, Math.ceil(rows.length / 12));
  rows.forEach((r, i) => {                             // frame-ID ticks
    if (i % step) return;
    svg.append(el("text", { x: X(r[0]), y: H - m.b + 16, "text-anchor": "middle" }, r[0]));
  });
  svg.append(el("line", { class: "axis", x1: m.l, x2: m.l, y1: m.t, y2: H - m.b }));
  svg.append(el("line", { class: "axis", x1: m.l, x2: W - m.r, y1: H - m.b, y2: H - m.b }));

  for (let c = 1; c <= nSeries; c++) {
    if (!enabled[c - 1]) continue;
    const pts = rows.map(r => `${X(r[0])},${Y(val(r, c))}`).join(" ");
    svg.append(el("polyline", { points: pts, fill: "none",
                                stroke: COLORS[(c - 1) % COLORS.length],
                                "stroke-width": 1.6 }));
  }

  const cursor = el("line", { class: "axis", y1: m.t, y2: H - m.b, visibility: "hidden" });
  svg.append(cursor);
  svg.onmousemove = ev => {                            // nearest-frame readout
    const r = svg.getBoundingClientRect();
    const mx = (ev.clientX - r.left) * W / r.width;
    let best = rows[0];
    for (const row of rows)
      if (Math.abs(X(row[0]) - mx) < Math.abs(X(best[0]) - mx)) best = row;
    cursor.setAttribute("x1", X(best[0]));
    cursor.setAttribute("x2", X(best[0]));
    cursor.setAttribute("visibility", "visible");
    readout.textContent = header
      .map((h, c) => `${h.padEnd(9)}${c ? val(best, c).toPrecision(6) : best[0]}`)
      .join("\\n");
  };
  svg.onmouseleave = () => { cursor.setAttribute("visibility", "hidden"); };
}

new ResizeObserver(draw).observe(svg);
draw();
</script>
</body>
</html>
"""
