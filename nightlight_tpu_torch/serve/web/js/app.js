/* nightlight-tpu visual job editor.
 *
 * Functional equivalent of the reference's Blockly workspace (web/js/*): a
 * palette of operators generated from the live registry schema, a sequence
 * canvas with drag-drop composition (drag ops from the palette, reorder or
 * re-nest steps by drag, incl. stackBatches.perBatch nesting), slider
 * fields for bounded numeric parameters and dropdowns for enumerated ones
 * (model: web/js/field-slider + blocks.js field_dropdown), and a run button
 * that POSTs the job and streams the chunked log. No external dependencies.
 */
"use strict";

let SCHEMA = null;
let JOB = { type: "seq", steps: [] };   // the root sequence
let SELECTED = null;                     // currently selected step object
let DRAG = null;                         // {op, fromSeq} for moves, {type} for palette drags

const $ = (id) => document.getElementById(id);
const logEl = $("log");

function log(s) {
  logEl.textContent += s;
  logEl.scrollTop = logEl.scrollHeight;
}

function catOf(type) {
  for (const [cat, types] of Object.entries(SCHEMA.categories)) {
    if (types.includes(type)) return cat;
  }
  return "seq";
}

function catColor(cat) {
  return getComputedStyle(document.documentElement).getPropertyValue(`--cat-${cat}`) || "#888";
}

function defaultOp(type) {
  const op = { type };
  for (const p of SCHEMA.operators[type].params) op[p.name] = p.default;
  if (type === "seq") op.steps = [];
  if (type === "stackBatches") op.perBatch = { type: "seq", steps: [] };
  return op;
}

/* The seq that nested steps of `op` live in, or null for leaf ops. */
function innerSeq(op) {
  return op.type === "seq" ? op : op.type === "stackBatches" ? op.perBatch : null;
}

/* True if `seq` is `op` itself or lives anywhere inside `op` (re-nesting a
 * container into its own descendants would orphan the subtree). */
function seqInside(op, seq) {
  const inner = innerSeq(op);
  if (!inner) return false;
  if (inner === seq) return true;
  return inner.steps.some((s) => seqInside(s, seq));
}

/* ---------------- palette ---------------- */

function renderPalette() {
  const pal = $("palette");
  pal.innerHTML = "";
  for (const [cat, types] of Object.entries(SCHEMA.categories)) {
    const h = document.createElement("h3");
    h.textContent = cat;
    pal.appendChild(h);
    for (const t of types) {
      if (!SCHEMA.operators[t]) continue;
      const d = document.createElement("div");
      d.className = "pal-op";
      d.textContent = t;
      d.style.borderLeftColor = catColor(cat);
      d.title = SCHEMA.operators[t].doc;
      d.draggable = true;
      d.ondragstart = (e) => {
        DRAG = { type: t };
        e.dataTransfer.effectAllowed = "copy";
        e.dataTransfer.setData("text/plain", t);
      };
      d.ondragend = () => { DRAG = null; clearDropMarks(); };
      // click-to-add remains as the keyboard/coarse-pointer path
      d.onclick = () => {
        const target = (SELECTED && innerSeq(SELECTED)) ? innerSeq(SELECTED) : JOB;
        target.steps.push(defaultOp(t));
        render();
      };
      pal.appendChild(d);
    }
  }
}

/* ---------------- drag-drop ---------------- */

function clearDropMarks() {
  for (const el of document.querySelectorAll(".drop.over")) el.classList.remove("over");
}

/* A thin drop target inserting into seq.steps at index i. */
function dropZone(seq, i) {
  const z = document.createElement("div");
  z.className = "drop";
  z.ondragover = (e) => {
    if (!DRAG) return;
    if (DRAG.op && seqInside(DRAG.op, seq)) return;   // no self-nesting
    e.preventDefault();
    e.dataTransfer.dropEffect = DRAG.op ? "move" : "copy";
    z.classList.add("over");
  };
  z.ondragleave = () => z.classList.remove("over");
  z.ondrop = (e) => {
    e.preventDefault();
    if (!DRAG) return;
    let op = DRAG.op;
    let at = i;
    if (op) {
      if (seqInside(op, seq)) return;
      const from = DRAG.fromSeq;
      const j = from.steps.indexOf(op);
      from.steps.splice(j, 1);
      if (from === seq && j < at) at--;
    } else {
      op = defaultOp(DRAG.type);
    }
    seq.steps.splice(at, 0, op);
    SELECTED = op;
    DRAG = null;
    render();
  };
  return z;
}

/* ---------------- canvas ---------------- */

function summary(op) {
  const parts = [];
  for (const [k, v] of Object.entries(op)) {
    if (k === "type" || k === "steps" || k === "perBatch" || v === null) continue;
    if (typeof v === "object") continue;
    if (v === "" || v === 0 || v === false) continue;
    parts.push(`${k}=${v}`);
  }
  return parts.join(" ");
}

function renderSeq(container, seq) {
  seq.steps.forEach((op, i) => {
    container.appendChild(dropZone(seq, i));
    const row = document.createElement("div");
    row.className = "step" + (op === SELECTED ? " selected" : "");
    row.style.borderLeftColor = catColor(catOf(op.type));
    row.draggable = true;
    row.ondragstart = (e) => {
      e.stopPropagation();
      DRAG = { op, fromSeq: seq };
      e.dataTransfer.effectAllowed = "move";
      e.dataTransfer.setData("text/plain", op.type);
    };
    row.ondragend = () => { DRAG = null; clearDropMarks(); };
    const t = document.createElement("span");
    t.className = "t";
    t.textContent = op.type;
    const s = document.createElement("span");
    s.className = "summary";
    s.textContent = summary(op);
    const btns = document.createElement("span");
    btns.className = "btns";
    for (const [label, fn] of [
      ["↑", () => { if (i > 0) { seq.steps.splice(i, 1); seq.steps.splice(i - 1, 0, op); } }],
      ["↓", () => { if (i < seq.steps.length - 1) { seq.steps.splice(i, 1); seq.steps.splice(i + 1, 0, op); } }],
      ["×", () => { seq.steps.splice(i, 1); if (SELECTED === op) SELECTED = null; }],
    ]) {
      const b = document.createElement("button");
      b.textContent = label;
      b.onclick = (e) => { e.stopPropagation(); fn(); render(); };
      btns.appendChild(b);
    }
    row.append(t, s, btns);
    row.onclick = () => { SELECTED = op; render(); };
    container.appendChild(row);

    const inner = innerSeq(op);
    if (inner) {
      const nest = document.createElement("div");
      nest.className = "nest";
      renderSeq(nest, inner);
      container.appendChild(nest);
    }
  });
  container.appendChild(dropZone(seq, seq.steps.length));
}

function render() {
  const seqEl = $("seq");
  seqEl.innerHTML = "";
  renderSeq(seqEl, JOB);
  renderInspector();
}

/* ---------------- inspector ---------------- */

/* Slider + numeric entry pair, kept in sync (model: the reference's
 * field-slider, functionality only). */
function sliderField(op, p) {
  const wrap = document.createElement("div");
  wrap.className = "sliderwrap";
  const [lo, hi, step] = p.range;
  const slider = document.createElement("input");
  slider.type = "range";
  slider.min = lo; slider.max = hi; slider.step = step;
  const num = document.createElement("input");
  num.type = "number";
  num.step = step;
  num.className = "slidernum";
  const cur = Number(op[p.name] ?? p.default ?? lo);
  slider.value = cur; num.value = cur;
  slider.oninput = () => {
    num.value = slider.value;
    op[p.name] = Number(slider.value);
  };
  slider.onchange = () => render();
  num.onchange = () => {
    op[p.name] = Number(num.value);
    slider.value = num.value;
    render();
  };
  wrap.append(slider, num);
  return wrap;
}

function enumField(op, p) {
  const sel = document.createElement("select");
  for (const [label, value] of p.enum) {
    const o = document.createElement("option");
    o.textContent = label || "(none)";
    o.value = JSON.stringify(value);
    // Loose comparison by normalized string: values arriving as strings
    // (hand-edited JSON import, or a param previously set via the generic
    // text input) must still preselect the matching numeric option instead
    // of silently displaying the first one.
    if (value === op[p.name] || String(value) === String(op[p.name])) o.selected = true;
    sel.appendChild(o);
  }
  sel.onchange = () => { op[p.name] = JSON.parse(sel.value); render(); };
  return sel;
}

function boolField(op, p) {
  const cb = document.createElement("input");
  cb.type = "checkbox";
  cb.checked = !!op[p.name];
  cb.onchange = () => { op[p.name] = cb.checked; render(); };
  return cb;
}

function renderInspector() {
  const ins = $("inspector");
  ins.innerHTML = "<h3>Inspector</h3>";
  if (!SELECTED) {
    ins.insertAdjacentHTML("beforeend",
      '<div class="doc">Select a step to edit its parameters. Drag ops from the palette into the canvas; drag steps to reorder or nest them.</div>');
    return;
  }
  const op = SELECTED;
  ins.insertAdjacentHTML("beforeend",
    `<div class="doc"><b>${op.type}</b> — ${SCHEMA.operators[op.type]?.doc || ""}</div>`);
  for (const p of (SCHEMA.operators[op.type]?.params || [])) {
    const label = document.createElement("label");
    label.textContent = p.name;
    ins.appendChild(label);
    if (p.enum) { ins.appendChild(enumField(op, p)); continue; }
    if (p.kind === "bool") { ins.appendChild(boolField(op, p)); continue; }
    if (p.kind === "number" && p.range) { ins.appendChild(sliderField(op, p)); continue; }
    const isJson = typeof op[p.name] === "object" && op[p.name] !== null;
    const input = document.createElement(isJson ? "textarea" : "input");
    input.value = isJson ? JSON.stringify(op[p.name]) : (op[p.name] ?? "");
    input.onchange = () => {
      let v = input.value;
      if (isJson) {
        try { v = JSON.parse(input.value); } catch (e) { log(`\nbad JSON for ${p.name}: ${e}\n`); return; }
      } else if (p.kind === "number" && v !== "") {
        v = Number(v);
      }
      op[p.name] = v;
      render();
    };
    ins.appendChild(input);
  }
}

/* ---------------- run / json ---------------- */

async function runJob() {
  log("\n=== running job ===\n");
  try {
    const resp = await fetch("/api/v1/job", { method: "POST", body: JSON.stringify(JOB) });
    const reader = resp.body.getReader();
    const dec = new TextDecoder();
    for (;;) {
      const { done, value } = await reader.read();
      if (done) break;
      log(dec.decode(value));
    }
    log("\n=== done ===\n");
  } catch (e) {
    log(`\nerror: ${e}\n`);
  }
}

async function init() {
  SCHEMA = await (await fetch("/api/v1/schema")).json();
  renderPalette();
  render();
}

$("btnRun").onclick = runJob;
$("btnClear").onclick = () => { JOB = { type: "seq", steps: [] }; SELECTED = null; render(); };
$("btnPing").onclick = async () => {
  const r = await (await fetch("/api/v1/ping")).json();
  log(`\nping: ${JSON.stringify(r)}\n`);
};
$("btnJson").onclick = () => {
  $("jsonText").value = JSON.stringify(JOB, null, 2);
  $("jsonModal").style.display = "flex";
};
$("btnJsonClose").onclick = () => { $("jsonModal").style.display = "none"; };
$("btnJsonApply").onclick = () => {
  try {
    JOB = JSON.parse($("jsonText").value);
    SELECTED = null;
    $("jsonModal").style.display = "none";
    render();
  } catch (e) {
    log(`\nbad JSON: ${e}\n`);
  }
};

init();
