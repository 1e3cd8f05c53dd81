/* Data Accelerator TPU — single-page app.
   reference roles: datax-home (flow list), datax-pipeline (flow
   designer tabs), datax-query (LiveQuery editor), datax-metrics (live
   dashboard over the datapoints feed), datax-jobs (job ops). Routing is
   hash-based; API calls go through the website server's /api bridge. */

"use strict";

const $ = (sel, el) => (el || document).querySelector(sel);
const h = (tag, attrs, ...kids) => {
  const el = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs || {})) {
    if (v == null) continue;
    if (k === "onclick" || k.startsWith("on")) el.addEventListener(k.slice(2), v);
    else if (k === "html") el.innerHTML = v;
    else el.setAttribute(k, v);
  }
  for (const k of kids.flat()) {
    if (k == null) continue;
    el.append(k.nodeType ? k : document.createTextNode(k));
  }
  return el;
};

function toast(msg, ok = true) {
  const t = $("#toast");
  t.textContent = msg;
  t.style.borderColor = ok ? "var(--border)" : "var(--serious)";
  t.hidden = false;
  clearTimeout(toast._t);
  toast._t = setTimeout(() => (t.hidden = true), 3500);
}

async function api(method, path, body) {
  const resp = await fetch(path, {
    method,
    headers: body ? { "Content-Type": "application/json" } : undefined,
    body: body ? JSON.stringify(body) : undefined,
  });
  const payload = await resp.json().catch(() => ({}));
  if (!resp.ok) {
    const msg = payload.error && payload.error.message || resp.statusText;
    throw new Error(msg);
  }
  return payload.result !== undefined ? payload.result : payload;
}

/* ---------------- theme ---------------- */
const theme = localStorage.getItem("dxtheme");
if (theme) document.documentElement.dataset.theme = theme;
$("#themeToggle").onclick = () => {
  const cur = document.documentElement.dataset.theme === "dark" ? "light" : "dark";
  document.documentElement.dataset.theme = cur;
  localStorage.setItem("dxtheme", cur);
};

/* ---------------- router ---------------- */
const routes = {};
function route(prefix, fn) { routes[prefix] = fn; }
async function render() {
  const hash = location.hash || "#/flows";
  const view = $("#view");
  view.textContent = "";
  closeLiveFeeds();
  const key = Object.keys(routes)
    .sort((a, b) => b.length - a.length)
    .find((p) => hash.startsWith(p));
  $("#nav").replaceChildren(
    ...[["#/flows", "Flows"], ["#/query", "Query"],
        ["#/metrics", "Metrics"], ["#/jobs", "Jobs"],
        ["#/fleet", "Fleet"]].map(([href, label]) =>
      h("a", { href, class: hash.startsWith(href) ? "active" : "" }, label))
  );
  try {
    await routes[key || "#/flows"](view, hash);
  } catch (e) {
    view.append(h("div", { class: "card" }, `Error: ${e.message}`));
  }
}
window.addEventListener("hashchange", render);

/* ---------------- flows (datax-home) ---------------- */
route("#/flows", async (view) => {
  view.append(h("h1", {}, "Flows"));
  const flows = await api("GET", "/api/flow/flow/getall/min");
  const tbl = h("table", { class: "grid" },
    h("thead", {}, h("tr", {},
      h("th", {}, "Name"), h("th", {}, "Jobs"), h("th", {}, "Actions"))),
    h("tbody", {}, flows.map((f) => h("tr", {},
      h("td", {}, h("a", { href: `#/flow/${f.name}` }, f.displayName || f.name)),
      h("td", {}, String((f.jobNames || []).length)),
      h("td", {},
        h("button", { class: "ghost", onclick: () => location.hash = `#/metrics/${f.name}` }, "metrics"),
        " ",
        h("button", {
          class: "ghost danger", onclick: async () => {
            if (!confirm(`Delete flow ${f.name}?`)) return;
            await api("POST", "/api/flow/flow/delete", { flowName: f.name });
            toast(`deleted ${f.name}`); render();
          },
        }, "delete"))))));
  view.append(tbl);
  const name = h("input", { placeholder: "new-flow-name" });
  view.append(h("div", { class: "row" }, name,
    h("button", {
      onclick: async () => {
        if (!name.value) return;
        await api("POST", "/api/flow/flow/save",
          { name: name.value, displayName: name.value });
        location.hash = `#/flow/${name.value}`;
      },
    }, "New flow")));
});

/* ---------------- flow designer (datax-pipeline) ---------------- */
const TABS = ["info", "input", "query", "rules", "functions", "outputs",
              "scale", "schedule"];

route("#/flow/", async (view, hash) => {
  const [, , name, tab = "info"] = hash.split("/");
  const doc = await api("GET", `/api/flow/flow/get?flowName=${encodeURIComponent(name)}`);
  const gui = doc.gui || {};
  view.append(h("h1", {}, `Flow: ${gui.displayName || name}`));
  view.append(h("div", { class: "tabs" }, TABS.map((t) =>
    h("a", { href: `#/flow/${name}/${t}`, class: t === tab ? "active" : "" }, t))));
  const pane = h("div", {});
  view.append(pane);

  const save = async () => {
    await api("POST", "/api/flow/flow/save", gui);
    toast("flow saved");
  };
  // inline diagnostics from the flow static analyzer (flow/validate —
  // same DXnnn diagnostics as `python -m data_accelerator_tpu_torch.analysis`,
  // device + udf tiers included: DX2xx lints + per-stage cost table,
  // DX3xx UDF tracing-safety lints + analyzed-function summary)
  const diagBox = h("div", { class: "diags" });
  const fmtBytes = (n) => {
    for (const u of ["B", "KB", "MB", "GB"]) {
      if (Math.abs(n) < 1024 || u === "GB")
        return (u === "B" ? Math.round(n) : n.toFixed(1)) + u;
      n /= 1024;
    }
  };
  const renderCostTable = (dev) => {
    if (!dev || !dev.stages || !dev.stages.length) return null;
    const t = dev.totals || {};
    /* roofline latency model (analysis/costmodel.py latency_model):
       per-stage predicted ms + the deviceStep/d2h decomposition; the
       per-stage column joins by stage name */
    const lm = dev.latencyModel || {};
    const lmStageMs = {};
    for (const s of lm.stages || []) lmStageMs[s.name] = s.computeMs;
    const lt = lm.totals || {};
    return h("div", { class: "cost" },
      h("div", { class: "muted" },
        `device plan @ ${dev.chips} chips — HBM ${fmtBytes(t.hbmBytes || 0)}` +
        ` (persistent ${fmtBytes(t.persistentBytes || 0)}),` +
        ` ICI ${fmtBytes(t.iciBytesPerBatch || 0)}/batch,` +
        ` D2H ${fmtBytes(t.d2hBytesPerBatch || 0)}/batch,` +
        ` ~${fmtVal(t.flops || 0)} FLOP/batch`),
      lt.batchMs != null ? h("div", { class: "muted" },
        `roofline latency (${lm.profileSource} profile): device step ` +
        `${fmtVal(lt.deviceStepMs)} ms + D2H ${fmtVal(lt.d2hMs || 0)} ms` +
        ` = ${fmtVal(lt.batchMs)} ms/batch (lower bound)`) : null,
      h("table", { class: "grid cost-table" },
        h("thead", {}, h("tr", {},
          h("th", {}, "stage"), h("th", {}, "kind"), h("th", {}, "rows"),
          h("th", {}, "HBM"), h("th", {}, "FLOPs"), h("th", {}, "ICI/batch"),
          h("th", {}, "D2H/batch"), h("th", {}, "roofline ms"))),
        h("tbody", {}, dev.stages.map((s) => h("tr", {},
          h("td", { class: "mono" }, s.name),
          h("td", {}, s.kind),
          h("td", { class: "num" }, fmtVal(s.rows)),
          h("td", { class: "num" }, fmtBytes(s.hbmBytes)),
          h("td", { class: "num" }, s.flops ? fmtVal(s.flops) : "–"),
          h("td", { class: "num" }, s.iciBytes ? fmtBytes(s.iciBytes) : "–"),
          h("td", { class: "num" }, s.d2hBytes ? fmtBytes(s.d2hBytes) : "–"),
          h("td", { class: "num" },
            lmStageMs[s.name] != null ? fmtVal(lmStageMs[s.name]) : "–"))))));
  };
  const renderPlacement = (f) => {
    // fleet tier (flow/validate fleet: true): placement plan of this
    // flow + every registered flow on the fleet spec — chip -> flows ->
    // packed HBM/headroom (the DX4xx admission-gate surface)
    if (!f || !f.placement) return null;
    const p = f.placement;
    const spec = f.spec || {};
    const chips = p.chips || [];
    const probs = [].concat(p.unplaced || [], p.oversized || []);
    return h("div", { class: "cost placement" },
      h("div", { class: "muted" },
        `fleet placement @ ${spec.chips} chip(s) x ` +
        `${fmtBytes(spec.hbmPerChipBytes || 0)} HBM — ` +
        (p.feasible ? "feasible" : "INFEASIBLE") +
        (probs.length ? ` (no fit: ${probs.join(", ")})` : "")),
      h("table", { class: "grid cost-table placement-table" },
        h("thead", {}, h("tr", {},
          h("th", {}, "chip"), h("th", {}, "flows"),
          h("th", {}, "predicted HBM"), h("th", {}, "headroom"))),
        h("tbody", {}, chips.map((c) => h("tr", {},
          h("td", { class: "num" }, String(c.chip)),
          h("td", { class: "mono" }, (c.flows || []).join(", ")),
          h("td", { class: "num" }, fmtBytes(c.hbmBytes || 0)),
          h("td", { class: "num" },
            ((c.headroom || 0) * 100).toFixed(1) + "%"))))));
  };
  const renderUdfSummary = (u) => {
    if (!u || !u.functions || !u.functions.length) return null;
    return h("div", { class: "muted" },
      "udf tier: " + u.functions.map((f) =>
        `${f.name} [${f.tier}] ${f.kind || "unloadable"}` +
        (f.analyzed && f.analyzed.length ? ` (${f.analyzed.join(",")})` : "")
      ).join(" · "));
  };
  const renderCompileSurface = (c) => {
    // compile tier (flow/validate compile: true): the enumerated jit
    // entry points + AOT manifest summary — "stable" means the flow
    // ships precompiled and restarts warm-start in sub-second
    if (!c || !c.entries) return null;
    return h("div", { class: "muted" },
      `compile surface: ${c.entries} entries (1 step + ` +
      `${c.helperEntries} transfer-helper over ` +
      `${(c.buckets || []).length} bucket(s)) — ` +
      (c.stable ? "stable (AOT manifest covers every dispatch; " +
                  "warm starts skip first-dispatch compiles)"
                : "OPEN (manifest covers the initial surface only; " +
                  "runtime re-traces surface as Retrace_Count)") +
      `, jit-cache cap ${c.jitCacheCap}`);
  };
  const renderShardingTable = (m) => {
    // mesh tier (flow/validate mesh: true): the static SPMD partition
    // plan — stage -> shard axis -> per-chip bytes -> ICI bytes, with
    // the modeled reshard points (the DX7xx surface). "validated"
    // means every byte was asserted equal to a real Mesh lowering.
    if (!m || !m.stages || !m.stages.length) return null;
    const t = m.totals || {};
    return h("div", { class: "cost sharding" },
      h("div", { class: "muted" },
        `mesh plan @ ${m.chips} chips — ` +
        `ICI ${fmtBytes(t.iciWireBytesPerBatch || 0)}/batch wire ` +
        `(${t.reshardCount || 0} reshard(s)), ` +
        `per-chip HBM ${fmtBytes(t.perChipHbmBytes || 0)} — ` +
        (m.validated ? "model validated against the Mesh lowering"
                     : "model UNVALIDATED (no multi-device backend)")),
      h("table", { class: "grid cost-table sharding-table" },
        h("thead", {}, h("tr", {},
          h("th", {}, "stage"), h("th", {}, "kind"), h("th", {}, "axis"),
          h("th", {}, "rows"), h("th", {}, "per-chip"),
          h("th", {}, "ICI/batch"), h("th", {}, "reshards"))),
        h("tbody", {}, m.stages.map((s) => h("tr", {},
          h("td", { class: "mono" }, s.name),
          h("td", {}, s.kind),
          h("td", {}, s.axis),
          h("td", { class: "num" }, fmtVal(s.rows)),
          h("td", { class: "num" }, fmtBytes(s.perChipBytes || 0)),
          h("td", { class: "num" },
            s.iciWireBytes ? fmtBytes(s.iciWireBytes) : "–"),
          h("td", { class: "mono" },
            (s.reshards || []).map((e) => e.table).join(", ") || "–"))))));
  };
  const renderRaceGate = (rc) => {
    // race tier (flow/validate race: true): the DX8xx buffer-lifetime
    // gate over the ENGINE the flow deploys onto — any error here is
    // an engine bug, not a flow bug, so the summary line names the
    // analyzed surface (merged DX8xx diagnostics render above)
    if (!rc || !rc.analyzedFiles) return null;
    return h("div", { class: "muted" },
      `race gate: ${rc.analyzedFiles} engine module(s) analyzed — ` +
      `${rc.allowedZeroCopySites} pinned zero-copy site(s), ` +
      `${rc.ownerHandoffSites} owner handoff(s)`);
  };
  const renderProtocolGate = (pc) => {
    // protocol tier (flow/validate protocol: true): the DX90x
    // exactly-once delivery gate over the engine + rescale handoff —
    // like the race gate, an error here is an engine bug (merged
    // DX90x diagnostics render above)
    if (!pc || !pc.analyzedFiles) return null;
    return h("div", { class: "muted" },
      `protocol gate: ${pc.analyzedFiles} engine module(s) analyzed — ` +
      `${pc.effectEvents} effect event(s), ` +
      `${pc.postCommitSites} pinned post-commit site(s), ` +
      `${pc.requeueUpstreamSites} requeue-upstream site(s)`);
  };
  const renderConfGate = (cf) => {
    // conf tier (flow/validate conf: true): the DX10xx configuration
    // lattice gate — engine read sites + generated keys checked
    // against the typed conf registry, plus this flow's effective
    // conf (merged DX10xx diagnostics render above)
    if (!cf || !cf.analyzedFiles) return null;
    return h("div", { class: "muted" },
      `conf gate: ${cf.analyzedFiles} module(s) scanned — ` +
      `${cf.readSites} read site(s) / ${cf.readKeys} key(s), ` +
      `${cf.producedKeys} produced key(s), ` +
      `${cf.registryKeys} registry row(s)`);
  };
  const renderDiags = (r) => {
    diagBox.replaceChildren(
      h("div", { class: "muted" },
        r.ok ? `analyzer: clean (${r.warningCount} warning(s))`
             : `analyzer: ${r.errorCount} error(s), ${r.warningCount} warning(s)`),
      ...r.diagnostics.map((d) => h("div", { class: `diag sev-${d.severity}` },
        h("span", { class: "diag-code" }, d.code),
        d.table ? h("span", { class: "diag-table" }, d.table) : null,
        h("span", {}, d.message),
        d.span && d.span.line ? h("span", { class: "muted" }, ` line ${d.span.line}`) : null)),
      renderUdfSummary(r.udfs),
      renderCompileSurface(r.compile),
      renderRaceGate(r.race),
      renderProtocolGate(r.protocol),
      renderConfGate(r.conf),
      renderCostTable(r.device),
      renderShardingTable(r.mesh),
      renderPlacement(r.fleet));
  };
  const validate = async () => {
    await save();
    // all: true = every analysis tier in one call (semantic + device +
    // udfs + fleet + compile + mesh + race + protocol), one merged
    // diagnostics list
    const r = await api("POST", "/api/flow/flow/validate",
      { flow: gui, all: true });
    renderDiags(r);
    toast(r.ok ? "flow is clean" : `${r.errorCount} error(s) found`, r.ok);
    return r;
  };
  const actions = h("div", { class: "row" },
    h("button", { onclick: save }, "Save"),
    h("button", { class: "ghost", onclick: validate }, "Validate"),
    h("button", {
      class: "ghost", onclick: async () => {
        const r0 = await validate();
        if (!r0.ok) { toast("fix analyzer errors before generating", false); return; }
        const r = await api("POST", "/api/flow/flow/generateconfigs", { flowName: name });
        toast(`generated: ${(r.jobNames || []).join(", ")}`);
      },
    }, "Generate configs"),
    h("button", {
      class: "ghost", onclick: async () => {
        const r = await api("POST", "/api/flow/flow/startjobs", { flowName: name });
        toast(`started ${r.length} job(s)`);
      },
    }, "Start"),
    h("button", {
      class: "ghost", onclick: async () => {
        const r = await api("POST", "/api/flow/flow/stopjobs", { flowName: name });
        toast(`stopped ${r.length} job(s)`);
      },
    }, "Stop"));
  view.append(actions, diagBox);

  const field = (obj, key, label, opts) => {
    const input = opts && opts.options
      ? h("select", {}, opts.options.map((o) =>
          h("option", { value: o, selected: (obj[key] || "") === o ? "" : null }, o)))
      : h("input", { value: obj[key] || "", placeholder: (opts && opts.ph) || "" });
    input.addEventListener("change", () => (obj[key] = input.value));
    return h("label", { class: "f" }, h("span", {}, label), input);
  };
  const area = (obj, key, label) => {
    const ta = h("textarea", { class: "code" });
    ta.value = obj[key] || "";
    ta.addEventListener("change", () => (obj[key] = ta.value));
    return h("label", { class: "f" }, h("span", {}, label), ta);
  };

  gui.input = gui.input || {}; gui.input.properties = gui.input.properties || {};
  gui.process = gui.process || {}; gui.rules = gui.rules || [];
  gui.outputs = gui.outputs || []; gui.scale = gui.scale || {};
  gui.batch = gui.batch || [];

  if (tab === "info") {
    pane.append(field(gui, "displayName", "Display name"));
    pane.append(field(gui, "databaseName", "Database"));
    pane.append(h("div", { class: "muted" }, `internal name: ${name}`));
  } else if (tab === "input") {
    pane.append(field(gui.input, "mode", "Mode",
      { options: ["streaming", "batching"] }));
    pane.append(field(gui.input, "type", "Input type",
      { options: ["local", "socket", "file", "blobpointer", "events"] }));
    pane.append(area(gui.input.properties, "inputSchemaFile", "Input schema (JSON)"));
    pane.append(area(gui.input.properties, "normalizationSnippet", "Normalization"));
    pane.append(h("button", {
      class: "ghost", onclick: async () => {
        const r = await api("POST", "/api/schemainference/inputdata/inferschema",
          { name, seconds: 10 });
        gui.input.properties.inputSchemaFile =
          typeof r.Schema === "string" ? r.Schema : JSON.stringify(r.Schema, null, 1);
        render(); toast("schema inferred from sample");
      },
    }, "Infer schema from sample"));
    // additional named sources (multi-source flows: each projects into
    // its own table; TIMEWINDOW over any table enables cross-stream
    // sliding-window joins)
    gui.input.sources = gui.input.sources || [];
    const srcs = gui.input.sources;
    const srcList = h("div", {});
    const renderSrcs = () => {
      srcList.replaceChildren(...srcs.map((sr, i) => {
        sr.properties = sr.properties || {};
        return h("div", { class: "card" },
          field(sr, "id", "Source name", { ph: "weather" }),
          field(sr, "type", "Input type",
            { options: ["local", "socket", "file", "kafka", "eventhub-kafka"] }),
          field(sr.properties, "target", "Projected table",
            { ph: "Weather (defaults to the source name)" }),
          area(sr.properties, "inputSchemaFile", "Schema (JSON)"),
          area(sr.properties, "normalizationSnippet", "Normalization"),
          h("button", {
            class: "ghost danger",
            onclick: () => { srcs.splice(i, 1); renderSrcs(); },
          }, "remove source"));
      }));
    };
    renderSrcs();
    pane.append(
      h("h3", {}, "Additional sources"),
      srcList,
      h("button", {
        class: "ghost",
        onclick: () => { srcs.push({ id: "", type: "local", properties: {} }); renderSrcs(); },
      }, "+ add source"));
  } else if (tab === "query") {
    // gui contract: process.queries is a list of script chunks
    const qobj = { text: (gui.process.queries || []).join("\n") };
    const ta = area(qobj, "text", "DataXQuery transform");
    $("textarea", ta).addEventListener("change", (ev) => {
      gui.process.queries = [ev.target.value];
    });
    pane.append(ta);
    pane.append(h("div", { class: "muted" },
      "--DataXQuery-- blocks; TIMEWINDOW('5 minutes'); OUTPUT t TO sink;"));
  } else if (tab === "rules") {
    const AGG_FNS = ["AVG", "SUM", "COUNT", "MIN", "MAX", "DCOUNT"];
    // csv editor over a LIST-valued model key: displays joined, stores
    // an array on change, and never mutates the model just by rendering
    // (the backend contract is a list; a render must not turn it into a
    // string that codegen would then iterate char-by-char)
    const csvField = (obj, key, label, opts) => {
      const disp = {
        v: Array.isArray(obj[key]) ? obj[key].join(",") : (obj[key] || ""),
      };
      const f = field(disp, "v", label, opts);
      $("input", f).addEventListener("change", (ev) => {
        obj[key] = ev.target.value.split(",").map((x) => x.trim()).filter(Boolean);
      });
      return f;
    };
    const list = h("div", {});
    const renderRules = () => {
      list.replaceChildren(...gui.rules.map((r, i) => {
        r.properties = r.properties || {};
        const p = r.properties;
        const sinksField = csvField(p, "_S_alertSinks", "Alert sinks (csv)", { ph: "Metrics" });
        const typeField = field(p, "_S_ruleType", "Type",
          { options: ["SimpleRule", "AggregateRule"] });
        $("select", typeField).addEventListener("change", () => renderRules());
        const card = h("div", { class: "card" },
          field(p, "_S_ruleDescription", "Description"),
          typeField);
        if ((p._S_ruleType || "SimpleRule") === "AggregateRule") {
          // pivot/agg builders (datax-pipeline AggregateRule editors):
          // pivots are the GROUP BY columns; each agg row contributes
          // "<FN>(<field>)" to $aggs, aliased FN_field for the condition
          card.append(csvField(p, "_S_pivots",
            "Pivot by (group-by columns, csv)", { ph: "deviceId, homeId" }));
          if (!Array.isArray(p._S_aggs)) {
            p._S_aggs = typeof p._S_aggs === "string" && p._S_aggs
              ? p._S_aggs.split(",").map((x) => x.trim()) : [];
          }
          const aggList = h("div", {});
          const renderAggs = () => {
            aggList.replaceChildren(
              ...p._S_aggs.map((agg, j) => {
                const m = /^(\w+)\((.*)\)$/.exec(agg) || [null, "AVG", ""];
                const fnSel = h("select", {}, AGG_FNS.map((o) =>
                  h("option", { value: o, selected: o === m[1] ? "" : null }, o)));
                const fieldIn = h("input", { value: m[2], placeholder: "temperature" });
                const sync = () => {
                  p._S_aggs[j] = `${fnSel.value}(${fieldIn.value.trim()})`;
                };
                fnSel.addEventListener("change", sync);
                fieldIn.addEventListener("change", sync);
                return h("div", { class: "row" }, fnSel, fieldIn,
                  h("span", { class: "muted" },
                    ` alias: ${(m[1] || "AVG")}_${(m[2] || "").replace(/\W/g, "_")}`),
                  h("button", {
                    class: "ghost danger",
                    onclick: () => { p._S_aggs.splice(j, 1); renderAggs(); },
                  }, "x"));
              }),
              h("button", {
                class: "ghost",
                onclick: () => { p._S_aggs.push("AVG()"); renderAggs(); },
              }, "+ add aggregate"));
          };
          renderAggs();
          card.append(h("label", { class: "f" },
            h("span", {}, "Aggregates"), aggList));
          card.append(field(p, "_S_condition", "Alert condition (over agg aliases)",
            { ph: "AVG_temperature > 75" }));
        } else {
          card.append(field(p, "_S_condition", "Condition (SQL expr)",
            { ph: "deviceType = 'DoorLock' AND status = 0" }));
        }
        card.append(
          sinksField,
          field(p, "_S_severity", "Severity", { options: ["Critical", "Medium", "Low"] }),
          field(p, "_S_isAlert", "Is alert", { options: ["", "true", "false"] }),
          h("button", {
            class: "ghost danger",
            onclick: () => { gui.rules.splice(i, 1); renderRules(); },
          }, "remove rule"));
        return card;
      }));
    };
    renderRules();
    pane.append(list, h("button", {
      class: "ghost",
      onclick: () => { gui.rules.push({ id: `rule${Date.now()}`, type: "Rule", properties: {} }); renderRules(); },
    }, "+ add rule"));
  } else if (tab === "functions") {
    // UDF / UDAF / external-function editor (datax-pipeline function
    // editors); entries land in process.functions and S500 routes them
    // to processJarUDFs / processJarUDAFs / processAzureFunctions
    gui.process.functions = gui.process.functions || [];
    const fns = gui.process.functions;
    const list = h("div", {});
    const renderFns = () => {
      list.replaceChildren(...fns.map((f, i) => {
        f.properties = f.properties || {};
        const fp = f.properties;
        const typeField = field(f, "type", "Kind",
          { options: ["udf", "udaf", "azureFunction"] });
        $("select", typeField).addEventListener("change", () => renderFns());
        const card = h("div", { class: "card" },
          field(f, "id", "Function name", { ph: "anomalyscore" }),
          typeField);
        if ((f.type || "udf") === "azureFunction") {
          card.append(
            field(fp, "serviceEndpoint", "Service endpoint", { ph: "https://fn.example" }),
            field(fp, "api", "API name", { ph: "score" }),
            field(fp, "code", "Function key/code"),
            field(fp, "methodType", "Method", { options: ["get", "post"] }));
        } else {
          card.append(
            field(fp, "module", "Python path (module:attribute)",
              { ph: "data_accelerator_tpu_torch.udf.samples:anomalyscore" }),
            h("div", { class: "muted" },
              (f.type || "udf") === "udaf"
                ? "attribute must be/build a UdfAggregate (see udf/samples.py)"
                : "attribute must be/build a torch-callable UDF (see udf/samples.py)"));
        }
        card.append(h("button", {
          class: "ghost danger",
          onclick: () => { fns.splice(i, 1); renderFns(); },
        }, "remove function"));
        return card;
      }));
    };
    renderFns();
    pane.append(list, h("button", {
      class: "ghost",
      onclick: () => { fns.push({ id: "", type: "udf", properties: {} }); renderFns(); },
    }, "+ add function"));
  } else if (tab === "outputs") {
    const list = h("div", {});
    const renderOutputs = () => {
      list.replaceChildren(...gui.outputs.map((o, i) => {
        o.properties = o.properties || {};
        const destKey = { blob: "folder", file: "folder", local: "folder",
                          httppost: "endpoint", eventhub: "connection",
                          cosmosdb: "connection", sql: "connection" }[o.type];
        const typeField = field(o, "type", "Sink type",
          { options: ["blob", "file", "sql", "cosmosdb", "eventhub", "httppost", "metric", "console"] });
        $("select", typeField).addEventListener("change", () => renderOutputs());
        return h("div", { class: "card" },
          field(o, "id", "Output name", { ph: "myOutput" }),
          typeField,
          destKey ? field(o.properties, destKey,
            destKey === "folder" ? "Output folder" :
            destKey === "endpoint" ? "Endpoint URL" : "Connection string") : null,
          h("button", {
            class: "ghost danger",
            onclick: () => { gui.outputs.splice(i, 1); renderOutputs(); },
          }, "remove output"));
      }));
    };
    renderOutputs();
    pane.append(list, h("button", {
      class: "ghost",
      onclick: () => { gui.outputs.push({ id: "", type: "blob", properties: {} }); renderOutputs(); },
    }, "+ add output"));
  } else if (tab === "scale") {
    gui.process.jobconfig = gui.process.jobconfig || {};
    pane.append(field(gui.process.jobconfig, "jobNumChips", "TPU chips", { ph: "1" }));
    pane.append(field(gui.process.jobconfig, "jobBatchCapacity", "Batch capacity (rows)", { ph: "65536" }));
    pane.append(field(gui.process.jobconfig, "jobDecoderThreads", "Ingest decoder shards", { ph: "engine default" }));
    pane.append(h("div", { class: "muted" },
      "capacity shards over the chip mesh; collectives ride ICI; " +
      "decoder shards fan the host-side ingest parse across cores"));
    pane.append(field(gui.process.jobconfig, "jobLqMaxBatchWaitMs", "LiveQuery batch wait (ms)", { ph: "8" }));
    pane.append(field(gui.process.jobconfig, "jobLqTenantMaxSessions", "LiveQuery sessions/tenant", { ph: "8" }));
    pane.append(field(gui.process.jobconfig, "jobLqTenantMaxQps", "LiveQuery QPS/tenant", { ph: "50" }));
    pane.append(h("div", { class: "muted" },
      "LiveQuery serving plane: executes queue per compile signature and " +
      "micro-batch into one device dispatch per tick; over-quota tenants " +
      "get 429 + Retry-After"));
  } else if (tab === "schedule") {
    const list = h("div", {});
    const renderBatches = () => {
      list.replaceChildren(...gui.batch.map((b, i) => {
        b.properties = b.properties || {};
        return h("div", { class: "card" },
          field(b.properties, "type", "Type", { options: ["recurring", "oneTime"] }),
          field(b.properties, "intervalSeconds", "Interval (s)", { ph: "3600" }),
          field(b.properties, "path", "Input path pattern", { ph: "/data/{yyyy-MM-dd}/*.json" }),
          field(b.properties, "startTime", "Window start (ISO)"),
          field(b.properties, "endTime", "Window end (ISO)"),
          h("button", {
            class: "ghost danger",
            onclick: () => { gui.batch.splice(i, 1); renderBatches(); },
          }, "remove"));
      }));
    };
    renderBatches();
    pane.append(list, h("button", {
      class: "ghost",
      onclick: () => { gui.batch.push({ properties: {} }); renderBatches(); },
    }, "+ add batch window"));
  }
});

/* ---------------- LiveQuery (datax-query) ---------------- */
route("#/query", async (view) => {
  view.append(h("h1", {}, "LiveQuery"));
  const flows = await api("GET", "/api/flow/flow/getall/min");
  const sel = h("select", {}, flows.map((f) => h("option", { value: f.name }, f.name)));
  const kernelLabel = h("span", { class: "muted" }, "no kernel");
  let kernelId = null;
  const editor = h("textarea", { class: "code", placeholder:
    "--DataXQuery--\nT = SELECT * FROM DataXProcessedInput WHERE ..." });
  const out = h("div", {});

  const showTable = (rows, title) => {
    out.replaceChildren();
    out.append(h("h2", {}, title));
    if (!rows || !rows.length) { out.append(h("div", { class: "muted" }, "no rows")); return; }
    const cols = Object.keys(rows[0]);
    out.append(h("table", { class: "grid" },
      h("thead", {}, h("tr", {}, cols.map((c) => h("th", {}, c)))),
      h("tbody", {}, rows.map((r) => h("tr", {}, cols.map((c) =>
        h("td", { class: "mono" }, JSON.stringify(r[c]))))))));
  };

  view.append(h("div", { class: "row" },
    sel,
    h("button", {
      class: "ghost", onclick: async () => {
        const r = await api("POST", "/api/interactivequery/kernel",
          { name: sel.value });
        kernelId = r.kernelId;
        kernelLabel.textContent = `kernel ${kernelId.slice(0, 8)}…`;
        toast("kernel ready");
      },
    }, "Create kernel"),
    h("button", {
      class: "ghost", onclick: async () => {
        const r = await api("POST", "/api/interactivequery/kernel/refresh",
          { name: sel.value });
        kernelId = r.kernelId;
        kernelLabel.textContent = `kernel ${kernelId.slice(0, 8)}…`;
        toast("kernel refreshed with fresh sample");
      },
    }, "Refresh sample"),
    kernelLabel));
  view.append(editor);
  view.append(h("div", { class: "row" },
    h("button", {
      onclick: async () => {
        if (!kernelId) { toast("create a kernel first", false); return; }
        const r = await api("POST", "/api/interactivequery/kernel/executequery",
          { kernelId, query: editor.value, maxRows: 50 });
        showTable(r.rows || r.result || r, "Result");
      },
    }, "Execute"),
    h("button", {
      class: "ghost", onclick: async () => {
        if (!kernelId) { toast("create a kernel first", false); return; }
        const r = await api("POST", "/api/interactivequery/kernel/executequery",
          { kernelId, query: "DataXProcessedInput", maxRows: 20 });
        showTable(r.rows || r.result || r, "Sample input");
      },
    }, "Show sample input")));
  view.append(out);
});

/* ---------------- metrics dashboard (datax-metrics) ---------------- */
const liveFeeds = [];
function closeLiveFeeds() {
  while (liveFeeds.length) liveFeeds.pop().close();
}

const SERIES_VARS = ["--series-1", "--series-2", "--series-3",
                     "--series-4", "--series-5", "--series-6"];

/* canonical engine stages (constants.py MetricName.STAGES minus the
   whole-batch rollup) and their Latency-<Stage> metric stems */
const STAGES = ["decode", "dispatch", "device-step", "sync", "collect",
                "sinks", "checkpoint"];
const stageMetric = (s) =>
  "Latency-" + s.split("-").map((w) => w[0].toUpperCase() + w.slice(1)).join("");
const LATENCY_PCTL_RE = /^Latency-[A-Za-z]+-p(50|95|99)$/;

function lineChart(container, title) {
  /* single-metric timechart: 2px line, crosshair+tooltip, recessive
     grid; series identity from the title (single series, no legend). */
  const W = 800, H = 180, PL = 54, PB = 18, PT = 8;
  const card = h("div", { class: "card chart-card" },
    h("div", { class: "chart-title" }, title));
  const wrap = h("div", { class: "chart-wrap" });
  const svg = document.createElementNS("http://www.w3.org/2000/svg", "svg");
  svg.setAttribute("viewBox", `0 0 ${W} ${H}`);
  const tip = h("div", { class: "tooltip" });
  wrap.append(svg, tip);
  card.append(wrap);
  container.append(card);
  const pts = [];  // {t, v}
  const MAX_POINTS = 600;

  function draw() {
    svg.replaceChildren();
    if (pts.length < 2) return;
    const t0 = pts[0].t, t1 = pts[pts.length - 1].t || t0 + 1;
    let vmin = Math.min(...pts.map((p) => p.v));
    let vmax = Math.max(...pts.map((p) => p.v));
    if (vmin === vmax) { vmin -= 1; vmax += 1; }
    const x = (t) => PL + (W - PL - 8) * (t - t0) / Math.max(1, t1 - t0);
    const y = (v) => PT + (H - PT - PB) * (1 - (v - vmin) / (vmax - vmin));
    const mk = (n, attrs) => {
      const el = document.createElementNS("http://www.w3.org/2000/svg", n);
      for (const [k, v] of Object.entries(attrs)) el.setAttribute(k, v);
      svg.append(el);
      return el;
    };
    for (const frac of [0, 0.5, 1]) {
      const v = vmin + (vmax - vmin) * frac;
      mk("line", { x1: PL, x2: W - 8, y1: y(v), y2: y(v), class: "grid-line" });
      const t = mk("text", { x: PL - 6, y: y(v) + 3, "text-anchor": "end" });
      t.textContent = fmtVal(v);
      t.setAttribute("fill", "var(--text-muted)");
      t.setAttribute("font-size", "10");
    }
    const d = pts.map((p, i) => `${i ? "L" : "M"}${x(p.t).toFixed(1)},${y(p.v).toFixed(1)}`).join("");
    mk("path", { d, class: "series", stroke: `var(${SERIES_VARS[0]})` });
    const cross = mk("line", { y1: PT, y2: H - PB, stroke: "var(--text-muted)", "stroke-dasharray": "3,3", visibility: "hidden" });
    const dot = mk("circle", { r: 4, fill: `var(${SERIES_VARS[0]})`, stroke: "var(--surface-2)", "stroke-width": 2, visibility: "hidden" });
    svg.onmousemove = (ev) => {
      const rect = svg.getBoundingClientRect();
      const mx = (ev.clientX - rect.left) * W / rect.width;
      let best = pts[0], bd = Infinity;
      for (const p of pts) {
        const dd = Math.abs(x(p.t) - mx);
        if (dd < bd) { bd = dd; best = p; }
      }
      cross.setAttribute("x1", x(best.t)); cross.setAttribute("x2", x(best.t));
      cross.setAttribute("visibility", "visible");
      dot.setAttribute("cx", x(best.t)); dot.setAttribute("cy", y(best.v));
      dot.setAttribute("visibility", "visible");
      tip.style.display = "block";
      tip.style.left = `${(x(best.t) / W) * rect.width + 12}px`;
      tip.style.top = `${(y(best.v) / H) * rect.height - 10}px`;
      tip.textContent = `${new Date(best.t).toLocaleTimeString()} — ${fmtVal(best.v)}`;
    };
    svg.onmouseleave = () => {
      cross.setAttribute("visibility", "hidden");
      dot.setAttribute("visibility", "hidden");
      tip.style.display = "none";
    };
  }
  return {
    push(t, v) {
      pts.push({ t, v });
      if (pts.length > MAX_POINTS) pts.shift();
      draw();
    },
    seed(points) {
      pts.splice(0, pts.length, ...points.map((p) => ({ t: p.uts, v: +p.val })));
      draw();
    },
  };
}

function fmtVal(v) {
  if (Math.abs(v) >= 1e6) return (v / 1e6).toFixed(1) + "M";
  if (Math.abs(v) >= 1e3) return (v / 1e3).toFixed(1) + "k";
  return (+v).toFixed(Math.abs(v) < 10 && v % 1 ? 2 : 0);
}

function multiChart(container, title, seriesNames) {
  /* multi-series timechart (per-stage latency): one 2px line per
     series, shared scale, legend keyed to the categorical palette. */
  const W = 800, H = 200, PL = 54, PB = 18, PT = 8;
  const card = h("div", { class: "card chart-card" },
    h("div", { class: "chart-title" }, title));
  const wrap = h("div", { class: "chart-wrap" });
  const svg = document.createElementNS("http://www.w3.org/2000/svg", "svg");
  svg.setAttribute("viewBox", `0 0 ${W} ${H}`);
  const tip = h("div", { class: "tooltip" });
  wrap.append(svg, tip);
  const colorOf = (name) =>
    `var(${SERIES_VARS[seriesNames.indexOf(name) % SERIES_VARS.length]})`;
  card.append(wrap, h("div", { class: "legend" }, seriesNames.map((n) =>
    h("span", {},
      h("span", { class: "sw", style: `background:${colorOf(n)}` }), n))));
  container.append(card);
  const data = {};  // series -> [{t, v}]
  for (const n of seriesNames) data[n] = [];
  const MAX_POINTS = 600;

  function draw() {
    svg.replaceChildren();
    const all = seriesNames.flatMap((n) => data[n]);
    if (all.length < 2) return;
    const t0 = Math.min(...all.map((p) => p.t));
    const t1 = Math.max(...all.map((p) => p.t));
    let vmin = 0;  // latency: zero-based scale reads honestly
    let vmax = Math.max(...all.map((p) => p.v));
    if (vmax <= vmin) vmax = vmin + 1;
    const x = (t) => PL + (W - PL - 8) * (t - t0) / Math.max(1, t1 - t0);
    const y = (v) => PT + (H - PT - PB) * (1 - (v - vmin) / (vmax - vmin));
    const mk = (n, attrs) => {
      const el = document.createElementNS("http://www.w3.org/2000/svg", n);
      for (const [k, v] of Object.entries(attrs)) el.setAttribute(k, v);
      svg.append(el);
      return el;
    };
    for (const frac of [0, 0.5, 1]) {
      const v = vmin + (vmax - vmin) * frac;
      mk("line", { x1: PL, x2: W - 8, y1: y(v), y2: y(v), class: "grid-line" });
      const t = mk("text", { x: PL - 6, y: y(v) + 3, "text-anchor": "end" });
      t.textContent = fmtVal(v);
      t.setAttribute("fill", "var(--text-muted)");
      t.setAttribute("font-size", "10");
    }
    for (const name of seriesNames) {
      const pts = data[name];
      if (pts.length < 2) continue;
      const d = pts.map((p, i) =>
        `${i ? "L" : "M"}${x(p.t).toFixed(1)},${y(p.v).toFixed(1)}`).join("");
      mk("path", { d, class: "series", stroke: colorOf(name) });
    }
    svg.onmousemove = (ev) => {
      const rect = svg.getBoundingClientRect();
      const mx = (ev.clientX - rect.left) * W / rect.width;
      const my = (ev.clientY - rect.top) * H / rect.height;
      let best = null, bd = Infinity;
      for (const name of seriesNames) {
        for (const p of data[name]) {
          const dd = Math.abs(x(p.t) - mx) + Math.abs(y(p.v) - my) / 4;
          if (dd < bd) { bd = dd; best = { ...p, name }; }
        }
      }
      if (!best) return;
      tip.style.display = "block";
      tip.style.left = `${(x(best.t) / W) * rect.width + 12}px`;
      tip.style.top = `${(y(best.v) / H) * rect.height - 10}px`;
      tip.textContent =
        `${best.name} — ${new Date(best.t).toLocaleTimeString()} — ${fmtVal(best.v)} ms`;
    };
    svg.onmouseleave = () => { tip.style.display = "none"; };
  }
  return {
    push(name, t, v) {
      if (!data[name]) return;
      data[name].push({ t, v });
      if (data[name].length > MAX_POINTS) data[name].shift();
      draw();
    },
    seed(name, points) {
      if (!data[name]) return;
      data[name].splice(0, data[name].length,
        ...points.map((p) => ({ t: p.uts, v: +p.val })));
      draw();
    },
  };
}

route("#/metrics", async (view, hash) => {
  const flow = hash.split("/")[2] || "";
  view.append(h("h1", {}, flow ? `Metrics — ${flow}` : "Metrics"));
  const flows = await api("GET", "/api/flow/flow/getall/min").catch(() => []);
  const sel = h("select", {},
    h("option", { value: "" }, "select flow…"),
    flows.map((f) => h("option", { value: f.name, selected: f.name === flow ? "" : null }, f.name)));
  sel.addEventListener("change", () => (location.hash = `#/metrics/${sel.value}`));
  view.append(h("div", { class: "row" }, sel));
  if (!flow) return;

  const prefix = `DATAX-${flow}:`;

  /* firing-alert annotations: poll the alert engine's /alerts surface
     (obs/alerts.py) — a banner lists firing rules, and any tile/chart
     whose metric a firing rule watches gets the alerting outline */
  const alertBox = h("div", {});
  view.append(alertBox);

  /* latency percentile stat tiles (whole-batch p50/p95/p99, live from
     the engine's per-stage histograms) + per-stage p95 timechart */
  const pctlTiles = h("div", { class: "tiles" });
  const PCTLS = ["p50", "p95", "p99"];
  const pctlEls = {};
  for (const p of PCTLS) {
    const tile = h("div", { class: "tile" },
      h("div", { class: "k" }, `batch latency ${p}`),
      h("div", { class: "v" }, "–", h("span", { class: "u" }, "ms")));
    pctlTiles.append(tile);
    pctlEls[`Latency-Batch-${p}`] = $(".v", tile);
  }
  view.append(h("h2", {}, "Latency percentiles"), pctlTiles);

  /* autopilot tile (pilot/controller.py): the controller's live state —
     commanded pipeline depth, backpressure token balance, cumulative
     actuations — as a dedicated stat row so "is the pilot flying this
     job?" is one glance, not a hunt through the generic metric tiles */
  const PILOT_METRICS = [
    ["Pilot_Depth", "pilot depth"],
    ["Pilot_Backpressure_Tokens", "backpressure tokens"],
    ["Pilot_Actuations_Count", "pilot actuations"],
  ];
  const pilotTiles = h("div", { class: "tiles" });
  const pilotEls = {};
  for (const [metric, label] of PILOT_METRICS) {
    const tile = h("div", { class: "tile" },
      h("div", { class: "k" }, label),
      h("div", { class: "v" }, "–"));
    pilotTiles.append(tile);
    pilotEls[metric] = $(".v", tile);
  }
  const pilotSection = h("div", { style: "display:none" },
    h("h2", {}, "Autopilot"), pilotTiles);
  view.append(pilotSection);

  /* time-model tile row (PR 12 roofline conformance): live HBM
     watermark vs the DX2xx footprint, the DX520 device-step ratio
     against the calibrated roofline, and on-demand profiler captures —
     hidden until the host emits any of the series */
  const TIMEMODEL_METRICS = [
    ["Hbm_BytesInUse", "HBM in use (B)"],
    ["Hbm_PeakBytes", "HBM peak (B)"],
    ["Conformance_Hbm_Ratio", "HBM vs model"],
    ["Conformance_StageTime_DeviceStep_Ratio", "device-step vs roofline"],
    ["Calib_DispatchOverheadUs", "dispatch overhead (µs)"],
    ["Profiler_Captures_Count", "profiler captures"],
  ];
  const tmTiles = h("div", { class: "tiles" });
  const tmEls = {};
  for (const [metric, label] of TIMEMODEL_METRICS) {
    const tile = h("div", { class: "tile" },
      h("div", { class: "k" }, label),
      h("div", { class: "v" }, "–"));
    tmTiles.append(tile);
    tmEls[metric] = $(".v", tile);
  }
  const tmSection = h("div", { style: "display:none" },
    h("h2", {}, "Time model"), tmTiles);
  view.append(tmSection);
  const stageChartBox = h("div", {});
  view.append(stageChartBox);
  const STAGE_PCTL = "p95";
  const stageChart = multiChart(
    stageChartBox, `Per-stage latency ${STAGE_PCTL} (ms)`, STAGES);
  const stageKeyOf = {};  // metric -> stage
  for (const s of STAGES) stageKeyOf[`${stageMetric(s)}-${STAGE_PCTL}`] = s;

  const tiles = h("div", { class: "tiles" });
  const charts = h("div", {});
  view.append(h("h2", {}, "Engine metrics"), tiles, charts);

  const tileEls = {};   // metric -> value el
  const chartEls = {};  // metric -> chart handle
  const latest = {};

  const routePoint = (metric, point) => {
    /* percentile series feed the dedicated tiles/stage chart instead of
       spawning one generic chart per metric (24 series otherwise) */
    if (pctlEls[metric]) {
      pctlEls[metric].childNodes[0].textContent = fmtVal(point.val);
      return true;
    }
    if (pilotEls[metric]) {
      pilotSection.style.display = "";
      pilotEls[metric].textContent = fmtVal(point.val);
      return true;
    }
    if (tmEls[metric]) {
      tmSection.style.display = "";
      tmEls[metric].textContent = fmtVal(point.val);
      return true;
    }
    if (stageKeyOf[metric]) {
      stageChart.push(stageKeyOf[metric], point.uts, point.val);
      return true;
    }
    return LATENCY_PCTL_RE.test(metric);  // other pctls: tracked, unplotted
  };

  const ensure = async (metric) => {
    if (chartEls[metric]) return;
    const tile = h("div", { class: "tile" },
      h("div", { class: "k" }, metric),
      h("div", { class: "v" }, "–"));
    tiles.append(tile);
    tileEls[metric] = $(".v", tile);
    chartEls[metric] = lineChart(charts, metric);
    const history = await fetch(
      `/metrics/history?key=${encodeURIComponent(prefix + metric)}`).then((r) => r.json());
    chartEls[metric].seed(history.slice(-300));
  };

  const seedLatency = async (metric) => {
    const history = await fetch(
      `/metrics/history?key=${encodeURIComponent(prefix + metric)}`).then((r) => r.json());
    if (!history.length) return;
    if (stageKeyOf[metric]) {
      stageChart.seed(stageKeyOf[metric], history.slice(-300));
    }
    routePoint(metric, history[history.length - 1]);
  };

  const seedPilot = async (metric) => {
    const history = await fetch(
      `/metrics/history?key=${encodeURIComponent(prefix + metric)}`).then((r) => r.json());
    if (history.length) routePoint(metric, history[history.length - 1]);
  };

  const keys = await fetch(`/metrics/keys?prefix=${encodeURIComponent(prefix)}`)
    .then((r) => r.json());
  await Promise.all(keys.sort().map((k) => {
    const metric = k.slice(prefix.length);
    if (pilotEls[metric]) return seedPilot(metric);
    return LATENCY_PCTL_RE.test(metric) ? seedLatency(metric) : ensure(metric);
  }));

  const alertedMetrics = new Set();
  async function pollAlerts() {
    let payload;
    try {
      payload = await fetch(`/alerts?flow=${encodeURIComponent(flow)}`)
        .then((r) => (r.ok ? r.json() : null));
    } catch { return; }
    if (!payload) return;
    const firing = payload.firing || [];
    alertBox.replaceChildren();
    alertedMetrics.clear();
    if (firing.length) {
      alertBox.append(h("div", { class: "card alert-firing" },
        h("div", { class: "chart-title" },
          `⚠ ${firing.length} alert(s) firing`),
        firing.map((a) => h("div", { class: "alert-row" },
          h("span", { class: "mono" }, `${a.severity || "warn"}: ${a.name}`),
          ` — ${a.description || a.metric || ""}`))));
      for (const a of firing) if (a.metric) alertedMetrics.add(a.metric);
    }
    for (const [metric, el] of Object.entries(tileEls)) {
      const tile = el.closest(".tile");
      if (tile) tile.classList.toggle("alerting", alertedMetrics.has(metric));
    }
  }
  pollAlerts();
  const alertTimer = setInterval(pollAlerts, 5000);
  liveFeeds.push({ close: () => clearInterval(alertTimer) });

  const es = new EventSource(`/metrics/stream?prefix=${encodeURIComponent(prefix)}`);
  liveFeeds.push(es);
  es.addEventListener("datapoints", async (ev) => {
    const { key, member } = JSON.parse(ev.data);
    const metric = key.slice(prefix.length);
    let point;
    try { point = JSON.parse(member); } catch { return; }
    if (typeof point.val !== "number") return;
    if (routePoint(metric, point)) return;
    await ensure(metric);
    latest[metric] = point.val;
    tileEls[metric].textContent = fmtVal(point.val);
    chartEls[metric].push(point.uts, point.val);
  });
});

/* ---------------- jobs (datax-jobs) ---------------- */
route("#/jobs", async (view) => {
  view.append(h("h1", {}, "Jobs"));
  const jobs = await api("GET", "/api/flow/job/getall");
  const body = h("tbody", {}, jobs.map((j) => h("tr", {},
    h("td", { class: "mono" }, j.name),
    h("td", {}, h("span", { class: `status ${(j.state || "idle").toLowerCase()}` }, j.state || "idle")),
    h("td", {}, j.flow || ""),
    h("td", {},
      h("button", {
        class: "ghost", onclick: async () => {
          await api("POST", "/api/flow/flow/startjobs", { flowName: j.flow });
          toast("start requested"); render();
        },
      }, "start"), " ",
      h("button", {
        class: "ghost", onclick: async () => {
          await api("POST", "/api/flow/flow/stopjobs", { flowName: j.flow });
          toast("stop requested"); render();
        },
      }, "stop")))));
  view.append(h("table", { class: "grid" },
    h("thead", {}, h("tr", {},
      h("th", {}, "Job"), h("th", {}, "State"), h("th", {}, "Flow"), h("th", {}, "Actions"))),
    body));
  view.append(h("div", { class: "row" },
    h("button", {
      class: "ghost", onclick: async () => {
        await api("POST", "/api/flow/job/syncall", {});
        toast("synced"); render();
      },
    }, "Sync states")));
});

/* ---------------- fleet (cross-replica rollup) ---------------- */
route("#/fleet", async (view, hash) => {
  const flow = hash.split("/")[2];
  if (flow) return fleetFlowView(view, decodeURIComponent(flow));
  view.append(h("h1", {}, "Fleet"));
  let summary;
  try {
    summary = await api("GET", "/api/flow/fleet/metrics");
  } catch (e) {
    view.append(h("div", { class: "card" },
      "Fleet view unavailable — the control plane needs an object " +
      `store (objectstore=) to aggregate telemetry frames. (${e.message})`));
    return;
  }
  const flows = summary.flows || {};
  const names = Object.keys(flows).sort();
  if (!names.length) {
    view.append(h("div", { class: "card" },
      "No telemetry frames yet. Replica hosts publish one frame per " +
      "window once a flow with fleet publishing runs."));
  } else {
    view.append(h("table", { class: "grid" },
      h("thead", {}, h("tr", {},
        h("th", {}, "Flow"), h("th", {}, "Replicas"), h("th", {}, "Live"),
        h("th", {}, "Stale"), h("th", {}, "Completed"),
        h("th", {}, "Alerts"), h("th", {}, "Audit"))),
      h("tbody", {}, names.map((n) => {
        const f = flows[n];
        const statuses = Object.values(f.replicas || {}).map((r) => r.status);
        const count = (s) => statuses.filter((x) => x === s).length;
        const counts = (f.audit || {}).counts || {};
        const bad = Object.values(counts).some((c) => c > 0);
        return h("tr", {},
          h("td", {}, h("a", { href: `#/fleet/${encodeURIComponent(n)}` }, n)),
          h("td", {}, String(statuses.length)),
          h("td", {}, String(count("live"))),
          h("td", {}, String(count("stale"))),
          h("td", {}, String(count("completed"))),
          h("td", {}, String((f.alerts || []).length || 0)),
          h("td", {}, h("span", { class: bad ? "status failed" : "status running" },
            bad ? Object.entries(counts).filter(([, c]) => c > 0)
              .map(([code, c]) => `${code}×${c}`).join(" ") : "conserved")));
      }))));
  }
  view.append(h("div", { class: "row mono" },
    `frame decode errors: ${summary.decodeErrors ?? 0}`,
    ` · last merge: ${summary.mergeMs ?? 0} ms`));
});

async function fleetFlowView(view, flow) {
  view.append(h("h1", {}, `Fleet: ${flow}`));
  const f = await api("GET", `/api/flow/fleet/flows/${encodeURIComponent(flow)}`);
  const reps = f.replicas || {};
  view.append(h("h2", {}, "Replicas"));
  view.append(h("table", { class: "grid" },
    h("thead", {}, h("tr", {},
      h("th", {}, "Replica"), h("th", {}, "Status"), h("th", {}, "Frames"),
      h("th", {}, "Batches"), h("th", {}, "Windows"), h("th", {}, "Last seen"))),
    h("tbody", {}, Object.keys(reps).sort().map((name) => {
      const r = reps[name];
      const cls = { live: "running", completed: "idle", stale: "failed" }[r.status] || "idle";
      return h("tr", {},
        h("td", { class: "mono" }, name),
        h("td", {}, h("span", { class: `status ${cls}` }, r.status)),
        h("td", {}, String(r.frames ?? 0)),
        h("td", {}, String(r.batches ?? 0)),
        h("td", { class: "mono" }, (r.windows || []).join("–")),
        h("td", {}, r.lastSeenMs ? new Date(r.lastSeenMs).toLocaleTimeString() : "–"));
    }))));
  const hists = f.histograms || {};
  if (Object.keys(hists).length) {
    view.append(h("h2", {}, "Merged stage latency"));
    view.append(h("table", { class: "grid" },
      h("thead", {}, h("tr", {},
        h("th", {}, "Stage"), h("th", {}, "Count"),
        h("th", {}, "p50"), h("th", {}, "p95"), h("th", {}, "p99"))),
      h("tbody", {}, Object.keys(hists).sort().map((s) => h("tr", {},
        h("td", { class: "mono" }, s),
        h("td", {}, String(hists[s].count)),
        h("td", {}, `${hists[s].p50} ms`),
        h("td", {}, `${hists[s].p95} ms`),
        h("td", {}, `${hists[s].p99} ms`))))));
  }
  const lineage = f.lineage || [];
  if (lineage.length) {
    view.append(h("h2", {}, "Lineage"));
    view.append(h("div", { class: "card mono" }, lineage.map((l, i) =>
      h("div", {}, `${i ? "└→ " : ""}${l.replica}` +
        (l.status ? ` [${l.status}]` : l.state ? ` [${l.state}]` : "")))));
  }
  const audit = f.audit || {};
  view.append(h("h2", {}, "Delivery conservation"));
  view.append(h("div", { class: "card" },
    h("div", { class: "mono" }, `ingested: ${JSON.stringify(audit.ingested || {})}`),
    h("div", { class: "mono" }, `emitted: ${JSON.stringify(audit.emitted || {})}`),
    h("div", {}, audit.conserved
      ? h("span", { class: "status running" }, "conserved")
      : h("span", { class: "status failed" }, "NOT conserved")),
    (audit.events || []).map((e) => h("div", { class: "alert-row mono" },
      `${e.code}: ${e.name || ""} ${e.description || ""}`))));
  const firing = f.alerts || [];
  if (firing.length) {
    view.append(h("h2", {}, "Fleet alerts"));
    view.append(h("div", { class: "card alert-firing" },
      firing.map((a) => h("div", { class: "alert-row" },
        h("span", { class: "mono" }, `${a.severity || "warn"}: ${a.name}`),
        ` — ${a.description || a.metric || ""}`))));
  }
}

render();
