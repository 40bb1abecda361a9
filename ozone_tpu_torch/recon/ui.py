"""Recon web UI: a single static dashboard page over the REST API.

Port of `ozone_tpu/recon/ui.py` (the same page).

Role analog of the reference's bundled React UI (hadoop-ozone/recon
`webapps/recon` — overview cards, datanode table, container health); this
build serves one dependency-free HTML page from the Recon server itself,
rendering /api/summary + /api/filesizes + /api/history. Visual rules
follow the dataviz method: headline numbers are stat tiles (not charts),
node/container state uses the reserved status palette with an icon+label
(never color alone), the single file-size series is one hue with direct
labels and no legend, and light/dark are both selected palettes swapped
via CSS custom properties.
"""

RECON_INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>Recon &mdash; ozone-tpu</title>
<style>
  .viz-root {
    color-scheme: light;
    --surface-1: #fcfcfb;
    --surface-2: #f1f0ee;
    --text-primary: #0b0b0b;
    --text-secondary: #52514e;
    --series-1: #2a78d6;
    --status-good: #0ca30c;
    --status-warning: #fab219;
    --status-critical: #d03b3b;
    --border: #d8d7d3;
  }
  @media (prefers-color-scheme: dark) {
    :root:where(:not([data-theme="light"])) .viz-root {
      color-scheme: dark;
      --surface-1: #1a1a19;
      --surface-2: #242422;
      --text-primary: #ffffff;
      --text-secondary: #c3c2b7;
      --series-1: #3987e5;
      --border: #3a3937;
    }
  }
  :root[data-theme="dark"] .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19;
    --surface-2: #242422;
    --text-primary: #ffffff;
    --text-secondary: #c3c2b7;
    --series-1: #3987e5;
    --border: #3a3937;
  }
  body { margin: 0; }
  .viz-root {
    font: 14px/1.45 system-ui, sans-serif;
    background: var(--surface-1);
    color: var(--text-primary);
    min-height: 100vh;
    padding: 24px;
    box-sizing: border-box;
  }
  h1 { font-size: 18px; margin: 0 0 4px; }
  .sub { color: var(--text-secondary); margin-bottom: 20px; }
  h2 { font-size: 14px; margin: 28px 0 10px; }
  .tiles { display: flex; flex-wrap: wrap; gap: 12px; }
  .tile {
    background: var(--surface-2);
    border: 1px solid var(--border);
    border-radius: 8px;
    padding: 12px 18px;
    min-width: 120px;
  }
  .tile .v { font-size: 26px; font-weight: 600; }
  .tile .k { color: var(--text-secondary); font-size: 12px; }
  table { border-collapse: collapse; width: 100%; max-width: 880px; }
  th, td {
    text-align: left;
    padding: 6px 10px;
    border-bottom: 1px solid var(--border);
  }
  th { color: var(--text-secondary); font-weight: 500; font-size: 12px; }
  .badge {
    display: inline-flex;
    align-items: center;
    gap: 6px;
    font-size: 12px;
  }
  .dot { width: 8px; height: 8px; border-radius: 50%; }
  .bar-row { display: flex; align-items: center; gap: 8px; margin: 3px 0; }
  .bar-label {
    width: 110px;
    text-align: right;
    color: var(--text-secondary);
    font-size: 12px;
  }
  .bar {
    height: 14px;
    background: var(--series-1);
    border-radius: 0 4px 4px 0;
    min-width: 2px;
  }
  .bar-val { font-size: 12px; }
  .heat-grid {
    display: flex; flex-wrap: wrap; gap: 6px; max-width: 720px;
  }
  .heat-cell {
    border: 1px solid var(--border); border-radius: 6px;
    padding: 8px 10px; min-width: 120px;
    /* sequential single-hue scale via opacity over the series color;
       the text label carries the value, color is reinforcement only */
    position: relative; overflow: hidden;
  }
  .heat-fill {
    position: absolute; inset: 0; background: var(--series-1);
  }
  .heat-cell .lbl, .heat-cell .val { position: relative; }
  .heat-cell .lbl { font-size: 12px; color: var(--text-secondary); }
  .heat-cell .val { font-weight: 600; }
  .err { color: var(--status-critical); }
</style>
</head>
<body>
<div class="viz-root">
  <h1>Recon &mdash; ozone-tpu cluster observability</h1>
  <div class="sub" id="ts">loading&hellip;</div>

  <div class="tiles" id="tiles"></div>

  <h2>Datanodes</h2>
  <table id="nodes">
    <thead><tr><th>node</th><th>rack</th><th>state</th><th>op state</th>
      <th>used / capacity</th></tr></thead>
    <tbody></tbody>
  </table>

  <h2>Pipelines</h2>
  <table id="pipelines">
    <thead><tr><th>id</th><th>replication</th><th>state</th>
      <th>members</th></tr></thead>
    <tbody></tbody>
  </table>

  <h2>Container health</h2>
  <table id="health">
    <thead><tr><th>class</th><th>count</th></tr></thead>
    <tbody></tbody>
  </table>

  <h2>Namespace heat</h2>
  <div class="sub">bytes per bucket &mdash; darker is larger; each cell
    carries its own value</div>
  <div id="heat"></div>

  <h2>File sizes</h2>
  <div id="sizes"></div>
  <details><summary>table view</summary>
    <table id="sizes-table">
      <thead><tr><th>bucket</th><th>files</th></tr></thead>
      <tbody></tbody>
    </table>
  </details>

  <h2>Namespace du</h2>
  <div class="sub">recursive totals from the delta-fed NSSummary index;
    click a row to drill in</div>
  <div class="sub" id="du-path"></div>
  <table id="du">
    <thead><tr><th>path</th><th>total files</th><th>total bytes</th>
    </tr></thead>
    <tbody></tbody>
  </table>

  <h2>Growth</h2>
  <div class="sub">namespace keys and bytes over the warehouse history
    (newest right); the labels carry the current values</div>
  <div id="trend"></div>

  <h2>OM table insights</h2>
  <div class="tiles" id="insight-tiles"></div>
  <details><summary>open keys (oldest first)</summary>
    <table id="open-keys">
      <thead><tr><th>key</th><th>age (s)</th><th>hsync</th></tr></thead>
      <tbody></tbody>
    </table>
  </details>
  <details><summary>pending deletions (purge chain)</summary>
    <table id="deleted-keys">
      <thead><tr><th>entry</th><th>size</th><th>blocks</th>
        <th>pending (s)</th></tr></thead>
      <tbody></tbody>
    </table>
  </details>

  <h2>Lifecycle tiering</h2>
  <div class="sub">hot&rarr;warm sweeper (replicated&rarr;EC on device
    + TTL expiry): fencing term, sweep cursor, and live counters</div>
  <div class="tiles" id="lifecycle-tiles"></div>
  <table id="lifecycle-rules">
    <thead><tr><th>bucket</th><th>rule</th><th>prefix</th>
      <th>age (days)</th><th>action</th></tr></thead>
    <tbody></tbody>
  </table>

  <h2>Geo replication</h2>
  <div class="sub">cross-cluster async bucket replication (geo-DR):
    term-fenced WAL shipper &mdash; lag behind the metadata WAL head,
    shipped/conflict counters, per-bucket rules</div>
  <div class="tiles" id="geo-tiles"></div>
  <table id="geo-rules">
    <thead><tr><th>bucket</th><th>rule</th><th>prefix</th>
      <th>destination</th><th>scheme</th></tr></thead>
    <tbody></tbody>
  </table>

  <h2>Codec service</h2>
  <div class="sub">cross-request continuous batching: stripes from
    concurrent operations coalesced into shared fused device
    dispatches &mdash; fill ratio, queue depth, QoS/linger flushes</div>
  <div class="tiles" id="codec-tiles"></div>

  <h2>Mesh executor</h2>
  <div class="sub">persistent multi-chip datapath: long-lived SPMD
    programs fed depth-N in-flight batches &mdash; dispatch fill,
    coalescing across operations, spill absorption from the codec
    service</div>
  <div class="tiles" id="mesh-tiles"></div>

  <h2>Admission control</h2>
  <div class="sub">end-to-end overload protection: per-tenant token
    buckets, bounded request queues, SLO-driven shedding &mdash;
    per-hop, per-reason rejection counters (rejections climbing while
    goodput holds = healthy shed; everything falling together =
    collapse)</div>
  <div class="tiles" id="admission-tiles"></div>

  <h2>Small objects</h2>
  <div class="sub">tiny-object fast path: values inlined in OM
    metadata, needles packed into shared EC slabs, batched multi-key
    commits &mdash; slab census with dead-byte ratio (the compaction
    sweeper's backlog signal)</div>
  <div class="tiles" id="smallobj-tiles"></div>

  <h2>Shard map</h2>
  <div class="sub">sharded metadata plane: hash-partitioned OM rings
    behind an epoch-numbered root shard map &mdash; routing volume,
    moved-slot rejections, cross-shard 2PC outcomes, follower-read
    hit rate</div>
  <div class="tiles" id="shard-tiles"></div>
  <table id="shard-owners">
    <thead><tr><th>shard</th><th>slots owned</th><th>addresses</th>
      </tr></thead>
    <tbody></tbody>
  </table>

  <h2>Slow requests</h2>
  <div class="sub">flight recorder: traces retained past their per-op
    SLO &mdash; click a trace for its critical path (stage &rarr;
    &micro;s latency attribution)</div>
  <table id="slow-traces">
    <thead><tr><th>trace</th><th>op</th><th>duration</th>
      <th>SLO</th><th>spans</th></tr></thead>
    <tbody></tbody>
  </table>
  <div id="slow-detail"></div>

  <h2>Container &rarr; keys</h2>
  <div class="sub">which keys reference a container (the reference's
    ContainerKeyMapper view) &mdash; enter a container id</div>
  <div>
    <input id="ck-id" inputmode="numeric" placeholder="container id"
      style="padding:6px 8px;border:1px solid var(--border);
             border-radius:6px;background:var(--surface-2);
             color:var(--text-primary)">
    <button id="ck-go" style="padding:6px 12px;border:1px solid
      var(--border);border-radius:6px;background:var(--surface-2);
      color:var(--text-primary);cursor:pointer">look up</button>
  </div>
  <table id="ck">
    <thead><tr><th>container</th><th>keys</th></tr></thead>
    <tbody></tbody>
  </table>

  <h2>Unhealthy containers</h2>
  <table id="unhealthy">
    <thead><tr><th>container</th><th>states</th><th>replicas</th>
      <th>racks used/expected</th></tr></thead>
    <tbody></tbody>
  </table>
</div>
<script>
// state -> reserved status palette; always icon(dot)+label, never color alone
const STATE = {
  HEALTHY: ["var(--status-good)", "\\u2713"],
  STALE: ["var(--status-warning)", "\\u26a0"],
  DEAD: ["var(--status-critical)", "\\u2715"],
};
// every server-derived string goes through esc() before innerHTML —
// dn ids, racks, bucket labels etc. are external input to this page
function esc(s) {
  return String(s).replace(/[&<>"']/g, c => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;",
  }[c]));
}
function badge(state) {
  const [color, icon] = STATE[state] || ["var(--text-secondary)", "?"];
  return `<span class="badge"><span class="dot" style="background:${color}">` +
         `</span>${icon} ${esc(state)}</span>`;
}
function fmtBytes(n) {
  if (n == null) return "0 B";
  const units = ["B", "KiB", "MiB", "GiB", "TiB"];
  let i = 0;
  while (n >= 1024 && i < units.length - 1) { n /= 1024; i++; }
  return (i ? n.toFixed(1) : n) + " " + units[i];
}
function tile(k, v) {
  return `<div class="tile"><div class="v">${esc(v)}</div>` +
         `<div class="k">${esc(k)}</div></div>`;
}
async function refresh() {
  try {
    const s = await (await fetch("/api/summary")).json();
    document.getElementById("ts").textContent =
        "as of " + new Date(s.ts * 1000).toLocaleString();
    const ns = s.namespace || {};
    const tiles = [
      ["volumes", ns.volumes], ["buckets", ns.buckets],
      ["keys", ns.keys], ["bytes", fmtBytes(ns.bytes)],
      ["datanodes", (s.nodes || []).length],
    ];
    for (const [k, n] of Object.entries(s.containers || {}))
      tiles.push(["containers: " + k, n]);
    document.getElementById("tiles").innerHTML =
        tiles.map(([k, v]) => tile(k, v ?? 0)).join("");

    document.querySelector("#nodes tbody").innerHTML = (s.nodes || [])
      .map(n => `<tr><td>${esc(n.dn_id)}</td><td>${esc(n.rack ?? "")}</td>` +
                `<td>${badge(n.state)}</td><td>${esc(n.op_state ?? "")}</td>` +
                `<td>${fmtBytes(n.used_bytes)} / ` +
                `${fmtBytes(n.capacity_bytes)}</td></tr>`).join("");

    const pls = await (await fetch("/api/pipelines")).json();
    document.querySelector("#pipelines tbody").innerHTML = pls
      .map(p => `<tr><td>${esc(p.id)}</td><td>${esc(p.replication)}</td>` +
                `<td>${esc(p.state)}</td>` +
                `<td>${esc((p.nodes || []).join(", "))}</td></tr>`)
      .join("");

    document.querySelector("#health tbody").innerHTML =
        Object.entries(s.containers || {})
          .map(([k, v]) =>
            `<tr><td>${esc(k)}</td><td>${esc(v)}</td></tr>`).join("");

    const hm = await (await fetch("/api/heatmap")).json();
    const hcells = hm.cells || [];
    const hmax = Math.max(1, ...hcells.map(c => c.bytes));
    document.getElementById("heat").innerHTML =
      '<div class="heat-grid">' + hcells.map(c =>
        `<div class="heat-cell">` +
        `<div class="heat-fill" style="opacity:${
            (0.08 + 0.62 * c.bytes / hmax).toFixed(3)}"></div>` +
        `<div class="lbl">${esc(c.volume)}/${esc(c.bucket)}</div>` +
        `<div class="val">${fmtBytes(c.bytes)} &middot; ` +
        `${esc(c.keys)} keys</div></div>`).join("") + "</div>";

    const fs = await (await fetch("/api/filesizes")).json();
    const entries = Object.entries(fs);
    const max = Math.max(1, ...entries.map(([, v]) => v));
    document.getElementById("sizes").innerHTML = entries.map(([k, v]) =>
      `<div class="bar-row"><span class="bar-label">${esc(k)}</span>` +
      `<span class="bar" style="width:${(260 * v / max) | 0}px"></span>` +
      `<span class="bar-val">${esc(v)}</span></div>`).join("");
    document.querySelector("#sizes-table tbody").innerHTML = entries
      .map(([k, v]) =>
        `<tr><td>${esc(k)}</td><td>${esc(v)}</td></tr>`).join("");
    await refreshDu(duPath);
    const ti = await (await fetch("/api/insights/tables")).json();
    document.getElementById("insight-tiles").innerHTML =
      Object.entries(ti).filter(([, v]) => v > 0)
        .map(([k, v]) => tile(k, v)).join("") || tile("tables", "empty");
    const ok = await (await fetch("/api/insights/open_keys")).json();
    document.querySelector("#open-keys tbody").innerHTML = ok
      .map(r => `<tr><td>${esc(r.key)}</td><td>${esc(r.age_s)}</td>` +
                `<td>${r.hsync ? "yes" : ""}</td></tr>`).join("");
    // history needs the warehouse (a db_path'd Recon): skip the panel,
    // never abort the shared refresh, when it answers 404
    const hres = await fetch("/api/history/namespace");
    const hist = hres.ok ? await hres.json() : null;
    document.getElementById("trend").innerHTML = Array.isArray(hist)
      ? spark("keys", hist.map(h => h.keys ?? 0).reverse(), String) +
        spark("bytes", hist.map(h => h.bytes ?? 0).reverse(), fmtBytes)
      : '<span class="sub">no history warehouse</span>';
    const dk = await (await fetch("/api/insights/deleted_keys")).json();
    document.querySelector("#deleted-keys tbody").innerHTML = dk
      .map(r => `<tr><td>${esc(r.key)}</td><td>${fmtBytes(r.size)}</td>` +
                `<td>${esc(r.blocks)}</td><td>${esc(r.pending_s ?? "")}` +
                `</td></tr>`).join("") ||
      '<tr><td colspan="4">purge chain empty</td></tr>';
    const lc = await (await fetch("/api/lifecycle")).json();
    const lm = lc.metrics || {};
    document.getElementById("lifecycle-tiles").innerHTML = [
      tile("sweeper", lc.in_progress ? "sweeping"
                                     : (lc.term == null ? "idle (never "
                                        + "run)" : "idle")),
      tile("keys scanned", lm.keys_scanned ?? 0),
      tile("transitions", lm.transitions ?? 0),
      tile("bytes tiered", fmtBytes(lm.bytes_tiered ?? 0)),
      tile("expirations", lm.expirations ?? 0),
      tile("leader fences", lm.leader_fences ?? 0),
    ].join("");
    document.querySelector("#lifecycle-rules tbody").innerHTML =
      (lc.buckets || []).flatMap(b => (b.rules || []).map(r =>
        `<tr><td>${esc(b.bucket)}</td><td>${esc(r.id)}</td>` +
        `<td>${esc(r.prefix)}</td><td>${esc(r.age_days)}</td>` +
        `<td>${esc(r.action)}</td></tr>`)).join("") ||
      '<tr><td colspan="5">no lifecycle rules configured</td></tr>';
    const geo = await (await fetch("/api/replication")).json();
    const gm = geo.metrics || {};
    const glag = geo.lag || {};
    document.getElementById("geo-tiles").innerHTML = [
      tile("lag (entries)", glag.entries ?? 0),
      tile("lag (seconds)", glag.seconds ?? 0),
      tile("keys shipped", gm.keys_shipped ?? 0),
      tile("bytes shipped", fmtBytes(gm.bytes_shipped ?? 0)),
      tile("deletes shipped", gm.deletes_shipped ?? 0),
      tile("conflicts (LWW)", gm.conflicts ?? 0),
      tile("leader fences", gm.leader_fences ?? 0),
    ].join("");
    document.querySelector("#geo-rules tbody").innerHTML =
      (geo.buckets || []).flatMap(b => (b.rules || []).map(r =>
        `<tr><td>${esc(b.bucket)}</td><td>${esc(r.id)}</td>` +
        `<td>${esc(r.prefix)}</td><td>${esc(r.endpoint)}` +
        `${r.bucket ? "/" + esc(r.bucket) : ""}</td>` +
        `<td>${esc(r.scheme || "source")}</td></tr>`)).join("") ||
      '<tr><td colspan="5">no replication rules configured</td></tr>';
    const cx = await (await fetch("/api/codec")).json();
    document.getElementById("codec-tiles").innerHTML =
      cx.enabled === false
        ? tile("codec service", "disabled")
        : [
      tile("batch fill", `${Math.round((cx.fill_ratio ?? 0) * 100)}%`),
      tile("queue depth", cx.queue_depth ?? 0),
      tile("dispatches", cx.dispatches ?? 0),
      tile("ops/dispatch",
           (cx.ops_per_dispatch ?? 0).toFixed(2)),
      tile("multi-op dispatches", cx.multi_op_dispatches ?? 0),
      tile("linger flushes", cx.forced_flushes ?? 0),
      tile("deadline flushes", cx.deadline_flushes ?? 0),
      tile("tail flushes", cx.tail_flushes ?? 0),
      tile("starvation trips", cx.starvation_guard_trips ?? 0),
    ].join("");
    const mx = await (await fetch("/api/mesh")).json();
    document.getElementById("mesh-tiles").innerHTML =
      mx.enabled === false
        ? tile("mesh executor", "disabled")
        : mx.started === false
        ? [
      tile("mesh executor", "idle"),
      tile("spill", mx.spill_enabled ? "on" : "off"),
    ].join("")
        : [
      tile("devices", mx.devices ?? 0),
      tile("mode", (mx.programs_host_twin ?? 0) > 0
           && mx.programs_host_twin === mx.programs
           ? "host twin" : "device"),
      tile("batch fill", `${Math.round((mx.fill_ratio ?? 0) * 100)}%`),
      tile("queue depth", mx.queue_depth ?? 0),
      tile("dispatches", mx.dispatches ?? 0),
      tile("ops/dispatch", (mx.ops_per_dispatch ?? 0).toFixed(2)),
      tile("in-flight", `${mx.inflight ?? 0}/${mx.mesh_depth ?? 0}`),
      tile("max in-flight", mx.max_inflight ?? 0),
      tile("programs", mx.programs ?? 0),
      tile("spilled lanes", mx.spilled_lanes ?? 0),
      tile("spilled stripes", mx.spilled_stripes ?? 0),
      tile("spill", mx.spill_enabled ? "on" : "off"),
    ].join("");
    const ad = await (await fetch("/api/admission")).json();
    const ac = ad.counters || {};
    const hops = Object.values(ad.hops || {});
    document.getElementById("admission-tiles").innerHTML =
      hops.length === 0
        ? tile("admission", "no controllers installed")
        : [
      tile("enabled hops",
           hops.filter((h) => h.enabled).map((h) => h.hop)
               .join(" ") || "none"),
      tile("in-flight", hops.map(
           (h) => `${h.hop}:${h.inflight}/${h.queue_limit}`)
           .join(" ")),
      ...Object.entries(ac)
        .filter(([k]) => k.endsWith("_rejected_total")
                         || k.endsWith("_tenant_rejections"))
        .map(([k, v]) => tile(k.replace(/_/g, " "), v)),
      tile("tenants seen",
           hops.reduce((n, h) => n + (h.tenants?.length ?? 0), 0)),
    ].join("");
    const so = await (await fetch("/api/smallobj")).json();
    const soc = so.counters || {};
    const sos = so.slabs || {};
    document.getElementById("smallobj-tiles").innerHTML = [
      tile("inline puts", soc.inline_puts ?? 0),
      tile("inline gets", soc.inline_gets ?? 0),
      tile("needles packed", soc.needles_packed ?? 0),
      tile("needle gets", soc.needle_gets ?? 0),
      tile("slabs flushed", soc.slabs_flushed ?? 0),
      tile("commit batches", soc.commit_batches ?? 0),
      tile("live slabs", sos.count ?? 0),
      tile("dead bytes", sos.dead_bytes ?? 0),
      tile("worst dead ratio",
           `${Math.round((sos.worst_dead_ratio ?? 0) * 100)}%`),
      tile("compacted slabs", soc.compaction_slabs ?? 0),
      tile("compaction bytes", soc.compaction_bytes ?? 0),
      tile("inline max", so.knobs?.inline_max ?? 0),
      tile("needle max", so.knobs?.needle_max ?? 0),
    ].join("");
    const sh = await (await fetch("/api/shards")).json();
    const sc = sh.counters || {};
    const frTotal = (sc.follower_read_hits ?? 0) +
                    (sc.follower_read_misses ?? 0);
    document.getElementById("shard-tiles").innerHTML =
      sh.sharded === false
        ? tile("shard plane", "unsharded")
        : [
      tile("map epoch", sh.map?.epoch ?? sh.config?.epoch ?? 0),
      tile("slots", sh.map?.slot_count ?? sh.config?.slot_count ?? 0),
      tile("owned here", sh.config?.owned_slots ?? 0),
      tile("routes", sc.routes ?? 0),
      tile("moved rejections", sc.moved_rejections ?? 0),
      tile("2PC prepares", sc.cross_shard_prepares ?? 0),
      tile("2PC commits", sc.cross_shard_commits ?? 0),
      tile("2PC aborts", sc.cross_shard_aborts ?? 0),
      tile("follower-read hit", frTotal
           ? `${Math.round(100 * (sc.follower_read_hits ?? 0)
                           / frTotal)}%` : "n/a"),
      tile("lease renewals", sc.lease_renewals ?? 0),
    ].join("");
    document.querySelector("#shard-owners tbody").innerHTML =
      Object.entries(sh.map?.slots_per_shard || {})
        .map(([sid, n]) =>
          `<tr><td>${esc(sid)}</td><td>${esc(n)}</td>` +
          `<td>${esc((sh.map?.addresses || {})[sid] || "")}</td></tr>`)
        .join("") ||
      '<tr><td colspan="3">no root shard map on this OM</td></tr>';
    const sl = await (await fetch("/api/traces/slow")).json();
    document.querySelector("#slow-traces tbody").innerHTML =
      (sl.traces || []).map(t =>
        `<tr><td><a href="#" onclick="showTrace('${esc(t.traceId)}');` +
        `return false">${esc(t.traceId)}</a></td>` +
        `<td>${esc(t.root)}</td>` +
        `<td>${(t.durationMs ?? 0).toFixed(1)} ms</td>` +
        `<td>${(t.sloMs ?? 0).toFixed(0)} ms</td>` +
        `<td>${esc(t.spans)}</td></tr>`).join("") ||
      '<tr><td colspan="5">no traces over SLO retained</td></tr>';
    const uh = await (await fetch("/api/containers/unhealthy")).json();
    document.querySelector("#unhealthy tbody").innerHTML = uh
      .map(r => `<tr><td>${esc(r.container)}</td>` +
                `<td>${esc((r.states || []).join(", "))}</td>` +
                `<td>${esc(r.actual)}/${esc(r.expected)}</td>` +
                `<td>${esc(r.racks_used)}/${esc(r.racks_expected)}` +
                `</td></tr>`).join("") ||
      '<tr><td colspan="4">all containers healthy</td></tr>';
  } catch (e) {
    const ts = document.getElementById("ts");
    ts.innerHTML = '<span class="err"></span>';
    ts.firstChild.textContent = "failed to load: " + e;
  }
}
// one-hue inline-SVG sparkline with a direct label (no axes/legend:
// it shows shape; the label carries the current value)
function spark(label, vals, fmt) {
  if (!vals.length) vals = [0];
  const w = 220, h = 36, max = Math.max(1, ...vals);
  const step = vals.length > 1 ? w / (vals.length - 1) : 0;
  const pts = vals.map((v, i) =>
      `${(i * step).toFixed(1)},${(h - 2 - (h - 6) * v / max).toFixed(1)}`)
    .join(" ");
  return `<div class="bar-row"><span class="bar-label">${esc(label)}` +
    `</span><svg width="${w}" height="${h}" role="img" ` +
    `aria-label="${esc(label)} trend">` +
    `<polyline points="${pts}" fill="none" ` +
    `stroke="var(--series-1)" stroke-width="1.5"/></svg>` +
    `<span class="bar-val">${esc(fmt(vals[vals.length - 1]))}</span></div>`;
}
// container -> keys lookup (ContainerKeyMapper view)
async function lookupContainer() {
  const id = document.getElementById("ck-id").value.trim();
  if (!id) {  // the unfiltered map is every key of every container
    document.querySelector("#ck tbody").innerHTML =
      '<tr><td colspan="2">enter a container id first</td></tr>';
    return;
  }
  const res = await fetch("/api/containers/keys?id=" +
      encodeURIComponent(id));
  const m = res.ok ? await res.json() : {};
  document.querySelector("#ck tbody").innerHTML =
    Object.entries(m).map(([cid, keys]) =>
      `<tr><td>${esc(cid)}</td><td>${esc((keys || []).join(", "))}` +
      `</td></tr>`).join("") ||
    '<tr><td colspan="2">no keys reference it</td></tr>';
}
document.getElementById("ck-go").onclick = lookupContainer;
// slow-trace drill-down: the critical path is the answer to "where
// did this request spend its time" — render it as a stage table
async function showTrace(id) {
  const res = await fetch("/api/traces/slow?id=" +
      encodeURIComponent(id));
  const t = res.ok ? await res.json() : {};
  const cp = t.criticalPath || [];
  const total = cp.reduce((a, s) => a + s.micros, 0) || 1;
  document.getElementById("slow-detail").innerHTML =
    `<div class="sub">trace ${esc(id)} &mdash; ` +
    `${esc(t.root || "?")} ${(t.durationMs ?? 0).toFixed(1)} ms, ` +
    `${(t.spans || []).length} spans</div>` +
    '<table><thead><tr><th>stage</th><th>&micro;s</th><th>share</th>' +
    "</tr></thead><tbody>" +
    (cp.map(s =>
      `<tr><td>${esc(s.stage)}</td><td>${esc(s.micros)}</td>` +
      `<td>${(100 * s.micros / total).toFixed(1)}%</td></tr>`)
      .join("") ||
     '<tr><td colspan="3">trace no longer retained</td></tr>') +
    "</tbody></table>";
}
// du drill-down: click rows to descend, the header crumb to reset
let duPath = "/";
async function refreshDu(p) {
  const res = await fetch(
      "/api/nssummary?path=" + encodeURIComponent(p));
  if (p !== duPath) return;  // a newer navigation superseded this one
  if (!res.ok) {
    // the path vanished (bucket/dir deleted): reset to the root view
    // instead of rendering a dead path as an empty-but-healthy du
    if (p !== "/") { duPath = "/"; return refreshDu("/"); }
    document.getElementById("du-path").textContent =
        "du unavailable (" + res.status + ")";
    return;
  }
  const du = await res.json();
  if (p !== duPath) return;
  const crumb = document.getElementById("du-path");
  crumb.innerHTML = `<a href="#" id="du-root">/</a> ${esc(p)} &mdash; ` +
      `${esc(du.total_files ?? 0)} files, ` +
      `${fmtBytes(du.total_bytes ?? 0)}`;
  crumb.querySelector("#du-root").onclick =
      () => { duPath = "/"; refreshDu("/"); return false; };
  const rows = (du.children || []);
  document.querySelector("#du tbody").innerHTML = rows.map(c =>
    `<tr data-p="${esc(c.path)}" style="cursor:pointer">` +
    `<td>${esc(c.path)}</td><td>${esc(c.total_files)}</td>` +
    `<td>${fmtBytes(c.total_bytes)}</td></tr>`).join("") ||
    '<tr><td colspan="3">no children</td></tr>';
  for (const tr of document.querySelectorAll("#du tbody tr[data-p]"))
    tr.onclick = () => { duPath = tr.dataset.p; refreshDu(duPath); };
}
refresh();
setInterval(refresh, 10000);
</script>
</body>
</html>
"""
