"""Single-file web dashboard (reference: python/ray/dashboard/client/).

The reference ships a built React frontend; here one self-contained HTML
page (no external assets — the cluster may have zero egress) polls the
dashboard's JSON APIs and renders live node / actor / placement-group /
job tables plus RPC handler timings. Served at ``/ui``.

Port of ``ray_tpu/cluster/dashboard_ui.py``: the same page.
"""

UI_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>ray_tpu dashboard</title>
<style>
  :root { color-scheme: light dark; }
  body { font-family: system-ui, sans-serif; margin: 0; padding: 0 1.2rem 2rem;
         background: Canvas; color: CanvasText; }
  h1 { font-size: 1.15rem; margin: 0.9rem 0 0.2rem; }
  h1 small { font-weight: normal; opacity: 0.65; font-size: 0.75rem; }
  h2 { font-size: 0.95rem; margin: 1.1rem 0 0.3rem; }
  table { border-collapse: collapse; width: 100%; font-size: 0.8rem; }
  th, td { text-align: left; padding: 0.22rem 0.55rem;
           border-bottom: 1px solid color-mix(in srgb, CanvasText 15%, Canvas); }
  th { opacity: 0.65; font-weight: 600; }
  .pill { display: inline-block; border-radius: 0.6rem; padding: 0 0.45rem;
          font-size: 0.72rem; }
  .ok { background: #1a7f3722; color: #1a7f37; }
  .bad { background: #d1242f22; color: #d1242f; }
  .mut { opacity: 0.6; }
  #summary { display: flex; gap: 1.6rem; flex-wrap: wrap; margin: 0.5rem 0; }
  #summary div { font-size: 0.8rem; }
  #summary b { display: block; font-size: 1.15rem; }
  #err { color: #d1242f; font-size: 0.8rem; }
</style>
</head>
<body>
<h1>ray_tpu cluster <small id="addr"></small></h1>
<div id="err"></div>
<div id="summary"></div>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Actors</h2><table id="actors"></table>
<h2>Placement groups</h2><table id="pgs"></table>
<h2>Jobs</h2><table id="jobs"></table>
<h2>RPC handlers (head)</h2><table id="rpc"></table>
<script>
const esc = (s) => String(s ?? "").replace(/[&<>]/g,
  (c) => ({"&": "&amp;", "<": "&lt;", ">": "&gt;"}[c]));
const pill = (ok, txt) =>
  `<span class="pill ${ok ? "ok" : "bad"}">${esc(txt)}</span>`;
function table(el, header, rows) {
  document.getElementById(el).innerHTML =
    "<tr>" + header.map((h) => `<th>${esc(h)}</th>`).join("") + "</tr>" +
    (rows.length
      ? rows.map((r) => "<tr>" + r.map((c) => `<td>${c}</td>`).join("") +
          "</tr>").join("")
      : `<tr><td class="mut" colspan="${header.length}">none</td></tr>`);
}
async function j(path) { const r = await fetch(path); return r.json(); }
async function tick() {
  try {
    const [status, nodes, actors, pgs, jobs, rpc] = await Promise.all([
      j("/api/cluster_status"), j("/api/nodes"), j("/api/actors"),
      j("/api/placement_groups"), j("/api/jobs"), j("/api/rpc_stats"),
    ]);
    document.getElementById("err").textContent = "";
    document.getElementById("addr").textContent = status.head_address || "";
    const s = status.leases || {};
    document.getElementById("summary").innerHTML = [
      ["nodes", (nodes || []).filter((n) => n.Alive).length +
        " / " + (nodes || []).length],
      ["actors", (actors || []).length],
      ["placement groups", (pgs || []).length],
      ["jobs", (jobs || []).length],
      ["pending leases", (s.pending ?? 0) + (s.infeasible ?? 0)],
      ["in flight", s.in_flight ?? 0],
    ].map(([k, v]) => `<div><b>${esc(v)}</b>${esc(k)}</div>`).join("");
    table("nodes", ["node", "alive", "address", "resources"],
      (nodes || []).map((n) => [
        esc((n.NodeID || "").slice(0, 12)), pill(n.Alive, n.Alive ? "alive" : "dead"),
        esc(n.Address || n.address || ""),
        esc(JSON.stringify(n.Resources || n.resources || {})),
      ]));
    table("actors", ["actor", "name", "class", "state", "node", "restarts"],
      (actors || []).map((a) => [
        esc((a.actor_id || "").slice(0, 12)), esc(a.name || ""),
        esc(a.class_name || ""), pill(a.state === "ALIVE", a.state),
        esc((a.node_id || "").slice(0, 12)), esc(a.num_restarts ?? 0),
      ]));
    table("pgs", ["pg", "strategy", "state", "bundles"],
      (pgs || []).map((p) => [
        esc((p.pg_id || p.id || "").slice(0, 12)), esc(p.strategy || ""),
        pill(p.state === "CREATED" || p.ready, p.state || (p.ready ? "ready" : "pending")),
        esc(JSON.stringify(p.bundles || [])),
      ]));
    table("jobs", ["job", "status", "entrypoint"],
      (jobs || []).map((jb) => [
        esc(jb.job_id || ""), pill(jb.status === "SUCCEEDED" ||
          jb.status === "RUNNING", jb.status || ""),
        esc(jb.entrypoint || ""),
      ]));
    const handlers = Object.entries(rpc.head || rpc || {})
      .sort((a, b) => (b[1].count || 0) - (a[1].count || 0)).slice(0, 20);
    table("rpc", ["handler", "calls", "mean ms", "max ms"],
      handlers.map(([name, h]) => [
        esc(name), esc(h.count ?? ""),
        esc(h.mean_ms != null ? h.mean_ms.toFixed(2) : ""),
        esc(h.max_ms != null ? h.max_ms.toFixed(2) : ""),
      ]));
  } catch (e) {
    document.getElementById("err").textContent = "refresh failed: " + e;
  }
}
tick();
setInterval(tick, 2000);
</script>
</body>
</html>
"""
