"""Benchmark result plotting (copy of expann_tpu/pyplotter.py).

Counterpart of the reference's Dash dashboard (reference:
src/pyplotter.py): an interactive recall-vs-QPS scatter over the
``data/<ds_name>/data/{all,latest}.json`` result files, with any metric or
engine param on either axis and the same transforms (time_per_query_ns ->
QPS = 1e9/x, time_to_build_ns -> seconds).

The module provides:
  * ``prepare_data`` — the same record->points transform, importable and
    tested,
  * a matplotlib static-plot CLI:
      python -m expann_tpu_torch.pyplotter [--config config.json] [--file all.json]
          [--x recall --y time_per_query_ns] [--out plot.png]
  * ``serve_dashboard()`` / ``--serve`` — an interactive app with
    metric/param axis dropdowns and hover annotations: the Dash app when
    dash/plotly are importable, else a zero-dependency ``http.server``
    fallback with an inline-SVG scatter (same data pipeline, live re-read
    per request; ``make_stdlib_dashboard``, served + tested in-image).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

AXIS_LABELS = {
    "recall": "Recall",
    "time_per_query_ns": "Queries per Second",
    "average_distance": "Average Distance",
    "average_squared_distance": "Average Squared Distance",
    "time_to_build_ns": "Time to Build (s)",
}


def transform_value(axis: str, value):
    """Reference's axis transforms (src/pyplotter.py:41-49)."""
    value = float(value)
    if axis == "time_to_build_ns":
        return value / 1e9
    if axis == "time_per_query_ns":
        return 1e9 / value if value != 0 else 0.0
    return value


def prepare_data(
    records: List[dict], x_axis: str, y_axis: str,
    use_param_x: bool = False, use_param_y: bool = False,
) -> Dict[str, list]:
    """Turn bench_data records into plot columns {x, y, annotations,
    engine}, mirroring the reference's prepare_data."""
    out = {"x": [], "y": [], "annotations": [], "engine": []}
    for bd in records:
        params = bd.get("param_list", {})
        if use_param_x and x_axis not in params:
            continue
        if use_param_y and y_axis not in params:
            continue
        xv = params.get(x_axis, 0) if use_param_x else bd.get(x_axis, 0)
        yv = params.get(y_axis, 0) if use_param_y else bd.get(y_axis, 0)
        out["x"].append(transform_value(x_axis, xv) if not use_param_x else float(xv))
        out["y"].append(transform_value(y_axis, yv) if not use_param_y else float(yv))
        ann = "Statistics:\n" + "\n".join(
            f"{k}: {v}" for k, v in bd.items() if k != "param_list"
        )
        ann += "\n\nParam List:\n" + "\n".join(
            f"{k}: {v}" for k, v in params.items()
        )
        out["annotations"].append(ann)
        out["engine"].append(bd.get("engine_name", "?"))
    return out


def load_records(data_folder: str, file_name: str) -> List[dict]:
    with open(os.path.join(data_folder, file_name)) as f:
        return json.load(f)


def static_plot(
    records: List[dict], x_axis: str, y_axis: str, out_path: str,
    use_param_x: bool = False, use_param_y: bool = False,
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = prepare_data(records, x_axis, y_axis, use_param_x, use_param_y)
    fig, ax = plt.subplots(figsize=(9, 6))
    engines = sorted(set(data["engine"]))
    for eng in engines:
        xs = [x for x, e in zip(data["x"], data["engine"]) if e == eng]
        ys = [y for y, e in zip(data["y"], data["engine"]) if e == eng]
        ax.scatter(xs, ys, label=eng, alpha=0.75)
    ax.set_xlabel(AXIS_LABELS.get(x_axis, x_axis))
    ax.set_ylabel(AXIS_LABELS.get(y_axis, y_axis))
    if y_axis == "time_per_query_ns":
        ax.set_yscale("log")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


_DASH_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>expann-tpu plots</title>
<style>
 body { font-family: sans-serif; margin: 1em; }
 select { margin-right: 1em; }
 #hover { white-space: pre; font-family: monospace; font-size: 12px;
          border: 1px solid #aaa; padding: 6px; min-height: 14em;
          margin-top: 0.5em; background: #fafafa; }
 circle { cursor: pointer; }
</style></head><body>
<h3>expann-tpu benchmark dashboard</h3>
<div>
 <label>file <select id="file"></select></label>
 <label>x <select id="x"></select></label>
 <label>y <select id="y"></select></label>
</div>
<svg id="plot" width="860" height="520"></svg>
<div id="hover">hover a point for Statistics / Param List</div>
<script>
const AXES = __AXES__;
const FILES = ["all.json", "latest.json"];
function fill(id, opts, val) {
  const s = document.getElementById(id);
  for (const [v, l] of opts) {
    const o = document.createElement("option");
    o.value = v; o.textContent = l; s.appendChild(o);
  }
  s.value = val; s.onchange = refresh;
}
const COLORS = ["#1f77b4","#ff7f0e","#2ca02c","#d62728","#9467bd","#8c564b"];
async function refresh() {
  const f = document.getElementById("file").value;
  const x = document.getElementById("x").value;
  const y = document.getElementById("y").value;
  const r = await fetch(`/data?file=${f}&x=${x}&y=${y}`);
  const d = await r.json();
  const svg = document.getElementById("plot");
  svg.innerHTML = "";
  const W = 860, H = 520, L = 70, B = 40, T = 15, R = 15;
  const logY = (y === "time_per_query_ns");
  const ys = d.y.map(v => logY ? Math.log10(Math.max(v, 1e-12)) : v);
  if (!d.x.length) return;
  const [x0, x1] = [Math.min(...d.x), Math.max(...d.x)];
  const [y0, y1] = [Math.min(...ys), Math.max(...ys)];
  const sx = v => L + (x1 > x0 ? (v - x0) / (x1 - x0) : 0.5) * (W - L - R);
  const sy = v => H - B - (y1 > y0 ? (v - y0) / (y1 - y0) : 0.5) * (H - B - T);
  const engines = [...new Set(d.engine)];
  const ns = "http://www.w3.org/2000/svg";
  for (let i = 0; i < d.x.length; i++) {
    const c = document.createElementNS(ns, "circle");
    c.setAttribute("cx", sx(d.x[i])); c.setAttribute("cy", sy(ys[i]));
    c.setAttribute("r", 5);
    c.setAttribute("fill", COLORS[engines.indexOf(d.engine[i]) % COLORS.length]);
    c.setAttribute("fill-opacity", "0.75");
    const ann = d.annotations[i];
    c.onmouseover = () => document.getElementById("hover").textContent = ann;
    svg.appendChild(c);
  }
  const lbl = (tx, ty, t, rot) => {
    const e = document.createElementNS(ns, "text");
    e.setAttribute("x", tx); e.setAttribute("y", ty);
    e.setAttribute("font-size", "13"); e.setAttribute("text-anchor", "middle");
    if (rot) e.setAttribute("transform", `rotate(-90 ${tx} ${ty})`);
    e.textContent = t; svg.appendChild(e);
  };
  lbl((L + W - R) / 2, H - 8, AXES[x] || x, false);
  lbl(16, (T + H - B) / 2, (AXES[y] || y) + (logY ? " (log)" : ""), true);
}
fill("file", FILES.map(f => [f, f]), "all.json");
fill("x", Object.entries(AXES), "recall");
fill("y", Object.entries(AXES), "time_per_query_ns");
refresh();
</script></body></html>
"""


def make_stdlib_dashboard(data_folder: str):
    """Zero-dependency interactive dashboard: the same live record->points
    pipeline as the Dash app (axis dropdowns, hover Statistics/Param List
    block, log-QPS axis) served by ``http.server`` with an inline-SVG
    scatter.  Covers the reference dashboard's workflow
    (reference: src/pyplotter.py) on hosts without dash/plotly.

    Returns an ``http.server.ThreadingHTTPServer``; call
    ``serve_forever()`` (or ``handle_request()`` in tests).
    """
    import http.server
    import urllib.parse

    page = _DASH_HTML.replace("__AXES__", json.dumps(AXIS_LABELS))

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urllib.parse.urlparse(self.path)
            if url.path == "/":
                return self._send(page.encode(), "text/html")
            if url.path == "/data":
                q = urllib.parse.parse_qs(url.query)
                fname = q.get("file", ["all.json"])[0]
                if fname not in ("all.json", "latest.json"):
                    self.send_error(400, "bad file")
                    return
                try:
                    recs = load_records(data_folder, fname)
                except OSError:
                    recs = []
                data = prepare_data(
                    recs,
                    q.get("x", ["recall"])[0],
                    q.get("y", ["time_per_query_ns"])[0],
                    use_param_x=q.get("px", ["0"])[0] == "1",
                    use_param_y=q.get("py", ["0"])[0] == "1",
                )
                return self._send(
                    json.dumps(data).encode(), "application/json"
                )
            self.send_error(404)

    return http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)


def serve_dashboard(data_folder: str, k_value: int = 10):
    """Interactive dashboard. Prefers the Dash app when dash/plotly are
    installed; otherwise serves the stdlib fallback (same data pipeline,
    dropdowns, and hover annotations)."""
    try:
        import dash  # noqa: F401
    except ImportError:
        srv = make_stdlib_dashboard(data_folder)
        print(f"dash not installed; stdlib dashboard at "
              f"http://127.0.0.1:{srv.server_address[1]}/")
        srv.serve_forever()
        return
    _serve_dash_app(data_folder, k_value)


def _serve_dash_app(data_folder: str, k_value: int = 10):  # pragma: no cover
    """Interactive Dash app, available only when dash/plotly are installed
    (they are not in this image; the stdlib fallback above is the default)."""
    import dash
    from dash import dcc, html
    from dash.dependencies import Input, Output
    import plotly.graph_objs as go

    app = dash.Dash(__name__)
    app.title = "expann-tpu plots"
    metric_opts = [{"label": v, "value": k} for k, v in AXIS_LABELS.items()]

    app.layout = html.Div(
        [
            dcc.Dropdown(id="file", options=[
                {"label": f, "value": f} for f in ("all.json", "latest.json")
            ], value="all.json"),
            dcc.Dropdown(id="x-axis", options=metric_opts, value="recall"),
            dcc.Dropdown(id="y-axis", options=metric_opts, value="time_per_query_ns"),
            dcc.Graph(id="scatter"),
        ]
    )

    @app.callback(
        Output("scatter", "figure"),
        [Input("file", "value"), Input("x-axis", "value"), Input("y-axis", "value")],
    )
    def update(file_name, x_axis, y_axis):
        data = prepare_data(load_records(data_folder, file_name), x_axis, y_axis)
        return {
            "data": [
                go.Scatter(
                    x=data["x"], y=data["y"], mode="markers",
                    text=data["annotations"], hoverinfo="text",
                )
            ],
            "layout": go.Layout(
                xaxis={"title": AXIS_LABELS.get(x_axis, x_axis)},
                yaxis={"title": AXIS_LABELS.get(y_axis, y_axis), "type": "log"},
            ),
        }

    app.run(debug=False)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="config.json")
    p.add_argument("--file", default="all.json")
    p.add_argument("--x", default="recall")
    p.add_argument("--y", default="time_per_query_ns")
    p.add_argument("--param-x", action="store_true")
    p.add_argument("--param-y", action="store_true")
    p.add_argument("--out", default="plot.png")
    p.add_argument("--serve", action="store_true", help="launch Dash app if available")
    args = p.parse_args(argv)

    with open(args.config) as f:
        config = json.load(f)
    data_folder = f"./data/{config['ds_name']}/data/"

    if args.serve:
        serve_dashboard(data_folder, config.get("k", 10))
        return 0

    records = load_records(data_folder, args.file)
    static_plot(records, args.x, args.y, args.out, args.param_x, args.param_y)
    print(f"wrote {args.out} ({len(records)} records)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
