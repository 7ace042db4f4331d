"""Interactive dataset explorer (port of bin/dash_explorer; role of
reference bin/dash_explorer):

    python -m plant3dvision_tpu_torch.tools.dash_explorer <db>/<scan> \\
        [--out explorer.html] [--max-points 40000] \\
        [--serve [--host 127.0.0.1] [--port 8050]]

Two modes:

- default: writes a SELF-CONTAINED interactive HTML file — a vanilla-JS
  canvas 3D viewer (drag to orbit, wheel to zoom) over the embedded point
  cloud + skeleton, an angle/internode chart, per-image thumbnails, and
  scan stats. Needs no server or extra packages, opens anywhere.
- ``--serve``: runs the reference-style Dash/Plotly web app (tabs for point
  cloud, mesh, tree graph and trait sequences built from
  visu_plotly trace specs). Requires dash + plotly; without them the
  mode exits with code 2 and a message, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
from io import BytesIO
from pathlib import Path

import numpy as np

from ..fsdb import FSDB, io
from ..runtime.cli import parse_dataset
from ..utils import locate_task_filesets

MAX_POINTS = 40000
MAX_THUMBS = 12

PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>plant3dvision explorer — {scan_id}</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 0; background: #111;
        color: #ddd; }}
 header {{ padding: 10px 16px; background: #1b1b1b; }}
 h1 {{ font-size: 18px; margin: 0; }}
 .row {{ display: flex; flex-wrap: wrap; gap: 12px; padding: 12px; }}
 .card {{ background: #1b1b1b; border-radius: 8px; padding: 10px; }}
 canvas {{ background: #0c0c0c; border-radius: 6px; }}
 .thumbs img {{ height: 110px; margin: 2px; border-radius: 4px; }}
 .hint {{ color: #888; font-size: 12px; }}
 table {{ font-size: 13px; border-collapse: collapse; }}
 td {{ padding: 2px 10px 2px 0; }}
</style></head><body>
<header><h1>Scan: {scan_id}</h1><span class="hint">{summary}</span></header>
<div class="row">
 <div class="card"><b>3D view</b> <span class="hint">drag = orbit,
  wheel = zoom, s = toggle skeleton, p = toggle points</span><br>
  <canvas id="view" width="760" height="640"></canvas></div>
 <div class="card"><b>Angles / internodes</b><br>
  <canvas id="seq" width="520" height="300"></canvas>
  <table id="stats">{stats_rows}</table></div>
</div>
<div class="row"><div class="card thumbs"><b>Images</b><br>{thumbs}</div></div>
<script>
const DATA = {data_json};
// ---------- 3D viewer ----------
const cv = document.getElementById('view'), ctx = cv.getContext('2d');
let pts = DATA.points, cols = DATA.colors, skel = DATA.skeleton;
let yaw = 0.7, pitch = -0.4, zoom = 1.0, showSk = true, showPts = true;
let center = [0,0,0], scale = 1;
if (pts.length) {{
  let mn=[1e9,1e9,1e9], mx=[-1e9,-1e9,-1e9];
  for (const p of pts) for (let i=0;i<3;i++) {{
    mn[i]=Math.min(mn[i],p[i]); mx[i]=Math.max(mx[i],p[i]); }}
  center = [(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
  scale = 500/Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1e-9);
}}
function proj(p) {{
  const x=p[0]-center[0], y=p[1]-center[1], z=p[2]-center[2];
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch),
        sp=Math.sin(pitch);
  const x1=cy*x+sy*y, y1=-sy*x+cy*y;
  const y2=cp*y1-sp*z, z2=sp*y1+cp*z;
  return [cv.width/2+x1*scale*zoom, cv.height/2-z2*scale*zoom, y2];
}}
function draw() {{
  ctx.clearRect(0,0,cv.width,cv.height);
  if (showPts) {{
    const order=[];
    for (let i=0;i<pts.length;i++) order.push(i);
    const prj = pts.map(proj);
    order.sort((a,b)=>prj[a][2]-prj[b][2]);
    for (const i of order) {{
      const q=prj[i];
      ctx.fillStyle=cols[i];
      ctx.fillRect(q[0],q[1],2,2);
    }}
  }}
  if (showSk && skel.points.length) {{
    ctx.strokeStyle='#ff5050'; ctx.lineWidth=1.6;
    for (const ln of skel.lines) {{
      const a=proj(skel.points[ln[0]]), b=proj(skel.points[ln[1]]);
      ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);
      ctx.stroke();
    }}
  }}
}}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{{ if(!drag) return;
  yaw+=(e.clientX-drag[0])*0.008; pitch+=(e.clientY-drag[1])*0.008;
  pitch=Math.max(-1.55,Math.min(1.55,pitch)); drag=[e.clientX,e.clientY];
  requestAnimationFrame(draw); }};
cv.onwheel=e=>{{ e.preventDefault();
  zoom*=Math.exp(-e.deltaY*0.001); requestAnimationFrame(draw); }};
window.onkeydown=e=>{{ if(e.key=='s') showSk=!showSk;
  if(e.key=='p') showPts=!showPts; draw(); }};
draw();
// ---------- sequence chart ----------
const sc=document.getElementById('seq'), c2=sc.getContext('2d');
const ang=DATA.angles, inter=DATA.internodes, gt=DATA.gt_angles;
if (ang.length) {{
  const n=ang.length, w=sc.width-50, h=120, bw=Math.max(2, w/n-2);
  c2.fillStyle='#888'; c2.fillText('divergence angle (deg)', 50, 12);
  for (let i=0;i<n;i++) {{
    c2.fillStyle='#4da3ff';
    const v=Math.min(ang[i],360);
    c2.fillRect(50+i*(w/n), 20+h-v/360*h, bw, v/360*h);
  }}
  if (gt && gt.length) {{
    c2.strokeStyle='#ffd24d';
    for (let i=0;i<gt.length;i++) {{
      const v=Math.min(gt[i],360), y=20+h-v/360*h;
      c2.beginPath(); c2.moveTo(50+i*(w/n), y);
      c2.lineTo(50+i*(w/n)+bw, y); c2.stroke();
    }}
  }}
  c2.fillStyle='#888'; c2.fillText('internode (mm)', 50, h+48);
  const mi=Math.max(...inter,1);
  for (let i=0;i<inter.length;i++) {{
    c2.fillStyle='#6fdc8c';
    const v=inter[i]/mi*100;
    c2.fillRect(50+i*(w/n), 56+h+100-v, bw, v);
  }}
}}
</script></body></html>
"""


def _height_colors(pts):
    z = pts[:, 2]
    t = (z - z.min()) / max(z.max() - z.min(), 1e-9)
    cols = []
    for v in t:
        r = int(60 + 160 * v)
        g = int(200 - 90 * v)
        b = int(90 + 120 * (1 - v))
        cols.append(f"rgb({r},{g},{b})")
    return cols


LABEL_COLORS = {"stem": "rgb(120,220,120)", "fruit": "rgb(255,180,60)",
                "leaf": "rgb(60,200,60)", "pedicel": "rgb(120,160,255)",
                "flower": "rgb(250,250,250)",
                "background": "rgb(90,90,90)"}


def serve_dash(scan_id, pts, colors, mesh, skel, tree, angles, internodes,
               gt_angles, stats, host="127.0.0.1", port=8050):
    """Reference-style Dash explorer (ref bin/dash_explorer:1-526): tabs for
    point cloud / mesh / tree graph / trait sequences, stats sidebar.

    Import-gated: dash + plotly are optional dependencies."""
    try:
        import dash
        from dash import dcc, html
        import plotly.graph_objects as go
    except ImportError:
        print("dash/plotly are not installed — use the default static-HTML "
              "mode, or `pip install dash plotly` for --serve.",
              file=sys.stderr)
        raise SystemExit(2)

    from .. import visu_plotly as vp
    from ..fsdb.geometry import PointCloud

    def _scene_fig(data, title, showlegend=False):
        fig = go.Figure(data=data)
        fig.update_layout(height=760, title=title, showlegend=showlegend,
                          template="plotly_dark", uirevision=title)
        fig.update_scenes(aspectmode="data")
        return fig

    tabs = []
    if len(pts):
        pcd_trace = vp.plotly_pointcloud_data(
            PointCloud(pts), n_pts="all",
            marker_kwargs={"color": colors} if colors else None)
        data = [pcd_trace]
        if skel["points"]:
            data += vp.plotly_skeleton_data(
                skel, line_kwargs={"color": "#ff5050", "width": 3})
        tabs.append(dcc.Tab(label="Point cloud", children=[
            dcc.Graph(figure=_scene_fig(data, "Point cloud + skeleton"))]))
    if mesh is not None:
        tabs.append(dcc.Tab(label="Mesh", children=[
            dcc.Graph(figure=_scene_fig([vp.plotly_mesh_data(mesh)],
                                        "Triangle mesh"))]))
    if tree is not None:
        tabs.append(dcc.Tab(label="Tree graph", children=[
            dcc.Graph(figure=_scene_fig(vp.plotly_treegraph_data(tree),
                                        "Tree graph", showlegend=True))]))
    if angles:
        seqs = {"divergence angle (deg)": angles}
        if internodes:
            seqs["internode (mm)"] = internodes
        fig = vp.plotly_vert_sequences(seqs, y_axis_label="organ index",
                                       layout_kwargs={"height": 760})
        if gt_angles:
            fig.add_trace(go.Scatter(x=gt_angles,
                                     y=list(range(len(gt_angles))),
                                     mode="markers", name="measured",
                                     marker={"symbol": "x"}), row=1, col=1)
        tabs.append(dcc.Tab(label="Sequences", children=[dcc.Graph(figure=fig)]))

    stat_rows = [html.Tr([html.Td(str(k)), html.Td(str(v))])
                 for k, v in stats]
    app = dash.Dash(__name__)
    app.layout = html.Div([
        html.H3(f"Scan: {scan_id}"),
        html.Table(stat_rows),
        dcc.Tabs(tabs or [dcc.Tab(label="(no derived data)",
                                  children=[html.P("Run the pipeline first.")])]),
    ])
    app.run(host=host, port=port, debug=False)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dash_explorer")
    ap.add_argument("dataset")
    ap.add_argument("--out", default="explorer.html")
    ap.add_argument("--max-points", type=int, default=MAX_POINTS)
    ap.add_argument("--serve", action="store_true",
                    help="serve a Dash/Plotly web app instead of writing "
                         "static HTML (requires dash + plotly)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8050)
    args = ap.parse_args(argv)

    db_path, scan_id = parse_dataset(args.dataset)
    db = FSDB(db_path)
    db.connect(unsafe=True)
    scan = db.get_scan(scan_id)
    located = locate_task_filesets(
        scan, ["PointCloud", "SegmentedPointCloud", "TriangleMesh",
               "CurveSkeleton", "RefineSkeleton", "TreeGraph",
               "AnglesAndInternodes"])

    pts = np.zeros((0, 3))
    colors = []
    src = (located["SegmentedPointCloud"]
           if located["SegmentedPointCloud"] != "None"
           else located["PointCloud"])
    labels = None
    if src != "None":
        f = scan.get_fileset(src).get_files()[0]
        pcd = io.read_point_cloud(f)
        pts = np.asarray(pcd.points)
        labels = f.get_metadata("labels")
        if len(pts) > args.max_points:
            sel = np.random.default_rng(0).choice(
                len(pts), args.max_points, replace=False)
            pts = pts[sel]
            labels = [labels[i] for i in sel] if labels else None
        colors = ([LABEL_COLORS.get(l, "rgb(200,200,200)") for l in labels]
                  if labels else _height_colors(pts))

    skel = {"points": [], "lines": []}
    sk_src = (located["RefineSkeleton"]
              if located["RefineSkeleton"] != "None"
              else located["CurveSkeleton"])
    if sk_src != "None":
        sk = io.read_json(scan.get_fileset(sk_src).get_files()[0])
        skel = {"points": np.round(np.asarray(sk["points"]), 2).tolist(),
                "lines": sk["lines"]}

    angles, internodes, gt_angles = [], [], []
    if located["AnglesAndInternodes"] != "None":
        f = scan.get_fileset(located["AnglesAndInternodes"]).get_file(
            "AnglesAndInternodes")
        if f:
            seq = io.read_json(f)
            angles = [round(float(a), 1) for a in seq.get("angles", [])]
            if angles and max(angles) < 7:
                angles = [round(np.degrees(a), 1) for a in angles]
            internodes = [round(float(x), 2)
                          for x in seq.get("internodes", [])]
    measures = scan.get_measures() if hasattr(scan, "get_measures") else None
    if measures and measures.get("angles"):
        gt_angles = [round(float(a), 1) for a in measures["angles"]]
        if gt_angles and max(gt_angles) < 7:
            gt_angles = [round(np.degrees(a), 1) for a in gt_angles]

    thumbs = []
    images = scan.get_fileset("images")
    n_images = 0
    if images:
        files = images.get_files(query={"channel": "rgb"}) or images.get_files()
        n_images = len(files)
        step = max(len(files) // MAX_THUMBS, 1)
        from PIL import Image
        for f in files[::step][:MAX_THUMBS]:
            try:
                img = Image.fromarray(io.read_image(f))
                img.thumbnail((220, 220))
                buf = BytesIO()
                img.convert("RGB").save(buf, "JPEG", quality=70)
                b64 = base64.b64encode(buf.getvalue()).decode()
                thumbs.append(f'<img src="data:image/jpeg;base64,{b64}" '
                              f'title="{f.id}"/>')
            except Exception:
                pass

    mesh = None
    stats = [("images", n_images), ("points", len(pts)),
             ("skeleton nodes", len(skel["points"])),
             ("organs (angles)", len(angles))]
    if located["TriangleMesh"] != "None":
        mesh = io.read_triangle_mesh(
            scan.get_fileset(located["TriangleMesh"]).get_files()[0])
        stats.append(("mesh", f"{len(mesh.vertices)} v / "
                              f"{len(mesh.triangles)} t"))
    stats_rows = "".join(f"<tr><td>{k}</td><td>{v}</td></tr>"
                         for k, v in stats)

    if args.serve:
        tree = None
        if located["TreeGraph"] != "None":
            tf = scan.get_fileset(located["TreeGraph"]).get_files()
            if tf:
                tree = io.read_graph(tf[0])
        try:
            serve_dash(scan.id, pts, colors, mesh, skel, tree, angles,
                       internodes, gt_angles, stats,
                       host=args.host, port=args.port)
        finally:
            db.disconnect()
        return

    data = {"points": np.round(pts, 2).tolist(), "colors": colors,
            "skeleton": skel, "angles": angles, "internodes": internodes,
            "gt_angles": gt_angles}
    html = PAGE.format(scan_id=scan.id,
                       summary=f"{n_images} images · {len(pts)} points shown",
                       stats_rows=stats_rows, thumbs="\n".join(thumbs),
                       data_json=json.dumps(data))
    Path(args.out).write_text(html)
    print(f"wrote {args.out} ({Path(args.out).stat().st_size // 1024} KiB)")
    db.disconnect()


if __name__ == "__main__":
    main()
