"""Interactive (plotly) visualization builders (port of
plant3dvision_tpu/visu_plotly.py).

Role of the plotly half of the reference's visu.py (reference
plant3dvision/visu.py:67-957: plotly_image_carousel, plotly_volume_slicer,
plotly_{pointcloud,mesh,skeleton,treegraph}[_data], plotly_direction_data,
plotly_fruit_directions, plotly_{,vert_}sequences). plotly does not ship in
the build environment, so this module is split in two layers:

- ``*_data`` builders return PLAIN DICT trace specs ({"type": "scatter3d",
  ...}) — the exact objects ``plotly.graph_objects.Figure(data=[...])``
  accepts — computed with numpy only. These are fully testable without
  plotly (tests/test_torch_visualization.py).
- ``plotly_*`` figure builders assemble those dicts into a real
  ``plotly.graph_objects.Figure``; they import plotly lazily and raise a
  clear ImportError when it is absent (the matplotlib fallbacks in visu.py
  cover headless use).

Data types are this framework's open3d-free containers
(fsdb.geometry.PointCloud / TriangleMesh), skeleton JSON dicts
({"points", "lines"}) and networkx tree graphs with "position" / "labels" /
"fruit_id" node attributes (traits/tree.py).
"""

from __future__ import annotations

import numpy as np

_FRUIT_COLORS = [
    "#636efa", "#ef553b", "#00cc96", "#ab63fa", "#ffa15a",
    "#19d3f3", "#ff6692", "#b6e880", "#ff97ff", "#fecb52",
]


def _require_plotly():
    try:
        import plotly.graph_objects as go  # noqa: F401
    except ImportError as e:  # pragma: no cover - env-dependent
        raise ImportError(
            "plotly is required for interactive figures; install plotly or "
            "use the matplotlib builders in plant3dvision_tpu_torch.visu"
        ) from e
    import plotly.graph_objects as go
    return go


def _layout(height, width, title, layout_kwargs, showlegend):
    style = dict(height=height, width=width, title=title,
                 showlegend=showlegend)
    if isinstance(layout_kwargs, dict):
        style.update(layout_kwargs)
    return style


# ---------------------------------------------------------------------------
# trace-data builders (plain dicts, no plotly import)
# ---------------------------------------------------------------------------

def plotly_pointcloud_data(pcd, n_pts=9000, marker_kwargs=None, seed=None,
                           **kwargs):
    """3D scatter trace spec for a point cloud (ref visu.py:272-327).

    ``n_pts`` may be the string "all"; otherwise the cloud is subsampled to
    at most that many points. Point colors are used when present.
    """
    pts = np.asarray(pcd.points, dtype=float)
    colors = np.asarray(pcd.colors, dtype=float) if getattr(
        pcd, "has_colors", lambda: False)() else None
    if not (isinstance(n_pts, str) and n_pts == "all") and len(pts) > n_pts:
        rng = np.random.default_rng(seed)
        sel = rng.choice(len(pts), int(n_pts), replace=False)
        pts = pts[sel]
        colors = None if colors is None else colors[sel]

    marker_style = {"size": 1, "color": "green", "opacity": 0.8}
    if colors is not None:
        marker_style["color"] = [
            f"rgb({int(r * 255)},{int(g * 255)},{int(b * 255)})"
            for r, g, b in np.clip(colors, 0, 1)
        ]
    if isinstance(marker_kwargs, dict):
        marker_style.update(marker_kwargs)

    x, y, z = (pts.T if len(pts) else np.zeros((3, 0)))
    return dict(type="scatter3d", x=list(x), y=list(y), z=list(z),
                mode="markers", name="point cloud", marker=marker_style,
                **kwargs)


def plotly_mesh_data(mesh, mesh_kwargs=None, **kwargs):
    """Mesh3d trace spec for a triangle mesh (ref visu.py:377-412)."""
    v = np.asarray(mesh.vertices, dtype=float)
    t = np.asarray(mesh.triangles, dtype=int)
    mesh_style = {"color": "lightgreen", "opacity": 1.0}
    if isinstance(mesh_kwargs, dict):
        mesh_style.update(mesh_kwargs)
    x, y, z = (v.T if len(v) else np.zeros((3, 0)))
    i, j, k = (t.T if len(t) else np.zeros((3, 0), dtype=int))
    return dict(type="mesh3d", x=list(x), y=list(y), z=list(z),
                i=list(i), j=list(j), k=list(k), name="triangular mesh",
                **mesh_style, **kwargs)


def plotly_skeleton_data(skeleton, line_kwargs=None, **kwargs):
    """One scatter3d line trace per skeleton edge (ref visu.py:463-512).

    ``skeleton`` is the CurveSkeleton JSON dict {"points", "lines"}.
    """
    pts = np.asarray(skeleton["points"], dtype=float)
    line_style = {"width": 4, "color": "blue"}
    if isinstance(line_kwargs, dict):
        line_style.update(line_kwargs)
    traces = []
    for n, (a, b) in enumerate(skeleton["lines"]):
        seg = pts[[int(a), int(b)]]
        x, y, z = seg.T
        traces.append(dict(type="scatter3d", x=list(x), y=list(y),
                           z=list(z), mode="lines", line=dict(line_style),
                           name=f"line {n}", showlegend=False, **kwargs))
    return traces


def plotly_treegraph_data(tree, mode="lines", line_kwargs=None,
                          marker_kwargs=None, **kwargs):
    """Root marker + main-stem line + one line per fruit (ref visu.py:564-650).

    Fruit traces are named ``fruit {fruit_id}`` (with ``-{n}`` suffixes when
    a branching point carries several fruits) and carry hovertemplates with
    node ids, like the reference.
    """
    from .traits import tree as tree_q

    marker_style = {}
    if isinstance(marker_kwargs, dict):
        marker_style.update(marker_kwargs)
    stem_line = {"width": 4, "color": "blue"}
    if isinstance(line_kwargs, dict):
        stem_line.update(line_kwargs)

    data = []
    try:
        root_id = tree_q.get_root_node_id(tree)
    except Exception:
        root_id = None
    if root_id is not None:
        x, y, z = np.asarray(tree.nodes[root_id]["position"], dtype=float)
        data.append(dict(type="scatter3d", x=[x], y=[y], z=[z],
                         mode="markers",
                         marker={"size": 4, "color": "blue",
                                 "symbol": "diamond"},
                         name="root", **kwargs))

    stem_nodes = tree_q.get_ordered_stem_nodes(tree)
    coords = tree_q.nodes_coordinates(tree, stem_nodes)
    ht = ["x: %{x}<br>y: %{y}<br>z: %{z}<br>"
          f"node_id: {i}<br>type: main stem" for i in stem_nodes]
    x, y, z = (coords.T if len(coords) else np.zeros((3, 0)))
    data.append(dict(type="scatter3d", x=list(x), y=list(y), z=list(z),
                     mode=mode, line=dict(stem_line), marker=marker_style,
                     name="main stem", hovertemplate=ht, **kwargs))

    def _fruit_trace(bp_id, fruit_nodes, fid, suffix, color):
        nodes = [bp_id] + list(fruit_nodes)
        fc = tree_q.nodes_coordinates(tree, nodes)
        fht = ["x: %{x}<br>y: %{y}<br>z: %{z}<br>"
               f"node_id: {i}<br>type: fruit {fid}{suffix}" for i in nodes]
        fline = {"width": 4, "color": color}
        if isinstance(line_kwargs, dict):
            fline.update(line_kwargs)
        fx, fy, fz = fc.T
        return dict(type="scatter3d", x=list(fx), y=list(fy), z=list(fz),
                    mode=mode, line=fline, marker=marker_style,
                    name=f"fruit {fid}{suffix}", hovertemplate=fht, **kwargs)

    for bp_id in tree_q.get_ordered_branching_point_nodes(tree):
        fruit_nodes = tree_q.select_fruit_nodes(tree, bp_id,
                                                max_node_dist=None)
        if not fruit_nodes:
            continue
        fid = tree.nodes[bp_id].get("fruit_id")
        color = _FRUIT_COLORS[int(fid) % len(_FRUIT_COLORS)] \
            if fid is not None else _FRUIT_COLORS[0]
        if len(fruit_nodes) > 1:
            for n, fnodes in enumerate(fruit_nodes):
                data.append(_fruit_trace(bp_id, fnodes, fid, f"-{n}", color))
        else:
            data.append(_fruit_trace(bp_id, fruit_nodes[0], fid, "", color))
    return data


def plotly_direction_data(vectors, origins, label=None, mode="markers+lines",
                          line_kwargs=None, marker_kwargs=None, **kwargs):
    """One line trace per (origin, origin+vector) pair (ref visu.py:730-794)."""
    vectors = np.asarray(vectors, dtype=float)
    origins = np.asarray(origins, dtype=float)
    line_style = {"width": 3}
    if isinstance(line_kwargs, dict):
        line_style.update(line_kwargs)
    marker_style = {"size": 2}
    if isinstance(marker_kwargs, dict):
        marker_style.update(marker_kwargs)
    traces = []
    for n, (o, v) in enumerate(zip(origins, vectors)):
        seg = np.stack([o, o + v])
        x, y, z = seg.T
        name = f"{label} {n}" if label else f"direction {n}"
        traces.append(dict(type="scatter3d", x=list(x), y=list(y),
                           z=list(z), mode=mode, line=dict(line_style),
                           marker=dict(marker_style), name=name, **kwargs))
    return traces


def _sequence_xy_traces(sequences, line_kwargs=None, marker_kwargs=None):
    """Shared scatter specs for the two sequence figures."""
    line_style = {"width": 2}
    if isinstance(line_kwargs, dict):
        line_style.update(line_kwargs)
    marker_style = {"size": 5}
    if isinstance(marker_kwargs, dict):
        marker_style.update(marker_kwargs)
    traces = {}
    for name, values in sequences.items():
        values = list(np.asarray(values, dtype=float))
        traces[name] = dict(type="scatter", x=list(range(len(values))),
                            y=values, name=name, mode="lines+markers",
                            line=dict(line_style), marker=dict(marker_style))
    return traces


# ---------------------------------------------------------------------------
# figure builders (require plotly)
# ---------------------------------------------------------------------------

def plotly_image_carousel(image_files, height=900, width=900,
                          title="Carousel", layout_kwargs=None):
    """Animated image carousel with a slider (ref visu.py:67-113).

    ``image_files`` is a list of fsdb File objects (or numpy images).
    """
    go = _require_plotly()
    from .fsdb import io as fsdb_io

    frames = []
    for f in image_files:
        img = f if isinstance(f, np.ndarray) else fsdb_io.read_image(f)
        name = getattr(f, "id", None) or f"image {len(frames)}"
        frames.append(go.Frame(data=[go.Image(z=img)], name=str(name)))
    fig = go.Figure(data=frames[0].data if frames else [], frames=frames)
    steps = [dict(args=[[fr.name], dict(frame=dict(duration=0),
                                        mode="immediate")],
                  label=fr.name, method="animate") for fr in frames]
    fig.update_layout(
        sliders=[dict(steps=steps)],
        **_layout(height, width, title, layout_kwargs, showlegend=False))
    return fig


def plotly_volume_slicer(array, cmap="viridis", height=900, width=900,
                         title="Volume", layout_kwargs=None):
    """Z-slice slider over a volume array (ref visu.py:226-269)."""
    _require_plotly()
    import plotly.express as px

    fig = px.imshow(np.asarray(array).transpose(2, 0, 1), animation_frame=0,
                    binary_string=True, color_continuous_scale=cmap,
                    labels=dict(animation_frame="slice"))
    fig.update_layout(**_layout(height, width, title, layout_kwargs,
                                showlegend=False))
    fig.update_scenes(aspectmode="data")
    return fig


def _data_figure(data, height, width, title, layout_kwargs, showlegend):
    go = _require_plotly()
    fig = go.Figure(data=data)
    fig.update_layout(**_layout(height, width, title, layout_kwargs,
                                showlegend))
    fig.update_scenes(aspectmode="data")
    return fig


def plotly_pointcloud(pcd, n_pts=9000, height=900, width=900,
                      title="Point cloud", marker_kwargs=None,
                      layout_kwargs=None):
    """Figure wrapper over plotly_pointcloud_data (ref visu.py:330-374)."""
    return _data_figure([plotly_pointcloud_data(pcd, n_pts, marker_kwargs)],
                        height, width, title, layout_kwargs, False)


def plotly_mesh(mesh, height=900, width=900, title="Triangular mesh",
                mesh_kwargs=None, layout_kwargs=None):
    """Figure wrapper over plotly_mesh_data (ref visu.py:415-460)."""
    return _data_figure([plotly_mesh_data(mesh, mesh_kwargs)],
                        height, width, title, layout_kwargs, False)


def plotly_skeleton(skeleton, height=900, width=900, title="Skeleton",
                    line_kwargs=None, layout_kwargs=None):
    """Figure wrapper over plotly_skeleton_data (ref visu.py:515-561)."""
    return _data_figure(plotly_skeleton_data(skeleton, line_kwargs),
                        height, width, title, layout_kwargs, False)


def plotly_treegraph(tree, height=900, width=900, title="Tree graph",
                     mode="lines", line_kwargs=None, marker_kwargs=None,
                     layout_kwargs=None):
    """Figure wrapper over plotly_treegraph_data (ref visu.py:651-700)."""
    return _data_figure(
        plotly_treegraph_data(tree, mode, line_kwargs, marker_kwargs),
        height, width, title, layout_kwargs, True)


def plotly_fruit_directions(fruit_vectors, branching_points, height=900,
                            width=900, title="Fruit directions", mode="lines",
                            line_kwargs=None, marker_kwargs=None,
                            layout_kwargs=None):
    """Fruit direction vectors anchored at branching points
    (ref visu.py:797-848)."""
    return _data_figure(
        plotly_direction_data(fruit_vectors, branching_points, label="fruit",
                              mode=mode, line_kwargs=line_kwargs,
                              marker_kwargs=marker_kwargs),
        height, width, title, layout_kwargs, True)


def plotly_sequences(sequences, height=900, width=900, title="Sequences",
                     line_kwargs=None, marker_kwargs=None,
                     layout_kwargs=None):
    """Stacked per-sequence subplots, shared x index (ref visu.py:851-908)."""
    _require_plotly()
    from plotly.subplots import make_subplots

    names = list(sequences.keys())
    traces = _sequence_xy_traces(sequences, line_kwargs, marker_kwargs)
    fig = make_subplots(rows=len(names), cols=1, vertical_spacing=0.1,
                        subplot_titles=names)
    for i, name in enumerate(names):
        fig.add_trace(traces[name], row=i + 1, col=1)
        fig.update_yaxes(title_text=name, row=i + 1, col=1)
    if names:
        fig.update_xaxes(title_text="index", row=len(names), col=1)
    fig.update_layout(**_layout(height, width, title, layout_kwargs, False))
    return fig


def plotly_vert_sequences(sequences, y_axis=None, y_axis_label=None,
                          line_kwargs=None, marker_kwargs=None,
                          layout_kwargs=None):
    """Side-by-side vertical sequence subplots with a shared y axis and the
    137.5 deg canonical-divergence guide line (ref visu.py:911-986)."""
    _require_plotly()
    from plotly.subplots import make_subplots

    names = list(sequences.keys())
    n = max((len(v) for v in sequences.values()), default=0)
    y_values = list(range(n)) if y_axis is None else list(y_axis)
    fig = make_subplots(rows=1, cols=max(len(names), 1),
                        horizontal_spacing=0.02, shared_yaxes=True)
    for i, name in enumerate(names):
        vals = list(np.asarray(sequences[name], dtype=float))
        fig.add_trace(dict(type="scatter", x=vals,
                           y=y_values[:len(vals)], name="",
                           mode="lines+markers"), row=1, col=i + 1)
        if "angle" in name.lower() and y_values:
            fig.add_trace(dict(type="scatter", x=[137.5, 137.5],
                               y=[0, max(y_values)], mode="lines",
                               line=dict(dash="dash", color="gray"),
                               name="137.5"), row=1, col=i + 1)
        fig.update_xaxes(title_text=name, row=1, col=i + 1)
    if y_axis_label:
        fig.update_yaxes(title_text=y_axis_label, row=1, col=1)
    style = dict(clickmode="event+select", hovermode="y",
                 hoverlabel_align="right", showlegend=False)
    if isinstance(layout_kwargs, dict):
        style.update(layout_kwargs)
    fig.update_layout(**style)
    return fig
