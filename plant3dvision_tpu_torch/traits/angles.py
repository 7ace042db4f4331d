"""Tree construction + divergence angle / internode estimation.

Behavioral port of reference plant3dvision/arabidopsis.py (the accuracy-
critical path for the 1-degree angle oracle):

- compute_tree_graph (arabidopsis.py:229-285): skeleton -> weighted graph,
  root at extremal stem-axis coordinate, main stem = shortest path to the
  farthest node, custom-penalty MST, per-branching-point fruit BFS labels.
- compute_stem_and_fruit_directions (:781-892): SVD line/direction fits of
  path-distance-sampled stem/fruit nodes around each branching point.
- compute_angles_and_internodes_from_directions (:895-957): angle between
  the fruit/stem plane normals with determinant-sign complement; degrees.
"""

from __future__ import annotations

import numpy as np

from .graph import (
    Graph,
    dfs_successors,
    dijkstra_predecessor_and_distance,
    minimum_spanning_tree,
    set_node_attributes,
)
from .tree import (
    get_ordered_branching_point_nodes,
    nodes_coordinates,
    select_fruit_nodes,
    select_stem_nodes,
)


def build_graph(vertices, edges):
    vertices = np.asarray(vertices, dtype=float)
    edges = np.asarray(edges, dtype=int)
    G = Graph()
    G.add_nodes_from(range(len(vertices)))
    for a, b in edges:
        G.add_edge(int(a), int(b),
                   weight=float(np.linalg.norm(vertices[a] - vertices[b])))
    return G


def get_main_stem_and_nodes(G, root_node):
    """Main stem = shortest path from root to the farthest (geodesic) node;
    branching nodes = stem nodes of degree > 2."""
    predecessors, dist = dijkstra_predecessor_and_distance(G, root_node)
    far = max(dist.items(), key=lambda kv: kv[1])[0]
    main_stem = [far]
    cur = far
    while cur != root_node:
        cur = predecessors[cur][0]
        main_stem.append(cur)
    main_stem = np.array(main_stem, dtype=int)
    n_neighbors = np.array([len(list(G.neighbors(n))) for n in main_stem])
    branching = main_stem[n_neighbors > 2]
    return main_stem, branching


def compute_mst(G, main_stem, nodes):
    """MST under the reference's custom penalty (arabidopsis.py:57-118):
    edges touching the stem are free; edges at extra branchings are heavily
    penalized; otherwise cost = summed distance-to-nearest-branching-node."""
    G = G.copy()
    distances = {}
    max_dist = 0.0
    for i in nodes:
        _, d = dijkstra_predecessor_and_distance(G, i)
        distances[i] = d
        if d:
            max_dist = max(max_dist, max(d.values()))
    if not len(nodes):
        max_dist = 10000

    main_set = set(int(x) for x in main_stem)
    dist_to_node = {}
    for n in G.nodes():
        vals = [distances[i][n] for i in nodes if n in distances[i]]
        dist_to_node[n] = min(vals) if vals else max_dist

    def penalty(u, v):
        if u in main_set or v in main_set:
            return 0.0
        if len(G[u]) > 2 or len(G[v]) > 2:
            return 10000 + dist_to_node[u] + dist_to_node[v]
        return dist_to_node[u] + dist_to_node[v]

    for u, v in G.edges():
        G[u][v]["weight"] = penalty(u, v)
    return minimum_spanning_tree(G)


def _label_fruit(T, branching_node, fruit_id):
    """BFS from a branching point marking non-stem nodes as this fruit."""
    from collections import deque
    q = deque([branching_node])
    while q:
        cur = q.pop()
        for nxt in T.neighbors(cur):
            data = T.nodes[nxt]
            labels = data["labels"]
            if "stem" not in labels and "fruit" not in labels:
                labels.append("fruit")
                data["fruit_id"] = fruit_id
                q.append(nxt)


def compute_tree_graph(points, lines, stem_axis=2, stem_axis_inverted=False):
    points = np.asarray(points, dtype=float)
    lines = np.asarray(lines, dtype=int)
    G = build_graph(points, lines)

    if stem_axis_inverted:
        root_node = int(np.argmin(points[:, stem_axis]))
    else:
        root_node = int(np.argmax(points[:, stem_axis]))

    main_stem, branching_points = get_main_stem_and_nodes(G, root_node)

    attributes = {}
    for i in range(len(points)):
        label = []
        if i in main_stem:
            label.append("stem")
        if i in branching_points:
            label.append("node")
        attributes[i] = {"position": points[i].tolist(), "labels": label}
    for i, n_i in enumerate(branching_points):
        attributes[int(n_i)]["fruit_id"] = i
    for i, n_i in enumerate(main_stem):
        attributes[int(n_i)]["main_stem_id"] = i

    T = compute_mst(G, main_stem, branching_points)
    set_node_attributes(T, attributes)
    for i, n_i in enumerate(branching_points):
        _label_fruit(T, int(n_i), i)
    return T


# -- direction fitting ----------------------------------------------------

def get_proj_matrix(pts, dim=2):
    c = pts - pts.mean(axis=0)
    _, _, Vt = np.linalg.svd(c)
    V = Vt.T
    return V[:, :dim] @ V[:, :dim].T


def project_points(pts, proj_mat, origin=None):
    if origin is None:
        origin = pts.mean(axis=0)
    return (pts - origin) @ proj_mat + origin


def vector_from_points(pts, origin=None):
    if origin is None:
        origin = pts.mean(axis=0)
    _, _, Vt = np.linalg.svd(pts - origin)
    return Vt[0]


def orient_vector(ref_vec, vec):
    return -vec if float(np.dot(vec, ref_vec)) < 0 else vec


def compute_stem_and_fruit_directions(tree, max_node_dist=10.0,
                                      branching_points=None,
                                      min_fruit_length=10.0):
    """Per branching point: SVD stem line fit (bp projected onto it) and SVD
    fruit direction fit; both oriented toward the last sampled node."""
    if branching_points is None or len(branching_points) == 0:
        branching_points = get_ordered_branching_point_nodes(tree)

    fruit_dirs, stem_dirs, bp_coords, fruit_pts = [], [], [], []
    for bp in branching_points:
        bp_coord = nodes_coordinates(tree, [bp])[0]
        fruit_nodes_list = select_fruit_nodes(tree, bp, max_node_dist, min_fruit_length)
        stem_nodes = select_stem_nodes(tree, bp, max_node_dist)
        stem_points = nodes_coordinates(tree, stem_nodes)
        if len(stem_points) < 2 or not fruit_nodes_list:
            continue
        line_proj = get_proj_matrix(stem_points, dim=1)
        proj_stem_points = project_points(stem_points, line_proj)
        proj_stem_mean = proj_stem_points.mean(axis=0)
        proj_bp = project_points(bp_coord, line_proj, proj_stem_mean)
        stem_dir = vector_from_points(proj_stem_points, origin=proj_bp)
        last_sp = proj_stem_points[-1, :] - proj_bp
        stem_dir = orient_vector(last_sp, stem_dir)

        for fruit_nodes in fruit_nodes_list:
            fruit_points = nodes_coordinates(tree, fruit_nodes)
            if len(fruit_points) < 2:
                continue
            fruit_dir = vector_from_points(fruit_points, origin=proj_bp)
            last_fp = fruit_points[-1, :] - proj_bp
            fruit_dir = orient_vector(last_fp, fruit_dir)
            fruit_dirs.append(fruit_dir)
            stem_dirs.append(stem_dir)
            bp_coords.append(proj_bp)
            fruit_pts.append([list(map(float, p)) for p in fruit_points])

    return fruit_dirs, stem_dirs, bp_coords, fruit_pts


def tree_to_treex(tree, root_id=None):
    """Optional treex export (reference arabidopsis.py:163-203, conda-only
    `treex` package). Gated: raises ImportError with install guidance."""
    try:
        from treex import tree as tx_tree
    except ImportError as e:
        raise ImportError(
            "treex is not installed (reference installs it from the conda "
            "'mosaic' channel); tree export is optional") from e
    from collections import deque
    if root_id is None:
        from .tree import get_root_node_id
        root_id = get_root_node_id(tree)
    successors = dfs_successors(tree, source=root_id)
    TT = tx_tree.Tree()
    for k, v in tree.nodes[root_id].items():
        TT.add_attribute_to_id(k, v)
    q = deque([(root_id, TT)])
    while q:
        cur_id, cur_t = q.pop()
        for child in successors.get(cur_id, []):
            sub = tx_tree.Tree()
            cur_t.add_subtree(sub)
            for k, v in tree.nodes[child].items():
                sub.add_attribute_to_id(k, v)
            q.append((child, sub))
    return TT


def fit_plane(points):
    """(centroid, v1, v2): least-squares plane basis by SVD
    (reference arabidopsis.py:145-162)."""
    points = np.asarray(points, float)
    c = points.mean(axis=0)
    _, _, vt = np.linalg.svd(points - c)
    return c, vt[0], vt[1]


def compute_angles_and_internodes_legacy(T, n_nodes_fruit=5, n_nodes_stem=5):
    """The reference's LEGACY angle algorithm
    (arabidopsis.py:566-683, superseded upstream by the directions
    method but kept as a capability and cross-check): per branching
    point, fit a plane through the first fruit nodes + surrounding stem
    nodes, project the fruit mean direction into it, and take the angle
    between successive (fruit x stem) plane normals with the determinant
    sign complement. Returns {"angles" (degrees), "internodes",
    "fruit_points"}.
    """
    from math import degrees

    from .tree import get_fruit, get_nodes_by_label

    unordered_main_stem = get_nodes_by_label(T, "stem")
    unordered_branching_points = get_nodes_by_label(T, "node")
    branching_points = sorted(unordered_branching_points,
                              key=lambda n: T.nodes[n]["fruit_id"])
    main_stem = sorted(unordered_main_stem,
                       key=lambda n: T.nodes[n]["main_stem_id"])

    angles, internodes, all_fruit_points, node_info = [], [], [], []
    for i in range(len(branching_points) - 1):
        node_point = np.array(T.nodes[branching_points[i]]["position"])
        node_next_point = np.array(
            T.nodes[branching_points[i + 1]]["position"])
        node_fruit_points = [np.array(T.nodes[n]["position"])
                             for n in get_fruit(T, i)]
        if len(node_fruit_points) <= 1:
            continue
        vertices_fruit = node_fruit_points[:n_nodes_fruit]
        idx = main_stem.index(branching_points[i])
        stem_ids = main_stem[max(idx - n_nodes_stem // 2, 0):
                             idx + n_nodes_stem // 2]
        vertices_stem = [T.nodes[s]["position"] for s in stem_ids]
        _, v1, v2 = fit_plane(np.vstack([vertices_fruit, vertices_stem]))

        fruit_points = np.vstack(node_fruit_points)
        all_fruit_points.append(fruit_points.tolist())
        new_v1 = fruit_points.mean(axis=0) - node_point
        new_v1 = new_v1.dot(v1) * v1 + new_v1.dot(v2) * v2
        new_v1 /= np.linalg.norm(new_v1)
        v1, v2 = new_v1, v2 - v2.dot(new_v1) * new_v1
        if v2.dot(node_next_point - node_point) < 0:
            v2 = -v2
        node_info.append({"node_point": node_point,
                          "fruit_direction": v1, "stem_direction": v2})

    for i in range(1, len(node_info)):
        n1 = np.cross(node_info[i - 1]["fruit_direction"],
                      node_info[i - 1]["stem_direction"])
        n2 = np.cross(node_info[i]["fruit_direction"],
                      node_info[i]["stem_direction"])
        v1 = node_info[i - 1]["fruit_direction"]
        v2 = node_info[i]["fruit_direction"]
        v3 = node_info[i]["node_point"] - node_info[i - 1]["node_point"]
        angle = np.arccos(np.clip(np.dot(n1 / np.linalg.norm(n1),
                                         n2 / np.linalg.norm(n2)), -1, 1))
        if np.linalg.det([v1, v2, v3]) < 0:
            angle = 2 * np.pi - angle
        angles.append(angle)
        internodes.append(float(np.linalg.norm(v3)))

    if angles and np.median(angles) > np.pi:
        angles = (2 * np.pi - np.array(angles)).tolist()
    return {"angles": [degrees(a) for a in angles],
            "internodes": internodes,
            "fruit_points": all_fruit_points}


def compute_angles_and_internodes_from_directions(fruit_dirs, stem_dirs, bp_coords):
    """Angles between successive organ planes, complemented by basis sign;
    output angles in DEGREES, internodes in input units."""
    from math import degrees

    angles, internodes = [], []
    for i in range(1, len(fruit_dirs)):
        internode_vec = bp_coords[i] - bp_coords[i - 1]
        internode_dist = float(np.linalg.norm(internode_vec))
        prev_normal = np.cross(fruit_dirs[i - 1], stem_dirs[i - 1])
        curr_normal = np.cross(fruit_dirs[i], stem_dirs[i])
        cosang = np.dot(prev_normal, curr_normal)
        cosang /= max(np.linalg.norm(prev_normal) * np.linalg.norm(curr_normal), 1e-12)
        angle = float(np.arccos(np.clip(cosang, -1.0, 1.0)))
        if np.linalg.det([fruit_dirs[i - 1], fruit_dirs[i], stem_dirs[i - 1]]) < 0:
            angle = 2 * np.pi - angle
        angles.append(angle)
        internodes.append(internode_dist)

    return {"angles": [degrees(a) for a in angles], "internodes": internodes}
