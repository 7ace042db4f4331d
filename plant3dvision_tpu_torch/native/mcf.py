"""Mean-curvature-flow mesh skeletonization (port of
plant3dvision_tpu/native/mcf.py; reference romicgal `skeletonize_mesh` =
CGAL Mean_curvature_flow_skeletonization, reference proc3d.py:156).

Two stages (`skeletonize_mesh`), both host code:

1. `contract_mesh`: MCF contraction (Au et al. 2008, the family CGAL
   implements) by the native library (geometry.cpp `p3d_mcf_contract`,
   Jacobi-preconditioned CG on the normal equations). A failed build
   raises; `_contract_scipy` is its plain version (the same iteration on
   scipy.sparse), for the tests.
2. the mesh-geodesic collapse: distance-to-root binning on the mesh graph
   (original surface connectivity) and the clusters' minimum spanning
   tree, each cluster at its members' original centroid; output
   {points, lines} as the graph method's
   (proc3d.skeleton_from_distance_to_root_clusters). Stage 1 moves no
   output at this embedding, the JAX package's default and the only one
   ported.

The JAX package's `collapse_to_skeleton` (a sequential edge collapse in
contracted space, which `skeletonize_mesh` does not call) is not ported.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .mc import lib


def contract_mesh(vertices, triangles, iterations=12, wl_factor=2.0,
                  wh0=1.0, cg_iters=800):
    """Contract a triangle mesh toward its curve skeleton; returns the
    contracted vertex positions (same indexing/topology)."""
    return contract_with(lib(), vertices, triangles, iterations, wl_factor,
                         wh0, cg_iters)


def contract_with(native, vertices, triangles, iterations=12, wl_factor=2.0,
                  wh0=1.0, cg_iters=800):
    """`contract_mesh` by `native`, a build of geometry.cpp loaded by
    mc.load."""
    v = np.ascontiguousarray(vertices, dtype=np.float32)
    t = np.ascontiguousarray(triangles, dtype=np.int32)
    out = np.empty_like(v)
    rc = native.p3d_mcf_contract(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(v),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(t),
        int(iterations), ctypes.c_float(wl_factor),
        ctypes.c_float(wh0), int(cg_iters),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"MCF contraction of a mesh of {len(v)} vertices "
                         f"and {len(t)} triangles failed (rc {rc})")
    return out.astype(np.float64)


def _cot_laplacian(v, t):
    """Cotangent Laplacian (scipy CSR) + per-vertex one-ring area."""
    import scipy.sparse as sp
    n = len(v)
    ii, jj, ww = [], [], []
    area = np.zeros(n)
    for e in range(3):
        a, b, c = t[:, e], t[:, (e + 1) % 3], t[:, (e + 2) % 3]
        u = v[a] - v[c]
        w = v[b] - v[c]
        cr = np.cross(u, w)
        crn = np.maximum(np.linalg.norm(cr, axis=1), 1e-12)
        cot = np.clip((u * w).sum(1) / crn, -57.0, 57.0)
        ii.extend([a, b])
        jj.extend([b, a])
        ww.extend([0.5 * cot] * 2)
        np.add.at(area, a, 0.5 * crn / 3.0)
    W = sp.coo_matrix((np.concatenate(ww),
                       (np.concatenate(ii), np.concatenate(jj))),
                      shape=(n, n)).tocsr()
    d = np.asarray(W.sum(axis=1)).ravel()
    L = sp.diags(d) - W
    return L, area


def _contract_scipy(v, t, iterations=12, wl_factor=2.0, wh0=1.0,
                    cg_iters=800):
    """The plain version of `contract_mesh`: the same iteration with
    scipy.sparse's CG (float64 positions between rounds)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    v = np.asarray(v, np.float64).copy()
    t = np.asarray(t)
    L0, a0 = _cot_laplacian(v, t)
    mean_face = a0.mean() if len(a0) else 1.0
    wl = np.sqrt(max(mean_face, 1e-12))  # 1e-3 * sqrt(A) * 1e3, as native
    for it in range(iterations):
        L, area = (L0, a0) if it == 0 else _cot_laplacian(v, t)
        if area.sum() < 5e-3 * a0.sum():   # contracted enough (as native)
            break
        whi = np.minimum(wh0 * np.sqrt(a0 / np.maximum(area, 1e-12)), 1e4)
        A = (wl * wl) * (L.T @ L) + sp.diags(whi * whi)
        for c in range(3):
            b = whi * whi * v[:, c]
            x, _ = spla.cg(A, b, x0=v[:, c], maxiter=cg_iters, rtol=1e-7)
            v[:, c] = x
        wl *= wl_factor
    return v


def _mesh_csr_graph(v, t):
    """CSR graph of mesh edges weighted by ORIGINAL edge length."""
    import scipy.sparse as sp
    e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    w = np.linalg.norm(v[e[:, 0]] - v[e[:, 1]], axis=1)
    n = len(v)
    g = sp.coo_matrix((np.concatenate([w, w]),
                       (np.concatenate([e[:, 0], e[:, 1]]),
                        np.concatenate([e[:, 1], e[:, 0]]))),
                      shape=(n, n)).tocsr()
    return g


def skeletonize_mesh(vertices, triangles, iterations=12, wl_factor=2.0,
                     wh0=1.0, cg_iters=800, bin_size=None, min_branch=0.0,
                     stem_axis=2, stem_axis_inverted=False):
    """Full MCF mesh skeletonization: contract + mesh-geodesic collapse.

    Topology comes from geodesic distance-to-root binning on the mesh
    graph (original edge lengths; every component bridged to the root's
    by its shortest link, as the graph method does); each bin cluster is
    embedded at the centroid of its members' original positions, which
    keeps the organs' tips (the JAX package's default `embed="original"`).
    `bin_size` defaults to 4x the mean mesh edge. Returns (centers (N, 3),
    lines (E, 2)).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import minimum_spanning_tree

    from ..proc3d import connect_csr_graph, distance_to_root_clusters

    v = np.asarray(vertices, float)
    t = np.asarray(triangles)
    g = _mesh_csr_graph(v, t)
    if bin_size is None:
        e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
        bin_size = 4.0 * float(
            np.linalg.norm(v[e[:, 0]] - v[e[:, 1]], axis=1).mean())
    axis = int(stem_axis)
    root = int(np.argmax(v[:, axis]) if stem_axis_inverted
               else np.argmin(v[:, axis]))
    g = connect_csr_graph(g, v, root)

    # The clusters sit at the original positions, so the contraction moves
    # no output; it runs as the JAX package's method runs it (its work, its
    # failures), and `iterations` names it in the task's fileset id.
    contract_mesh(v, t, iterations=iterations, wl_factor=wl_factor,
                  wh0=wh0, cg_iters=cg_iters)
    centers, edges, _ = distance_to_root_clusters(g, root, v,
                                                  float(bin_size))
    if len(edges) == 0:
        return centers, edges
    w = np.linalg.norm(centers[edges[:, 0]] - centers[edges[:, 1]], axis=1)
    cg_m = sp.coo_matrix((w, (edges[:, 0], edges[:, 1])),
                         shape=(len(centers), len(centers)))
    mst = sp.coo_matrix(minimum_spanning_tree(cg_m.maximum(cg_m.T)))
    lines = np.stack([mst.row, mst.col], axis=1)
    if min_branch > 0:
        centers, lines = _prune_spurs(centers, lines, float(min_branch))
    return centers, lines


def _prune_spurs(centers, lines, min_branch):
    """Remove leaf chains shorter than min_branch (real coordinates), in
    the JAX package's networkx orders (traits/graph.py)."""
    from ..traits.graph import Graph
    g = Graph()
    g.add_nodes_from(range(len(centers)))
    for a, b in lines:
        g.add_edge(int(a), int(b),
                   length=float(np.linalg.norm(centers[a] - centers[b])))
    changed = True
    while changed:
        changed = False
        for leaf in [v_ for v_ in g.nodes if g.degree(v_) == 1]:
            chain = [leaf]
            total = 0.0
            cur, prev = leaf, None
            while g.degree(cur) <= 2:
                nxt_l = [v_ for v_ in g.neighbors(cur) if v_ != prev]
                if not nxt_l:
                    break
                nxt = nxt_l[0]
                total += g[cur][nxt]["length"]
                prev, cur = cur, nxt
                if g.degree(cur) > 2 or total >= min_branch:
                    break
                chain.append(cur)
            if total < min_branch and g.degree(cur) > 2:
                g.remove_nodes_from(chain)
                changed = True
    nodes = sorted(g.nodes)
    remap = {v_: i for i, v_ in enumerate(nodes)}
    centers = centers[nodes]
    lines = np.array([[remap[a], remap[b]] for a, b in g.edges()],
                     dtype=np.int64).reshape(-1, 2)
    return centers, lines
