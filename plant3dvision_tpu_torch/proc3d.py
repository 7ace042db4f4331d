"""3D processing: volume -> point cloud on the device, point-cloud graphs on
the host.

Port of the parts of plant3dvision_tpu/proc3d.py on the geometric main
path. The dense stages of vol2pcd (signed distance, gradients, smoothing,
band extraction) run as the port's CUDA kernels on a CUDA tensor and as
their plain PyTorch versions on a CPU tensor; the graph stages (kNN,
Dijkstra, clustering) run on the host through scipy's C implementations
(scipy.spatial.cKDTree where the JAX package uses scikit-learn).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .fsdb.geometry import PointCloud
from .runtime.log import configure_logger

logger = configure_logger(__name__)


# -- coordinate transforms (reference proc3d.py:28-65) -------------------

def index2point(indexes, origin, voxel_size):
    indexes = np.asarray(indexes, dtype=np.float64)
    origin = np.asarray(origin, dtype=np.float64)
    return voxel_size * indexes + origin[np.newaxis, :]


def point2index(points, origin, voxel_size):
    points = np.asarray(points, dtype=np.float64)
    origin = np.asarray(origin, dtype=np.float64)
    return np.asarray(np.round((points - origin[np.newaxis, :]) / voxel_size), dtype=int)


# -- volume -> point cloud (reference vol2pcd, proc3d.py:490-570) --------

def band_limits(level_set_value):
    """(lo, hi) of the band lo < d <= hi, in float32 exactly as the JAX
    package computes them: f32(-l) and f32(-l) + f32(sqrt 3)."""
    lo = np.float32(-np.float32(level_set_value))
    return lo, np.float32(lo + np.float32(np.sqrt(3)))


def band_compact(dist, gx, gy, gz, level_set_value):
    """The level-set band of `dist` as records in flat index order:
    (idx int64 (n,), d float32 (n,), g float32 (n, 3)).

    A CUDA tensor goes to kernels/csrc/band.cu (count per tile, exclusive
    scan of the tile counts, ordered scatter; the band is counted first and
    the outputs allocated exactly), a CPU tensor to `band_compact_plain`.
    """
    if dist.device.type == "cpu":
        return band_compact_plain(dist, gx, gy, gz, level_set_value)
    for t in (dist, gx, gy, gz):
        if t.dtype != torch.float32 or t.shape != dist.shape:
            raise ValueError("band_compact takes four float32 volumes of "
                             "one shape")
    kernels.require_cuda("band_compact", dist, gx, gy, gz)
    lo, hi = band_limits(level_set_value)
    n = dist.numel()
    dev = dist.device
    so = kernels.lib()
    n_tiles = so.p3d_band_tiles(n)
    stream = kernels.stream_ptr(dev)
    counts = torch.empty(n_tiles, dtype=torch.int64, device=dev)
    rc = so.p3d_band_count(dist.data_ptr(), n, float(lo), float(hi),
                           counts.data_ptr(), stream)
    kernels.LAUNCHES["band_compact"] += 1
    kernels.check("band_compact", rc)
    ends = torch.cumsum(counts, 0)
    offsets = (ends - counts).contiguous()
    n_band = int(ends[-1]) if n_tiles else 0
    idx = torch.empty(n_band, dtype=torch.int64, device=dev)
    d = torch.empty(n_band, dtype=torch.float32, device=dev)
    g = torch.empty((n_band, 3), dtype=torch.float32, device=dev)
    if n_band:
        rc = so.p3d_band_scatter(dist.data_ptr(), gx.data_ptr(),
                                 gy.data_ptr(), gz.data_ptr(), n, float(lo),
                                 float(hi), offsets.data_ptr(),
                                 idx.data_ptr(), d.data_ptr(), g.data_ptr(),
                                 stream)
        kernels.LAUNCHES["band_compact"] += 1
        kernels.check("band_compact", rc)
    return idx, d, g


def band_compact_plain(dist, gx, gy, gz, level_set_value):
    """Plain PyTorch version of the band-compaction kernel."""
    lo, hi = band_limits(level_set_value)
    flat = dist.reshape(-1)
    idx = torch.nonzero((flat > float(lo)) & (flat <= float(hi))).reshape(-1)
    g = torch.stack([gx.reshape(-1)[idx], gy.reshape(-1)[idx],
                     gz.reshape(-1)[idx]], dim=1)
    return idx, flat[idx], g


def vol2pcd(volume, origin, voxel_size, level_set_value=0, dist_cap=16,
            device="cuda"):
    """Binary/score volume -> surface point cloud with outward normals.

    Same algorithm as the reference: signed distance from two EDTs,
    Gaussian-smoothed gradient normals, points extracted on the level-set
    band (-l, -l + sqrt(3)] and slid along the normal onto the level set.
    `volume` is a numpy array (moved to `device`) or a tensor (computed
    where it lies). Only the compacted band leaves the device.
    """
    from .ops.edt import signed_distance
    from .ops.filters import gaussian_filter, gradient
    from .runtime.config import resolve_device

    if torch.is_tensor(volume):
        vol = volume.to(torch.float32)
    else:
        vol = torch.from_numpy(np.ascontiguousarray(volume, np.float32)).to(
            resolve_device(device))
    vol = vol.contiguous()
    cap = int(min(dist_cap + level_set_value + 4, max(vol.shape)))
    dist = signed_distance(vol, cap)
    gx, gy, gz = gradient(dist)
    gx = gaussian_filter(gx, 1.0)
    gy = gaussian_filter(gy, 1.0)
    gz = gaussian_filter(gz, 1.0)
    idx, d, g = band_compact(dist, gx, gy, gz, level_set_value)
    idx = idx.cpu().numpy()
    d = d.cpu().numpy()
    grad = g.cpu().numpy()

    ny, nz = vol.shape[1], vol.shape[2]
    x = idx // (ny * nz)
    y = (idx // nz) % ny
    z = idx % nz

    gnorm = np.linalg.norm(grad, axis=1)
    ok = gnorm > 0
    x, y, z, grad, gnorm, d = x[ok], y[ok], z[ok], grad[ok], gnorm[ok], d[ok]
    ghat = grad / gnorm[:, None]
    val = d + level_set_value - np.sqrt(3) / 2
    pts = np.stack([x, y, z], axis=1).astype(np.float64) - ghat * val[:, None]
    normals = -ghat
    pts = index2point(pts, np.asarray(origin), voxel_size)
    return PointCloud(pts, normals).normalize_normals()


def skeletonize(points, root_index=None, bin_size=2.0, k=10, stem_axis=2):
    """Curve skeleton of a point set (role of reference proc3d.skeletonize,
    CGAL mean-curvature-flow): Xu distance-to-root clustering. Returns
    (nodes, edges)."""
    points = np.asarray(points)
    if root_index is None:
        root_index = int(np.argmin(points[:, stem_axis]))
    return skeleton_from_distance_to_root_clusters(points, root_index,
                                                   bin_size, k)


# -- graphs over point clouds --------------------------------------------

def knn_query(points, k):
    """(dist, idx) of the k nearest neighbours of every point (itself
    included), by cKDTree; equal distances are ordered by index."""
    from scipy.spatial import cKDTree
    points = np.asarray(points)
    k = min(k, len(points))
    # a few spare neighbours so ties at the k-th distance resolve by index
    kq = min(k + 4, len(points))
    dist, idx = cKDTree(points).query(points, k=kq)
    dist = dist.reshape(len(points), kq)
    idx = idx.reshape(len(points), kq)
    order = np.lexsort((idx, dist), axis=1)[:, :k]
    return (np.take_along_axis(dist, order, axis=1),
            np.take_along_axis(idx, order, axis=1))


def knn_graph_csr(points, k):
    """Symmetric kNN graph as a scipy CSR matrix of Euclidean weights."""
    import scipy.sparse as sp
    points = np.asarray(points)
    dist, idx = knn_query(points, k)
    rows = np.repeat(np.arange(len(points)), idx.shape[1])
    g = sp.coo_matrix((dist.ravel(), (rows, idx.ravel())),
                      shape=(len(points), len(points))).tocsr()
    return g.maximum(g.T)


def connect_csr_graph(g, points, root_index):
    """Connect all components to the root component by iteratively adding the
    shortest bridging edge (reference connect_graph, proc3d.py:212-263)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    points = np.asarray(points)
    g = sp.lil_matrix(g)
    while True:
        n_cc, labels = connected_components(g.tocsr(), directed=False)
        if n_cc == 1:
            break
        root_label = labels[root_index]
        in_root = np.where(labels == root_label)[0]
        out_root = np.where(labels != root_label)[0]
        d, j = cKDTree(points[in_root]).query(points[out_root], k=1)
        best = np.argmin(d)
        i1 = out_root[best]
        i2 = in_root[j[best]]
        w = float(d[best])
        g[i1, i2] = w
        g[i2, i1] = w
    return g.tocsr()


def distance_to_root_clusters(g, root_index, points, bin_size):
    """Xu-method clustering: bin nodes by geodesic distance-to-root, split
    bins into connected components, build the quotient (cluster) graph.

    Returns (cluster_centers (C,3), cluster_edges (E,2), node_cluster (N,)).
    Vectorized reimplementation of reference proc3d.py:266-329.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components, dijkstra

    points = np.asarray(points)
    n = len(points)
    dist = dijkstra(g, directed=False, indices=root_index)
    finite = np.isfinite(dist)
    bins = np.full(n, -1, dtype=np.int64)
    bins[finite] = np.floor(dist[finite] / bin_size).astype(np.int64)

    # connected components within each bin: mask edges that cross bins
    coo = sp.coo_matrix(g)
    same_bin = (bins[coo.row] == bins[coo.col]) & (bins[coo.row] >= 0)
    sub = sp.coo_matrix((coo.data[same_bin], (coo.row[same_bin], coo.col[same_bin])),
                        shape=(n, n))
    _, cc_labels = connected_components(sub.tocsr(), directed=False)

    # cluster id = unique (bin, cc) among reachable nodes; order by (bin, cc)
    key = bins.astype(np.int64) * (cc_labels.max() + 1) + cc_labels
    key[~finite] = -1
    reach = np.where(finite)[0]
    uniq, node_cluster_r = np.unique(key[reach], return_inverse=True)
    node_cluster = np.full(n, -1, dtype=np.int64)
    node_cluster[reach] = node_cluster_r

    n_clusters = len(uniq)
    centers = np.zeros((n_clusters, 3))
    counts = np.bincount(node_cluster_r, minlength=n_clusters).astype(float)
    for d in range(3):
        centers[:, d] = np.bincount(node_cluster_r, weights=points[reach, d],
                                    minlength=n_clusters) / counts

    # quotient edges: any original edge between different clusters
    cr = node_cluster[coo.row]
    cc_ = node_cluster[coo.col]
    cross = (cr >= 0) & (cc_ >= 0) & (cr != cc_)
    e = np.stack([np.minimum(cr[cross], cc_[cross]),
                  np.maximum(cr[cross], cc_[cross])], axis=1)
    edges = np.unique(e, axis=0) if len(e) else np.zeros((0, 2), dtype=np.int64)
    return centers, edges, node_cluster


def skeleton_from_distance_to_root_clusters(points, root_index, bin_size, k,
                                            connect_all_points=True):
    """The Xu method (reference proc3d.py:392-426): kNN graph -> geodesic
    distance bins -> cluster quotient graph -> MST. Returns (nodes (C,3),
    edges (E,2)) — the skeleton in {points, lines} form."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import minimum_spanning_tree

    g = knn_graph_csr(points, k)
    if connect_all_points:
        g = connect_csr_graph(g, points, root_index)
    centers, edges, _ = distance_to_root_clusters(g, root_index, points, bin_size)
    if len(edges) == 0:
        return centers, edges
    w = np.linalg.norm(centers[edges[:, 0]] - centers[edges[:, 1]], axis=1)
    cg = sp.coo_matrix((w, (edges[:, 0], edges[:, 1])),
                       shape=(len(centers), len(centers)))
    mst = minimum_spanning_tree(cg.maximum(cg.T))
    mst = sp.coo_matrix(mst)
    lines = np.stack([mst.row, mst.col], axis=1)
    return centers, lines


def dbscan(points, eps, min_samples):
    """DBSCAN cluster labels of `points` (N, d), equal to
    `sklearn.cluster.DBSCAN(eps, min_samples=min_samples).fit(points)
    .labels_` (scikit-learn is not a dependency of the port):

    - a point's neighbourhood is every point at distance <= eps, itself
      included, and it is a core point when that holds >= min_samples;
    - core points within eps of each other share a cluster; clusters are
      numbered in the order of their first core point by index;
    - a non-core point within eps of a core point is a border point of the
      first (lowest-numbered) such cluster — the cluster that reaches it
      first in scikit-learn's expansion, which finishes one cluster before
      it starts the next; every other point is noise, -1.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    points = np.asarray(points, dtype=np.float64)
    n = len(points)
    labels = np.full(n, -1, dtype=np.int64)
    if n == 0:
        return labels
    pairs = cKDTree(points).query_pairs(float(eps), output_type="ndarray")
    a, b = pairs[:, 0], pairs[:, 1]
    counts = 1 + np.bincount(a, minlength=n) + np.bincount(b, minlength=n)
    core = counts >= int(min_samples)
    both = core[a] & core[b]
    g = sp.coo_matrix((np.ones(int(both.sum()), np.int8),
                       (a[both], b[both])), shape=(n, n))
    _, comp = connected_components(g, directed=False)
    # number the clusters by their first core point
    first = np.full(n, n, dtype=np.int64)
    np.minimum.at(first, comp[core], np.flatnonzero(core))
    order = np.argsort(first, kind="stable")
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n)
    labels[core] = rank[comp[core]]
    # border points: the lowest-numbered cluster among their core neighbours
    border = np.full(n, n, dtype=np.int64)
    for c, o in ((a, b), (b, a)):
        m = core[c] & ~core[o]
        np.minimum.at(border, o[m], labels[c[m]])
    nb = ~core & (border < n)
    labels[nb] = border[nb]
    return labels
