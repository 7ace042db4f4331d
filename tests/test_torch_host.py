"""The port's host code that replaces libraries absent where the port runs:
the numpy + zlib PNG codec (against cv2), the small graph module (against
networkx, orders included), cKDTree kNN (against scikit-learn), and the
tree-graph / angle traits built on them (against the JAX package's, which
use networkx). All exact unless stated.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

from plant3dvision_tpu_torch.fsdb.io import png_decode, png_encode
from plant3dvision_tpu_torch.traits import graph as pg

torch.set_num_threads(1)

cv2 = pytest.importorskip("cv2")
nx = pytest.importorskip("networkx")


# -- PNG ----------------------------------------------------------------------

def _cv2_order(img):
    if img.ndim == 3 and img.shape[2] == 3:
        return cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    if img.ndim == 3 and img.shape[2] == 4:
        return cv2.cvtColor(img, cv2.COLOR_RGBA2BGRA)
    return img


@pytest.mark.parametrize("shape", [(37, 53), (20, 31, 3), (16, 9, 4)])
def test_png_roundtrip_against_cv2(shape):
    rng = np.random.default_rng(len(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[: shape[0] // 2] //= 64                    # smooth + noisy halves
    # ours -> cv2
    dec = cv2.imdecode(np.frombuffer(png_encode(img), np.uint8),
                       cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(dec, _cv2_order(img))
    # cv2 (its own adaptive row filters) -> ours
    ok, buf = cv2.imencode(".png", _cv2_order(img))
    assert ok
    np.testing.assert_array_equal(png_decode(buf.tobytes()), img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_with_filters(img, ftypes):
    """Reference encoder (plain Python) that applies the given filter type to
    each row, so every filter of the PNG spec reaches the decoders."""
    H, W, C = img.shape
    raw = img.astype(np.int64).reshape(H, W * C)
    out = bytearray()
    for r in range(H):
        f = ftypes[r % len(ftypes)]
        out.append(f)
        for i in range(W * C):
            x = raw[r, i]
            a = raw[r, i - C] if i >= C else 0
            b = raw[r - 1, i] if r > 0 else 0
            c = raw[r - 1, i - C] if r > 0 and i >= C else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
            out.append((x - pred) & 0xFF)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decodes_all_filter_types(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (15, 11, channels), dtype=np.uint8)
    data = _png_with_filters(img, [0, 1, 2, 3, 4, 4, 3, 2, 1])
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    out = png_decode(data)
    want = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(_cv2_order(out), ref)


def test_read_write_image_without_cv2(monkeypatch, tmp_path):
    """With cv2 absent (as on the machine with the card) read/write_image
    take the numpy + zlib path; the bytes decode to the same image."""
    from plant3dvision_tpu_torch.fsdb import io
    from plant3dvision_tpu_torch.fsdb.testing import TemporaryDB
    monkeypatch.setattr(io, "_cv2", lambda: None)
    img = (np.random.default_rng(0).random((30, 40)) > 0.5).astype(np.uint8) * 255
    with TemporaryDB() as db:
        f = db.get_scan("s", create=True).get_fileset(
            "images", create=True).create_file("m")
        io.write_image(f, img, "png")
        np.testing.assert_array_equal(io.read_image(f), img)
        np.testing.assert_array_equal(cv2.imread(str(f.path()),
                                                 cv2.IMREAD_UNCHANGED), img)


# -- graph algorithms vs networkx -----------------------------------------------

def _random_graphs(seed, n=40):
    """The same graph built in networkx and in the port's Graph: a random
    tree plus extra edges, integer weights so ties are common, edges added
    in a shuffled order (neighbour orders then differ from node order)."""
    rng = np.random.default_rng(seed)
    edges = [(int(rng.integers(0, i)), i) for i in range(1, n)]
    edges += [tuple(int(v) for v in rng.choice(n, 2, replace=False))
              for _ in range(n // 2)]
    rng.shuffle(edges)
    G, P = nx.Graph(), pg.Graph()
    G.add_nodes_from(range(n))
    P.add_nodes_from(range(n))
    for u, v in edges:
        w = float(rng.integers(1, 4))
        if rng.random() < 0.5:
            u, v = v, u
        G.add_edge(u, v, weight=w)
        P.add_edge(u, v, weight=w)
    return G, P


def _adj(G):
    return [(u, list(nbrs)) for u, nbrs in G._adj.items()]


@pytest.mark.parametrize("seed", range(4))
def test_graph_algorithms_match_networkx_orders(seed):
    G, P = _random_graphs(seed)
    assert _adj(G) == _adj(P)
    assert list(G.edges(data=True)) == P.edges(data=True)
    assert _adj(G.copy()) == _adj(P.copy())
    for src in (0, 7, 23):
        gp, gd = nx.dijkstra_predecessor_and_distance(G, src)
        pp, pd = pg.dijkstra_predecessor_and_distance(P, src)
        assert list(gd.items()) == list(pd.items())
        assert gp == pp and all(gp[k] == pp[k] for k in gp)
        for w in ("weight", 1):
            assert list(nx.single_source_dijkstra_path_length(
                G, src, weight=w).items()) == list(
                pg.single_source_dijkstra_path_length(P, src,
                                                      weight=w).items())
        assert nx.dfs_successors(G, src) == pg.dfs_successors(P, src)
    T, Q = nx.minimum_spanning_tree(G), pg.minimum_spanning_tree(P)
    assert _adj(T) == _adj(Q)
    assert list(T.edges(data=True)) == Q.edges(data=True)
    keep = [n for n in G if n % 3]
    assert _adj(G.subgraph(keep)) == _adj(P.subgraph(keep))
    assert [sorted(c) for c in nx.connected_components(G.subgraph(keep))] == \
        [sorted(c) for c in pg.connected_components(P.subgraph(keep))]


def _jax_tree(points, lines, inv):
    from plant3dvision_tpu.traits.angles import compute_tree_graph
    return compute_tree_graph(points, lines, 2, inv)


def _skeleton(seed):
    """A noisy stem with side branches on a coarse grid (tied lengths)."""
    rng = np.random.default_rng(seed)
    pts = [np.array([0.0, 0.0, z]) for z in range(0, 40, 2)]
    lines = [(i, i + 1) for i in range(len(pts) - 1)]
    for b in range(6):
        base = 3 + 3 * b
        a = 2.4 * b
        d = np.array([np.cos(a), np.sin(a), 0.8])
        prev = base
        for s in range(1, 7):
            pts.append(pts[base] + 2.0 * s * d
                       + np.round(rng.normal(scale=0.3, size=3), 1))
            lines.append((prev, len(pts) - 1))
            prev = len(pts) - 1
    order = rng.permutation(len(lines))
    return np.array(pts), np.array(lines)[order]


@pytest.mark.parametrize("seed,inv", [(0, True), (1, True), (2, False)])
def test_tree_graph_and_angles_match_jax(seed, inv):
    from plant3dvision_tpu.traits.angles import (
        compute_angles_and_internodes_from_directions as jax_angles,
        compute_stem_and_fruit_directions as jax_dirs)
    from plant3dvision_tpu_torch.traits.angles import (
        compute_angles_and_internodes_from_directions,
        compute_stem_and_fruit_directions, compute_tree_graph)
    pts, lines = _skeleton(seed)
    if not inv:
        pts = pts * np.array([1.0, 1.0, -1.0])
    T = _jax_tree(pts, lines, inv)
    Q = compute_tree_graph(pts, lines, 2, inv)
    assert _adj(T) == _adj(Q)
    assert {n: T.nodes[n] for n in T} == {n: Q.nodes[n] for n in Q}
    ref = jax_angles(*jax_dirs(T, 10.0, min_fruit_length=4.0)[:3])
    out = compute_angles_and_internodes_from_directions(
        *compute_stem_and_fruit_directions(Q, 10.0, min_fruit_length=4.0)[:3])
    assert len(out["angles"]) == len(ref["angles"]) >= 3
    np.testing.assert_array_equal(out["angles"], ref["angles"])
    np.testing.assert_array_equal(out["internodes"], ref["internodes"])


# -- kNN ----------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 5, 10])
def test_knn_matches_sklearn(k):
    from sklearn.neighbors import NearestNeighbors
    from plant3dvision_tpu_torch.proc3d import knn_query
    pts = np.random.default_rng(k).random((500, 3)) * 50
    dist, idx = NearestNeighbors(n_neighbors=k).fit(pts).kneighbors(pts)
    d, i = knn_query(pts, k)
    np.testing.assert_array_equal(i, idx)
    np.testing.assert_allclose(d, dist, rtol=1e-12)


def test_knn_ties_break_by_index():
    from plant3dvision_tpu_torch.proc3d import knn_query
    pts = np.array([[0.0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                    [5, 5, 5]])
    d, i = knn_query(pts, 3)
    assert list(i[0]) == [0, 1, 2]                 # 4 neighbours at 1.0


def test_knn_graph_and_skeleton_match_jax():
    from plant3dvision_tpu import proc3d as jp
    from plant3dvision_tpu_torch import proc3d as pp
    rng = np.random.default_rng(9)
    pts, _ = _skeleton(3)
    cloud = np.repeat(pts, 20, axis=0) + rng.normal(scale=0.6,
                                                    size=(20 * len(pts), 3))
    a, b = jp.knn_graph_csr(cloud, 10), pp.knn_graph_csr(cloud, 10)
    assert (a != b).nnz == 0
    root = int(np.argmin(cloud[:, 2]))
    ca, la = jp.skeleton_from_distance_to_root_clusters(cloud, root, 2.0, 10)
    cb, lb = pp.skeleton_from_distance_to_root_clusters(cloud, root, 2.0, 10)
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(la, lb)
