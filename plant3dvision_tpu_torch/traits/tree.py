"""Tree graph queries (role of reference plant3dvision/tree.py, 291 LoC).

The tree graph is a `traits.graph.Graph` (insertion-ordered like
networkx.Graph) whose nodes carry:
- 'position': [x, y, z]
- 'labels': list of {'stem', 'node', 'fruit'}
- 'main_stem_id': order along the main stem (stem nodes)
- 'fruit_id': organ index (branching 'node' nodes and their fruit nodes)
"""

from __future__ import annotations

import numpy as np


def get_nodes_by_label(G, label):
    return [i for i in G.nodes if label in G.nodes[i]["labels"]]


def get_root_node_id(tree):
    return [n for n in tree.nodes
            if tree.nodes[n]["labels"][:1] == ["stem"]
            and tree.nodes[n].get("main_stem_id") == 0][0]


def get_ordered_stem_nodes(tree):
    stem = get_nodes_by_label(tree, "stem")
    return sorted(stem, key=lambda n: tree.nodes[n]["main_stem_id"])


def get_ordered_branching_point_nodes(tree):
    bps = get_nodes_by_label(tree, "node")
    return sorted(bps, key=lambda n: tree.nodes[n]["fruit_id"])


def nodes_coordinates(tree, nodes):
    return np.array([tree.nodes[n]["position"] for n in nodes], dtype=float)


def path_distance(tree, nodes):
    """Sum of Euclidean hop lengths along an ordered node list."""
    if len(nodes) < 2:
        return 0.0
    pts = nodes_coordinates(tree, nodes)
    return float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())


def select_by_path_distance(tree, nodes, max_node_dist):
    """Prefix of `nodes` whose cumulative path length stays <= max_node_dist
    (reference tree.py:149-176)."""
    if not len(nodes):
        return []
    sel = [nodes[0]]
    total = 0.0
    for prev, nxt in zip(nodes[:-1], nodes[1:]):
        d = float(np.linalg.norm(
            np.asarray(tree.nodes[prev]["position"], dtype=float)
            - np.asarray(tree.nodes[nxt]["position"], dtype=float)))
        if total + d > max_node_dist:
            break
        total += d
        sel.append(nxt)
    return sel


def topological_distance(tree, source, max_depth=None):
    from .graph import single_source_dijkstra_path_length
    d = single_source_dijkstra_path_length(tree, source, cutoff=max_depth, weight=1)
    d.pop(source, None)
    return d


def get_fruit(G, i):
    return [j for j in get_nodes_by_label(G, "fruit")
            if G.nodes[j].get("fruit_id") == i]


def select_fruit_nodes(tree, bp_node_id, max_node_dist=10.0, min_fruit_length=0.0):
    """Fruit node runs attached to a branching point, split per connected
    component, ordered by topological distance from the bp, small fruits
    dropped, optionally truncated by path distance
    (reference tree.py:179-245)."""
    from .graph import connected_components

    fruit_ids = [tree.nodes[nei].get("fruit_id")
                 for nei in tree.neighbors(bp_node_id)
                 if "fruit" in tree.nodes[nei]["labels"]]
    if not fruit_ids:
        return []
    fruit_id = fruit_ids[0]

    fruit_nodes_all = get_fruit(tree, fruit_id)
    sub = tree.subgraph(fruit_nodes_all)
    components = [list(c) for c in connected_components(sub)]

    ordered = []
    for comp in components:
        local = tree.subgraph([bp_node_id] + comp)
        topo = topological_distance(local, bp_node_id)
        ordered.append([k for k, _ in sorted(topo.items(), key=lambda kv: kv[1])])

    kept = []
    for comp in ordered:
        if path_distance(tree, [bp_node_id] + comp) >= min_fruit_length:
            kept.append(comp)

    if max_node_dist is not None:
        kept = [select_by_path_distance(tree, [bp_node_id] + comp, max_node_dist)
                for comp in kept]
        # reference keeps the bp at the head of the truncated list
    return kept


def select_stem_nodes(tree, bp_node_id, max_node_dist=10.0):
    """Stem nodes within a path distance of a branching point, walking the
    ordered main stem both ways (reference tree.py:248-291)."""
    main_stem = get_ordered_stem_nodes(tree)
    bp_idx = main_stem.index(bp_node_id)
    forward = select_by_path_distance(tree, main_stem[bp_idx:], max_node_dist)
    backward = select_by_path_distance(tree, main_stem[:bp_idx][::-1], max_node_dist)[::-1]
    return backward + [bp_node_id] + forward


# alias matching the reference name
select_stem_nodes_by_euclidean_distance = select_stem_nodes
