"""A small undirected graph and the few graph algorithms the trait code
uses, in place of networkx (which the port does not depend on).

The orders matter: which skeleton edges survive the tree-graph MST, and
which nodes a fruit walk visits first, follow the iteration orders of
networkx's `Graph` (insertion-ordered dict of dicts), its `copy()`, its
stable Kruskal sort and its Dijkstra (predecessor lists and the order in
which distances are settled). Each function below reproduces the networkx
algorithm of the same name step for step, so the trait outputs equal the
JAX package's, which uses networkx.
"""

from __future__ import annotations

from collections import defaultdict
from heapq import heappop, heappush
from itertools import count


class NodeView:
    """`G.nodes`: iterate nodes in insertion order, `G.nodes[n]` -> the
    node's attribute dict, `G.nodes()` -> the same view."""

    def __init__(self, nodes: dict):
        self._nodes = nodes

    def __iter__(self):
        return iter(self._nodes)

    def __len__(self):
        return len(self._nodes)

    def __contains__(self, n):
        return n in self._nodes

    def __getitem__(self, n):
        return self._nodes[n]

    def __call__(self):
        return self

    def items(self):
        return self._nodes.items()


class Graph:
    """Undirected simple graph: `_node` {n: attrs}, `_adj` {u: {v: data}},
    both insertion ordered; an edge's data dict is shared by (u, v) and
    (v, u), as in networkx."""

    def __init__(self):
        self.graph = {}
        self._node = {}
        self._adj = {}

    @property
    def nodes(self):
        return NodeView(self._node)

    def __iter__(self):
        return iter(self._node)

    def __len__(self):
        return len(self._node)

    def __contains__(self, n):
        return n in self._node

    def __getitem__(self, n):
        return self._adj[n]

    def add_node(self, n, **attr):
        if n not in self._node:
            self._adj[n] = {}
            self._node[n] = {}
        self._node[n].update(attr)

    def add_nodes_from(self, nodes):
        for item in nodes:
            if isinstance(item, tuple) and len(item) == 2 and \
                    isinstance(item[1], dict):
                self.add_node(item[0], **item[1])
            else:
                self.add_node(item)

    def add_edge(self, u, v, **attr):
        for n in (u, v):
            if n not in self._node:
                self._adj[n] = {}
                self._node[n] = {}
        datadict = self._adj[u].get(v, {})
        datadict.update(attr)
        self._adj[u][v] = datadict
        self._adj[v][u] = datadict

    def add_edges_from(self, ebunch):
        for e in ebunch:
            if len(e) == 3:
                u, v, dd = e
            else:
                (u, v), dd = e, {}
            self.add_edge(u, v, **dd)

    def neighbors(self, n):
        return iter(self._adj[n])

    def degree(self, n):
        """The number of neighbours of n (a simple graph without
        self-loops)."""
        return len(self._adj[n])

    def remove_nodes_from(self, nodes):
        """networkx `remove_nodes_from`: each node and its edges; the other
        nodes and neighbours keep their order."""
        for n in nodes:
            for nbr in self._adj.pop(n, {}):
                self._adj.get(nbr, {}).pop(n, None)
            self._node.pop(n, None)

    def edges(self, data=False):
        """Each edge once, as networkx's EdgeDataView reports it: nodes in
        order, each with the neighbours not reported yet."""
        seen = set()
        out = []
        for n, nbrs in self._adj.items():
            for nbr, dd in nbrs.items():
                if nbr not in seen:
                    out.append((n, nbr, dd) if data else (n, nbr))
            seen.add(n)
        return out

    def copy(self):
        """networkx `Graph.copy()`: nodes in order, then every (u, v) of
        the adjacency in order — which can reorder neighbour dicts."""
        G = Graph()
        G.graph.update(self.graph)
        G.add_nodes_from((n, d.copy()) for n, d in self._node.items())
        G.add_edges_from((u, v, dd.copy())
                         for u, nbrs in self._adj.items()
                         for v, dd in nbrs.items())
        return G

    def subgraph(self, nodes):
        """Induced subgraph in this graph's orders, sharing node and edge
        attribute dicts (as networkx's subgraph view does)."""
        keep = set(nodes)
        G = Graph()
        G.graph = self.graph
        G._node = {n: d for n, d in self._node.items() if n in keep}
        G._adj = {n: {v: dd for v, dd in self._adj[n].items() if v in keep}
                  for n in G._node}
        return G


def _weight_function(weight):
    if callable(weight):
        return weight
    return lambda u, v, data: data.get(weight, 1)


def _dijkstra_multisource(G, sources, weight, pred=None, cutoff=None):
    adj = G._adj
    dist = {}
    seen = {}
    c = count()
    fringe = []
    for source in sources:
        seen[source] = 0
        heappush(fringe, (0, next(c), source))
    while fringe:
        (d, _, v) = heappop(fringe)
        if v in dist:
            continue
        dist[v] = d
        for u, e in adj[v].items():
            cost = weight(v, u, e)
            if cost is None:
                continue
            vu_dist = dist[v] + cost
            if cutoff is not None and vu_dist > cutoff:
                continue
            if u in dist:
                u_dist = dist[u]
                if vu_dist < u_dist:
                    raise ValueError("Contradictory paths found: "
                                     "negative weights?")
                if pred is not None and vu_dist == u_dist:
                    pred[u].append(v)
            elif u not in seen or vu_dist < seen[u]:
                seen[u] = vu_dist
                heappush(fringe, (vu_dist, next(c), u))
                if pred is not None:
                    pred[u] = [v]
            elif vu_dist == seen[u]:
                if pred is not None:
                    pred[u].append(v)
    return dist


def dijkstra_predecessor_and_distance(G, source, cutoff=None,
                                      weight="weight"):
    """(pred, dist): every shortest-path predecessor of each node, in the
    order found, and distances in the order they were settled."""
    if source not in G:
        raise KeyError(f"Node {source} is not in the graph")
    pred = {source: []}
    dist = _dijkstra_multisource(G, [source], _weight_function(weight),
                                 pred=pred, cutoff=cutoff)
    return pred, dist


def single_source_dijkstra_path_length(G, source, cutoff=None,
                                       weight="weight"):
    """{node: distance} in settling order. A non-string `weight` that is
    not an edge attribute counts every edge as 1 (hop count), as in
    networkx."""
    if source not in G:
        raise KeyError(f"Node {source} is not in the graph")
    return _dijkstra_multisource(G, [source], _weight_function(weight),
                                 cutoff=cutoff)


def connected_components(G):
    """Node sets of the components, in the order of their first node."""
    seen = set()
    n = len(G)
    for v in G:
        if v not in seen:
            c = _plain_bfs(G, n - len(seen), v)
            seen.update(c)
            yield c


def _plain_bfs(G, n, source):
    adj = G._adj
    seen = {source}
    nextlevel = [source]
    while nextlevel:
        thislevel = nextlevel
        nextlevel = []
        for v in thislevel:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    nextlevel.append(w)
            if len(seen) == n:
                return seen
    return seen


class _UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        parent = self.parent
        if x not in parent:
            parent[x] = x
            return x
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:       # path compression
            parent[x], x = root, parent[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def minimum_spanning_tree(G, weight="weight"):
    """Kruskal MST (forest): edges in `G.edges()` order, stably sorted by
    weight; the tree gets G's nodes (with a copy of their attributes) and
    then the kept edges in the order they were accepted."""
    edges = []
    for u, v, d in G.edges(data=True):
        wt = d.get(weight, 1)
        if wt != wt:
            raise ValueError(f"NaN found as an edge weight. Edge {(u, v, d)}")
        edges.append((wt, u, v, d))
    edges.sort(key=lambda e: e[0])
    subtrees = _UnionFind()
    T = Graph()
    T.graph.update(G.graph)
    T.add_nodes_from((n, dict(d)) for n, d in G._node.items())
    for _, u, v, d in edges:
        if subtrees.find(u) != subtrees.find(v):
            T.add_edge(u, v, **d)
            subtrees.union(u, v)
    return T


def dfs_successors(G, source):
    """{node: [children]} of a depth-first search from `source`."""
    d = defaultdict(list)
    visited = {source}
    stack = [(source, iter(G[source]))]
    while stack:
        parent, children = stack[-1]
        for child in children:
            if child not in visited:
                d[parent].append(child)
                visited.add(child)
                stack.append((child, iter(G[child])))
                break
        else:
            stack.pop()
    return dict(d)


def set_node_attributes(G, values):
    """`values` {node: {attr: value}}: update each node's attribute dict
    (nodes not in G are skipped)."""
    for n, d in values.items():
        if n in G._node:
            G._node[n].update(d)
