"""Trait extraction (phyllotaxis): skeleton -> tree graph -> divergence
angles & internode lengths.

Role of reference plant3dvision/{arabidopsis,tree}.py. Graphs here are tiny
(hundreds of skeleton nodes), so this layer runs on host with numpy and the
port's own small graph module (traits/graph.py, in networkx's orders);
the node attribute schema ('position', 'labels', 'fruit_id', 'main_stem_id')
matches the reference so pickled TreeGraph outputs are interchangeable.
"""

from .tree import (
    get_root_node_id,
    get_ordered_stem_nodes,
    get_ordered_branching_point_nodes,
    nodes_coordinates,
    path_distance,
    select_by_path_distance,
    select_fruit_nodes,
    select_stem_nodes,
)
from .angles import (
    build_graph,
    compute_tree_graph,
    compute_stem_and_fruit_directions,
    compute_angles_and_internodes_from_directions,
)
