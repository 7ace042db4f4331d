"""Trait tasks: TreeGraph, AnglesAndInternodes
(port of plant3dvision_tpu/tasks/arabidopsis.py; reference
tasks/arabidopsis.py, 219 LoC)."""

from __future__ import annotations


from ..fsdb import io
from ..runtime.log import configure_logger
from ..runtime.task import Parameter, RomiTask
from ..traits import (
    compute_angles_and_internodes_from_directions,
    compute_stem_and_fruit_directions,
    compute_tree_graph,
)

logger = configure_logger(__name__)


class TreeGraph(RomiTask):
    """Curve skeleton -> labelled tree graph
    (reference tasks/arabidopsis.py:41-62)."""

    upstream_task = Parameter(default="CurveSkeleton")
    z_axis = Parameter(default=2)
    stem_axis_inverted = Parameter(default=False)

    def run(self):
        skel = io.read_json(self.input_file())
        tree = compute_tree_graph(skel["points"], skel["lines"],
                                  int(self.z_axis), bool(self.stem_axis_inverted))
        outfile = self.output_file()
        io.write_graph(outfile, tree)


class AnglesAndInternodes(RomiTask):
    """Divergence angles + internode lengths between successive organs
    (reference tasks/arabidopsis.py:120-219).

    Dispatches on the upstream task family: TreeGraph (geometric pipeline)
    or ClusteredMesh/OrganSegmentation (ML pipeline).
    """

    upstream_task = Parameter(default="TreeGraph")
    #: "directions" (the reference's current algorithm) or "legacy"
    #: (arabidopsis.py:566-683 plane-normal method)
    method = Parameter(default="directions")
    min_fruit_size = Parameter(default=6.0)
    node_sampling_dist = Parameter(default=10.0)
    organ_type = Parameter(default="fruit")
    characteristic_length = Parameter(default=1.0)
    stem_axis = Parameter(default=2)
    stem_axis_inverted = Parameter(default=False)
    min_elongation_ratio = Parameter(default=2.0)

    def run(self):
        upstream_family = self.upstream_task if isinstance(self.upstream_task, str) \
            else self.upstream_task.__name__
        if upstream_family == "TreeGraph":
            measures = self.measures_from_tree_graph()
        else:
            measures = self.measures_from_organ_segmentation()
        outfile = self.output_file("AnglesAndInternodes")
        io.write_json(outfile, measures)

    def measures_from_tree_graph(self):
        t = io.read_graph(self.input_file())
        if str(self.method) == "legacy":
            from ..traits.angles import compute_angles_and_internodes_legacy
            return compute_angles_and_internodes_legacy(
                t, n_nodes_fruit=max(int(self.node_sampling_dist) // 2, 3),
                n_nodes_stem=max(int(self.node_sampling_dist) // 2, 3))
        fruit_dirs, stem_dirs, bp_coords, fruit_pts = \
            compute_stem_and_fruit_directions(
                t, max_node_dist=float(self.node_sampling_dist),
                min_fruit_length=float(self.min_fruit_size))
        measures = compute_angles_and_internodes_from_directions(
            fruit_dirs, stem_dirs, bp_coords)
        measures["fruit_points"] = fruit_pts

        io.write_json(self.output_file("fruit_direction"),
                      {"fruit_dirs": {i: list(map(float, d)) for i, d in enumerate(fruit_dirs)},
                       "bp_coords": {i: list(map(float, c)) for i, c in enumerate(bp_coords)}})
        io.write_json(self.output_file("stem_direction"),
                      {"stem_dirs": {i: list(map(float, d)) for i, d in enumerate(stem_dirs)},
                       "bp_coords": {i: list(map(float, c)) for i, c in enumerate(bp_coords)}})
        return measures

    def measures_from_organ_segmentation(self):
        """ML pipeline path: angles from a labelled point cloud
        (reference arabidopsis.py:379-506), by the organ oriented-bbox
        direction method."""
        from ..fsdb.geometry import PointCloud as PCD
        from ..traits.organs import angles_and_internodes_from_point_cloud

        infs = self.input()
        if isinstance(infs, (list, tuple)):
            infs = infs[0]
        fs = infs.get(create=False)
        stem_pcds, organ_pcds = [], []
        for f in fs.get_files():
            obj = io.read_point_cloud(f)
            # ClusteredMesh upstream yields meshes; use their vertices
            pcd = obj if hasattr(obj, "points") else PCD(obj.vertices)
            label = f.get_metadata("label")
            if label == "stem":
                stem_pcds.append(pcd)
            elif label == str(self.organ_type):
                organ_pcds.append(pcd)
        if not stem_pcds:
            raise ValueError("No stem point cloud found in upstream fileset")
        stem = stem_pcds[0]
        for extra in stem_pcds[1:]:
            stem = stem + extra
        return angles_and_internodes_from_point_cloud(
            stem, organ_pcds,
            characteristic_length=float(self.characteristic_length),
            stem_axis=int(self.stem_axis),
            stem_axis_inverted=bool(self.stem_axis_inverted),
            min_elongation_ratio=float(self.min_elongation_ratio),
            min_fruit_size=float(self.min_fruit_size))
