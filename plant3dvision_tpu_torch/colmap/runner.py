"""ColmapRunner: drives the external COLMAP binary through its SfM steps
(port of plant3dvision_tpu/colmap/runner.py; host code around the binary,
nothing here runs on the card).

Role of reference plant3dvision/colmap.py:381-1269 (ColmapRunner): workdir
setup, image staging, poses.txt for the model aligner, the step sequence
feature_extractor -> matcher -> mapper -> model_aligner -> model_analyzer
(+ optional dense MVS), model parsing, bounding-box estimation.

Env: COLMAP_EXE (binary path, default 'colmap'), COLMAP_WD (workdir).
Docker images are supported through the docker CLI (COLMAP_EXE to an
image name from COLMAP_DOCKER, e.g. 'roboticsmicrofarms/colmap' —
reference colmap.py:842-896 uses the docker SDK for the same).

Hardening parity with the reference:
- exe/docker validation incl. version parse >= 3.6 (colmap.py:683-761),
- version-dependent model_aligner argument rename (colmap.py:1002-1003),
- rgb-channel image staging (colmap.py:603-631),
- multiple-reconstruction handling (largest model wins),
- model_analyzer failures logged, stats captured.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..runtime.log import configure_logger
from . import read_model as rm

logger = configure_logger(__name__)


class ColmapError(RuntimeError):
    pass


#: docker image names the reference accepts (colmap.py:683-761)
COLMAP_DOCKER = ("geki/colmap", "roboticsmicrofarms/colmap")


def _is_docker_image(exe: str) -> bool:
    return exe.split(":")[0] in COLMAP_DOCKER


def colmap_available(exe=None) -> bool:
    exe = exe or os.environ.get("COLMAP_EXE", "colmap")
    if _is_docker_image(exe):
        return shutil.which("docker") is not None
    return shutil.which(exe) is not None


def parse_colmap_version(help_output: str):
    """'COLMAP 3.8 -- ...' -> (3, 8) (reference colmap.py:706-707)."""
    try:
        tok = help_output.split()[1].split("-")[0]
        return tuple(int(x) for x in tok.split(".")[:2])
    except (IndexError, ValueError):
        return None


class ColmapRunner:
    def __init__(self, image_files, matcher="exhaustive", compute_dense=False,
                 all_cli_args=None, align_pcd=True, use_gpu=False,
                 single_camera=True, alignment_max_error=10,
                 camera_model="SIMPLE_RADIAL", workdir=None, exe=None):
        """image_files: list of fsdb Files (payload + metadata with poses)."""
        self.matcher = matcher
        self.compute_dense = compute_dense
        self.align_pcd = align_pcd
        self.use_gpu = use_gpu
        self.single_camera = single_camera
        self.alignment_max_error = alignment_max_error
        self.camera_model = camera_model
        self.cli_args = all_cli_args or {}
        self.exe = exe or os.environ.get("COLMAP_EXE", "colmap")
        self.docker = _is_docker_image(self.exe)
        self.version = None
        self.analyzer_stats = None

        wd = workdir or os.environ.get("COLMAP_WD")
        self.workdir = Path(wd) if wd else Path(tempfile.mkdtemp(prefix="colmap_"))
        self.imgs_dir = self.workdir / "images"
        self.sparse_dir = self.workdir / "sparse"
        self.dense_dir = self.workdir / "dense"
        self.imgs_dir.mkdir(parents=True, exist_ok=True)
        self.sparse_dir.mkdir(parents=True, exist_ok=True)
        self.log_path = self.workdir / "colmap.log"

        self._stage_images(image_files)

    def _stage_images(self, image_files):
        """Copy images into the workdir; write poses.txt from metadata
        (priority: calibrated_pose > pose > approximate_pose — reference
        colmap.py:633-681)."""
        from ..fsdb import io
        lines = []
        for f in image_files:
            dst = self.imgs_dir / (f.filename or f"{f.id}.jpg")
            io.to_file(f, dst)
            self._ensure_rgb(dst)
            pose = (f.get_metadata("calibrated_pose")
                    or f.get_metadata("pose")
                    or f.get_metadata("approximate_pose"))
            if pose is not None:
                x, y, z = pose[0], pose[1], pose[2]
                lines.append(f"{dst.name} {x} {y} {z}")
        if lines:
            (self.workdir / "poses.txt").write_text("\n".join(lines) + "\n")

    @staticmethod
    def _ensure_rgb(path: Path):
        """COLMAP chokes on alpha/palette images: convert non-RGB files
        in place (reference colmap.py:603-631 stages the rgb channel)."""
        try:
            from PIL import Image
            with Image.open(path) as im:
                mode = im.mode
                if mode in ("RGB", "L"):
                    return
                rgb = im.convert("RGB")
            rgb.save(path)
            logger.info(f"staged {path.name}: converted {mode} -> RGB")
        except Exception as e:      # non-image payloads stage as-is
            logger.debug(f"rgb staging skipped for {path.name}: {e}")

    def validate_exe(self):
        """Check the binary/docker image exists and its version is >= 3.6
        (reference colmap.py:683-761). Stores self.version."""
        if not colmap_available(self.exe):
            raise ColmapError(
                f"COLMAP binary not found ({self.exe}); set COLMAP_EXE")
        if self.docker:
            probe = ["docker", "run", "--rm", self.exe, "colmap", "-h"]
        else:
            probe = [self.exe, "-h"]
        out = subprocess.run(probe, capture_output=True, text=True)
        ver = parse_colmap_version(out.stdout + out.stderr)
        if ver is None:
            raise ColmapError(
                f"could not parse COLMAP version from '{self.exe} -h'")
        if ver < (3, 6):
            raise ColmapError(
                f"COLMAP >= 3.6 is required, found {ver[0]}.{ver[1]} "
                "(reference colmap.py:757-761)")
        self.version = ver
        logger.info(f"Using COLMAP {ver[0]}.{ver[1]} from '{self.exe}'")

    # -- steps ---------------------------------------------------------

    def _run(self, subcommand, capture=False, **kwargs):
        if self.docker:
            cmd = ["docker", "run", "--rm",
                   "-v", f"{self.workdir}:{self.workdir}",
                   self.exe, "colmap", subcommand]
        else:
            cmd = [self.exe, subcommand]
        for k, v in kwargs.items():
            cmd += [f"--{k}", str(v)]
        extra = self.cli_args.get(subcommand, {})
        for k, v in extra.items():
            cmd += [f"--{k.lstrip('-')}", str(v)]
        logger.info(f"colmap {subcommand}")
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(self.log_path, "a") as log:
            log.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise ColmapError(
                f"colmap {subcommand} failed (rc={proc.returncode}); "
                f"see {self.log_path}")
        return proc.stdout if capture else None

    def feature_extractor(self):
        self._run("feature_extractor",
                  **{"database_path": self.workdir / "database.db",
                     "image_path": self.imgs_dir,
                     "ImageReader.camera_model": self.camera_model,
                     "ImageReader.single_camera": int(self.single_camera),
                     "SiftExtraction.use_gpu": int(self.use_gpu)})

    def matcher_step(self):
        sub = {"exhaustive": "exhaustive_matcher",
               "sequential": "sequential_matcher",
               "spatial": "spatial_matcher",
               "transitive": "transitive_matcher"}[self.matcher]
        self._run(sub, **{"database_path": self.workdir / "database.db",
                          "SiftMatching.use_gpu": int(self.use_gpu)})

    def mapper(self):
        self._run("mapper", **{"database_path": self.workdir / "database.db",
                               "image_path": self.imgs_dir,
                               "output_path": self.sparse_dir})

    def model_aligner(self):
        if not (self.workdir / "poses.txt").exists():
            logger.warning("model_aligner skipped: no poses.txt")
            return
        aligned = self.workdir / "aligned"
        aligned.mkdir(exist_ok=True)
        # COLMAP <= 3.9 calls the threshold "robust_alignment_max_error"
        # (reference colmap.py:1002-1003)
        err_key = ("robust_alignment_max_error"
                   if (self.version or (3, 6)) <= (3, 9)
                   else "alignment_max_error")
        self._run("model_aligner",
                  **{"input_path": self.model_dir,
                     "output_path": aligned,
                     "ref_images_path": self.workdir / "poses.txt",
                     "ref_is_gps": 0,
                     err_key: self.alignment_max_error})
        for f in aligned.glob("*.bin"):
            shutil.copy(f, self.model_dir / f.name)

    def model_analyzer(self):
        self.analyzer_stats = self._run(
            "model_analyzer", capture=True, **{"path": self.model_dir})

    def _pick_model(self):
        """The mapper may output several reconstructions (sparse/0, /1,
        ...); keep the one registering the most images instead of
        assuming sparse/0 exists."""
        models = sorted(d for d in self.sparse_dir.iterdir()
                        if d.is_dir() and (d / "images.bin").exists())
        if not models:
            raise ColmapError(
                f"mapper produced no reconstruction in {self.sparse_dir}")
        if len(models) > 1:
            sizes = {d: (d / "images.bin").stat().st_size for d in models}
            best = max(models, key=lambda d: sizes[d])
            logger.warning(
                f"{len(models)} reconstructions; keeping {best.name} "
                f"(largest images.bin)")
            self.model_dir = best
        else:
            self.model_dir = models[0]

    def dense(self):
        self.dense_dir.mkdir(exist_ok=True)
        self._run("image_undistorter",
                  **{"image_path": self.imgs_dir,
                     "input_path": self.model_dir,
                     "output_path": self.dense_dir})
        self._run("patch_match_stereo", **{"workspace_path": self.dense_dir})
        self._run("stereo_fusion",
                  **{"workspace_path": self.dense_dir,
                     "output_path": self.dense_dir / "fused.ply"})

    # -- orchestration ---------------------------------------------------

    def run(self):
        """Full SfM; returns (points_dict, images_dict, cameras_dict,
        sparse_points (N,3), dense_path or None, bounding_box)."""
        self.validate_exe()
        self.feature_extractor()
        self.matcher_step()
        self.mapper()
        self._pick_model()
        if self.align_pcd:
            self.model_aligner()
        try:
            self.model_analyzer()
        except ColmapError as e:
            # stats are advisory; the reconstruction is still usable
            logger.warning(f"model_analyzer failed (continuing): {e}")

        cameras, images, points = rm.read_model(self.model_dir)
        sparse = np.array([p.xyz for p in points.values()]) if points else np.zeros((0, 3))

        dense_path = None
        if self.compute_dense:
            self.dense()
            dense_path = self.dense_dir / "fused.ply"

        bbox = self.estimate_bounding_box(sparse)
        return (rm.points_to_dict(points), rm.images_to_dict(images),
                rm.cameras_to_dict(cameras), sparse, dense_path, bbox)

    @staticmethod
    def estimate_bounding_box(points, margin_frac=0.05):
        """Auto bbox = min/max +/- 5% (reference colmap.py:1244-1266)."""
        if len(points) == 0:
            return None
        lo = points.min(axis=0)
        hi = points.max(axis=0)
        margin = (hi - lo) * margin_frac
        lo = lo - margin
        hi = hi + margin
        return {"x": [float(lo[0]), float(hi[0])],
                "y": [float(lo[1]), float(hi[1])],
                "z": [float(lo[2]), float(hi[2])]}

    @staticmethod
    def crop_points(points, bbox):
        """Crop with empty-fallback (reference colmap.py:1218-1242)."""
        keep = np.ones(len(points), dtype=bool)
        for ax, key in enumerate(("x", "y", "z")):
            keep &= (points[:, ax] >= bbox[key][0]) & (points[:, ax] <= bbox[key][1])
        if keep.sum() == 0:
            logger.warning("bbox crop removed all points; keeping uncropped")
            return points
        return points[keep]
