"""Declarative pipeline configuration: a class registry with the docs of
every parameter (``describe``), named-object creation
(``ConfigManager.create``) and JSON object graphs with ``#id``/``#pointer``
references.

Counterpart of ``srrg2_laser_slam_2d_tpu/utils/config.py``, kept as the
port's own copy. The port's configuration classes register under the same
``#class`` names as the JAX package's, so both read the same files
(``configurations/corridor.json`` and its siblings) unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

_REGISTRY: dict[str, type] = {}
_FIELD_DOCS: dict[str, dict[str, str]] = {}

# the parameter docs of the port's configuration classes, by class name
# (``describe`` lists them; the same text as the JAX package's)
_PORT_DOCS: dict[str, dict[str, str]] = {
    "PreprocessorConfig": {
        "range_min": "range_min [meters]",
        "range_max": "range_max [meters]",
        "voxelize_resolution": "unproject voxelization resolution [meters]",
        "normal_point_distance": "range of points considered while computing normal",
        "normal_min_points": "min number of points to compute a normal",
        "normal_window": "static one-sided stencil width of the normal window",
        "scan_topic": "topic of the scan",
    },
    "AlignerConfig": {
        "max_iterations": "maximum number of iterations of the outer ICP loop",
        "min_num_inliers": "minimum number of inliers",
        "enable_inlier_only_runs": "additional inlier-only runs if sufficient inliers are available",
        "keep_only_inlier_correspondences": "final pass drops correspondences whose factors are not inliers",
        "epsilon": "chi2-decay termination ratio (None = run all iterations)",
        "damping": "GN damping factor, the higher the closer to gradient descent",
        "point_distance": "max beam-depth distance between corresponding points",
        "normal_cos": "min cosine between normals",
        "chi_threshold": "Cauchy robustifier chi threshold (<=0 disables)",
        "min_num_correspondences": "minimum number of correspondences in this slice",
        "odom_weight": "information weight of the odometry prior slice (0 disables)",
        "finder": "correspondence finder: projective | nn_grid | bruteforce",
        "finder_max_distance": "max distance for NN correspondences [meters]",
        "finder_resolution": "resolution of the nn_grid distance map [m/pixel]",
        "finder_grid_size": "static side of the nn_grid distance map [pixels]",
    },
    "TrackerConfig": {
        "scene_capacity": "static local-map scene capacity [points]",
        "merge_threshold": "max depth distance for merging measurement into scene",
        "clip_voxelize_resolution": "clipper decimation grid [meters], 0 = off",
        "projection": "polar canvas used for matching/merging/clipping",
        "aligner": "scan-to-scene aligner assembly",
        "use_fused_aligner": "run the whole alignment as one Pallas kernel",
        "banded_aligner": "block-windowed beam matching in the fused aligner (beam-indexed moving cloud required)",
        "use_fused_scene_ops": "Pallas clip/merge kernels instead of XLA scatters",
        "clipper": "scene clipper: projective | ball",
        "ball_max_range": "SceneClipperBall2D max range [meters]",
        "reuse_clip_canvas": "reuse the merger's canvas as the next clip (fast path)",
        "lean_scene_ops": "beam-window merge via the cached canvas (zero full-scene projections)",
        "auto_grow_scene": "regrow the scene 2x at a watermark between steps (reference dynamic-resize role)",
        "grow_watermark": "occupancy fraction that triggers scene regrowth",
    },
    "LoopDetectorConfig": {
        "relocalize_min_inliers": "minimum number of inliers for success [int]",
        "relocalize_min_inliers_ratio": "minimum fraction of inliers over total correspondences",
        "relocalize_max_chi_inliers": "maximum chi per inlier for success [chi]",
        "max_local_map_distance": "max distance in meters for closure candidates",
        "relocalize_range_scale": "distance scale of candidate closures",
        "aggressive_relocalize_graph_distance": "min graph distance to start aggressive widening",
        "aggressive_relocalize_graph_max_range": "max graph distance for aggressive widening",
        "aggressive_relocalize_range_increase_per_edge": "chi2 range increase per graph edge",
        "max_candidates": "static batch size of the parallel candidate alignment",
        "aligner": "aligner used to register loop closures",
        "backend": "candidate-alignment backend: projective (XLA parity "
                   "path) or fused_nn (one-kernel bounded-NN ICP, TPU "
                   "serving path of the chunked loop)",
        "detection_capacity": "chunked-loop alignment point capacity "
                              "(0 = live-count bucket); align cost is "
                              "O(capacity)",
    },
    "ValidatorConfig": {
        "inlier_accept_ratio": "ratio to accept a closure after min checks",
        "inlier_reject_ratio": "ratio to reject a closure after min checks",
        "inlier_chi": "chi2 of an inlier",
        "min_times_checked": "minimum number a closure is checked",
        "partition_expansion_range": "region around a closure endpoint to compute partitions",
        "enabled": "toggle vote-based validation (off = accept gated closures immediately)",
    },
    "RelocalizerConfig": {
        "max_translation": "max translation to attempt a jump",
        "relocalize_max_chi_inliers": "maximum chi per inlier for successful relocalization",
        "relocalize_min_inliers": "minimum number of inliers for successful relocalization",
        "relocalize_min_inliers_ratio": "minimum fraction of inliers out of total correspondences",
    },
    "PGOConfig": {
        "max_iterations": "maximum global GN iterations",
        "epsilon": "ratio of decay of chi2 between iterations",
        "chi_threshold": "Cauchy robustifier threshold on PGO edges (<=0 disables)",
        "damping": "diagonal damping of the dense solve",
        "anchor_weight": "gauge prior weight on fixed variables",
        "algorithm": "iteration algorithm: gn | lm (the reference's GN/LM slot)",
        "lm_lambda_init": "initial LM damping lambda",
        "lm_lambda_factor": "LM lambda multiplier on reject (divider on accept)",
    },
    "GraphSLAMConfig": {
        "local_map_distance": "distance between the centers of local maps [meters]",
        "var_capacity": "static pose-graph variable capacity",
        "edge_capacity": "static pose-graph edge capacity",
        "odom_edge_info": "diagonal information of odometry edges (tx, ty, theta)",
        "closure_edge_info": "diagonal information of closure edges",
        "tracker": "incremental tracker assembly",
        "detector": "loop detector assembly",
        "validator": "closure validator",
        "relocalizer": "relocalizer",
        "global_solver": "global pose-graph solver",
        "global_solver_kind": "global linear solver: dense | cg | schur",
        "schur_partitions": "partition count of the Schur solver",
        "enable_loop_closure": "toggle loop closing",
        "enable_relocalizer": "toggle relocalization",
        "enable_closure_merger": "fuse the query map into the candidate map on accepted closures",
        "closure_merge_max_distance2": "closure merger max squared point distance [m^2]",
        "closure_merge_target": "closure merger target number of merges",
        "closure_merge_binning": "closure merger point binning (distribution homogenization)",
        "cue_extrinsics": "per-cue sensor-in-robot poses; enables multi-cue tracking",
        "use_fast_tracker": "track through the fused frame kernel (lazy scene materialization)",
        "fast_canvas_meas": "fast-tracker measurement layout: pre-z-buffered canvases (fast) vs raw rows (bit-exact parity oracle)",
    },
}


def register(cls: type, docs: dict[str, str] | None = None) -> type:
    """Register a dataclass (or NamedTuple) as a configurable type, with
    the docs of its fields."""
    _REGISTRY[cls.__name__] = cls
    if docs:
        _FIELD_DOCS[cls.__name__] = docs
    return cls


def _register_port_classes() -> None:
    """Register every configuration class of the port's SLAM path (imported
    lazily: the models import nothing of this module)."""
    if "GraphSLAMConfig" in _REGISTRY:
        return
    from ..models import loop_closure, preprocessor, slam, tracker
    from ..ops import icp
    from ..ops.projector import PolarProjection
    from ..solver import pgo

    for cls in (
        preprocessor.PreprocessorConfig, icp.AlignerConfig,
        tracker.TrackerConfig, loop_closure.LoopDetectorConfig,
        loop_closure.ValidatorConfig, loop_closure.RelocalizerConfig,
        pgo.PGOConfig, slam.GraphSLAMConfig, PolarProjection,
    ):
        register(cls, _PORT_DOCS.get(cls.__name__))


def registry() -> dict[str, type]:
    _register_port_classes()
    return dict(_REGISTRY)


def describe(cls_or_name) -> list[dict]:
    """Parameter sheet: name, type, default and doc of every field."""
    _register_port_classes()
    cls = _REGISTRY[cls_or_name] if isinstance(cls_or_name, str) else cls_or_name
    docs = _FIELD_DOCS.get(cls.__name__, {})
    out = []
    for f in dataclasses.fields(cls):
        default: Any = f.default
        if default is dataclasses.MISSING and f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        out.append({"name": f.name, "type": getattr(f.type, "__name__", str(f.type)),
                    "default": default, "doc": docs.get(f.name, "")})
    return out


def _is_component(obj) -> bool:
    return dataclasses.is_dataclass(obj) and type(obj).__name__ in _REGISTRY


class ConfigManager:
    """Named-object manager with object-graph JSON round-trip."""

    def __init__(self):
        self._objects: dict[int, Any] = {}
        self._names: dict[str, int] = {}
        self._next_id = 1

    def create(self, class_name: str, name: str | None = None, **overrides):
        """A registered class built with ``overrides``, added under ``name``."""
        _register_port_classes()
        return self.add(_REGISTRY[class_name](**overrides), name)

    def add(self, obj, name: str | None = None):
        oid = self._next_id
        self._next_id += 1
        self._objects[oid] = obj
        if name:
            self._names[name] = oid
        return obj

    def get_by_name(self, name: str):
        oid = self._names.get(name)
        return self._objects.get(oid) if oid is not None else None

    def objects(self):
        return list(self._objects.values())

    def write(self, path: str) -> None:
        """Serialize the object graph; nested components become #pointer
        references, once per distinct object."""
        ids: dict[int, int] = {}
        entries: list[dict] = []

        def assign(obj):
            key = id(obj)
            if key in ids:
                return ids[key]
            oid = len(entries) + 1
            ids[key] = oid
            entry = {"#id": oid, "#class": type(obj).__name__}
            entries.append(entry)
            for f in dataclasses.fields(obj):
                entry[f.name] = encode(getattr(obj, f.name))
            return oid

        def encode(v):
            if _is_component(v):
                return {"#pointer": assign(v)}
            if isinstance(v, tuple) and hasattr(v, "_fields"):
                return {
                    "#namedtuple": type(v).__name__,
                    "values": {k: encode(x) for k, x in zip(v._fields, v)},
                }
            if isinstance(v, tuple):
                return list(v)
            if isinstance(v, (list, dict, str, int, float, bool)) or v is None:
                return v
            raise TypeError(f"unserializable config value {v!r}")

        _register_port_classes()
        roots = {name: assign(self._objects[o]) for name, o in self._names.items()}
        for obj in self._objects.values():
            assign(obj)
        with open(path, "w") as f:
            json.dump({"objects": entries, "names": roots}, f, indent=1)

    @classmethod
    def read(cls, path: str) -> "ConfigManager":
        _register_port_classes()
        with open(path) as f:
            data = json.load(f)
        mgr = cls()
        raw = {e["#id"]: e for e in data["objects"]}
        built: dict[int, Any] = {}

        def build(oid: int):
            if oid in built:
                return built[oid]
            e = raw[oid]
            klass = _REGISTRY[e["#class"]]
            fields = {f.name: f for f in dataclasses.fields(klass)}
            kwargs = {
                k: decode(v, fields[k]) for k, v in e.items()
                if not k.startswith("#") and k in fields
            }
            built[oid] = klass(**kwargs)
            return built[oid]

        def decode(v, field):
            if isinstance(v, dict) and "#pointer" in v:
                return build(v["#pointer"])
            if isinstance(v, dict) and "#namedtuple" in v:
                nt_cls = _REGISTRY[v["#namedtuple"]]
                return nt_cls(**{k: decode(x, field) for k, x in v["values"].items()})
            if isinstance(v, list):
                if "tuple" in str(field.type).lower() or isinstance(field.default, tuple):
                    return tuple(v)
            return v

        for oid in raw:
            build(oid)
        for obj in built.values():
            mgr.add(obj)
        for name, oid in data.get("names", {}).items():
            mgr._names[name] = next(
                k for k, o in mgr._objects.items() if o is built[oid]
            )
        return mgr
