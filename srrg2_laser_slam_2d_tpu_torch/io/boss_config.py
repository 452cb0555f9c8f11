"""Reader for the reference's BOSS-format configuration files.
Counterpart of ``srrg2_laser_slam_2d_tpu/io/boss_config.py``, kept as the
port's own copy.

The SRRG2 stack ships complete pipeline assemblies as BOSS text configs
(``stage_segway_double_config_LASER_0.json`` / ``_MULTI.json``): repeated
``"ClassName" { ...json body... }`` blocks with ``#id`` identities and
``{"#pointer": id}`` cross-references. This module parses that format and
translates the object graph into the port's native configs, so a user of the
reference can point the port at their existing tuning and get the equivalent
assembly (aligner / finder / robustifier / merger / clipper / detector /
validator / relocalizer / global-solver parameters all mapped).

The one rule that depends on the device: a MULTI assembly (more than one
laser tracker slice) aligns through the fused multi-cue aligner kernel when
it runs on a CUDA card, through the plain ``align_multi`` on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re

from ..models import loop_closure as lc
from ..models import slam as slam_mod
from ..models import tracker as tracker_mod
from ..models.preprocessor import PreprocessorConfig
from ..ops import icp
from ..ops.projector import PolarProjection
from ..solver import pgo
from ..utils.presets import _on_card

_BLOCK_RE = re.compile(r'"(?P<cls>[A-Za-z0-9_:]+)"\s*\{', re.MULTILINE)


def parse_boss(text: str) -> list[dict]:
    """Split a BOSS config into (class, body-dict) entries."""
    objects = []
    for m in _BLOCK_RE.finditer(text):
        cls = m.group("cls")
        # find the matching closing brace
        depth = 0
        start = m.end() - 1
        for i in range(start, len(text)):
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
                if depth == 0:
                    end = i
                    break
        else:
            raise ValueError(f"unbalanced braces after {cls}")
        body = text[start : end + 1]
        # strip // comments, then parse as JSON
        body = re.sub(r"//[^\n]*", "", body)
        data = json.loads(body)
        data["#class"] = cls
        objects.append(data)
    return objects


class BossGraph:
    def __init__(self, objects: list[dict]):
        self.objects = objects
        self.by_id = {o["#id"]: o for o in objects if "#id" in o}
        self.by_name = {o["name"]: o for o in objects if "name" in o}

    def deref(self, v):
        """Resolve {'#pointer': id} (-1 = null)."""
        if isinstance(v, dict) and "#pointer" in v:
            pid = v["#pointer"]
            return None if pid == -1 else self.by_id.get(pid)
        return v

    def find(self, cls: str) -> list[dict]:
        return [o for o in self.objects if o["#class"] == cls]


def load(path: str) -> BossGraph:
    with open(path) as f:
        return BossGraph(parse_boss(f.read()))


# ---- translation into native configs ---------------------------------------


def _projection_from(g: BossGraph, proj_obj: dict | None) -> PolarProjection:
    if proj_obj is None:
        return PolarProjection.make(721, -math.pi, math.pi, 0.3, 20.0)
    return PolarProjection.make(
        cols=int(proj_obj.get("canvas_cols", 721)),
        angle_min=float(proj_obj.get("angle_col_min", -math.pi)),
        angle_max=float(proj_obj.get("angle_col_max", math.pi)),
        range_min=float(proj_obj.get("range_min", 0.3)),
        range_max=float(proj_obj.get("range_max", 20.0)),
    )


def _aligner_from(g: BossGraph, aligner_obj: dict) -> tuple[icp.AlignerConfig, PolarProjection]:
    """MultiAligner2D (+ its laser slice, finder, robustifier) -> AlignerConfig."""
    max_it = aligner_obj.get("max_iterations", 10)
    min_inl = aligner_obj.get("min_num_inliers", 10)
    point_distance, normal_cos, chi_thr = 0.5, 0.8, 0.05
    proj = None
    has_odom_slice = False
    for sp in aligner_obj.get("slice_processors", []):
        s = g.deref(sp)
        if s is None:
            continue
        cls = s["#class"]
        if cls.startswith("AlignerSliceProcessorLaser"):
            finder = g.deref(s.get("finder"))
            if finder:
                point_distance = float(finder.get("point_distance", point_distance))
                normal_cos = float(finder.get("normal_cos", normal_cos))
                proj = g.deref(finder.get("projector"))
            rob = g.deref(s.get("robustifier"))
            if rob:
                chi_thr = float(rob.get("chi_threshold", chi_thr))
        elif cls == "AlignerSliceOdom2DPrior":
            has_odom_slice = True
    cfg = icp.AlignerConfig(
        max_iterations=int(max_it),
        min_num_inliers=int(min_inl),
        enable_inlier_only_runs=bool(aligner_obj.get("enable_inlier_only_runs", 0)),
        keep_only_inlier_correspondences=bool(
            aligner_obj.get("keep_only_inlier_correspondences", 0)
        ),
        point_distance=point_distance,
        normal_cos=normal_cos,
        chi_threshold=chi_thr,
        odom_weight=1.0 if has_odom_slice else 0.0,
    )
    return cfg, _projection_from(g, proj)


def to_slam_config(g: BossGraph, scene_capacity: int = 8192,
                   var_capacity: int = 1024, edge_capacity: int = 4096,
                   device=None) -> slam_mod.GraphSLAMConfig:
    """Translate a full MultiGraphSLAM2D assembly. A MULTI assembly runs the
    fused multi-cue aligner kernel when ``device`` (None: the default
    device) is a CUDA card; single-cue assemblies keep the flag off."""
    slam_objs = g.find("MultiGraphSLAM2D")
    if not slam_objs:
        raise ValueError("no MultiGraphSLAM2D in config")
    s = slam_objs[0]

    # splitting criterion
    splitter = g.deref(s.get("splitting_criterion"))
    local_map_distance = float(splitter.get("local_map_distance", 1.0)) if splitter else 1.0

    # tracker -> aligner + merger + clipper
    tracker = g.deref(s.get("tracker"))
    aligner_cfg, proj = icp.AlignerConfig(), None
    merge_threshold, clip_vox = 0.2, 0.0
    cue_extr = None
    if tracker:
        al = g.deref(tracker.get("aligner"))
        if al:
            aligner_cfg, proj = _aligner_from(g, al)
        laser_slices = [
            g.deref(sp)
            for sp in tracker.get("slice_processors", [])
            if g.deref(sp) and g.deref(sp)["#class"].startswith("TrackerSliceProcessorLaser")
        ]
        if laser_slices:
            merger = g.deref(laser_slices[0].get("merger"))
            if merger:
                merge_threshold = float(merger.get("merge_threshold", 0.2))
                if proj is None:
                    proj = _projection_from(g, g.deref(merger.get("projector")))
            clipper = g.deref(laser_slices[0].get("clipper"))
            if clipper:
                clip_vox = float(clipper.get("voxelize_resolution", 0.0))
        if len(laser_slices) > 1:
            # MULTI: extrinsics come from the TF tree at runtime; flag the
            # cue count with identity placeholders the runner overrides
            cue_extr = tuple((0.0, 0.0, 0.0) for _ in laser_slices)
    if proj is None:
        proj = _projection_from(g, None)

    # loop detector + selector
    det = g.deref(s.get("loop_detector"))
    det_cfg = lc.LoopDetectorConfig()
    if det:
        sel = g.deref(det.get("local_map_selector"))
        ld_al = g.deref(det.get("relocalize_aligner"))
        ld_aligner = lc.default_ld_aligner()
        if ld_al:
            ld_aligner, _ = _aligner_from(g, ld_al)
            ld_aligner = dataclasses.replace(ld_aligner, odom_weight=0.0)
        det_cfg = lc.LoopDetectorConfig(
            relocalize_min_inliers=int(det.get("relocalize_min_inliers", 300)),
            relocalize_min_inliers_ratio=float(det.get("relocalize_min_inliers_ratio", 0.8)),
            relocalize_max_chi_inliers=float(det.get("relocalize_max_chi_inliers", 0.1)),
            max_local_map_distance=float(sel.get("max_local_map_distance", 1.0)) if sel else 1.0,
            relocalize_range_scale=float(sel.get("relocalize_range_scale", 2.0)) if sel else 2.0,
            aggressive_relocalize_graph_distance=int(
                sel.get("aggressive_relocalize_graph_distance", 10)
            ) if sel else 10,
            aggressive_relocalize_graph_max_range=int(
                sel.get("aggressive_relocalize_graph_max_range", 20)
            ) if sel else 20,
            aggressive_relocalize_range_increase_per_edge=float(
                sel.get("aggressive_relocalize_range_increase_per_edge", 0.05)
            ) if sel else 0.05,
            aligner=ld_aligner,
        )

    # validator
    val = g.deref(s.get("closure_validator"))
    val_cfg = lc.ValidatorConfig()
    if val:
        val_cfg = lc.ValidatorConfig(
            inlier_accept_ratio=float(val.get("inlier_accept_ratio", 0.5)),
            inlier_reject_ratio=float(val.get("inlier_reject_ratio", 0.3)),
            inlier_chi=float(val.get("inlier_chi", 0.05)),
            min_times_checked=int(val.get("min_times_checked", 3)),
            partition_expansion_range=int(val.get("partition_expansion_range", 8)),
        )

    # relocalizer
    rel = g.deref(s.get("relocalizer"))
    rel_cfg = lc.RelocalizerConfig()
    if rel:
        rel_cfg = lc.RelocalizerConfig(
            max_translation=float(rel.get("max_translation", 3.0)),
            relocalize_max_chi_inliers=float(rel.get("relocalize_max_chi_inliers", 0.005)),
            relocalize_min_inliers=int(rel.get("relocalize_min_inliers", 500)),
            relocalize_min_inliers_ratio=float(rel.get("relocalize_min_inliers_ratio", 0.7)),
        )

    # global solver
    gs = g.deref(s.get("global_solver"))
    gs_cfg = pgo.PGOConfig()
    if gs:
        max_its = gs.get("max_iterations", [20])
        term = g.deref(gs.get("termination_criteria"))
        algo = g.deref(gs.get("algorithm"))
        algo_kind = "gn"
        if algo and "LM" in algo.get("#class", ""):
            algo_kind = "lm"
        # robustifier policies -> Cauchy threshold on PGO edges
        # (slam_app.cpp:147-153; RobustifierCauchy default kernel 1.0); the
        # last policy wins
        chi_thr = 0.0
        for pol in gs.get("robustifier_policies", []) or []:
            p = g.deref(pol)
            if p is None:
                continue
            rob = g.deref(p.get("robustifier"))
            chi_thr = float(rob.get("chi_threshold", 1.0)) if rob else 1.0
        gs_cfg = pgo.PGOConfig(
            max_iterations=int(max_its[0] if isinstance(max_its, list) else max_its),
            epsilon=float(term.get("epsilon", 1e-5)) if term else 1e-5,
            algorithm=algo_kind,
            chi_threshold=chi_thr,
        )

    return slam_mod.GraphSLAMConfig(
        local_map_distance=local_map_distance,
        var_capacity=var_capacity,
        edge_capacity=edge_capacity,
        tracker=tracker_mod.TrackerConfig(
            scene_capacity=scene_capacity,
            merge_threshold=merge_threshold,
            clip_voxelize_resolution=clip_vox,
            projection=proj,
            aligner=aligner_cfg,
            # MULTI on a card: the dual-cue alignment is one launch of the
            # multi-cue aligner kernel (csrc/multicue_align_kernel.cu); on the
            # CPU the plain align_multi runs
            use_fused_aligner=cue_extr is not None and _on_card(device),
        ),
        detector=det_cfg,
        validator=val_cfg,
        relocalizer=rel_cfg,
        global_solver=gs_cfg,
        cue_extrinsics=cue_extr,
    )


def to_preprocessor_config(g: BossGraph) -> PreprocessorConfig:
    pres = g.find("RawDataPreprocessorProjective2D")
    if not pres:
        return PreprocessorConfig()
    p = pres[0]
    nc = g.deref(p.get("normal_computator_sliding"))
    return PreprocessorConfig(
        range_min=float(p.get("range_min", 0.0)),
        range_max=float(p.get("range_max", 1000.0)),
        voxelize_resolution=float(p.get("voxelize_resolution", 0.02)),
        normal_point_distance=float(nc.get("normal_point_distance", 0.3)) if nc else 0.3,
        normal_min_points=int(nc.get("normal_min_points", 5)) if nc else 5,
        scan_topic=p.get("scan_topic", "/scan"),
    )
