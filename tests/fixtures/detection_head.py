"""torchvision Faster R-CNN R50-FPN's second stage as an ONNX graph, for
either package.

``fasterrcnn_resnet50_fpn`` inference after the backbone and the RPN head,
at its published widths (:data:`FULL`; torchvision
``models/detection/faster_rcnn.py``'s defaults, ``roi_heads.py``'s
``postprocess_detections``, ``poolers.py``'s ``LevelMapper``,
``_utils.py``'s ``BoxCoder``), weights random from a seed (nothing is
fetched). The graph, opset 16, built by the caller's ``GraphBuilder``
(:func:`head_graph`; the nodes of steps 1, 2 and 8 are named ``rpn_nms``,
``roi_align`` and ``box_nms``):

1. ``NonMaxSuppression`` of the 1,000 proposals (``rpn.pre_nms_top_n_test``)
   by their objectness, IoU 0.7, ``max_out`` 1,000
   (``post_nms_top_n_test``): ``rows1`` ``[1000, 3]``, ``-1`` rows unused;
2. the kept proposals gathered (the batch column as ``batch_indices``),
   ``RoiAlign`` 7 x 7, ``sampling_ratio`` 2, ``spatial_scale`` 1/16,
   ``output_half_pixel`` (``aligned=False``) over the FPN level P4:
   ``pooled`` ``[1000, 256, 7, 7]``;
3. ``TwoMLPHead``: flatten, ``Gemm`` 12,544 -> 1,024, ``Relu``, ``Gemm``
   1,024 -> 1,024, ``Relu``;
4. ``FastRCNNPredictor``: ``Gemm`` -> 91 class logits, ``Softmax``;
   ``Gemm`` -> 364 box deltas;
5. the ``BoxCoder`` decode, weights (10, 10, 5, 5), dw and dh clamped at
   log(1000 / 16), then clipped to the 800 x 1,066 image;
6. the background class dropped;
7. the unused rows of step 1 given class score 0 (``Where`` on their -1);
8. ``NonMaxSuppression`` with the 90 classes as the batch axis (boxes
   ``[90, 1000, 4]``), IoU 0.5, score threshold 0.05
   (``box_score_thresh``), ``max_out`` 100: ``rows2`` ``[9000, 3]``;
9. the kept scores by ``GatherND`` (``-1`` rows set to -inf), ``TopK`` 100
   (``box_detections_per_img``), the boxes, labels (class + 1) and rows
   gathered: ``det_boxes``, ``det_scores``, ``det_labels``, ``det_rows``.

The one difference from torchvision's path: ``remove_small_boxes`` (a
data-dependent filter) is left out.

The inputs (:func:`inputs`, from :data:`INPUT_SEED`): one 640 x 480 COCO
image resized to ``min_size`` 800 (800 x 1,066) and padded to a multiple
of 32 (800 x 1,088); its P4 ``[1, 256, 50, 68]``; 1,000 proposals drawn
as jittered clusters with sqrt(area) in [224, 448), which ``LevelMapper``
(canonical level 4, scale 224) sends to P4 every one, so pooling them from
one level is ``MultiScaleRoIAlign``'s result; objectness uniform in (0, 1).
:data:`LOGIT_SCALE` scales the class logits' weights so that between 200
and 2,000 (proposal, class) pairs clear 0.05. :data:`SMALL` is the tier-1
tests' width. ``tests/fixtures/make_detection_fixture.py`` writes the JAX
package's full-width outputs into ``detection_head_io.npz``. This module
imports neither package and no JAX.
"""
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "detection_head_io.npz")
FULL = dict(channels=256, pool=7, proposals=1000, classes=91, mlp=1024,
            feature_hw=(50, 68))
SMALL = dict(channels=32, pool=7, proposals=64, classes=8, mlp=16,
             feature_hw=(50, 68))
IMAGE_HW = (800, 1066)        # the resized image; padded to 800 x 1088
SPATIAL_SCALE = 1.0 / 16      # P4's stride
SAMPLING_RATIO = 2
RPN_NMS_IOU = 0.7
BOX_NMS_IOU = 0.5
SCORE_THRESH = 0.05
DETECTIONS = 100
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
BOX_CLIP = math.log(1000.0 / 16)
LOGIT_SCALE = 2.5
WEIGHT_SEED = 0
INPUT_SEED = 1
OPSET = 16
INPUTS = ("features", "proposals", "objectness")
OUTPUTS = ("rows1", "pooled", "rows2", "det_boxes", "det_scores",
           "det_labels", "det_rows")
NEAR = 1e-5                   # a score or IoU this close to a threshold is a near-tie


def inputs(cfg: dict = FULL, seed: int = INPUT_SEED) -> dict:
    """P4 features, proposals ``[1, R, 4]`` (x1, y1, x2, y2) and
    objectness ``[1, 1, R]``, float32."""
    rng = np.random.default_rng(seed)
    c, (fh, fw), r = cfg["channels"], cfg["feature_hw"], cfg["proposals"]
    features = rng.standard_normal((1, c, fh, fw), dtype=np.float32)
    ih, iw = IMAGE_HW
    n_obj = max(4, r // 5)
    side = rng.uniform(240, 430, n_obj)
    aspect = rng.uniform(0.5, 2.0, n_obj)
    cx = rng.uniform(0, 1, n_obj)
    cy = rng.uniform(0, 1, n_obj)
    pick = rng.integers(0, n_obj, r)
    s = np.clip(side[pick] * np.exp(rng.normal(0, 0.05, r)), 225.0, 447.0)
    a = np.clip(aspect[pick] * np.exp(rng.normal(0, 0.05, r)), 0.5, 2.0)
    w, h = s * np.sqrt(a), s / np.sqrt(a)
    ow = side[pick] * np.sqrt(aspect[pick])     # the object's own box
    oh = side[pick] / np.sqrt(aspect[pick])
    x0 = ow / 2 + cx[pick] * (iw - ow) + rng.normal(0, 0.12, r) * w
    y0 = oh / 2 + cy[pick] * (ih - oh) + rng.normal(0, 0.12, r) * h
    x0 = np.clip(x0, w / 2, iw - w / 2)
    y0 = np.clip(y0, h / 2, ih - h / 2)
    proposals = np.stack([x0 - w / 2, y0 - h / 2, x0 + w / 2, y0 + h / 2],
                         -1)[None].astype(np.float32)
    objectness = rng.uniform(0, 1, (1, 1, r)).astype(np.float32)
    return {"features": features, "proposals": proposals,
            "objectness": objectness}


def parameters(cfg: dict = FULL, seed: int = WEIGHT_SEED) -> dict:
    """The two MLP layers' and the predictor's weights, ``[out, in]``."""
    rng = np.random.default_rng(seed)
    d_in = cfg["channels"] * cfg["pool"] ** 2
    mlp, k = cfg["mlp"], cfg["classes"]

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    return {"fc6_w": normal((mlp, d_in), math.sqrt(2.0 / d_in)),
            "fc6_b": normal((mlp,), 0.01),
            "fc7_w": normal((mlp, mlp), math.sqrt(2.0 / mlp)),
            "fc7_b": normal((mlp,), 0.01),
            "cls_w": normal((k, mlp), LOGIT_SCALE / math.sqrt(mlp)),
            "cls_b": normal((k,), 0.01),
            "box_w": normal((4 * k, mlp), 1.0 / math.sqrt(mlp)),
            "box_b": normal((4 * k,), 0.01)}


def head_graph(graph_cls, cfg: dict = FULL) -> bytes:
    """The second stage's graph (steps 1-9 above) with ``graph_cls``."""
    g = graph_cls(opset=OPSET)
    c, (fh, fw), r = cfg["channels"], cfg["feature_hw"], cfg["proposals"]
    k, pool = cfg["classes"], cfg["pool"]
    f32, i64 = np.float32, np.int64
    g.add_input("features", f32, [1, c, fh, fw])
    g.add_input("proposals", f32, [1, r, 4])
    g.add_input("objectness", f32, [1, 1, r])
    for name, a in parameters(cfg).items():
        g.add_initializer(name, a)
    for name, a in (("rpn_max", np.array([r], i64)),
                    ("rpn_iou", np.array([RPN_NMS_IOU], f32)),
                    ("det_max", np.array([DETECTIONS], i64)),
                    ("box_iou", np.array([BOX_NMS_IOU], f32)),
                    ("score_thresh", np.array([SCORE_THRESH], f32)),
                    ("topk", np.array([DETECTIONS], i64)),
                    ("col0", np.array(0, i64)), ("col2", np.array(2, i64)),
                    ("zero_i", np.array(0, i64)), ("one_i", np.array(1, i64)),
                    ("zero_f", np.array(0.0, f32)),
                    ("neg_inf", np.array(-np.inf, f32)),
                    ("half", np.array(0.5, f32)),
                    ("w_xy", np.array(BOX_WEIGHTS[0], f32)),
                    ("w_wh", np.array(BOX_WEIGHTS[2], f32)),
                    ("box_clip", np.array(BOX_CLIP, f32)),
                    ("img_w", np.array(IMAGE_HW[1], f32)),
                    ("img_h", np.array(IMAGE_HW[0], f32)),
                    ("shape_r4", np.array([r, 4], i64)),
                    ("shape_r14", np.array([r, 1, 4], i64)),
                    ("shape_rk4", np.array([r, k, 4], i64)),
                    ("fg_start", np.array([1], i64)),
                    ("fg_end", np.array([k], i64)), ("ax1", np.array([1], i64)),
                    ("c0s", np.array([0], i64)), ("c1s", np.array([1], i64)),
                    ("c2s", np.array([2], i64)), ("c3s", np.array([3], i64))):
        g.add_initializer(name, a)

    def node(op, ins, **attrs):
        return g.add_node(op, ins, **attrs)

    # 1. the RPN's NMS
    g.add_node("NonMaxSuppression", ["proposals", "objectness", "rpn_max",
                                     "rpn_iou"], outputs=["rows1"],
               name="rpn_nms")
    # 2. kept proposals, RoiAlign over P4
    keep = node("Gather", ["rows1", "col2"], axis=1)
    batch = node("Gather", ["rows1", "col0"], axis=1)
    rois = node("Gather", [node("Reshape", ["proposals", "shape_r4"]), keep],
                axis=0)
    g.add_node("RoiAlign", ["features", rois, batch], outputs=["pooled"],
               name="roi_align",
               output_height=pool, output_width=pool,
               sampling_ratio=SAMPLING_RATIO, spatial_scale=SPATIAL_SCALE,
               coordinate_transformation_mode="output_half_pixel")
    # 3. TwoMLPHead
    h = node("Flatten", ["pooled"], axis=1)
    h = node("Relu", [node("Gemm", [h, "fc6_w", "fc6_b"], transB=1)])
    h = node("Relu", [node("Gemm", [h, "fc7_w", "fc7_b"], transB=1)])
    # 4. FastRCNNPredictor
    probs = node("Softmax", [node("Gemm", [h, "cls_w", "cls_b"], transB=1)],
                 axis=1)
    deltas = node("Reshape", [node("Gemm", [h, "box_w", "box_b"], transB=1),
                              "shape_rk4"])
    # 5. BoxCoder.decode, clipped to the image
    dx, dy, dw, dh = node("Split", [deltas], outputs=[
        g.fresh("d") for _ in range(4)], axis=2)
    dx, dy = node("Div", [dx, "w_xy"]), node("Div", [dy, "w_xy"])
    dw = node("Min", [node("Div", [dw, "w_wh"]), "box_clip"])
    dh = node("Min", [node("Div", [dh, "w_wh"]), "box_clip"])
    x1, y1, x2, y2 = node("Split", [node("Reshape", [rois, "shape_r14"])],
                          outputs=[g.fresh("r") for _ in range(4)], axis=2)
    widths, heights = node("Sub", [x2, x1]), node("Sub", [y2, y1])
    ctr_x = node("Add", [x1, node("Mul", ["half", widths])])
    ctr_y = node("Add", [y1, node("Mul", ["half", heights])])
    pcx = node("Add", [node("Mul", [dx, widths]), ctr_x])
    pcy = node("Add", [node("Mul", [dy, heights]), ctr_y])
    half_w = node("Mul", ["half", node("Mul", [node("Exp", [dw]), widths])])
    half_h = node("Mul", ["half", node("Mul", [node("Exp", [dh]), heights])])
    corners = [node("Clip", [node(op, [ctr, half]), "zero_f", limit])
               for op, ctr, half, limit in (
                   ("Sub", pcx, half_w, "img_w"), ("Sub", pcy, half_h, "img_h"),
                   ("Add", pcx, half_w, "img_w"), ("Add", pcy, half_h, "img_h"))]
    boxes = node("Concat", corners, axis=2)                      # [R, K, 4]
    # 6-7. the foreground classes; unused rows of step 1 score 0
    fg_boxes = node("Slice", [boxes, "fg_start", "fg_end", "ax1"])
    fg_scores = node("Slice", [probs, "fg_start", "fg_end", "ax1"])
    unused = node("Unsqueeze", [node("Less", [keep, "zero_i"]), "ax1"])
    fg_scores = node("Where", [unused, "zero_f", fg_scores])
    # 8. per-class NMS, the classes as the batch axis
    b2 = node("Transpose", [fg_boxes], perm=[1, 0, 2])           # [K-1, R, 4]
    s2 = node("Unsqueeze", [node("Transpose", [fg_scores], perm=[1, 0]),
                            "ax1"])                              # [K-1, 1, R]
    g.add_node("NonMaxSuppression", [b2, s2, "det_max", "box_iou",
                                     "score_thresh"], outputs=["rows2"],
               name="box_nms")
    # 9. the 100 best kept scores, their boxes and labels
    kept = node("GatherND", [s2, "rows2"])
    empty = node("Less", [node("Gather", ["rows2", "col0"], axis=1), "zero_i"])
    kept = node("Where", [empty, "neg_inf", kept])
    g.add_node("TopK", [kept, "topk"], outputs=["det_scores", "top_idx"],
               axis=0)
    g.add_node("Gather", ["rows2", "top_idx"], outputs=["det_rows"], axis=0)
    pair = node("Concat", [node("Slice", ["det_rows", "c0s", "c1s", "ax1"]),
                           node("Slice", ["det_rows", "c2s", "c3s", "ax1"])],
                axis=1)
    g.add_node("GatherND", [b2, pair], outputs=["det_boxes"])
    g.add_node("Add", [node("Gather", ["det_rows", "col0"], axis=1), "one_i"],
               outputs=["det_labels"])
    for name in OUTPUTS:
        g.add_output(name, np.float32, None)
    return g.to_bytes()


def flops(cfg: dict = FULL) -> float:
    """Multiply-adds x 2 of the four ``Gemm``s at ``cfg``'s width."""
    r, d_in = cfg["proposals"], cfg["channels"] * cfg["pool"] ** 2
    mlp, k = cfg["mlp"], cfg["classes"]
    return 2.0 * r * (d_in * mlp + mlp * mlp + mlp * k + mlp * 4 * k)


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two (x1, y1, x2, y2) boxes, in float64."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = iw * ih
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def near_ties(out: dict) -> set:
    """The (label, slot) detections of ``out`` that sit at a tie: a score
    within :data:`NEAR` of the score threshold or of the 100th score, or a
    box whose IoU with another detection of its label is within
    :data:`NEAR` of the NMS threshold."""
    used = out["det_rows"][:, 2] >= 0
    labels, slots = out["det_labels"][used], out["det_rows"][used, 2]
    scores, boxes = out["det_scores"][used], out["det_boxes"][used]
    last = scores.min() if len(scores) == DETECTIONS else -np.inf
    ties = set()
    for i in range(len(labels)):
        near = (abs(scores[i] - SCORE_THRESH) <= NEAR
                or abs(scores[i] - last) <= NEAR)
        for j in range(len(labels)):
            if j != i and labels[j] == labels[i]:
                near |= abs(_iou(boxes[i], boxes[j]) - BOX_NMS_IOU) <= NEAR
        if near:
            ties.add((int(labels[i]), int(slots[i])))
    return ties


def held(got: dict, want: dict, box_tol: float) -> dict:
    """The detections of ``got`` against ``want`` (dicts of
    :data:`OUTPUTS` as numpy): the same (label, slot) pairs but where a
    pair is a near-tie in either run (counted); matched pairs' boxes within
    ``box_tol`` of the largest |coordinate| and scores within 1e-5 of the
    largest."""
    def pairs(out):           # the used rows (a -1 row is a slot left empty)
        return {(int(lab), int(s)): i for i, (lab, s) in enumerate(
            zip(out["det_labels"], out["det_rows"][:, 2])) if s >= 0}

    g, w = pairs(got), pairs(want)
    differing = set(g) ^ set(w)
    ties = near_ties(got) | near_ties(want)
    untied = differing - ties
    both = sorted(set(g) & set(w))
    gi, wi = [g[p] for p in both], [w[p] for p in both]
    span = float(np.abs(want["det_boxes"]).max())
    box_err = float(np.abs(got["det_boxes"][gi] - want["det_boxes"][wi]).max()
                    ) if both else 0.0
    score_err = float(np.abs(got["det_scores"][gi] - want["det_scores"][wi]
                             ).max()) if both else 0.0
    return {"ok": not untied and box_err <= box_tol * span
            and score_err <= NEAR, "matched": len(both),
            "differing": len(differing), "near_ties": len(differing & ties),
            "untied": sorted(untied)[:10], "box_err": box_err,
            "box_bound": box_tol * span, "score_err": score_err}
