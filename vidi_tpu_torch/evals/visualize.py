"""Character-grounding visualization: draw (interpolated) bbox tubes on
video (a copy of vidi_tpu/evals/visualize.py for the port).

Behavior-matched to the reference's optional cv2 visualization
(reference: VUE_PLOT/character_eval.py:371-566): per-timestamp boxes are
assigned to frames, linearly interpolated between consecutive boxes of the
same speaker when they are <= 2 s apart, drawn with a caption, and written to
an output video. GT and prediction tubes can be drawn in different colors.

Host-side only (cv2); never on the model path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

GT_COLOR = (0, 200, 0)      # BGR green
PRED_COLOR = (0, 0, 230)    # BGR red


def collect_boxes_by_frame(
    segments: Sequence[Dict],
    duration: float,
    fps: float,
    frame_count: int,
    width: int,
    height: int,
    color: Tuple[int, int, int],
    caption_prefix: str,
    boxes_by_frame: Dict[int, List[Dict]],
    interpolate: bool = False,
) -> None:
    """segments: [{"text": str, "boxes": [{"timestamp", "box_2d": [x0,y0,x1,y1]}]}].

    Timestamps <= 1.0 are duration-normalized; coordinates <= 1.0 are
    pixel-normalized (character_eval.py:377-381 conventions). When
    `interpolate`, boxes of the same speaker <= 2 s apart are linearly
    interpolated per frame (character_eval.py:403-440).
    """
    all_boxes = []
    for seg in segments:
        for box in seg["boxes"]:
            ts = box["timestamp"]
            if ts <= 1.0:
                ts *= duration
            x0, y0, x1, y1 = box["box_2d"]
            if max(x0, y0, x1, y1) <= 1.0:
                x0, y0, x1, y1 = x0 * width, y0 * height, x1 * width, y1 * height
            frame = int(ts * fps)
            data = {"x0": x0, "y0": y0, "x1": x1, "y1": y1, "color": color,
                    "caption": caption_prefix, "frame": frame,
                    "speaker": seg.get("text", "")}
            all_boxes.append(data)
            if frame < frame_count:
                boxes_by_frame.setdefault(frame, []).append(data)

    if not interpolate:
        return
    by_speaker: Dict[str, List[Dict]] = {}
    for b in all_boxes:
        by_speaker.setdefault(b["speaker"], []).append(b)
    for boxes in by_speaker.values():
        boxes.sort(key=lambda x: x["frame"])
        for cur, nxt in zip(boxes, boxes[1:]):
            fd = nxt["frame"] - cur["frame"]
            if fd <= 0 or fd / fps > 2.0:
                continue
            for f in range(cur["frame"] + 1, nxt["frame"]):
                if f >= frame_count:
                    break
                a = (f - cur["frame"]) / fd
                interp = {
                    "x0": cur["x0"] + a * (nxt["x0"] - cur["x0"]),
                    "y0": cur["y0"] + a * (nxt["y0"] - cur["y0"]),
                    "x1": cur["x1"] + a * (nxt["x1"] - cur["x1"]),
                    "y1": cur["y1"] + a * (nxt["y1"] - cur["y1"]),
                    "color": cur["color"], "caption": cur["caption"],
                    "frame": f, "speaker": cur["speaker"],
                }
                boxes_by_frame.setdefault(f, []).append(interp)


def draw_tubes_video(
    video_path: str,
    out_path: str,
    pred_segments: Sequence[Dict],
    gt_segments: Optional[Sequence[Dict]] = None,
    interpolate: bool = True,
    max_frames: Optional[int] = None,
) -> int:
    """Render prediction (red) and GT (green) tubes onto the video.
    Returns the number of frames written."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    duration = n / fps if fps else 0.0

    boxes_by_frame: Dict[int, List[Dict]] = {}
    collect_boxes_by_frame(pred_segments, duration, fps, n, w, h,
                           PRED_COLOR, "pred", boxes_by_frame, interpolate)
    if gt_segments:
        collect_boxes_by_frame(gt_segments, duration, fps, n, w, h,
                               GT_COLOR, "gt", boxes_by_frame, interpolate)

    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    written = 0
    idx = 0
    limit = min(n, max_frames) if max_frames else n
    while idx < limit:
        ok, frame = cap.read()
        if not ok:
            break
        for b in boxes_by_frame.get(idx, []):
            p0 = (int(b["x0"]), int(b["y0"]))
            p1 = (int(b["x1"]), int(b["y1"]))
            cv2.rectangle(frame, p0, p1, b["color"], 2)
            cv2.putText(frame, f"{b['caption']}: {b['speaker'][:40]}",
                        (p0[0], max(p0[1] - 6, 12)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, b["color"], 1)
        writer.write(frame)
        written += 1
        idx += 1
    writer.release()
    cap.release()
    return written
