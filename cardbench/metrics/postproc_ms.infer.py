"""Mean ms of a detection request outside the model's forward:
`fcaf3d_get_bboxes` (top-k, decode, `nms_bev`) and `detections_to_numpy`."""


def read(run):
    if run["mode"] != "infer" or not run["traced"]:
        return None
    s = run["spans"]
    if s.get("request") is None or s.get("forward") is None:
        return None
    return s["request"] - s["forward"]
