"""The faults a rig cell can have, each a wrapper of the program's serving
entry (called as `infer(images, intrinsics, pose_quat, pose_tvec)`) that
breaks what it returns, the poses it is given, or how its BEV NMS decides:
for the harness's own tests, which must see `correct` come out false, and
for `readings_rig.py`, which reads them at the cell's own size."""
import numpy as np

from harness import serve_rig

CAMERAS = 6  # a rig cell's sample
ATTRIBUTES = 4  # DD3D.NUSC.MAX_NUM_ATTRIBUTES


def _bev(change, where):
    def fault(infer):
        def broken(*args):
            with serve_rig.bev_nms_arguments(change, where):
                return infer(*args)
        return broken
    return fault


def _keep_all(iou, valid, threshold):
    return valid


# the sample walk suppresses nothing and keeps past 500: each camera's boxes as its own BEV NMS left them
aggregation_skipped = _bev(lambda args, kw: (args, dict(kw, suppress=_keep_all, max_outputs=0)), ("sample_bev_nms",))
aggregation_skipped.__name__ = "aggregation_skipped"
# BEV_NMS_IOU_THRESH read as 0.5 by both walks
bev_threshold_changed = _bev(lambda args, kw: ((*args[:3], 0.5, *args[4:]), kw), ("dd3d", "sample_bev_nms"))
bev_threshold_changed.__name__ = "bev_threshold_changed"


def identity_poses(infer):
    """The poses never applied: every camera's boxes left in its own frame."""
    def broken(images, intrinsics, pose_quat, pose_tvec):
        quat = np.zeros_like(pose_quat)
        quat[:, 0] = 1.0
        return infer(images, intrinsics, quat, np.zeros_like(pose_tvec))
    return broken


def poses_one_camera_off(infer):
    """Each camera given its neighbour's pose within the sample, as an
    indexing error in a per-camera table makes it."""
    def broken(images, intrinsics, pose_quat, pose_tvec):
        roll = lambda x: np.roll(x.reshape(-1, CAMERAS, x.shape[-1]), 1, axis=1).reshape(x.shape)  # noqa: E731
        return infer(images, intrinsics, roll(pose_quat), roll(pose_tvec))
    return broken


def attributes_one_off(infer):
    """Every attribute one class off, as an off-by-one in the attribute
    head's argmax makes it."""
    def broken(*args):
        det = infer(*args)
        return dict(det, attributes=(det["attributes"] + 1) % ATTRIBUTES)
    return broken


FAULTS = {f.__name__: f for f in (aggregation_skipped, identity_poses, poses_one_camera_off, bev_threshold_changed,
                                  attributes_one_off)}
