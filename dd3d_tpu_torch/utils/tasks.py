"""TaskManager: task gating flags derived from MODEL.*_ON; the port's own
copy of dd3d_tpu/utils/tasks.py.

Rebuild of `tridet/utils/tasks.py:37-97`: the flags gate mapper/dataloader/
evaluator behavior (used at tridet/data/build.py:33-36 and
dataset_mapper.py:167-177).
"""


class TaskManager:
    def __init__(self, cfg):
        self._box2d_on = bool(cfg.MODEL.BOX2D_ON)
        self._box3d_on = bool(cfg.MODEL.BOX3D_ON)
        self._depth_on = bool(cfg.MODEL.DEPTH_ON)
        if self._box3d_on and not self._box2d_on:
            raise ValueError("BOX3D_ON requires BOX2D_ON (FCOS2D drives the 3D head).")

    @property
    def box2d_on(self):
        return self._box2d_on

    @property
    def box3d_on(self):
        return self._box3d_on

    @property
    def depth_on(self):
        return self._depth_on

    @property
    def has_detection_task(self):
        return self._box2d_on or self._box3d_on

    @property
    def has_dense_depth_task(self):
        return self._depth_on
