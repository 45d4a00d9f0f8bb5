"""The faults a serving cell can have, each a wrapper of the program's
serving entry that breaks what it returns or how its NMS decides: for the
harness's own tests, which must see `correct` come out false, and for
`readings.py`, which reads them at the cell's own size."""
import torch

from harness import program


def half_batch_left_out(infer):
    """The second half of every batch never served: no detection there."""
    def broken(*args):
        det = infer(*args)
        valid = det["valid"].clone()
        valid[valid.shape[0] // 2:] = False
        return dict(det, valid=valid)
    return broken


def answer_altered(infer):
    """Each answer altered where it is produced: every detection's class
    one off, as an off-by-one in the decode's (location, class) split makes
    it."""
    def broken(*args):
        det = infer(*args)
        classes = det["classes"]
        return dict(det, classes=torch.where(classes > 0, classes - 1, classes + 1))
    return broken


def answers_one_image_off(infer):
    """The batch's answers written one image off, as an indexing error in a
    batched write makes them: every answer is a real answer, of another
    frame."""
    def broken(*args):
        det = infer(*args)
        return {k: torch.roll(v, 1, dims=0) for k, v in det.items()}
    return broken


def _nms(change):
    def fault(infer):
        def broken(*args):
            with program.nms_arguments(change):
                return infer(*args)
        return broken
    return fault


# IoU never exceeds 1: nothing is suppressed
nms_skipped = _nms(lambda boxes, scores, classes, t: (boxes, scores, classes, 1.0))
nms_skipped.__name__ = "nms_skipped"
# NMS_THRESH read as the common default 0.5
nms_threshold_changed = _nms(lambda boxes, scores, classes, t: (boxes, scores, classes, 0.5))
nms_threshold_changed.__name__ = "nms_threshold_changed"
# every candidate one class: boxes suppress across classes
nms_across_classes = _nms(lambda boxes, scores, classes, t: (boxes, scores, torch.zeros_like(classes), t))
nms_across_classes.__name__ = "nms_across_classes"

# Faults that the committed cells' traffic barely exercises, read and not asserted: with random
# weights one class wins whole regions of a frame, so boxes of two classes seldom overlap past
# NMS_THRESH, and suppression across classes changes a few answers a sample, no more than
# rounding does (PERF.md).
WITHIN_ROUNDING = ("nms_across_classes",)
FAULTS = {f.__name__: f for f in (half_batch_left_out, answer_altered, answers_one_image_off, nms_skipped,
                                  nms_threshold_changed, nms_across_classes)}
