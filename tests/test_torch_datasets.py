"""The port's copies of the JAX package's dataset code, held equal to it:
`data/datasets/kitti_3d.py` (calibration, labels, every entry of
DATASET_DICTS_BUILDER that the fixture's train split serves, metadata),
`structures/pose.py`, `data/samplers.py`, `data/catalog.py` and
`utils/tasks.py`. Exact equality: the same numpy code on the same inputs.
"""
import numpy as np
import pytest

from dd3d_tpu.configs import get_experiment_cfg as jax_experiment_cfg
from dd3d_tpu.data import catalog as jcatalog
from dd3d_tpu.data import samplers as jsamplers
from dd3d_tpu.data.datasets import kitti_3d as jkitti
from dd3d_tpu.structures.pose import Pose as JaxPose
from dd3d_tpu.utils.tasks import TaskManager as JaxTaskManager
from dd3d_tpu_torch.configs import get_experiment_cfg
from dd3d_tpu_torch.data import catalog
from dd3d_tpu_torch.data import samplers
from dd3d_tpu_torch.data.datasets import kitti_3d
from dd3d_tpu_torch.overfit_smoke import make_fixture
from dd3d_tpu_torch.structures.pose import Pose
from dd3d_tpu_torch.utils.tasks import TaskManager

TRAIN_SPLIT_DATASETS = [n for n, (split, _, _) in kitti_3d.DATASET_DICTS_BUILDER.items() if split == "train"]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("kitti")), n_images=8)


def test_builder_tables_match():
    assert kitti_3d.DATASET_DICTS_BUILDER == jkitti.DATASET_DICTS_BUILDER
    assert kitti_3d.VALID_CLASS_NAMES == jkitti.VALID_CLASS_NAMES
    assert len(TRAIN_SPLIT_DATASETS) == 4


@pytest.mark.parametrize("name", TRAIN_SPLIT_DATASETS)
def test_kitti_dicts_equal_jax(fixture_root, name):
    cfg = get_experiment_cfg("dd3d_kitti_dla34_overfit")
    cfg.DATASET_ROOT = fixture_root
    jcfg = jax_experiment_cfg("dd3d_kitti_dla34_overfit")
    jcfg.DATASET_ROOT = fixture_root
    assert name in catalog.register_datasets(cfg)
    jcatalog.register_datasets(jcfg)
    got, want = catalog.DatasetCatalog.get(name), jcatalog.DatasetCatalog.get(name)
    assert len(got) == len(want) == 8
    assert got == want
    assert got[0]["width"] == 1242 and got[0]["height"] == 375  # from the PNG header
    assert catalog.MetadataCatalog.get(name) == jcatalog.MetadataCatalog.get(name)


def test_calibration_and_labels_equal_jax(fixture_root):
    base = f"{fixture_root}/KITTI3D/training"
    got, want = kitti_3d.read_calibration_file(f"{base}/calib/000003.txt"), \
        jkitti.read_calibration_file(f"{base}/calib/000003.txt")
    assert set(got) == set(want)
    for sensor in got:
        k, pose = got[sensor]
        jk, jpose = want[sensor]
        assert (k is None and jk is None) or np.array_equal(k, jk)
        assert np.array_equal(pose.quat, jpose.quat) and np.array_equal(pose.tvec, jpose.tvec)
    assert kitti_3d.parse_label_file(f"{base}/label_2/000005.txt", kitti_3d.VALID_CLASS_NAMES) == \
        jkitti.parse_label_file(f"{base}/label_2/000005.txt", jkitti.VALID_CLASS_NAMES)


def test_pose_equals_jax():
    rng = np.random.RandomState(0)
    for _ in range(5):
        q, t = rng.randn(4), rng.randn(3)
        q2, t2 = rng.randn(4), rng.randn(3)
        p, jp = Pose(q, t), JaxPose(q, t)
        other, jother = Pose(q2, t2), JaxPose(q2, t2)
        pts = rng.randn(7, 3)
        assert np.array_equal(p.matrix, jp.matrix)
        assert np.array_equal((p * other).matrix, (jp * jother).matrix)
        assert np.array_equal(p.inverse().matrix, jp.inverse().matrix)
        assert np.array_equal(p * pts, jp * pts)
        m = p.matrix
        assert np.array_equal(Pose.from_matrix(m).quat, JaxPose.from_matrix(m).quat)
    with pytest.raises(ValueError):
        Pose.from_matrix(np.eye(3))


def test_samplers_equal_jax(fixture_root):
    cfg = get_experiment_cfg("dd3d_kitti_dla34_overfit")
    cfg.DATASET_ROOT = fixture_root
    catalog.register_datasets(cfg)
    dicts = catalog.DatasetCatalog.get("kitti_3d_train")
    dicts[1]["annotations"] = []  # an image without boxes: repeat factor 1
    dicts[2]["annotations"] = dicts[2]["annotations"] + [dict(dicts[2]["annotations"][0], category_id=2)]
    take = lambda it: [next(it) for _ in range(40)]  # noqa: E731
    assert take(iter(samplers.TrainingSampler(8, seed=3))) == take(iter(jsamplers.TrainingSampler(8, seed=3)))
    assert take(iter(samplers.RepeatFactorTrainingSampler(dicts, 0.4, seed=5))) == \
        take(iter(jsamplers.RepeatFactorTrainingSampler(dicts, 0.4, seed=5)))
    for shard in range(3):
        assert list(samplers.InferenceSampler(10, shard, 3)) == list(jsamplers.InferenceSampler(10, shard, 3))
        assert list(samplers.InferenceGroupSampler(12, 6, shard, 3)) == \
            list(jsamplers.InferenceGroupSampler(12, 6, shard, 3))


def test_task_manager_equals_jax():
    cfg = get_experiment_cfg("dd3d_kitti_dla34")
    for box3d in (True, False):
        cfg.MODEL.BOX3D_ON = box3d
        tm, jtm = TaskManager(cfg), JaxTaskManager(cfg)
        assert (tm.box2d_on, tm.box3d_on, tm.depth_on, tm.has_detection_task, tm.has_dense_depth_task) == \
            (jtm.box2d_on, jtm.box3d_on, jtm.depth_on, jtm.has_detection_task, jtm.has_dense_depth_task)
