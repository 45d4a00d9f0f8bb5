"""Experiment deltas over defaults, mirroring `configs/experiments/*.yaml`: the
port's own copy of dd3d_tpu/configs/experiments.py (tests/test_torch_configs.py
holds the two equal).

Each experiment is a dict merged into the default tree, exactly like the
reference's `@package _global_` Hydra deltas
(e.g. `configs/experiments/dd3d_kitti_dla34.yaml`).
"""
from dd3d_tpu_torch.configs.defaults import get_cfg
from dd3d_tpu_torch.utils.config import CfgNode

# tridet configs/experiments/dd3d_kitti_dla34.yaml
DD3D_KITTI_DLA34 = {
    "FE": {
        "BACKBONE": {"NORM": "FrozenBN"},
        "FPN": {"NORM": "FrozenBN"},
    },
    "DD3D": {
        "FCOS2D": {"NORM": "BN", "INFERENCE": {"NMS_THRESH": 0.75}},
        "FCOS3D": {"NORM": "FrozenBN"},
    },
    "INPUT": {
        "RESIZE": {
            "MIN_SIZE_TRAIN": [288, 304, 320, 336, 352, 368, 384, 400, 416, 448, 480, 512, 544, 576],
            "MAX_SIZE_TRAIN": 10000,
            "MIN_SIZE_TEST": 384,
            "MAX_SIZE_TEST": 100000,
        }
    },
    "SOLVER": {
        "IMS_PER_BATCH": 64,
        "BASE_LR": 0.002,
        "MAX_ITER": 25000,
        "STEPS": [21500, 24000],
        "WARMUP_ITERS": 2000,
        "MIXED_PRECISION_ENABLED": True,
        "CHECKPOINT_PERIOD": 2000,
    },
    "TEST": {
        "IMS_PER_BATCH": 80,
        "EVAL_PERIOD": 2000,
        # final-test TTA, like configs/experiments/dd3d_kitti_dla34.yaml:52-57
        "AUG": {"ENABLED": True, "MIN_SIZES": [320, 384, 448, 512, 576], "MAX_SIZE": 100000, "FLIP": True},
    },
    "DATALOADER": {"TRAIN": {"SAMPLER": "RepeatFactorTrainingSampler", "REPEAT_THRESHOLD": 0.4}},
}

# tridet configs/experiments/dd3d_kitti_dla34_overfit.yaml: 32-image overfit
# smoke experiment (README.md:147-155).
DD3D_KITTI_DLA34_OVERFIT = {
    **DD3D_KITTI_DLA34,
    "DATASETS": {"TRAIN": {"NAME": "kitti_3d_overfit", "NUM_CLASSES": 5}, "TEST": {"NAME": "kitti_3d_overfit"}},
    "SOLVER": {
        **DD3D_KITTI_DLA34["SOLVER"],
        "IMS_PER_BATCH": 8,
        "MAX_ITER": 1500,
        "STEPS": [1300, 1450],
        "WARMUP_ITERS": 100,
        "CHECKPOINT_PERIOD": 10000,
    },
}

# tridet configs/experiments/dd3d_kitti_v99.yaml
DD3D_KITTI_V99 = {
    "FE": {
        "BUILDER": "build_fcos_vovnet_fpn_backbone_p6",
        "BACKBONE": {"NAME": "V-99-eSE", "NORM": "FrozenBN", "OUT_FEATURES": ["stage3", "stage4", "stage5"]},
        "FPN": {"NORM": "FrozenBN", "IN_FEATURES": ["stage3", "stage4", "stage5"]},
        "OUT_FEATURES": ["p3", "p4", "p5", "p6"],
    },
    "DD3D": {
        "FCOS2D": {"NORM": "BN", "INFERENCE": {"NMS_THRESH": 0.75}},
        "FCOS3D": {"NORM": "FrozenBN"},
    },
    "SOLVER": {
        "IMS_PER_BATCH": 64,
        "BASE_LR": 0.002,
        "MAX_ITER": 25000,
        "STEPS": [21500, 24000],
        "WARMUP_ITERS": 2000,
        "MIXED_PRECISION_ENABLED": True,
    },
}

# Shared nuScenes deltas, mirroring the common parts of
# configs/experiments/dd3d_nusc_{dla34,v99}.yaml (+ the nuScenes dataset
# config, configs/train_datasets/nuscenes.yaml).
_NUSC_COMMON = {
    "MODEL": {"META_ARCHITECTURE": "NuscenesDD3D"},
    "DATASETS": {
        "TRAIN": {"NAME": "nusc_train", "NUM_CLASSES": 10},
        "TEST": {"NAME": "nusc_val-subsample-8"},
    },
    "DD3D": {
        "NUM_CLASSES": 10,
        "FCOS2D": {"NORM": "BN", "INFERENCE": {"NMS_THRESH": 0.75}},
        "FCOS3D": {
            "NORM": "FrozenBN",
            # configs/train_datasets/nuscenes.yaml:22-23
            "MEAN_DEPTH_PER_LEVEL": [44.921, 20.252, 11.712, 7.166, 8.548],
            "STD_DEPTH_PER_LEVEL": [24.331, 9.833, 6.223, 4.611, 8.275],
            # configs/train_datasets/nuscenes.yaml:6-19 (width, length, height)
            "CANONICAL_BOX3D_SIZES": [
                [2.3524184, 0.5062202, 1.0413622],   # barrier
                [0.61416006, 1.7016163, 1.3054738],  # bicycle
                [2.9139307, 10.725025, 3.2832346],   # bus
                [1.9751819, 4.641267, 1.74352],      # car
                [2.772134, 6.565072, 3.2474296],     # construction vehicle
                [0.7800532, 2.138673, 1.4437162],    # motorcycle
                [0.6667362, 0.7181772, 1.7616143],   # pedestrian
                [0.40246472, 0.4027083, 1.0084083],  # traffic cone
                [3.0059454, 12.8197, 4.1213827],     # trailer
                [2.4986045, 6.9310856, 2.8382742],   # truck
            ],
        },
        # 6-camera sample-level aggregation + global BEV NMS at inference
        # (nuscenes_dd3d.py:448-465; NUM_IMAGES_PER_SAMPLE/MAX_NUM_DETS=500).
        "INFERENCE": {"NUSC_SAMPLE_AGGREGATE": True, "DO_BEV_NMS": True},
        "NUSC": {
            "MAX_NUM_ATTRIBUTES": 4,
            "LOSS": {"WEIGHT_ATTR": 0.2, "WEIGHT_SPEED": 0.2},
        },
    },
    "INPUT": {
        "RESIZE": {
            # nuScenes images are (900, 1600); dd3d_nusc_*.yaml:38-44
            "MIN_SIZE_TRAIN": [640, 672, 704, 736, 768, 800, 832, 864, 896,
                               928, 960, 992, 1024, 1056, 1088, 1120, 1152],
            "MAX_SIZE_TRAIN": 10000,
            "MIN_SIZE_TEST": 896,
            "MAX_SIZE_TEST": 100000,
        }
    },
    "SOLVER": {
        "IMS_PER_BATCH": 64,
        "BASE_LR": 0.002,
        "MAX_ITER": 120000,
        "STEPS": [100000, 115000],
        "WARMUP_ITERS": 2000,
        "MIXED_PRECISION_ENABLED": True,
        "CHECKPOINT_PERIOD": 2000,
    },
    "TEST": {
        "IMS_PER_BATCH": 96,  # must be a multiple of 6 cameras
        "EVAL_PERIOD": 2000,
        "AUG": {"ENABLED": True, "MIN_SIZES": [640, 768, 896, 1024, 1152], "MAX_SIZE": 100000, "FLIP": True},
    },
    "DATALOADER": {"TRAIN": {"NUM_WORKERS": 12, "SAMPLER": "RepeatFactorTrainingSampler", "REPEAT_THRESHOLD": 0.8}},
}

# tridet configs/experiments/dd3d_nusc_dla34.yaml
DD3D_NUSC_DLA34 = _NUSC_COMMON

# tridet configs/experiments/dd3d_nusc_v99.yaml (V2-99 backbone + FPN-P6,
# eval batch 192 = 6 x 32).
DD3D_NUSC_V99 = {
    **_NUSC_COMMON,
    "FE": {
        "BUILDER": "build_fcos_vovnet_fpn_backbone_p6",
        "BACKBONE": {"NAME": "V-99-eSE", "NORM": "FrozenBN", "OUT_FEATURES": ["stage3", "stage4", "stage5"]},
        "FPN": {"NORM": "FrozenBN", "IN_FEATURES": ["stage3", "stage4", "stage5"]},
        "OUT_FEATURES": ["p3", "p4", "p5", "p6"],
    },
    "TEST": {**_NUSC_COMMON["TEST"], "IMS_PER_BATCH": 192},
}

# tridet configs/experiments/dd3d_kitti_regnety_006_bifpn.yaml — a DEAD
# config upstream (its `regnety_006_bifpn` feature extractor never existed
# there; SURVEY.md §2.3). Implemented for real here: models/regnet.py +
# models/bifpn.py. Solver/input/test blocks mirror the yaml (identical to
# the DLA-34 experiment's), FE block selects the RegNetY-006+BiFPN builder.
DD3D_KITTI_REGNETY_006_BIFPN = {
    **DD3D_KITTI_DLA34,
    "FE": {
        "BUILDER": "build_fcos_regnety_bifpn_backbone",
        "BACKBONE": {"NAME": "RegNetY-006", "NORM": "FrozenBN"},
        "BIFPN": {"NORM": "FrozenBN"},
    },
}

EXPERIMENTS = {
    "dd3d_kitti_dla34": DD3D_KITTI_DLA34,
    "dd3d_kitti_regnety_006_bifpn": DD3D_KITTI_REGNETY_006_BIFPN,
    "dd3d_kitti_dla34_overfit": DD3D_KITTI_DLA34_OVERFIT,
    "dd3d_kitti_v99": DD3D_KITTI_V99,
    "dd3d_nusc_dla34": DD3D_NUSC_DLA34,
    "dd3d_nusc_v99": DD3D_NUSC_V99,
}


def get_experiment_cfg(name: str) -> CfgNode:
    cfg = get_cfg()
    if name not in EXPERIMENTS:
        raise KeyError(f"Unknown experiment {name!r}. Available: {sorted(EXPERIMENTS)}")
    return cfg.merge(EXPERIMENTS[name])
