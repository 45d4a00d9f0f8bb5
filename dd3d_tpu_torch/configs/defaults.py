"""Default config tree: the port's own copy of dd3d_tpu/configs/defaults.py,
key for key and value for value (tests/test_torch_configs.py holds the two
equal), so that the port never imports the JAX package.

Key names and default values mirror the reference's composed Hydra tree:
- model defaults:      tridet configs/models/dd3d.yaml
- meta-arch defaults:  tridet configs/meta_arch/dd3d.yaml
- FPN defaults:        tridet configs/feature_extractors/d2_fpn.yaml
- solver defaults:     tridet configs/common/optimizer.yaml
- augmentation:        tridet configs/common/augmentation.yaml

TPU-specific additions live under `TPU` (static-shape decode sizes, mesh axes,
bucketed image shapes) — these have no reference analogue because the
reference relies on dynamic shapes (`tridet/modeling/dd3d/fcos2d.py:283-337`).
"""
from dd3d_tpu_torch.utils.config import CfgNode

# (width, length, height) canonical sizes, KITTI classes.
# tridet configs/train_datasets/kitti_3d.yaml
KITTI_CANONICAL_BOX3D_SIZES = [
    [1.61876949, 3.89154523, 1.52969237],  # Car
    [0.62806586, 0.82038497, 1.76784787],  # Pedestrian
    [0.56898187, 1.77149234, 1.7237099],   # Cyclist
    [1.9134491, 5.15499603, 2.18998422],   # Van
    [2.61168401, 9.22692319, 3.36492722],  # Truck
    [0.5390196, 1.08098042, 1.28392158],   # Person_sitting
    [2.36044838, 15.56991038, 3.5289238],  # Tram
    [1.24489164, 2.51495357, 1.61402478],  # Misc
]

KITTI_MEAN_DEPTH_PER_LEVEL = [32.594, 15.178, 8.424, 5.004, 4.662]
KITTI_STD_DEPTH_PER_LEVEL = [14.682, 7.139, 4.345, 2.399, 2.587]


def get_cfg() -> CfgNode:
    return CfgNode.from_dict(
        {
            "MODEL": {
                "META_ARCHITECTURE": "DD3D",
                # BGR order, as in the reference (INPUT.FORMAT: BGR).
                "PIXEL_MEAN": [103.530, 116.280, 123.675],
                "PIXEL_STD": [57.375, 57.120, 58.395],
                "CKPT": "",
                "BOX2D_ON": True,
                "BOX3D_ON": True,
                "DEPTH_ON": False,
            },
            "FE": {
                "BUILDER": "build_fcos_dla_fpn_backbone_p67",
                "BACKBONE": {
                    "NAME": "DLA-34",
                    "OUT_FEATURES": ["level3", "level4", "level5"],
                    "NORM": "BN",
                },
                "FPN": {
                    "IN_FEATURES": ["level3", "level4", "level5"],
                    "OUT_CHANNELS": 256,
                    "NORM": "BN",
                    "FUSE_TYPE": "sum",
                },
                # BiFPN neck (build_fcos_regnety_bifpn_backbone): channel
                # count / cell repeats / norm. The reference's regnety yaml
                # never shipped a feature-extractor config (dead config),
                # so these are this repo's choices (EfficientDet-D1 scale).
                "BIFPN": {
                    "OUT_CHANNELS": 160,
                    "NUM_REPEATS": 3,
                    "NORM": "BN",
                },
                "OUT_FEATURES": ["p3", "p4", "p5", "p6", "p7"],
            },
            "DD3D": {
                "IN_FEATURES": None,  # None -> all backbone outputs
                "NUM_CLASSES": 5,
                "FEATURE_LOCATIONS_OFFSET": "none",
                "SIZES_OF_INTEREST": [64, 128, 256, 512],
                "INFERENCE": {
                    "DO_NMS": True,
                    "DO_POSTPROCESS": True,
                    "DO_BEV_NMS": False,
                    "BEV_NMS_IOU_THRESH": 0.3,
                    "NUSC_SAMPLE_AGGREGATE": False,
                },
                "FCOS2D": {
                    "_VERSION": "v2",
                    "NORM": "BN",
                    "NUM_CLS_CONVS": 4,
                    "NUM_BOX_CONVS": 4,
                    "USE_SCALE": True,
                    "BOX2D_SCALE_INIT_FACTOR": 1.0,
                    "LOSS": {
                        "ALPHA": 0.25,
                        "GAMMA": 2.0,
                        "LOC_LOSS_TYPE": "giou",
                    },
                    "INFERENCE": {
                        "THRESH_WITH_CTR": True,
                        "PRE_NMS_THRESH": 0.05,
                        "PRE_NMS_TOPK": 1000,
                        "POST_NMS_TOPK": 100,
                        "NMS_THRESH": 0.6,
                    },
                },
                "FCOS3D": {
                    "NORM": "BN",
                    "NUM_CONVS": 4,
                    "USE_SCALE": True,
                    "DEPTH_SCALE_INIT_FACTOR": 0.3,
                    "PROJ_CTR_SCALE_INIT_FACTOR": 1.0,
                    "PER_LEVEL_PREDICTORS": False,
                    "SCALE_DEPTH_BY_FOCAL_LENGTHS": True,
                    "SCALE_DEPTH_BY_FOCAL_LENGTHS_FACTOR": 500.0,
                    "MEAN_DEPTH_PER_LEVEL": KITTI_MEAN_DEPTH_PER_LEVEL,
                    "STD_DEPTH_PER_LEVEL": KITTI_STD_DEPTH_PER_LEVEL,
                    "MIN_DEPTH": 0.1,
                    "MAX_DEPTH": 80.0,
                    "CANONICAL_BOX3D_SIZES": KITTI_CANONICAL_BOX3D_SIZES,
                    "CLASS_AGNOSTIC_BOX3D": False,
                    "PREDICT_ALLOCENTRIC_ROT": True,
                    "PREDICT_DISTANCE": False,
                    "LOSS": {
                        "SMOOTH_L1_BETA": 0.05,
                        "MAX_LOSS_PER_GROUP_DISENT": 20.0,
                        "CONF_3D_TEMPERATURE": 1.0,
                        "WEIGHT_BOX3D": 2.0,
                        "WEIGHT_CONF3D": 1.0,
                    },
                    "PREPARE_TARGET": {
                        "CENTER_SAMPLE": True,
                        "POS_RADIUS": 1.5,
                    },
                    "DEPTH_HEAD": {"LOSS_TYPE": "L1", "LOSS_WEIGHT": 1.0},
                },
            },
            "INPUT": {
                "FORMAT": "BGR",
                "AUG_ENABLED": True,
                "RESIZE": {
                    "ENABLED": True,
                    "MIN_SIZE_TRAIN": [288, 304, 320, 336, 352, 368, 384, 400, 416, 448, 480, 512, 544, 576],
                    "MIN_SIZE_TRAIN_SAMPLING": "choice",
                    "MAX_SIZE_TRAIN": 10000,
                    "MIN_SIZE_TEST": 384,
                    "MAX_SIZE_TEST": 100000,
                },
                "CROP": {"ENABLED": False, "TYPE": "relative_range", "SIZE": [0.9, 0.9]},
                "RANDOM_FLIP": {"ENABLED": True, "HORIZONTAL": True, "VERTICAL": False},
                "COLOR_JITTER": {
                    "ENABLED": True,
                    "BRIGHTNESS": [0.2, 0.2],
                    "SATURATION": [0.2, 0.2],
                    "CONTRAST": [0.2, 0.2],
                },
            },
            "DATASETS": {
                "TRAIN": {"NAME": "kitti_3d_train", "NUM_CLASSES": 5},
                "TEST": {"NAME": "kitti_3d_val"},
            },
            "DATALOADER": {
                # USE_PROCESS_POOL: map samples in spawned worker processes
                # (the numpy-heavy transforms are GIL-bound in threads).
                # "auto" = processes when the host has >= 4 cores.
                "TRAIN": {"NUM_WORKERS": 8, "SAMPLER": "TrainingSampler",
                          "REPEAT_THRESHOLD": 0.4, "USE_PROCESS_POOL": "auto"},
                "TEST": {"NUM_WORKERS": 4},
                # Opt-in on-disk cache of DECODED+RESIZED uint8 images (one
                # .npy per (path, mtime, resize-target)), filled by the
                # batched native decode path. PNG inflate is the measured
                # loader floor (~19 ms/img, ROADMAP round-4); a warm cache
                # replaces it with a ~1.4 MB file read. "" = off. Used by
                # the thread-pool loaders (eval always; train when the
                # resize bucket is fixed and crop is off).
                "DECODED_CACHE_DIR": "",
            },
            "SOLVER": {
                "IMS_PER_BATCH": 16,
                "BASE_LR": 0.001,
                "MOMENTUM": 0.9,
                "NESTEROV": False,
                "WEIGHT_DECAY": 0.0001,
                "WEIGHT_DECAY_NORM": 0.0,
                "BIAS_LR_FACTOR": 1.0,
                "GAMMA": 0.1,
                "LR_SCHEDULER_NAME": "WarmupMultiStepLR",
                "STEPS": [30000],
                "MAX_ITER": 40000,
                "WARMUP_FACTOR": 0.0001,
                "WARMUP_ITERS": 2000,
                "WARMUP_METHOD": "linear",
                "CLIP_GRADIENTS": {"ENABLED": False, "CLIP_TYPE": "value", "CLIP_VALUE": 1.0, "NORM_TYPE": 2.0},
                # Flat-vector SGD update (training/optim.py::fused_sgd):
                # identical semantics to the optax chain, ~2000 fewer tiny
                # per-leaf HLO ops per step. False restores the optax chain.
                "FUSED_SGD": True,
                "CHECKPOINT_PERIOD": 5000,
                "MIXED_PRECISION_ENABLED": False,
                "ACCUMULATE_GRAD_BATCHES": 1,
                "SYNCBN_USE_LOCAL_WORKERS": False,
            },
            "TEST": {
                "IMS_PER_BATCH": 8,
                "EVAL_PERIOD": 2000,
                # Compute eval metrics on process 0 only and broadcast the
                # result (the reference's rank-0 gather shape,
                # kitti_3d_evaluator.py:158-161). Default False = symmetric
                # compute on every rank; flip on for large val sets where
                # the N-way duplicated metric engine is real wall clock.
                "RANK0_METRICS": False,
                "AUG": {
                    "ENABLED": False,
                    "MIN_SIZES": [320, 384, 448, 512, 576],
                    "MAX_SIZE": 100000,
                    "FLIP": True,
                },
            },
            # TPU-native knobs (no reference analogue).
            "TPU": {
                # Compute dtype for conv stacks; params always fp32.
                "COMPUTE_DTYPE": "bfloat16",
                # Static candidate count per level taken before NMS (replaces the
                # dynamic nonzero/topk in tridet/modeling/dd3d/fcos2d.py:283-337).
                "PRE_NMS_CANDIDATES_PER_LEVEL": 256,
                # Max padded GT boxes per image for vectorized target assignment.
                "MAX_GT_PER_IMAGE": 64,
                # Run the DLA stem convs in a 2x2 space-to-depth layout
                # (exact rewrite, identical params; see models/s2d.py).
                # False | True | "train" (s2d for the training graph only).
                # Measured on v5e, 384x1280: INFERENCE is faster with the
                # plain stem (20.1 vs 27.4 ms stem region @batch 96 — the 4x
                # FLOP inflation of dense phase-mixing kernels outweighs the
                # MXU utilization gain), but TRAINING is faster with s2d
                # (161.0 vs 154.5 imgs/s @batch 40 — the plain [7,7,3,16]
                # stem weight-gradient is the step's single worst op, ~17 ms
                # at ~1% efficiency; xplane trace in ROADMAP). Hence the
                # default "train": s2d weight-grad layout for training, plain
                # stem for inference. Both stems share one parameter tree.
                "S2D_STEM": "train",
                # Batch-fold the s2d stem onto ONE guard-banded
                # (1, B*(H+G), W, C) row canvas (models/s2d.py
                # fold_batch_rows): removes XLA's batch-minor dW layouts
                # (batch padded to the 128-lane axis) in the stem's
                # weight gradients. Exact (guard rows reproduce zero
                # padding; BN stats rescaled by the valid-row fraction),
                # but measured 1.7x SLOWER on v5e at batch 40 (96.7 vs
                # 162.8 imgs/s): XLA spatially partitions the huge-H
                # canvas convs into 5-D halo-materialized forms (ROADMAP
                # round-4). Kept as a documented dead end; leave False.
                "S2D_STEM_FOLD": False,
                # Run the 7x7 base layer at s2d factor 4 ([3,3,48,256]
                # kernel: full MXU lanes for forward AND weight-gradient,
                # vs the f=2 [5,5,12,64] dW at ~2% MFU) then repack to
                # s2d(2) for level0/level1. Exact rewrite, s2d-stem only —
                # but measured SLOWER on v5e (147.3 vs 162.8 imgs/s at
                # batch 40): the s2d4->s2d2 repack transpose materializes
                # a full-activation copy in fwd AND bwd, and its HBM temp
                # OOMs batch 128. Documented dead end; leave False.
                "S2D_BASE4": False,
                # Pallas slab kernel for the s2d train stem's stride-1
                # weight gradients (ops/pallas_conv.py): attacked the
                # batch-minor [5,5,12,64] dW layout XLA picks (11.5
                # ms/step at batch 40, ROADMAP round-4). MEASURED SLOWER
                # on the v5e (0.85x stem, 0.39x level0 vs XLA's dW;
                # scripts/bench_pallas_dw.py, ROADMAP round-5): a
                # documented dead end like S2D_STEM_FOLD. Leave False.
                "PALLAS_STEM_DW": False,
                # Pack P4..P7 into ONE guard-banded canvas for the shared
                # FCOS head towers/predictors at eval (models/level_pack.py):
                # each tower layer becomes 2 conv calls (P3 + packed) instead
                # of 5, exact numerics. Off until measured on TPU.
                "PACKED_HEADS": False,
                # Same packing for the TRAINING graph (live per-level BN
                # stats from canvas slices; 4 small head-conv dW GEMMs
                # collapse into 1). Off until measured on TPU.
                "PACKED_HEADS_TRAIN": False,
                # Dynamic int8 PTQ for the INFERENCE graph: norm-folded convs
                # with >= QUANT_MIN_CH input channels run int8xint8->int32 on
                # the MXU (v5e int8 peak is 2x bf16). Measured on v5e at
                # batch 128, 384x1280: 596.6 -> 715.1 imgs/s (1.20x) at
                # MIN_CH=256 (quantizing the narrow high-res convs LOSES —
                # they are HBM-bound and dynamic quant adds activation
                # passes; sweep in ROADMAP round-4). Accuracy drift pinned by
                # tests/test_int8_infer.py. Off by default: reference-exact
                # numerics unless opted in. Ignored by the training graph.
                "QUANT_INT8": False,
                "QUANT_MIN_CH": 256,
                # Static PTQ: path to a calibration JSON from
                # scripts/calibrate_int8.py ({conv_path: act_amax}). When set
                # (and QUANT_INT8 on), each calibrated conv's activation
                # scale is a trace-time constant — the dynamic per-batch
                # abs-max reduce passes disappear. Convs missing from the
                # file keep dynamic scales.
                "QUANT_SCALES_PATH": "",
                # Also quantize UNFOLDED convs (no norm to fold — the head
                # predictor convs; everything else quantizable is folded).
                # These produce the decode inputs directly, so quantization
                # noise hits scores/boxes without a norm in between; keep
                # off unless the serving config's AP drift is re-validated
                # (overfit_smoke --int8-ab gate). Measured on v5e (ROADMAP
                # round-5).
                "QUANT_UNFOLDED": False,
                # Mesh axis names: data-parallel axis.
                "MESH_AXES": ["data"],
            },
            # W&B mirroring of every logged scalar (tridet/utils/events.py:11-21,
            # tridet/utils/wandb.py); disabled by default, no-op if wandb is
            # not installed.
            "WANDB": {"ENABLED": False, "PROJECT": "dd3d_tpu", "TAGS": []},
            # Visualization during training/eval (reference
            # configs/visualizers/common.yaml + scripts/train.py:168-183,
            # 233-260). Dataloader vis draws GT on the current train batch
            # every DATALOADER_PERIOD steps; prediction vis caps the images
            # rendered per evaluation.
            "VIS": {
                "DATALOADER_ENABLED": True,
                "DATALOADER_PERIOD": 1000,
                "DATALOADER_MAX_NUM_SAMPLES": 10,
                "PREDICTIONS_ENABLED": True,
                "PREDICTIONS_MAX_NUM_SAMPLES": 20,
            },
            "EVAL_ONLY": False,
            "OUTPUT_ROOT": "./outputs",
        }
    )
