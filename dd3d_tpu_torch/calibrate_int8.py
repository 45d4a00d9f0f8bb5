"""Calibrate static int8 activation scales from representative images.

    python -m dd3d_tpu_torch.calibrate_int8 --experiment dd3d_kitti_dla34 \
        --ckpt model_final.pth --images /data/frames \
        --intrinsics 721.5,721.5,609.5,172.8 --out scales.json [--batch 8] [--device cuda]

Counterpart of scripts/calibrate_int8.py. Images are read as
`python -m dd3d_tpu_torch.predict` reads them; every eligible conv records
its input max|x| per (scope path, "HxWxC" shape tag), whatever
QUANT_MIN_CH is, and the running max over the images is written as JSON in
the JAX package's schema, so the file serves both packages. As in the JAX
CLI, the convs upstream quantize by the config's TPU.QUANT_MIN_CH; pass
TPU.QUANT_MIN_CH=0 to calibrate in the regime of `prepare_static_scales`. `--headroom` (default 1.0) multiplies the
recorded maxima: above 1 it trades clipping for a coarser step. Serve with
`TPU.QUANT_INT8=True TPU.QUANT_SCALES_PATH=<out>` (bench.py's serving
configuration also sets TPU.QUANT_MIN_CH=32 TPU.QUANT_UNFOLDED=True).
It runs on the card; `--device cpu` runs it on the CPU.
"""
import argparse
import json

from dd3d_tpu_torch.models.calibrate import capture_scales
from dd3d_tpu_torch.predict import iter_batches, list_images, load_model, parse_intrinsics, parse_overrides, \
    read_image_dicts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--experiment", required=True)
    ap.add_argument("--images", required=True, help="directory or glob of calibration images")
    ap.add_argument("--intrinsics", required=True, help='"fx,fy,cx,cy" or JSON file')
    ap.add_argument("--ckpt", default=None, help="reference-named .pth state dict")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-images", type=int, default=64)
    ap.add_argument("--headroom", type=float, default=1.0, help="scale multiplier on recorded maxes")
    ap.add_argument("--out", default="int8_scales.json")
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu")
    ap.add_argument("--seed", type=int, default=0, help="weight seed when no --ckpt is given")
    ap.add_argument("overrides", nargs="*", help="KEY=VALUE config overrides")
    args = ap.parse_args(argv)

    from dd3d_tpu_torch.configs import get_experiment_cfg
    from dd3d_tpu_torch.utils.comm import resolve_device

    device = resolve_device(args.device)
    cfg = get_experiment_cfg(args.experiment)
    parse_overrides(args.overrides, cfg)
    files = list_images(args.images)[: args.max_images]
    print(f"{len(files)} calibration images, experiment {args.experiment}, device {device}")
    dicts = read_image_dicts(files, parse_intrinsics(args.intrinsics))
    model = load_model(cfg, args.ckpt, args.seed, device)
    batches = (batch["image"] for _, batch, _ in iter_batches(cfg, dicts, args.batch))
    scales = capture_scales(cfg, model, batches)
    if args.headroom != 1.0:
        scales = {k: {t: a * args.headroom for t, a in v.items()} for k, v in scales.items()}
    with open(args.out, "w") as f:
        json.dump(scales, f, indent=0, sort_keys=True)
    print(f"wrote {args.out}; use with TPU.QUANT_INT8=True TPU.QUANT_SCALES_PATH={args.out}")


if __name__ == "__main__":
    main()
