"""The synthetic KITTI-format fixture of the overfit smoke experiment, the
port's counterpart of scripts/overfit_smoke.py::make_fixture (:36-85): the
same calib, label and split files, and the same pixels, written without
cv2 (data/imageio.write_png). Only the fixture is ported; the overfit
training and evaluation run need the evaluation slice (ROADMAP §1 item 3).

    python -m dd3d_tpu_torch.overfit_smoke --root /tmp/fixture --n-images 8
"""
import argparse
import os

import numpy as np

from dd3d_tpu_torch.data.imageio import write_png

CALIB_TEXT = "\n".join(
    [
        "P0: 7.215377e+02 0 6.095593e+02 0 0 7.215377e+02 1.728540e+02 0 0 0 1 0",
        "P1: 7.215377e+02 0 6.095593e+02 -3.875744e+02 0 7.215377e+02 1.728540e+02 0 0 0 1 0",
        "P2: 7.215377e+02 0.0 6.095593e+02 4.485728e+01 0.0 7.215377e+02 1.728540e+02 2.163791e-01 0.0 0.0 1.0 "
        "2.745884e-03",
        "P3: 7.215377e+02 0 6.095593e+02 -3.395242e+02 0 7.215377e+02 1.728540e+02 2.199936e+00 0 0 1 2.729905e-03",
        "R0_rect: 1 0 0 0 1 0 0 0 1",
        "Tr_velo_to_cam: 7.533745e-03 -9.999714e-01 -6.166020e-04 -4.069766e-03 1.480249e-02 7.280733e-04 "
        "-9.998902e-01 -7.631618e-02 9.998621e-01 7.523790e-03 1.480755e-02 -2.717806e-01",
        "Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0",
    ]
)


def fill_rectangle(img: np.ndarray, pt1, pt2, color) -> None:
    """cv2.rectangle(img, pt1, pt2, color, thickness=-1): every pixel between
    the two corners, both included, clipped to the image."""
    (x1, y1), (x2, y2) = pt1, pt2
    x1, x2 = sorted((x1, x2))
    y1, y2 = sorted((y1, y2))
    h, w = img.shape[:2]
    img[max(y1, 0): min(y2, h - 1) + 1, max(x1, 0): min(x2, w - 1) + 1] = color


def make_fixture(root: str, n_images: int = 4):
    """KITTI-format fixture with a rendered box so the 2D branch has visual
    structure to learn from. n_images > 4 varies pose over a grid."""
    os.makedirs(os.path.join(root, "KITTI3D", "mv3d_kitti_splits"), exist_ok=True)
    for sub in ("calib", "label_2", "image_2"):
        os.makedirs(os.path.join(root, "KITTI3D", "training", sub), exist_ok=True)

    rng = np.random.RandomState(0)
    sids = []
    for i in range(n_images):
        sid = f"{i:06d}"
        sids.append(sid)
        # a car at varying x, depth ~14-38m -> decently sized 2D box
        if n_images <= 4:
            x = -2.0 + 1.5 * i
            z = 16.0 + 4.0 * i
        else:
            x = -2.5 + 1.2 * (i % 5)
            z = 14.0 + 3.5 * (i % 8)
        y = 1.65
        h3, w3, l3 = 1.5, 1.6, 3.9
        ry = 0.1 * (i % 12)
        # project center to get a plausible 2D box
        fx, cx_k = 721.5377, 609.5593
        fy, cy_k = 721.5377, 172.854
        u = fx * x / z + cx_k
        v = fy * (y - h3 / 2) / z + cy_k
        bw = fx * l3 / z
        bh = fy * h3 / z
        l2, t2, r2, b2 = u - bw / 2, v - bh / 2, u + bw / 2, v + bh / 2
        label = f"Car 0.00 0 {ry:.2f} {l2:.2f} {t2:.2f} {r2:.2f} {b2:.2f} {h3} {w3} {l3} {x} {y} {z} {ry}\n"

        img = (rng.rand(375, 1242, 3) * 40 + 90).astype(np.uint8)
        fill_rectangle(img, (int(l2), int(t2)), (int(r2), int(b2)), (200, 60, 220))
        fill_rectangle(img, (int(l2) + 4, int(t2) + 4), (int(r2) - 4, int((t2 + b2) / 2)), (40, 200, 60))

        base = os.path.join(root, "KITTI3D", "training")
        with open(os.path.join(base, "calib", f"{sid}.txt"), "w") as f:
            f.write(CALIB_TEXT)
        with open(os.path.join(base, "label_2", f"{sid}.txt"), "w") as f:
            f.write(label)
        write_png(os.path.join(base, "image_2", f"{sid}.png"), img)

    with open(os.path.join(root, "KITTI3D", "mv3d_kitti_splits", "train.txt"), "w") as f:
        f.write("\n".join(sids) + "\n")
    return root


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", required=True)
    parser.add_argument("--n-images", type=int, default=4, help="fixture size; >4 varies car pose over a grid")
    args = parser.parse_args(argv)
    print(make_fixture(args.root, n_images=args.n_images))


if __name__ == "__main__":
    main()
