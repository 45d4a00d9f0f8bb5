"""Kernels (csrc/stem_conv.cu): the stem kernel's share of its roofline in
the rig cell, read as `stem_conv_roofline` reads the KITTI cells
(metrics/stem_conv_roofline.py): the least time of the stem's work at the
cell's own batch and canvas over the device time of the `stem_conv_kernel`
launches. A metric of its own, since `stem_conv_roofline` lists the cells
it reads. None where no such kernel launched. Moves serve_images_per_s."""
import os

from harness import spec

read = spec.load_reader("stem_conv_roofline", os.path.dirname(os.path.dirname(os.path.abspath(__file__)))).read
