"""The yardstick: plain PyTorch and NumPy that imports nothing of the
program. The frozen reference model and losses, the seeded weights, the
plain decode and NMS, the comparison that decides `correct`, and the table
of peaks with each op's least time."""
