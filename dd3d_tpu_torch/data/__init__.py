"""Host-side inference data path of the port (numpy, cv2 and PIL): its own
copy of what dd3d_tpu/data does for serving, nothing for training."""
