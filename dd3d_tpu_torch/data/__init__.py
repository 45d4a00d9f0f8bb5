"""Host-side data path of the port (numpy and its own C++ image code): its
own copy of dd3d_tpu/data for the KITTI-3D datasets, training and
inference."""
