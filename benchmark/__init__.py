"""The benchmark of the PyTorch and CUDA port (``srrg2_laser_slam_2d_tpu_torch``):
``python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
