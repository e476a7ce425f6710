"""Scene-flow, motion-segmentation and odometry metrics (copies of
``cmflow_tpu/evaluation``)."""
