"""Command-line entry points of the port: `python -m
fcaf3d_tpu_torch.tools.train`, `.test` and `.pcd_demo`."""
