"""Command-line entry points of the port: `python -m
fcaf3d_tpu_torch.tools.<name>` for `train`, `test`, `pcd_demo`,
`train_votenet`, `train_detector2d`, `train_imvotenet`,
`convert_checkpoint`, `fuse_conv_bn`, `publish_model`, `create_data`,
`print_config`, `analyze_logs` and `browse_dataset`."""
