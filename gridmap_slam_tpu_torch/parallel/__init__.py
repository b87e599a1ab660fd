"""The distributed engines on torch.distributed (counterpart of
gridmap_slam_tpu/parallel/): mesh, shmap, tiled, surface_sharded, sharded,
ba, dcn, comm_model and the multi-rank dry run."""
