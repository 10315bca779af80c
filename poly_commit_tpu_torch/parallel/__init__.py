"""Multi-GPU execution: meshes of torch.distributed ranks (``mesh``) and a
single-machine rank launcher (``launch``)."""
