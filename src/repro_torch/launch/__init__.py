"""Launch helpers of the port: host meshes over ``torch.distributed``
(``mesh``) and tensor-parallel serving on one host (``serve``)."""
