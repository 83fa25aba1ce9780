"""Launch helpers of the port: meshes over ``torch.distributed``
(``mesh``), rank groups on one host (``spawn``), tensor-parallel serving
(``serve``) and the training driver (``train``)."""
