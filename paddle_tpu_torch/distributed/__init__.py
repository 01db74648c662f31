"""paddle_tpu_torch.distributed: the single-device parallel layers so far
(``fleet/meta_parallel/mp_layers.py``); the mesh, collectives and
sharding come with ROADMAP item A7."""
