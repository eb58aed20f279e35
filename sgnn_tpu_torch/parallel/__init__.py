"""Multi-device execution over ``torch.distributed`` (port of
``sgnn_tpu/parallel``): ``mesh`` (process groups, per-rank batches, the
rank launcher), ``comm`` (the collectives with their gradients) and
``spatial`` (z-sharded channels-last grids and their halo exchange)."""
