"""Scale-out for serving on torch.distributed (counterpart of
ltx2_tpu/parallel/): one process per rank (`runtime`), a grid of ranks with
a process group per axis line (`mesh`), the collectives the paths call
(`collectives`), the DiT's TP sharding rules (`sharding`), ring attention
(`ring_attention`), the token-split DiT forward (`sequence_parallel`), the
GPipe-staged block stack (`pipeline_parallel`) and the layout advisor
behind --auto-shard (`advisor`). Training scale-out is not ported yet."""
