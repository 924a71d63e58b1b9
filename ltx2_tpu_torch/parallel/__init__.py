"""Scale-out for serving on torch.distributed (counterpart of
ltx2_tpu/parallel/): one process per rank (`runtime`), a grid of ranks with
a process group per axis line (`mesh`), the collectives the paths call
(`collectives`), the DiT's TP sharding rules (`sharding`), ring attention
(`ring_attention`) and the token-split DiT forward (`sequence_parallel`).
Not ported yet: pipeline parallelism and the layout advisor."""
