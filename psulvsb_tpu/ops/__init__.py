from psulvsb_tpu.ops.pair_grid import consistency_degree
